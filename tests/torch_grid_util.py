"""Point layouts for the grid backward's tests (K4, K9, K10): the CPU tests
against the JAX kernels (``tests/test_torch_grid_layouts.py``) and the card
tests of the CUDA routine (``tests/test_torch_cuda.py``) draw the same
layouts, and K9's sample-major order. No JAX here: the card's machine has
none."""
import numpy as np
import torch

LAYOUTS = ("hot_cell", "all_outside", "grid_faces")
# the hot cell's lowest corner, voxel (x, y, z)
HOT_VOXEL = (14, 12, 10)


def layout(kind: str, rng, n: int, others: int = 8) -> np.ndarray:
    """(n, 5) float32 packed points (xyz, 2 ambient columns) of a 32^3
    grid in ``kind``'s layout: "hot_cell" (all but ``others`` points in the
    cell whose lowest corner is HOT_VOXEL), "all_outside" (one axis of every
    point past the band, so that no corner of its cell is in the grid) or
    "grid_faces" (on cell faces, each coordinate four times in ten at a
    grid face, +-1, or one float ulp past it)."""
    c = rng.uniform(-0.9, 0.9, (n, 5)).astype(np.float32)
    if kind == "hot_cell":
        lo = 2.0 * np.array(HOT_VOXEL) / 31.0 - 1.0
        c[:n - others, :3] = lo + rng.uniform(0.0, 2.0 / 31.0, (n - others, 3))
    elif kind == "all_outside":
        axis = rng.randint(0, 3, n)
        c[np.arange(n), axis] = rng.choice([-1.0, 1.0], n) * rng.uniform(1.1, 3.0, n)
    elif kind == "grid_faces":
        c[:, :3] = 2.0 * rng.randint(0, 32, (n, 3)) / 31.0 - 1.0
        face = rng.rand(n, 3) < 0.4
        c[:, :3][face] = rng.choice([-1.0, 1.0, -1.0000001, 1.0000001], int(face.sum()))
    else:
        raise ValueError(kind)
    return c.astype(np.float32)


def hot_corners(dg: np.ndarray) -> np.ndarray:
    """(2, 2, 2) bool: which of the hot cell's 8 corner voxels of dG (C, D,
    H, W) are non-zero in some channel."""
    x, y, z = HOT_VOXEL
    return np.abs(dg).sum(axis=0)[z:z + 2, y:y + 2, x:x + 2] > 0


def sample_major(x: torch.Tensor, R: int, S: int) -> torch.Tensor:
    """(R*S, k) ray-major -> sample-major, all rays' sample s adjacent: the
    layout the JAX slab kernel (K9, sahs_tpu/ops/pallas/field_grid.py:80-85)
    wants; the port's K9 takes any order."""
    return x.reshape(R, S, x.shape[-1]).transpose(0, 1).reshape(R * S, x.shape[-1])
