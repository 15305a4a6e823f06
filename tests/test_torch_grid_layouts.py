"""The grid backward's plain versions (K4 ``grid_dg_plain``, K9
``grid_dg_coords_plain``, K10 ``grid_bwd_fused_plain``) against the JAX
kernels (``grid_bwd.grid_dg_slab_packed``, ``grid_dg_slab``,
``grid_bwd_fused``, Pallas in interpret mode) on the layouts that a binned
dG routine finds hardest: a hot cell (all points but a few in one cell), every
point outside the band, and points on the grid's faces and edges and on
cell faces. The card tests (``tests/test_torch_cuda.py``) hold the CUDA
routine against these plain versions on the same layouts, so this anchors
their oracle to JAX there. K9 is also held on ray-major against
sample-major points: its result does not depend on the order.

Tolerances as the existing tests of these kernels: K4 and K9 within 1e-4
relative and 1e-5 of the largest entry (the JAX kernels contract dense
axis weights, the plain versions add point by point); K10 within 1e-5
L2-relative (both sides round the same values the same way, bf16
included). Where every point is outside the band, both sides give exact
zeros.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from sahs_tpu.ops import grid as jgrid
from sahs_tpu.ops.pallas import grid_bwd as jgb

from sahs_tpu_torch.ops.grid import _cell_geometry
from sahs_tpu_torch.ops.kernels import grid_bwd as k4
from torch_grid_util import LAYOUTS, hot_corners, layout, sample_major

torch.set_num_threads(2)

GRID = (32, 32, 32)
SHAPE = (32,) + GRID
P = 1536
K10_L2 = 1e-5
KERNELS = ("K4", "K9", "K10 float32", "K10 bfloat16")


def _t(x):
    return torch.tensor(np.asarray(x))


def _n(x):
    return np.asarray(x.detach().cpu()) if torch.is_tensor(x) else np.asarray(x)


def _l2(x, y):
    x, y = _n(x).astype(np.float64).ravel(), np.asarray(y, np.float64).ravel()
    return np.linalg.norm(x - y) / np.linalg.norm(y)


def _plain_and_jax(kernel: str, c: np.ndarray, rng):
    """The plain version's and the JAX kernel's (dG, dcoords or None)."""
    g = rng.randn(len(c), 32).astype(np.float32)
    if kernel == "K4":
        g2 = rng.randn(len(c), 32).astype(np.float32)
        rows, _, _ = _cell_geometry(_t(c), GRID)
        dg_t = k4.grid_dg(_t(c), rows, _t(g), _t(g2), SHAPE)
        packed = lambda a: jnp.asarray(np.concatenate(
            [c[:, :3], np.zeros((len(c), 6), np.float32), a,
             np.zeros((len(c), 23), np.float32)], 1))
        return (dg_t, None), (jgb.grid_dg_slab_packed(SHAPE, packed(g), "float32",
                                                      packed2=packed(g2)), None)
    if kernel == "K9":
        dg_t = k4.grid_dg_coords(_t(c), _t(g), SHAPE)
        return (dg_t, None), (jgb.grid_dg_slab(SHAPE, jnp.asarray(c), jnp.asarray(g),
                                               "float32"), None)
    dtype = kernel.split()[1]
    G = jnp.asarray(rng.randn(*SHAPE).astype(np.float32) * 0.1)
    _, (_, _, vals) = jgrid._grid_sample_fwd(G, jnp.asarray(c), dtype)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    vals_t = _t(np.asarray(vals.astype(jnp.float32))).to(tdt)
    out_t = k4.grid_bwd_fused(SHAPE, _t(c), _t(g), vals_t, dtype)
    return out_t, jgb.grid_bwd_fused(SHAPE, jnp.asarray(c), jnp.asarray(g), vals,
                                     compute_dtype=dtype)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("kind", LAYOUTS)
def test_grid_backward_plain_matches_pallas_on_layouts(kind, kernel):
    rng = np.random.RandomState(LAYOUTS.index(kind) * 10 + KERNELS.index(kernel))
    c = layout(kind, rng, P)
    counts = (k4.grid_dg.launches, k4.grid_dg_coords.launches,
              k4.grid_bwd_fused.launches)
    (dg_t, dc_t), (dg_j, dc_j) = _plain_and_jax(kernel, c, rng)
    # CPU tensors: the plain versions, no launch
    assert (k4.grid_dg.launches, k4.grid_dg_coords.launches,
            k4.grid_bwd_fused.launches) == counts
    assert dg_t.shape == SHAPE
    if kind == "all_outside":
        assert not _n(dg_t).any() and not np.asarray(dg_j).any()
        if dc_t is not None:
            assert not _n(dc_t).any() and not np.asarray(dc_j).any()
        return
    if kind == "hot_cell":
        # the hot cell's 8 corners, and at most those of the 8 others
        touched = np.abs(_n(dg_t)).sum(axis=0) > 0
        assert hot_corners(_n(dg_t)).all() and touched.sum() <= 8 * 9
    if kernel.startswith("K10"):
        for name, x, y in (("dG", dg_t, dg_j), ("dcoords", dc_t, dc_j)):
            assert _l2(x, y) <= K10_L2, (name, _l2(x, y))
    else:
        scale = float(np.abs(np.asarray(dg_j)).max())
        np.testing.assert_allclose(_n(dg_t), np.asarray(dg_j), rtol=1e-4,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("kind", LAYOUTS)
def test_grid_dg_coords_plain_is_order_free(kind):
    """K9's plain version on ray-major points and on the same points
    sample-major (``torch_grid_util.sample_major``, 48 rays of 32) within 1e-4
    relative and 1e-5 of the largest entry: the sum's order alone differs."""
    rng = np.random.RandomState(40 + LAYOUTS.index(kind))
    R, S = 48, 32
    c, g = _t(layout(kind, rng, R * S)), _t(rng.randn(R * S, 32).astype(np.float32))
    ray_major = k4.grid_dg_coords(c, g, SHAPE)
    by_sample = k4.grid_dg_coords(sample_major(c, R, S), sample_major(g, R, S),
                                  SHAPE)
    scale = float(by_sample.abs().max())
    if kind == "all_outside":
        assert scale == 0.0 and not ray_major.any()
        return
    np.testing.assert_allclose(_n(ray_major), _n(by_sample), rtol=1e-4,
                               atol=1e-5 * scale)
