"""K4, K9 and K10: the gradient of the trilinear spatial-embedding sample
with respect to the grid (dGrid), and for K10 also to the coordinates.

K4 replaces ``sahs_tpu/ops/pallas/grid_bwd.py:grid_dg_slab_packed`` (:211,
``pallas_call`` at :327), which the fused train path runs once per step
over the sorted fine points with the coarse level's cotangents scattered
in as a second input (train/fused.py:405-413). K9 replaces
``grid_bwd.py:grid_dg_slab`` (:103, ``pallas_call`` at :191), the autograd
fallback's dGrid: the backward of the grid-coupled level ops
(``field_grid.py``) over their sample-major points. Both are the CUDA
kernel of ``csrc/grid_bwd.cu``.

    dG[c, z, y, x] = sum_p w_corner(p) * (gse[p, c] + gse2[p, c])

over the 8 corners of each point's cell, with zeros padding: a corner
outside the grid contributes nothing. The weights are those of the
forward sample (ops/grid._cell_geometry's exact expression). K4 takes each
point's cell as its corner-table row, mapped back to grid voxels with the
table's padding border dropped; K9 forms the cell from the coordinates
itself, with the same expression, and has no addend.

K10 replaces ``grid_bwd.py:grid_bwd_fused`` (:343, ``pallas_call`` at
:415), the backward of ``ops/grid.grid_sample_3d`` on the per-point branch
and the plain path: dG and the coordinates' cotangent from the corner rows
the forward gathered, with the JAX kernel's bf16 roundings in bf16 mode.
It takes every grid shape.

All three run one routine of ``csrc/grid_bwd.cu``: the points binned by
cell (a stable radix sort), each cell's points summed in index order into
its corners' partial sums, each voxel written once. No float atomics and
no zero fill: dG is the same bit for bit on every run. Each wrapper makes
one ctypes call, which launches the routine's kernels on PyTorch's current
stream, and allocates its scratch (``_scratch``) with ``torch.empty``.

``grid_dg``, ``grid_dg_coords`` and ``grid_bwd_fused`` launch the kernel
for CUDA tensors and count the call in ``<wrapper>.launches``; for CPU
tensors they run ``grid_dg_plain`` / ``grid_dg_coords_plain`` /
``grid_bwd_fused_plain``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from ..grid import _cell_geometry, corner_dcoords


@functools.lru_cache(maxsize=64)
def _scratch_sizes(P: int, C: int, D: int, H: int, W: int) -> Tuple[int, int]:
    """(int32s, float32s) of scratch the routine takes, as csrc/grid_bwd.cu
    counts them (``sahs_grid_scratch``)."""
    sizes = (ctypes.c_longlong * 2)()
    fn = _build.function("grid_bwd", "sahs_grid_scratch", "liiii" + "p")
    _build.check(fn(P, C, D, H, W, ctypes.addressof(sizes)), "grid backward scratch")
    return sizes[0], sizes[1]


def _scratch(P: int, C: int, dims: Sequence[int], device):
    """The routine's scratch for P points, C channels and a (D, H, W) grid:
    int32s for the sort and the cells' counts and offsets, float32s for
    the chunks' partial sums. Returns (ints, n_ints, partials, n_floats)."""
    n_ints, n_floats = _scratch_sizes(P, C, *dims)
    ints = torch.empty(max(n_ints, 1), dtype=torch.int32, device=device)
    part = torch.empty(max(n_floats, 1), dtype=torch.float32, device=device)
    return ints, n_ints, part, n_floats


def _check_addend(gse: torch.Tensor, gse2: Optional[torch.Tensor]) -> None:
    if gse2 is not None and gse2.shape != gse.shape:
        raise ValueError(f"the dGrid addend must have gse's shape "
                         f"{tuple(gse.shape)}, got {tuple(gse2.shape)}")


def grid_dg_plain(pts: torch.Tensor, rows: torch.Tensor, gse: torch.Tensor,
                  gse2: Optional[torch.Tensor], grid_shape: Sequence[int]
                  ) -> torch.Tensor:
    """pts (P, >=3) sample coordinates (their xyz), rows (P,) or (R, S)
    their corner-table rows, gse (P, C) the cotangent of the sampled
    features, gse2 an addend of the same shape or None -> dG (C, D, H, W)
    float32 (a view of a (D, H, W, C) buffer). ``index_add_`` over the 8
    corners."""
    _check_addend(gse, gse2)
    C, D, H, W = grid_shape
    g = gse.to(torch.float32)
    if gse2 is not None:
        g = g + gse2.to(torch.float32)
    _, (fx, fy, fz), ok = _cell_geometry(pts[:, :3].to(torch.float32), (D, H, W))
    okf = ok.to(torch.float32)
    r = rows.reshape(-1).long()
    bx = r % (W + 1)
    by = torch.div(r, W + 1, rounding_mode="floor") % (H + 1)
    bz = torch.div(r, (W + 1) * (H + 1), rounding_mode="floor")
    dg = torch.zeros((D * H * W, C), dtype=torch.float32, device=pts.device)
    for dz in (0, 1):
        wz = fz if dz else 1.0 - fz
        z = bz + dz - 1
        for dy in (0, 1):
            wy = fy if dy else 1.0 - fy
            y = by + dy - 1
            for dx in (0, 1):
                wx = fx if dx else 1.0 - fx
                x = bx + dx - 1
                w = wz * wy * wx * okf
                inside = ((z >= 0) & (z < D) & (y >= 0) & (y < H)
                          & (x >= 0) & (x < W))
                idx = (z * H + y) * W + x
                dg.index_add_(0, idx[inside], w[inside, None] * g[inside])
    return dg.reshape(D, H, W, C).permute(3, 0, 1, 2)


def grid_dg(pts: torch.Tensor, rows: torch.Tensor, gse: torch.Tensor,
            gse2: Optional[torch.Tensor], grid_shape: Sequence[int]
            ) -> torch.Tensor:
    """K4 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Same arguments and result as ``grid_dg_plain``."""
    if pts.device.type == "cpu":
        return grid_dg_plain(pts, rows, gse, gse2, grid_shape)
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}")
    _check_addend(gse, gse2)
    C, D, H, W = grid_shape
    P, PW = pts.shape
    if (gse.dim() != 2 or gse.shape != (P, C) or rows.numel() != P
            or PW > 8 or PW < 3):
        raise ValueError(f"K4 shapes not supported: pts {tuple(pts.shape)}, "
                         f"rows {tuple(rows.shape)}, gse {tuple(gse.shape)} for "
                         f"grid {tuple(grid_shape)}")
    if any(t is not None and t.device != pts.device for t in (rows, gse, gse2)):
        raise ValueError("K4 inputs must all be on " + str(pts.device))
    f32 = torch.float32
    pts = pts.to(f32).contiguous()
    rows = rows.reshape(-1).to(torch.int32).contiguous()
    gse = gse.to(f32).contiguous()
    gse2 = gse2.to(f32).contiguous() if gse2 is not None else None
    dg = torch.empty((D, H, W, C), dtype=f32, device=pts.device)
    ints, n_ints, part, n_floats = _scratch(P, C, (D, H, W), pts.device)
    fn = _build.function("grid_bwd", "sahs_grid_dg",
                         "pppp" + "li" + "iiii" + "plpl" + "p" + "p")
    p = _build.ptr
    rc = fn(p(pts), p(rows), p(gse), p(gse2), P, PW, C, D, H, W,
            p(ints), n_ints, p(part), n_floats, p(dg), _build.stream_ptr(pts.device))
    _build.check(rc, "grid_dg")
    grid_dg.launches += 1
    return dg.permute(3, 0, 1, 2)


grid_dg.launches = 0


def grid_dg_coords_plain(coords: torch.Tensor, g: torch.Tensor,
                         grid_shape: Sequence[int]) -> torch.Tensor:
    """K9's plain version: coords (P, >=3) sample coordinates, g (P, C) the
    cotangent of the sampled features -> dG (C, D, H, W) float32."""
    rows, _, _ = _cell_geometry(coords[:, :3].to(torch.float32), grid_shape[1:])
    return grid_dg_plain(coords, rows, g, None, grid_shape)


def grid_dg_coords(coords: torch.Tensor, g: torch.Tensor,
                   grid_shape: Sequence[int]) -> torch.Tensor:
    """K9 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Same arguments and result as ``grid_dg_coords_plain``."""
    if coords.device.type == "cpu":
        return grid_dg_coords_plain(coords, g, grid_shape)
    if coords.device.type != "cuda":
        raise ValueError(f"unsupported device {coords.device}")
    C, D, H, W = grid_shape
    P, PW = coords.shape
    if g.dim() != 2 or g.shape != (P, C) or PW > 8 or PW < 3:
        raise ValueError(f"K9 shapes not supported: coords {tuple(coords.shape)}, "
                         f"g {tuple(g.shape)} for grid {tuple(grid_shape)}")
    if g.device != coords.device:
        raise ValueError("K9 inputs must all be on " + str(coords.device))
    f32 = torch.float32
    coords = coords.to(f32).contiguous()
    g = g.to(f32).contiguous()
    dg = torch.empty((D, H, W, C), dtype=f32, device=coords.device)
    ints, n_ints, part, n_floats = _scratch(P, C, (D, H, W), coords.device)
    fn = _build.function("grid_bwd", "sahs_grid_dg_coords",
                         "pp" + "li" + "iiii" + "plpl" + "p" + "p")
    p = _build.ptr
    rc = fn(p(coords), p(g), P, PW, C, D, H, W, p(ints), n_ints, p(part),
            n_floats, p(dg), _build.stream_ptr(coords.device))
    _build.check(rc, "grid_dg_coords")
    grid_dg_coords.launches += 1
    return dg.permute(3, 0, 1, 2)


grid_dg_coords.launches = 0


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def grid_bwd_fused_plain(grid_shape: Sequence[int], coords: torch.Tensor,
                         g: torch.Tensor, vals: torch.Tensor,
                         compute_dtype: str = "float32"):
    """K10's plain version: coords (P, >=3) sample coordinates, g (P, C) the
    cotangent of the sampled features, vals (P, 8C) the corner rows the
    forward gathered -> (dG (C, D, H, W) float32, dcoords (P, 3) float32).

    dG[c, z, y, x] = sum_p (Az Ay)[p, z, y] (Ax g)[p, x, c] over each
    point's corners inside the grid (grid_bwd.py:374-390); in bfloat16 the
    axis weights and g are rounded to bf16 and so is each of the two
    products, which then multiply and sum in float32 (grid_bwd.py:375-384).
    dcoords is ``grid.corner_dcoords`` in float32, gated by the whole cell's
    band (grid_bwd.py:392-413)."""
    C, D, H, W = grid_shape
    rnd = _bf16 if compute_dtype == "bfloat16" else (lambda x: x)
    cf = coords[:, :3].to(torch.float32)
    _, fs, ok = _cell_geometry(cf, (D, H, W))
    i0 = [torch.floor((cf[:, a] + 1.0) * 0.5 * (n - 1)).long()
          for a, n in ((0, W), (1, H), (2, D))]
    gf = g.to(torch.float32)
    gr = rnd(gf)
    fx, fy, fz = fs
    dg = torch.zeros((D * H * W, C), dtype=torch.float32, device=coords.device)
    for dz in (0, 1):
        wz = rnd(fz if dz else 1.0 - fz)
        z = i0[2] + dz
        for dy in (0, 1):
            wzy = rnd(wz * rnd(fy if dy else 1.0 - fy))
            y = i0[1] + dy
            for dx in (0, 1):
                wx = rnd(fx if dx else 1.0 - fx)
                x = i0[0] + dx
                inside = ((z >= 0) & (z < D) & (y >= 0) & (y < H)
                          & (x >= 0) & (x < W))
                contrib = wzy[:, None] * rnd(wx[:, None] * gr)
                dg.index_add_(0, ((z * H + y) * W + x)[inside], contrib[inside])
    dcoords = corner_dcoords(gf, fs, ok, vals, (D, H, W))
    return dg.reshape(D, H, W, C).permute(3, 0, 1, 2), dcoords


def grid_bwd_fused(grid_shape: Sequence[int], coords: torch.Tensor,
                   g: torch.Tensor, vals: torch.Tensor,
                   compute_dtype: str = "float32"):
    """K10 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Same arguments and results as ``grid_bwd_fused_plain``;
    every grid shape is taken."""
    if coords.device.type == "cpu":
        return grid_bwd_fused_plain(grid_shape, coords, g, vals, compute_dtype)
    if coords.device.type != "cuda":
        raise ValueError(f"unsupported device {coords.device}")
    C, D, H, W = grid_shape
    P, PW = coords.shape
    vdt = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    if (g.shape != (P, C) or vals.shape != (P, 8 * C) or vals.dtype != vdt
            or PW < 3):
        raise ValueError(f"K10 shapes not supported: coords {tuple(coords.shape)}, "
                         f"g {tuple(g.shape)}, vals {tuple(vals.shape)} "
                         f"{vals.dtype} for grid {tuple(grid_shape)}, "
                         f"{compute_dtype}")
    if any(t.device != coords.device for t in (g, vals)):
        raise ValueError("K10 inputs must all be on " + str(coords.device))
    f32 = torch.float32
    coords = coords.to(f32).contiguous()
    g = g.to(f32).contiguous()
    vals = vals.contiguous()
    dg = torch.empty((D, H, W, C), dtype=f32, device=coords.device)
    dc = torch.empty((P, 3), dtype=f32, device=coords.device)
    ints, n_ints, part, n_floats = _scratch(P, C, (D, H, W), coords.device)
    fn = _build.function("grid_bwd", "sahs_grid_bwd_fused",
                         "ppp" + "li" + "iiii" + "i" + "plpl" + "pp" + "p")
    p = _build.ptr
    rc = fn(p(coords), p(g), p(vals), P, PW, C, D, H, W,
            int(compute_dtype == "bfloat16"), p(ints), n_ints, p(part), n_floats,
            p(dg), p(dc), _build.stream_ptr(coords.device))
    _build.check(rc, "grid_bwd_fused")
    grid_bwd_fused.launches += 1
    return dg.permute(3, 0, 1, 2), dc


grid_bwd_fused.launches = 0
