"""Trilinear 3-D feature-grid sampling (counterpart of ``sahs_tpu/ops/grid.py``).

Semantics of torch ``F.grid_sample(..., mode='bilinear', padding_mode='zeros',
align_corners=True)`` on a 5-D grid, as the reference's learnable spatial
embedding uses it (nerf-pytorch/nerf/models.py:346-365):

  - coords in [-1, 1], last-dim order (x, y, z) indexing the grid's
    (W, H, D) axes, for a grid stored as (C, D, H, W);
  - align_corners=True:  i = (c + 1) * 0.5 * (dim - 1);
  - zeros padding: out-of-range corners contribute 0.

The forward gathers from a corner-packed table: the grid, bordered with one
zero cell on every side, is laid out so that row (z, y, x) holds all 8
corner values of that base cell. One row gather per point then replaces 8
scattered ones, and the zero border realises the padding rule. The CUDA
level kernel (``ops/kernels/nerf_level.py``) gathers from the same table.
The backward (dGrid and the coordinates' cotangent) is K10,
``ops/kernels/grid_bwd.py:grid_bwd_fused``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def pack_corner_table(grid: torch.Tensor, dtype=None) -> torch.Tensor:
    """(C, D, H, W) -> ((D+1)*(H+1)*(W+1), 8*C). Row (z, y, x) slot
    (dz*4 + dy*2 + dx)*C + c = Gpad[c, z+dz, y+dy, x+dx], Gpad the grid with
    one zero cell on every side."""
    C, D, H, W = grid.shape
    g = torch.nn.functional.pad(grid.permute(1, 2, 3, 0),
                                (0, 0, 1, 1, 1, 1, 1, 1))   # (D+2, H+2, W+2, C)
    corners = [g[dz:dz + D + 1, dy:dy + H + 1, dx:dx + W + 1]
               for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    table = torch.stack(corners, dim=-2)                    # (D+1, H+1, W+1, 8, C)
    table = table.reshape((D + 1) * (H + 1) * (W + 1), 8 * C)
    if dtype is not None:
        table = table.to(dtype)
    return table.contiguous()


def _cell_geometry(coords: torch.Tensor, dims: Sequence[int]
                   ) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor]:
    """coords (P, >=3) -> (rows (P,) int64, fracs [fx, fy, fz], in_band (P,)).
    rows index the packed table's base cells (floor + 1 per axis, clipped);
    fracs are with respect to the true floor; in_band is the zeros-padding
    predicate (floor in [-1, dim-1] on every axis). The floating-point
    expression is the JAX package's, operation for operation: the CUDA
    kernels repeat it so that every point falls in the cell whose row was
    gathered."""
    D, H, W = dims
    fs, bases, ok = [], [], None
    for axis, n in ((0, W), (1, H), (2, D)):
        i = (coords[:, axis] + 1.0) * 0.5 * (n - 1)
        i0 = torch.floor(i)
        fs.append(i - i0)
        band = (i0 >= -1) & (i0 <= n - 1)
        ok = band if ok is None else (ok & band)
        bases.append(torch.clamp(i0 + 1, 0, n).to(torch.int64))
    bx, by, bz = bases
    rows = (bz * (H + 1) + by) * (W + 1) + bx
    return rows, fs, ok


def interp_corners(corners: torch.Tensor, fs, ok: torch.Tensor) -> torch.Tensor:
    """(P, 8C) gathered corner rows + cell fractions -> (P, C) float32,
    summed over the 8 slots in slot order (dz, dy, dx). Each slot is
    widened to float32 on its own, so a bf16 (P, 8C) input is never copied
    whole."""
    C = corners.shape[1] // 8
    fx, fy, fz = fs
    okf = ok.to(torch.float32)
    out = None
    for dz in (0, 1):
        wz = fz if dz else 1.0 - fz
        for dy in (0, 1):
            wy = fy if dy else 1.0 - fy
            for dx in (0, 1):
                wx = fx if dx else 1.0 - fx
                s = dz * 4 + dy * 2 + dx
                w = wz * wy * wx * okf
                contrib = corners[:, s * C:(s + 1) * C].to(torch.float32) * w[:, None]
                out = contrib if out is None else out + contrib
    return out


def corner_dcoords(g: torch.Tensor, fs, ok: torch.Tensor, cf: torch.Tensor,
                   dims) -> torch.Tensor:
    """The sample's cotangent with respect to its coordinates, analytic from
    the gathered corner rows (grid.py:256-291): each axis' weight replaced
    by +-1, scaled by (n - 1) / 2, zero outside the band. g (P, C) the
    cotangent of the sampled features, cf (P, 8C) the corner rows -> (P, 3)
    float32."""
    C = g.shape[1]
    fx, fy, fz = fs
    okf = ok.to(torch.float32)
    dfx = dfy = dfz = 0.0
    for s in range(8):
        dz_, dy_, dx_ = (s >> 2) & 1, (s >> 1) & 1, s & 1
        gv = torch.sum(g * cf[:, s * C:(s + 1) * C].to(torch.float32), dim=-1)
        wz = fz if dz_ else 1.0 - fz
        wy = fy if dy_ else 1.0 - fy
        wx = fx if dx_ else 1.0 - fx
        dfx = dfx + (1.0 if dx_ else -1.0) * wz * wy * gv
        dfy = dfy + (1.0 if dy_ else -1.0) * wz * wx * gv
        dfz = dfz + (1.0 if dz_ else -1.0) * wy * wx * gv
    D_, H_, W_ = dims
    return torch.stack([dfx * okf * (0.5 * (W_ - 1)), dfy * okf * (0.5 * (H_ - 1)),
                        dfz * okf * (0.5 * (D_ - 1))], dim=-1)


class _GridSample(torch.autograd.Function):
    """The packed-table gather forward (grid.py:214-231); the backward is
    K10, ``kernels.grid_bwd.grid_bwd_fused`` (grid.py:234-252), from the
    corner rows the forward gathered. They are kept only when a gradient
    is wanted: at a frame's fine chunk they are gigabytes."""

    @staticmethod
    def forward(ctx, grid, coords, compute_dtype):
        gdt = torch.bfloat16 if compute_dtype == "bfloat16" else None
        table = pack_corner_table(grid.detach(), dtype=gdt)
        cf = coords.detach().reshape(-1, coords.shape[-1])
        rows, fs, ok = _cell_geometry(cf, grid.shape[1:])
        vals = table[rows]
        out = interp_corners(vals, fs, ok)
        ctx.grid_shape = tuple(grid.shape)
        ctx.compute_dtype = compute_dtype
        if any(ctx.needs_input_grad[:2]):
            ctx.save_for_backward(coords, vals)
        return out.reshape(coords.shape[:-1] + (grid.shape[0],))

    @staticmethod
    def backward(ctx, g):
        from .kernels.grid_bwd import grid_bwd_fused
        coords, vals = ctx.saved_tensors
        C = ctx.grid_shape[0]
        cf = coords.detach().reshape(-1, coords.shape[-1])
        dg, dc = grid_bwd_fused(ctx.grid_shape, cf, g.reshape(-1, C), vals,
                                ctx.compute_dtype)
        if cf.shape[1] > 3:
            # a packed coordinate block: only its first 3 columns are coords
            dc = torch.nn.functional.pad(dc, (0, cf.shape[1] - 3))
        return dg, dc.reshape(coords.shape).to(coords.dtype), None


def grid_sample_3d(grid: torch.Tensor, coords: torch.Tensor,
                   compute_dtype: str = "float32") -> torch.Tensor:
    """Trilinear sample of grid (C, D, H, W) at coords (..., >=3) in [-1, 1]
    -> (..., C), differentiable with respect to the grid and the coordinates.
    compute_dtype="bfloat16" gathers the table in bf16, and its backward
    (K10) rounds as the JAX package's bf16 path does."""
    return _GridSample.apply(grid, coords, compute_dtype)
