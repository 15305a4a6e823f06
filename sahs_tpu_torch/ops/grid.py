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
    summed over the 8 slots in slot order (dz, dy, dx)."""
    C = corners.shape[1] // 8
    fx, fy, fz = fs
    okf = ok.to(torch.float32)
    cf = corners.to(torch.float32)
    out = None
    for dz in (0, 1):
        wz = fz if dz else 1.0 - fz
        for dy in (0, 1):
            wy = fy if dy else 1.0 - fy
            for dx in (0, 1):
                wx = fx if dx else 1.0 - fx
                s = dz * 4 + dy * 2 + dx
                w = wz * wy * wx * okf
                contrib = cf[:, s * C:(s + 1) * C] * w[:, None]
                out = contrib if out is None else out + contrib
    return out


def grid_sample_3d(grid: torch.Tensor, coords: torch.Tensor,
                   compute_dtype: str = "float32") -> torch.Tensor:
    """Trilinear sample of grid (C, D, H, W) at coords (..., >=3) in [-1, 1]
    -> (..., C). compute_dtype="bfloat16" gathers the table in bf16, as the
    JAX package does on its fast path."""
    gdt = torch.bfloat16 if compute_dtype == "bfloat16" else None
    dims = grid.shape[1:]
    table = pack_corner_table(grid, dtype=gdt)
    shape = coords.shape[:-1]
    cf = coords.reshape(-1, coords.shape[-1])
    rows, fs, ok = _cell_geometry(cf, dims)
    out = interp_corners(table[rows], fs, ok)
    return out.reshape(shape + (grid.shape[0],))
