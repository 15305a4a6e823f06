"""K4: the gradient of the trilinear spatial-embedding sample with respect
to the grid (dGrid).

Replaces ``sahs_tpu/ops/pallas/grid_bwd.py:grid_dg_slab_packed`` (:211,
``pallas_call`` at :327), which the fused train path runs once per step
over the sorted fine points with the coarse level's cotangents scattered
in as a second input (train/fused.py:405-413). The CUDA kernel is
``csrc/grid_bwd.cu``.

    dG[c, z, y, x] = sum_p w_corner(p) * (gse[p, c] + gse2[p, c])

over the 8 corners of each point's cell, with zeros padding: a corner
outside the grid contributes nothing. The weights are those of the
forward sample (ops/grid._cell_geometry's exact expression), and each
point's cell is its corner-table row, mapped back to grid voxels with the
table's padding border dropped.

``grid_dg`` launches the kernel for CUDA tensors and counts the call in
``grid_dg.launches``; for CPU tensors it runs ``grid_dg_plain``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import _build
from ..grid import _cell_geometry


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
    dg = torch.zeros((D, H, W, C), dtype=f32, device=pts.device)
    fn = _build.function("grid_bwd", "sahs_grid_dg", "pppp" + "li" + "iiii" + "p" + "p")
    p = _build.ptr
    rc = fn(p(pts), p(rows), p(gse), p(gse2), P, PW, C, D, H, W, p(dg),
            _build.stream_ptr(pts.device))
    _build.check(rc, "grid_dg")
    grid_dg.launches += 1
    return dg.permute(3, 0, 1, 2)


grid_dg.launches = 0
