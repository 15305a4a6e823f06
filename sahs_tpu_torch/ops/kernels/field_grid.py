"""The NeRF ops with autograd: the grid-coupled level ops (counterpart of
``sahs_tpu/ops/pallas/field_grid.py``) and the per-point field (of
``field_mlp.py:nerf_mlp_apply_fused``).

The JAX grid-coupled ops span an XLA row gather of the corner table and a
Pallas level kernel, and differentiate as one custom VJP
(field_grid.py:121-259). Here the level kernels gather the rows
themselves, so the corner table is packed once per frame, next to the
folded weights, and each op is a ``torch.autograd.Function``:

  nerf_render_level_grid   forward K5 (MLP + interp + compositing),
                           backward K6, the conditioning unfold, K9
  nerf_mlp_apply_rayd_grid forward K7 (the raw field),
                           backward K8, the conditioning unfold, K9
  nerf_mlp_apply_fused     forward K11 (the raw field on per-point inputs),
                           backward K12, the conditioning unfold

A model without the spatial-embedding grid runs the two grid-coupled ops
in their grid-free form (JAX: ``field_mlp.py:nerf_render_level`` :3187 and
``nerf_mlp_apply_rayd`` :2399, se=None): grid None, and no corner table or
rows in the op; K5/K6 and K7/K8 run with C = 0 and the backward has no
dGrid (no K9).

All are differentiable with respect to the NeRF module's parameters, their
point inputs, the conditioning (and so AudioNet and the latent code behind
it); the grid-coupled ops also to the grid and, for the level op, the
background prior; z, the sigma noise and the corner-table rows get no
gradient. Their dGrid pass (K9) runs over the points ray by ray: it bins
them by cell, so it needs no sample-major copy (the JAX op's order,
field_grid.py:80-85). The per-point op takes the spatial
embedding as an input, sampled before it by ``ops/grid.grid_sample_3d``,
whose backward (K10) carries the gradient on to the grid.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from ..grid import pack_corner_table
from .field_mlp import torch_dtype, trunk_params, unfold_cond_grads
from .grid_bwd import grid_dg_coords
from .level_train import nerf_level_vjp, nerf_mlp_vjp, nerf_rayd_vjp
from .nerf_level import (LevelWeights, level_param_grads, nerf_level_forward,
                         nerf_rayd_forward)
from .nerf_mlp import nerf_mlp_forward_fused


def corner_table(grid: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """(C, D, H, W) grid -> ((D+1)(H+1)(W+1), 8C) corner table in the
    compute dtype: bf16 when compute_dtype is bfloat16, as the JAX op
    casts it."""
    with torch.no_grad():
        return pack_corner_table(grid, dtype=torch_dtype(compute_dtype))


def gather_corners_from_rows(grid: torch.Tensor, rows: torch.Tensor,
                             compute_dtype: str) -> torch.Tensor:
    """(C, D, H, W) grid + table rows (any shape) -> (P, 8C) corner rows, in
    bf16 when compute_dtype is bfloat16 (field_grid.py:67-77)."""
    return corner_table(grid, compute_dtype)[rows.reshape(-1).long()]


@dataclasses.dataclass
class GridLevelOp:
    """What a level op holds beside its differentiable inputs: the NeRF
    module and its parameters, the folded weights (``prepare_level`` of
    this frame's conditioning), the corner table and the table rows of the
    points (both None for the grid-free form), the ray directions (R, 3),
    the sample count, the grid's (C, D, H, W) (None without a grid), and
    for the level op z (R, S) and the scaled sigma noise (R, S) | None."""
    nerf: torch.nn.Module
    params: List[torch.Tensor]
    weights: LevelWeights
    table: Optional[torch.Tensor]
    rows: Optional[torch.Tensor]
    dirs: torch.Tensor
    samples: int
    compute_dtype: str
    grid_shape: Optional[Sequence[int]]
    z: Optional[torch.Tensor] = None
    noise: Optional[torch.Tensor] = None


def _unfold(op: GridLevelOp, grads: dict, cond: torch.Tensor) -> torch.Tensor:
    """Raw-trunk gradients from the folded ones, in place; returns d(cond)."""
    spec = op.nerf.spec
    raw = [{"w": p["w"].detach(), "b": p["b"].detach()}
           for p in trunk_params(op.nerf.trunk)]
    grads["trunk"], dcond = unfold_cond_grads(
        raw, grads["trunk"], cond, spec.skip_connect_every, spec.hidden_size,
        spec.pe_xyz_dim + spec.ambient_pe_dim)
    return dcond


def _backward_tail(op: GridLevelOp, pts_raw, gse, grads, cond):
    """The conditioning unfold, the parameters' gradients in ``op.params``
    order, and dGrid (K9) over the points as the level holds them, ray by
    ray: K9 bins them by cell, so their order does not matter (None for
    the grid-free form)."""
    dcond = _unfold(op, grads, cond)
    by_param = {}
    level_param_grads(by_param, op.nerf, grads)
    dG = None
    if gse is not None:
        dG = grid_dg_coords(pts_raw, gse, op.grid_shape)
    return dcond, dG, [by_param.get(p) for p in op.params]


def _dims(op: GridLevelOp):
    return None if op.grid_shape is None else tuple(op.grid_shape[1:])


class _LevelGrid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, pts_raw, bg, cond, grid, *params):
        ctx.op = op
        ctx.save_for_backward(pts_raw, bg, cond)
        return nerf_level_forward(pts_raw, op.dirs, op.table, op.rows, op.z, bg,
                                  op.noise, op.weights, op.compute_dtype,
                                  _dims(op))

    @staticmethod
    def backward(ctx, g_rgb, g_w):
        op = ctx.op
        pts_raw, bg, cond = ctx.saved_tensors
        gx, gse, g_bg, grads = nerf_level_vjp(
            pts_raw, op.dirs, op.table, op.rows, op.z, bg, op.noise, g_rgb, g_w,
            op.weights, op.compute_dtype, _dims(op))
        dcond, dG, dparams = _backward_tail(op, pts_raw, gse, grads, cond)
        return (None, gx, g_bg, dcond, dG, *dparams)


class _RaydGrid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, pts_raw, cond, grid, *params):
        ctx.op = op
        ctx.save_for_backward(pts_raw, cond)
        return nerf_rayd_forward(pts_raw, op.dirs, op.table, op.rows, op.weights,
                                 op.compute_dtype, _dims(op))

    @staticmethod
    def backward(ctx, g):
        op = ctx.op
        pts_raw, cond = ctx.saved_tensors
        gx, gse, grads = nerf_rayd_vjp(pts_raw, op.dirs, op.table, op.rows, g,
                                       op.weights, op.compute_dtype, _dims(op))
        dcond, dG, dparams = _backward_tail(op, pts_raw, gse, grads, cond)
        return (None, gx, dcond, dG, *dparams)


def nerf_render_level_grid(op: GridLevelOp, grid: Optional[torch.Tensor],
                           pts_raw: torch.Tensor, bg: Optional[torch.Tensor],
                           cond: torch.Tensor):
    """The grid-coupled level (field_grid.py:262-277): pts_raw (P, 3 +
    ambient) packed [warped | ambient], grid (C, D, H, W) (None for the
    grid-free level, field_mlp.py:3187-3201), bg (R, 15) | None, cond the
    level's conditioning. Returns (rgb_map (R, 16), weights (R, S))."""
    return _LevelGrid.apply(op, pts_raw, bg, cond, grid, *op.params)


def nerf_mlp_apply_rayd_grid(op: GridLevelOp, grid: Optional[torch.Tensor],
                             pts_raw: torch.Tensor,
                             cond: torch.Tensor) -> torch.Tensor:
    """The grid-coupled raw field (field_grid.py:176-188; grid None for the
    grid-free one, field_mlp.py:2399-2417): (P, 16) [rgb3 | seg12 |
    sigma1]."""
    return _RaydGrid.apply(op, pts_raw, cond, grid, *op.params)


@dataclasses.dataclass
class PointOp:
    """What the per-point op holds beside its differentiable inputs: the
    NeRF module and its parameters and the folded weights
    (``prepare_level`` of this frame's conditioning)."""
    nerf: torch.nn.Module
    params: List[torch.Tensor]
    weights: LevelWeights
    compute_dtype: str


class _PointMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, pts_raw, extra, cond, *params):
        ctx.op = op
        ctx.save_for_backward(pts_raw, extra, cond)
        return nerf_mlp_forward_fused(pts_raw, extra, op.weights, op.compute_dtype)

    @staticmethod
    def backward(ctx, g):
        op = ctx.op
        pts_raw, extra, cond = ctx.saved_tensors
        gx, gextra, grads = nerf_mlp_vjp(pts_raw, extra, g, op.weights,
                                         op.compute_dtype)
        dcond = _unfold(op, grads, cond)
        by_param = {}
        level_param_grads(by_param, op.nerf, grads)
        return (None, gx, gextra, dcond, *[by_param.get(p) for p in op.params])


def nerf_mlp_apply_fused(op: PointOp, pts_raw: torch.Tensor,
                         extra: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """The per-point NeRF field (field_mlp.py:1356-1428): pts_raw (P, 3 +
    ambient) packed [warped | ambient], extra (P, 3 + C) [raw dir | spatial
    embedding] (the direction alone, C = 0, without a grid), cond the
    level's conditioning, folded into the weights.
    Forward K11, backward K12 and the conditioning unfold; differentiable
    with respect to the module's parameters, both inputs and ``cond``.
    Returns (P, 16) [rgb3 | seg12 | sigma1]."""
    return _PointMLP.apply(op, pts_raw, extra, cond, *op.params)
