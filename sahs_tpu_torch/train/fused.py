"""The fused Stage-I gradient path (counterpart of ``sahs_tpu/train/fused.py``).

Both render levels and every gradient of the Stage-I loss are computed in
one forward pass, because the loss is per-ray analytic (its cotangents are
formed inside the train-level kernel K2) and because the sorted fine sample
set holds every coarse point bit for bit (the same float32 o + d z at equal
z), so the coarse level's point cotangents can be scattered into their
fine slots and the pair backward (K3) and dGrid (K4), both linear in their
cotangents, run once over the fine points (fused.py:370-413).

A step runs: coarse z; K15 for the coarse points; K1 on them; K2 on the
coarse level; sample_pdf and the stable sort; K15 for the sorted fine
points; K1 on them; K2 on the fine level; the coarse-in-fine scatter;
one K3 and (with a grid) one K4 over the fine points; the
conditioning-fold gradients unfolded.

``stage1_fused`` is a ``torch.autograd.Function``: its forward computes all
gradients and its backward scales them by the scalar loss cotangent
(fused.py:538-548). Only the loss is differentiable: rgb_c, rgb_f and w_f
come back detached. The Function returns d(driving), so autograd carries
it on into AudioNet, and d(bg) when the background is trained.

A model without the spatial-embedding grid takes the same path with K2
in its grid-free form: no corner table, no rows, no gse scatter and no K4
(fused.py:193-474 with ``use_grid`` off).

Both levels' positions come from K15 (ops/kernels/points.py), which
rounds as the PyTorch expression ro + rd z does, bit for bit. The JAX
package keeps its kernel behind ``SAHS_PTS_KERNEL`` (fused.py:156-163)
for a cost of its TPU layout (the 128-lane padded intermediate), which
the port does not have, so the port takes the kernel on every step.

Four structural variants, switched as in the JAX package by environment
variables read at import (fused.py:128-175) into module flags that tests
may patch. Each computes the default step's function; what differs is
where the coarse points' backward runs, and so the order of sums:
  - ``SAHS_BWD_SPLIT`` (``_BWD_SPLIT``): no coarse-in-fine merge. K3 runs
    once per level, on each level's own cotangent, and with a grid K4 once
    per level; the two levels' gradients are summed (fused.py:449-466,
    :410-415). Exact because both backwards are linear in the cotangent:
    the merge only regroups the sum over the coarse points.
  - ``SAHS_FUSED_UNION`` (``_UNION``): K1 runs on the new points alone (no
    rows); the fine level's points are the coarse ∪ new union permuted by a
    stable argsort of [z_c | z_new] (ties coarse first, as the stable sort
    puts them), its rows computed from the permuted packed points with
    ``_cell_geometry``'s expression (the one K1's rows follow, so the rows
    equal K1's bit for bit). The fine cotangents go back through the
    inverse permutation and the coarse ones are added at their own slots:
    one K3 over the union points and, with a grid, one K9 on the union
    coordinates (fused.py:309-360). Exact: a permutation moves values
    without rounding, and each union point's cotangent is the same sum of
    two terms as the merge's.
  - ``SAHS_PAIR_RAYS`` (``_PAIR_RAYS``): K1 and K3 take their rays= form,
    building each position in the kernel as K15 does (two roundings), so
    no position array is made and every coarse point still reappears bit
    for bit among the fine points (fused.py:240-247, :290-293, :427-440).
    Under ``_UNION`` only the coarse level takes it: the new points go
    through the positional K1, and the union's K3 through K15's points.
  - ``SAHS_PAIR_FOLD`` (``_PAIR_FOLD``, ignored under ``_UNION``): K2's
    pair= form runs K2's launches with the level's gx written to a float32
    scratch, then K3's rays= launches on that gx (no K3 call of the step's
    own); the two levels' pair gradients are summed; with a grid K4
    runs once per level, as under the split (fused.py:252-256, :266-277,
    :416-423). Exact as the split is: the same per-level backwards.
"""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import torch

from ..models import fields
from ..models.nerface import (NeRFaceModel, build_pe_groups,
                              level_kernel_compatible, pair_kernel_ok)
from ..ops.kernels.deform_pair import (deform_pair_forward, deform_pair_vjp,
                                       pair_param_grads, prepare_pair)
from ..ops.grid import _cell_geometry
from ..ops.kernels.field_grid import corner_table
from ..ops.kernels.grid_bwd import grid_dg, grid_dg_coords
from ..ops.kernels.level_train import level_train_apply
from ..ops.kernels.nerf_level import level_param_grads
from ..ops.kernels.points import build_pts
from ..ops.sampling import coarse_z_vals, sample_pdf
from ..utils import profiling


# The JAX package's structural switches (fused.py:128-175), read at import
# from the same environment variables; see the module docstring.
_PAIR_RAYS = os.environ.get("SAHS_PAIR_RAYS", "0") == "1"
_PAIR_FOLD = os.environ.get("SAHS_PAIR_FOLD", "0") == "1"
_UNION = os.environ.get("SAHS_FUSED_UNION", "0") == "1"
_BWD_SPLIT = os.environ.get("SAHS_BWD_SPLIT", "0") == "1"


@dataclasses.dataclass(frozen=True)
class FusedCfg:
    """Static settings of the fused train renderer."""
    num_coarse: int
    num_fine: int
    near: float
    far: float
    perturb: bool
    noise_std: float
    lindisp: bool
    compute_dtype: str
    bg_sup_weight: float       # background_loss_weight when supervised, 0 off
    # the rays the background term averages over: None = this call's; a
    # ray group's rank passes the whole batch's (train/stage1.py)
    num_rays: Optional[int] = None


class TrainDraws(NamedTuple):
    """Injectable random draws of one train step (None = draw from the
    generator): Gumbel noise of the ray pick (H*W,), coarse jitter
    t_rand (R, Nc), importance uniforms u (R, Nf), and standard-normal
    sigma noise per level (R, Nc) and (R, Nc + Nf)."""
    gumbel: Optional[torch.Tensor] = None
    t_rand: Optional[torch.Tensor] = None
    u: Optional[torch.Tensor] = None
    noise_coarse: Optional[torch.Tensor] = None
    noise_fine: Optional[torch.Tensor] = None


def stage1_fused_eligible(spec, render) -> bool:
    """The configurations the fused path's kernels cover, the JAX package's
    predicate (fused.py:83-100): the kernel path with the deformation pair,
    composited in the kernel, with a fine level, at sample counts the level
    kernels take; with a grid, one of the shape the JAX kernels take; a
    model without the grid qualifies too."""
    # JAX's clause on the grid (fused.py:86-95) also holds its slab dGrid
    # kernel's block to the TPU's VMEM; on this card K4 needs only the
    # 32-channel layout of the packed gse
    if spec.use_spatial_embeddings and fields.SPATIAL_EMBEDDING_DIM != 32:
        return False
    return (render.use_pallas and render.fuse_composite
            and not render.white_background and spec.use_viewdirs
            and pair_kernel_ok(spec)
            and spec.fine is not None and render.num_fine > 0
            and level_kernel_compatible(render.num_coarse)
            and level_kernel_compatible(render.num_coarse + render.num_fine))


def ray_loss_weights(mask_s: torch.Tensor, ce_weight: float,
                     mouth_loss_weight: float) -> torch.Tensor:
    """Per-ray (R, 2) [w_l2, w_ce] with sum_r w_l2 ||rgb - t||^2 + w_ce CE
    equal to the Stage-I level loss (fused.py:103-116): the per-class count
    normalisers depend only on the mask."""
    R = mask_s.shape[0]
    counts = torch.sum(mask_s != 0, dim=0).to(mask_s.dtype)
    counts = torch.where(counts == 0, torch.ones_like(counts), counts)
    mouth = torch.sum(mask_s[:, 7:9] / counts[7:9], dim=-1)
    w_l2 = 1.0 / R + mouth_loss_weight * mouth
    w_ce = ce_weight / R + mouth_loss_weight * mouth
    return torch.stack([w_l2, w_ce], dim=-1)


def _level_loss(rgb_map, tgt, lw):
    """The scalar K2's cotangents differentiate (fused.py:119-125)."""
    diff = torch.sum(torch.square(rgb_map[:, :3] - tgt[:, :3]), dim=-1)
    ce = -torch.sum(tgt[:, 3:15] * torch.log(rgb_map[:, 3:15] + 1e-10), dim=-1)
    return torch.sum(lw[:, 0] * diff + lw[:, 1] * ce)


def _cond_parts(dcond, spec_parts, out, name="driving"):
    """Route the d(cond) slices of ``name`` (driving or latent) back to its
    gradient; pose is data and its slice is dropped."""
    i = 0
    for part, size in spec_parts:
        if part == name:
            out = out + dcond[i:i + size]
        i += size
    return out


def _tree_add(a, b):
    """Leafwise a + b of two gradient trees of one layout."""
    if isinstance(a, dict):
        return {k: _tree_add(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return [_tree_add(x, y) for x, y in zip(a, b)]
    return a + b


def fused_forward(model: NeRFaceModel, fcfg: FusedCfg, driving, pose_enc,
                  ro, rd, tgt, lw, bg, generator=None,
                  draws: TrainDraws = TrainDraws(), latent=None):
    """Both levels, the loss and its gradients (fused.py:186-516), in the
    variant the module's flags select. Returns (loss, rgb_c (R, 15), rgb_f
    (R, 15), w_f (R, Nc + Nf), {parameter: grad}, d_driving, d_bg | None,
    d_latent | None)."""
    spec = model.spec
    cdt = fcfg.compute_dtype
    R = ro.shape[0]
    Sc, Sn = fcfg.num_coarse, fcfg.num_fine
    Sf = Sc + Sn
    dev = ro.device
    warp_pe, pts_pe, dir_pe = build_pe_groups(spec)
    driving = driving.detach()
    latent = None if latent is None else latent.detach()
    pair_parts = ([("driving", driving.shape[0])] if spec.warp.include_driving
                  else []) + [("pose", pose_enc.shape[0])]
    cond_pair = torch.cat([driving, pose_enc]) if spec.warp.include_driving \
        else pose_enc

    def nerf_cond(nspec):
        parts, vals = [], []
        if latent is not None and nspec.latent_code_dim > 0:
            parts.append(("latent", latent.shape[0]))
            vals.append(latent)
        if nspec.include_driving:
            parts.append(("driving", driving.shape[0]))
            vals.append(driving)
        if nspec.use_pose:
            parts.append(("pose", pose_enc.shape[0]))
            vals.append(pose_enc)
        return (torch.cat(vals) if vals else pose_enc[:0]), parts

    pair = prepare_pair(model.warp, model.hyper, cond_pair, warp_pe)
    grid = dims = table = None          # the grid-free form without a grid
    if model.spatial_embeddings is not None:
        grid = model.spatial_embeddings.detach()
        dims = tuple(grid.shape[1:])
        table = corner_table(grid, cdt)

    # the ray origins arrive as a broadcast view of the camera's centre:
    # one copy a step, not one in each K15 call
    ro_rows = ro.contiguous()

    def points(z):
        # the same float32 roundings at both levels: every coarse point
        # reappears bit for bit among the sorted fine points
        return build_pts(ro_rows, rd, z)

    def pair_points(z):
        """K1's and K3's points at z: (K15's positions, None), or under
        _PAIR_RAYS (None, the rays), which the kernels build alike."""
        return (None, (ro_rows, rd, z)) if _PAIR_RAYS else (points(z), None)

    # K1 and K3 on points take the arguments they always took; on rays
    # their rays= form
    def pair_forward(pts, rays, samples, dims_):
        if rays is None:
            return deform_pair_forward(pts, pair, cdt, samples, dims_)
        return deform_pair_forward(None, pair, cdt, samples, dims_, rays=rays)

    def pair_vjp(pts, rays, g, g2):
        if rays is None:
            return deform_pair_vjp(pts, pair, g, g2, cdt)
        return deform_pair_vjp(None, pair, g, g2, cdt, rays=rays)

    pair_fold = _PAIR_FOLD and not _UNION
    merge = not (_BWD_SPLIT or pair_fold)
    fold = (pair, ro_rows) if pair_fold else None

    def noise_for(shape, injected):
        if fcfg.noise_std <= 0:
            return None
        if injected is None:
            injected = torch.randn(shape, generator=generator, device=dev)
        return injected * fcfg.noise_std

    with profiling.span("fused.z"):
        nearv = torch.full((R,), fcfg.near, device=dev)
        farv = torch.full((R,), fcfg.far, device=dev)
        z_c = coarse_z_vals(nearv, farv, Sc, lindisp=fcfg.lindisp,
                            perturb=fcfg.perturb, generator=generator,
                            t_rand=draws.t_rand)
    pts_c, rays_c = pair_points(z_c)
    packed_c, rows_c = pair_forward(pts_c, rays_c, Sc, dims)
    cond_c, parts_c = nerf_cond(spec.coarse)
    # with the fold, gx_c / gx_f are the levels' pair gradient trees
    rgb_c, w_c, gx_c, gse_c, gbg_c, grads_c, dcond_c = level_train_apply(
        model.coarse, cond_c, packed_c, rd, table, rows_c, z_c, bg,
        noise_for(z_c.shape, draws.noise_coarse), tgt, lw, pts_pe, dir_pe,
        cdt, dims, 0.0, pair=fold)

    with profiling.span("fused.z"):
        z_mid = 0.5 * (z_c[..., 1:] + z_c[..., :-1])
        z_new = sample_pdf(z_mid, w_c[..., 1:-1], Sn, det=not fcfg.perturb,
                           generator=generator, u=draws.u)
    bg_sup = (fcfg.bg_sup_weight / (fcfg.num_rays or R)
              if (fcfg.bg_sup_weight > 0 and bg is not None) else 0.0)
    z_cat = torch.cat([z_c, z_new], dim=-1)
    if _UNION:
        # the union [coarse | new] of each ray, permuted into z order
        pts_n = points(z_new)
        packed_n, _ = pair_forward(pts_n, None, Sn, None)
        with profiling.span("fused.sort"):
            perm = torch.argsort(z_cat, dim=-1, stable=True)
            z_f = torch.gather(z_cat, 1, perm)
            packed_u = torch.cat([packed_c.reshape(R, Sc, -1),
                                  packed_n.reshape(R, Sn, -1)], dim=1)
            packed_f = torch.gather(packed_u, 1, perm[..., None].expand(
                -1, -1, packed_u.shape[-1])).reshape(R * Sf, -1)
            rows_f = (None if dims is None else
                      _cell_geometry(packed_f[:, :3], dims)[0].to(torch.int32)
                      .reshape(R, Sf))
    else:
        with profiling.span("fused.sort"):
            z_f = torch.sort(z_cat, dim=-1, stable=True).values
        pts_f, rays_f = pair_points(z_f)
        packed_f, rows_f = pair_forward(pts_f, rays_f, Sf, dims)
    cond_f, parts_f = nerf_cond(spec.fine)
    rgb_f, w_f, gx_f, gse_f, gbg_f, grads_f, dcond_f = level_train_apply(
        model.fine, cond_f, packed_f, rd, table, rows_f, z_f, bg,
        noise_for(z_f.shape, draws.noise_fine), tgt, lw, pts_pe, dir_pe,
        cdt, dims, bg_sup, pair=fold)

    dG = None
    if _UNION:
        # the fine cotangents back onto the union through the inverse
        # permutation, the coarse ones added at their own slots; one K3
        # over the union points, one K9 on the union coordinates
        inv = torch.argsort(perm, dim=-1)

        def to_union(x_f, x_c):
            w = x_f.shape[-1]
            xu = torch.gather(x_f.reshape(R, Sf, w), 1, inv[..., None].expand(-1, -1, w))
            xu[:, :Sc] += x_c.reshape(R, Sc, w)
            return xu.reshape(R * Sf, w)

        pts_u = torch.cat([(points(z_c) if pts_c is None else pts_c).reshape(R, Sc, 3),
                           pts_n.reshape(R, Sn, 3)], dim=1).reshape(-1, 3)
        pair_g = pair_vjp(pts_u, None, to_union(gx_f, gx_c), None)
        if grid is not None:
            dG = grid_dg_coords(packed_u.reshape(R * Sf, -1),
                                to_union(gse_f, gse_c), grid.shape)
    elif merge:
        # coarse cotangents into their sorted-fine slots: slot(j) = j +
        # #{z_new < z_c[j]}, ties coarse-first as the stable sort puts them;
        # one term per sum, so the scatter is exact
        with profiling.span("fused.scatter"):
            pos_c = (torch.arange(Sc, device=dev)[None, :]
                     + torch.sum(z_new[:, None, :] < z_c[:, :, None], dim=-1))
            slot = (torch.arange(R, device=dev)[:, None] * Sf + pos_c).reshape(-1)
            gx_add = torch.zeros_like(gx_f).index_add_(0, slot, gx_c)
        pair_g = pair_vjp(pts_f, rays_f, gx_f, gx_add)
        if grid is not None:
            with profiling.span("fused.scatter"):
                gse_add = torch.zeros_like(gse_f).index_add_(0, slot, gse_c)
            dG = grid_dg(packed_f, rows_f, gse_f, gse_add, grid.shape)
    else:
        # per level: the fold's trees from K2, or K3 on each level's points
        pair_g = (_tree_add(gx_c, gx_f) if pair_fold else _tree_add(
            pair_vjp(pts_c, rays_c, gx_c, None), pair_vjp(pts_f, rays_f, gx_f, None)))
        if grid is not None:
            dG = (grid_dg(packed_c, rows_c, gse_c, None, grid.shape)
                  + grid_dg(packed_f, rows_f, gse_f, None, grid.shape))

    with profiling.span("fused.unfold"):
        grads, dcond = pair_param_grads(model.warp, model.hyper, pair_g, cond_pair)
        d_driving = _cond_parts(dcond, pair_parts, torch.zeros_like(driving))
        level_param_grads(grads, model.coarse, grads_c)
        level_param_grads(grads, model.fine, grads_f)
        d_driving = _cond_parts(dcond_c, parts_c, d_driving)
        d_driving = _cond_parts(dcond_f, parts_f, d_driving)
        d_latent = None
        if latent is not None:
            d_latent = _cond_parts(dcond_c, parts_c, torch.zeros_like(latent), "latent")
            d_latent = _cond_parts(dcond_f, parts_f, d_latent, "latent")
    if grid is not None:
        grads[model.spatial_embeddings] = dG

    loss = _level_loss(rgb_c, tgt, lw) + _level_loss(rgb_f, tgt, lw)
    if bg_sup > 0.0:
        bgerr = torch.sum(torch.square(bg[:, :3] - tgt[:, :3]), dim=-1)
        loss = loss + bg_sup * torch.sum(w_f[:, -1] * bgerr)
    d_bg = (gbg_c + gbg_f) if bg is not None else None
    return (loss, rgb_c[:, :15], rgb_f[:, :15], w_f, grads, d_driving, d_bg,
            d_latent)


class _Stage1Fused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, params, driving, bg, latent, *param_tensors):
        loss, rgb_c, rgb_f, w_f, grads, d_driving, d_bg, d_latent = run()
        ctx.grads = ([d_driving, d_bg, d_latent]
                     + [grads.get(p) for p in params])
        ctx.mark_non_differentiable(rgb_c, rgb_f, w_f)
        return loss, rgb_c, rgb_f, w_f

    @staticmethod
    def backward(ctx, ct, *_):
        scaled = [None if g is None else ct * g for g in ctx.grads]
        return (None, None, *scaled)


def stage1_fused(model: NeRFaceModel, fcfg: FusedCfg, driving, pose_enc, ro,
                 rd, tgt, lw, bg, generator=None,
                 draws: TrainDraws = TrainDraws(), latent=None):
    """Both levels and the Stage-I loss, with every gradient computed in the
    forward. driving: AudioNet's output (or the expression vector), with
    its autograd history; pose_enc (36,); ro/rd (R, 3); tgt (R, 15)
    [target rgb | seg mask]; lw (R, 2) from ray_loss_weights; bg (R, 15) |
    None, with history when the background is trained.

    Returns (loss, rgb_coarse (R, 15), rgb_fine (R, 15), weights_fine
    (R, Nc + Nf)); only the loss carries gradients, into the model's
    deformation, NeRF and grid parameters, into driving, into bg and into
    the frame's latent code (L,) | None, which rides the levels'
    conditioning (fused.py:204-205). Without a grid there is no dGrid."""
    params = [p for net in (model.warp, model.hyper, model.coarse, model.fine)
              for p in net.parameters()]
    if model.spatial_embeddings is not None:
        params.append(model.spatial_embeddings)

    def run():
        return fused_forward(model, fcfg, driving, pose_enc, ro, rd, tgt, lw,
                             None if bg is None else bg.detach(), generator,
                             draws, latent)

    none = torch.zeros((), device=ro.device)
    return _Stage1Fused.apply(run, params, driving,
                              bg if bg is not None else none,
                              latent if latent is not None else none, *params)
