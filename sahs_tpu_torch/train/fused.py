"""The fused Stage-I gradient path (counterpart of ``sahs_tpu/train/fused.py``).

Both render levels and every gradient of the Stage-I loss are computed in
one forward pass, because the loss is per-ray analytic (its cotangents are
formed inside the train-level kernel K2) and because the sorted fine sample
set holds every coarse point bit for bit (the same float32 o + d z at equal
z), so the coarse level's point cotangents can be scattered into their
fine slots and the pair backward (K3) and dGrid (K4), both linear in their
cotangents, run once over the fine points (fused.py:370-413).

A step runs: coarse z; K1 on the coarse points; K2 on the coarse level;
sample_pdf and the stable sort; K1 on the sorted fine points; K2 on the
fine level; the coarse-in-fine scatter; one K3 and one K4 over the fine
points; the conditioning-fold gradients unfolded.

``stage1_fused`` is a ``torch.autograd.Function``: its forward computes all
gradients and its backward scales them by the scalar loss cotangent
(fused.py:538-548). Only the loss is differentiable: rgb_c, rgb_f and w_f
come back detached. The Function returns d(driving), so autograd carries
it on into AudioNet, and d(bg) when the background is trained.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..models.nerface import NeRFaceModel, build_pe_groups, kernel_path_ok
from ..ops.kernels.deform_pair import deform_pair_forward, deform_pair_vjp, prepare_pair
from ..ops.kernels.field_grid import corner_table
from ..ops.kernels.field_mlp import trunk_params, unfold_cond_grads
from ..ops.kernels.grid_bwd import grid_dg
from ..ops.kernels.level_train import level_train_apply
from ..ops.sampling import coarse_z_vals, sample_pdf


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


STILL_TO_PORT = ("this configuration needs the autograd fallback and its "
                 "kernels, still to be ported: K6 nerf_level_vjp, K7 "
                 "nerf_rayd_forward, K8 nerf_rayd_vjp, K9 grid_dg_slab, K10 "
                 "grid_bwd_fused (ROADMAP Queue 2)")


def stage1_fused_eligible(spec, render) -> bool:
    """The configurations the fused path's kernels cover (fused.py:83-100):
    the kernel path with the deformation pair and the grid-coupled level,
    composited in the kernel, with a fine level."""
    return (render.use_pallas and render.fuse_composite
            and not render.white_background and kernel_path_ok(spec)
            and spec.fine is not None and render.num_fine > 0)


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


def _linear_grads(out: dict, lin, g) -> None:
    out[lin.weight] = g["w"].t()
    out[lin.bias] = g["b"]


def _level_param_grads(out: dict, nerf, g) -> None:
    for lin, gl in zip(nerf.trunk.layers, g["trunk"]):
        _linear_grads(out, lin, gl)
    for name in ("fc_feat", "fc_alpha", "fc_rgb", "fc_seg"):
        _linear_grads(out, getattr(nerf, name), g[name])
    for lin, gl in zip(nerf.dir, g["dir"]):
        _linear_grads(out, lin, gl)
    for lin, gl in zip(nerf.seg, g["seg"]):
        _linear_grads(out, lin, gl)


def _cond_parts(dcond, spec_parts, out):
    """Route d(cond) slices back to d(driving); pose is data and its slice
    is dropped."""
    i = 0
    for name, size in spec_parts:
        if name == "driving":
            out = out + dcond[i:i + size]
        i += size
    return out


def fused_forward(model: NeRFaceModel, fcfg: FusedCfg, driving, pose_enc,
                  ro, rd, tgt, lw, bg, generator=None,
                  draws: TrainDraws = TrainDraws()):
    """Both levels, the loss and its gradients (fused.py:186-516, default
    branch). Returns (loss, rgb_c (R, 15), rgb_f (R, 15), w_f (R, Nc + Nf),
    {parameter: grad}, d_driving, d_bg | None)."""
    spec = model.spec
    cdt = fcfg.compute_dtype
    R = ro.shape[0]
    Sc, Sn = fcfg.num_coarse, fcfg.num_fine
    Sf = Sc + Sn
    dev = ro.device
    warp_pe, pts_pe, dir_pe = build_pe_groups(spec)
    driving = driving.detach()
    pair_parts = ([("driving", driving.shape[0])] if spec.warp.include_driving
                  else []) + [("pose", pose_enc.shape[0])]
    cond_pair = torch.cat([driving, pose_enc]) if spec.warp.include_driving \
        else pose_enc

    def nerf_cond(nspec):
        parts, vals = [], []
        if nspec.include_driving:
            parts.append(("driving", driving.shape[0]))
            vals.append(driving)
        if nspec.use_pose:
            parts.append(("pose", pose_enc.shape[0]))
            vals.append(pose_enc)
        return (torch.cat(vals) if vals else pose_enc[:0]), parts

    pair = prepare_pair(model.warp, model.hyper, cond_pair, warp_pe)
    grid = model.spatial_embeddings.detach()
    dims = tuple(grid.shape[1:])
    table = corner_table(grid, cdt)

    def points(z):
        # one float32 expression at both levels: every coarse point
        # reappears bit for bit among the sorted fine points
        return (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3)

    def noise_for(shape, injected):
        if fcfg.noise_std <= 0:
            return None
        if injected is None:
            injected = torch.randn(shape, generator=generator, device=dev)
        return injected * fcfg.noise_std

    nearv = torch.full((R,), fcfg.near, device=dev)
    farv = torch.full((R,), fcfg.far, device=dev)
    z_c = coarse_z_vals(nearv, farv, Sc, lindisp=fcfg.lindisp,
                        perturb=fcfg.perturb, generator=generator,
                        t_rand=draws.t_rand)
    pts_c = points(z_c)
    packed_c, rows_c = deform_pair_forward(pts_c, pair, cdt, Sc, dims)
    cond_c, parts_c = nerf_cond(spec.coarse)
    rgb_c, w_c, gx_c, gse_c, gbg_c, grads_c, dcond_c = level_train_apply(
        model.coarse, cond_c, packed_c, rd, table, rows_c, z_c, bg,
        noise_for(z_c.shape, draws.noise_coarse), tgt, lw, pts_pe, dir_pe,
        cdt, dims, 0.0)

    z_mid = 0.5 * (z_c[..., 1:] + z_c[..., :-1])
    z_new = sample_pdf(z_mid, w_c[..., 1:-1], Sn, det=not fcfg.perturb,
                       generator=generator, u=draws.u)
    bg_sup = (fcfg.bg_sup_weight / R
              if (fcfg.bg_sup_weight > 0 and bg is not None) else 0.0)
    z_f = torch.sort(torch.cat([z_c, z_new], dim=-1), dim=-1, stable=True).values
    pts_f = points(z_f)
    packed_f, rows_f = deform_pair_forward(pts_f, pair, cdt, Sf, dims)
    cond_f, parts_f = nerf_cond(spec.fine)
    rgb_f, w_f, gx_f, gse_f, gbg_f, grads_f, dcond_f = level_train_apply(
        model.fine, cond_f, packed_f, rd, table, rows_f, z_f, bg,
        noise_for(z_f.shape, draws.noise_fine), tgt, lw, pts_pe, dir_pe,
        cdt, dims, bg_sup)

    # coarse cotangents into their sorted-fine slots: slot(j) = j +
    # #{z_new < z_c[j]}, ties coarse-first as the stable sort puts them;
    # one term per sum, so the scatter is exact
    pos_c = (torch.arange(Sc, device=dev)[None, :]
             + torch.sum(z_new[:, None, :] < z_c[:, :, None], dim=-1))
    slot = (torch.arange(R, device=dev)[:, None] * Sf + pos_c).reshape(-1)
    gx_add = torch.zeros_like(gx_f).index_add_(0, slot, gx_c)
    gse_add = torch.zeros_like(gse_f).index_add_(0, slot, gse_c)
    pair_g = deform_pair_vjp(pts_f, pair, gx_f, gx_add, cdt)
    dG = grid_dg(packed_f, rows_f, gse_f, gse_add, grid.shape)

    d_driving = torch.zeros_like(driving)
    grads = {}
    for name, net in (("warp", model.warp), ("hyper", model.hyper)):
        raw = [{"w": p["w"].detach(), "b": p["b"].detach()}
               for p in trunk_params(net.trunk)]
        tg, dcond = unfold_cond_grads(
            raw, pair_g[name]["trunk"], cond_pair, net.spec.skip_connect_every,
            net.spec.hidden_size, net.spec.pe_xyz_dim)
        for lin, gl in zip(net.trunk.layers, tg):
            _linear_grads(grads, lin, gl)
        _linear_grads(grads, net.out, pair_g[name]["out"])
        d_driving = _cond_parts(dcond, pair_parts, d_driving)
    _level_param_grads(grads, model.coarse, grads_c)
    _level_param_grads(grads, model.fine, grads_f)
    d_driving = _cond_parts(dcond_c, parts_c, d_driving)
    d_driving = _cond_parts(dcond_f, parts_f, d_driving)
    grads[model.spatial_embeddings] = dG

    loss = _level_loss(rgb_c, tgt, lw) + _level_loss(rgb_f, tgt, lw)
    if bg_sup > 0.0:
        bgerr = torch.sum(torch.square(bg[:, :3] - tgt[:, :3]), dim=-1)
        loss = loss + bg_sup * torch.sum(w_f[:, -1] * bgerr)
    d_bg = (gbg_c + gbg_f) if bg is not None else None
    return (loss, rgb_c[:, :15], rgb_f[:, :15], w_f, grads, d_driving, d_bg)


class _Stage1Fused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, params, driving, bg, *param_tensors):
        loss, rgb_c, rgb_f, w_f, grads, d_driving, d_bg = run()
        ctx.grads = ([d_driving, d_bg]
                     + [grads.get(p) for p in params])
        ctx.mark_non_differentiable(rgb_c, rgb_f, w_f)
        return loss, rgb_c, rgb_f, w_f

    @staticmethod
    def backward(ctx, ct, *_):
        scaled = [None if g is None else ct * g for g in ctx.grads]
        return (None, None, *scaled)


def stage1_fused(model: NeRFaceModel, fcfg: FusedCfg, driving, pose_enc, ro,
                 rd, tgt, lw, bg, generator=None,
                 draws: TrainDraws = TrainDraws()):
    """Both levels and the Stage-I loss, with every gradient computed in the
    forward. driving: AudioNet's output (or the expression vector), with
    its autograd history; pose_enc (36,); ro/rd (R, 3); tgt (R, 15)
    [target rgb | seg mask]; lw (R, 2) from ray_loss_weights; bg (R, 15) |
    None, with history when the background is trained.

    Returns (loss, rgb_coarse (R, 15), rgb_fine (R, 15), weights_fine
    (R, Nc + Nf)); only the loss carries gradients, into the model's
    deformation, NeRF and grid parameters, into driving and into bg."""
    params = [p for net in (model.warp, model.hyper, model.coarse, model.fine)
              for p in net.parameters()] + [model.spatial_embeddings]

    def run():
        return fused_forward(model, fcfg, driving, pose_enc, ro, rd, tgt, lw,
                             None if bg is None else bg.detach(), generator,
                             draws)

    bg_in = bg if bg is not None else torch.zeros((), device=ro.device)
    return _Stage1Fused.apply(run, params, driving, bg_in, *params)
