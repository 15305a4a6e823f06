"""Stage-I trainer (counterpart of ``sahs_tpu/train/stage1.py``).

One step (reference nerf-pytorch/train_stage_rays_auto.py:273-544):
  - semantic-weighted ray pick on the device (Gumbel top-k);
  - rays at the picked pixels, targets gathered;
  - the gradients: the fused path (train/fused.py: K1, K2, K3 and K4) when
    ``fused_grads`` is on and the configuration is ``stage1_fused_eligible``,
    else the autograd fallback: ``render_rays(differentiable=True)`` and
    ``loss.backward()`` (stage1.py:256-294), through the differentiable
    kernel ops (K1/K3, or for a warp-only, ambient-only or
    split-conditioning model K13/K14 a net; K5/K6 or K7/K8, K9; at a sample
    count the level kernels do not take, the per-point branch's K11/K12
    and K10; a model without the grid takes their grid-free forms, with
    no K4, K9 or K10), or with ``use_pallas`` off, or for a model without
    view directions, through the plain modules (K10 for the grid sample);
  - Adam with the reference's exponential decay, lr0 * factor^(step /
    (lr_decay * 1000)) at the pre-update count (stage1.py:110-126);
  - the dynamic ``sample_prob`` carry and the metrics.
``make_multi_train_step`` runs K steps a call (the JAX package's
``lax.scan`` loop, stage1.py:326-343, as a loop over the same step) on
batches stacked along a leading K axis by ``stack_batches``.

With a ray group (``parallel/mesh.py``; the JAX package's
``ray_constraint``, stage1.py:164, :201-210) each rank renders the
rank-th contiguous block of the step's rays and the step stays the single
step's: every rank picks the rays and forms the rays, targets, masks,
background rays and every draw of the whole step from the same generator
state, then keeps its block; the loss normalisers (``ray_loss_weights``,
the losses' 1/R and class counts, the background term's 1/R) are the
whole batch's, so the ranks' losses sum to the single step's; the latent
and grid regularisers count on rank 0 only; one sum all-reduce of a flat
bucket (every gradient, then the metrics' sums) comes before Adam, so
every rank takes the same Adam step and holds the same metrics and
``sample_prob``. At world size 1 the step is the single step plus that
all-reduce, bit for bit.

Loss stack (train_stage_rays_auto.py:455-492):
  L = [coarse_l2 + 0.02 coarse_ce + 0.005 sum(mouth_l2 + mouth_ce)] + fine(...)
      (+ 10 * 0.0005 ||grid||) (+ 10 * 0.0005 ||latent||)
      (+ background supervision * 0.001)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..models.nerface import (ModelSpec, NeRFaceModel, compute_driving,
                              encode_pose)
from ..ops import losses as L
from ..ops.rays import get_rays_at, ndc_rays
from ..ops.sampling import (bbox_ray_probs, gather_rays, semantic_ray_probs,
                            weighted_ray_indices)
from ..render.pipeline import Draws, RenderSettings, full_draws, render_rays
from ..utils import profiling
from ..utils.device import resolve_device
from ..utils.seg import NUM_CLASSES
from .fused import (FusedCfg, TrainDraws, ray_loss_weights, stage1_fused,
                    stage1_fused_eligible)

LATENT_CODE_DIM = 32   # the width of the per-frame code table (stage1.py:136)


@dataclasses.dataclass
class TrainState:
    """The model, the trained background (or None), the optimizer, its
    learning-rate schedule (step -> lr, or None to leave the rate as it
    is), the step count, the (12,) dynamic sampling weights and the
    trained per-frame latent codes (frames, 32) (or None)."""
    model: NeRFaceModel
    background: Optional[torch.nn.Parameter]
    optimizer: torch.optim.Optimizer
    lr_fn: Optional[Callable[[int], float]]
    step: int
    sample_prob: torch.Tensor
    latent_codes: Optional[torch.nn.Parameter] = None


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    """Static training configuration distilled from Config."""
    num_random_rays: int
    near: float
    far: float
    render: RenderSettings
    dynamic_sampling: bool
    fixed_background: bool
    train_background: bool
    supervised_train_background: bool
    train_latent_codes: bool
    disable_latent_codes: bool
    regularize_latent_codes: bool
    regularize_spatial_embedding: bool
    use_spatial_embeddings: bool
    ce_weight: float
    mouth_loss_weight: float
    mouth_class_weight: float
    latent_reg_weight: float
    spatial_reg_weight: float
    background_loss_weight: float
    lr: float
    lr_decay: int
    lr_decay_factor: float
    fused_grads: bool = True

    @classmethod
    def from_config(cls, cfg: Config) -> "TrainSettings":
        rt = cfg.runtime
        return cls(
            num_random_rays=cfg.nerf.train.num_random_rays,
            near=float(cfg.dataset.near), far=float(cfg.dataset.far),
            render=RenderSettings.from_config(cfg, "train"),
            dynamic_sampling=rt.dynamic_sampling,
            fixed_background=rt.fixed_background,
            train_background=rt.train_background,
            supervised_train_background=rt.supervised_train_background,
            train_latent_codes=rt.train_latent_codes,
            disable_latent_codes=rt.disable_latent_codes,
            regularize_latent_codes=rt.regularize_latent_codes,
            regularize_spatial_embedding=rt.regularize_spatial_embedding,
            use_spatial_embeddings=cfg.models.coarse.use_spatial_embeddings,
            ce_weight=rt.ce_weight, mouth_loss_weight=rt.mouth_loss_weight,
            mouth_class_weight=rt.mouth_class_weight,
            latent_reg_weight=rt.latent_reg_weight,
            spatial_reg_weight=rt.spatial_reg_weight,
            background_loss_weight=rt.background_loss_weight,
            lr=float(cfg.optimizer.lr), lr_decay=int(cfg.scheduler.lr_decay),
            lr_decay_factor=float(cfg.scheduler.lr_decay_factor),
            fused_grads=bool(getattr(rt, "fused_grads", True)))


def class_weights(ts: TrainSettings, device=None) -> torch.Tensor:
    w = torch.ones((NUM_CLASSES,), dtype=torch.float32, device=device)
    w[7:9] = ts.mouth_class_weight
    return w


def lr_schedule(ts: TrainSettings) -> Callable[[int], float]:
    """lr(i) = lr0 * factor^(i / (lr_decay * 1000))
    (train_stage_rays_auto.py:504-509)."""
    return lambda step: ts.lr * ts.lr_decay_factor ** (step / (ts.lr_decay * 1000.0))


def make_optimizer(params, ts: TrainSettings) -> torch.optim.Adam:
    """Adam with optax's defaults (betas 0.9 / 0.999, eps 1e-8)."""
    return torch.optim.Adam(params, lr=ts.lr, betas=(0.9, 0.999), eps=1e-8)


def init_train_state(spec: ModelSpec, ts: TrainSettings, seed: int = 0,
                     background=None, device=None,
                     num_latent_frames: int = 0) -> TrainState:
    """Seeded model and Adam state on ``device`` (CUDA unless the caller
    names another; with no device given and no CUDA present this raises).
    ``background`` (H, W, 15) becomes a trained parameter when
    ``ts.train_background``; with ``ts.train_latent_codes`` a zero table of
    ``num_latent_frames`` codes does (stage1.py:133-136)."""
    dev = resolve_device(device)
    model = NeRFaceModel.init(spec, seed=seed, device=dev)
    bg = None
    if ts.train_background and background is not None:
        bg = torch.nn.Parameter(torch.as_tensor(
            np.asarray(background), dtype=torch.float32).to(dev))
    codes = None
    if ts.train_latent_codes and num_latent_frames > 0:
        codes = torch.nn.Parameter(torch.zeros(
            (num_latent_frames, LATENT_CODE_DIM), device=dev))
    params = (list(model.parameters()) + ([bg] if bg is not None else [])
              + ([codes] if codes is not None else []))
    return TrainState(model=model, background=bg,
                      optimizer=make_optimizer(params, ts),
                      lr_fn=lr_schedule(ts), step=0,
                      sample_prob=torch.ones((NUM_CLASSES,), device=dev),
                      latent_codes=codes)


def _stage1_losses(ts: TrainSettings, rgb, mask, target, cw, norm=None):
    l2, masked_l2, masked_l2_w = L.mask_mse_loss(mask, rgb[..., :3],
                                                 target[..., :3], cw, norm)
    ce, masked_ce, masked_ce_w = L.mask_cross_entropy_loss(mask, rgb[..., 3:],
                                                           mask, cw, norm)
    mouth = torch.sum(masked_l2[7:9] + masked_ce[7:9])
    total = l2 + ts.ce_weight * ce + ts.mouth_loss_weight * mouth
    return total, l2, ce, masked_l2_w, masked_ce_w


def _as_batch(batch: Dict[str, Any], dev) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v
                               ).to(dev)
            for k, v in batch.items() if k != "fname"}


def train_step(state: TrainState, batch: Dict[str, Any], spec: ModelSpec,
               ts: TrainSettings, generator: Optional[torch.Generator] = None,
               draws: TrainDraws = TrainDraws(), ray_group=None):
    """One training step in place on ``state``. batch keys: image (H, W, 3),
    mask (H, W, 12), pose (3, 4), intrinsics (4,), driving ((76,) or the
    (16, 29) audio window), background (H, W, 15) [fixed background], bbox
    (4,) [optional], frame_idx () [for latent codes]. Random draws come
    from ``generator`` unless given in ``draws``. ``ray_group``
    (parallel/mesh.RayGroup): this rank renders its block of the rays
    (module note). Returns (state, metrics); the model's ``.grad`` fields
    hold the step's gradients afterwards (summed over the ranks). The
    step runs in the phase ``train.step``, its parts in the spans
    ``train.pick``, ``train.draws``, ``train.forward``, ``train.losses``,
    ``train.backward``, ``train.reduce``, ``train.adam`` and
    ``train.sample_prob``."""
    with profiling.phase("train.step"):
        return _train_step(state, batch, spec, ts, generator, draws, ray_group)


def _train_step(state, batch, spec, ts, generator, draws, ray_group):
    model = state.model
    dev = next(model.parameters()).device
    b = _as_batch(batch, dev)
    H, W = b["image"].shape[:2]
    mask_img = b["mask"].to(torch.float32)
    with profiling.span("train.pick"):
        if ts.dynamic_sampling:
            probs = semantic_ray_probs(state.sample_prob, mask_img)
        elif "bbox" in b:
            probs = bbox_ray_probs(b["bbox"], H, W)
        else:
            probs = torch.full((H, W), 1.0 / (H * W), device=dev)
        idx = weighted_ray_indices(probs.reshape(-1), ts.num_random_rays,
                                   generator=generator, gumbel=draws.gumbel)
        bg_img = b.get("background")
        if ts.train_background and state.background is not None:
            bg_img = state.background
        use_bg = (ts.fixed_background or ts.train_background) and bg_img is not None
        ro, rd = get_rays_at(idx, H, W, b["intrinsics"], b["pose"])
        if ts.render.use_ndc:
            ro, rd = ndc_rays(H, W, b["intrinsics"], 1.0, ro, rd)
        target_s, mask_s = gather_rays(idx, b["image"], mask_img)
        bg_r = gather_rays(idx, bg_img)[0] if use_bg else None
    cw = class_weights(ts, dev)
    fused = ts.fused_grads and stage1_fused_eligible(spec, ts.render)
    with profiling.span("train.draws"):
        # every draw of the step up front, in the order and at the shapes the
        # render takes them, so that a rank's block of them is the single step's
        d = full_draws(ts.render, idx.shape[0], fused or model.fine is not None,
                       generator, dev, Draws(draws.t_rand, draws.u,
                                             draws.noise_coarse, draws.noise_fine))
        draws = TrainDraws(None, d.t_rand, d.u, d.noise_coarse, d.noise_fine)
        sharded = ray_group is not None and ray_group.world > 1
        lw, norm = _batch_normalisers(ts, mask_s, fused, sharded)
        rays = None if norm is None else norm[0]
        if sharded:
            sl = _ray_block(ray_group, idx.shape[0])
            ro, rd, target_s, mask_s = ro[sl], rd[sl], target_s[sl], mask_s[sl]
            bg_r = None if bg_r is None else bg_r[sl]
            lw = None if lw is None else lw[sl]
            draws = TrainDraws(None, *(None if d is None else d[sl]
                                       for d in draws[1:]))

    state.optimizer.zero_grad(set_to_none=True)
    latent = None
    if (ts.train_latent_codes and not ts.disable_latent_codes
            and state.latent_codes is not None):
        latent = state.latent_codes[b["frame_idx"].long()]
    sup = ts.supervised_train_background and bg_r is not None
    with profiling.span("train.forward"):
        if fused:
            driving = compute_driving(model, b["driving"])
            pose_enc = encode_pose(b["pose"])
            tgt15 = torch.cat([target_s[..., :3], mask_s], dim=-1)
            fcfg = FusedCfg(num_coarse=ts.render.num_coarse,
                            num_fine=ts.render.num_fine, near=ts.near, far=ts.far,
                            perturb=ts.render.perturb,
                            noise_std=ts.render.radiance_field_noise_std,
                            lindisp=ts.render.lindisp,
                            compute_dtype=ts.render.compute_dtype,
                            bg_sup_weight=ts.background_loss_weight if sup else 0.0,
                            num_rays=rays)
            loss, rgb_c, rgb_f, weights = stage1_fused(
                model, fcfg, driving, pose_enc, ro, rd, tgt15, lw, bg_r, generator,
                draws, latent)
        else:
            # the autograd fallback (stage1.py:256-294)
            res = render_rays(model, ts.render, ro, rd, ts.near, ts.far,
                              b["driving"], b["pose"], generator=generator,
                              background_prior=bg_r, latent_code=latent,
                              draws=Draws(draws.t_rand, draws.u, draws.noise_coarse,
                                          draws.noise_fine),
                              differentiable=True)
            rgb_c, rgb_f, weights = res.rgb_coarse, res.rgb_fine, res.weights
    with profiling.span("train.losses"):
        if not fused:
            loss = _stage1_losses(ts, rgb_c, mask_s, target_s, cw, norm)[0]
            if rgb_f is not None:
                loss = loss + _stage1_losses(ts, rgb_f, mask_s, target_s, cw, norm)[0]
            if sup:
                loss = loss + _bg_loss(ts, bg_r, target_s, weights, rays)
        # the regularisers count once over the ranks
        once = ray_group is None or ray_group.rank == 0
        if ts.regularize_latent_codes and latent is not None and once:
            loss = loss + 10.0 * ts.latent_reg_weight * torch.linalg.norm(latent)
        if ts.regularize_spatial_embedding and ts.use_spatial_embeddings and once:
            loss = loss + 10.0 * ts.spatial_reg_weight * torch.linalg.norm(
                model.spatial_embeddings)
    with profiling.span("train.backward"):
        loss.backward()

    with torch.no_grad(), profiling.span("train.reduce"):
        _, c_l2, c_ce, c_ml2w, c_mcew = _stage1_losses(ts, rgb_c.detach(),
                                                       mask_s, target_s, cw, norm)
        f_l2, f_ce, prob_num = c_l2, c_ce, c_ml2w + c_mcew
        if rgb_f is not None:
            _, f_l2, f_ce, f_ml2w, f_mcew = _stage1_losses(
                ts, rgb_f.detach(), mask_s, target_s, cw, norm)
            prob_num = prob_num + f_ml2w + f_mcew
        bg_loss = (_bg_loss(ts, bg_r.detach(), target_s, weights.detach(), rays)
                   if sup else torch.zeros((), device=dev))
        sums = {"loss": loss.detach(), "coarse_l2": c_l2, "fine_l2": f_l2,
                "coarse_ce": c_ce, "fine_ce": f_ce, "bg_loss": bg_loss,
                "prob_num": prob_num}
        if ray_group is not None:
            sums = _reduce_step(ray_group, state.optimizer, sums)
    if state.lr_fn is not None:
        for group in state.optimizer.param_groups:
            group["lr"] = state.lr_fn(state.step)
    with profiling.span("train.adam"):
        state.optimizer.step()

    with torch.no_grad(), profiling.span("train.sample_prob"):
        prob_num = sums.pop("prob_num")
        if ts.dynamic_sampling:
            state.sample_prob = prob_num / torch.sum(prob_num)
        metrics = dict(sums, psnr=-10.0 * torch.log10(
            torch.clamp(sums["fine_l2"], min=1e-10)))
    state.step += 1
    return state, metrics


def _ray_block(ray_group, R: int) -> slice:
    """This rank's rays of the step."""
    return ray_group.block(R)


def _batch_normalisers(ts: TrainSettings, mask_s, fused: bool, sharded: bool):
    """The whole batch's loss normalisers: ray_loss_weights (R, 2) on the
    fused path (else None), and for a sharded step the losses' (R, the
    per-class counts) (else None: the losses take their own)."""
    lw = (ray_loss_weights(mask_s, ts.ce_weight, ts.mouth_loss_weight)
          if fused else None)
    return lw, ((mask_s.shape[0], L._class_counts(mask_s)) if sharded else None)


def _reduce_step(ray_group, optimizer, sums: Dict[str, torch.Tensor]):
    """One sum all-reduce over the ranks of a flat bucket: every gradient,
    in the optimizer's order, then the metrics' sums. The gradients come
    back in place; returns the summed metrics. The collective is ordered
    after the kernels that wrote the gradients: they run on the current
    stream, which NCCL's stream waits on and gloo's copy to the host
    follows."""
    grads = [p.grad for g in optimizer.param_groups for p in g["params"]
             if p.grad is not None]
    names = list(sums)
    parts = grads + [sums[k].reshape(-1).to(torch.float32) for k in names]
    flat = ray_group.all_reduce_(torch.cat([t.reshape(-1) for t in parts]))
    chunks = flat.split([t.numel() for t in parts])
    for g, c in zip(grads, chunks):
        g.copy_(c.view_as(g))
    return {k: c.view_as(sums[k]) for k, c in zip(names, chunks[len(grads):])}


def _bg_loss(ts: TrainSettings, bg_r, target_s, weights, rays=None):
    """The background supervision: the background sample's weight times
    its colour error, averaged over the rays (stage1.py:284-294), or,
    given ``rays``, summed over a block of a batch of that many."""
    per_ray = torch.sum(torch.square(bg_r[..., :3] - target_s[..., :3]), dim=-1)
    x = per_ray * weights[:, -1]
    mean = torch.mean(x) if rays is None else torch.sum(x) / rays
    return mean * ts.background_loss_weight


def make_train_step(spec: ModelSpec, ts: TrainSettings, device=None,
                    ray_group=None):
    """A train-step closure for ``device`` (CUDA unless the caller names
    another; with no device given and no CUDA present this raises):
    step(state, batch, generator=None, draws=TrainDraws()) -> (state,
    metrics). With ``ray_group`` each rank renders its block of the rays
    (``parallel/mesh.make_sharded_train_step``)."""
    dev = resolve_device(device)

    def step(state: TrainState, batch, generator=None,
             draws: TrainDraws = TrainDraws()):
        on = next(state.model.parameters()).device
        if on.type != dev.type:
            raise ValueError(f"the model is on {on}, the step was made for "
                             f"{dev}")
        return train_step(state, batch, spec, ts, generator, draws, ray_group)

    return step


def make_multi_train_step(spec: ModelSpec, ts: TrainSettings, device=None,
                          ray_group=None):
    """K train steps a call (counterpart of the JAX package's
    ``make_multi_train_step``, whose ``lax.scan`` becomes a loop over the
    step of ``make_train_step``; no CUDA graph): multi(state, batches,
    generator=None, draws=None) -> (state, metrics). ``batches`` holds
    each batch key stacked along a leading K axis (``stack_batches``);
    ``draws`` is a TrainDraws whose given fields are stacked along K (step
    k takes index k), else every step draws from ``generator``. The
    metrics come back stacked (K,) on the device: nothing is read back to
    the host between steps. CUDA unless the caller names another device;
    with no device given and no CUDA present this raises. With
    ``ray_group`` each step is the sharded step
    (``parallel/mesh.make_sharded_train_step``)."""
    step = make_train_step(spec, ts, device=device, ray_group=ray_group)

    def multi(state: TrainState, batches: Dict[str, torch.Tensor],
              generator=None, draws: Optional[TrainDraws] = None):
        K = int(batches["image"].shape[0])
        per_step = []
        for k in range(K):
            batch = {name: v[k] for name, v in batches.items()}
            d = TrainDraws() if draws is None else TrainDraws(
                *(None if f is None else f[k] for f in draws))
            state, metrics = step(state, batch, generator=generator, draws=d)
            per_step.append(metrics)
        return state, {name: torch.stack([m[name] for m in per_step])
                       for name in per_step[0]}

    return multi


def stack_batches(items, background=None, device=None) -> Dict[str, torch.Tensor]:
    """Per-frame batch dicts (numpy, as the datasets give them) -> one dict
    of tensors on ``device`` stacked along a leading K axis, for
    ``make_multi_train_step``; ``background`` (H, W, 15), when given, is
    broadcast to (K, H, W, 15) as a view. CUDA unless the caller names
    another device; with no device given and no CUDA present this
    raises."""
    dev = resolve_device(device)
    keys = [k for k in items[0] if k != "fname"]
    out = {k: torch.from_numpy(np.stack([np.asarray(it[k]) for it in items])).to(dev)
           for k in keys}
    if background is not None:
        bg = torch.as_tensor(background, dtype=torch.float32).to(dev)
        out["background"] = bg.expand((len(items),) + tuple(bg.shape))
    return out
