"""Stage-I trainer (counterpart of ``sahs_tpu/train/stage1.py``).

One step (reference nerf-pytorch/train_stage_rays_auto.py:273-544):
  - semantic-weighted ray pick on the device (Gumbel top-k);
  - rays at the picked pixels, targets gathered;
  - the fused gradient path (train/fused.py): K1, K2, K3 and K4;
  - Adam with the reference's exponential decay, lr0 * factor^(step /
    (lr_decay * 1000)) at the pre-update count (stage1.py:110-126);
  - the dynamic ``sample_prob`` carry and the metrics.

Loss stack (train_stage_rays_auto.py:455-492):
  L = [coarse_l2 + 0.02 coarse_ce + 0.005 sum(mouth_l2 + mouth_ce)] + fine(...)
      (+ 10 * 0.0005 ||grid||) (+ background supervision * 0.001)
A configuration the fused path does not cover, or one with active latent
codes, raises NotImplementedError: it needs kernels still to be ported.
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
from ..render.pipeline import RenderSettings
from ..utils.device import resolve_device
from ..utils.seg import NUM_CLASSES
from .fused import (STILL_TO_PORT, FusedCfg, TrainDraws, ray_loss_weights,
                    stage1_fused, stage1_fused_eligible)


@dataclasses.dataclass
class TrainState:
    """The model, the trained background (or None), the optimizer, its
    learning-rate schedule (step -> lr, or None to leave the rate as it
    is), the step count and the (12,) dynamic sampling weights."""
    model: NeRFaceModel
    background: Optional[torch.nn.Parameter]
    optimizer: torch.optim.Optimizer
    lr_fn: Optional[Callable[[int], float]]
    step: int
    sample_prob: torch.Tensor


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


def _check_supported(spec: ModelSpec, ts: TrainSettings) -> None:
    if ts.train_latent_codes and not ts.disable_latent_codes:
        raise NotImplementedError(
            "latent codes on the kernel path: " + STILL_TO_PORT)
    if not ts.fused_grads or not stage1_fused_eligible(spec, ts.render):
        raise NotImplementedError(
            "fused_grads=False or a configuration outside the fused path: "
            + STILL_TO_PORT)


def init_train_state(spec: ModelSpec, ts: TrainSettings, seed: int = 0,
                     background=None, device=None) -> TrainState:
    """Seeded model and Adam state on ``device`` (CUDA unless the caller
    names another; with no device given and no CUDA present this raises).
    ``background`` (H, W, 15) becomes a trained parameter when
    ``ts.train_background``."""
    _check_supported(spec, ts)
    dev = resolve_device(device)
    model = NeRFaceModel.init(spec, seed=seed, device=dev)
    bg = None
    if ts.train_background and background is not None:
        bg = torch.nn.Parameter(torch.as_tensor(
            np.asarray(background), dtype=torch.float32).to(dev))
    params = list(model.parameters()) + ([bg] if bg is not None else [])
    return TrainState(model=model, background=bg,
                      optimizer=make_optimizer(params, ts),
                      lr_fn=lr_schedule(ts), step=0,
                      sample_prob=torch.ones((NUM_CLASSES,), device=dev))


def _stage1_losses(ts: TrainSettings, rgb, mask, target, cw):
    l2, masked_l2, masked_l2_w = L.mask_mse_loss(mask, rgb[..., :3],
                                                 target[..., :3], cw)
    ce, masked_ce, masked_ce_w = L.mask_cross_entropy_loss(mask, rgb[..., 3:],
                                                           mask, cw)
    mouth = torch.sum(masked_l2[7:9] + masked_ce[7:9])
    total = l2 + ts.ce_weight * ce + ts.mouth_loss_weight * mouth
    return total, l2, ce, masked_l2_w, masked_ce_w


def _as_batch(batch: Dict[str, Any], dev) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v
                               ).to(dev)
            for k, v in batch.items() if k != "fname"}


def train_step(state: TrainState, batch: Dict[str, Any], spec: ModelSpec,
               ts: TrainSettings, generator: Optional[torch.Generator] = None,
               draws: TrainDraws = TrainDraws()):
    """One training step in place on ``state``. batch keys: image (H, W, 3),
    mask (H, W, 12), pose (3, 4), intrinsics (4,), driving ((76,) or the
    (16, 29) audio window), background (H, W, 15) [fixed background], bbox
    (4,) [optional]. Random draws come from ``generator`` unless given in
    ``draws``. Returns (state, metrics); the model's ``.grad`` fields hold
    the step's gradients afterwards."""
    _check_supported(spec, ts)
    model = state.model
    dev = model.spatial_embeddings.device
    b = _as_batch(batch, dev)
    H, W = b["image"].shape[:2]
    mask_img = b["mask"].to(torch.float32)
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

    state.optimizer.zero_grad(set_to_none=True)
    driving = compute_driving(model, b["driving"])
    pose_enc = encode_pose(b["pose"])
    tgt15 = torch.cat([target_s[..., :3], mask_s], dim=-1)
    lw = ray_loss_weights(mask_s, ts.ce_weight, ts.mouth_loss_weight)
    sup = ts.supervised_train_background and bg_r is not None
    fcfg = FusedCfg(num_coarse=ts.render.num_coarse,
                    num_fine=ts.render.num_fine, near=ts.near, far=ts.far,
                    perturb=ts.render.perturb,
                    noise_std=ts.render.radiance_field_noise_std,
                    lindisp=ts.render.lindisp,
                    compute_dtype=ts.render.compute_dtype,
                    bg_sup_weight=ts.background_loss_weight if sup else 0.0)
    loss, rgb_c, rgb_f, w_f = stage1_fused(model, fcfg, driving, pose_enc,
                                           ro, rd, tgt15, lw, bg_r,
                                           generator, draws)
    if ts.regularize_spatial_embedding and ts.use_spatial_embeddings:
        loss = loss + 10.0 * ts.spatial_reg_weight * torch.linalg.norm(
            model.spatial_embeddings)
    loss.backward()
    if state.lr_fn is not None:
        for group in state.optimizer.param_groups:
            group["lr"] = state.lr_fn(state.step)
    state.optimizer.step()

    with torch.no_grad():
        _, c_l2, c_ce, c_ml2w, c_mcew = _stage1_losses(ts, rgb_c, mask_s,
                                                       target_s, cw)
        _, f_l2, f_ce, f_ml2w, f_mcew = _stage1_losses(ts, rgb_f, mask_s,
                                                       target_s, cw)
        bg_loss = torch.zeros((), device=dev)
        if sup:
            per_ray = torch.sum(torch.square(bg_r[..., :3] - target_s[..., :3]),
                                dim=-1)
            bg_loss = torch.mean(per_ray * w_f[:, -1]) * ts.background_loss_weight
        if ts.dynamic_sampling:
            prob_num = c_ml2w + c_mcew + f_ml2w + f_mcew
            state.sample_prob = prob_num / torch.sum(prob_num)
        metrics = {"loss": loss.detach(), "coarse_l2": c_l2, "fine_l2": f_l2,
                   "coarse_ce": c_ce, "fine_ce": f_ce, "bg_loss": bg_loss,
                   "psnr": -10.0 * torch.log10(torch.clamp(f_l2, min=1e-10))}
    state.step += 1
    return state, metrics


def make_train_step(spec: ModelSpec, ts: TrainSettings, device=None):
    """A train-step closure for ``device`` (CUDA unless the caller names
    another; with no device given and no CUDA present this raises):
    step(state, batch, generator=None, draws=TrainDraws()) -> (state,
    metrics)."""
    _check_supported(spec, ts)
    dev = resolve_device(device)

    def step(state: TrainState, batch, generator=None,
             draws: TrainDraws = TrainDraws()):
        if state.model.spatial_embeddings.device.type != dev.type:
            raise ValueError(f"the model is on "
                             f"{state.model.spatial_embeddings.device}, the "
                             f"step was made for {dev}")
        return train_step(state, batch, spec, ts, generator, draws)

    return step
