"""The plain reference of the Stage-I train step (the reference repository's
train_stage_rays_auto.py:273-544) in float32 autograd: the semantic-weighted
ray pick (Gumbel top-k over the class-weighted pixel probabilities), the
rays, both levels through ``model.render_rays``, the masked per-class MSE
and cross-entropy losses with the mouth terms, Adam at the configuration's
decaying rate, and the dynamic sampling weights for the next step.

The gradients are taken over blocks of rays, each block's loss divided by
the whole batch's ray count and class counts, so the blocks' gradients sum
to the batch's while one block's graph fits on the card.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

from ..shapes import SEG_CLASSES, Spec
from .model import Field, encode_pose, plain_linear, ray_bundle, render_rays

BETAS = (0.9, 0.999)      # optax's and torch's Adam defaults, as the trainer
EPS = 1e-8


def _per_ray(rgb, target, mask):
    diff = torch.sum(torch.square(rgb[:, :3] - target), dim=-1)
    ce = -torch.sum(mask * torch.log(rgb[:, 3:15] + 1e-10), dim=-1)
    return diff, ce


def train_steps(spec: Spec, cfg: dict, weights: Dict[str, torch.Tensor],
                batches: List[Dict[str, torch.Tensor]],
                draws: List[Dict[str, torch.Tensor]], rays: int,
                linear: Callable = plain_linear, block: int = 2048,
                half_batch: bool = False) -> Dict:
    """Steps from ``weights``, one per batch (image, mask, pose,
    intrinsics, driving, background) and its draws (gumbel, t_rand, u,
    noise_coarse, noise_fine). ``half_batch`` plants a fault for the
    control's readings: the step takes the first half of its picked rays
    twice, so its means run over half of the batch. Returns {"loss": [each
    step's loss], "metrics": [each step's {loss, coarse_l2, fine_l2,
    coarse_ce, fine_ce}, the trainer's own names: the levels' unmasked
    means], "grad1": {name: the first step's gradient}, "params": {name:
    the parameters after the last step}}."""
    rt, tr = cfg["runtime"], cfg["nerf"]["train"]
    near, far = float(cfg["dataset"]["near"]), float(cfg["dataset"]["far"])
    std = float(tr["radiance_field_noise_std"])
    lr0, decay = float(cfg["optimizer"]["lr"]), float(cfg["scheduler"]["lr_decay"])
    factor = float(cfg["scheduler"]["lr_decay_factor"])
    ce_w, mouth_w = float(rt["ce_weight"]), float(rt["mouth_loss_weight"])
    cw = torch.ones(SEG_CLASSES, device=next(iter(weights.values())).device)
    cw[7:9] = float(rt["mouth_class_weight"])
    if not (rt["dynamic_sampling"] and rt["fixed_background"]):
        raise ValueError("the reference step covers dynamic sampling over a fixed background")

    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    sample_prob = torch.ones_like(cw)
    field = Field(spec, params, linear)
    out = {"loss": [], "metrics": [], "grad1": None}
    for t, (b, d) in enumerate(zip(batches, draws)):
        H, W = b["image"].shape[:2]
        with torch.no_grad():
            probs = torch.sum(sample_prob * b["mask"], dim=-1).reshape(-1)
            probs = probs / torch.sum(probs)
            scores = torch.log(probs + 1e-12) + d["gumbel"]
            idx = torch.sort(scores, descending=True, stable=True).indices[:rays]
            if half_batch:
                idx = torch.cat([idx[:rays // 2], idx[:rays - rays // 2]])
            ro, rd = ray_bundle(H, W, b["intrinsics"], b["pose"], idx)
            target = b["image"].reshape(-1, 3)[idx]
            mask = b["mask"].reshape(-1, SEG_CLASSES)[idx]
            bg = b["background"].reshape(-1, b["background"].shape[-1])[idx]
            counts = torch.sum(mask != 0, dim=0).to(torch.float32)
            counts = torch.where(counts == 0, torch.ones_like(counts), counts)
        loss_sum = torch.zeros((), device=cw.device)
        class_sum = torch.zeros_like(cw)
        means = {k: torch.zeros((), device=cw.device)
                 for k in ("coarse_l2", "fine_l2", "coarse_ce", "fine_ce")}
        pose_enc = encode_pose(b["pose"])
        for s in range(0, rays, block):
            sl = slice(s, min(s + block, rays))
            driving = field.driving(b["driving"])
            rgb_c, rgb_f, _ = render_rays(
                field, ro[sl], rd[sl], near, far, driving, pose_enc, bg[sl],
                d["t_rand"][sl], d["u"][sl], d["noise_coarse"][sl] * std,
                d["noise_fine"][sl] * std)
            loss = 0.0
            for level, rgb in (("coarse", rgb_c), ("fine", rgb_f)):
                diff, ce = _per_ray(rgb, target[sl], mask[sl])
                means[level + "_l2"] += torch.sum(diff).detach() / rays
                means[level + "_ce"] += torch.sum(ce).detach() / rays
                ml2 = torch.sum(diff[:, None] * mask[sl], dim=0) / counts
                mce = torch.sum(ce[:, None] * mask[sl], dim=0) / counts
                loss = loss + (torch.sum(diff) + ce_w * torch.sum(ce)) / rays \
                    + mouth_w * torch.sum(ml2[7:9] + mce[7:9])
                class_sum = class_sum + (ml2 + mce).detach()
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        out["loss"].append(loss_sum)
        out["metrics"].append(dict(means, loss=loss_sum))
        with torch.no_grad():
            if t == 0:
                out["grad1"] = {k: p.grad.clone() for k, p in params.items()}
            lr = lr0 * factor ** (t / (decay * 1000.0))
            c1, c2 = 1 - BETAS[0] ** (t + 1), 1 - BETAS[1] ** (t + 1)
            for k, p in params.items():
                g = p.grad
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                p.sub_(lr / c1 * m[k] / (torch.sqrt(v2[k] / c2) + EPS))
                p.grad = None
            prob_num = cw * class_sum
            sample_prob = prob_num / torch.sum(prob_num)
    out["params"] = {k: p.detach() for k, p in params.items()}
    return out
