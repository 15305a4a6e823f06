"""Loss stack: masked per-semantic-class MSE / cross-entropy (counterpart
of ``sahs_tpu/ops/losses.py``).

Parity targets in the reference:
  - MaskCrossEntropyLoss   nerf-pytorch/nerf/nerf_helpers.py:14-37
  - MaskMSELoss            nerf-pytorch/nerf/nerf_helpers.py:40-62
  - img2mse / mse2psnr     nerf-pytorch/nerf/nerf_helpers.py:65-73

Both masked losses return (unmasked mean, per-class masked vector,
class-weight-scaled vector); the per-class count has a zero guard
(count == 0 -> 1).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _class_counts(mask: torch.Tensor) -> torch.Tensor:
    counts = torch.sum(mask != 0, dim=0).to(mask.dtype)
    return torch.where(counts == 0, torch.ones_like(counts), counts)


def mask_mse_loss(mask: torch.Tensor, pred: torch.Tensor, target: torch.Tensor,
                  weights: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """mask (N, 12) one-hot; pred/target (N, 3). The per-pixel diff is the
    SUM of squared channel errors, as the reference (nerf_helpers.py:56-58)."""
    mask = mask.reshape(-1, mask.shape[-1])
    pred = pred.reshape(-1, 3)
    target = target.reshape(-1, 3)
    counts = _class_counts(mask)
    diff = torch.sum(torch.square(pred - target), dim=-1, keepdim=True)
    unmasked = torch.mean(diff)
    masked = torch.sum(diff * mask, dim=0) / counts
    if weights is None:
        weights = torch.ones((mask.shape[-1],), dtype=mask.dtype,
                             device=mask.device)
    return unmasked, masked, weights * masked


def mask_cross_entropy_loss(mask: torch.Tensor, probs: torch.Tensor,
                            target: torch.Tensor,
                            weights: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """mask/target (N, 12) one-hot; probs (N, 12) composited probabilities,
    hence -sum(target * log(probs + 1e-10)) (nerf_helpers.py:31)."""
    mask = mask.reshape(-1, mask.shape[-1])
    probs = probs.reshape(-1, probs.shape[-1])
    target = target.reshape(-1, target.shape[-1])
    counts = _class_counts(mask)
    ce = -torch.sum(target * torch.log(probs + 1e-10), dim=-1, keepdim=True)
    unmasked = torch.mean(ce)
    masked = torch.sum(ce * mask, dim=0) / counts
    if weights is None:
        weights = torch.ones((mask.shape[-1],), dtype=mask.dtype,
                             device=mask.device)
    return unmasked, masked, weights * masked


def img2mse(img_src: torch.Tensor, img_tgt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(img_src - img_tgt))


def mse2psnr(mse: float) -> float:
    """Host-side scalar helper with the reference's zero guard."""
    mse = float(mse)
    if mse == 0:
        mse = 1e-5
    return -10.0 * math.log10(mse)
