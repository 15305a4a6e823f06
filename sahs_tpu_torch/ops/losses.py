"""Loss stack: masked per-semantic-class MSE / cross-entropy (counterpart
of ``sahs_tpu/ops/losses.py``).

Parity targets in the reference:
  - MaskCrossEntropyLoss   nerf-pytorch/nerf/nerf_helpers.py:14-37
  - MaskMSELoss            nerf-pytorch/nerf/nerf_helpers.py:40-62
  - img2mse / mse2psnr     nerf-pytorch/nerf/nerf_helpers.py:65-73

Both masked losses return (unmasked mean, per-class masked vector,
class-weight-scaled vector); the per-class count has a zero guard
(count == 0 -> 1). Given ``norm`` = (rays, counts) of a whole batch, they
take a block of its rays (a ray group's rank, train/stage1.py) and divide
by the batch's ray count and class counts, so the blocks' values sum to
the batch's.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _class_counts(mask: torch.Tensor) -> torch.Tensor:
    counts = torch.sum(mask != 0, dim=0).to(mask.dtype)
    return torch.where(counts == 0, torch.ones_like(counts), counts)


def _reduce(x: torch.Tensor, mask: torch.Tensor, norm):
    """(mean of x, per-class mean of x): over ``x``'s rows, or, given norm
    = (rays, counts), the rows' sums over a whole batch's normalisers."""
    if norm is None:
        return torch.mean(x), torch.sum(x * mask, dim=0) / _class_counts(mask)
    rays, counts = norm
    return torch.sum(x) / rays, torch.sum(x * mask, dim=0) / counts


def mask_mse_loss(mask: torch.Tensor, pred: torch.Tensor, target: torch.Tensor,
                  weights: Optional[torch.Tensor] = None, norm=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """mask (N, 12) one-hot; pred/target (N, 3). The per-pixel diff is the
    SUM of squared channel errors, as the reference (nerf_helpers.py:56-58)."""
    mask = mask.reshape(-1, mask.shape[-1])
    pred = pred.reshape(-1, 3)
    target = target.reshape(-1, 3)
    diff = torch.sum(torch.square(pred - target), dim=-1, keepdim=True)
    unmasked, masked = _reduce(diff, mask, norm)
    if weights is None:
        weights = torch.ones((mask.shape[-1],), dtype=mask.dtype,
                             device=mask.device)
    return unmasked, masked, weights * masked


def mask_cross_entropy_loss(mask: torch.Tensor, probs: torch.Tensor,
                            target: torch.Tensor,
                            weights: Optional[torch.Tensor] = None, norm=None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """mask/target (N, 12) one-hot; probs (N, 12) composited probabilities,
    hence -sum(target * log(probs + 1e-10)) (nerf_helpers.py:31)."""
    mask = mask.reshape(-1, mask.shape[-1])
    probs = probs.reshape(-1, probs.shape[-1])
    target = target.reshape(-1, target.shape[-1])
    ce = -torch.sum(target * torch.log(probs + 1e-10), dim=-1, keepdim=True)
    unmasked, masked = _reduce(ce, mask, norm)
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
