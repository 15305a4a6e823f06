"""Depth-sample generation (counterpart of ``sahs_tpu/ops/sampling.py``).

Parity targets in the reference:
  - coarse linspace + stratified perturb   nerf-pytorch/nerf/train_utils.py:93-113
  - sample_pdf_2 (inverse-CDF importance)  nerf-pytorch/nerf/nerf_helpers.py:454-497

Every random draw is an optional tensor argument (``t_rand``, ``u``,
``gumbel``); when it is absent the function draws from the given
``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional

import torch


def coarse_z_vals(near: torch.Tensor, far: torch.Tensor, num_coarse: int,
                  lindisp: bool = False, perturb: bool = False,
                  generator: Optional[torch.Generator] = None,
                  t_rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(R,) near/far -> (R, num_coarse) depths, depth- or disparity-spaced,
    with optional stratified jitter ``t_rand`` (R, num_coarse) in [0, 1)."""
    t = torch.linspace(0.0, 1.0, num_coarse, dtype=near.dtype,
                       device=near.device)
    near = near[..., None]
    far = far[..., None]
    if not lindisp:
        z = near * (1.0 - t) + far * t
    else:
        z = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    if perturb:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], dim=-1)
        lower = torch.cat([z[..., :1], mids], dim=-1)
        if t_rand is None:
            t_rand = torch.rand(z.shape, generator=generator, dtype=z.dtype,
                                device=z.device)
        z = lower + (upper - lower) * t_rand
    return z


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, num_samples: int,
               det: bool = False, generator: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF importance sampling with the reference's clamps (sample_pdf_2):
    +1e-5 weight floor, zero-prepended cumsum CDF, searchsorted-right, and
    denom < 1e-5 -> 1. bins (R, B), weights (R, B-1) -> (R, num_samples),
    detached. ``bins`` must be non-decreasing per row."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)   # (R, B)
    if u is None:
        if det:
            u = torch.linspace(0.0, 1.0, num_samples, dtype=weights.dtype,
                               device=weights.device)
            u = u.expand(cdf.shape[:-1] + (num_samples,))
        else:
            u = torch.rand(cdf.shape[:-1] + (num_samples,),
                           generator=generator, dtype=weights.dtype,
                           device=weights.device)
    u = u.contiguous()
    B = cdf.shape[-1]
    inds = torch.searchsorted(cdf.detach().contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=B - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    samples = bins_below + t * (bins_above - bins_below)
    return samples.detach()


def merge_z_vals(z_vals: torch.Tensor, z_samples: torch.Tensor) -> torch.Tensor:
    """sort(cat(coarse, fine)) along the sample axis (train_utils.py:166)."""
    return torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1,
                      stable=True).values


# ---------------------------------------------------------------------------
# Semantic-weighted ray selection (train_stage_rays_auto.py:390-422)
# ---------------------------------------------------------------------------

def semantic_ray_probs(sample_prob: torch.Tensor, mask: torch.Tensor
                       ) -> torch.Tensor:
    """probs[h, w] = sum_c sample_prob[c] * mask[h, w, c], normalised."""
    probs = torch.sum(sample_prob[None, None, :] * mask, dim=-1)
    return probs / torch.sum(probs)


def bbox_ray_probs(bbox: torch.Tensor, H: int, W: int, p: float = 0.9
                   ) -> torch.Tensor:
    """Mass ``p`` inside the face bbox rows [b0, b1) x cols [b2, b3), 1 - p
    outside, normalised (nerface_dataloader.py:63-87)."""
    dev = bbox.device
    rows = torch.arange(H, device=dev)
    cols = torch.arange(W, device=dev)
    in_r = (rows >= bbox[0]) & (rows < bbox[1])
    in_c = (cols >= bbox[2]) & (cols < bbox[3])
    inside = in_r[:, None] & in_c[None, :]
    probs = torch.where(inside, torch.tensor(p, device=dev),
                        torch.tensor(1.0 - p, device=dev))
    return probs / torch.sum(probs)


def weighted_ray_indices(probs_flat: torch.Tensor, num_rays: int,
                         replace: bool = False,
                         generator: Optional[torch.Generator] = None,
                         gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``num_rays`` flat pixel indices drawn with probabilities ``probs``.
    Without replacement (the reference's np.random.choice(replace=False)):
    Gumbel top-k over log-probabilities, exact, equal scores taken lower
    index first as ``lax.top_k`` takes them (float32 Gumbel noise ties
    now and then at 512x512, and ``torch.topk`` breaks ties in an order
    that differs between devices); ``gumbel`` (H*W,) standard Gumbel noise
    may be passed in instead of drawn. With replacement: independent
    categorical draws."""
    if replace:
        return torch.multinomial(probs_flat, num_rays, replacement=True,
                                 generator=generator)
    if gumbel is None:
        u = torch.rand(probs_flat.shape, generator=generator,
                       dtype=probs_flat.dtype, device=probs_flat.device)
        tiny = torch.finfo(probs_flat.dtype).tiny
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    scores = torch.log(probs_flat + 1e-12) + gumbel
    return torch.sort(scores, descending=True, stable=True).indices[:num_rays]


def gather_rays(flat_idx: torch.Tensor, *arrays):
    """Rows at flat pixel indices of (H*W, C) or (H, W, C) arrays."""
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        if a.dim() == 3:
            a = a.reshape(-1, a.shape[-1])
        out.append(a[flat_idx])
    return tuple(out)
