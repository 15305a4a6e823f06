"""Volume rendering, plain tensor math (counterpart of
``sahs_tpu/ops/rendering.py``).

Exact math parity with reference nerf-pytorch/nerf/volume_rendering_utils.py:7-78
including its quirks:
  - dists: z-diffs with 1e10 appended, scaled by ||ray_dir||
  - with a background prior: sigmoid on rgb and softmax on the 12 seg
    channels of all but the LAST sample, whose channels are taken RAW
    (they hold the background prior written by the pipeline)
  - sigma = relu(raw[..., -1] + noise); sigma[:, -1] += 1e-6
  - weights = alpha * cumprod_exclusive(1 - alpha + 1e-10)
  - disp = 1 / max(1e-10, depth / acc)
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class RenderOutputs(NamedTuple):
    rgb: torch.Tensor      # (R, C) composited rgb(+seg) map
    disp: torch.Tensor     # (R,)
    acc: torch.Tensor      # (R,)
    weights: torch.Tensor  # (R, S)
    depth: torch.Tensor    # (R,)


def cumprod_exclusive(x: torch.Tensor) -> torch.Tensor:
    cp = torch.cumprod(x, dim=-1)
    return torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)


def volume_render_radiance_field(
    radiance_field: torch.Tensor,        # (R, S, C+1); last channel is sigma
    depth_values: torch.Tensor,          # (R, S)
    ray_directions: torch.Tensor,        # (R, 3) raw directions
    radiance_field_noise_std: float = 0.0,
    white_background: bool = False,
    background_prior: Optional[torch.Tensor] = None,   # (R, C)
    noise: Optional[torch.Tensor] = None,              # (R, S) standard normal
    generator: Optional[torch.Generator] = None,
) -> RenderOutputs:
    dists = torch.cat(
        [depth_values[..., 1:] - depth_values[..., :-1],
         torch.full_like(depth_values[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(ray_directions, dim=-1)[..., None]

    if background_prior is not None:
        rgb = torch.sigmoid(radiance_field[:, :-1, :3])
        if background_prior.shape[1] > 4:
            seg = torch.softmax(radiance_field[:, :-1, 3:-1], dim=-1)
            rgb = torch.cat([rgb, seg], dim=-1)
        rgb = torch.cat([rgb, radiance_field[:, -1:, :-1]], dim=1)
    else:
        rgb = torch.sigmoid(radiance_field[..., :-1])

    sigma_raw = radiance_field[..., -1]
    if radiance_field_noise_std > 0.0:
        if noise is None:
            noise = torch.randn(sigma_raw.shape, generator=generator,
                                dtype=sigma_raw.dtype, device=sigma_raw.device)
        sigma_raw = sigma_raw + noise * radiance_field_noise_std
    sigma = torch.relu(sigma_raw)
    sigma = torch.cat([sigma[:, :-1], sigma[:, -1:] + 1e-6], dim=1)

    alpha = 1.0 - torch.exp(-sigma * dists)
    weights = alpha * cumprod_exclusive(1.0 - alpha + 1e-10)

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * depth_values, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(depth_map / acc_map, min=1e-10)

    if white_background:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return RenderOutputs(rgb_map, disp_map, acc_map, weights, depth_map)
