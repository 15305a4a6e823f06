"""Camera and ray geometry (counterpart of ``sahs_tpu/ops/rays.py``).

Parity targets in the reference:
  - get_ray_bundle      nerf-pytorch/nerf/nerf_helpers.py:178-233
  - ndc_rays            nerf-pytorch/nerf/nerf_helpers.py:362-391
  - rot_to_euler / pose_to_euler_trans   nerf-pytorch/nerf/models.py:482-504
"""
from __future__ import annotations

from typing import Tuple

import torch


def pixel_grid(height: int, width: int, dtype=torch.float32, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ii, jj), each (H, W), with ii running along columns."""
    ii = torch.arange(width, dtype=dtype, device=device)[None, :].expand(height, width)
    jj = torch.arange(height, dtype=dtype, device=device)[:, None].expand(height, width)
    return ii, jj


def get_ray_bundle(height: int, width: int, intrinsics: torch.Tensor,
                   tform_cam2world: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel ray origins and directions, each (H, W, 3).
    intrinsics = [fx, fy, cx, cy] with cx, cy relative to the image size.
    Directions are NOT normalised, as in the reference."""
    c2w = tform_cam2world
    intrinsics = intrinsics.to(c2w.dtype)
    ii, jj = pixel_grid(height, width, dtype=c2w.dtype, device=c2w.device)
    dirs = torch.stack(
        [(ii - width * intrinsics[2]) / intrinsics[0],
         -(jj - height * intrinsics[3]) / intrinsics[1],
         -torch.ones_like(ii)], dim=-1)
    # broadcast-multiply-sum, not a matmul: exact f32 on every backend
    ray_directions = torch.sum(dirs[..., None, :] * c2w[:3, :3], dim=-1)
    ray_origins = c2w[:3, -1].expand(ray_directions.shape)
    return ray_origins, ray_directions


def get_rays_at(flat_idx: torch.Tensor, height: int, width: int,
                intrinsics: torch.Tensor, tform_cam2world: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ray origins and directions, each (N, 3), at flat pixel indices
    (row-major h * W + w): the math of get_ray_bundle at those pixels only."""
    c2w = tform_cam2world
    intrinsics = intrinsics.to(c2w.dtype)
    ii = (flat_idx % width).to(c2w.dtype)
    jj = torch.div(flat_idx, width, rounding_mode="floor").to(c2w.dtype)
    dirs = torch.stack(
        [(ii - width * intrinsics[2]) / intrinsics[0],
         -(jj - height * intrinsics[3]) / intrinsics[1],
         -torch.ones_like(ii)], dim=-1)
    ray_directions = torch.sum(dirs[..., None, :] * c2w[:3, :3], dim=-1)
    ray_origins = c2w[:3, -1].expand(ray_directions.shape)
    return ray_origins, ray_directions


def ndc_rays(height: int, width: int, focal, near: float,
             rays_o: torch.Tensor, rays_d: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standard NeRF NDC warp; off in every shipped config (no_ndc: True)."""
    if not hasattr(focal, "__len__"):
        focal = (focal, focal)
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    o0 = -1.0 / (width / (2.0 * focal[0])) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (height / (2.0 * focal[1])) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (width / (2.0 * focal[0])) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (height / (2.0 * focal[1])) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def rot_to_euler(R: torch.Tensor) -> torch.Tensor:
    """(B,3,3) rotation -> (B,3) angles, with the reference's axis choices
    (models.py:482-498)."""
    e2 = torch.atan2(R[:, 0, 0], -R[:, 0, 1])
    e1 = torch.asin(-R[:, 0, 2])
    e0 = torch.atan2(R[:, 2, 2], R[:, 1, 2])
    return torch.stack([e0, e1, e2], dim=-1)


def pose_to_euler_trans(poses: torch.Tensor) -> torch.Tensor:
    """(B,3,4) or (B,4,4) pose -> (B,6) [euler(3), trans(3)]."""
    return torch.cat([rot_to_euler(poses), poses[:, :3, 3]], dim=1)
