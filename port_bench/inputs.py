"""Seeded inputs: camera poses, driving inputs, the background prior and
the training frames, made on the device in a few calls each.

A head sits at the origin; each camera looks at it from a jittered point
on the sphere of radius (near + far) / 2, as a monocular video of a talking
head sees it. A training frame is a face-like parse map (background, hair,
face, nose, eyes, lips, mouth interior, torso as concentric regions around
a jittered centre) with a colour per class, tinted and noised.
"""
from __future__ import annotations

from typing import Dict

import torch

from .shapes import AUDIO_WINDOW, DRIVING_DIM, SEG_CLASSES
from .weights import sub_seed


def _gen(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def intrinsics(W: int, device) -> torch.Tensor:
    """[fx, fy, cx, cy], the centre relative to the image size."""
    f = 1.2 * W
    return torch.tensor([f, f, 0.5, 0.5], dtype=torch.float32, device=device)


def poses(n: int, radius: float, seed: int, device) -> torch.Tensor:
    """(n, 3, 4) camera-to-world poses looking along -z at the origin."""
    g = _gen(seed, "poses", device)
    u = torch.rand((n, 2), generator=g, device=device)
    theta = (u[:, 0] * 2 - 1) * 0.3
    phi = (u[:, 1] * 2 - 1) * 0.2
    eye = radius * torch.stack([torch.sin(theta) * torch.cos(phi), torch.sin(phi),
                                torch.cos(theta) * torch.cos(phi)], dim=-1)
    fwd = -eye / eye.norm(dim=-1, keepdim=True)
    up = torch.tensor([0.0, 1.0, 0.0], device=device).expand_as(fwd)
    right = torch.linalg.cross(fwd, up)
    right = right / right.norm(dim=-1, keepdim=True)
    up = torch.linalg.cross(right, fwd)
    return torch.stack([right, up, -fwd, eye], dim=-1)


def driving(n: int, audio: bool, seed: int, device) -> torch.Tensor:
    """(n, 16, 29) DeepSpeech-like windows, or (n, 76) expression codes."""
    g = _gen(seed, "driving", device)
    if audio:
        return torch.randn((n,) + AUDIO_WINDOW, generator=g, device=device)
    return torch.randn((n, DRIVING_DIM), generator=g, device=device) * 0.1


def background(H: int, W: int, seed: int, device) -> torch.Tensor:
    """(H, W, 15): a smooth colour field and the background class."""
    g = _gen(seed, "background", device)
    yy = torch.linspace(0, 1, H, device=device)[:, None, None]
    xx = torch.linspace(0, 1, W, device=device)[None, :, None]
    a = torch.rand((4, 3), generator=g, device=device)
    rgb = 0.5 + 0.25 * (torch.sin(6.28 * (a[0] * xx + a[1] * yy) + 6.28 * a[2])
                        + (a[3] - 0.5))
    seg = torch.zeros((H, W, SEG_CLASSES), device=device)
    seg[..., 0] = 1.0
    return torch.cat([rgb.clamp(0, 1), seg], dim=-1).contiguous()


def train_frames(n: int, H: int, W: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """n frames: image (n, H, W, 3) and one-hot mask (n, H, W, 12)."""
    g = _gen(seed, "frames", device)
    jit = torch.rand((n, 2), generator=g, device=device)
    yy = torch.arange(H, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(W, device=device, dtype=torch.float32)[None, None, :]
    cx = (W / 2 + (jit[:, 0] * 2 - 1) * 0.05 * W)[:, None, None]
    cy = (H / 2 + (jit[:, 1] * 2 - 1) * 0.05 * H)[:, None, None]
    r = torch.sqrt((xx - cx) ** 2 + (yy - cy) ** 2) / (0.5 * min(H, W))
    lab = torch.zeros((n, H, W), dtype=torch.long, device=device)
    lab = torch.where(r < 0.8, 9, lab)                                  # hair
    lab = torch.where(r < 0.6, 1, lab)                                  # face
    lab = torch.where(r < 0.15, 2, lab)                                 # nose
    lab = torch.where((r > 0.2) & (r < 0.3) & (yy < cy), 4, lab)        # eyes
    lab = torch.where((r < 0.25) & (yy > cy + 0.125 * H), 8, lab)       # lips
    lab = torch.where((r < 0.12) & (yy > cy + 0.15 * H), 7, lab)        # mouth
    lab = torch.where(yy > cy + 0.45 * H, 11, lab)                      # torso
    mask = torch.nn.functional.one_hot(lab, SEG_CLASSES).to(torch.float32)
    colours = torch.rand((SEG_CLASSES, 3), generator=g, device=device)
    tint = 0.6 + 0.4 * torch.rand((n, 1, 1, 3), generator=g, device=device)
    noise = torch.randn((n, H, W, 3), generator=g, device=device) * 0.02
    image = (colours[lab] * tint + noise).clamp(0, 1)
    return {"image": image.contiguous(), "mask": mask.contiguous()}
