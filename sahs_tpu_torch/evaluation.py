"""Stage-I evaluation: the full-frame renderer that serves a trained model
(counterpart of ``sahs_tpu/evaluation.py``; reference
nerf-pytorch/eval_stage_rays.py)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .models.nerface import ModelSpec
from .render.pipeline import RenderSettings, render_image
from .utils.device import resolve_device


def cast_to_image(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        img = img.detach().float().cpu().numpy()
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8)


def make_eval_renderer(spec: ModelSpec, settings: RenderSettings, H: int,
                       W: int, near: float, far: float,
                       chunksize: Optional[int] = None,
                       with_latent: bool = False, device=None):
    """A full-image renderer on ``device`` (CUDA unless the caller names
    another; with no device given and no CUDA present this raises).

    Returns render(model, intrinsics, pose, driving, background, generator
    [, latent_code]) -> dict of (H, W, ...) tensors, as render_image. The
    model must already be on the device; the other inputs are moved there.

    On CUDA with the kernel path, chunks are clamped to 32768 rays as the
    JAX package clamps them on the TPU: a fine chunk is then 4.19 M
    points, and the plain versions used to check the kernels still fit in
    device memory at that size."""
    dev = resolve_device(device)
    if chunksize is None and settings.use_pallas and dev.type == "cuda":
        chunksize = min(settings.chunksize, 32768)

    def _to(x):
        if x is None:
            return None
        return torch.as_tensor(x, dtype=torch.float32).to(dev)

    def render(model, intrinsics, pose, driving, background=None,
               generator: Optional[torch.Generator] = None, latent_code=None):
        if with_latent and latent_code is None:
            raise ValueError("this renderer was built with_latent=True")
        return render_image(model, settings, H, W, _to(intrinsics), _to(pose),
                            near, far, _to(driving), generator=generator,
                            background=_to(background),
                            latent_code=_to(latent_code), chunksize=chunksize)

    return render
