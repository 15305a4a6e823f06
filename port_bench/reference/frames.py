"""The plain reference of a served frame: every pixel's ray through both
levels in float32, on the same inputs and the same random draws as the
renderer under test.

With ``perturb`` on the renderer draws, for each chunk of ``chunk`` rays
in pixel order, the coarse jitter (rays, coarse) and then the importance
uniforms (rays, fine) from the frame's generator; the validation sigma
noise is 0 and draws nothing. A generator seeded alike gives the reference
those draws again. The frame is computed in blocks of ``block`` rays.
"""
from __future__ import annotations

import torch

from .model import Field, encode_pose, ray_bundle, render_rays


def render_frame(field: Field, H: int, W: int, intrinsics, pose, driving_or_audio,
                 background, near: float, far: float, coarse: int, fine: int,
                 gen_seed: int, chunk: int, block: int = 8192) -> torch.Tensor:
    """(H * W, 15) composited rgb | seg of the fine level."""
    dev = pose.device
    with torch.no_grad():
        driving = field.driving(driving_or_audio)
        pose_enc = encode_pose(pose)
        ro, rd = ray_bundle(H, W, intrinsics, pose)
        bg = background.reshape(H * W, -1)
        gen = torch.Generator(device=dev).manual_seed(gen_seed)
        out = []
        for start in range(0, H * W, chunk):
            n = min(chunk, H * W - start)
            t_rand = torch.rand((n, coarse), generator=gen, device=dev)
            u = torch.rand((n, fine), generator=gen, device=dev)
            for s in range(0, n, block):
                a, b = start + s, start + min(s + block, n)
                out.append(render_rays(field, ro[a:b], rd[a:b], near, far, driving,
                                       pose_enc, bg[a:b], t_rand[s:s + block],
                                       u[s:s + block])[1])
        return torch.cat(out)
