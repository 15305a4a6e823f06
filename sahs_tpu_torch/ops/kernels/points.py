"""K15: the sample positions of a ray bundle, o + d z, ray-major.

K15 replaces ``sahs_tpu/ops/pallas/field_mlp.py:build_pts`` (:814,
``pallas_call`` at :839), which the JAX fused train step uses under
``SAHS_PTS_KERNEL=1`` (``sahs_tpu/train/fused.py:156-163``); the port's
fused step builds both levels' positions with it on every step. The CUDA
kernel is ``csrc/build_pts.cu``: it rounds the product and the sum one at a
time, so its positions equal ``build_pts_plain``'s bit for bit. That is the
contract the JAX kernel's docstring states (field_mlp.py:819-824) and the
fused step's coarse-in-fine scatter needs.

The wrapper launches the kernel for tensors on a CUDA device and counts
the call in ``build_pts.launches``; for tensors on the CPU it runs
``build_pts_plain``. There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from . import _build


def build_pts_plain(ro: torch.Tensor, rd: torch.Tensor,
                    z: torch.Tensor) -> torch.Tensor:
    """ro, rd (R, 3), z (R, S) -> (R * S, 3): ro + rd * z, ray-major."""
    return (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3)


def build_pts(ro: torch.Tensor, rd: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """K15 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Same arguments and result as ``build_pts_plain``."""
    if ro.device.type == "cpu":
        return build_pts_plain(ro, rd, z)
    if ro.device.type != "cuda":
        raise ValueError(f"unsupported device {ro.device}")
    R = ro.shape[0]
    for name, t, shape in (("ro", ro, (R, 3)), ("rd", rd, (R, 3)),
                           ("z", z, (R, z.shape[-1]))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != ro.device):
            raise ValueError(f"K15 takes float32 ro, rd (R, 3) and z (R, S) "
                             f"on one device, got {name} {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    S = z.shape[1]
    ro, rd, z = ro.contiguous(), rd.contiguous(), z.contiguous()
    out = torch.empty((R * S, 3), dtype=torch.float32, device=ro.device)
    fn = _build.function("build_pts", "sahs_build_pts", "ppplipp")
    rc = fn(_build.ptr(ro), _build.ptr(rd), _build.ptr(z), R, S,
            _build.ptr(out), _build.stream_ptr(ro.device))
    _build.check(rc, "build_pts")
    build_pts.launches += 1
    return out


build_pts.launches = 0
