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
    CPU tensors. Same arguments and result as ``build_pts_plain``. The
    fused step calls it twice a step at a few hundred thousand points,
    where the kernel takes microseconds and the wrapper's host path most of
    a call: one check of dtypes, shapes and devices on ints and the
    tensors' own attributes, no copy of a contiguous input, the C function
    looked up once (``_build.function``)."""
    if not ro.is_cuda:
        if ro.device.type == "cpu":
            return build_pts_plain(ro, rd, z)
        raise ValueError(f"unsupported device {ro.device}")
    f32, index = torch.float32, ro.get_device()
    if not (z.dim() == 2 and ro.dtype is f32 and rd.dtype is f32 and z.dtype is f32
            and ro.shape == rd.shape and ro.dim() == 2 and ro.shape[1] == 3
            and ro.shape[0] == z.shape[0]
            and rd.get_device() == index and z.get_device() == index):
        raise ValueError(f"K15 takes float32 ro, rd (R, 3) and z (R, S) on one "
                         f"device, got ro {tuple(ro.shape)} {ro.dtype} on {ro.device}, "
                         f"rd {tuple(rd.shape)} {rd.dtype} on {rd.device}, "
                         f"z {tuple(z.shape)} {z.dtype} on {z.device}")
    if not ro.is_contiguous():
        ro = ro.contiguous()
    if not rd.is_contiguous():
        rd = rd.contiguous()
    if not z.is_contiguous():
        z = z.contiguous()
    R, S = z.shape
    out = torch.empty((R * S, 3), dtype=f32, device=ro.device)
    fn = _build.function("build_pts", "sahs_build_pts", "ppplipp")
    rc = fn(ro.data_ptr(), rd.data_ptr(), z.data_ptr(), R, S, out.data_ptr(),
            _build.stream_ptr(ro.device))
    _build.check(rc, "build_pts")
    build_pts.launches += 1
    return out


build_pts.launches = 0
