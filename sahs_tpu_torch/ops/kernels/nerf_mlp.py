"""K11: the NeRF MLP on per-point inputs, forward (the per-point branch).

K11 replaces ``sahs_tpu/ops/pallas/field_mlp.py:nerf_mlp_forward_fused``
(:3204, ``pallas_call`` at :3246), which the JAX package runs when a level's
sample count does not tile its level kernels (nerface.py:442-460). Its
inputs are per point: the packed raw point [warped xyz | ambient] and the
extra input [raw dir | spatial embedding], whose encodings (10 and 4
frequencies for xyz and ambient, 4 for the direction; the embedding passed
through) it computes itself. The math is K7's but for the direction
branch's first layer, which reads the point's own [feat | pe(dir) | se]
(field_mlp.py:1525). In bfloat16 it runs on the tensor cores: the forward
tile of the level backward without its stash
(``csrc/level_train.cu:field_tc_kernel``, through
``nerf_level.nerf_field_tc``), on the forward blob its backward K12 reads
(``point_blob``); in float32 on the SIMT kernel of ``csrc/nerf_mlp.cu``.
The source notes give the bound on the H100 and the design.

K11 also takes JAX's pre-encoded form (``pe_spec`` / ``extra_pe_spec``
None, reached through ``nerf_mlp_apply_fused``, field_mlp.py:1410-1428):
the folded level's ``pts_groups`` None makes ``pts`` the point encoding
``pts_embed`` (P, kx) (81 columns at the flagship: pe(xyz) | pe(ambient)),
its ``dir_groups`` None makes ``extra`` the encoding ``dir_extra`` (P,
n_dir + C) (59: pe(dir) | se). JAX casts both to the compute dtype before
its kernel (:3220-3223); the wrapper does, and the kernels read them as
they are and form no PE (``ENC_PTS`` and ``ENC_EXTRA``, csrc/nerf_mlp.cu,
csrc/level_train.cu).

``nerf_mlp_forward_fused`` launches a kernel for CUDA tensors and counts
the launch in ``nerf_mlp_forward_fused.launches``; for CPU tensors it runs
``nerf_mlp_plain``, the same function in plain tensor math.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .field_mlp import kernel_pe, mm, torch_dtype
from .nerf_level import (LevelWeights, _pe_freqs, check_device, field_plain,
                         nerf_field_tc, point_blob)

# the kernels' bits of a pre-encoded input (csrc/nerf_mlp.cu, level_train.cu)
ENC_PTS, ENC_EXTRA = 1, 2


def encodings(pts: torch.Tensor, extra: torch.Tensor, weights: LevelWeights):
    """The per-point field's inputs as its layers read them, float32:
    (the point encoding, pe(dir), se, the raw directions). A level folded
    without point PE groups takes ``pts`` as its encoding, one without
    direction PE groups takes ``extra`` as [pe(dir) | se] (the raw
    directions are then None)."""
    n_dir = weights.dir0_dir.shape[0]
    C = weights.dir0_se.shape[0]
    x = (pts.to(torch.float32) if weights.pts_groups is None
         else kernel_pe(pts, weights.pts_groups))
    if weights.dir_groups is None:
        e = extra.to(torch.float32)
        return x, e[:, :n_dir], e[:, n_dir:n_dir + C], None
    dirs = extra[:, :3].to(torch.float32)
    return x, kernel_pe(dirs, weights.dir_groups), extra[:, 3:3 + C].to(torch.float32), dirs


def nerf_mlp_plain(pts: torch.Tensor, extra: torch.Tensor,
                   weights: LevelWeights, compute_dtype: str,
                   acts: Optional[dict] = None) -> torch.Tensor:
    """K11's plain version. pts (P, 3 + ambient) packed [warped xyz |
    ambient], extra (P, 3 + C) [raw dir | spatial embedding], weights a
    level folded by ``prepare_level`` (either input an encoding instead,
    as ``encodings`` reads them). Returns raw (P, 16) [rgb3 | seg12 |
    sigma1]. ``acts``, when given, receives what a backward needs (as
    ``nerf_level.nerf_raw_plain``'s, with the per-point ``dir_pe``, ``se``
    and the raw directions ``dirs``)."""
    dtype = torch_dtype(compute_dtype)
    W = weights
    with torch.no_grad():
        x, dpe, se, dirs = encodings(pts, extra, W)
        ein = torch.cat([dpe, se], dim=-1)
        d0e = torch.cat([W.dir0_dir, W.dir0_se], dim=0)
        raw = field_plain(
            W, x, lambda feat: (mm(feat, W.dir0_feat, dtype) + mm(ein, d0e, dtype)
                                + W.dir0_b), dtype, acts)
        if acts is not None:
            acts.update(se=se, dir_pe=dpe, dirs=dirs)
        return raw


def point_kernel_args(pts: torch.Tensor, extra: torch.Tensor,
                      weights: LevelWeights, what: str):
    """The shape checks and integer arguments of the per-point kernels
    (K11, K12): (P, PW, [n_trunk, hidden, branch, C, amb, nf_xyz, nf_amb,
    nf_dir], enc). ``enc`` holds ``ENC_PTS`` when ``pts`` is the point
    encoding (its width PW, no point PE: amb and the point frequencies 0)
    and ``ENC_EXTRA`` when ``extra`` is [pe(dir) | se] (C its whole width,
    no direction PE)."""
    P, PW = pts.shape
    C = weights.dir0_se.shape[0]
    enc = 0
    if weights.pts_groups is None:
        enc |= ENC_PTS
        nf_xyz = nf_amb = amb = 0
        kx = weights.trunk[0]["w"].shape[0]
        pts_ok = PW == kx
    else:
        nf_xyz, nf_amb = (_pe_freqs(weights.pts_groups, 2, "point") if PW > 3
                          else _pe_freqs(weights.pts_groups, 1, "point") + [0])
        amb = PW - 3
        kx = 3 + 6 * nf_xyz + amb * (1 + 2 * nf_amb)
        pts_ok = 3 <= PW <= 8
    if weights.dir_groups is None:
        enc |= ENC_EXTRA
        nf_dir, C = 0, weights.dir0_dir.shape[0] + C
        extra_ok = tuple(extra.shape) == (P, C)
    else:
        (nf_dir,) = _pe_freqs(weights.dir_groups, 1, "direction")
        extra_ok = tuple(extra.shape) == (P, 3 + C)
    hidden = weights.trunk[0]["w"].shape[1]
    branch = weights.dir0_b.shape[0]
    if (not pts_ok or not extra_ok
            or 2 * branch > hidden or branch % 8 or hidden % 8
            or -(-kx // 8) * 8 > hidden):
        raise ValueError(f"{what} shapes not supported: pts {tuple(pts.shape)}, "
                         f"extra {tuple(extra.shape)} for {C} channels, hidden "
                         f"{hidden}, branch {branch}, point PE width {kx}")
    return P, PW, [len(weights.trunk), hidden, branch, C, amb, nf_xyz,
                   nf_amb, nf_dir], enc


def nerf_mlp_forward_fused(pts: torch.Tensor, extra: torch.Tensor,
                           weights: LevelWeights,
                           compute_dtype: str = "bfloat16") -> torch.Tensor:
    """K11 wrapper: a CUDA kernel for CUDA tensors (bf16: ``nerf_field_tc``
    on the tensor cores; float32: the SIMT kernel), the plain version for
    CPU tensors. Same arguments and result as ``nerf_mlp_plain``."""
    if pts.device.type == "cpu":
        return nerf_mlp_plain(pts, extra, weights, compute_dtype)
    check_device("K11", pts.device)
    P, PW, ints, enc = point_kernel_args(pts, extra, weights, "K11")
    dtype = torch_dtype(compute_dtype)
    if dtype == torch.bfloat16:
        out = nerf_field_tc("K11", pts, weights, P, 1, ints, extra=extra, enc=enc)
        nerf_mlp_forward_fused.launches += 1
        return out
    wblob, bblob, meta = point_blob(weights, dtype)
    check_device("K11", pts.device, extra, wblob)
    f32 = torch.float32
    pts = pts.to(f32).contiguous()
    extra = extra.to(f32).contiguous()
    out = torch.empty((P, 16), dtype=f32, device=pts.device)
    fn = _build.function("nerf_mlp", "sahs_nerf_mlp_forward",
                         "p" * 6 + "l" + "i" * 10 + "p")
    p = _build.ptr
    rc = fn(p(pts), p(extra), p(wblob), p(bblob), p(meta), p(out), P, PW,
            *ints, enc, _build.stream_ptr(pts.device))
    _build.check(rc, "nerf_mlp_forward_fused")
    nerf_mlp_forward_fused.launches += 1
    return out


nerf_mlp_forward_fused.launches = 0
