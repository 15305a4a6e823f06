"""K1: the warp + hyper-sheet deformation pair, forward.

Replaces ``sahs_tpu/ops/pallas/field_mlp.py:deform_pair_forward`` (:868,
``pallas_call`` at :1022), reached through ``deform_pair_apply_fused``.
The CUDA kernel is ``csrc/deform_pair.cu``; its source note gives the
bound on the H100 (operations: ~0.25 MFLOP per point) and the design.

``deform_pair_forward`` launches the kernel for tensors on a CUDA device
and counts the launch in ``deform_pair_forward.launches``; for tensors on
the CPU it runs ``deform_pair_plain``, the same function in plain tensor
math. There is no fallback from one to the other.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from ..grid import _cell_geometry
from . import _build
from .field_mlp import (BlobBuilder, PEGroup, fold_trunk, kernel_pe, mm,
                        linear_params, torch_dtype, trunk_forward,
                        trunk_into_blob, trunk_params)


@dataclasses.dataclass
class PairWeights:
    """Both deformation MLPs with the per-frame conditioning folded in.
    Trunks are lists of {"w": (in, out), "b": (out,)}; the skip layer's
    rows are [hidden ; pe]."""
    warp_trunk: List[dict]
    warp_out: dict
    hyper_trunk: List[dict]
    hyper_out: dict
    warp_skip: int
    hyper_skip: int
    pe_groups: Tuple[PEGroup, ...]
    _blobs: dict = dataclasses.field(default_factory=dict)

    def blob(self, dtype: torch.dtype):
        """(weight blob, bias blob, layer descriptors) for the kernel."""
        if dtype not in self._blobs:
            bb = BlobBuilder()
            trunk_into_blob(bb, self.warp_trunk, self.warp_skip, "relu",
                            self.warp_out, "tanh")
            trunk_into_blob(bb, self.hyper_trunk, self.hyper_skip, "relu",
                            self.hyper_out, "linear")
            self._blobs[dtype] = bb.build(dtype)
        return self._blobs[dtype]


def prepare_pair(warp, hyper, cond: torch.Tensor,
                 pe_groups: Sequence[PEGroup]) -> PairWeights:
    """Fold ``cond`` (driving ⊕ pose PE) into the input and skip biases of
    the ``WarpField`` and ``HyperSheet`` modules (field_mlp.py:1285-1298)."""
    pe_dim = warp.spec.pe_xyz_dim
    with torch.no_grad():
        wt = fold_trunk(trunk_params(warp.trunk), cond, pe_dim,
                        warp.spec.hidden_size, warp.spec.skip_connect_every)
        ht = fold_trunk(trunk_params(hyper.trunk), cond, pe_dim,
                        hyper.spec.hidden_size, hyper.spec.skip_connect_every)
    return PairWeights(wt, linear_params(warp.out), ht, linear_params(hyper.out),
                       warp.spec.skip_connect_every,
                       hyper.spec.skip_connect_every, tuple(pe_groups))


def deform_pair_plain(points: torch.Tensor, weights: PairWeights,
                      compute_dtype: str, samples: int, grid_dims):
    """points (P, 3) float32 -> (packed (P, 3 + ambient) [x + warp(x) |
    ambient], the corner-table rows of the warped points, int32 shaped
    (P // samples, samples))."""
    dtype = torch_dtype(compute_dtype)
    relu = torch.relu
    with torch.no_grad():
        pe = kernel_pe(points, weights.pe_groups)
        hw = trunk_forward(weights.warp_trunk, pe, weights.warp_skip, relu, dtype)
        yw = torch.tanh(mm(hw, weights.warp_out["w"], dtype) + weights.warp_out["b"])
        hh = trunk_forward(weights.hyper_trunk, pe, weights.hyper_skip, relu, dtype)
        yh = mm(hh, weights.hyper_out["w"], dtype) + weights.hyper_out["b"]
        warped = points[:, :3].to(torch.float32) + yw
        packed = torch.cat([warped, yh], dim=-1)
    rows, _, _ = _cell_geometry(warped, grid_dims)
    return packed, rows.to(torch.int32).reshape(-1, samples)


def _check_kernel_shapes(points, weights: PairWeights):
    if points.dtype != torch.float32 or points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (P, 3) float32, got "
                         f"{tuple(points.shape)} {points.dtype}")
    if weights.pe_groups != ((0, 3, weights.pe_groups[0][2], True, True),):
        raise ValueError("the K1 kernel encodes xyz with include_input and "
                         f"log sampling only, got {weights.pe_groups}")
    if weights.warp_out["w"].shape[1] != 3 or weights.hyper_out["w"].shape[1] > 8:
        raise ValueError("the K1 kernel takes a warp head of 3 outputs and a "
                         "hyper head of at most 8")


def deform_pair_forward(points: torch.Tensor, weights: PairWeights,
                        compute_dtype: str, samples: int, grid_dims):
    """K1 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Same arguments and results as ``deform_pair_plain``."""
    if points.device.type == "cpu":
        return deform_pair_plain(points, weights, compute_dtype, samples,
                                 grid_dims)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    _check_kernel_shapes(points, weights)
    dtype = torch_dtype(compute_dtype)
    points = points.contiguous()
    P = points.shape[0]
    wblob, bblob, meta = weights.blob(dtype)
    if wblob.device != points.device:
        raise ValueError(f"K1 weights are on {wblob.device}, points on "
                         f"{points.device}")
    wo, ho = 3, weights.hyper_out["w"].shape[1]
    if P % samples:
        raise ValueError(f"P={P} is not a multiple of samples={samples}")
    out = torch.empty((P, wo + ho), dtype=torch.float32, device=points.device)
    rows = torch.empty((P,), dtype=torch.int32, device=points.device)
    gD, gH, gW = grid_dims
    fn = _build.function("deform_pair", "sahs_deform_pair_forward",
                         "plppp" + "i" * 8 + "pp" + "iii" + "p")
    rc = fn(
        _build.ptr(points), P, _build.ptr(wblob), _build.ptr(bblob),
        _build.ptr(meta), len(weights.warp_trunk), len(weights.hyper_trunk),
        weights.warp_trunk[0]["w"].shape[1], weights.hyper_trunk[0]["w"].shape[1],
        wo, ho, weights.pe_groups[0][2], int(dtype == torch.bfloat16),
        _build.ptr(out), _build.ptr(rows), gD, gH, gW,
        _build.stream_ptr(points.device))
    _build.check(rc, "deform_pair_forward")
    deform_pair_forward.launches += 1
    return out, rows.reshape(-1, samples)


deform_pair_forward.launches = 0

