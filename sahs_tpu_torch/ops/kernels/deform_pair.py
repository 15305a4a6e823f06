"""K1 and K3: the warp + hyper-sheet deformation pair, forward and backward.

K1 replaces ``sahs_tpu/ops/pallas/field_mlp.py:deform_pair_forward`` (:868,
``pallas_call`` at :1022), reached through ``deform_pair_apply_fused``.
The CUDA kernel is ``csrc/deform_pair.cu``; its source note gives the
bound on the H100 (operations: ~0.25 MFLOP per point) and the design.

K3 replaces ``field_mlp.py:deform_pair_vjp`` (:1098, ``pallas_call`` at
:1233) with need_gx=False, the train path's form: the dW and db of both
trunks and heads from the packed cotangent g (+ an addend g2). The CUDA
kernel is ``csrc/deform_pair_vjp.cu``.

Each wrapper launches its kernel for tensors on a CUDA device and counts
the call in ``<wrapper>.launches``; for tensors on the CPU it runs the
``*_plain`` version, the same function in plain tensor math. There is no
fallback from one to the other.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from ..grid import _cell_geometry
from . import _build
from .field_mlp import (BlobBuilder, PEGroup, TrainPlan, build_train_plan,
                        dact, dw_chunks, fold_trunk, kernel_pe, linear_params,
                        mm, mm_t, torch_dtype, trunk_backward, trunk_forward,
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


# ---------------------------------------------------------------------------
# K3: the pair's backward
# ---------------------------------------------------------------------------

TP_BWD = 32   # points per tile of K3's per-point kernel and of its stash


def pair_train_plan(weights: PairWeights, dtype: torch.dtype) -> TrainPlan:
    """K3's plan: the forward blob of K1, a blob of transposed head and
    trunk weights in backward order (per net: head, then layers L-1 .. 1,
    the skip layer by its hidden rows), the activation slots [pe, warp h_0
    .. h_{L-1}, hyper h_0 .. h_{L-1}] and the products of every layer."""
    key = ("train", dtype)
    if key not in weights._blobs:
        fwd, bwd = BlobBuilder(), BlobBuilder()
        trunk_into_blob(fwd, weights.warp_trunk, weights.warp_skip, "relu",
                        weights.warp_out, "tanh")
        trunk_into_blob(fwd, weights.hyper_trunk, weights.hyper_skip, "relu",
                        weights.hyper_out, "linear")
        pe_rows = weights.warp_trunk[0]["w"].shape[0]
        act_rows, inputs = [pe_rows], []
        for trunk, out, skip in ((weights.warp_trunk, weights.warp_out,
                                  weights.warp_skip),
                                 (weights.hyper_trunk, weights.hyper_out,
                                  weights.hyper_skip)):
            first = len(act_rows)        # act slot of this net's h_0
            hid = trunk[0]["w"].shape[1]
            for i in range(len(trunk)):
                inputs.append((0 if i == 0 else first + i - 1,
                               0 if (i == skip and i > 0) else -1))
                act_rows.append(hid)
            inputs.append((first + len(trunk) - 1, -1))
            zeros = torch.zeros(hid, device=out["w"].device)
            bwd.layer(out["w"].t(), zeros, "linear")
            for i in range(len(trunk) - 1, 0, -1):
                bwd.layer(trunk[i]["w"][:hid].t(), zeros, "linear")
        weights._blobs[key] = build_train_plan(fwd, bwd, act_rows, inputs,
                                               TP_BWD, dtype)
    return weights._blobs[key]


def _pair_grads(warp_layers, hyper_layers):
    return {"warp": {"trunk": warp_layers[:-1], "out": warp_layers[-1]},
            "hyper": {"trunk": hyper_layers[:-1], "out": hyper_layers[-1]}}


def deform_pair_vjp_plain(points: torch.Tensor, weights: PairWeights,
                          g: torch.Tensor, g2, compute_dtype: str):
    """Backward of K1 (field_mlp.py:_pair_bwd_math :1038-1095, need_gx
    False): both trunks recomputed from the shared PE of the raw points
    (P, 3), the packed cotangent g (+ g2) (P, 3 + ambient) taken back
    through the tanh warp head and the linear hyper head. Returns
    {"warp"|"hyper": {"trunk": [{"w", "b"}] folded, "out": {"w", "b"}}}."""
    dtype = torch_dtype(compute_dtype)
    with torch.no_grad():
        pe = kernel_pe(points, weights.pe_groups)
        gval = g.to(torch.float32) if g2 is None else (
            g.to(torch.float32) + g2.to(torch.float32))
        nets = []
        for trunk, out, skip, act, cols in (
                (weights.warp_trunk, weights.warp_out, weights.warp_skip,
                 "tanh", slice(0, 3)),
                (weights.hyper_trunk, weights.hyper_out, weights.hyper_skip,
                 "linear", slice(3, None))):
            acts = []
            h = trunk_forward(trunk, pe, skip, torch.relu, dtype, acts=acts)
            y = mm(h, out["w"], dtype) + out["b"]
            y = torch.tanh(y) if act == "tanh" else y
            gz = gval[:, cols] * dact(act, y)
            head = {"w": mm_t(h, gz, dtype), "b": torch.sum(gz, dim=0)}
            ga = mm(gz, out["w"].t(), dtype)
            _, tg = trunk_backward(trunk, pe, acts, ga, skip, "relu", dtype,
                                   need_gx=False)
            nets.append(tg + [head])
    return _pair_grads(*nets)


def deform_pair_vjp(points: torch.Tensor, weights: PairWeights,
                    g: torch.Tensor, g2, compute_dtype: str):
    """K3 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Same arguments and results as ``deform_pair_vjp_plain``.
    One call is one count, whatever the number of launches inside."""
    if points.device.type == "cpu":
        return deform_pair_vjp_plain(points, weights, g, g2, compute_dtype)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    _check_kernel_shapes(points, weights)
    dtype = torch_dtype(compute_dtype)
    P = points.shape[0]
    gw = 3 + weights.hyper_out["w"].shape[1]
    if max(weights.warp_trunk[0]["w"].shape[1],
           weights.hyper_trunk[0]["w"].shape[1]) > 128:
        raise ValueError("the K3 kernel takes trunks at most 128 wide")
    if tuple(g.shape) != (P, gw) or (g2 is not None and g2.shape != g.shape):
        raise ValueError(f"K3 cotangents must be ({P}, {gw}), got g "
                         f"{tuple(g.shape)}, g2 "
                         f"{None if g2 is None else tuple(g2.shape)}")
    plan = pair_train_plan(weights, dtype)
    if plan.fwd[0].device != points.device:
        raise ValueError(f"K3 weights are on {plan.fwd[0].device}, points on "
                         f"{points.device}")
    f32 = torch.float32
    points = points.contiguous()
    g = g.to(f32).contiguous()
    g2 = g2.to(f32).contiguous() if g2 is not None else None
    n_tiles = -(-P // TP_BWD)
    dev = points.device
    acts = torch.empty(n_tiles * plan.act_stride, dtype=dtype, device=dev)
    gzs = torch.empty(n_tiles * plan.gz_stride, dtype=f32, device=dev)
    chunks = dw_chunks(n_tiles)
    part = torch.zeros(chunks * plan.out_len, dtype=f32, device=dev)
    out = torch.empty(plan.out_len, dtype=f32, device=dev)
    p = _build.ptr
    fn = _build.function("deform_pair_vjp", "sahs_deform_pair_vjp",
                         "plpp" + "ppp" + "ppp" + "iiiiiii" + "p"
                         + "pp" + "i" * 6 + "pppp" + "p")
    rc = fn(p(points), P, p(g), p(g2), *[p(t) for t in plan.fwd],
            *[p(t) for t in plan.bwd], len(weights.warp_trunk),
            len(weights.hyper_trunk), weights.warp_skip, weights.hyper_skip,
            weights.pe_groups[0][2], gw - 3, int(dtype == torch.bfloat16),
            p(plan.slots), p(acts), p(gzs), plan.n_act, plan.act_stride,
            plan.gz_stride, plan.work.numel() // 3, chunks, plan.out_len,
            p(plan.prods), p(plan.work), p(part), p(out),
            _build.stream_ptr(dev))
    _build.check(rc, "deform_pair_vjp")
    deform_pair_vjp.launches += 1
    layers = plan.unpack(out)
    nw = len(weights.warp_trunk) + 1
    return _pair_grads(layers[:nw], layers[nw:])


deform_pair_vjp.launches = 0

