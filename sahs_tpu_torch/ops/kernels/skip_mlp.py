"""K13 and K14: one deformation MLP (the warp field or the hyper sheet) on
its own, forward and backward.

A model whose warp and hyper nets cannot share K1's one kernel (a
warp-only model, an ambient-only model, or one whose two nets take
different conditioning) runs each net through these
(``sahs_tpu/models/nerface.py:380-398``).

K13 replaces ``sahs_tpu/ops/pallas/field_mlp.py:skip_mlp_forward`` (:345,
``pallas_call`` at :372) in both its forms: the raw-coordinate form
(``pe_spec`` given: the positional encoding is computed in the kernel), the
one the model uses, and the pre-encoded form (``pe_spec`` None, weights of
``prepare_skip`` with ``pe_groups`` None), whose input is the (P, in_dim)
encoding itself. As JAX casts that encoding to the compute dtype before
its kernel (field_mlp.py:354-356), the wrapper does, and the kernel reads
it as it is and forms no PE.

In bfloat16 K13 runs on the tensor cores (``csrc/skip_mlp.cu:
skip_wg_kernel``, the deformation nets' tile on wgmma, ``csrc/skip_wg.cuh``,
the one K1 runs with two nets), its weights streamed as the stages of
``field_mlp.stage_blob`` (``tile_stages``); in float32 on the CUDA cores
(``skip_mlp_kernel``).

K14 replaces ``field_mlp.py:skip_mlp_vjp`` (:516, ``pallas_call`` at :571):
the folded dW and db of every trunk layer and of the head, and, when asked,
the cotangent of the raw coordinates through the PE backward
(``_pe_bwd``, field_mlp.py:245-259), or in the pre-encoded form the
cotangent of the encoding, (P, in_dim) float32, with no PE backward. The CUDA kernels are
``csrc/skip_mlp.cu``; its source note gives the bound and the design. In
bfloat16 K14 runs the deformation nets' backward tile on wgmma over
64-point tiles (``csrc/skip_bw.cuh``, the tile K3 runs with both nets;
``backward_stages``) and the dW of ``csrc/level_dw.cuh``
(``vjp_buffers``), in float32 on the CUDA cores over 32-point tiles
(``field_mlp.tile_points``; the stash follows the tile).

``deform_mlp_apply_fused`` is the differentiable net (field_mlp.py:
647-703): a ``torch.autograd.Function`` whose forward is K13 and whose
backward is K14, with the gradient going to the net's parameters, to the
conditioning and, only when autograd asks for it, to the points.

Each wrapper launches its kernel for tensors on a CUDA device and counts
the call in ``<wrapper>.launches``; for tensors on the CPU it runs the
``*_plain`` version. There is no fallback from one to the other.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .field_mlp import (WG_KB, BlobBuilder, PEGroup, TrainPlan,
                        build_train_plan, dact, dw_items_on, fold_trunk,
                        kernel_pe, linear_grads, linear_params, mm, mm_t,
                        pe_backward, plan_buffers, stage_blob, stash_buffers,
                        tile_points, torch_dtype, trunk_backward, trunk_forward,
                        trunk_into_blob, trunk_params, unfold_cond_grads,
                        wgmma_chunks)

MAX_HIDDEN = 128
MAX_OUT = 8
# The forward tile of bf16 K1 and K13 (csrc/skip_wg.cuh) takes trunks of
# whole multiples of this width; the backward tile of K3 and K14
# (csrc/skip_bw.cuh), whose stages are zero-padded to 64 k, takes any
# multiple of 8 (the blobs' padding)
TC_K_STEP = 32


@dataclasses.dataclass
class SkipWeights:
    """One deformation MLP with the per-frame conditioning folded in: the
    trunk as a list of {"w": (in, out), "b": (out,)} (the skip layer's rows
    are [hidden ; pe]), the head and its activation ("tanh" for the warp
    field, "linear" for the hyper sheet), and the PE groups of the raw
    coordinates (None: the input is an encoding already)."""
    trunk: List[dict]
    out: dict
    skip: int
    out_act: str
    pe_groups: Optional[Tuple[PEGroup, ...]]
    _blobs: dict = dataclasses.field(default_factory=dict)

    def blob(self, dtype: torch.dtype):
        """(weight blob, bias blob, layer descriptors) for K13."""
        if dtype not in self._blobs:
            bb = BlobBuilder()
            with torch.no_grad():
                trunk_into_blob(bb, self.trunk, self.skip, "relu", self.out,
                                self.out_act)
                self._blobs[dtype] = bb.build(dtype)
            self._blobs["descs"] = np.asarray(bb.descs, np.int32)
        return self._blobs[dtype]


def tile_stages(weights, heads: Sequence[int]) -> Tuple[torch.Tensor, np.ndarray]:
    """What the bf16 forward tile of csrc/skip_wg.cuh reads beside the bias
    blob: the weight stages of ``weights.blob(bfloat16)`` (``SkipWeights``,
    or K1's ``PairWeights``; ``field_mlp.stage_blob``, rebuilt when that
    blob is another tensor or changed in place), and the blob's layer table
    in host memory (int32, 7 a layer), which the launch passes to the tile
    as a kernel parameter. ``heads``: each net's head layer."""
    w, _, meta = weights.blob(torch.bfloat16)
    descs = weights._blobs.get("descs")
    if descs is None:   # a blob put in place by hand
        descs = weights._blobs["descs"] = np.asarray(meta.reshape(-1, 7).tolist(),
                                                     np.int32)
    return stage_blob(weights._blobs, w, descs.tolist(), tuple(heads)), descs


def backward_stage_order(descs_t, trunks: Sequence[int], need_gx: bool) -> List[tuple]:
    """``field_mlp.stage_order``'s tuples of the transposed layers ``descs_t``
    of a pair's or one net's train plan (``trunks``: each net's trunk
    layers) in the order the bf16 backward tile (csrc/skip_bw.cuh) runs
    them: per net its head^T, trunk L-1 .. 1 and, with ``need_gx``, its
    layer back to the encoding (the plan's last layers, a net each: layer
    0's and the skip layer's pe rows, two inputs); per layer its one chunk
    of outputs (the width rounded up to 64), each input, its 64-k blocks."""
    out, t0 = [], 0
    for net, L in enumerate(trunks):
        layers = list(range(t0, t0 + L)) + ([sum(trunks) + net] if need_gx else [])
        t0 += L
        for q in layers:
            w1, k1, w2, k2, n = descs_t[q][:5]
            for c0, rows in wgmma_chunks(n, False):
                for off, k in ((w1, k1), (w2, k2)):
                    if off >= 0:
                        out += [(q, off, k, n, c0, rows, kb) for kb in range(-(-k // WG_KB))]
    return out


def backward_stages(weights, plan: TrainPlan, heads: Sequence[int],
                    trunks: Sequence[int], need_gx: bool):
    """The two stage blobs the bf16 backward tile (K3, K14) streams, built
    from the plan's blobs (a test's altered copy reaches the kernel; each
    kept while its blob is the same tensor, unchanged): the forward layers'
    (``field_mlp.stage_blob`` of ``plan.fwd``, as K1's and K13's tile reads
    them; ``heads``: each net's head layer) and the transposed layers' in
    ``backward_stage_order``."""
    fwd = stage_blob(weights._blobs, plan.fwd[0], plan.descs, tuple(heads),
                     name="wgmma_train")
    bwd = stage_blob(weights._blobs, plan.bwd[0], plan.descs_t, (),
                     order=lambda: backward_stage_order(plan.descs_t, trunks, need_gx),
                     name=f"wgmma_train_bwd{int(need_gx)}")
    return fwd, bwd


def vjp_buffers(weights, plan: TrainPlan, heads: Sequence[int], trunks: Sequence[int],
                need_gx: bool, n_tiles: int, dtype: torch.dtype, dev):
    """(acts, gzs, chunks, part, out, the wgmma launch's arguments, what
    they point to) of one K3 or K14 call. In bf16: the bf16 stashes, the
    tiles' column sums and level_dw.cuh's partials (``stash_buffers``), and
    the arguments (the two stage blobs and their bytes, the plan's host
    layer tables and slot offsets, bsum, the dW's work items and their
    count). In float32: the float32 stash and the plan's work list
    (``plan_buffers``), no such arguments. The caller holds the last entry
    until the launches are queued: a tensor freed before them would be
    handed to the next allocation while the kernels write it."""
    if dtype != torch.bfloat16:
        acts, gzs, chunks, part, out = plan_buffers(plan, n_tiles, dtype, dev)
        return acts, gzs, chunks, part, out, (None, 0, None, 0, None, None, 0, None, None,
                                              None, 0), ()
    acts, gzs, bsum, chunks, part, out = stash_buffers(plan, n_tiles, dev)
    wf, wb = backward_stages(weights, plan, heads, trunks, need_gx)
    items = dw_items_on(plan, dev)
    host = [np.asarray(t, np.int32) for t in (plan.descs, plan.descs_t, plan.act_off)]
    p = _build.ptr
    args = (p(wf), 2 * wf.numel(), p(wb), 2 * wb.numel(), host[0].ctypes.data,
            host[1].ctypes.data, len(plan.descs_t), host[2].ctypes.data, p(bsum), p(items),
            items.numel() // 4)
    return acts, gzs, chunks, part, out, args, (wf, wb, items, bsum, *host)


# the C functions' arguments of vjp_buffers' launch, after the dW output
VJP_WG_SIGNATURE = "plplppipppi"


def prepare_skip(net, cond: torch.Tensor,
                 pe_groups: Optional[Sequence[PEGroup]],
                 out_act: str) -> SkipWeights:
    """Fold ``cond`` (pose PE, after the driving vector when the net takes
    it) into the input and skip biases of a ``WarpField`` or
    ``HyperSheet`` (field_mlp.py:388-420, 650-652); ``out_act`` is the
    head's activation, "tanh" (warp) or "linear" (hyper)."""
    with torch.no_grad():
        trunk = fold_trunk(trunk_params(net.trunk), cond, net.spec.pe_xyz_dim,
                           net.spec.hidden_size, net.spec.skip_connect_every)
    return SkipWeights(trunk, linear_params(net.out),
                       net.spec.skip_connect_every,
                       out_act,
                       None if pe_groups is None else tuple(pe_groups))


def _encode(x: torch.Tensor, weights: SkipWeights) -> torch.Tensor:
    if weights.pe_groups is None:
        return x.to(torch.float32)
    return kernel_pe(x, weights.pe_groups)


def skip_mlp_plain(points: torch.Tensor, weights: SkipWeights,
                   compute_dtype: str) -> torch.Tensor:
    """points (P, 3) float32 raw coordinates (or (P, pe_dim) an encoding,
    for weights without PE groups) -> (P, out) float32: the trunk, the head
    and its activation."""
    dtype = torch_dtype(compute_dtype)
    with torch.no_grad():
        pe = _encode(points, weights)
        h = trunk_forward(weights.trunk, pe, weights.skip, torch.relu, dtype)
        y = mm(h, weights.out["w"], dtype) + weights.out["b"]
        return torch.tanh(y) if weights.out_act == "tanh" else y


def _kernel_input(points, weights: SkipWeights, what: str,
                  dtype: torch.dtype):
    """The checks of the kernels' shapes; returns (the input as the kernel
    reads it, n_freq, enc_dim): the raw (P, 3) float32 points with their PE
    frequencies and enc_dim 0, or a pre-encoded (P, in_dim) input in the
    compute dtype with n_freq 0 and enc_dim in_dim."""
    if weights.pe_groups is None:
        in_dim = weights.trunk[0]["w"].shape[0]
        if (not points.is_floating_point() or points.dim() != 2
                or points.shape[1] != in_dim or -(-in_dim // 8) * 8 > MAX_HIDDEN):
            raise ValueError(f"the pre-encoded input must be (P, {in_dim}), at "
                             f"most {MAX_HIDDEN} wide, got {tuple(points.shape)} "
                             f"{points.dtype}")
        x, n_freq, enc_dim = points.to(dtype).contiguous(), 0, in_dim
    else:
        n_freq = weights.pe_groups[0][2]
        if weights.pe_groups != ((0, 3, n_freq, True, True),):
            raise ValueError(f"the {what} kernel encodes xyz with include_input "
                             f"and log sampling only, got {weights.pe_groups}")
        if points.dtype != torch.float32 or points.dim() != 2 or points.shape[1] != 3:
            raise ValueError(f"points must be (P, 3) float32, got "
                             f"{tuple(points.shape)} {points.dtype}")
        x, enc_dim = points.contiguous(), 0
    widths = [p["w"].shape[1] for p in weights.trunk]
    step = TC_K_STEP if dtype == torch.bfloat16 and what == "K13" else 8
    if max(widths) > MAX_HIDDEN or any(w % step for w in widths):
        raise ValueError(f"the {what} kernel takes trunks at most "
                         f"{MAX_HIDDEN} wide, in multiples of {step}, got {widths}")
    if weights.out["w"].shape[1] > MAX_OUT:
        raise ValueError(f"the {what} kernel takes a head of at most "
                         f"{MAX_OUT} outputs, got {weights.out['w'].shape[1]}")
    return x, n_freq, enc_dim


def _on_device(points, tensor, what: str):
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    if tensor.device != points.device:
        raise ValueError(f"{what} weights are on {tensor.device}, points on "
                         f"{points.device}")


def skip_mlp_forward(points: torch.Tensor, weights: SkipWeights,
                     compute_dtype: str,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K13 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Same arguments and result as ``skip_mlp_plain``; ``out``,
    a (P, out) float32 tensor on the points' device, takes the result in
    place of a new one (the kernel writes its P rows and nothing else)."""
    if points.device.type == "cpu":
        return skip_mlp_plain(points, weights, compute_dtype)
    dtype = torch_dtype(compute_dtype)
    x, n_freq, enc_dim = _kernel_input(points, weights, "K13", dtype)
    wblob, bblob, meta = weights.blob(dtype)
    _on_device(points, wblob, "K13")
    P = points.shape[0]
    out_dim = weights.out["w"].shape[1]
    if out is None:
        out = torch.empty((P, out_dim), dtype=torch.float32, device=points.device)
    elif (out.shape != (P, out_dim) or out.dtype != torch.float32
          or out.device != points.device or not out.is_contiguous()):
        raise ValueError(f"K13's out must be a contiguous ({P}, {out_dim}) float32 "
                         f"tensor on {points.device}, got {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}")
    stages, descs, n_stage = None, None, 0
    if dtype == torch.bfloat16:
        stages, descs = tile_stages(weights, [len(weights.trunk)])
        n_stage = 2 * stages.numel()
    fn = _build.function("skip_mlp", "sahs_skip_mlp_forward", "plppp" + "i" * 6
                         + "pplpp")
    rc = fn(_build.ptr(x), P, _build.ptr(wblob), _build.ptr(bblob),
            _build.ptr(meta), len(weights.trunk), weights.trunk[0]["w"].shape[1],
            out_dim, n_freq, enc_dim, int(dtype == torch.bfloat16),
            _build.ptr(out), _build.ptr(stages), n_stage,
            None if descs is None else descs.ctypes.data,
            _build.stream_ptr(points.device))
    _build.check(rc, "skip_mlp_forward")
    skip_mlp_forward.launches += 1
    return out


skip_mlp_forward.launches = 0


# ---------------------------------------------------------------------------
# K14: the backward
# ---------------------------------------------------------------------------

def skip_train_plan(weights: SkipWeights, dtype: torch.dtype) -> TrainPlan:
    """K14's plan: K13's forward blob; a blob of transposed weights in
    backward order (the head, layers L-1 .. 1 by their hidden rows, then
    the layer back to the PE: layer 0's and the skip layer's pe rows as one
    two-input layer); the activation slots [pe, h_0 .. h_{L-1}] and the
    products of every layer."""
    key = ("train", dtype)
    if key in weights._blobs:
        return weights._blobs[key]
    trunk, skip = weights.trunk, weights.skip
    hid = trunk[0]["w"].shape[1]
    L = len(trunk)
    act_rows, inputs = [trunk[0]["w"].shape[0]], []
    for i in range(L):
        inputs.append((i, 0 if (i == skip and i > 0) else -1))
        act_rows.append(hid)
    inputs.append((L, -1))
    fwd, bwd = BlobBuilder(), BlobBuilder()
    with torch.no_grad():
        trunk_into_blob(fwd, trunk, skip, "relu", weights.out, weights.out_act)
        zeros = torch.zeros(hid, device=weights.out["w"].device)
        bwd.layer(weights.out["w"].t(), zeros, "linear")
        for i in range(L - 1, 0, -1):
            bwd.layer(trunk[i]["w"][:hid].t(), zeros, "linear")
        fires = 0 < skip < L
        bwd.layer(trunk[0]["w"].t(), torch.zeros(trunk[0]["w"].shape[0],
                                                 device=zeros.device),
                  "linear", w2=trunk[skip]["w"][hid:].t() if fires else None)
        weights._blobs[key] = build_train_plan(fwd, bwd, act_rows, inputs,
                                               tile_points(dtype), dtype)
    return weights._blobs[key]


def skip_mlp_vjp_plain(points: torch.Tensor, weights: SkipWeights,
                       g: torch.Tensor, need_gx: bool, compute_dtype: str):
    """Backward of K13 (field_mlp.py:534-563): the trunk recomputed from the
    encoding of ``points``, the cotangent g (P, out) taken back through the
    head's activation. Returns (gx (P, 3) | None, {"trunk": [{"w", "b"}]
    folded, "out": {"w", "b"}}); gx is with respect to the raw coordinates
    (the encoding, (P, in_dim), for weights without PE groups)."""
    dtype = torch_dtype(compute_dtype)
    with torch.no_grad():
        pe = _encode(points, weights)
        acts = []
        h = trunk_forward(weights.trunk, pe, weights.skip, torch.relu, dtype,
                          acts=acts)
        y = mm(h, weights.out["w"], dtype) + weights.out["b"]
        y = torch.tanh(y) if weights.out_act == "tanh" else y
        gz = g.to(torch.float32) * dact(weights.out_act, y)
        head = {"w": mm_t(h, gz, dtype), "b": torch.sum(gz, dim=0)}
        ga = mm(gz, weights.out["w"].t(), dtype)
        gpe, tg = trunk_backward(weights.trunk, pe, acts, ga, weights.skip,
                                 "relu", dtype, need_gx=need_gx)
        gx = None
        if need_gx:
            gx = (gpe if weights.pe_groups is None
                  else pe_backward(points, gpe, weights.pe_groups))
    return gx, {"trunk": tg, "out": head}


def skip_mlp_vjp(points: torch.Tensor, weights: SkipWeights, g: torch.Tensor,
                 need_gx: bool, compute_dtype: str):
    """K14 wrapper: the CUDA kernels for CUDA tensors, the plain version for
    CPU tensors. Same arguments and results as ``skip_mlp_vjp_plain``. One
    call is one count, whatever the number of launches inside: in bf16 the
    backward tile on wgmma (``skip_bwd_wg_kernel``) and level_dw.cuh's dW,
    in float32 the SIMT tile and dW."""
    if points.device.type == "cpu":
        return skip_mlp_vjp_plain(points, weights, g, need_gx, compute_dtype)
    dtype = torch_dtype(compute_dtype)
    x, n_freq, enc_dim = _kernel_input(points, weights, "K14", dtype)
    P = points.shape[0]
    out_dim = weights.out["w"].shape[1]
    if tuple(g.shape) != (P, out_dim):
        raise ValueError(f"K14's cotangent must be ({P}, {out_dim}), got "
                         f"{tuple(g.shape)}")
    plan = skip_train_plan(weights, dtype)
    _on_device(points, plan.fwd[0], "K14")
    f32 = torch.float32
    g = g.to(f32).contiguous()
    n_tiles = -(-P // tile_points(dtype))
    dev = points.device
    L = len(weights.trunk)
    # held: what wg_args point to, alive until the launches are queued
    acts, gzs, chunks, part, out, wg_args, held = vjp_buffers(
        weights, plan, [L], [L], need_gx, n_tiles, dtype, dev)
    gx = (torch.empty((P, enc_dim or 3), dtype=f32, device=dev) if need_gx
          else None)
    p = _build.ptr
    fn = _build.function("skip_mlp", "sahs_skip_mlp_vjp",
                         "plp" + "ppp" + "ppp" + "i" * 6 + "pppp"
                         + "i" * 6 + "pppp" + VJP_WG_SIGNATURE + "p")
    rc = fn(p(x), P, p(g), *[p(t) for t in plan.fwd],
            *[p(t) for t in plan.bwd], L, weights.skip,
            n_freq, enc_dim, out_dim, int(dtype == torch.bfloat16),
            p(plan.slots), p(acts), p(gzs), p(gx), plan.n_act, plan.act_stride,
            plan.gz_stride, plan.work.numel() // 3, chunks, plan.out_len,
            p(plan.prods), p(plan.work), p(part), p(out), *wg_args,
            _build.stream_ptr(dev))
    _build.check(rc, "skip_mlp_vjp")
    skip_mlp_vjp.launches += 1
    layers = plan.unpack(out)
    return gx, {"trunk": layers[:-1], "out": layers[-1]}


skip_mlp_vjp.launches = 0


def skip_param_grads(net, grads, cond: torch.Tensor):
    """K14's folded gradient tree -> ({parameter: grad} of the module,
    d(cond)), through the conditioning unfold (field_mlp.py:617-644)."""
    raw = [{"w": p["w"].detach(), "b": p["b"].detach()}
           for p in trunk_params(net.trunk)]
    tg, dcond = unfold_cond_grads(raw, grads["trunk"], cond,
                                  net.spec.skip_connect_every,
                                  net.spec.hidden_size, net.spec.pe_xyz_dim)
    out = {}
    for lin, gl in zip(net.trunk.layers, tg):
        linear_grads(out, lin, gl)
    linear_grads(out, net.out, grads["out"])
    return out, dcond


@dataclasses.dataclass
class SkipOp:
    """What the differentiable net holds beside the conditioning: the
    module and its parameters, the folded weights of this frame, the points
    (P, 3) and the compute dtype."""
    net: torch.nn.Module
    params: List[torch.Tensor]
    weights: SkipWeights
    points: torch.Tensor
    compute_dtype: str


class _SkipMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, cond, points, *params):
        ctx.op = op
        ctx.save_for_backward(cond, points)
        return skip_mlp_forward(points, op.weights, op.compute_dtype)

    @staticmethod
    def backward(ctx, g):
        op = ctx.op
        cond, points = ctx.saved_tensors
        gx, grads = skip_mlp_vjp(points, op.weights, g, ctx.needs_input_grad[2],
                                 op.compute_dtype)
        by_param, dcond = skip_param_grads(op.net, grads, cond)
        return (None, dcond, gx, *[by_param.get(p) for p in op.params])


def deform_mlp_apply_fused(op: SkipOp, cond: torch.Tensor) -> torch.Tensor:
    """One deformation net on ``op.points``, differentiable with respect to
    its parameters, ``cond`` and (when autograd asks) the points: (P, out)."""
    return _SkipMLP.apply(op, cond, op.points, *op.params)
