"""K1 and K3: the warp + hyper-sheet deformation pair, forward and backward.

K1 replaces ``sahs_tpu/ops/pallas/field_mlp.py:deform_pair_forward`` (:868,
``pallas_call`` at :1022), reached through ``deform_pair_apply_fused``.
The CUDA kernel is ``csrc/deform_pair.cu``; its source note gives the
bound on the H100 (operations: ~0.26 MFLOP per point) and the design. In
bfloat16 it runs on the tensor cores (``deform_pair_wg_kernel``: the
deformation nets' tile on wgmma, ``csrc/skip_wg.cuh``, both nets on one
encoding, with the semantics of K3's recomputed forward from the same
blob), its weights streamed as the stages of ``field_mlp.stage_blob``
(``skip_mlp.tile_stages``); in float32 on the CUDA cores. A bf16 pair whose
trunks are not multiples of ``skip_mlp.TC_K_STEP`` wide raises.

K3 replaces ``field_mlp.py:deform_pair_vjp`` (:1098, ``pallas_call`` at
:1233): the dW and db of both trunks and heads from the packed cotangent g
(+ an addend g2), and with need_gx the cotangent of the raw points
(field_mlp.py:1089-1094): gx = pe_bwd(x, gpe_warp + gpe_hyper) + g[:, :3],
the two nets' PE cotangents summed before the one shared PE backward, then
the residual of the warped coordinates. The train path asks for no gx
(need_gx=False) and runs as it did before that form existed: the same
plan, the same launches. The CUDA kernel is ``csrc/deform_pair_vjp.cu``:
in bfloat16 the deformation nets' backward tile on wgmma over 64-point
tiles (``csrc/skip_bw.cuh``, its weights streamed as the two stage blobs
of ``skip_mlp.backward_stages``) and the dW of ``csrc/level_dw.cuh`` over
bf16 stashes (``skip_mlp.vjp_buffers``); in float32 on the CUDA cores over
32-point tiles (``field_mlp.tile_points``; the stash follows the tile).

``deform_pair_apply_fused`` is the differentiable pair (field_mlp.py:
1284-1354): a ``torch.autograd.Function`` whose forward is K1 and whose
backward is K3, with the gradient going to the warp and hyper parameters,
to the conditioning and, only when autograd asks for it, to the points
(JAX's need_input_grad; the model path asks for none).

K1 and K3 also take the rays= form (field_mlp.py:882-885, :915, :949-953
and :1108-1130, :1181-1192; the JAX fused step under ``SAHS_PAIR_RAYS``):
``rays=(ro (R, 3), rd (R, 3), z (R, S))`` in place of the points, which
the kernels build per tile as K15 builds them (``points.build_pts``: the
product and then the sum rounded, never one FMA), so that the form's
results equal, bit for bit, the kernel's on K15's points.

Each wrapper launches its kernel for tensors on a CUDA device and counts
the call in ``<wrapper>.launches``; for tensors on the CPU it runs the
``*_plain`` version, the same function in plain tensor math. There is no
fallback from one to the other.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..grid import _cell_geometry
from . import _build
from .field_mlp import (BlobBuilder, PEGroup, TrainPlan, build_train_plan,
                        dact, fold_trunk, kernel_pe, linear_params, mm, mm_t,
                        pe_backward, tile_points, torch_dtype, trunk_backward,
                        trunk_forward, trunk_into_blob, trunk_params)
from .points import build_pts_plain
from .skip_mlp import (TC_K_STEP, VJP_WG_SIGNATURE, skip_param_grads,
                       tile_stages, vjp_buffers)

# The rays of the rays= form: (ro (R, 3), rd (R, 3), z (R, S)), float32.
Rays = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def ray_points(rays: Rays) -> torch.Tensor:
    """The rays' points (R * S, 3) as K15 rounds them, in float32 whatever
    the rays' type (an exact-sum run hands float64 copies of float32 rays),
    returned in the rays' type."""
    ro, rd, z = rays
    f32 = torch.float32
    return build_pts_plain(ro.to(f32), rd.to(f32), z.to(f32)).to(ro.dtype)


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
            self._blobs["descs"] = np.asarray(bb.descs, np.int32)
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


def deform_pair_plain(points: Optional[torch.Tensor], weights: PairWeights,
                      compute_dtype: str, samples: int, grid_dims,
                      rays: Optional[Rays] = None):
    """points (P, 3) float32 -> (packed (P, 3 + ambient) [x + warp(x) |
    ambient], the corner-table rows of the warped points, int32 shaped
    (P // samples, samples)). With ``grid_dims`` None (a model without the
    grid, JAX's emit_rows=None) there are no rows: (packed, None). With
    ``rays`` (points None) the points are ``ray_points(rays)``."""
    if rays is not None:
        points = ray_points(rays)
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
    if grid_dims is None:
        return packed, None
    rows, _, _ = _cell_geometry(warped, grid_dims)
    return packed, rows.to(torch.int32).reshape(-1, samples)


def _check_kernel_shapes(points, weights: PairWeights, what: str,
                         dtype: torch.dtype):
    """Raise unless the kernel takes ``points`` (None: the rays= form,
    checked by ``_rays_args``) and the pair's widths."""
    if points is not None and (points.dtype != torch.float32 or points.dim() != 2
                               or points.shape[1] != 3):
        raise ValueError(f"points must be (P, 3) float32, got "
                         f"{tuple(points.shape)} {points.dtype}")
    if weights.pe_groups != ((0, 3, weights.pe_groups[0][2], True, True),):
        raise ValueError(f"the {what} kernel encodes xyz with include_input and "
                         f"log sampling only, got {weights.pe_groups}")
    if weights.warp_out["w"].shape[1] != 3 or weights.hyper_out["w"].shape[1] > 8:
        raise ValueError(f"the {what} kernel takes a warp head of 3 outputs and a "
                         "hyper head of at most 8")
    widths = [p["w"].shape[1] for p in weights.warp_trunk + weights.hyper_trunk]
    # bf16: the forward tile (K1) takes multiples of TC_K_STEP, the backward
    # tile (K3, and K2's pair= form) any of 8
    step = TC_K_STEP if dtype == torch.bfloat16 and what == "K1" else 8
    if max(widths) > 128 or any(w % step for w in widths):
        raise ValueError(f"the {what} kernel takes trunks at most 128 wide, in "
                         f"multiples of {step}, got {widths}")


def _rays_args(rays: Rays, what: str):
    """The rays of the rays= form as contiguous float32 tensors on one CUDA
    device, and their (R, S)."""
    ro, rd, z = rays
    f32 = torch.float32
    if not (z.dim() == 2 and ro.dim() == 2 and ro.shape == rd.shape
            and ro.shape[1] == 3 and ro.shape[0] == z.shape[0]
            and ro.dtype is f32 and rd.dtype is f32 and z.dtype is f32
            and rd.device == ro.device and z.device == ro.device):
        raise ValueError(f"{what} takes float32 rays ro, rd (R, 3) and z (R, S) on "
                         f"one device, got ro {tuple(ro.shape)} {ro.dtype} on "
                         f"{ro.device}, rd {tuple(rd.shape)} {rd.dtype} on {rd.device}, "
                         f"z {tuple(z.shape)} {z.dtype} on {z.device}")
    return (ro.contiguous(), rd.contiguous(), z.contiguous()), tuple(z.shape)


def _points_device(points, rays) -> torch.device:
    return (points if rays is None else rays[2]).device


def deform_pair_forward(points: Optional[torch.Tensor], weights: PairWeights,
                        compute_dtype: str, samples: int, grid_dims,
                        rays: Optional[Rays] = None):
    """K1 wrapper: the CUDA kernel for CUDA tensors (bf16 on the tensor
    cores, float32 on the CUDA cores), the plain version for CPU tensors.
    Same arguments and results as ``deform_pair_plain``; with ``rays``
    (points None) the kernel's rays= form."""
    dev = _points_device(points, rays)
    if dev.type == "cpu":
        return deform_pair_plain(points, weights, compute_dtype, samples,
                                 grid_dims, rays)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    dtype = torch_dtype(compute_dtype)
    _check_kernel_shapes(points, weights, "K1", dtype)
    if rays is not None:
        rays, (R, S) = _rays_args(rays, "K1")
        if S != samples:
            raise ValueError(f"K1 rays of {S} samples, asked for {samples}")
        P = R * S
    else:
        points = points.contiguous()
        P = points.shape[0]
        if P % samples:
            raise ValueError(f"P={P} is not a multiple of samples={samples}")
    out = torch.empty((P, 3 + weights.hyper_out["w"].shape[1]), dtype=torch.float32,
                      device=dev)
    rows = (None if grid_dims is None
            else torch.empty((P,), dtype=torch.int32, device=dev))
    _launch(points, weights, dtype, grid_dims, out, rows, rays)
    deform_pair_forward.launches += 1
    return out, None if rows is None else rows.reshape(-1, samples)


deform_pair_forward.launches = 0


def _launch(points: Optional[torch.Tensor], weights: PairWeights,
            dtype: torch.dtype, grid_dims, out: torch.Tensor,
            rows: Optional[torch.Tensor], rays: Optional[Rays] = None):
    """One launch of K1's kernel on contiguous float32 ``points`` (P, 3),
    or on contiguous float32 ``rays`` (the rays= form, points None): the
    packed points into ``out`` (a contiguous float32 (P, 3 + ambient)
    tensor) and, with a grid, the rows into ``rows`` (a contiguous int32
    (P,) tensor)."""
    dev = _points_device(points, rays)
    wblob, bblob, meta = weights.blob(dtype)
    if wblob.device != dev:
        raise ValueError(f"K1 weights are on {wblob.device}, points on {dev}")
    gD, gH, gW = grid_dims or (0, 0, 0)
    n_warp = len(weights.warp_trunk)
    stages, descs = None, None
    if dtype == torch.bfloat16:
        heads = [n_warp, n_warp + 1 + len(weights.hyper_trunk)]
        stages, descs = tile_stages(weights, heads)
    rest = (_build.ptr(wblob), _build.ptr(bblob),
            _build.ptr(meta), n_warp, len(weights.hyper_trunk),
            weights.warp_trunk[0]["w"].shape[1], weights.hyper_trunk[0]["w"].shape[1],
            3, weights.hyper_out["w"].shape[1], weights.pe_groups[0][2],
            int(dtype == torch.bfloat16), _build.ptr(out), _build.ptr(rows), gD, gH, gW,
            _build.ptr(stages), 0 if stages is None else 2 * stages.numel(),
            None if descs is None else descs.ctypes.data, _build.stream_ptr(dev))
    if rays is None:
        fn = _build.function("deform_pair", "sahs_deform_pair_forward",
                             "plppp" + "i" * 8 + "pp" + "iii" + "plpp")
        rc = fn(_build.ptr(points), points.shape[0], *rest)
    else:
        ro, rd, z = rays
        fn = _build.function("deform_pair", "sahs_deform_pair_forward_rays",
                             "ppp" + "li" + "ppp" + "i" * 8 + "pp" + "iii" + "plpp")
        rc = fn(_build.ptr(ro), _build.ptr(rd), _build.ptr(z), z.shape[0], z.shape[1],
                *rest)
    _build.check(rc, "deform_pair_forward")


# ---------------------------------------------------------------------------
# K3: the pair's backward
# ---------------------------------------------------------------------------

def pair_train_plan(weights: PairWeights, dtype: torch.dtype,
                    need_gx: bool = False) -> TrainPlan:
    """K3's plan: the forward blob of K1, a blob of transposed head and
    trunk weights in backward order (per net: head, then layers L-1 .. 1,
    the skip layer by its hidden rows), the activation slots [pe, warp h_0
    .. h_{L-1}, hyper h_0 .. h_{L-1}] and the products of every layer.
    With ``need_gx`` the transposed blob also ends with each net's layer
    back to the encoding (warp, then hyper: layer 0 and the skip layer's pe
    rows, one two-input layer, as K14's); the rest is the plan without."""
    key = ("train", dtype) + (("gx",) if need_gx else ())
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
        if need_gx:
            for trunk, skip in ((weights.warp_trunk, weights.warp_skip),
                                (weights.hyper_trunk, weights.hyper_skip)):
                hid = trunk[0]["w"].shape[1]
                fires = 0 < skip < len(trunk)
                bwd.layer(trunk[0]["w"].t(),
                          torch.zeros(pe_rows, device=trunk[0]["w"].device),
                          "linear", w2=trunk[skip]["w"][hid:].t() if fires else None)
        weights._blobs[key] = build_train_plan(fwd, bwd, act_rows, inputs,
                                               tile_points(dtype), dtype)
    return weights._blobs[key]


def _pair_grads(warp_layers, hyper_layers):
    return {"warp": {"trunk": warp_layers[:-1], "out": warp_layers[-1]},
            "hyper": {"trunk": hyper_layers[:-1], "out": hyper_layers[-1]}}


def pair_grads_tree(weights: PairWeights, plan: TrainPlan, out: torch.Tensor):
    """The split-K reduction's output ``out`` of a pair plan as the plain
    version's gradient tree."""
    layers = plan.unpack(out)
    nw = len(weights.warp_trunk) + 1
    return _pair_grads(layers[:nw], layers[nw:])


def deform_pair_vjp_plain(points: Optional[torch.Tensor], weights: PairWeights,
                          g: torch.Tensor, g2, compute_dtype: str,
                          need_gx: bool = False, rays: Optional[Rays] = None):
    """Backward of K1 (field_mlp.py:_pair_bwd_math :1038-1095): both trunks
    recomputed from the shared PE of the raw points (P, 3), the packed
    cotangent g (+ g2) (P, 3 + ambient) taken back through the tanh warp
    head and the linear hyper head. Returns {"warp"|"hyper": {"trunk":
    [{"w", "b"}] folded, "out": {"w", "b"}}}; with ``need_gx`` (gx, that
    tree), gx (P, 3) float32 the cotangent of the raw points: the PE
    backward of the two nets' summed PE cotangents, plus the cotangent of
    the warped coordinates (the residual x of x + warp(x)). With ``rays``
    (points None) the points are ``ray_points(rays)``."""
    if rays is not None:
        points = ray_points(rays)
    dtype = torch_dtype(compute_dtype)
    with torch.no_grad():
        pe = kernel_pe(points, weights.pe_groups)
        gval = g.to(torch.float32) if g2 is None else (
            g.to(torch.float32) + g2.to(torch.float32))
        nets, gpe = [], None
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
            gp, tg = trunk_backward(trunk, pe, acts, ga, skip, "relu", dtype,
                                    need_gx=need_gx)
            gpe = gp if gpe is None else gpe + gp
            nets.append(tg + [head])
        grads = _pair_grads(*nets)
        if not need_gx:
            return grads
        gx = pe_backward(points, gpe, weights.pe_groups) + gval[:, :3]
    return gx, grads


def deform_pair_vjp(points: Optional[torch.Tensor], weights: PairWeights,
                    g: torch.Tensor, g2, compute_dtype: str,
                    need_gx: bool = False, rays: Optional[Rays] = None):
    """K3 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Same arguments and results as ``deform_pair_vjp_plain``;
    with ``rays`` (points None) the kernel's rays= form. One call is one
    count, whatever the number of launches inside."""
    dev = _points_device(points, rays)
    if dev.type == "cpu":
        return deform_pair_vjp_plain(points, weights, g, g2, compute_dtype,
                                     need_gx, rays)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = _vjp_launch(points, weights, g, g2, compute_dtype, need_gx, rays)
    deform_pair_vjp.launches += 1
    return out


deform_pair_vjp.launches = 0


# K3's C entries' arguments after the points (or the rays): g, g2, gx, the
# plan's blobs, the nets' shapes, the dtype's flag, the stashes, the dW's
# and the wgmma launch's (bf16), the stream
_VJP_SIGNATURE = ("ppp" + "ppp" + "ppp" + "iiiiiii" + "p" + "pp" + "i" * 6 + "pppp"
                  + VJP_WG_SIGNATURE + "p")


def _vjp_launch(points: Optional[torch.Tensor], weights: PairWeights, g: torch.Tensor,
                g2, compute_dtype: str, need_gx: bool = False, rays: Optional[Rays] = None):
    """One call of K3's kernels on CUDA tensors, not counted: what
    ``deform_pair_vjp`` returns. K2's pair= form runs it on K2's gx."""
    dev = _points_device(points, rays)
    dtype = torch_dtype(compute_dtype)
    _check_kernel_shapes(points, weights, "K3", dtype)
    if rays is not None:
        rays, (R, S) = _rays_args(rays, "K3")
        P = R * S
    else:
        P = points.shape[0]
    gw = 3 + weights.hyper_out["w"].shape[1]
    if tuple(g.shape) != (P, gw) or (g2 is not None and g2.shape != g.shape):
        raise ValueError(f"K3 cotangents must be ({P}, {gw}), got g "
                         f"{tuple(g.shape)}, g2 "
                         f"{None if g2 is None else tuple(g2.shape)}")
    plan = pair_train_plan(weights, dtype, need_gx)
    if plan.fwd[0].device != dev or g.device != dev:
        raise ValueError(f"K3 weights are on {plan.fwd[0].device}, points on "
                         f"{dev}, g on {g.device}")
    f32 = torch.float32
    g = g.to(f32).contiguous()
    g2 = g2.to(f32).contiguous() if g2 is not None else None
    n_tiles = -(-P // tile_points(dtype))
    nw, nh = len(weights.warp_trunk), len(weights.hyper_trunk)
    # held: what wg_args point to, alive until the launches are queued
    acts, gzs, chunks, part, out, wg_args, held = vjp_buffers(
        weights, plan, [nw, nw + 1 + nh], [nw, nh], need_gx, n_tiles, dtype, dev)
    gx = torch.empty((P, 3), dtype=f32, device=dev) if need_gx else None
    p = _build.ptr
    rest = (p(g), p(g2), p(gx), *[p(t) for t in plan.fwd],
            *[p(t) for t in plan.bwd], nw, nh, weights.warp_skip, weights.hyper_skip,
            weights.pe_groups[0][2], gw - 3, int(dtype == torch.bfloat16),
            p(plan.slots), p(acts), p(gzs), plan.n_act, plan.act_stride,
            plan.gz_stride, plan.work.numel() // 3, chunks, plan.out_len,
            p(plan.prods), p(plan.work), p(part), p(out), *wg_args,
            _build.stream_ptr(dev))
    if rays is None:
        points = points.contiguous()
        fn = _build.function("deform_pair_vjp", "sahs_deform_pair_vjp",
                             "pl" + _VJP_SIGNATURE)
        rc = fn(p(points), P, *rest)
    else:
        ro, rd, z = rays
        fn = _build.function("deform_pair_vjp", "sahs_deform_pair_vjp_rays",
                             "pppli" + _VJP_SIGNATURE)
        rc = fn(p(ro), p(rd), p(z), R, S, *rest)
    _build.check(rc, "deform_pair_vjp")
    grads = pair_grads_tree(weights, plan, out)
    return (gx, grads) if need_gx else grads


def pair_param_grads(warp, hyper, pair_g, cond: torch.Tensor):
    """K3's folded gradient tree -> ({parameter: grad} of the ``WarpField``
    and ``HyperSheet`` modules, d(cond)), through the conditioning unfold
    (field_mlp.py:617-644), one net at a time as K14's."""
    out = {}
    dcond = torch.zeros_like(cond)
    for name, net in (("warp", warp), ("hyper", hyper)):
        grads, dc = skip_param_grads(net, pair_g[name], cond)
        out.update(grads)
        dcond = dcond + dc
    return out, dcond


@dataclasses.dataclass
class PairOp:
    """What the differentiable pair holds beside the conditioning: the two
    modules and their parameters, the folded weights of this frame, the
    points (P, 3), the sample count and the grid's (D, H, W), None for a
    model without the grid (no rows)."""
    warp: torch.nn.Module
    hyper: torch.nn.Module
    params: List[torch.Tensor]
    weights: PairWeights
    points: torch.Tensor
    samples: int
    grid_dims: Optional[Tuple[int, int, int]]
    compute_dtype: str


class _DeformPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, cond, points, *params):
        ctx.op = op
        ctx.save_for_backward(cond)
        packed, rows = deform_pair_forward(points, op.weights,
                                           op.compute_dtype, op.samples,
                                           op.grid_dims)
        if rows is not None:
            ctx.mark_non_differentiable(rows)
        return packed, rows

    @staticmethod
    def backward(ctx, g_packed, _):
        op = ctx.op
        (cond,) = ctx.saved_tensors
        need_gx = ctx.needs_input_grad[2]
        out = deform_pair_vjp(op.points, op.weights, g_packed, None,
                              op.compute_dtype, need_gx=need_gx)
        gx, pair_g = out if need_gx else (None, out)
        by_param, dcond = pair_param_grads(op.warp, op.hyper, pair_g, cond)
        return (None, dcond, gx, *[by_param.get(p) for p in op.params])


def deform_pair_apply_fused(op: PairOp, cond: torch.Tensor):
    """The deformation pair, differentiable with respect to the modules'
    parameters, ``cond`` and, when ``op.points`` asks for a gradient, the
    points: (packed (P, 3 + ambient), rows (P // S, S) | None)."""
    return _DeformPair.apply(op, cond, op.points, *op.params)

