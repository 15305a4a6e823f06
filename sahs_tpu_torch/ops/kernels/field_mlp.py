"""Helpers shared by the field kernels (non-kernel parts of
``sahs_tpu/ops/pallas/field_mlp.py``).

- Per-frame conditioning (driving and pose PE, constant across points) is
  folded into effective biases of the input and skip layers, so a kernel's
  per-point input is only the positional encoding (field_mlp.py:388-420).
- The kernels compute their positional encoding themselves from the raw
  coordinates. ``kernel_pe`` is that encoding in plain tensor math: each
  slot is sin(x * f + phase), cos slots being sin with a float32 pi/2
  phase, and include-input slots pass x through. The angle is formed and
  the sine taken in float32: angles reach 2^9 |x|, where a fast sine loses
  the digits the MLP needs.
- ``mm`` is the matmul semantics every kernel follows: operands rounded to
  the compute dtype, products accumulated in float32. Biases, the PE and
  compositing stay float32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..encoding import frequency_bands

# (src_col, dim, num_freq, include_input, log_sampling), as the JAX PESpec
PEGroup = Tuple[int, int, int, bool, bool]

HALF_PI_F32 = float(np.float32(np.pi / 2))


def torch_dtype(compute_dtype: str) -> torch.dtype:
    if compute_dtype == "float32":
        return torch.float32
    if compute_dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                     f"got {compute_dtype!r}")


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to ``dtype`` and held in float32."""
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


def mm(a: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """a @ w with both operands rounded to ``dtype`` and float32 sums."""
    return round_to(a, dtype) @ round_to(w, dtype)


def pe_columns(groups: Sequence[PEGroup]):
    """Per-output-slot (src column, frequency, phase, is_input) tables, in
    the layout of ops/encoding.py: per group [x?, sin(f0 x), cos(f0 x), ...]."""
    src, freq, phase, is_input = [], [], [], []
    for (s0, dim, nf, inc, log_s) in groups:
        freqs = frequency_bands(nf, log_s)
        if inc:
            for d in range(dim):
                src.append(s0 + d), freq.append(1.0), phase.append(0.0)
                is_input.append(True)
        for f in range(nf):
            for trig in range(2):
                for d in range(dim):
                    src.append(s0 + d)
                    freq.append(float(freqs[f]))
                    phase.append(HALF_PI_F32 if trig else 0.0)
                    is_input.append(False)
    return (np.asarray(src, np.int64), np.asarray(freq, np.float32),
            np.asarray(phase, np.float32), np.asarray(is_input, bool))


def kernel_pe(x: torch.Tensor, groups: Sequence[PEGroup]) -> torch.Tensor:
    """(P, >=cols) float32 raw coordinates -> (P, pe_dim) float32 encoding,
    exactly as the CUDA kernels compute it."""
    src, freq, phase, is_input = pe_columns(groups)
    dev = x.device
    xs = x[:, torch.as_tensor(src, device=dev)].to(torch.float32)
    t = xs * torch.as_tensor(freq, device=dev) + torch.as_tensor(phase, device=dev)
    return torch.where(torch.as_tensor(is_input, device=dev), xs, torch.sin(t))


def linear_params(lin: torch.nn.Linear) -> Dict[str, torch.Tensor]:
    """nn.Linear -> {"w": (in, out), "b": (out,)} (the JAX layout)."""
    return {"w": lin.weight.t(), "b": lin.bias}


def trunk_params(trunk) -> List[Dict[str, torch.Tensor]]:
    return [linear_params(lin) for lin in trunk.layers]


def _cond_dot(cond: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # elementwise multiply-sum: full float32 on every device (never TF32)
    return torch.sum(cond[:, None].to(w.dtype) * w, dim=0)


def fold_conditioning(trunk, cond: torch.Tensor, pe_dim: int):
    """Input layer: b_eff = b + cond @ W[pe_dim:], W keeps its first
    ``pe_dim`` rows (field_mlp.py:388-403)."""
    out = list(trunk)
    w, b = trunk[0]["w"], trunk[0]["b"]
    out[0] = {"w": w[:pe_dim], "b": b + _cond_dot(cond, w[pe_dim:])}
    return out


def fold_skip_conditioning(hidden: int, trunk, skip_every: int,
                           cond: torch.Tensor, pe_dim: int):
    """Skip layer, whose rows are [hidden ; pe ; cond] (field_mlp.py:406-420).
    No-op when the skip never fires."""
    if skip_every <= 0 or skip_every >= len(trunk):
        return trunk
    out = list(trunk)
    w, b = trunk[skip_every]["w"], trunk[skip_every]["b"]
    out[skip_every] = {"w": w[:hidden + pe_dim],
                       "b": b + _cond_dot(cond, w[hidden + pe_dim:])}
    return out


def fold_trunk(trunk, cond: torch.Tensor, pe_dim: int, hidden: int,
               skip_every: int):
    trunk = fold_conditioning(trunk, cond, pe_dim)
    return fold_skip_conditioning(hidden, trunk, skip_every, cond, pe_dim)


def trunk_forward(trunk, x: torch.Tensor, skip_every: int, act,
                  dtype: torch.dtype, acts: List[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Folded trunk on a (P, pe_dim) input. The skip layer's weight splits
    into [h | x] row blocks (field_mlp.py:278-298). ``acts``, when given,
    collects every layer's output for a backward pass."""
    h = act(mm(x, trunk[0]["w"], dtype) + trunk[0]["b"])
    if acts is not None:
        acts.append(h)
    for i in range(1, len(trunk)):
        w, b = trunk[i]["w"], trunk[i]["b"]
        if i == skip_every:
            hid = h.shape[1]
            h = act(mm(h, w[:hid], dtype) + mm(x, w[hid:], dtype) + b)
        else:
            h = act(mm(h, w, dtype) + b)
        if acts is not None:
            acts.append(h)
    return h


# ---------------------------------------------------------------------------
# Backward helpers (the plain versions of K2 and K3)
# ---------------------------------------------------------------------------

def dact(name: str, y: torch.Tensor) -> torch.Tensor:
    """Activation derivative from the activation's output (field_mlp.py:77-88)."""
    if name == "relu":
        return (y > 0).to(y.dtype)
    if name == "leaky":
        return torch.where(y > 0, 1.0, 0.01).to(y.dtype)
    if name == "tanh":
        return 1.0 - y * y
    return torch.ones_like(y)


def mm_t(a: torch.Tensor, g: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """a.T @ g, the dW contraction over points, with the ``mm`` semantics."""
    return round_to(a, dtype).t() @ round_to(g, dtype)


def trunk_backward(trunk, x: torch.Tensor, acts: List[torch.Tensor],
                   ga: torch.Tensor, skip_every: int, act: str,
                   dtype: torch.dtype, need_gx: bool):
    """Backprop through a folded trunk given d(last hidden) = ``ga``
    (field_mlp.py:471-499). Returns (gx | None, [{"w", "b"}] grads in the
    folded shapes)."""
    grads = [None] * len(trunk)
    gx = None
    for i in range(len(trunk) - 1, -1, -1):
        gz = ga * dact(act, acts[i])
        w = trunk[i]["w"]
        a_prev = x if i == 0 else acts[i - 1]
        if i == skip_every and i > 0:
            hid = a_prev.shape[1]
            dw = torch.cat([mm_t(a_prev, gz, dtype), mm_t(x, gz, dtype)], dim=0)
            if need_gx:
                gx = mm(gz, w[hid:].t(), dtype) + (0 if gx is None else gx)
            ga = mm(gz, w[:hid].t(), dtype)
        else:
            dw = mm_t(a_prev, gz, dtype)
            if i == 0:
                if need_gx:
                    gx = mm(gz, w.t(), dtype) + (0 if gx is None else gx)
            else:
                ga = mm(gz, w.t(), dtype)
        grads[i] = {"w": dw, "b": torch.sum(gz, dim=0)}
    return gx, grads


def unfold_cond_grads(raw_trunk, folded_grads, cond: torch.Tensor,
                      skip_every: int, hidden: int, pe_dim: int):
    """Gradients of the raw trunk from those of the folded one
    (field_mlp.py:617-644): the folded layers' conditioning rows get
    outer(cond, db), since b_eff = b + cond @ W_tail, and d(cond) gathers
    W_tail @ db over the input and the skip layer."""
    if skip_every <= 0 or skip_every >= len(raw_trunk):
        skip_every = -1
    out = []
    dcond = torch.zeros_like(cond)
    for i, (p, g) in enumerate(zip(raw_trunk, folded_grads)):
        w, db = p["w"], g["b"]
        if i == 0 or i == skip_every:
            tail = w[pe_dim:] if i == 0 else w[hidden + pe_dim:]
            dw = torch.cat([g["w"], cond[:, None] * db[None, :]], dim=0)
            # elementwise multiply-sum: full float32 (never TF32)
            dcond = dcond + torch.sum(tail.to(db.dtype) * db[None, :], dim=1)
        else:
            dw = g["w"]
        out.append({"w": dw, "b": db})
    return out, dcond


# ---------------------------------------------------------------------------
# Weight blobs for the CUDA kernels
# ---------------------------------------------------------------------------

# One LayerDesc per layer, int32: element offsets into the weight blob
# (w1, w2 or -1) and the bias blob, the two input widths, the padded output
# width, and the activation. Matches LayerDesc in csrc/mlp.cuh.
ACT = {"linear": 0, "relu": 1, "leaky": 2, "tanh": 3}
DESC_INTS = 7


class BlobBuilder:
    """Packs (in, out) weight matrices into one compute-dtype blob with each
    output width padded to a multiple of 8 (zero columns), and biases into
    one float32 blob. Every offset is a multiple of 8 elements, so the
    kernels read 16-byte vectors."""

    def __init__(self):
        self.w_parts: List[torch.Tensor] = []
        self.b_parts: List[torch.Tensor] = []
        self.w_len = 0
        self.b_len = 0
        self.descs: List[List[int]] = []
        self.n_real: List[int] = []

    @staticmethod
    def padded(n: int) -> int:
        return -(-n // 8) * 8

    def _add_w(self, w: torch.Tensor, n_pad: int) -> int:
        k, n = w.shape
        wp = torch.zeros((k, n_pad), dtype=torch.float32, device=w.device)
        wp[:, :n] = w
        off = self.w_len
        self.w_parts.append(wp.reshape(-1))
        self.w_len += wp.numel()
        return off

    def add_bias(self, b: torch.Tensor, n_pad: int) -> int:
        bp = torch.zeros((n_pad,), dtype=torch.float32, device=b.device)
        bp[:b.shape[0]] = b
        off = self.b_len
        self.b_parts.append(bp)
        self.b_len += n_pad
        return off

    def layer(self, w1: torch.Tensor, b: torch.Tensor, act: str,
              w2: torch.Tensor = None) -> int:
        """Add a layer y = act(x1 @ w1 [+ x2 @ w2] + b); returns its index."""
        n_pad = self.padded(w1.shape[1])
        o1 = self._add_w(w1, n_pad)
        o2, k2 = -1, 0
        if w2 is not None:
            o2, k2 = self._add_w(w2, n_pad), w2.shape[0]
        ob = self.add_bias(b, n_pad)
        self.descs.append([o1, w1.shape[0], o2, k2, n_pad, ob, ACT[act]])
        self.n_real.append(w1.shape[1])
        return len(self.descs) - 1

    def build(self, dtype: torch.dtype):
        w = torch.cat(self.w_parts).to(dtype).contiguous()
        b = torch.cat(self.b_parts).contiguous()
        meta = torch.tensor(self.descs, dtype=torch.int32).reshape(-1)
        return w, b, meta.to(w.device)


@dataclasses.dataclass
class TrainPlan:
    """What a backward kernel (K2, K3) needs beside the forward blob.

    - ``bwd``: a blob of transposed weights, read by the per-point backward
      as plain layers (linear, zero bias);
    - ``slots``: int32 element offsets, within one tile's block of the two
      device-memory stashes, of each stored activation (compute dtype) and
      of each layer's pre-activation cotangent gz (float32). A stash is
      tile-blocked: tile b's block starts at b * stride, and inside it a
      slot of K rows is k-major, row k holding the tile's TP points;
    - ``prods``: int32 (n, 6) rows [a_off, K, g_off, N, out_off, is_bias]:
      dW[k][n] = sum_p A[p][k] gz[p][n] over all points, written at
      ``out_off`` of the float32 output, which is laid out like the forward
      weight blob followed by its bias blob (bias rows take A = 1);
    - ``work``: int32 (m, 3) rows [product, k0, n0], one 64 x 64 output
      tile each."""
    fwd: tuple
    bwd: tuple
    descs: List[List[int]]
    n_real: List[int]
    slots: torch.Tensor
    act_stride: int
    gz_stride: int
    n_act: int
    prods: torch.Tensor
    work: torch.Tensor
    w_len: int
    out_len: int

    def unpack(self, out: torch.Tensor):
        """The float32 output of the dW reduction -> one {"w", "b"} per
        forward layer (two-input layers stacked by rows)."""
        return unpack_blob_grads(self.descs, self.n_real, out[:self.w_len],
                                 out[self.w_len:])


DW_TILE = 64


def build_train_plan(fwd: BlobBuilder, bwd: BlobBuilder, act_rows: List[int],
                     inputs: List[Tuple[int, int]], tp: int,
                     dtype: torch.dtype) -> TrainPlan:
    """``act_rows``: rows of each stored activation slot; ``inputs``: per
    forward layer, the act slots of its first and second input (-1: none)."""
    fwd_t, bwd_t = fwd.build(dtype), bwd.build(dtype)
    dev = fwd_t[0].device
    act_off, off = [], 0
    for rows in act_rows:
        act_off.append(off)
        off += rows * tp
    act_stride = off
    gz_off, off = [], 0
    for d in fwd.descs:
        gz_off.append(off)
        off += d[4] * tp
    gz_stride = off
    w_len = fwd.w_len
    prods = []
    for i, ((o1, k1, o2, k2, n_pad, ob, _), (in1, in2)) in enumerate(
            zip(fwd.descs, inputs)):
        prods.append([act_off[in1], k1, gz_off[i], n_pad, o1, 0])
        if o2 >= 0:
            prods.append([act_off[in2], k2, gz_off[i], n_pad, o2, 0])
        prods.append([0, 1, gz_off[i], n_pad, w_len + ob, 1])
    work = [[j, k0, n0] for j, p in enumerate(prods)
            for k0 in range(0, p[1], DW_TILE) for n0 in range(0, p[3], DW_TILE)]
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    return TrainPlan(fwd_t, bwd_t, fwd.descs, fwd.n_real,
                     i32(act_off + gz_off), act_stride, gz_stride,
                     len(act_off), i32(prods).reshape(-1), i32(work).reshape(-1),
                     w_len, w_len + fwd.b_len)


def dw_chunks(n_tiles: int) -> int:
    """Split-K factor of the dW reduction: chunks of at least 64 tiles,
    at most 64 chunks."""
    return max(1, min(64, n_tiles // 64))


def unpack_blob_grads(descs, n_real, dw: torch.Tensor, db: torch.Tensor):
    """Split float32 gradient blobs laid out like a weight blob (``dw``)
    and its bias blob (``db``) into one {"w", "b"} per layer, the two input
    blocks of a two-input layer stacked by rows."""
    out = []
    for (o1, k1, o2, k2, n_pad, ob, _), n in zip(descs, n_real):
        w = dw[o1:o1 + k1 * n_pad].reshape(k1, n_pad)[:, :n]
        if o2 >= 0:
            w = torch.cat([w, dw[o2:o2 + k2 * n_pad].reshape(k2, n_pad)[:, :n]])
        out.append({"w": w, "b": db[ob:ob + n]})
    return out


def trunk_into_blob(bb: BlobBuilder, trunk, skip_every: int, act: str,
                    head: Dict[str, torch.Tensor], head_act: str) -> None:
    for i, p in enumerate(trunk):
        if i == skip_every and i > 0:
            hid = trunk[i - 1]["w"].shape[1]
            bb.layer(p["w"][:hid], p["b"], act, w2=p["w"][hid:])
        else:
            bb.layer(p["w"], p["b"], act)
    bb.layer(head["w"], head["b"], head_act)
