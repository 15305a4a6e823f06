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
                  dtype: torch.dtype) -> torch.Tensor:
    """Folded trunk on a (P, pe_dim) input. The skip layer's weight splits
    into [h | x] row blocks (field_mlp.py:278-298)."""
    h = act(mm(x, trunk[0]["w"], dtype) + trunk[0]["b"])
    for i in range(1, len(trunk)):
        w, b = trunk[i]["w"], trunk[i]["b"]
        if i == skip_every:
            hid = h.shape[1]
            h = act(mm(h, w[:hid], dtype) + mm(x, w[hid:], dtype) + b)
        else:
            h = act(mm(h, w, dtype) + b)
    return h


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
        return len(self.descs) - 1

    def build(self, dtype: torch.dtype):
        w = torch.cat(self.w_parts).to(dtype).contiguous()
        b = torch.cat(self.b_parts).contiguous()
        meta = torch.tensor(self.descs, dtype=torch.int32).reshape(-1)
        return w, b, meta.to(w.device)


def trunk_into_blob(bb: BlobBuilder, trunk, skip_every: int, act: str,
                    head: Dict[str, torch.Tensor], head_act: str) -> None:
    for i, p in enumerate(trunk):
        if i == skip_every and i > 0:
            hid = trunk[i - 1]["w"].shape[1]
            bb.layer(p["w"][:hid], p["b"], act, w2=p["w"][hid:])
        else:
            bb.layer(p["w"], p["b"], act)
    bb.layer(head["w"], head["b"], head_act)
