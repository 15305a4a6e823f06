"""The two-points-a-row experiment on the H100 (counterpart of
``tools/exp_pair2.py``): does a 64-wide layer chain lose its rate against
a 128-wide one?

  narrow  (X4): 6 x (64, 64) tanh layers on x[:, :64] of (P, 128) rows
  paired  (X5): 6 x (128, 128) tanh layers on (P / 2, 128) rows, two
                points a row (dense weights: block-diagonal ones are data)
  reshape (X6): X5 with its rows formed in the kernel as
                [x[2r, :64] | x[2r + 1, :64]] from the (P, 128) input;
                mode "reshape" and "strided" form the same rows

    python -m sahs_tpu_torch.tools.exp_pair2

``narrow_call``, ``paired_call`` and ``reshape_call`` keep the JAX tool's
signatures and return the kernel's output, bf16. They launch the CUDA
kernel (``csrc/exp_pair2.cu``, whose source note gives the bounds and
design) for CUDA tensors and count it in ``<wrapper>.launches``; for CPU
tensors they run the plain version beside them. P is the input's row
count.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..ops.kernels import _build
from ..utils.device import card_line, cuda_ms, resolve_device
from . import LAUNCHES, RUNS

P = 262144
L = 6          # layers
_ROWS, _PAIRED = 0, 1


def _chain_plain(h: torch.Tensor, ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """h <- bf16(tanh(h @ w)) over ``ws``, bf16 operands, float32 sums."""
    h = h.to(torch.bfloat16)
    for w in ws:
        h = torch.tanh(h.float() @ w.to(torch.bfloat16).float()).to(torch.bfloat16)
    return h


def narrow_plain(x: torch.Tensor, ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """X4's plain version: (P, 128) -> (P, 128), the chain on x[:, :64],
    the right half zero."""
    h = _chain_plain(x[:, :64], ws)
    return torch.cat([h, torch.zeros_like(h)], dim=-1)


def paired_plain(x2: torch.Tensor, ws2: Sequence[torch.Tensor]) -> torch.Tensor:
    """X5's plain version: (P / 2, 128) -> (P / 2, 128)."""
    return _chain_plain(x2, ws2)


def pair_rows(x: torch.Tensor) -> torch.Tensor:
    """[x[2r, :64] | x[2r + 1, :64]]: (P, 128) -> (P / 2, 128)."""
    return torch.cat([x[0::2, :64], x[1::2, :64]], dim=1)


def reshape_plain(x: torch.Tensor, ws2: Sequence[torch.Tensor],
                  mode: str) -> torch.Tensor:
    """X6's plain version: X5 on ``pair_rows(x)`` (either mode)."""
    return _chain_plain(pair_rows(x), ws2)


def _launch(what: str, x: torch.Tensor, ws: Sequence[torch.Tensor], mode: int,
            H: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel on x and ws in ``mode``; its R output rows into a new
    (R, 128) tensor, or into the first R rows of ``out`` (which may hold
    more)."""
    dev = x.device
    if (dev.type != "cuda" or x.dtype != torch.bfloat16 or x.dim() != 2
            or x.shape[1] != 128 or len(ws) != L
            or any(w.device != dev or w.dtype != torch.bfloat16
                   or tuple(w.shape) != (H, H) for w in ws)
            or (mode == _PAIRED and x.shape[0] % 2)):
        raise ValueError(f"{what} takes a (P, 128) bf16 input and {L} ({H}, "
                         f"{H}) bf16 weights on one CUDA device, got "
                         f"{tuple(x.shape)} {x.dtype} on {dev}, "
                         f"{[tuple(w.shape) for w in ws]}")
    R = x.shape[0] // 2 if mode == _PAIRED else x.shape[0]
    x = x.contiguous()
    w = torch.stack([w.contiguous() for w in ws]).contiguous()
    if out is None:
        out = torch.empty((R, 128), dtype=torch.bfloat16, device=dev)
    elif (out.device != dev or out.dtype != torch.bfloat16 or out.dim() != 2
          or out.shape[0] < R or out.shape[1] != 128 or not out.is_contiguous()):
        raise ValueError(f"{what}: out must be a contiguous ({R}+, 128) bf16 "
                         f"tensor on {dev}, got {tuple(out.shape)} {out.dtype}")
    fn = _build.function("exp_pair2", "sahs_exp_tanh_chain", "pliipp" + "ipip")
    rc = fn(_build.ptr(x), R, mode, H, _build.ptr(w), None, L,
            _build.ptr(out), 128, _build.stream_ptr(dev))
    _build.check(rc, what)
    return out


def narrow_call(x: torch.Tensor, ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """X4 wrapper: x (P, 128) bf16, ws 6 x (64, 64) bf16 -> (P, 128)."""
    if x.device.type == "cpu":
        return narrow_plain(x, ws)
    out = _launch("X4", x, ws, _ROWS, 64)
    narrow_call.launches += 1
    return out


narrow_call.launches = 0


def paired_call(x2: torch.Tensor, ws2: Sequence[torch.Tensor]) -> torch.Tensor:
    """X5 wrapper: x2 (P / 2, 128) bf16, ws2 6 x (128, 128) bf16 ->
    (P / 2, 128)."""
    if x2.device.type == "cpu":
        return paired_plain(x2, ws2)
    out = _launch("X5", x2, ws2, _ROWS, 128)
    paired_call.launches += 1
    return out


paired_call.launches = 0


def reshape_call(x: torch.Tensor, ws2: Sequence[torch.Tensor],
                 mode: str) -> torch.Tensor:
    """X6 wrapper: x (P, 128) bf16, ws2 6 x (128, 128) bf16 -> (P / 2, 128);
    any ``mode`` other than "reshape" is the strided one, as in the JAX
    tool, and both form the same rows."""
    if x.device.type == "cpu":
        return reshape_plain(x, ws2, mode)
    out = _launch("X6", x, ws2, _PAIRED, 128)
    reshape_call.launches += 1
    return out


reshape_call.launches = 0


def inputs(gen: torch.Generator, device, rows: int = P):
    """The JAX tool's inputs, drawn on ``device``: x (rows, 128) bf16 at
    0.1 of a standard normal, x2 its first rows / 2 rows, ws 6 x (64, 64)
    at 0.3 and ws2 their block-diagonal (128, 128) forms."""
    x = (torch.randn((rows, 128), generator=gen, device=device) * 0.1
         ).to(torch.bfloat16)
    ws = [(torch.randn((64, 64), generator=gen, device=device) * 0.3
           ).to(torch.bfloat16) for _ in range(L)]
    ws2 = [torch.block_diag(w, w) for w in ws]
    return x, x[:rows // 2], ws, ws2


def main(device=None) -> List[dict]:
    """Times the four variants at the JAX tool's size on the card; prints
    and returns one row each: ms per call (the minimum over 3 runs of 30
    launches, CUDA events) and TFLOP/s of the chain."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x, x2, ws, ws2 = inputs(gen, dev)
    print(f"card: {torch.cuda.get_device_name(dev)} | {card_line()}", flush=True)
    rows = []
    for name, fn, width in (
            ("narrow", lambda: narrow_call(x, ws), 64),
            ("paired", lambda: paired_call(x2, ws2), 128),
            ("reshape", lambda: reshape_call(x, ws2, "reshape"), 128),
            ("strided", lambda: reshape_call(x, ws2, "strided"), 128)):
        ms = cuda_ms(fn, LAUNCHES, RUNS)
        n_rows = P if width == 64 else P // 2
        tflops = 2 * n_rows * width * width * L / (ms * 1e-3) / 1e12
        print(f"{name:10s} {ms:7.3f} ms  ({P} pts, {L} layers) -> {tflops:.1f} TF/s",
              flush=True)
        rows.append({"case": name, "ms": ms, "tflops": tflops})
    return rows


if __name__ == "__main__":
    main()
