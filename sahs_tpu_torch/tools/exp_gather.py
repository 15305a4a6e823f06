"""The gather experiments on the H100 (counterpart of ``tools/exp_gather.py``).

1. chain (X1): a bare chain of (H, H) bf16 layer products with ReLU on
   the tensor cores (wgmma, csrc/wgmma.cuh): the rate the trunk's layer
   product reaches at its shapes with nothing else in the kernel.
2. dg (X2): n gathers within each 1024-row tile, summed: the cost of an
   in-tile gather (from a TMA-filled ring of shared-memory stages on this
   card).
3. chunk (X3): out[r] = sum_c tab[idx[r, c], c] from a (32768, L) table:
   the cost of a gather from an L2-resident table, as K5 and K2 gather
   their corner rows.
4. xla_gather: the same kind of table gather as one PyTorch indexing op,
   for reference (plain PyTorch, not a kernel).

    python -m sahs_tpu_torch.tools.exp_gather [chain dg chunk xla_gather]

``make_chain``, ``make_dg`` and ``make_chunk`` keep the JAX tool's
signatures: each returns ``run(x, w | idx, eps)``, the sum of the kernel's
per-row output with ``eps`` added to the input in the input's dtype, and
``run.rows``, that per-row output (P, 1) float32. The kernels' wrappers
(``chain_rows``, ``dg_rows``, ``chunk_rows``) launch the CUDA kernel
(``csrc/exp_gather.cu``, whose source note gives each bound and design)
for CUDA tensors and count it in ``<wrapper>.launches``; for CPU tensors
they run the plain version beside them. P is the input's row count.
"""
from __future__ import annotations

import sys
from typing import List, Optional

import torch

from ..ops.kernels import _build
from ..ops.kernels.field_mlp import torch_dtype
from ..utils.device import card_line, cuda_ms, resolve_device
from . import LAUNCHES, RUNS

P = 262144
TILE = 1024

CHAIN_CASES = ((8, 256), (16, 256), (8, 512))                # (n_layers, H)
DG_CASES = ((128, "float32", 1), (128, "float32", 8),
            (128, "bfloat16", 8), (256, "float32", 8))       # (L, dtype, n)
CHUNK_CASES = ((32768, 128, "float32"), (32768, 128, "bfloat16"),
               (32768, 256, "bfloat16"))                     # (N, L, dtype)
XLA_GATHER_CASES = ((35937, 256, "bfloat16"), (35937, 256, "float32"))


def _plus(x: torch.Tensor, eps) -> torch.Tensor:
    """x + eps, eps rounded to x's dtype first (the JAX tool's
    ``x + eps.astype(x.dtype)``)."""
    return x + torch.as_tensor(eps, device=x.device).to(x.dtype)


def _cuda(what: str, *tensors) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: tensors must all be on one CUDA device")


# ---------------------------------------------------------------------------
# X1: the chain
# ---------------------------------------------------------------------------

def chain_plain(x: torch.Tensor, w: torch.Tensor, n_layers: int) -> torch.Tensor:
    """X1's plain version: h <- bf16(relu(h @ w)) ``n_layers`` times, bf16
    operands with float32 sums; the float32 row sums (P, 1)."""
    h = x.to(torch.bfloat16)
    wf = w.to(torch.bfloat16).float()
    for _ in range(n_layers):
        h = torch.relu(h.float() @ wf).to(torch.bfloat16)
    return h.float().sum(dim=-1, keepdim=True)


def chain_rows(x: torch.Tensor, w: torch.Tensor, n_layers: int) -> torch.Tensor:
    """X1 wrapper: x (P, H) bf16, w (H, H) bf16, H 256 or 512 (the trunk's
    widths, CHAIN_CASES), n_layers >= 1 -> (P, 1) float32."""
    if x.device.type == "cpu":
        return chain_plain(x, w, n_layers)
    _cuda("X1", x, w)
    Pn, H = x.shape
    if (x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16
            or tuple(w.shape) != (H, H) or H not in (256, 512) or n_layers < 1):
        raise ValueError(f"X1 takes (P, H) and (H, H) bf16 with H 256 or 512 "
                         f"and at least one layer, got {tuple(x.shape)} "
                         f"{x.dtype}, {tuple(w.shape)} {w.dtype}, {n_layers}")
    out = torch.empty((Pn, 1), dtype=torch.float32, device=x.device)
    _chain_launch(x.contiguous(), w.contiguous(), n_layers, out)
    chain_rows.launches += 1
    return out


def _chain_launch(x: torch.Tensor, w: torch.Tensor, n_layers: int,
                  out: torch.Tensor) -> None:
    """X1's kernel on checked, contiguous x and w, its P row sums into the
    first P floats of ``out`` (which may be longer)."""
    if (out.device != x.device or out.dtype != torch.float32
            or out.numel() < x.shape[0] or not out.is_contiguous()):
        raise ValueError(f"X1: out must be a contiguous float32 tensor of at "
                         f"least {x.shape[0]} values on {x.device}, got "
                         f"{tuple(out.shape)} {out.dtype}")
    fn = _build.function("exp_gather", "sahs_exp_chain", "plippip" + "p")
    rc = fn(_build.ptr(x), x.shape[0], x.shape[1], _build.ptr(w), None,
            n_layers, _build.ptr(out), _build.stream_ptr(x.device))
    _build.check(rc, "chain_rows")


chain_rows.launches = 0


def make_chain(n_layers: int, H: int):
    """X1 at (n_layers, H): run(x, w, eps) -> the scalar sum."""
    def rows(x, w, eps):
        return chain_rows(_plus(x, eps), w, n_layers)

    def run(x, w, eps):
        return torch.sum(rows(x, w, eps))
    run.rows = rows
    return run


# ---------------------------------------------------------------------------
# X2: gathers within a tile
# ---------------------------------------------------------------------------

def dg_plain(x: torch.Tensor, idx: torch.Tensor, n_gathers: int) -> torch.Tensor:
    """X2's plain version: within each 1024-row tile of x (P, L),
    ``n_gathers`` gathers g[r, c] = x[idx[r, c] mod 1024, c] summed in
    float32, idx <- idx + 7 after each; the row sums (P, 1)."""
    Pn, L = x.shape
    h = x.reshape(Pn // TILE, TILE, L)
    i = idx.reshape(Pn // TILE, TILE, L).long() % TILE
    acc = torch.zeros(h.shape, dtype=torch.float32, device=x.device)
    for _ in range(n_gathers):
        acc = acc + torch.gather(h, 1, i).float()
        i = (i + 7) % TILE
    return acc.sum(dim=-1).reshape(Pn, 1)


def dg_rows(x: torch.Tensor, idx: torch.Tensor, n_gathers: int) -> torch.Tensor:
    """X2 wrapper: x (P, L) float32 or bf16, idx (P, L) int32 in [0, 1024),
    P a multiple of 1024, L of a stage's 64 bytes of x (16 float32 or 32
    bf16 columns) -> (P, 1) float32."""
    if x.device.type == "cpu":
        return dg_plain(x, idx, n_gathers)
    _cuda("X2", x, idx)
    Pn, L = x.shape
    cols = 64 // x.element_size()
    if (x.dtype not in (torch.float32, torch.bfloat16) or idx.shape != x.shape
            or Pn % TILE or L % cols):
        raise ValueError(f"X2 takes (P, L) float32 or bf16 with P a multiple "
                         f"of {TILE} and L of {cols} and an idx of its shape, got "
                         f"{tuple(x.shape)} {x.dtype}, {tuple(idx.shape)}")
    # the kernel reads x through TMA and idx in 8-byte pairs, from aligned rows
    x, idx = (t if t.data_ptr() % 16 == 0 else t.clone()
              for t in (x.contiguous(), idx.to(torch.int32).contiguous()))
    out = torch.empty((Pn, 1), dtype=torch.float32, device=x.device)
    fn = _build.function("exp_gather", "sahs_exp_dg", "pplii" + "ip" + "p")
    rc = fn(_build.ptr(x), _build.ptr(idx), Pn, L, n_gathers,
            int(x.dtype == torch.bfloat16), _build.ptr(out),
            _build.stream_ptr(x.device))
    _build.check(rc, "dg_rows")
    dg_rows.launches += 1
    return out


dg_rows.launches = 0


def make_dg(L: int, dt, n_gathers: int):
    """X2 at (L, dtype, n_gathers); the dtype is the input's, as in the
    JAX tool: run(x, idx, eps) -> the scalar sum."""
    def rows(x, idx, eps):
        return dg_rows(_plus(x, eps), idx, n_gathers)

    def run(x, idx, eps):
        return torch.sum(rows(x, idx, eps))
    run.rows = rows
    return run


# ---------------------------------------------------------------------------
# X3: the table gather
# ---------------------------------------------------------------------------

def chunk_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """X3's plain version: tab (N / 1024, 1024, L), idx (P, L) -> out[r] =
    sum_c tab[idx[r, c], c] in float32, an idx outside [0, N) adding 0;
    (P, 1)."""
    L = tab.shape[-1]
    flat = tab.reshape(-1, L)
    N = flat.shape[0]
    i = idx.long()
    ok = (i >= 0) & (i < N)
    vals = torch.gather(flat, 0, i.clamp(0, N - 1)).float()
    return torch.where(ok, vals, torch.zeros_like(vals)).sum(dim=-1, keepdim=True)


def chunk_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """X3 wrapper: tab (N / 1024, 1024, L) float32 or bf16, idx (P, L)
    int32 -> (P, 1) float32."""
    if tab.device.type == "cpu":
        return chunk_plain(tab, idx)
    _cuda("X3", tab, idx)
    L = tab.shape[-1]
    if (tab.dtype not in (torch.float32, torch.bfloat16) or idx.dim() != 2
            or idx.shape[1] != L):
        raise ValueError(f"X3 takes a (N / 1024, 1024, L) float32 or bf16 "
                         f"table and a (P, L) idx, got {tuple(tab.shape)} "
                         f"{tab.dtype}, {tuple(idx.shape)}")
    flat = tab.reshape(-1, L).contiguous()
    idx = idx.to(torch.int32).contiguous()
    Pn = idx.shape[0]
    out = torch.empty((Pn, 1), dtype=torch.float32, device=tab.device)
    fn = _build.function("exp_gather", "sahs_exp_chunk", "plpli" + "ip" + "p")
    rc = fn(_build.ptr(flat), flat.shape[0], _build.ptr(idx), Pn, L,
            int(tab.dtype == torch.bfloat16), _build.ptr(out),
            _build.stream_ptr(tab.device))
    _build.check(rc, "chunk_rows")
    chunk_rows.launches += 1
    return out


chunk_rows.launches = 0


def make_chunk(N: int, L: int, dt):
    """X3 over a (N, L) table of dtype ``dt`` (the table's own):
    run(tab, idx, eps) -> the scalar sum."""
    def rows(tab, idx, eps):
        return chunk_rows(_plus(tab, eps), idx)

    def run(tab, idx, eps):
        return torch.sum(rows(tab, idx, eps))
    run.rows = rows
    return run


def xla_gather(tab: torch.Tensor, idx: torch.Tensor, eps) -> torch.Tensor:
    """The JAX tool's reference row gather as one PyTorch indexing op:
    sum(tab[idx]) in float32 (plain PyTorch, not a kernel)."""
    return torch.sum(_plus(tab, eps)[idx.long()].float())


# ---------------------------------------------------------------------------
# Inputs and the experiments
# ---------------------------------------------------------------------------

def chain_inputs(H: int, gen: torch.Generator, device, rows: int = P):
    """x (rows, H) and w (H, H) bf16, standard normal and 0.05 of it."""
    x = torch.randn((rows, H), generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((H, H), generator=gen, device=device) * 0.05).to(torch.bfloat16)
    return x, w


def dg_inputs(L: int, dt: str, gen: torch.Generator, device, rows: int = P):
    """x (rows, L) standard normal in ``dt``, idx (rows, L) in [0, 1024)."""
    x = torch.randn((rows, L), generator=gen, device=device).to(torch_dtype(dt))
    idx = torch.randint(0, TILE, (rows, L), generator=gen, device=device,
                        dtype=torch.int32)
    return x, idx


def chunk_inputs(N: int, L: int, dt: str, gen: torch.Generator, device,
                 rows: int = P):
    """tab (N / 1024, 1024, L) standard normal in ``dt``, idx (rows, L): one
    row of [0, N) a point, the same in every column."""
    tab = torch.randn((N // TILE, TILE, L), generator=gen,
                      device=device).to(torch_dtype(dt))
    idx = torch.randint(0, N, (rows, 1), generator=gen, device=device,
                        dtype=torch.int32).repeat(1, L)
    return tab, idx


def main(argv: Optional[List[str]] = None, device=None) -> List[dict]:
    """Runs the experiments named in ``argv`` (all by default) at the JAX
    tool's sizes on the card; prints and returns one row per case: ms per
    call (the minimum over 3 runs of 30 launches, CUDA events) and, for the
    chains, TFLOP/s."""
    exps = list(argv or []) or ["chain", "dg", "chunk", "xla_gather"]
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    eps = torch.zeros((), device=dev)
    print(f"card: {torch.cuda.get_device_name(dev)} | {card_line()}", flush=True)
    rows = []

    def timed(name, fn, *args, flops=None):
        ms = cuda_ms(lambda: fn(*args, eps), LAUNCHES, RUNS)
        row = {"case": name, "ms": ms}
        line = f"{name:28s} {ms:7.3f} ms"
        if flops:
            row["tflops"] = flops / (ms * 1e-3) / 1e12
            line += f"  -> {row['tflops']:.1f} TF/s"
        print(line, flush=True)
        rows.append(row)

    if "chain" in exps:
        for n_layers, H in CHAIN_CASES:
            x, w = chain_inputs(H, gen, dev)
            timed(f"chain {n_layers}x{H}", make_chain(n_layers, H), x, w,
                  flops=2 * P * H * H * n_layers)
    if "dg" in exps:
        for L, dt, ng in DG_CASES:
            x, idx = dg_inputs(L, dt, gen, dev)
            timed(f"dg L={L} x{ng} {dt}", make_dg(L, dt, ng), x, idx)
    if "chunk" in exps:
        for N, L, dt in CHUNK_CASES:
            tab, idx = chunk_inputs(N, L, dt, gen, dev)
            timed(f"chunk N={N} L={L} {dt}", make_chunk(N, L, dt), tab, idx)
    if "xla_gather" in exps:
        for N, L, dt in XLA_GATHER_CASES:
            tab = torch.randn((N, L), generator=gen, device=dev).to(torch_dtype(dt))
            idx = torch.randint(0, N, (P,), generator=gen, device=dev)
            timed(f"xla_gather N={N} L={L} {dt}", xla_gather, tab, idx)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
