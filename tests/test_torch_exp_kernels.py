"""The tools' experiment kernels X1-X6 (sahs_tpu_torch/tools) against the
JAX tools they replace (tools/exp_gather.py, tools/exp_pair2.py), run in
Pallas interpret mode at P = 4096 rows: the tool module's P is patched, and
its ``pl.pallas_call`` is wrapped to run in interpret mode and to keep the
kernel's own output (the JAX ``run`` returns only its sum). The port's
wrappers run their plain versions on the CPU. Both sides get the same
inputs, drawn with numpy and rounded to bf16 the same way.

Gates: X2 and X3 (sums of the same values in another order) within 1e-6
L2-relative over the rows and on the scalar; X1's row sums within 1e-3
L2-relative and the worst row within 1e-2 of the largest (bf16 rounds
every layer's activation, and one rounding that lands the other way moves
the next layers); X4-X6 within 1e-3 L2-relative and 5e-2 absolute on
every entry (tanh in float32 before the bf16 rounding differs by an ulp
between the two sides now and then).
"""
import types

import numpy as np
import pytest

import jax.numpy as jnp
from jax.experimental import pallas as pl

import torch

from tools import exp_gather as jgather
from tools import exp_pair2 as jpair2

from sahs_tpu_torch.tools import exp_gather as tgather
from sahs_tpu_torch.tools import exp_pair2 as tpair2

torch.set_num_threads(2)

P_TEST = 4096
EPS = 1e-3


@pytest.fixture
def interpret(monkeypatch):
    """Patches both JAX tools to P_TEST rows and interpret mode; returns
    the list that receives each pallas_call's output."""
    outs = []

    def pallas_call(*a, **k):
        call = pl.pallas_call(*a, interpret=True, **k)

        def run(*args):
            out = call(*args)
            outs.append(np.asarray(jnp.asarray(out, jnp.float32)))
            return out
        return run

    proxy = types.SimpleNamespace(pallas_call=pallas_call, BlockSpec=pl.BlockSpec)
    for mod in (jgather, jpair2):
        monkeypatch.setattr(mod, "P", P_TEST)
        monkeypatch.setattr(mod, "pl", proxy)
    return outs


def _n(x):
    return x.detach().float().numpy()


def l2_rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16), torch.tensor(a).to(torch.bfloat16)


@pytest.mark.parametrize("n_layers,H", tgather.CHAIN_CASES)
def test_chain_matches_jax_tool(interpret, n_layers, H):
    """X1: the per-row sums and their total."""
    rng = np.random.RandomState(H + n_layers)
    xj, xt = _bf16(rng.randn(P_TEST, H).astype(np.float32))
    wj, wt = _bf16((rng.randn(H, H) * 0.05).astype(np.float32))
    s_j = float(jgather.make_chain(n_layers, H)(xj, wj, jnp.float32(EPS)))
    run = tgather.make_chain(n_layers, H)
    rows_t = _n(run.rows(xt, wt, torch.tensor(EPS)))
    s_t = float(run(xt, wt, torch.tensor(EPS)))
    rows_j = interpret[-1]
    assert rows_t.shape == rows_j.shape == (P_TEST, 1)
    assert l2_rel(rows_t, rows_j) <= 1e-3
    assert np.abs(rows_t - rows_j).max() <= 1e-2 * np.abs(rows_j).max()
    assert abs(s_t - s_j) <= 1e-3 * abs(s_j)


@pytest.mark.parametrize("L,dt,n_gathers", tgather.DG_CASES)
def test_dg_matches_jax_tool(interpret, L, dt, n_gathers):
    """X2: the per-row sums of the in-tile gathers and their total."""
    rng = np.random.RandomState(L + n_gathers)
    x = rng.randn(P_TEST, L).astype(np.float32)
    idx = rng.randint(0, jgather.TILE, (P_TEST, L)).astype(np.int32)
    if dt == "bfloat16":
        xj, xt = _bf16(x)
    else:
        xj, xt = jnp.asarray(x), torch.tensor(x)
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    s_j = float(jgather.make_dg(L, jdt, n_gathers)(xj, jnp.asarray(idx),
                                                   jnp.float32(EPS)))
    run = tgather.make_dg(L, dt, n_gathers)
    rows_t = _n(run.rows(xt, torch.tensor(idx), torch.tensor(EPS)))
    s_t = float(run(xt, torch.tensor(idx), torch.tensor(EPS)))
    rows_j = interpret[-1]
    assert rows_t.shape == rows_j.shape == (P_TEST, 1)
    assert l2_rel(rows_t, rows_j) <= 1e-6
    assert abs(s_t - s_j) <= 1e-6 * np.abs(rows_j).sum()


@pytest.mark.parametrize("N,L,dt", tgather.CHUNK_CASES)
def test_chunk_matches_jax_tool(interpret, N, L, dt):
    """X3: the per-row sums of the table gather and their total, with some
    indices outside [0, N), which add nothing."""
    rng = np.random.RandomState(L)
    tab = rng.randn(N // jgather.TILE, jgather.TILE, L).astype(np.float32)
    idx = rng.randint(0, N, (P_TEST, 1)).repeat(L, 1).astype(np.int32)
    idx[::97] = N + 5
    idx[1::101] = -3
    if dt == "bfloat16":
        tj, tt = _bf16(tab)
    else:
        tj, tt = jnp.asarray(tab), torch.tensor(tab)
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    s_j = float(jgather.make_chunk(N, L, jdt)(tj, jnp.asarray(idx),
                                              jnp.float32(EPS)))
    run = tgather.make_chunk(N, L, dt)
    rows_t = _n(run.rows(tt, torch.tensor(idx), torch.tensor(EPS)))
    s_t = float(run(tt, torch.tensor(idx), torch.tensor(EPS)))
    rows_j = interpret[-1]
    assert rows_t.shape == rows_j.shape == (P_TEST, 1)
    assert not rows_j[::97].any() and not rows_t[::97].any()
    assert l2_rel(rows_t, rows_j) <= 1e-6
    assert abs(s_t - s_j) <= 1e-6 * np.abs(rows_j).sum()


def _pair2_inputs():
    rng = np.random.RandomState(0)
    x = (rng.randn(P_TEST, 128) * 0.1).astype(np.float32)
    ws = [(rng.randn(64, 64) * 0.3).astype(np.float32) for _ in range(jpair2.L)]
    xj, xt = _bf16(x)
    wsj, wst = zip(*[_bf16(w) for w in ws])
    ws2j = [jnp.zeros((128, 128), jnp.bfloat16).at[:64, :64].set(w).at[64:, 64:].set(w)
            for w in wsj]
    ws2t = [torch.block_diag(w, w) for w in wst]
    return xj, xt, list(wsj), list(wst), ws2j, ws2t


@pytest.mark.parametrize("variant", ["narrow", "paired", "reshape", "strided"])
def test_pair2_matches_jax_tool(interpret, variant):
    """X4 (narrow), X5 (paired) and X6 (reshape, strided): the chain's
    output, entry by entry."""
    xj, xt, wsj, wst, ws2j, ws2t = _pair2_inputs()
    if variant == "narrow":
        out_j, out_t = jpair2.narrow_call(xj, wsj), tpair2.narrow_call(xt, wst)
    elif variant == "paired":
        half = P_TEST // 2
        out_j = jpair2.paired_call(xj[:half], ws2j)
        out_t = tpair2.paired_call(xt[:half], ws2t)
    else:
        out_j = jpair2.reshape_call(xj, ws2j, variant)
        out_t = tpair2.reshape_call(xt, ws2t, variant)
    a, b = _n(out_t), np.asarray(jnp.asarray(out_j, jnp.float32))
    assert a.shape == b.shape
    assert l2_rel(a, b) <= 1e-3
    assert np.abs(a - b).max() <= 5e-2
    if variant == "narrow":
        assert not a[:, 64:].any()


def test_reshape_modes_form_the_same_rows():
    """X6's two modes give the same output; its rows are X5's on the
    paired rows [x[2r, :64] | x[2r + 1, :64]]."""
    _, xt, _, _, _, ws2t = _pair2_inputs()
    a = tpair2.reshape_call(xt, ws2t, "reshape")
    assert torch.equal(a, tpair2.reshape_call(xt, ws2t, "strided"))
    assert torch.equal(a, tpair2.paired_call(tpair2.pair_rows(xt), ws2t))
