"""What the deformation nets' backward tile on wgmma (``csrc/skip_bw.cuh``:
bf16 K3, ``deform_pair_vjp.cu:pair_bwd_wg_kernel``, with both nets, and
K14, ``skip_mlp.cu:skip_bwd_wg_kernel``, with one) and its dW
(``csrc/level_dw.cuh``) take from Python, on the CPU:

  (a) the tile's shared memory (sb::Layout, reckoned from the source's
      constants) fits its one block an SM, 1,024-byte aligned, with a ring
      of at least two stages, for the pair and each net, with and without
      the points' cotangent, on raw points and on a given encoding;
  (b) its two stage blobs (``skip_mlp.backward_stages``) unpack to each
      layer of the plan's forward blob and each transposed layer of its
      transposed blob, in the order the tile runs its products
      (``skip_mlp.backward_stage_order``: per net head^T, trunk L-1 .. 1,
      and with the points' cotangent the layer back to the encoding), zero
      past K and past the outputs; their bytes are the kernel's
      (sb::fwd_bytes, sb::bwd_bytes), the transposed layers chain as
      sb::takes asks, and a stage blob follows the blob it is built from;
  (c) the dW's work list (``field_mlp.dw_items``) covers every (k, n) of
      every weight product of the pair's and the nets' plans exactly once;
  (d) bsum's row (a tile's column sums of gz, db's only source) is laid
      out as the plan's bias blob: a layer's sums at its bias offset, which
      is its gz slot's offset over the 64-point tile, and the host's slot
      offsets are the device's.
"""
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from sahs_tpu_torch.config import Config
from sahs_tpu_torch.models import nerface
from sahs_tpu_torch.ops.kernels import deform_pair as k1
from sahs_tpu_torch.ops.kernels import skip_mlp as k13
from sahs_tpu_torch.ops.kernels.field_mlp import (DW_ROWS, TP_BF16, dw_items, stage_order,
                                                   swizzled)

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "sahs_tpu_torch", "csrc")
SM_SMEM, BLOCK_RESERVED, BLOCK_MAX = 233472, 1024, 232448
BF = torch.bfloat16


def _text(path):
    with open(os.path.join(CSRC, path)) as fp:
        return fp.read()


def _const(path, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _text(path)).group(1))


cdiv = lambda n, d: -(-n // d)
pad8 = lambda n: cdiv(n, 8) * 8


@pytest.fixture(scope="module")
def kinds():
    """kind -> (weights, heads, trunks): the flagship's folded pair (K3),
    its warp and hyper nets alone (K14), and both nets on an encoding
    (K14 pre-encoded)."""
    spec = nerface.ModelSpec.from_config(Config())
    model = nerface.NeRFaceModel.init(spec, seed=0, device="cpu")
    cond = torch.tensor((np.random.RandomState(1).randn(76 + 36) * 0.5).astype(np.float32))
    warp_g = nerface.build_pe_groups(spec)[0]
    pair = k1.prepare_pair(model.warp, model.hyper, cond, warp_g)
    nw, nh = len(pair.warp_trunk), len(pair.hyper_trunk)
    out = {"pair": (pair, [nw, nw + 1 + nh], [nw, nh])}
    for name, act in (("warp", "tanh"), ("hyper", "linear")):
        for enc, groups in (("", warp_g), (" pre-encoded", None)):
            w = k13.prepare_skip(getattr(model, name), cond, groups, act)
            out[name + enc] = (w, [len(w.trunk)], [len(w.trunk)])
    return out


KINDS = ["pair", "warp", "hyper", "warp pre-encoded", "hyper pre-encoded"]


def _plan(w, kind, gx):
    if kind == "pair":
        return k1.pair_train_plan(w, BF, gx)
    return k13.skip_train_plan(w, BF)


def _pe_dim(w):
    return (w.warp_trunk if hasattr(w, "warp_trunk") else w.trunk)[0]["w"].shape[0]


def _layout(plan, trunks, pe_dim, gx):
    """skip_bw.cuh's sb::Layout(a) (ring slots, bytes, per-warpgroup bytes)
    from the source's constants: per warpgroup the encoding [cdiv(pe_dim,
    64) blocks of 64 points x 128 bytes], Ha and Hb [the widest trunk's
    blocks each] and with gx gS [as many] and F (pad8(pe_dim) rows of TP +
    4 floats); the derivative bits (the longest trunk's layers x 2 words x
    128 threads), two sets of 4 warps' column sums of NC floats and the raw
    points [64][3], padded to 1,024 bytes; the biases; as many ring slots
    of NC rows x 128 bytes as fit, at most RING_MAX; the barriers; the
    alignment slack."""
    src = _text("skip_bw.cuh")
    for line in ("gs = (eb + 2 * hb) * wg::BLOCK;",
                 "f = gs + (to_pe ? hb * wg::BLOCK : 0);",
                 "mk = f + (to_pe ? (a.pe_dim + 7) / 8 * 8 * LDF * 4 : 0);",
                 "cs = mk + l_max(a) * 2 * wg::THREADS * 4;",
                 "xs = cs + 2 * 4 * wg::NC * 4;",
                 "per_wg = cdiv(xs + TP * 3 * 4, 1024) * 1024;",
                 "const int params = cdiv(a.b_len, 4) * 16;",
                 "const int fixed = WG * per_wg + params + 16 * RING_MAX + 1024;",
                 "bytes = bar + 16 * RING_MAX + 1024;",
                 "constexpr int LDF = TP + 4;"):
        assert line in src, line
    assert "constexpr int SLOT = NC * 128;" in _text("wgmma.cuh")
    wgs, ring_max, smem_max = (_const("skip_bw.cuh", n) for n in ("WG", "RING_MAX", "SMEM_MAX"))
    kb, nc, threads = (_const("wgmma.cuh", n) for n in ("KB", "NC", "THREADS"))
    hidden = [d[4] for i, d in enumerate(plan.descs) if d[6] == 1]   # the ReLU layers
    block = 64 * 128
    gs = (cdiv(pe_dim, kb) + 2 * cdiv(max(hidden), kb)) * block
    f = gs + (cdiv(max(hidden), kb) * block if gx else 0)
    mk = f + (pad8(pe_dim) * (64 + 4) * 4 if gx else 0)
    xs = mk + max(trunks) * 2 * threads * 4 + 2 * 4 * nc * 4
    per_wg = cdiv(xs + 64 * 3 * 4, 1024) * 1024
    b_len = plan.out_len - plan.w_len
    fixed = wgs * per_wg + cdiv(b_len, 4) * 16 + 16 * ring_max + 1024
    ring = min(ring_max, (smem_max - fixed) // (nc * 128))
    return ring, fixed + ring * nc * 128, per_wg


@pytest.mark.parametrize("gx", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_backward_tile_layout_fits_its_block(kinds, kind, gx):
    """The tile's block (two consumer warpgroups of a 64-point tile each,
    the stashes' unit, and a producer warp; one block an SM) and its shared
    memory within a block's 227 KB with a ring of at least two 16 KB
    stages, the warpgroups' regions on 1,024-byte boundaries (the 128-byte
    swizzle's atom), at the flagship's widths."""
    w, heads, trunks = kinds[kind]
    assert _const("skip_bw.cuh", "WG") == 2 and _const("wgmma.cuh", "ROWS") == TP_BF16
    src = _text("skip_bw.cuh")
    assert "constexpr int THREADS = WG * wg::THREADS + 32;" in src
    assert "kernel<<<(unsigned)(pairs < sms ? pairs : sms), THREADS, ly.bytes, stream>>>(a);" in src
    assert "Layout(a).ring < 2)" in src
    for cu, fn in (("deform_pair_vjp.cu", "pair_bwd_wg_kernel"),
                   ("skip_mlp.cu", "skip_bwd_wg_kernel")):
        assert re.search(rf"__launch_bounds__\(sb::THREADS, 1\)\n{fn}\(", _text(cu))
        assert "extern __shared__ __align__(1024) unsigned char sb_smem[];" in _text(cu)
    plan = _plan(w, kind, gx)
    ring, smem, per_wg = _layout(plan, trunks, _pe_dim(w), gx)
    assert ring >= 2 and smem % 16 == 0 and smem <= BLOCK_MAX
    assert smem + BLOCK_RESERVED <= SM_SMEM and per_wg % 1024 == 0
    want = {("pair", False): (7, 224960), ("pair", True): (3, 227008),
            ("warp", False): (7, 223392), ("warp", True): (3, 225440),
            ("hyper", False): (8, 205472), ("hyper", True): (6, 223904)}
    if kind in ("pair", "warp", "hyper"):
        assert (ring, smem) == want[(kind, gx)]


def _unpack(stages, order, blob):
    """Each stage of ``order`` (stage_order's tuples) read back from the
    swizzled, K-major ``stages`` and held against ``blob``'s (k, n) block,
    zero past K and past n; returns the elements read."""
    pos = 0
    for _, off, k, n, c0, rows, kb in order:
        perm = torch.from_numpy(swizzled(rows).ravel())
        got = stages[pos:pos + rows * 64].float()[perm].reshape(rows, 64).t()
        want = torch.zeros(64, rows)
        kr, nr = max(0, min(64, k - kb * 64)), max(0, min(rows, n - c0))
        block = blob[off:off + k * n].float().reshape(k, n)
        want[:kr, :nr] = block[kb * 64:kb * 64 + kr, c0:c0 + nr]
        assert torch.equal(got, want), (off, kb, c0)
        pos += rows * 64
    return pos


@pytest.mark.parametrize("gx", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_backward_weight_stages_unpack_to_each_layer(kinds, kind, gx):
    """The forward stages put back every layer of the plan's forward blob
    (as K1's and K13's tile reads them: a head one chunk of 8 rows); the
    transposed stages every transposed layer the tile runs, net by net
    (head^T, trunk L-1 .. 1 by their hidden rows, with gx the layer back to
    the encoding: layer 0's rows and the skip layer's pe rows, two inputs),
    each its one chunk of outputs rounded up to 64; the blobs' bytes are
    the kernel's count, and the layers chain as sb::takes asks."""
    w, heads, trunks = kinds[kind]
    plan = _plan(w, kind, gx)
    fwd, bwd = k13.backward_stages(w, plan, heads, trunks, gx)
    assert fwd.dtype == bwd.dtype == BF
    assert k13.backward_stages(w, plan, heads, trunks, gx)[1] is bwd
    order_f = stage_order(plan.descs, heads)
    order_b = k13.backward_stage_order(plan.descs_t, trunks, gx)
    assert _unpack(fwd, order_f, plan.fwd[0]) == fwd.numel()
    assert _unpack(bwd, order_b, plan.bwd[0]) == bwd.numel()
    # the tile's product order: per net head^T, trunk L-1 .. 1, the PE layer
    want, t0 = [], 0
    for net, L in enumerate(trunks):
        want += list(range(t0, t0 + L)) + ([sum(trunks) + net] if gx else [])
        t0 += L
    assert list(dict.fromkeys(q for q, *_ in order_b)) == want
    # sb::fwd_bytes, sb::bwd_bytes
    kb = lambda k: cdiv(k, 64)
    src = _text("skip_bw.cuh")
    assert "s += 128LL * fwd_rows(a, i) * stages(a.layer[i]);" in src
    assert "s += 128LL * rows64(d.n) * stages(d);" in src
    f_bytes = sum(128 * (d[4] if i in heads else cdiv(d[4], 64) * 64)
                  * (kb(d[1]) + (kb(d[3]) if d[2] >= 0 else 0))
                  for i, d in enumerate(plan.descs))
    d_t = plan.descs_t
    b_bytes = sum(128 * cdiv(d_t[q][4], 64) * 64
                  * (kb(d_t[q][1]) + (kb(d_t[q][3]) if d_t[q][2] >= 0 else 0)) for q in want)
    assert (2 * fwd.numel(), 2 * bwd.numel()) == (f_bytes, b_bytes)
    # the chain: head^T and trunk (L - q)^T give layer L - 1 - q's outputs
    first, t0 = 0, 0
    pe_dim = _pe_dim(w)
    for net, L in enumerate(trunks):
        for q in range(L):
            t = d_t[t0 + q]
            assert t[4] == plan.descs[first + L - 1 - q][4] and t[2] < 0
            assert t[1] <= (8 if q == 0 else 128)
        if gx:
            pe = d_t[sum(trunks) + net]
            assert pe[4] == pad8(pe_dim) and pe[2] >= 0
        first, t0 = first + L + 1, t0 + L


@pytest.mark.parametrize("kind", ["pair", "warp"])
def test_backward_stages_follow_the_blob_they_are_built_from(kinds, kind):
    """A zeroed 16-row slice of the transposed trunk[5]^T in a copy of the
    plan's transposed blob (as the card tests' faults put one in place) is
    zero in the transposed stages and nowhere else; the stages are built
    anew for it."""
    w, heads, trunks = kinds[kind]
    plan = _plan(w, kind, False)
    base = k13.backward_stages(w, plan, heads, trunks, False)[1]
    b = plan.bwd[0].clone()
    off, _, _, _, n = plan.descs_t[1][:5]
    b[off + 16 * n:off + 32 * n] = 0
    changed = k13.backward_stages(w, dataclasses.replace(plan, bwd=(b,) + plan.bwd[1:]),
                                  heads, trunks, False)[1]
    diff = (changed != base).nonzero().reshape(-1)
    assert 0 < diff.numel() <= 16 * n and bool((changed[diff] == 0).all())


@pytest.mark.parametrize("kind", KINDS[:3])
def test_dw_items_cover_every_product_of_the_plans_once(kinds, kind):
    """The dW's work list over the pair's and each net's plan: [product,
    k0, n0, rows] items of 128 k rows (two warpgroups' 64) by at most 128
    gz columns (rows a multiple of the gz TMA box's 8) cover every (k, n)
    of every weight product once; db's entries, the bias blob past the
    weights, are the tiles' column sums (bias_dw_kernel), none an item's."""
    w, _, _ = kinds[kind]
    plan = _plan(w, kind, False)
    prods = plan.prods.reshape(-1, 6).tolist()
    hits = np.zeros(plan.out_len, np.int64)
    for j, k0, n0, rows in dw_items(plan.descs):
        _, K, _, N, out_off, is_bias = prods[j]
        assert not is_bias and k0 % DW_ROWS == 0 and n0 % DW_ROWS == 0
        assert 0 <= k0 < K and 0 <= n0 < N and rows == min(DW_ROWS, N - n0)
        assert rows % _const("level_dw.cuh", "GBOX") == 0
        kr = min(DW_ROWS, K - k0)
        idx = out_off + (k0 + np.arange(kr))[:, None] * N + n0 + np.arange(rows)[None, :]
        np.add.at(hits, idx.reshape(-1), 1)
    hits[plan.w_len:] += 1
    assert (hits == 1).all()
    # the stash's unit is the tile's 64 points, as level_dw.cuh's TMA boxes
    assert plan.act_stride % TP_BF16 == 0 and plan.gz_stride % TP_BF16 == 0


@pytest.mark.parametrize("kind", KINDS[:3])
def test_column_sums_row_follows_the_bias_blob(kinds, kind):
    """bsum's row of a tile is laid out as the forward bias blob (b_len =
    gz_stride / 64 floats, level_dw.cuh's check): the tile writes a layer's
    column sums at its bias offset (sb::tile's ``bst + d.b``) and its gz at
    that offset x 64 in the gz stash, which is the plan's gz slot; the host
    table of activation slots (the kernel's parameters) is the device's."""
    w, _, _ = kinds[kind]
    plan = _plan(w, kind, False)
    b_len = plan.out_len - plan.w_len
    assert b_len * TP_BF16 == plan.gz_stride
    slots = plan.slots.tolist()
    assert plan.act_off == slots[:plan.n_act]
    for i, d in enumerate(plan.descs):
        assert slots[plan.n_act + i] == d[5] * TP_BF16
    for _, K, g_off, N, out_off, is_bias in plan.prods.reshape(-1, 6).tolist():
        if is_bias:
            assert out_off - plan.w_len == g_off // TP_BF16 and K == 1
    src = _text("skip_bw.cuh")
    assert "put_sums(cs, bst + fd.b, fd.n, t);" in src
    assert "stash_tile(dst, gzt + (long long)fd.b * TP, fd.n, t);" in src
    assert "a.b_len * (long long)TP != a.gz_stride" in src
