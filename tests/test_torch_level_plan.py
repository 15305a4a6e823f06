"""What the backward kernels take from Python: the train plans of a NeRF
level (``csrc/level_train.cu``: K2, K6, K8, K12), of the deformation pair
(``csrc/deform_pair_vjp.cu``: K3) and of one deformation net, the warp
field or the hyper sheet (``csrc/skip_mlp.cu``: K14), each built at the
tile size of its compute dtype (64 points in bf16, the tensor-core tiles
on ``csrc/wgmma.cuh``; 32 in float32, the SIMT kernels), on the CPU:

  (a) the activation and gz slots tile each stash block without overlap;
  (b) each slot starts where the tensor-core loads want it: a stash row is
      a tile's points, so every slot and row starts on a 16-byte boundary
      (and in bf16 on a 128-byte row);
  (c) every (k, n) of every dW product, bias rows included, falls in
      exactly one work item of the split-K reduction;
  (d) the tile sizes agree with the CUDA sources, in both dtypes;
  (e) the bf16 forward tile on wgmma (level_train.cu fw::, K5's field,
      K7, K11 and launch 1 of K2/K6/K8/K12): its 64-point tiles, one
      block an SM, and its shared memory (the weight ring's stages, each
      warpgroup's A tiles and hidden tiles) within a block's 227 KB at the
      flagship's widths, warp-only and grid-free, from the constants of
      the CUDA source; its weight stages (nerf_level.wgmma_blob) unpack
      to each layer's (k, n) weights, with zero K and N padding, in the
      order the tile runs its products, for every form of the level; the
      deformation nets' forward tile on wgmma (skip_wg.cuh: bf16 K1 and
      K13) likewise: its shared memory fits its one block an SM with a
      ring of at least two stages, and its weight stages
      (skip_mlp.tile_stages) unpack to each layer of the pair's and of
      each net's blob, raw and pre-encoded; K5's compositing holds a ray
      of the largest sample count the level kernels take;
  (f) the kernels' C functions are looked up and typed once.
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
from sahs_tpu_torch.ops.kernels import level_train as k2
from sahs_tpu_torch.ops.kernels import nerf_level as k5
from sahs_tpu_torch.ops.kernels import skip_mlp as k13
from sahs_tpu_torch.ops.kernels.field_mlp import (DW_TILE, WG_KB, WG_NC, stage_order,
                                                   swizzled)

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "sahs_tpu_torch", "csrc")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _model(grid: bool):
    cfg = Config()
    cfg.models.coarse.use_spatial_embeddings = grid
    spec = nerface.ModelSpec.from_config(cfg)
    return nerface.NeRFaceModel.init(spec, seed=0, device="cpu")


@pytest.fixture(scope="module")
def models():
    return {"grid": _model(True), "grid_free": _model(False)}


def _level(model):
    rng = np.random.RandomState(0)
    cond = torch.tensor(rng.randn(36).astype(np.float32))
    _, pts_g, dir_g = nerface.build_pe_groups(model.spec)
    return k5.prepare_level(model.coarse, cond, pts_g, dir_g)


def _slots(plan):
    slots = plan.slots.tolist()
    act = slots[:plan.n_act]
    gz = slots[plan.n_act:]
    return act, gz


def _act_rows(lvl):
    """Rows of each activation slot of a level's plan, from its weights:
    [pe, h_0 .. h_{L-1}, feat, [pe(dir) | se], d0-d3, s0-s3]."""
    L, hid = len(lvl.trunk), lvl.trunk[0]["w"].shape[1]
    din = lvl.dir0_dir.shape[0] + lvl.dir0_se.shape[0]
    B = lvl.dir0_b.shape[0]
    return [lvl.trunk[0]["w"].shape[0]] + [hid] * (L + 1) + [din] + [B] * 8


def _trunk_rows(trunk):
    """Rows of a deformation net's activation slots [h_0 .. h_{L-1}]."""
    return [p["w"].shape[1] for p in trunk]


def _deform(models):
    """The grid model's folded deformation pair and its two nets alone."""
    model = models["grid"]
    rng = np.random.RandomState(1)
    cond = torch.tensor((rng.randn(76 + 36) * 0.5).astype(np.float32))
    warp_g = nerface.build_pe_groups(model.spec)[0]
    return {"pair": k1.prepare_pair(model.warp, model.hyper, cond, warp_g),
            "skip_warp": k13.prepare_skip(model.warp, cond, warp_g, "tanh"),
            "skip_hyper": k13.prepare_skip(model.hyper, cond, warp_g, "linear")}


def _plan_rows(models, kind, dtype):
    """(train plan, rows of each activation slot) of ``kind``: a level
    ("grid", "grid_free"), the pair ("pair": [pe, warp h_0 ..., hyper h_0
    ...]) or one net ("skip_warp", "skip_hyper": [pe, h_0 ...])."""
    dt = DTYPES[dtype]
    if kind in ("grid", "grid_free"):
        lvl = _level(models[kind])
        return k2.level_train_plan(lvl, dt), _act_rows(lvl)
    w = _deform(models)[kind]
    if kind == "pair":
        return k1.pair_train_plan(w, dt), ([w.warp_trunk[0]["w"].shape[0]]
                                           + _trunk_rows(w.warp_trunk)
                                           + _trunk_rows(w.hyper_trunk))
    return k13.skip_train_plan(w, dt), [w.trunk[0]["w"].shape[0]] + _trunk_rows(w.trunk)


KINDS = ("grid", "grid_free", "pair", "skip_warp", "skip_hyper")
CASES = [(k, d) for k in KINDS for d in DTYPES]


@pytest.mark.parametrize("kind,dtype", CASES)
def test_slots_tile_each_stash_block(models, kind, dtype):
    plan, act_rows = _plan_rows(models, kind, dtype)
    tp = k2.tile_points(DTYPES[dtype])
    act, gz = _slots(plan)
    for offs, stride, rows in (
            (act, plan.act_stride, act_rows),
            (gz, plan.gz_stride, [d[4] for d in plan.descs])):
        assert len(offs) == len(rows)
        assert offs[0] == 0
        ends = [o + r * tp for o, r in zip(offs, rows)]
        # consecutive, non-empty, and the last one ends the block
        assert all(r > 0 for r in rows)
        assert ends[:-1] == offs[1:]
        assert ends[-1] == stride
    # the activation slots hold the rows the products read
    for a_off, K, g_off, N, out_off, is_bias in plan.prods.reshape(-1, 6).tolist():
        if not is_bias:
            i = act.index(a_off)
            assert K <= act_rows[i]
        j = gz.index(g_off)
        assert N == plan.descs[j][4]


@pytest.mark.parametrize("kind,dtype", CASES)
def test_slots_start_where_the_tensor_core_loads_want(models, kind, dtype):
    plan = _plan_rows(models, kind, dtype)[0]
    tp = k2.tile_points(DTYPES[dtype])
    item = torch.empty((), dtype=DTYPES[dtype]).element_size()
    act, gz = _slots(plan)
    for off in act:
        assert off % tp == 0 and (off * item) % 16 == 0
    for off in gz:
        assert off % tp == 0 and (off * 4) % 16 == 0
    # a stash row is a tile's points: 128 bytes in bf16, the dW kernel's
    # 16-byte loads and ldmatrix rows
    assert (tp * item) % 16 == 0 and (tp * 4) % 16 == 0
    if dtype == "bfloat16":
        assert tp * item == 128
        assert (plan.act_stride * item) % 128 == 0 and (plan.gz_stride * 4) % 128 == 0
    # the weight blobs: every layer's rows start on 16 bytes
    for meta in (plan.fwd[2], plan.bwd[2]):
        for w1, k1_, w2, k2_, n, b, act_ in meta.reshape(-1, 7).tolist():
            assert n % 8 == 0 and (w1 * item) % 16 == 0 and (n * item) % 16 == 0
            assert w2 < 0 or (w2 * item) % 16 == 0


@pytest.mark.parametrize("kind,dtype", CASES)
def test_work_items_cover_every_product_once(models, kind, dtype):
    plan = _plan_rows(models, kind, dtype)[0]
    prods = plan.prods.reshape(-1, 6).tolist()
    hits = np.zeros(plan.out_len, np.int64)
    for j, k0, n0 in plan.work.reshape(-1, 3).tolist():
        _, K, _, N, out_off, _ = prods[j]
        assert 0 <= k0 < K and 0 <= n0 < N and k0 % DW_TILE == 0 and n0 % DW_TILE == 0
        kr, nr = min(DW_TILE, K - k0), min(DW_TILE, N - n0)
        idx = (out_off + (k0 + np.arange(kr))[:, None] * N
               + n0 + np.arange(nr)[None, :])
        np.add.at(hits, idx.reshape(-1), 1)
    # every weight and bias entry of every product, bias rows included
    want = np.zeros(plan.out_len, np.int64)
    for _, K, _, N, out_off, is_bias in prods:
        want[out_off:out_off + K * N] += 1
        assert not is_bias or K == 1
    assert (hits == want).all()
    assert (want == 1).all()
    assert sum(p[5] for p in prods) == len(plan.descs)


def _cu_const(path, name):
    with open(os.path.join(CSRC, path)) as fp:
        return int(re.search(rf"constexpr int {name} = (\d+);", fp.read()).group(1))


def test_tile_sizes_match_the_cuda_sources():
    """bf16: the 64-point tile of wgmma.cuh (a warpgroup's product rows),
    which K2/K6/K8/K12 (level_train.cu's TC_TP), K3 and K14 (skip_bw.cuh)
    take; float32: each SIMT kernel's own tile (K3's in pair_bwd.cuh)."""
    assert k2.tile_points(torch.bfloat16) == _cu_const("level_train.cu", "TC_TP") == 64
    assert "static_assert(TC_TP == wg::ROWS" in _cu_text("level_train.cu")
    assert k2.tile_points(torch.float32) == _cu_const("level_train.cu", "TP") == 32
    assert k2.tile_points(torch.float32) == _cu_const("pair_bwd.cuh", "PAIR_TP") == 32
    assert k2.tile_points(torch.float32) == _cu_const("skip_mlp.cu", "TP_BWD") == 32
    # float32 K3 keeps pair_bwd.cuh's SIMT tile; bf16 K3 and K14 run the
    # deformation nets' backward tile on wgmma (skip_bw.cuh) and the dW of
    # level_dw.cuh; K2's pair= form calls K3 after the level's backward, so
    # level_train.cu builds no pair tile of its own
    for src, inc in (("deform_pair_vjp.cu", "pair_bwd.cuh"), ("pair_bwd.cuh", "train.cuh"),
                     ("deform_pair_vjp.cu", "skip_bw.cuh"), ("skip_mlp.cu", "skip_bw.cuh"),
                     ("deform_pair_vjp.cu", "level_dw.cuh"), ("skip_mlp.cu", "level_dw.cuh"),
                     ("level_train.cu", "level_dw.cuh"), ("level_train.cu", "wgmma.cuh")):
        with open(os.path.join(CSRC, src)) as fp:
            assert f'#include "{inc}"' in fp.read()
    for inc in ("pair_bwd.cuh", "skip_bw.cuh"):
        assert f'#include "{inc}"' not in _cu_text("level_train.cu")
    for src, gone in (("deform_pair_vjp.cu", "pair_vjp_tc_kernel"),
                      ("skip_mlp.cu", "skip_vjp_tc_kernel")):
        assert f"{gone}<<<" not in _cu_text(src) and "launch_stash_dw(" not in _cu_text(src)
    assert "constexpr int TP = wg::ROWS;" in _cu_text("skip_bw.cuh")
    # the width step the K1 and K13 wrappers check in bf16: the forward
    # tile's (sk::takes)
    assert k13.TC_K_STEP == 32
    assert "(d.n % 32 || d.n > HMAX" in _cu_text("skip_wg.cuh")
    # bf16 K13 and K1: the deformation nets' tile on wgmma (skip_wg.cuh),
    # 64-point tiles (a warpgroup's product rows), launched from the blob's
    # layer table with one net (K13) or two (K1); no other forward is left
    assert _cu_const("wgmma.cuh", "ROWS") == k2.tile_points(torch.bfloat16)
    assert "constexpr int TP = wg::ROWS;" in _cu_text("skip_wg.cuh")
    for src, fn, nets in (("skip_mlp.cu", "skip_wg_kernel", "1, n_layers, 0"),
                          ("deform_pair.cu", "deform_pair_wg_kernel", "2, n_warp, n_hyper")):
        text = _cu_text(src)
        assert f'#include "skip_wg.cuh"' in text
        assert re.search(rf"__launch_bounds__\(sk::THREADS, 1\)\n{fn}\(", text)
        assert f"sk::args_of(reinterpret_cast<const int*>(descs), {nets});" in text
        assert f"return sk::launch({fn}, a, s);" in text
        assert "skip_trunk_tc" not in text
        assert "deform_pair_tc_kernel" not in text and "skip_fwd_tc_kernel" not in text
    assert "a.pe_dim = enc_dim > 0 ? enc_dim : 3 + 6 * n_freq;" in _cu_text("skip_mlp.cu")
    assert "a.pe_dim = 3 + 6 * n_freq;" in _cu_text("deform_pair.cu")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pair_and_skip_plans_keep_their_tiles(models, dtype):
    """K3's and K14's plans take their dtype's tile: 64 points in bf16, 32
    in float32."""
    tp = k2.tile_points(DTYPES[dtype])
    assert tp == {"bfloat16": 64, "float32": 32}[dtype]
    for kind in ("pair", "skip_warp", "skip_hyper"):
        plan = _plan_rows(models, kind, dtype)[0]
        act, gz = _slots(plan)
        assert plan.act_stride % tp == 0 and plan.gz_stride % tp == 0
        assert all(o % tp == 0 for o in act + gz)
        assert plan.gz_stride == tp * sum(d[4] for d in plan.descs)


def test_level_plans_differ_only_by_tile(models):
    """The bf16 plan is the float32 plan at twice the tile: the same
    products, layers and work list, every slot offset doubled."""
    _plans_differ_only_by_tile(models, "grid")


@pytest.mark.parametrize("kind", ["pair", "skip_warp", "skip_hyper"])
def test_pair_and_skip_plans_differ_only_by_tile(models, kind):
    _plans_differ_only_by_tile(models, kind)


def _plans_differ_only_by_tile(models, kind):
    p32 = _plan_rows(models, kind, "float32")[0]
    p64 = _plan_rows(models, kind, "bfloat16")[0]
    assert torch.equal(p64.slots, 2 * p32.slots)
    assert (p64.act_stride, p64.gz_stride) == (2 * p32.act_stride, 2 * p32.gz_stride)
    assert torch.equal(p64.work, p32.work)
    q32, q64 = p32.prods.reshape(-1, 6).clone(), p64.prods.reshape(-1, 6).clone()
    q32[:, [0, 2]] *= 2
    assert torch.equal(q32, q64)
    assert p64.descs == p32.descs and p64.out_len == p32.out_len


def _cu_text(path):
    with open(os.path.join(CSRC, path)) as fp:
        return fp.read()


# an H100 SM's shared memory for blocks (228 KB) and what the runtime
# reserves per block (1 KB); a block's dynamic shared memory is at most 227 KB
SM_SMEM, BLOCK_RESERVED, BLOCK_MAX = 233472, 1024, 232448


def _field_layout(kx, n_din, hidden, branch, n_trunk):
    """level_train.cu's fw::Layout(a) (ring slots, bytes), from the
    source's constants: per warpgroup x [max(kx, B) / 64 blocks], d [n_din
    / 64], two column-0-127 hidden regions and the columns from 128 on,
    blocks of 64 points x 128 bytes; the biases ((L + 1) H + 8 B + 32
    floats) and the L + 12 stash slots' offsets; then as many ring slots of
    NC rows x 128 bytes as fit, at most RING_MAX; the barriers; the
    alignment slack."""
    c = lambda n: _cu_const("level_train.cu", n)
    kb, nc = _cu_const("wgmma.cuh", "KB"), _cu_const("wgmma.cuh", "NC")
    ring_max, smem_max, wgs = c("RING_MAX"), c("SMEM_MAX"), c("WG")
    src = _cu_text("level_train.cu")
    assert "constexpr int SLOT = NC * 128;" in _cu_text("wgmma.cuh")
    assert "using wg::KB;" in src and "using wg::NC;" in src and "using wg::SLOT;" in src
    assert "per_wg = (xb + db + 2 * h0 + h1) * wg::BLOCK;" in src
    assert "return (a.L + 1) * a.H + 8 * a.B + 32;" in src
    assert "const int params = (bias_floats(a) + a.L + 12 + 3) / 4 * 16;" in src
    assert "const int fixed = WG * per_wg + params + 16 * RING_MAX + 1024;" in src
    assert "bytes = bar + 16 * RING_MAX + 1024;" in src
    assert "constexpr int BLOCK = 64 * 128;" in _cu_text("wgmma.cuh")
    cd = lambda n, d: -(-n // d)
    hb = cd(hidden, kb)
    h0 = min(hb, 2)
    per_wg = (max(cd(kx, kb), cd(branch, kb)) + max(cd(n_din, kb), 1) + 2 * h0
              + hb - h0) * 64 * 128
    params = ((n_trunk + 1) * hidden + 8 * branch + 32 + n_trunk + 12 + 3) // 4 * 16
    fixed = wgs * per_wg + params + 16 * ring_max + 1024
    ring = min(ring_max, (smem_max - fixed) // (nc * 128))
    return ring, fixed + ring * nc * 128


@pytest.mark.parametrize("kind", ["grid", "grid_free", "no_ambient"])
def test_field_kernel_layout_matches_the_cuda_source(models, kind):
    """The bf16 forward tile on wgmma (``level_train.cu:fw::tile``, run by
    ``field_tc_kernel`` for K5's field, K7 and K11 and by ``fwd_tc_kernel``
    for launch 1 of K2/K6/K8/K12): the Python side's bf16 tile is the
    tile's 64 points (one warpgroup's product rows), the block is two
    consumer warpgroups and a producer warp, one block an SM, and its
    shared memory (a ring of at least two weight stages, each warpgroup's
    A and hidden tiles) fits a block at the flagship's widths, warp-only
    and without the grid."""
    assert k2.tile_points(torch.bfloat16) == _cu_const("level_train.cu", "TC_TP") == 64
    assert _cu_const("wgmma.cuh", "ROWS") == 64
    assert _cu_const("level_train.cu", "WG") == 2
    src = _cu_text("level_train.cu")
    assert "constexpr int THREADS = WG * wg::THREADS + 32;" in src
    assert re.search(r"__launch_bounds__\(fw::THREADS, 1\) field_tc_kernel", src)
    assert re.search(r"__launch_bounds__\(fw::THREADS, 1\) fwd_tc_kernel", src)
    assert "fw::tile<false, PROMOTE>(a, fw_smem);" in src
    assert "fw::tile<true, FIELD_PROMOTE>(a, fw_smem);" in src
    assert (WG_KB, WG_NC) == (_cu_const("wgmma.cuh", "KB"), _cu_const("wgmma.cuh", "NC"))
    lvl = _level(_model_without_ambient() if kind == "no_ambient" else models[kind])
    kx = lvl.trunk[0]["w"].shape[0]
    n_din = lvl.dir0_dir.shape[0] + lvl.dir0_se.shape[0]
    hidden, branch = lvl.trunk[0]["w"].shape[1], lvl.dir0_b.shape[0]
    ring, smem = _field_layout(kx, n_din, hidden, branch, len(lvl.trunk))
    assert ring >= 2 and smem % 16 == 0 and smem <= BLOCK_MAX
    assert smem + BLOCK_RESERVED <= SM_SMEM
    assert (kx, n_din, hidden, branch) == {"grid": (81, 59, 256, 128),
                                           "grid_free": (81, 27, 256, 128),
                                           "no_ambient": (63, 59, 256, 128)}[kind]
    # every form at the flagship's widths: four 16 KB stages
    assert (ring, smem) == (4, 227632)


def _forms():
    """The folded levels of every form the forward tile takes: with the grid
    (the ray forms on the corner table or a per-point se, and K11's per-point
    field share its layers), without it, without the ambient coordinates,
    pre-encoded (K11's point and [pe(dir) | se] encodings given), and the
    ablation config's 4 x 256 trunk with 15 PE frequencies."""
    from sahs_tpu_torch.config import load_config
    rng = np.random.RandomState(0)
    out = {}
    for kind, model in (("grid", _model(True)), ("grid_free", _model(False)),
                        ("no_ambient", _model_without_ambient())):
        cond = torch.tensor(rng.randn(36).astype(np.float32))
        _, pts_g, dir_g = nerface.build_pe_groups(model.spec)
        out[kind] = k5.prepare_level(model.coarse, cond, pts_g, dir_g)
        if kind == "grid":
            out["pre_encoded"] = k5.prepare_level(model.coarse, cond, None, None)
    cfg = load_config(os.path.join(os.path.dirname(CSRC), "..", "configs", "expression",
                                   "person_1_ablation.yml"))
    spec = nerface.ModelSpec.from_config(cfg)
    model = nerface.NeRFaceModel.init(spec, seed=0, device="cpu")
    _, pts_g, dir_g = nerface.build_pe_groups(spec)
    out["ablation"] = k5.prepare_level(model.coarse, torch.tensor(
        rng.randn(76).astype(np.float32)), pts_g, dir_g)
    return out


FORMS = ("grid", "grid_free", "no_ambient", "pre_encoded", "ablation")


@pytest.fixture(scope="module")
def forms():
    return _forms()


def _tile_products(lvl):
    """fw::prod_of's products of one tile, from the level's widths: (layer,
    [k of each input], n, head)."""
    L, hid = len(lvl.trunk), lvl.trunk[0]["w"].shape[1]
    kx, B = lvl.trunk[0]["w"].shape[0], lvl.dir0_b.shape[0]
    kd = lvl.dir0_dir.shape[0] + lvl.dir0_se.shape[0]
    out = [(q, [kx] if q == 0 else [hid, kx] if q == lvl.skip else [hid], hid, False)
           for q in range(L)]
    out += [(L, [hid], hid, False), (L + 1, [hid], 8, True), (L + 2, [hid, kd], B, False)]
    out += [(L + 2 + k, [B], B, False) for k in (1, 2, 3)] + [(L + 6, [B], 8, True)]
    out += [(L + 7, [hid], B, False)] + [(L + 7 + k, [B], B, False) for k in (1, 2, 3)]
    return out + [(L + 11, [B], 16, True)]


@pytest.mark.parametrize("kind", FORMS)
def test_field_weight_stages_unpack_to_each_layer(forms, kind):
    """``nerf_level.wgmma_blob``, the weight stages the forward tile
    streams, read back on the CPU: stage by stage, in the order the tile
    runs its products (fw::prod_of: each layer's output chunks of at most
    128 columns, the heads one chunk of 8 or 16, then each input, then its
    64-k blocks), each stage rows (outputs) x 64 k in the 128-byte swizzle,
    K-major. Un-swizzled, the stages put back every layer's (k, n) weights
    of the bf16 forward blob, exactly, with zeros past K and past the
    layer's outputs; the blob's length is the kernel's fw::blob_bytes."""
    lvl = forms[kind]
    w, _, meta = k5.point_blob(lvl, torch.bfloat16)
    descs = meta.reshape(-1, 7).tolist()
    stages = k5.wgmma_blob(lvl, w)
    assert stages.dtype == torch.bfloat16 and k5.wgmma_blob(lvl, w) is stages
    L = len(lvl.trunk)
    prods = _tile_products(lvl)
    assert [(d[1], d[3]) for d in descs] == [(k[0], k[1] if len(k) > 1 else 0)
                                             for _, k, _, _ in prods]
    unswizzle = torch.from_numpy(swizzled(1).ravel())
    pos, n_stages = 0, 0
    for q, ks, n, head in prods:
        w1, _, w2, _, n_pad = descs[q][:5]
        assert (n_pad == n) if head else n_pad == -(-n // 8) * 8
        cols = -(-n // 64) * 64
        chunks = [(0, n)] if head else [(c0, min(128, cols - c0)) for c0 in range(0, cols, 128)]
        for c0, rows in chunks:
            for off, k in zip((w1, w2), ks):
                got = torch.zeros(-(-k // 64) * 64, rows)
                perm = torch.from_numpy(swizzled(rows).ravel())
                for kb in range(-(-k // 64)):
                    st = stages[pos:pos + rows * 64].float()
                    pos += rows * 64
                    n_stages += 1
                    got[kb * 64:kb * 64 + 64] = st[perm].reshape(rows, 64).t()
                want = torch.zeros_like(got)
                real = w[off:off + k * n_pad].float().reshape(k, n_pad)[:, c0:c0 + rows]
                want[:k, :real.shape[1]] = real
                assert torch.equal(got, want), (kind, q, c0, off)
    assert pos == stages.numel() and unswizzle.tolist() == list(range(64))
    assert n_stages == len(k5.wgmma_stages(descs, L))
    # the kernel's count, fw::blob_bytes: 128 bytes a row, per chunk the
    # 64-k blocks of every input
    kb = lambda k: -(-k // 64)
    assert 2 * stages.numel() == sum(
        128 * rows * sum(kb(k) for k in ks)
        for _, ks, n, head in prods
        for rows in ([n] if head else [min(128, -(-n // 64) * 64 - c0)
                                       for c0 in range(0, -(-n // 64) * 64, 128)]))
    if kind == "grid":
        assert 2 * stages.numel() == 1533952 and n_stages == 101


def test_field_weight_stages_follow_the_blob_they_are_built_from(forms):
    """The stages are built from the forward blob they are given (a test's
    altered copy, a train plan's), and built anew when that blob changes in
    place: a zeroed 16-row slice of trunk[1] in the blob is zero in its
    stages and nowhere else."""
    lvl = forms["grid"]
    w, _, meta = k5.point_blob(lvl, torch.bfloat16)
    base = k5.wgmma_blob(lvl, w)
    w1, _, _, _, n = meta.reshape(-1, 7)[1, :5].tolist()
    bad = w.clone()
    bad[w1 + 16 * n:w1 + 32 * n] = 0
    changed = k5.wgmma_blob(lvl, bad)
    assert changed is not base
    diff = (changed != base).nonzero().reshape(-1)
    assert 0 < diff.numel() <= 16 * n and bool((changed[diff] == 0).all())
    bad[w1 + 16 * n:w1 + 32 * n] = w[w1 + 16 * n:w1 + 32 * n]
    assert torch.equal(k5.wgmma_blob(lvl, bad), base)


def _model_without_ambient():
    cfg = Config()
    cfg.models.hyper.use_ambient = False
    spec = nerface.ModelSpec.from_config(cfg)
    return nerface.NeRFaceModel.init(spec, seed=0, device="cpu")


def _skip_layout(pe_dim, widths, b_len):
    """skip_wg.cuh's sk::Layout (ring slots, bytes) from the sources'
    constants: per warpgroup the encoding [pe_dim / 64 blocks], two hidden
    tiles [max width / 64 blocks each], blocks of 64 points x 128 bytes,
    then the raw points (f32 [64][3]) and two heads' outputs (f32 [64][8]),
    padded to 1,024 bytes; the biases (b_len floats); as many ring slots of
    NC rows x 128 bytes as fit, at most RING_MAX; the barriers; the
    alignment slack."""
    c = lambda n: _cu_const("skip_wg.cuh", n)
    kb, nc = _cu_const("wgmma.cuh", "KB"), _cu_const("wgmma.cuh", "NC")
    wgs, ring_max, smem_max, head = c("WG"), c("RING_MAX"), c("SMEM_MAX"), c("HEAD")
    src = _cu_text("skip_wg.cuh")
    assert "xs = (eb + 2 * hb) * wg::BLOCK;" in src
    assert "ys = xs + TP * 3 * 4;" in src
    assert "per_wg = cdiv(ys + 2 * TP * HEAD * 4, 1024) * 1024;" in src
    assert "const int params = cdiv(a.b_len, 4) * 16;" in src
    assert "const int fixed = WG * per_wg + params + 16 * RING_MAX + 1024;" in src
    assert "bytes = bar + 16 * RING_MAX + 1024;" in src
    assert "constexpr int SLOT = NC * 128;" in _cu_text("wgmma.cuh")
    cd = lambda n, d: -(-n // d)
    eb, hb = cd(pe_dim, kb), cd(max(widths), kb)
    xs = (eb + 2 * hb) * 64 * 128
    per_wg = cd(xs + 64 * 3 * 4 + 2 * 64 * head * 4, 1024) * 1024
    fixed = wgs * per_wg + cd(b_len, 4) * 16 + 16 * ring_max + 1024
    ring = min(ring_max, (smem_max - fixed) // (nc * 128))
    return ring, fixed + ring * nc * 128


def _skip_tile_fits(pe_dim, widths, b_len):
    """The block the deformation nets' tile launches (two consumer
    warpgroups and a producer warp, one block an SM, from the sources) and
    its shared memory at these widths: a ring of at least two weight
    stages, within a block's 227 KB. Returns (ring slots, bytes)."""
    assert _cu_const("skip_wg.cuh", "WG") == 2
    assert "constexpr int THREADS = WG * wg::THREADS + 32;" in _cu_text("skip_wg.cuh")
    assert _cu_const("wgmma.cuh", "THREADS") == 128
    assert "kernel<<<(unsigned)(pairs < sms ? pairs : sms), THREADS, ly.bytes, stream>>>(a);" \
        in _cu_text("skip_wg.cuh")
    assert max(widths) <= _cu_const("skip_wg.cuh", "HMAX") and pe_dim <= _cu_const("skip_wg.cuh", "HMAX")
    assert all(n % k13.TC_K_STEP == 0 for n in widths)
    assert "(d.n % 32 || d.n > HMAX || d.act != sahs::ACT_RELU)" in _cu_text("skip_wg.cuh")
    ring, smem = _skip_layout(pe_dim, widths, b_len)
    assert ring >= 2 and smem % 16 == 0 and smem <= BLOCK_MAX
    assert smem + BLOCK_RESERVED <= SM_SMEM
    return ring, smem


def _b_len(w, dtype=torch.bfloat16):
    return w.blob(dtype)[1].numel()


@pytest.mark.parametrize("net", ["warp", "hyper"])
def test_skip_forward_layout_fits_its_blocks(models, net):
    """bf16 K13 (``skip_mlp.cu:skip_wg_kernel``, skip_wg.cuh's tile with
    one net): the warp and the hyper net's trunks are widths the tile takes
    (multiples of 32 up to 128), and its shared memory (the ring, each
    warpgroup's encoding and hidden tiles, the biases) fits the one block
    an SM that it launches, with a ring of at least two stages."""
    w = _deform(models)["skip_" + net]
    pe_dim = w.trunk[0]["w"].shape[0]
    widths = [p["w"].shape[1] for p in w.trunk]
    assert pe_dim == 63 and widths == [128 if net == "warp" else 64] * 6
    ring, smem = _skip_tile_fits(pe_dim, widths, _b_len(w))
    assert (ring, smem) == {"warp": (8, 227488), "hyper": (8, 193184)}[net]


@pytest.mark.parametrize("grid", [True, False])
def test_deform_pair_tile_layout_fits_two_blocks(models, grid):
    """bf16 K1 (``deform_pair.cu:deform_pair_wg_kernel``, skip_wg.cuh's
    tile with both nets): the flagship pair's trunks are widths the tile
    takes, and its shared memory, sk::Layout as Python reckons it from the
    sources' constants, holds the blocks of both consumer warpgroups (a
    64-point tile each) and a ring of at least two stages in the one block
    an SM that it launches."""
    model = models["grid" if grid else "grid_free"]
    cond = torch.tensor(np.random.RandomState(0).randn(76 + 36).astype(np.float32))
    pair = k1.prepare_pair(model.warp, model.hyper, cond,
                           nerface.build_pe_groups(model.spec)[0])
    pe_dim = pair.warp_trunk[0]["w"].shape[0]
    widths = [p["w"].shape[1] for p in pair.warp_trunk + pair.hyper_trunk]
    assert pe_dim == 63 and widths == [128] * 6 + [64] * 6
    ring, smem = _skip_tile_fits(pe_dim, widths, _b_len(pair))
    assert (ring, smem) == (8, 229056)
    assert _cu_const("skip_wg.cuh", "LAYERS_MAX") >= len(widths) + 2


def _skip_kinds(models):
    """The deformation nets' folded weights the tile runs, with each net's
    head layer: K1's pair, K13's warp and hyper nets, and K13's hyper net
    in the pre-encoded form (its input an encoding, no PE groups)."""
    d = _deform(models)
    model = models["grid"]
    cond = torch.tensor((np.random.RandomState(2).randn(76 + 36) * 0.5).astype(np.float32))
    pair = d["pair"]
    nw = len(pair.warp_trunk)
    return {"pair": (pair, [nw, nw + 1 + len(pair.hyper_trunk)]),
            "warp": (d["skip_warp"], [len(d["skip_warp"].trunk)]),
            "hyper": (d["skip_hyper"], [len(d["skip_hyper"].trunk)]),
            "pre_encoded": (k13.prepare_skip(model.hyper, cond, None, "linear"),
                            [len(model.hyper.trunk.layers)])}


def _net_products(trunk, skip):
    """A net's layers as the tile runs them: ([k of each input], n, head)."""
    hid = trunk[0]["w"].shape[1]
    pe = trunk[0]["w"].shape[0]
    out = [([pe] if i == 0 else [hid, pe] if i == skip and i > 0 else [hid], hid, False)
           for i in range(len(trunk))]
    return out + [([hid], 8, True)]


@pytest.mark.parametrize("kind", ["pair", "warp", "hyper", "pre_encoded"])
def test_skip_weight_stages_unpack_to_each_layer(models, kind):
    """``skip_mlp.tile_stages``, the weight stages the deformation nets'
    tile streams, read back on the CPU: stage by stage, in the order the
    tile runs its products (each net's layers, then its head; per layer its
    one chunk of outputs (the width rounded up to 64, a head's 8), then
    each input, then its 64-k blocks), each stage rows (outputs) x 64 k in
    the 128-byte swizzle, K-major. Un-swizzled, the stages put back every
    layer's (k, n) weights of the bf16 blob exactly, with zeros past K and
    past the layer's outputs; their bytes are the kernel's count
    (sk::blob_bytes), and the host layer table is the blob's."""
    w, heads = _skip_kinds(models)[kind]
    wb, _, meta = w.blob(torch.bfloat16)
    stages, descs = k13.tile_stages(w, heads)
    assert stages.dtype == torch.bfloat16 and k13.tile_stages(w, heads)[0] is stages
    assert descs.dtype == np.int32 and descs.tolist() == meta.reshape(-1, 7).tolist()
    if kind == "pair":
        prods = (_net_products(w.warp_trunk, w.warp_skip)
                 + _net_products(w.hyper_trunk, w.hyper_skip))
    else:
        prods = _net_products(w.trunk, w.skip)
    assert [i for i, p in enumerate(prods) if p[2]] == heads
    assert [(d[1], d[3], d[4]) for d in descs.tolist()] == [
        (ks[0], ks[1] if len(ks) > 1 else 0, n) for ks, n, _ in prods]
    pos = 0
    for q, (ks, n, head) in enumerate(prods):
        w1, _, w2, _, n_pad = descs[q][:5].tolist()
        rows = n if head else -(-n // 64) * 64
        for off, k in zip((w1, w2), ks):
            got = torch.zeros(-(-k // 64) * 64, rows)
            perm = torch.from_numpy(swizzled(rows).ravel())
            for kb in range(-(-k // 64)):
                got[kb * 64:kb * 64 + 64] = stages[pos:pos + rows * 64].float()[perm].reshape(
                    rows, 64).t()
                pos += rows * 64
            want = torch.zeros_like(got)
            want[:k, :n_pad] = wb[off:off + k * n_pad].float().reshape(k, n_pad)
            assert torch.equal(got, want), (kind, q, off)
    assert pos == stages.numel()
    assert len(stage_order(descs.tolist(), heads)) == sum(
        -(-k // 64) for ks, _, _ in prods for k in ks)
    kb = lambda k: -(-k // 64)
    assert 2 * stages.numel() == sum(128 * (n if head else -(-n // 64) * 64)
                                     * sum(kb(k) for k in ks) for ks, n, head in prods)
    want_bytes = {"pair": 257024, "warp": 198656, "hyper": 58368, "pre_encoded": 58368}
    assert 2 * stages.numel() == want_bytes[kind]


@pytest.mark.parametrize("kind", ["pair", "warp"])
def test_skip_weight_stages_follow_the_blob_they_are_built_from(models, kind):
    """The stages are built from the bf16 blob the weights hold (a test's
    altered copy put in its place, as the card tests' faults are), and
    built anew when that blob changes in place: a zeroed 16-row slice of
    the warp trunk[1] is zero in its stages and nowhere else."""
    w, heads = _skip_kinds(models)[kind]
    wb, b, meta = w.blob(torch.bfloat16)
    base = k13.tile_stages(w, heads)[0]
    w1, _, _, _, n = meta.reshape(-1, 7)[1, :5].tolist()
    bad = wb.clone()
    bad[w1 + 16 * n:w1 + 32 * n] = 0
    w._blobs[torch.bfloat16] = (bad, b, meta)
    changed = k13.tile_stages(w, heads)[0]
    assert changed is not base
    diff = (changed != base).nonzero().reshape(-1)
    assert 0 < diff.numel() <= 16 * n and bool((changed[diff] == 0).all())
    bad[w1 + 16 * n:w1 + 32 * n] = wb[w1 + 16 * n:w1 + 32 * n]
    assert torch.equal(k13.tile_stages(w, heads)[0], base)
    w._blobs[torch.bfloat16] = (wb, b, meta)


def test_composite_forward_smem_covers_every_tiling_count():
    """bf16 K5's second launch (``level_train.cu:composite_fwd_kernel``)
    holds a whole ray in shared memory: COMPOSITE_FWD_FLOATS floats a
    sample (the channels [S][16] and six per-sample arrays of
    composite_fwd), and K2's and K6's composite_kernel two more. Both fit
    a block at the largest sample count the level kernels take (every
    divisor of nerface.LEVEL_TILE)."""
    src = _cu_text("level_train.cu")
    fwd, full = (_cu_const("level_train.cu", n)
                 for n in ("COMPOSITE_FWD_FLOATS", "COMPOSITE_FLOATS"))
    body = src[src.index("void composite_fwd(const Args& a"):]
    body = body[:body.index("const long long r = blockIdx.x;")]
    assert body.count("float* ch = smem;            // [S][16]") == 1
    assert fwd == 16 + len(re.findall(r"float\* \w+ = \w+ \+ (?:S \* 16|S);", body)) == 22
    assert full == fwd + 2
    assert "(size_t)a.S * COMPOSITE_FWD_FLOATS * sizeof(float)" in src
    assert src.count("(size_t)a.S * COMPOSITE_FLOATS * sizeof(float)") == 2
    S = max(s for s in range(1, nerface.LEVEL_TILE + 1) if nerface.level_kernel_compatible(s))
    assert S == nerface.LEVEL_TILE == 1024
    for floats in (fwd, full):
        assert S * floats * 4 <= BLOCK_MAX


def test_kernel_functions_are_resolved_once(monkeypatch):
    """``_build.function`` keeps one typed C function per (library,
    symbol): a second lookup returns the same object without loading the
    library again, and its argument types are set once (on the callable's
    ``fn``, the C function it calls in its launch span). A stub library
    stands in for nvcc's."""
    import ctypes
    from sahs_tpu_torch.ops.kernels import _build

    class Fn:
        def __init__(self):
            self.sets = 0
            self._argtypes = None

        @property
        def argtypes(self):
            return self._argtypes

        @argtypes.setter
        def argtypes(self, v):
            self.sets += 1
            self._argtypes = v

    loads = []

    class Lib:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, symbol):
            return self.fns.setdefault(symbol, Fn())

    libs = {}

    def load(name):
        loads.append(name)
        return libs.setdefault(name, Lib())

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "_FUNCS", {})
    a = _build.function("stub", "sahs_a", "ppli")
    assert _build.function("stub", "sahs_a", "ppli") is a
    assert loads == ["stub"] and a.fn.sets == 1
    assert a.fn.argtypes == [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_int]
    assert a.fn.restype is ctypes.c_int
    b = _build.function("stub", "sahs_b", "f")
    c = _build.function("other", "sahs_a", "p")
    assert b is not a and c is not a and loads == ["stub", "stub", "other"]
    assert (b.fn.argtypes, c.fn.argtypes) == ([ctypes.c_float], [ctypes.c_void_p])


# ---------------------------------------------------------------------------
# (g) The bf16 level backward on wgmma: bwd_tc_kernel (level_train.cu bw::,
# launch 3 of K2/K6/K8/K12) and its dW (level_dw.cuh)
# ---------------------------------------------------------------------------

def _ns_text(path, ns):
    """The body of ``namespace ns { ... }`` in a CUDA source."""
    src = _cu_text(path)
    return src[src.index(f"namespace {ns} {{"):src.index(f"}}  // namespace {ns}")]


def _ns_const(path, ns, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _ns_text(path, ns)).group(1))


def _level_widths(lvl):
    """(L, H, B, kx, n_din, skip) of a folded level."""
    return (len(lvl.trunk), lvl.trunk[0]["w"].shape[1], lvl.dir0_b.shape[0],
            lvl.trunk[0]["w"].shape[0], lvl.dir0_dir.shape[0] + lvl.dir0_se.shape[0],
            lvl.skip)


def _backward_products(L, H, B, kx, n_din, skip):
    """bw::prod_of's products from the level's widths: (k1, k2, n) in the
    order the tile runs them: rgb^T (K 3), dir3^T-dir1^T, dir0's [pe(dir) |
    se] block, the seg head^T (K 12), seg3^T-seg1^T, gfeat (two inputs of
    B), feat^T, the trunk L-1 .. 1 with the PE layer's skip input before
    trunk[skip]^T, and trunk[0]^T, each n padded to 8."""
    p8 = lambda n: -(-n // 8) * 8
    out = [(3, 0, B)] + [(B, 0, B)] * 3 + [(B, 0, p8(n_din))]
    out += [(12, 0, B)] + [(B, 0, B)] * 3 + [(B, B, H), (H, 0, H)]
    for i in range(L - 1, 0, -1):
        if i == skip and 0 < skip < L:
            out.append((H, 0, p8(kx)))
        out.append((H, 0, H))
    return out + [(H, 0, p8(kx))]


def _backward_layout(L, H, B, kx, n_din, n_act):
    """level_train.cu's bw::Layout(a) (ring slots, bytes), from the source's
    constants: per warpgroup R0 and R1 [max(min(H / 64, 2), B / 64) blocks],
    R2 [max(H / 64 - 2, B / 64)], blocks of 64 points x 128 bytes, then F
    (max(pad8(kx), pad8(n_din)) rows of TC_LDF floats), the column sums (2
    x 4 warps x NC floats), gz_alpha and the corner dCoords (4 x 64 floats),
    padded to 1,024 bytes; the alpha head's row (H bf16) and the stash
    slots' offsets; as many ring slots of NC rows x 128 bytes as fit, at
    most RING_MAX; the barriers; the alignment slack."""
    c = lambda n: _ns_const("level_train.cu", "bw", n)
    kb, nc = _cu_const("wgmma.cuh", "KB"), _cu_const("wgmma.cuh", "NC")
    wgs, ring_max, smem_max = c("WG"), c("RING_MAX"), c("SMEM_MAX")
    ldf = _cu_const("level_train.cu", "TC_TP") + 4
    src = _ns_text("level_train.cu", "bw")
    assert "f = (2 * r01 + r2) * wg::BLOCK;" in src
    assert ("per_wg = (f + nf * TC_LDF * 4 + (2 * 4 * NC + 4 * TC_TP) * 4 + 1023) / 1024 * 1024;"
            in src)
    assert "const int params = (2 * a.H + 4 * (a.n_act + a.L + 12) + 15) / 16 * 16;" in src
    assert "const int fixed = WG * per_wg + params + 16 * RING_MAX + 1024;" in src
    assert "bytes = bar + 16 * RING_MAX + 1024;" in src
    assert "constexpr int TC_LDF = TC_TP + 4;" in _cu_text("level_train.cu")
    cd = lambda n, d: -(-n // d)
    p8 = lambda n: -(-n // 8) * 8
    hb, bb = cd(H, kb), cd(B, kb)
    h0 = min(hb, 2)
    r01, r2 = max(h0, bb), max(hb - h0, bb)
    nf = max(p8(kx), p8(n_din))
    per_wg = cd((2 * r01 + r2) * 64 * 128 + nf * ldf * 4 + (2 * 4 * nc + 4 * 64) * 4, 1024) * 1024
    fixed = wgs * per_wg + (2 * H + 4 * (n_act + L + 12) + 15) // 16 * 16 + 16 * ring_max + 1024
    ring = min(ring_max, (smem_max - fixed) // (nc * 128))
    return ring, fixed + ring * nc * 128


@pytest.mark.parametrize("kind", ["grid", "grid_free", "no_ambient"])
def test_backward_tile_layout_fits_its_block(forms, kind):
    """The bf16 backward tile on wgmma (``level_train.cu:bwd_tc_kernel``,
    bw::tile): two consumer warpgroups of a 64-point tile each (the stashes'
    unit) and a producer warp, one block an SM, and its shared memory (each
    warpgroup's three gz regions, its float32 cotangent tile and column
    sums, a ring of at least two stages: a chunk's two y stages must both
    fit) within a block's 227 KB at the flagship's widths, warp-only and
    without the grid."""
    assert _ns_const("level_train.cu", "bw", "WG") == 2
    src = _cu_text("level_train.cu")
    assert "constexpr int THREADS = WG * wg::THREADS + 32;" in _ns_text("level_train.cu", "bw")
    assert re.search(r"__launch_bounds__\(bw::THREADS, 1\)\nbwd_tc_kernel\(", src)
    assert "bw::Layout(a).ring >= 2" in src
    assert "constexpr uint32_t YBYTES = NC * 128;" in src
    lvl = forms[kind]
    L, H, B, kx, n_din, _ = _level_widths(lvl)
    plan = k2.level_train_plan(lvl, torch.bfloat16)
    ring, smem = _backward_layout(L, H, B, kx, n_din, plan.n_act)
    assert ring >= 2 and smem % 16 == 0 and smem <= BLOCK_MAX
    assert smem + BLOCK_RESERVED <= SM_SMEM
    # four 16 KB slots; five without the ambient coordinates (kx 63: F 64 rows)
    assert (ring, smem) == {"grid": (4, 225056), "grid_free": (4, 225056),
                            "no_ambient": (5, 227104)}[kind]


@pytest.mark.parametrize("kind", FORMS)
def test_backward_weight_stages_unpack_to_each_transposed_layer(forms, kind):
    """``level_train.backward_stages``, the weight stages the backward tile
    streams, read back on the CPU in the order the tile runs its products
    (bw::prod_of, here from the level's widths alone): per product its
    output chunks of at most 128 columns, its inputs, their 64-k blocks,
    each stage rows (outputs) x 64 k in the 128-byte swizzle, K-major. They
    put back every transposed layer's (k, n) weights of the plan's bf16
    transposed blob exactly, zero past K and past n: gfeat's second input
    without its last row (the alpha head's, the epilogue's rank-1 term),
    the PE layer's two inputs as two products. The blob's length is the
    kernel's bw::blob_bytes."""
    lvl = forms[kind]
    plan = k2.level_train_plan(lvl, torch.bfloat16)
    w = plan.bwd[0]
    d = plan.descs_t
    L, H, B, kx, n_din, skip = _level_widths(lvl)
    stages = k2.backward_stages(lvl, plan)
    assert stages.dtype == torch.bfloat16 and k2.backward_stages(lvl, plan) is stages
    # the tile's products from the widths, and the transposed layers they read
    prods = _backward_products(L, H, B, kx, n_din, skip)
    pe = d[10 + L]
    layers = [([(d[i][0], d[i][1])], d[i][4]) for i in range(9)]
    layers += [([(d[9][0], d[9][1]), (d[9][2], d[9][3] - 1)], d[9][4]),
               ([(d[10][0], d[10][1])], d[10][4])]
    for i in range(L - 1, 0, -1):
        if i == skip:
            layers.append(([(pe[2], pe[3])], pe[4]))
        t = d[11 + L - 1 - i]
        layers.append(([(t[0], t[1])], t[4]))
    layers.append(([(pe[0], pe[1])], pe[4]))
    assert [(ins[0][1], ins[1][1] if len(ins) > 1 else 0, n) for ins, n in layers] == prods
    assert d[9][3] == B + 1 and d[0][1] == 3 and d[5][1] == 12
    pos = 0
    for ins, n in layers:
        cols = -(-n // 64) * 64
        for c0 in range(0, cols, 128):
            rows = min(128, cols - c0)
            perm = torch.from_numpy(swizzled(rows).ravel())
            for off, k in ins:
                got = torch.zeros(-(-k // 64) * 64, rows)
                for kb in range(-(-k // 64)):
                    st = stages[pos:pos + rows * 64].float()
                    pos += rows * 64
                    got[kb * 64:kb * 64 + 64] = st[perm].reshape(rows, 64).t()
                want = torch.zeros_like(got)
                real = w[off:off + k * n].float().reshape(k, n)[:, c0:c0 + rows]
                want[:k, :real.shape[1]] = real
                assert torch.equal(got, want), (kind, off, c0)
    assert pos == stages.numel()
    kb = lambda k: -(-k // 64)
    assert 2 * stages.numel() == sum(
        128 * min(128, -(-n // 64) * 64 - c0) * (kb(k1_) + kb(k2_))
        for k1_, k2_, n in prods for c0 in range(0, -(-n // 64) * 64, 128))
    src = _ns_text("level_train.cu", "bw")
    assert "s += 128LL * chunk_cols(p.n, c) * (k_blocks(p.k1) + k_blocks(p.k2));" in src
    assert "a.wgb_bytes == bw::blob_bytes(a)" in _cu_text("level_train.cu")
    if kind == "grid":
        assert 2 * stages.numel() == 1556480
    # a zeroed 16-row slice of feat^T in the blob is zero in its stages alone
    bad = w.clone()
    bad[d[10][0] + 16 * d[10][4]:d[10][0] + 32 * d[10][4]] = 0
    changed = k2.backward_stages(lvl, dataclasses.replace(plan, bwd=(bad,) + plan.bwd[1:]))
    diff = (changed != stages).nonzero().reshape(-1)
    assert 0 < diff.numel() <= 16 * d[10][4] and bool((changed[diff] == 0).all())


@pytest.mark.parametrize("kind", ["grid", "grid_free", "ablation"])
def test_level_dw_schedule_covers_every_product_and_stash_block_once(forms, kind):
    """The bf16 level's dW (``level_dw.cuh``): its work list
    (``level_train.dw_items``, [product, k0, n0, rows]) covers every (k, n)
    of every weight product of the plan exactly once (128 k rows, two
    warpgroups' 64, by at most 128 gz columns an item), and db's entries
    are the bias blob past the weights, b_len = gz_stride / 64 floats a
    tile (the tiles' column sums); the chunks of point tiles partition the
    tiles, so each (item, tile) reads its stash blocks once: the item's k
    rows of the activation slot and its gz rows."""
    lvl = forms[kind]
    plan = k2.level_train_plan(lvl, torch.bfloat16)
    prods = plan.prods.reshape(-1, 6).tolist()
    items = k2.dw_items(plan.descs)
    assert k2.DW_ROWS == _cu_const("level_dw.cuh", "WG") * _cu_const("level_dw.cuh", "KW")
    assert k2.DW_ROWS == _cu_const("level_dw.cuh", "NW")
    assert _cu_const("level_dw.cuh", "ITEM_INTS") == len(items[0]) == 4
    hits = np.zeros(plan.out_len, np.int64)
    for j, k0, n0, rows in items:
        a_off, K, g_off, N, out_off, is_bias = prods[j]
        assert not is_bias and k0 % k2.DW_ROWS == 0 and n0 % k2.DW_ROWS == 0
        assert 0 <= k0 < K and 0 <= n0 < N and rows == min(k2.DW_ROWS, N - n0)
        assert rows % 8 == 0 and rows % _cu_const("level_dw.cuh", "GBOX") == 0
        kr = min(k2.DW_ROWS, K - k0)
        idx = out_off + (k0 + np.arange(kr))[:, None] * N + n0 + np.arange(rows)[None, :]
        np.add.at(hits, idx.reshape(-1), 1)
    b_len = plan.gz_stride // k2.TP_BF16
    assert plan.out_len - plan.w_len == b_len
    hits[plan.w_len:] += 1   # bias_dw_kernel: every entry of the bias blob
    assert (hits == 1).all()
    bias = [p for p in prods if p[5]]
    assert sorted(p[4] - plan.w_len + p[3] for p in bias)[-1] == b_len
    for p in bias:   # a layer's bias entries are its gz slot's rows
        assert p[4] - plan.w_len == p[2] // k2.TP_BF16
    for n_tiles in (1, 63, 64, 96, 2047, 4096, 6144):
        chunks = k2.level_dw_chunks(n_tiles)
        per = -(-n_tiles // chunks)
        seen = np.zeros(n_tiles, np.int64)
        for c in range(chunks):
            seen[c * per:min(n_tiles, (c + 1) * per)] += 1
        assert (seen == 1).all() and 1 <= chunks <= 32
    src = _cu_text("level_dw.cuh")
    assert "const int per = (n_tiles + chunks - 1) / chunks;" in src
    assert "level_dw_kernel<<<dim3(n_items, chunks), THREADS, SMEM, stream>>>(" in src
    assert "bias_dw_kernel<<<dim3((b_len + 255) / 256, chunks), 256, 0, stream>>>(" in src


def test_level_dw_tile_sizes_match_the_cuda_sources():
    """The dW's operands: a stash row is a tile's 64 points (128 bytes of
    bf16, the TMA box's width and wgmma's K-major row), a warpgroup's A
    block 64 k rows, a ring stage both warpgroups' A and 128 gz rows, within
    a block's shared memory; the gz stash is bf16 in the backward tile's
    calls (``field_mlp.stash_buffers``) and the bias sums one float per
    gz row of a tile."""
    c = lambda n: _cu_const("level_dw.cuh", n)
    src = _cu_text("level_dw.cuh")
    assert "constexpr int TP = wg::ROWS;" in src and _cu_const("wgmma.cuh", "ROWS") == 64
    assert k2.tile_points(torch.bfloat16) == 64
    assert "constexpr int A_BYTES = KW * 128;" in src
    assert "constexpr int STAGE = WG * A_BYTES + NW * 128;" in src
    assert "constexpr int SMEM = RING * STAGE + 16 * RING + 1024;" in src
    smem = c("RING") * (c("WG") * c("KW") * 128 + c("NW") * 128) + 16 * c("RING") + 1024
    assert smem <= BLOCK_MAX and smem + BLOCK_RESERVED <= SM_SMEM
    lvl = _level(_model(True))
    plan = k2.level_train_plan(lvl, torch.bfloat16)
    acts, gzs, bsum, chunks, part, out = k2.stash_buffers(plan, 5, "cpu")
    assert acts.dtype == gzs.dtype == torch.bfloat16
    assert (acts.numel(), gzs.numel()) == (5 * plan.act_stride, 5 * plan.gz_stride)
    assert bsum.numel() == 5 * plan.gz_stride // 64 and bsum.dtype == torch.float32
    assert (chunks, part.numel(), out.numel()) == (1, plan.out_len, plan.out_len)
