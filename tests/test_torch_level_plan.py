"""What the backward kernels take from Python: the train plans of a NeRF
level (``csrc/level_train.cu``: K2, K6, K8, K12), of the deformation pair
(``csrc/deform_pair_vjp.cu``: K3) and of one deformation net, the warp
field or the hyper sheet (``csrc/skip_mlp.cu``: K14), each built at the
tile size of its compute dtype (64 points in bf16, the tensor-core kernels
of ``csrc/mma.cuh`` and ``csrc/skip_tc.cuh``; 32 in float32, the SIMT
kernels), on the CPU:

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
      other bf16 forward-only kernels (K13; K1) take mma.cuh's tile and
      block, and their shared memory leaves room for the blocks an SM
      that their launch bounds ask for; K5's compositing holds a ray of
      the largest sample count the level kernels take;
  (f) the kernels' C functions are looked up and typed once.
"""
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
from sahs_tpu_torch.ops.kernels.field_mlp import DW_TILE

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
    """bf16: the tensor-core tile of mma.cuh, which K2/K6/K8/K12
    (level_train.cu), K3 and K14 (skip_tc.cuh) take; float32: each SIMT
    kernel's own tile (K3's in pair_bwd.cuh, which K2's pair= form runs on
    the level's tile: level_train.cu asserts the two equal)."""
    assert k2.tile_points(torch.bfloat16) == _cu_const("mma.cuh", "TC_TP") == 64
    assert k2.tile_points(torch.float32) == _cu_const("level_train.cu", "TP") == 32
    assert k2.tile_points(torch.float32) == _cu_const("pair_bwd.cuh", "PAIR_TP") == 32
    assert k2.tile_points(torch.float32) == _cu_const("skip_mlp.cu", "TP_BWD") == 32
    assert "static_assert(TP == sahs::PAIR_TP" in _cu_text("level_train.cu")
    for src, inc in (("deform_pair_vjp.cu", "pair_bwd.cuh"), ("pair_bwd.cuh", "skip_tc.cuh"),
                     ("skip_mlp.cu", "skip_tc.cuh")):
        with open(os.path.join(CSRC, src)) as fp:
            assert f'#include "{inc}"' in fp.read()
    # the width step the K3, K13 and K14 wrappers check in bf16
    assert k13.TC_K_STEP == _cu_const("skip_tc.cuh", "SKIP_KS")
    # bf16 K13: skip_fwd_tc_kernel on mma.cuh's tile, its slices a whole
    # number of k-steps that divides the width step, launched with the
    # layout without the product back to the encoding
    src = _cu_text("skip_mlp.cu")
    ks = _cu_const("skip_mlp.cu", "SKIP_FWD_KS")
    assert ks % 16 == 0 and k13.TC_K_STEP % ks == 0
    assert "const sahs::SkipLayout ly(a.pe_dim(), false, KS);" in src
    assert "const sahs::SkipLayout ly(a.pe_dim(), false, SKIP_FWD_KS);" in src
    assert ("return enc_dim > 0 ? enc_dim : 3 + 6 * n_freq;" in src)
    assert "skip_fwd_tc_kernel<SKIP_FWD_KS>\n      <<<(unsigned)n_tiles, sahs::TC_THREADS" in src
    assert "const long long base = (long long)blockIdx.x * TC_TP;" in src


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
    kb, nc, ring_max, smem_max, wgs = c("KB"), c("NC"), c("RING_MAX"), c("SMEM_MAX"), c("WG")
    src = _cu_text("level_train.cu")
    assert "constexpr int SLOT = NC * 128;" in src
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
    assert k2.tile_points(torch.bfloat16) == _cu_const("mma.cuh", "TC_TP") == 64
    assert _cu_const("wgmma.cuh", "ROWS") == 64
    assert _cu_const("level_train.cu", "WG") == 2
    src = _cu_text("level_train.cu")
    assert "constexpr int THREADS = WG * wg::THREADS + 32;" in src
    assert re.search(r"__launch_bounds__\(fw::THREADS, 1\) field_tc_kernel", src)
    assert re.search(r"__launch_bounds__\(fw::THREADS, 1\) fwd_tc_kernel", src)
    assert "fw::tile<false, PROMOTE>(a, fw_smem);" in src
    assert "fw::tile<true, FIELD_PROMOTE>(a, fw_smem);" in src
    assert (k5.WG_KB, k5.WG_NC) == (_cu_const("level_train.cu", "KB"),
                                    _cu_const("level_train.cu", "NC"))
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
    unswizzle = torch.from_numpy(k5._swizzled(1).ravel())
    pos, n_stages = 0, 0
    for q, ks, n, head in prods:
        w1, _, w2, _, n_pad = descs[q][:5]
        assert (n_pad == n) if head else n_pad == -(-n // 8) * 8
        cols = -(-n // 64) * 64
        chunks = [(0, n)] if head else [(c0, min(128, cols - c0)) for c0 in range(0, cols, 128)]
        for c0, rows in chunks:
            for off, k in zip((w1, w2), ks):
                got = torch.zeros(-(-k // 64) * 64, rows)
                perm = torch.from_numpy(k5._swizzled(rows).ravel())
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


def _skip_fwd_smem_bytes(pe_dim, ks=None):
    """skip_tc.cuh's SkipLayout(pe_dim, false, ks).bytes, from the
    sources' constants: the encoding [pad(pe_dim) to SKIP_KS], two
    SKIP_HMAX-row activation tiles and the two-slice weight ring of
    ks-row slices (K13's SKIP_FWD_KS unless given) for outputs up to
    max(SKIP_HMAX, pad8(pe_dim)) wide."""
    tp, hmax = _cu_const("mma.cuh", "TC_TP"), _cu_const("skip_tc.cuh", "SKIP_HMAX")
    pad_ks = _cu_const("skip_tc.cuh", "SKIP_KS")
    ks = ks or _cu_const("skip_mlp.cu", "SKIP_FWD_KS")
    hdr = _cu_text("skip_tc.cuh")
    assert "ha = pe + pad_ks(pe_dim) * TC_LD * 2;" in hdr
    assert "ring = gs + (to_pe ? SKIP_HMAX * TC_LD * 2 : 0);" in hdr
    assert "bytes = ring + ring_bytes(n_pe > SKIP_HMAX ? n_pe : SKIP_HMAX, ks);" in hdr
    row = (tp + 8) * 2
    return (-(-pe_dim // pad_ks) * pad_ks * row + 2 * hmax * row
            + 2 * ks * (max(hmax, -(-pe_dim // 8) * 8) + 8) * 2)


@pytest.mark.parametrize("net", ["warp", "hyper"])
def test_skip_forward_layout_fits_its_blocks(models, net):
    """bf16 K13 (``skip_mlp.cu:skip_fwd_tc_kernel``): the warp and the hyper
    net's trunks fit the kernel's tiles, and its shared memory leaves room
    for the blocks an SM that its launch bounds ask for."""
    cond = torch.tensor(np.random.RandomState(0).randn(76 + 36).astype(np.float32))
    model = models["grid"]
    w = k13.prepare_skip(getattr(model, net), cond,
                         nerface.build_pe_groups(model.spec)[0],
                         "tanh" if net == "warp" else "linear")
    pe_dim = w.trunk[0]["w"].shape[0]
    widths = [p["w"].shape[1] for p in w.trunk]
    assert pe_dim == 63 and widths == [128 if net == "warp" else 64] * 6
    assert max(widths) <= _cu_const("skip_tc.cuh", "SKIP_HMAX")
    assert all(n % k13.TC_K_STEP == 0 for n in widths)
    blocks = _cu_const("skip_mlp.cu", "SKIP_FWD_BLOCKS")
    assert re.search(r"__launch_bounds__\(sahs::TC_THREADS, SKIP_FWD_BLOCKS\)\n"
                     r"skip_fwd_tc_kernel\(FwdArgs a\)", _cu_text("skip_mlp.cu"))
    assert _cu_const("mma.cuh", "TC_THREADS") * blocks <= 2048
    smem = _skip_fwd_smem_bytes(pe_dim)
    assert smem % 16 == 0 and smem <= BLOCK_MAX
    assert blocks * (smem + BLOCK_RESERVED) <= SM_SMEM
    if _cu_const("skip_mlp.cu", "SKIP_FWD_KS") == 32:
        assert smem == 63488


@pytest.mark.parametrize("grid", [True, False])
def test_deform_pair_tile_layout_fits_two_blocks(models, grid):
    """bf16 K1 (``deform_pair.cu:deform_pair_tc_kernel``): the flagship
    pair's trunks fit skip_tc.cuh's tiles at K3's slice depth (SKIP_KS),
    and the kernel's shared memory, SkipLayout(pe_dim, false) as Python
    reckons it from the sources' constants, leaves room for the two blocks
    an SM that its launch bounds ask for."""
    model = models["grid" if grid else "grid_free"]
    cond = torch.tensor(np.random.RandomState(0).randn(76 + 36).astype(np.float32))
    pair = k1.prepare_pair(model.warp, model.hyper, cond,
                           nerface.build_pe_groups(model.spec)[0])
    pe_dim = pair.warp_trunk[0]["w"].shape[0]
    widths = [p["w"].shape[1] for p in pair.warp_trunk + pair.hyper_trunk]
    assert pe_dim == 63 and widths == [128] * 6 + [64] * 6
    ks = _cu_const("skip_tc.cuh", "SKIP_KS")
    assert max(widths) <= _cu_const("skip_tc.cuh", "SKIP_HMAX")
    assert all(n % ks == 0 for n in widths) and k13.TC_K_STEP == ks
    src = _cu_text("deform_pair.cu")
    assert '#include "skip_tc.cuh"' in src
    assert re.search(r"__launch_bounds__\(sahs::TC_THREADS, 2\)\n"
                     r"deform_pair_tc_kernel\(PairArgs a\)", src)
    assert src.count("const sahs::SkipLayout ly(3 + 6 * a.n_freq, false);") == 2
    assert src.count("skip_trunk_tc<false, sahs::SKIP_KS>") == 2
    assert "const long long base = (long long)blockIdx.x * TC_TP;" in src
    smem = _skip_fwd_smem_bytes(pe_dim, ks)
    assert smem % 16 == 0 and smem <= BLOCK_MAX
    assert 2 * (smem + BLOCK_RESERVED) <= SM_SMEM
    assert smem == 63488


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
    library again, and its argument types are set once. A stub library
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
    assert loads == ["stub"] and a.sets == 1
    assert a.argtypes == [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_int]
    assert a.restype is ctypes.c_int
    b = _build.function("stub", "sahs_b", "f")
    c = _build.function("other", "sahs_a", "p")
    assert b is not a and c is not a and loads == ["stub", "stub", "other"]
    assert (b.argtypes, c.argtypes) == ([ctypes.c_float], [ctypes.c_void_p])
