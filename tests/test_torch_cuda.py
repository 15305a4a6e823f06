"""The port's CUDA kernels on the card: K1 (deform pair), K5 (NeRF level),
K2 (level train), K3 (pair backward), K4 (dGrid), K6 (level backward), K7
(raw field), K8 (raw-field backward), K9 (dGrid from coordinates), K10
(the grid sample's backward), K11 (the per-point field), K12 (its
backward), K13 (one deformation MLP), K14 (its backward), K15 (the
sample positions), the grid-free forms of K1, K2, K5-K8, K11 and K12, and
the tools' experiment kernels X1-X6 against their plain versions (the
kernels on the tensor cores in bf16, the backwards K2, K3, K6, K8, K12,
K14 and the forwards K1, K5, K7, K11, K13, also against exact sums), the
kernel path of
render_rays against the plain path, train steps (fused, the autograd
fallback on both of its paths, the per-point branch, the plain path, the
warp-only and ambient-only models, and the grid-free model on each of
its paths) through the kernels against the
same steps on the plain versions, and the fused step against the fallback
step.
Every test draws its inputs from its own numpy random state (the ``rng``
fixture), so it reads the same inputs whichever tests ran before it.
Marked ``cuda``; without a CUDA device they skip. This file imports no JAX,
so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances: float32 within 1e-4 absolute (the kernels sum in another order
than cuBLAS) and corner rows exact; bfloat16 within 2e-2 relative, the bf16
gate of PARITY_TPU.json (the two sides round the same operands to bf16 but
sum them in another order, so a value rounds differently now and then),
and for the kernels on the tensor cores against exact sums, at most
PLAIN_MULTIPLE times the plain version's distance to them. bf16 K6 point
cotangents in the two tests of ROADMAP Queue 3, bf16 K2's in the
grid-free one and bf16 K8's in the raw-field one, excuse the kink points
that are off, and fail with more of them than utils/compare.kink_cap
(``_kink_gate``); there each side is held against the exact-sum reference
on its own leaky-ReLU branch at its off kink points (``_plain_ref``). The
grid backward (K4, K9, K10: one binned routine) is also held to give the
same bits on a second launch, as the deformation nets' backward (bf16 K3
and K14) is; its tests also hold a ragged last tile, the rows of gx past
P and trunks a multiple of 8.
Selecting: ``-k deform_backward`` (bf16 K3's and K14's tile and dW: faults,
repeats, ragged last tile, gx past P, widths), ``-k tensor_core`` (the tensor-core kernels' own tests, the
level backward's faults, repeats and ragged last tile among them), ``-k
"tensor_core_level_forward or tensor_core_deform_pair"`` (bf16 K5 and K1's
faults, guards and K5's bit-equality with K2's forward), ``-k "grid_dg or
grid_bwd or grid_backward or order_free"`` (the grid backward), ``-k
"pre_encoded or points_cotangent or on_se"`` (the kernels' pre-encoded
forms, K3's points' cotangent and the level kernels on a per-point se).
"""
import dataclasses
import re
import zlib

import numpy as np
import pytest
import torch

from sahs_tpu_torch.config import Config
from sahs_tpu_torch.models import nerface
from sahs_tpu_torch.ops.grid import _cell_geometry, pack_corner_table
from sahs_tpu_torch.ops.kernels import deform_pair as k1
from sahs_tpu_torch.ops.kernels import field_grid
from sahs_tpu_torch.ops.kernels import field_mlp
from sahs_tpu_torch.ops.kernels import grid_bwd as k4
from sahs_tpu_torch.ops.kernels import level_train as k2
from sahs_tpu_torch.ops.kernels import nerf_level as k5
from sahs_tpu_torch.ops.kernels import nerf_mlp as k11
from sahs_tpu_torch.ops.kernels import points as k15
from sahs_tpu_torch.ops.kernels import skip_mlp as k13
from sahs_tpu_torch.render.pipeline import RenderSettings, render_rays
from sahs_tpu_torch.tools import level_exact
from sahs_tpu_torch.train import fused
from sahs_tpu_torch.utils import compare
from sahs_tpu_torch.utils.compare import point_errors, tree_errors

import torch_grid_util

GRID = (32, 32, 32)


@pytest.fixture(scope="module")
def card():
    """The flagship model with seeded weights on the card and its per-frame
    folded weights (the conditioning from a random state of its own)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    spec = nerface.ModelSpec.from_config(Config())
    model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
    with torch.no_grad():
        model.coarse.fc_alpha.bias.fill_(0.5)   # sigma active
        # colours that vary along a ray: at the seeded init they agree to
        # 4e-4, and sigma's gradient, a difference of a ray's colours,
        # would be rounding alone
        model.coarse.fc_rgb.weight.mul_(100.0)
    rng = np.random.RandomState(0)
    cond = torch.tensor(rng.randn(76 + 36).astype(np.float32) * 0.5, device=dev)
    warp_g, pts_g, dir_g = nerface.build_pe_groups(spec)
    pair = k1.prepare_pair(model.warp, model.hyper, cond, warp_g)
    level = k5.prepare_level(model.coarse, cond[76:], pts_g, dir_g)
    yield dev, model, pair, level
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32


@pytest.fixture
def rng(request):
    """The test's own numpy random state, seeded from a stable hash of its
    node id (crc32; Python's hash is salted per process): a test draws the
    same inputs whichever tests ran before it, in the whole file, in a
    subset or alone."""
    return np.random.RandomState(zlib.crc32(request.node.nodeid.encode()))


def _gpu(dev, a):
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def _rel(a, b):
    """max |a - b| / (|b| + 1e-3), the metric of PARITY_TPU.json."""
    return float(((a.double() - b.double()).abs() / (b.double().abs() + 1e-3)).max())


def _scaled(a, b):
    """max |a - b| / max |b|, for outputs that pass through zero."""
    return float((a - b).abs().max() / b.abs().max())


# In bfloat16 a backward kernel's distance to exact sums may be at
# most PLAIN_MULTIPLE times the plain version's on the same draw (or
# PLAIN_MULTIPLE x PLAIN_FLOOR, a tenth of the bf16 point gate, where the
# plain version is closer than that), for every cotangent and the worst dW
# leaf: the plain version stays the yardstick of how far float32
# arithmetic on the same bf16 operands may move a reading. Over these
# tests' draws on the card the largest ratio read 3.2 (K8's gse at 96 x
# 16); tools/level_exact.py's draws with a background read at most ~1.6.
PLAIN_MULTIPLE = 4.0
PLAIN_FLOOR = 1e-3

# The forwards K7 and K11 keep the multiple in each output group of their
# raw field [rgb3 | seg12 | sigma1], each against its own scale, with a
# floor of their own: the plain forwards sit 4.1e-5-5.0e-5 from exact sums
# over the whole field on the card, so PLAIN_FLOOR would pass a kernel 100
# times as far, and one that leaves 16 rows of trunk[1] out moves the field
# by ~6 times the plain version's distance.
FIELD_GROUPS = (("rgb", 0, 3), ("seg", 3, 15), ("sigma", 15, 16))
FIELD_FLOOR = 1e-5


def _field_scaled(a, b):
    """The worst group of raw (P, 16) ``a`` against ``b``: max |a - b| /
    max |b| within the group."""
    return max(_scaled(a[:, i:j], b[:, i:j]) for _, i, j in FIELD_GROUPS)


def _field_exact(k, p, x):
    """(kernel keeps the rule in every group, {group: (d_k, d_p)}): the
    L2-relative distances of raw fields ``k`` and ``p`` to exact sums ``x``."""
    d = {g: (point_errors(k[:, i:j], x[:, i:j])["l2_rel"],
             point_errors(p[:, i:j], x[:, i:j])["l2_rel"]) for g, i, j in FIELD_GROUPS}
    return all(dk <= PLAIN_MULTIPLE * max(dp, FIELD_FLOOR) for dk, dp in d.values()), d


def _without_sigma_head(tree):
    return {k: v for k, v in tree.items() if k != "fc_alpha"}


# The bf16 level kernels whose reference takes each side's own leaky-ReLU
# branch at its off kink points (``_plain_ref``; level_exact.kernel_branches
# reads the kernel's from its stash): the index of gx among their results.
BRANCH_GX = {k2.nerf_level_vjp_plain: 0, k2.nerf_level_train_plain: 2,
             k2.nerf_rayd_vjp_plain: 0}


def _plain_ref(plain, *args, out_k=None, skip_sigma=False, kinks=None):
    """The reference of a kernel on the tensor cores in bf16 (the backwards
    K2, K6, K8, K12; K3, K14; the forwards K7, K11): its plain version. In
    bfloat16 the plain version
    with exact sums (``tools/level_exact.exact_plain``: the same bf16
    operands, float64 sums): the tensor-core kernels (csrc/mma.cuh,
    csrc/skip_tc.cuh) sum the same bf16 products in another order than the
    plain version's float32 matmuls, so a value rounds to bf16 differently
    now and then, and against the plain version both sides' rounding would
    count; with exact sums only the kernel's does. Given the kernel's
    results ``out_k``, also holds them to the plain version's own distance
    from exact sums (PLAIN_MULTIPLE), dW without the sigma head where
    ``skip_sigma``, point cotangents over the points that are not excused
    kink points where ``kinks`` is given (``_kink_gate``).

    Where ``kinks`` is given to bf16 K6 or K2 (BRANCH_GX), each side is
    held against the exact-sum reference on its own leaky-ReLU branch at
    the kink points where its gx is off by more than compare.KINK_TOL, and
    at no other point (``level_exact.exact_plain_at_branches``; at most
    compare.kink_cap such points of the kernel's): the kernel's reference
    takes the kernel's branch there (read from its own stash), the plain
    version's its own, so that a flip at a kink moves neither side's
    distance (ROADMAP Queue 3). The kernel's reference is returned."""
    if not any(isinstance(a, str) and a == "bfloat16" for a in args):
        return plain(*args)
    ref = ref_p = level_exact.exact_plain(plain, *args)
    out_p = plain(*args) if out_k is not None else None
    gx = BRANCH_GX.get(plain)
    if out_k is not None and kinks is not None and gx is not None:
        off = compare.excused_points(out_k[gx], ref[gx], kinks)
        off_p = compare.excused_points(out_p[gx], ref[gx], kinks)
        assert int(off.sum()) <= compare.kink_cap(len(off), int(off_p.sum())), (
            plain.__name__, int(off.sum()), int(off_p.sum()), len(off))
        if bool(off.any()):
            ref = level_exact.exact_plain_at_branches(
                plain, args, off, level_exact.kernel_branches(args, plain))
        if bool(off_p.any()):
            ref_p = level_exact.exact_plain_at_branches(
                plain, args, off_p, level_exact.plain_branches(args))
    if out_k is not None:
        # K2's composited colours and weights are forward outputs
        first = 2 if plain is k2.nerf_level_train_plain else 0
        # K3 returns its gradient tree alone, K7 and K11 their raw field
        outs = lambda o: (o,) if isinstance(o, (dict, torch.Tensor)) else o
        for i, (k, p, x, xp) in enumerate(zip(outs(out_k), outs(out_p), outs(ref),
                                              outs(ref_p))):
            if i < first or k is None:
                continue
            if plain in (k5.nerf_raw_plain, k11.nerf_mlp_plain):
                ok, d = _field_exact(k, p, x)
                assert ok, (plain.__name__, d)
                continue
            if isinstance(x, dict):
                if skip_sigma:
                    k, p, x, xp = (_without_sigma_head(t) for t in (k, p, x, xp))
                d_k, d_p = tree_errors(k, x)["l2_rel"], tree_errors(p, xp)["l2_rel"]
            else:
                keep = slice(None)
                if kinks is not None and len(k) == len(kinks):
                    off = compare.excused_points(k, x, kinks)
                    off_p = compare.excused_points(p, xp, kinks)
                    assert int(off.sum()) <= compare.kink_cap(len(off), int(off_p.sum())), (
                        plain.__name__, i, int(off.sum()), int(off_p.sum()), len(off))
                    keep = ~off
                d_k = point_errors(k[keep], x[keep])["l2_rel"]
                d_p = point_errors(p[keep], xp[keep])["l2_rel"]
            assert d_k <= PLAIN_MULTIPLE * max(d_p, PLAIN_FLOOR), (
                plain.__name__, i, d_k, d_p)
    return ref


# bf16 K1 and K5 on the tensor cores keep the exact-sum rule in each of
# their output groups, each against its own scale: K1's warp offset (its
# output xyz less the input point) and ambient coordinates, with K13's
# floor (SKIP_FLOOR: the same nets); K5's composited rgb and seg channels
# and its weights, with a floor of their own below the plain version's
# distance to exact sums.
LEVEL_FLOOR = 1e-7


def _pair_exact(pts, out_k, out_p, out_x):
    """(K1's output ``out_k`` keeps the rule in both groups, {group: (d_k,
    d_p)}): the L2-relative distances of ``out_k`` and ``out_p`` to exact
    sums ``out_x`` in the warp offset and the ambient coordinates."""
    groups = {"warp": lambda o: o.double()[:, :3] - pts.double(),
              "ambient": lambda o: o.double()[:, 3:]}
    d = {g: (point_errors(f(out_k), f(out_x))["l2_rel"],
             point_errors(f(out_p), f(out_x))["l2_rel"]) for g, f in groups.items()}
    return all(dk <= PLAIN_MULTIPLE * max(dp, SKIP_FLOOR) for dk, dp in d.values()), d


def _level_exact(out_k, out_p, out_x):
    """(K5's (rgb_map, weights) ``out_k`` keeps the rule in every group,
    {group: (d_k, d_p)}): the L2-relative distances of ``out_k`` and
    ``out_p`` to exact sums ``out_x`` in rgb_map's rgb and seg channels
    and in the weights."""
    groups = {"rgb": lambda o: o[0][:, :3], "seg": lambda o: o[0][:, 3:15],
              "weights": lambda o: o[1]}
    d = {g: (point_errors(f(out_k), f(out_x))["l2_rel"],
             point_errors(f(out_p), f(out_x))["l2_rel"]) for g, f in groups.items()}
    return all(dk <= PLAIN_MULTIPLE * max(dp, LEVEL_FLOOR) for dk, dp in d.values()), d


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [16, 128])
def test_deform_pair_kernel_matches_plain(card, rng, compute_dtype, S):
    """K1 against its plain version: float32 within 1e-4 and the rows
    exact; bf16 (the tensor cores) by the exact-sum rule. In both types the
    rows are the cells of the kernel's own output, bit for bit."""
    dev, _, pair, _ = card
    P = 300 * S                   # not a multiple of the 64-point tile
    pts = _gpu(dev, rng.uniform(-0.6, 0.6, (P, 3)))
    before = k1.deform_pair_forward.launches
    out_k, rows_k = k1.deform_pair_forward(pts, pair, compute_dtype, S, GRID)
    out_p, rows_p = k1.deform_pair_plain(pts, pair, compute_dtype, S, GRID)
    torch.cuda.synchronize()
    assert k1.deform_pair_forward.launches == before + 1
    assert out_k.shape == (P, 5) and rows_k.shape == (P // S, S)
    assert torch.isfinite(out_k).all()
    # the rows are _cell_geometry's of the kernel's own output, bit for bit
    rows_self, _, _ = _cell_geometry(out_k[:, :3], GRID)
    assert torch.equal(rows_k.reshape(-1).long(), rows_self)
    if compute_dtype == "float32":
        assert float((out_k - out_p).abs().max()) <= 1e-4
        assert torch.equal(rows_k, rows_p)
    else:
        out_x = level_exact.exact_plain(k1.deform_pair_plain, pts, pair,
                                        compute_dtype, S, GRID)[0]
        ok, d = _pair_exact(pts, out_k, out_p, out_x)
        assert ok, d


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,with_bg,with_noise", [
    (16, True, True), (16, False, False), (128, True, False), (64, False, True)])
def test_nerf_level_kernel_matches_plain(card, rng, compute_dtype, S, with_bg,
                                         with_noise):
    """K5 against its plain version: float32 within 1e-4; bf16 (the
    tensor cores, two launches a call) by the exact-sum rule."""
    dev, model, _, level = card
    R = 96
    pts = _gpu(dev, np.concatenate([rng.uniform(-1.05, 1.05, (R * S, 3)),
                                    rng.uniform(-1, 1, (R * S, 2))], 1))
    dirs = _gpu(dev, rng.randn(R, 3) * 0.1 + [0, 0, -1])
    z = _gpu(dev, np.sort(rng.uniform(0.48, 1.08, (R, S)), axis=-1))
    bg = _gpu(dev, rng.rand(R, 15)) if with_bg else None
    noise = _gpu(dev, rng.randn(R, S) * 0.5) if with_noise else None
    dtype = torch.float32 if compute_dtype == "float32" else torch.bfloat16
    table = pack_corner_table(model.spatial_embeddings.detach(), dtype=dtype)
    rows, _, _ = _cell_geometry(pts, GRID)
    args = (pts, dirs, table, rows, z, bg, noise, level, compute_dtype, GRID)
    before = k5.nerf_level_forward.launches
    rgb_k, w_k = k5.nerf_level_forward(*args)
    rgb_p, w_p = k5.nerf_level_plain(*args)
    torch.cuda.synchronize()
    assert k5.nerf_level_forward.launches == before + 1
    assert rgb_k.shape == (R, 16) and w_k.shape == (R, S)
    assert torch.isfinite(rgb_k).all() and torch.isfinite(w_k).all()
    assert float(w_p.sum()) > 0.1 * R
    if compute_dtype == "float32":
        assert float((rgb_k - rgb_p).abs().max()) <= 1e-4
        assert float((w_k - w_p).abs().max()) <= 1e-4
    else:
        out_x = level_exact.exact_plain(k5.nerf_level_plain, *args)
        assert out_x[0].dtype == out_x[1].dtype == torch.float64
        ok, d = _level_exact((rgb_k, w_k), (rgb_p, w_p), out_x)
        assert ok, d


@pytest.mark.cuda
def test_wrapper_refuses_weights_on_another_device(card):
    dev, _, pair, _ = card
    cpu_pair = k1.prepare_pair(*_cpu_nets(), torch.zeros(76 + 36),
                               pair.pe_groups)
    with pytest.raises(ValueError, match="weights are on"):
        k1.deform_pair_forward(torch.zeros((64, 3), device=dev), cpu_pair,
                               "float32", 64, GRID)


def _cpu_nets():
    spec = nerface.ModelSpec.from_config(Config())
    m = nerface.NeRFaceModel.init(spec, seed=0, device="cpu")
    return m.warp, m.hyper


@pytest.mark.cuda
def test_render_rays_kernel_path_matches_plain_path(card, rng):
    """render_rays on the card, 64 + 64 samples, float32, deterministic:
    K1 + K5 against the plain path, which runs no kernel."""
    dev, model, _, _ = card
    R = 256
    ro = torch.zeros((R, 3), device=dev)
    rd = _gpu(dev, rng.randn(R, 3) * 0.05 + [0, 0, -1])
    audio = _gpu(dev, rng.randn(16, 29))
    pose = _gpu(dev, np.concatenate([np.linalg.qr(rng.randn(3, 3))[0],
                                     [[0.0], [0.0], [0.6]]], 1))
    bg = _gpu(dev, rng.rand(R, 15))
    out = {}
    launches = {}
    for use_kernels in (True, False):
        s = RenderSettings(num_coarse=64, num_fine=64, perturb=False,
                           use_pallas=use_kernels, compute_dtype="float32")
        before = (k1.deform_pair_forward.launches,
                  k5.nerf_level_forward.launches)
        out[use_kernels] = render_rays(model, s, ro, rd, 0.48, 1.08, audio,
                                       pose, background_prior=bg)
        launches[use_kernels] = (k1.deform_pair_forward.launches - before[0],
                                 k5.nerf_level_forward.launches - before[1])
    assert launches == {True: (2, 2), False: (0, 0)}
    k, p = out[True], out[False]
    assert torch.isfinite(k.rgb_fine).all()
    assert float((k.rgb_fine - p.rgb_fine).abs().max()) <= 1e-4
    assert float((k.weights - p.weights).abs().max()) <= 1e-4
    torch.testing.assert_close(k.disp_fine, p.disp_fine, rtol=1e-3, atol=0)


# ---------------------------------------------------------------------------
# The train kernels: K2 (level train), K3 (pair backward), K4 (dGrid)
# Gates (those of chip_smoke.py's phase 5): float32 outputs within 1e-4
# absolute; the point cotangents gx, gse and g_bg at a cosine of 0.9999,
# with at most 4 points whose error exceeds 1e-4 of the largest point's
# norm (where a pre-activation lies within rounding of 0 an activation
# derivative flips; utils/compare.point_errors); every gradient leaf, each
# weight and each bias on its own, within 1e-3 of its own norm and at
# 0.9999 cosine (utils/compare.tree_errors); bfloat16 outputs within 2e-2
# relative, gradient leaves within 1e-2 and at 0.9999 (at these tests'
# 1,536 to 12,288 random points a bf16 leaf reaches 2.1e-3; chip_smoke
# gates the main path's 262,144 at 2e-3). A whole step's
# leaves within 2e-2 and at 0.9999: each side rounds K1's output its own
# way, and one rounding step of a point flips the ReLUs whose input lies
# within ~1e-5 of 0 (chip_smoke.STEP_GATES). dGrid's atomics sum in a
# varying order.
# ---------------------------------------------------------------------------

GRAD_GATES = {"float32": (1e-3, 0.9999), "bfloat16": (1e-2, 0.9999),
              "step": (2e-2, 0.9999)}
POINT_FLIPS = 4


def _grads_ok(a, b, gates):
    e = tree_errors(a, b)
    rel, cos = GRAD_GATES[gates]
    assert e["l2_rel"] <= rel and e["cosine"] >= cos, e


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,with_bg,with_noise,bg_sup", [
    (16, True, True, 0.0), (64, True, False, 0.5), (128, False, True, 0.0)])
def test_level_train_kernel_matches_plain(card, rng, grid_varied, compute_dtype, S,
                                          with_bg, with_noise, bg_sup):
    """K2 against its plain version. Without a background, as the
    tensor-core test at a step's size: every output and every dW leaf but
    sigma's head on the seeded level, and sigma's head on ``grid_varied``'s.
    There sigma's gradient is not a cancelled sum, but the trunk's dW is
    less well conditioned than on the seeded level (tools/level_exact.py,
    PERF.md section 6)."""
    dev, model, _, level = card
    R = 96
    pts = _gpu(dev, np.concatenate([rng.uniform(-1.05, 1.05, (R * S, 3)),
                                    rng.uniform(-1, 1, (R * S, 2))], 1))
    dirs = _gpu(dev, rng.randn(R, 3) * 0.1 + [0, 0, -1])
    z = _gpu(dev, np.sort(rng.uniform(0.48, 1.08, (R, S)), axis=-1))
    bg = _gpu(dev, rng.rand(R, 15)) if with_bg else None
    noise = _gpu(dev, rng.randn(R, S) * 0.5) if with_noise else None
    tgt = _gpu(dev, np.concatenate([rng.rand(R, 3),
                                    np.eye(12)[rng.randint(0, 12, R)]], 1))
    lw = _gpu(dev, np.stack([np.full(R, 1.0 / R), np.full(R, 0.02 / R)], 1))
    dtype = torch.float32 if compute_dtype == "float32" else torch.bfloat16
    table = pack_corner_table(model.spatial_embeddings.detach(), dtype=dtype)
    rows, _, _ = _cell_geometry(pts, GRID)
    args = (pts, dirs, table, rows, z, bg, noise, tgt, lw, level,
            compute_dtype, GRID, bg_sup)
    before = k2.nerf_level_train.launches
    out_k = k2.nerf_level_train(*args)
    out_p = _plain_ref(k2.nerf_level_train_plain, *args, out_k=out_k,
                       skip_sigma=not with_bg)
    torch.cuda.synchronize()
    (rgb_k, w_k, gx_k, gse_k, gbg_k, g_k), (rgb_p, w_p, gx_p, gse_p, gbg_p, g_p) = \
        out_k, out_p
    assert all(bool(torch.isfinite(t).all()) for t in (rgb_k, w_k, gx_k, gse_k))
    if compute_dtype == "float32":
        assert float((rgb_k - rgb_p).abs().max()) <= 1e-4
        assert float((w_k - w_p).abs().max()) <= 1e-4
        for a, b in ((gx_k, gx_p), (gse_k, gse_p)) + (
                ((gbg_k, gbg_p),) if with_bg else ()):
            e = point_errors(a, b, 1e-4)
            assert e["n_over"] <= POINT_FLIPS and e["cosine"] >= 0.9999, e
    else:
        assert _rel(rgb_k, rgb_p) <= 2e-2 and _rel(w_k, w_p) <= 2e-2
    if with_bg:
        _grads_ok(g_k, g_p, compute_dtype)
    else:
        _grads_ok(_without_sigma_head(g_k), _without_sigma_head(g_p), compute_dtype)
        vargs = args[:9] + (grid_varied,) + args[10:]
        out_v = k2.nerf_level_train(*vargs)
        head_p = _plain_ref(k2.nerf_level_train_plain, *vargs, out_k=out_v)[5]["fc_alpha"]
        torch.cuda.synchronize()
        _grads_ok(out_v[5]["fc_alpha"], head_p, compute_dtype)
    assert k2.nerf_level_train.launches == before + 1 + (not with_bg)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_deform_pair_vjp_kernel_matches_plain(card, rng, compute_dtype):
    """K3 against its plain version (in bf16 with exact sums, and within
    PLAIN_MULTIPLE of the plain version's distance to them), the last
    64-point tile ragged."""
    dev, _, pair, _ = card
    P = 300 * 64 + 17
    pts = _gpu(dev, rng.uniform(-0.6, 0.6, (P, 3)))
    g = _gpu(dev, rng.randn(P, 5) * 0.1)
    g2 = _gpu(dev, rng.randn(P, 5) * 0.1)
    before = k1.deform_pair_vjp.launches
    out_k = k1.deform_pair_vjp(pts, pair, g, g2, compute_dtype)
    out_p = _plain_ref(k1.deform_pair_vjp_plain, pts, pair, g, g2, compute_dtype,
                       out_k=out_k)
    torch.cuda.synchronize()
    assert k1.deform_pair_vjp.launches == before + 1
    _grads_ok(out_k, out_p, compute_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("with_addend", [False, True])
def test_grid_dg_kernel_matches_plain(card, rng, with_addend):
    dev, _, _, _ = card
    P = 50000
    pts = _gpu(dev, rng.uniform(-1.1, 1.1, (P, 5)))
    gse = _gpu(dev, rng.randn(P, 32))
    gse2 = _gpu(dev, rng.randn(P, 32)) if with_addend else None
    rows, _, _ = _cell_geometry(pts, GRID)
    before = k4.grid_dg.launches
    dg_k = k4.grid_dg(pts, rows, gse, gse2, (32,) + GRID)
    dg_p = k4.grid_dg_plain(pts, rows, gse, gse2, (32,) + GRID)
    torch.cuda.synchronize()
    assert k4.grid_dg.launches == before + 1
    _grads_ok(dg_k, dg_p, "float32")
    with pytest.raises(ValueError, match="addend"):
        k4.grid_dg(pts, rows, gse, gse[:, :16], (32,) + GRID)


@pytest.mark.cuda
def test_train_step_kernel_path_matches_plain_path(card, monkeypatch):
    """One float32 train step (256 rays, 64 + 64 samples) through K15 and
    K1-K4 against the same step with the plain versions put in the
    kernels' place (no kernel launches then), same weights and draws: the
    loss within 1e-5 relative, the gradients within the step's gates."""
    from sahs_tpu_torch.train import stage1
    from sahs_tpu_torch.train.fused import TrainDraws
    from sahs_tpu_torch.data.synthetic import SyntheticFaceDataset
    dev = card[0]
    cfg = Config()
    cfg.nerf.train.num_random_rays = 256
    cfg.runtime.compute_dtype = "float32"
    spec = nerface.ModelSpec.from_config(cfg)
    ts = stage1.TrainSettings.from_config(cfg)
    ds = SyntheticFaceDataset(kind="audio", num_frames=1, H=64, W=64,
                              near=cfg.dataset.near, far=cfg.dataset.far)
    batch = dict(ds[0], background=ds.background())
    gen = torch.Generator().manual_seed(3)
    draws = TrainDraws(*[t.to(dev) for t in (
        -torch.log(-torch.log(torch.rand(64 * 64, generator=gen).clamp_min(1e-20))),
        torch.rand((256, 64), generator=gen), torch.rand((256, 64), generator=gen),
        torch.randn((256, 64), generator=gen), torch.randn((256, 128), generator=gen))])
    res = {}
    for use_kernels in (True, False):
        st = stage1.init_train_state(spec, ts, seed=0, device=dev)
        with torch.no_grad():
            for lvl in (st.model.coarse, st.model.fine):
                lvl.fc_alpha.bias.fill_(0.5)
        before = (k1.deform_pair_forward.launches, k2.nerf_level_train.launches,
                  k1.deform_pair_vjp.launches, k4.grid_dg.launches,
                  k15.build_pts.launches)
        step = stage1.make_train_step(spec, ts, device=dev)
        with monkeypatch.context() as mp:
            if not use_kernels:
                mp.setattr(fused, "deform_pair_forward", k1.deform_pair_plain)
                mp.setattr(fused, "deform_pair_vjp", k1.deform_pair_vjp_plain)
                mp.setattr(fused, "grid_dg", k4.grid_dg_plain)
                mp.setattr(k2, "nerf_level_train", k2.nerf_level_train_plain)
                mp.setattr(fused, "build_pts", k15.build_pts_plain)
            st, m = step(st, batch, draws=draws)
        launches = (k1.deform_pair_forward.launches - before[0],
                    k2.nerf_level_train.launches - before[1],
                    k1.deform_pair_vjp.launches - before[2],
                    k4.grid_dg.launches - before[3],
                    k15.build_pts.launches - before[4])
        grads = {n: p.grad for n, p in st.model.named_parameters()}
        res[use_kernels] = (m, grads, launches, st.sample_prob)
    (m_k, g_k, l_k, sp_k), (m_p, g_p, l_p, sp_p) = res[True], res[False]
    assert l_k == (2, 2, 1, 1, 2) and l_p == (0, 0, 0, 0, 0)
    assert abs(float(m_k["loss"]) - float(m_p["loss"])) <= 1e-5 * abs(float(m_p["loss"]))
    _grads_ok(g_k, g_p, "step")
    assert float((sp_k - sp_p).abs().max()) <= 1e-4


# ---------------------------------------------------------------------------
# The autograd fallback's kernels: K6 (level backward), K7 (raw field), K8
# (raw-field backward), K9 (dGrid from coordinates), and its steps. Gates
# as the train kernels' above. Cotangents like the fallback's own: those
# of a loss of the outputs (random cotangents at every point would make a
# single kink flip move a whole dW leaf).
# ---------------------------------------------------------------------------

def _level_case(dev, model, rng, R, S, with_bg, with_noise, compute_dtype):
    pts = _gpu(dev, np.concatenate([rng.uniform(-1.05, 1.05, (R * S, 3)),
                                    rng.uniform(-1, 1, (R * S, 2))], 1))
    dirs = _gpu(dev, rng.randn(R, 3) * 0.1 + [0, 0, -1])
    z = _gpu(dev, np.sort(rng.uniform(0.48, 1.08, (R, S)), axis=-1))
    bg = _gpu(dev, rng.rand(R, 15)) if with_bg else None
    noise = _gpu(dev, rng.randn(R, S) * 0.5) if with_noise else None
    dtype = torch.float32 if compute_dtype == "float32" else torch.bfloat16
    table = pack_corner_table(model.spatial_embeddings.detach(), dtype=dtype)
    rows, _, _ = _cell_geometry(pts, GRID)
    return pts, dirs, table, rows, z, bg, noise


def _loss_cotangents(dev, rng, rgb_map, w):
    """Cotangents of an L2 + cross-entropy loss of rgb_map against a
    random target, and of the background sample's weight."""
    R = rgb_map.shape[0]
    tgt = _gpu(dev, np.concatenate([rng.rand(R, 3),
                                    np.eye(12)[rng.randint(0, 12, R)]], 1))
    g_rgb = torch.cat([2.0 * (rgb_map[:, :3] - tgt[:, :3]) / R,
                       -0.02 * tgt[:, 3:15] / (rgb_map[:, 3:15] + 1e-10) / R,
                       torch.zeros_like(rgb_map[:, :1])], dim=-1)
    g_w = torch.zeros_like(w)
    g_w[:, -1] = _gpu(dev, rng.rand(R)) * 1e-3
    return g_rgb, g_w


# bf16 K6 point cotangents in the two tests that hold them against exact
# sums at 96 rays on any of their draws (test_nerf_level_vjp_kernel_...
# and test_grid_free_level_kernels_..., where K2's are held so too; ROADMAP
# Queue 3): a kink point (utils/compare.kink_points: a leaky-ReLU
# pre-activation of the exact-sum run within bf16 rounding of 0) whose
# cotangent is off by more than
# compare.KINK_TOL of the largest point's is excused, and a gate with more
# such points than compare.kink_cap fails (1 % of the points, and no more
# than the plain version's own count on the draw and compare.KINK_SLACK;
# tools/point_spread.py: at 96
# rays the worst 10 points carry 90-100 % of a bf16 run's squared distance
# from exact sums, the kernel's and the plain version's alike); every
# other point keeps the gates, and dW is held over every ray. At the kink
# points where a side's gx is off, that side is held against the
# reference on its own branch (``_plain_ref``): the rays holding the
# kernel's carry 79-100 % of its squared dW distance from exact sums on
# the cases' draws, and a flipped unit moves its dW columns by the whole
# slope (point_spread.py).


def _level_kinks(plain, args):
    """(P,) bool: the kink points of the level whose bf16 backward
    ``plain`` (K6's or K2's plain version) runs on ``args``, from the
    activations of its forward with exact sums."""
    i = next(i for i, a in enumerate(args) if isinstance(a, k5.LevelWeights))
    return compare.kink_points(level_exact.exact_acts(
        k5.nerf_raw_plain, *args[:4], *args[i:i + 3]))


def _kink_gate(a, b, kinks, ref_off=None):
    """(cotangent ``a`` keeps the bf16 point gate against ``b``, what it
    read): the kink points off by more than compare.KINK_TOL are excused,
    at most compare.kink_cap of them (given ``ref_off``, the plain
    version's own count of such points against ``b``, no more than it and
    compare.KINK_SLACK);
    every other point keeps the L2-relative distance and the cosine."""
    off = compare.excused_points(a, b, kinks)
    n, cap = int(off.sum()), compare.kink_cap(len(off), ref_off)
    e = point_errors(a[~off], b[~off], 1e-4)
    ok = n <= cap and e["l2_rel"] <= 1e-2 and e["cosine"] >= 0.9999
    return ok, {"excused": n, "cap": cap, **e}


def _points_ok(a, b, f32, kinks=None):
    """A point cotangent's gate: float32 at most POINT_FLIPS points off
    and the cosine; bfloat16 the L2-relative distance and the cosine, by
    ``_kink_gate`` when ``kinks`` is given."""
    if f32:
        e = point_errors(a, b, 1e-4)
        assert e["n_over"] <= POINT_FLIPS and e["cosine"] >= 0.9999, e
    elif kinks is not None:
        ok, e = _kink_gate(a, b, kinks)
        assert ok, e
    else:
        e = point_errors(a, b, 1e-4)
        assert e["l2_rel"] <= 1e-2 and e["cosine"] >= 0.9999, e


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,with_bg,with_noise", [
    (16, True, True), (64, True, False), (128, False, True)])
def test_nerf_level_vjp_kernel_matches_plain(card, rng, grid_varied, compute_dtype, S,
                                             with_bg, with_noise):
    """K6 against its plain version. Without a background the level is
    ``grid_varied``'s, whose sigma gradient is not a cancelled sum."""
    dev, model, _, level = card
    if not with_bg:
        level = grid_varied
    R = 96
    args = _level_case(dev, model, rng, R, S, with_bg, with_noise, compute_dtype)
    rgb_p, w_p = k5.nerf_level_plain(*args, level, compute_dtype, GRID)
    g_rgb, g_w = _loss_cotangents(dev, rng, rgb_p, w_p)
    vargs = args + (g_rgb, g_w, level, compute_dtype, GRID)
    before = k2.nerf_level_vjp.launches
    out_k = gx_k, gse_k, gbg_k, g_k = k2.nerf_level_vjp(*vargs)
    f32 = compute_dtype == "float32"
    kinks = None if f32 else _level_kinks(k2.nerf_level_vjp_plain, vargs)
    gx_p, gse_p, gbg_p, g_p = _plain_ref(k2.nerf_level_vjp_plain, *vargs, out_k=out_k,
                                         kinks=kinks)
    torch.cuda.synchronize()
    assert k2.nerf_level_vjp.launches == before + 1
    assert all(bool(torch.isfinite(t).all()) for t in (gx_k, gse_k))
    for a, b in ((gx_k, gx_p), (gse_k, gse_p)):
        _points_ok(a, b, f32, kinks)
    if with_bg:
        _points_ok(gbg_k, gbg_p, f32)
    assert (gbg_k is None) == (not with_bg)
    _grads_ok(g_k, g_p, compute_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("out", ["gx", "gse"])
def test_kink_gate_fails_a_fault_in_one_tile(card, rng, out):
    """The kink gate of bf16 K6's point cotangents refuses a fault limited
    to one 64-point tile: at the Queue-3 case's size (96 rays x 64, a
    background, no noise), the kernel's own result with every point of one
    tile moved by 1e-2 of the largest point's norm (far past KINK_TOL,
    each point off as a tile computed from a wrong operand would be)."""
    dev, model, _, level = card
    R, S = 96, 64
    args = _level_case(dev, model, rng, R, S, True, False, "bfloat16")
    rgb_p, w_p = k5.nerf_level_plain(*args, level, "bfloat16", GRID)
    g_rgb, g_w = _loss_cotangents(dev, rng, rgb_p, w_p)
    vargs = args + (g_rgb, g_w, level, "bfloat16", GRID)
    k = k2.nerf_level_vjp(*vargs)[("gx", "gse").index(out)]
    x = level_exact.exact_plain(k2.nerf_level_vjp_plain, *vargs)[("gx", "gse").index(out)]
    kinks = _level_kinks(k2.nerf_level_vjp_plain, vargs)
    ref_off = _plain_kink_count(vargs, ("gx", "gse").index(out), x, kinks)
    torch.cuda.synchronize()
    bad = k.clone()
    tile = slice(10 * 64, 11 * 64)
    step = torch.ones_like(bad[0]) / bad.shape[1] ** 0.5
    bad[tile] += 1e-2 * float(x.norm(dim=1).max()) * step
    assert bool(compare.excused_points(bad, x, torch.ones_like(kinks))[tile].all())
    ok, e = _kink_gate(bad, x, kinks, ref_off)
    assert not ok, e


def _plain_kink_count(vargs, i, x, kinks) -> int:
    """The reference's own count on K6's draw ``vargs``: the kink points at
    which bf16 K6's plain version's output ``i`` is off the exact sums
    ``x`` by more than compare.KINK_TOL (compare.kink_cap's bound)."""
    return int(compare.excused_points(k2.nerf_level_vjp_plain(*vargs)[i], x, kinks).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("out", ["gx", "gse"])
def test_kink_gate_fails_a_fault_in_half_a_tile(card, rng, out):
    """As test_kink_gate_fails_a_fault_in_one_tile, with 32 points of one
    64-point tile moved (ROADMAP Queue 3). Against the share alone the
    half tile passed: 44-45 points excused with the 13 natural ones, under
    the cap of 61 at 6,144 points. The cap is now also the plain
    version's own count on the draw (29-35 here) and compare.KINK_SLACK:
    the kernel's own result keeps the gate and the half tile fails it."""
    dev, model, _, level = card
    R, S = 96, 64
    args = _level_case(dev, model, rng, R, S, True, False, "bfloat16")
    rgb_p, w_p = k5.nerf_level_plain(*args, level, "bfloat16", GRID)
    g_rgb, g_w = _loss_cotangents(dev, rng, rgb_p, w_p)
    vargs = args + (g_rgb, g_w, level, "bfloat16", GRID)
    i = ("gx", "gse").index(out)
    k = k2.nerf_level_vjp(*vargs)[i]
    x = level_exact.exact_plain(k2.nerf_level_vjp_plain, *vargs)[i]
    kinks = _level_kinks(k2.nerf_level_vjp_plain, vargs)
    ref_off = _plain_kink_count(vargs, i, x, kinks)
    torch.cuda.synchronize()
    ok, e = _kink_gate(k, x, kinks, ref_off)
    assert ok, e
    bad = k.clone()
    tile = slice(10 * 64, 10 * 64 + 32)
    step = torch.ones_like(bad[0]) / bad.shape[1] ** 0.5
    bad[tile] += 1e-2 * float(x.norm(dim=1).max()) * step
    assert bool(compare.excused_points(bad, x, torch.ones_like(kinks))[tile].all())
    ok, e = _kink_gate(bad, x, kinks, ref_off)
    assert not ok, e


def _queue3_gates(kernel, out_k, args, kinks):
    """(bf16 K6's, K2's or K8's results ``out_k`` keep the grid-free Queue-3
    test's gates on ``args``, what failed): the exact-sum rule and the kink
    gate (``_plain_ref``), the point gates and the dW gate against the
    reference, and K2's composited colours."""
    try:
        gbg_k = gbg_p = None
        if kernel == "K6":
            gx_p, _, gbg_p, g_p = _plain_ref(k2.nerf_level_vjp_plain, *args,
                                             out_k=out_k, kinks=kinks)
            gx_k, gbg_k, g_k = out_k[0], out_k[2], out_k[3]
        elif kernel == "K8":
            gx_p, _, g_p = _plain_ref(k2.nerf_rayd_vjp_plain, *args, out_k=out_k,
                                      kinks=kinks)
            gx_k, g_k = out_k[0], out_k[2]
        else:
            rgb_p, _, gx_p, _, gbg_p, g_p = _plain_ref(k2.nerf_level_train_plain, *args,
                                                       out_k=out_k, kinks=kinks)
            assert _rel(out_k[0], rgb_p) <= 2e-2
            gx_k, gbg_k, g_k = out_k[2], out_k[4], out_k[5]
        _points_ok(gx_k, gx_p, False, kinks)
        if gbg_k is not None:
            _points_ok(gbg_k, gbg_p, False)
        _grads_ok(g_k, g_p, "bfloat16")
    except AssertionError as e:
        return False, str(e)[:300]
    return True, ""


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["tile", "half tile", "weight slice"])
@pytest.mark.parametrize("kernel", ["K6", "K2", "K8"])
def test_kink_branch_reference_fails_planted_faults(grid_free, request, kernel, fault):
    """The Queue-3 case (grid-free, 96 rays x 16, a background, sigma
    noise) whose reference takes the kernel's own branch at the excused
    kink points (``_plain_ref``), for K6, K2 and K8: the kernel passes its
    gates, and fails them with every point of one 64-point tile, or of half
    of one, moved by 1e-2 of the largest point's norm in gx, or with rows
    16-31 of trunk[1]'s weights left out of its forward blob. The kernels
    take the draw of the node id without the kernel's name (K6's draw
    before K2 and K8 had cases here); K8 the cotangent of its raw field
    from the same loss."""
    dev, _, level = grid_free
    rng = np.random.RandomState(zlib.crc32(
        request.node.nodeid.replace(f"[{kernel}-", "[").encode()))
    R, S = 96, 16
    args = _grid_free_case(dev, rng, R, S, True, True)
    rgb_p, w_p = k5.nerf_level_plain(*args, level, "bfloat16", None)
    g_rgb, g_w = _loss_cotangents(dev, rng, rgb_p, w_p)
    if kernel == "K6":
        plain, call, gx, extra = k2.nerf_level_vjp_plain, k2.nerf_level_vjp, 0, (g_rgb, g_w)
        tail = ()
    elif kernel == "K8":
        # the cotangent of raw from the same colour loss, through the plain
        # compositing of the plain raw field
        raw = k5.nerf_raw_plain(*args[:4], level, "bfloat16", None).detach().requires_grad_()
        rgb_r, _ = k5.composite_plain(raw.reshape(R, S, 16), args[4], args[1], args[5],
                                      args[6])
        (graw,) = torch.autograd.grad(rgb_r, raw, g_rgb)
        plain, call, gx = k2.nerf_rayd_vjp_plain, k2.nerf_rayd_vjp, 0
        args, extra, tail = args[:4], (graw,), ()
    else:
        tgt = _gpu(dev, np.concatenate([rng.rand(R, 3),
                                        np.eye(12)[rng.randint(0, 12, R)]], 1))
        lw = _gpu(dev, np.stack([np.full(R, 1.0 / R), np.full(R, 0.02 / R)], 1))
        plain, call, gx, extra = k2.nerf_level_train_plain, k2.nerf_level_train, 2, (tgt, lw)
        tail = (0.5,)
    kargs = args + extra + (level, "bfloat16", None) + tail
    kinks = _level_kinks(plain, kargs)
    out_k = call(*kargs)
    ok, why = _queue3_gates(kernel, out_k, kargs, kinks)
    assert ok, why
    if fault == "weight slice":
        faulty = dataclasses.replace(level, _blobs={})
        plan = k2.level_train_plan(faulty, torch.bfloat16)
        w, b, meta = plan.fwd
        w1, k1_, _, _, n = meta.reshape(-1, 7)[1, :5].tolist()
        assert k1_ >= 32
        w = w.clone()
        w[w1 + 16 * n:w1 + 32 * n] = 0
        faulty._blobs[("train", torch.bfloat16)] = dataclasses.replace(plan, fwd=(w, b, meta))
        kargs = args + extra + (faulty, "bfloat16", None) + tail
        bad = call(*kargs)
    else:
        x = level_exact.exact_plain(plain, *kargs)[gx]
        g = out_k[gx].clone()
        tile = slice(10 * 64, 10 * 64 + (64 if fault == "tile" else 32))
        g[tile] += 1e-2 * float(x.norm(dim=1).max()) / g.shape[1] ** 0.5
        bad = tuple(out_k[:gx]) + (g,) + tuple(out_k[gx + 1:])
    torch.cuda.synchronize()
    ok, why = _queue3_gates(kernel, bad, kargs, kinks)
    assert not ok


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [64, 128])
def test_ablation_level_kernels_match_plain(card, rng, compute_dtype, S):
    """K5 and K6 at the widths of configs/expression/person_1_ablation.yml
    (no deformation: the points themselves, PW = 3, rows from
    _cell_geometry; 15 PE frequencies; a 4x256 trunk) against their plain
    versions, with a background prior, sigma noise and loss cotangents."""
    import os
    from sahs_tpu_torch.config import load_config
    dev, _, _, _ = card
    cfg = load_config(os.path.join(os.path.dirname(__file__), "..", "configs",
                                   "expression", "person_1_ablation.yml"))
    spec = nerface.ModelSpec.from_config(cfg)
    model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
    with torch.no_grad():
        model.coarse.fc_alpha.bias.fill_(0.5)
    _, pts_g, dir_g = nerface.build_pe_groups(spec)
    level = k5.prepare_level(model.coarse, _gpu(dev, rng.randn(76) * 0.5), pts_g, dir_g)
    R = 96
    pts, dirs, table, _, z, bg, noise = _level_case(dev, model, rng, R, S, True, True,
                                                    compute_dtype)
    pts = pts[:, :3].contiguous()
    rows = _cell_geometry(pts, GRID)[0].to(torch.int32).reshape(R, S)
    args = (pts, dirs, table, rows, z, bg, noise, level, compute_dtype, GRID)
    rgb_k, w_k = k5.nerf_level_forward(*args)
    rgb_p, w_p = k5.nerf_level_plain(*args)
    g_rgb, g_w = _loss_cotangents(dev, rng, rgb_p, w_p)
    vargs = args[:7] + (g_rgb, g_w) + args[7:]
    out_k = gx_k, gse_k, gbg_k, g_k = k2.nerf_level_vjp(*vargs)
    f32 = compute_dtype == "float32"
    gx_p, gse_p, gbg_p, g_p = _plain_ref(k2.nerf_level_vjp_plain, *vargs, out_k=out_k)
    torch.cuda.synchronize()
    for a, b in ((rgb_k, rgb_p), (w_k, w_p)):
        assert torch.isfinite(a).all()
        if f32:
            assert float((a - b).abs().max()) <= 1e-4
    if not f32:
        ok, d = _level_exact((rgb_k, w_k), (rgb_p, w_p),
                             level_exact.exact_plain(k5.nerf_level_plain, *args))
        assert ok, d
    assert gx_k.shape == (R * S, 3)
    for a, b in ((gx_k, gx_p), (gse_k, gse_p)):
        _points_ok(a, b, f32)
    _points_ok(gbg_k, gbg_p, f32)
    _grads_ok(g_k, g_p, compute_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [16, 128])
def test_nerf_rayd_kernels_match_plain(card, rng, compute_dtype, S):
    """K7 against its plain version, then K8 from the cotangent of a loss
    composited from K7's plain output. In bf16 K8's point cotangents take
    the kink gate and each side is held on its own branch at its off kink
    points, as K6's and K2's (ROADMAP Queue 3: at 96 rays x 16 about ten
    leaky-ReLU units of 4.7 M flip at a kink and carry the whole distance on
    some draws)."""
    from sahs_tpu_torch.ops.rendering import volume_render_radiance_field
    dev, model, _, level = card
    R = 96
    pts, dirs, table, rows, z, bg, _ = _level_case(dev, model, rng, R, S, True,
                                                   False, compute_dtype)
    counts = (k5.nerf_rayd_forward.launches, k2.nerf_rayd_vjp.launches)
    raw_k = k5.nerf_rayd_forward(pts, dirs, table, rows, level, compute_dtype, GRID)
    raw_p = k5.nerf_raw_plain(pts, dirs, table, rows, level, compute_dtype, GRID)
    torch.cuda.synchronize()
    assert raw_k.shape == (R * S, 16) and torch.isfinite(raw_k).all()
    if compute_dtype == "float32":
        assert float((raw_k - raw_p).abs().max()) <= 1e-4
    else:
        assert _scaled(raw_k, raw_p) <= 2e-2
    raw = raw_p.clone().requires_grad_()
    r3 = raw.reshape(R, S, 16)
    r3 = torch.cat([r3[:, :-1], torch.cat([bg, r3[:, -1:, -1]], -1)[:, None]], 1)
    out = volume_render_radiance_field(r3, z, dirs, background_prior=bg)
    g_rgb, _ = _loss_cotangents(dev, rng, out.rgb.detach(), out.weights.detach())
    (g,) = torch.autograd.grad(out.rgb, raw, g_rgb[:, :15])
    rargs = (pts, dirs, table, rows, g, level, compute_dtype, GRID)
    out_k = gx_k, gse_k, g_k = k2.nerf_rayd_vjp(*rargs)
    f32 = compute_dtype == "float32"
    kinks = None if f32 else _level_kinks(k2.nerf_rayd_vjp_plain, rargs)
    gx_p, gse_p, g_p = _plain_ref(k2.nerf_rayd_vjp_plain, *rargs, out_k=out_k, kinks=kinks)
    torch.cuda.synchronize()
    assert (k5.nerf_rayd_forward.launches, k2.nerf_rayd_vjp.launches) == (
        counts[0] + 1, counts[1] + 1)
    _points_ok(gx_k, gx_p, f32, kinks)
    _points_ok(gse_k, gse_p, f32, kinks)
    _grads_ok(g_k, g_p, compute_dtype)


@pytest.mark.cuda
def test_grid_dg_coords_kernel_matches_plain(card, rng):
    """K9 on sample-major points inside the grid, on cell faces, on the
    grid's faces and outside it."""
    dev, _, _, _ = card
    P = 50000
    pts = rng.uniform(-1.1, 1.1, (P, 5))
    pts[:500, :3] = 2.0 * rng.randint(0, 32, (500, 3)) / 31.0 - 1.0
    pts[500:504, :3] = [[-1, -1, -1], [1, 1, 1], [1.2, 0, 0], [0, 0, 1.0000001]]
    pts, g = _gpu(dev, pts), _gpu(dev, rng.randn(P, 32))
    before = k4.grid_dg_coords.launches
    dg_k = k4.grid_dg_coords(pts, g, (32,) + GRID)
    dg_p = k4.grid_dg_coords_plain(pts, g, (32,) + GRID)
    torch.cuda.synchronize()
    assert k4.grid_dg_coords.launches == before + 1
    _grads_ok(dg_k, dg_p, "float32")


FALLBACK_KERNELS = {"deform_pair_forward": (k1, k1.deform_pair_plain),
                    "deform_pair_vjp": (k1, k1.deform_pair_vjp_plain),
                    "nerf_level_forward": (field_grid, k5.nerf_level_plain),
                    "nerf_level_vjp": (field_grid, k2.nerf_level_vjp_plain),
                    "nerf_rayd_forward": (field_grid, k5.nerf_raw_plain),
                    "nerf_rayd_vjp": (field_grid, k2.nerf_rayd_vjp_plain),
                    "grid_dg_coords": (field_grid, k4.grid_dg_coords_plain),
                    "nerf_mlp_forward_fused": (field_grid, k11.nerf_mlp_plain),
                    "nerf_mlp_vjp": (field_grid, k2.nerf_mlp_vjp_plain),
                    "grid_bwd_fused": (k4, k4.grid_bwd_fused_plain),
                    "skip_mlp_forward": (k13, k13.skip_mlp_plain),
                    "skip_mlp_vjp": (k13, k13.skip_mlp_vjp_plain)}
FUSED_KERNELS = [(fused, "deform_pair_forward", k1.deform_pair_plain),
                 (fused, "deform_pair_vjp", k1.deform_pair_vjp_plain),
                 (fused, "grid_dg", k4.grid_dg_plain),
                 (fused, "grid_dg_coords", k4.grid_dg_coords_plain),
                 (fused, "build_pts", k15.build_pts_plain),
                 (k2, "nerf_level_train", k2.nerf_level_train_plain)]
COUNTERS = {"K1": k1.deform_pair_forward, "K2": k2.nerf_level_train,
            "K3": k1.deform_pair_vjp, "K4": k4.grid_dg,
            "K5": k5.nerf_level_forward, "K6": k2.nerf_level_vjp,
            "K7": k5.nerf_rayd_forward, "K8": k2.nerf_rayd_vjp,
            "K9": k4.grid_dg_coords, "K10": k4.grid_bwd_fused,
            "K11": k11.nerf_mlp_forward_fused, "K12": k2.nerf_mlp_vjp,
            "K13": k13.skip_mlp_forward, "K14": k13.skip_mlp_vjp,
            "K15": k15.build_pts}


def _f32_step(dev, monkeypatch, plain, fused_grads, fuse_composite=True,
              samples=(64, 64), use_pallas=True, models=()):
    """One float32 flagship train step, 256 rays of a 64 x 64 frame, Sc +
    Sn ``samples``, seeded draws, ``models`` fields (sub, field, value) set
    on the config; the fallback's kernels swapped for their plain versions
    and the fused path's when ``plain``. Returns (loss, {name: grad}, {K:
    launches})."""
    from sahs_tpu_torch.data.synthetic import SyntheticFaceDataset
    from sahs_tpu_torch.train import stage1
    from sahs_tpu_torch.train.fused import TrainDraws
    Sc, Sn = samples
    cfg = Config()
    cfg.nerf.train.num_random_rays = 256
    cfg.nerf.train.num_coarse, cfg.nerf.train.num_fine = Sc, Sn
    cfg.runtime.compute_dtype = "float32"
    cfg.runtime.fused_grads = fused_grads
    cfg.runtime.fuse_composite = fuse_composite
    cfg.runtime.use_pallas = use_pallas
    for sub, field, value in models:
        setattr(getattr(cfg.models, sub), field, value)
    spec = nerface.ModelSpec.from_config(cfg)
    ts = stage1.TrainSettings.from_config(cfg)
    ds = SyntheticFaceDataset(kind="audio", num_frames=1, H=64, W=64,
                              near=cfg.dataset.near, far=cfg.dataset.far)
    batch = dict(ds[0], background=ds.background())
    gen = torch.Generator().manual_seed(3)
    draws = TrainDraws(*[t.to(dev) for t in (
        -torch.log(-torch.log(torch.rand(64 * 64, generator=gen).clamp_min(1e-20))),
        torch.rand((256, Sc), generator=gen), torch.rand((256, Sn), generator=gen),
        torch.randn((256, Sc), generator=gen), torch.randn((256, Sc + Sn), generator=gen))])
    st = stage1.init_train_state(spec, ts, seed=0, device=dev)
    with torch.no_grad():
        for lvl in (st.model.coarse, st.model.fine):
            lvl.fc_alpha.bias.fill_(0.5)
    before = {k: f.launches for k, f in COUNTERS.items()}
    with monkeypatch.context() as mp:
        if plain:
            for name, (mod, f) in FALLBACK_KERNELS.items():
                mp.setattr(mod, name, f)
            for mod, name, f in FUSED_KERNELS:
                mp.setattr(mod, name, f)
        st, m = stage1.make_train_step(spec, ts, device=dev)(st, batch, draws=draws)
    launches = {k: f.launches - before[k] for k, f in COUNTERS.items()}
    return float(m["loss"]), {n: p.grad for n, p in st.model.named_parameters()}, launches


@pytest.mark.cuda
@pytest.mark.parametrize("fuse_composite", [True, False])
def test_fallback_step_kernel_path_matches_plain_path(card, monkeypatch,
                                                      fuse_composite):
    """One float32 fallback step (fused_grads off) through the kernels
    against the same step on their plain versions: fuse_composite on (K1,
    K5, then K6, K9, K3) and off (K1, K7, then K8, K9, K3)."""
    dev = card[0]
    loss_k, g_k, l_k = _f32_step(dev, monkeypatch, False, False, fuse_composite)
    loss_p, g_p, l_p = _f32_step(dev, monkeypatch, True, False, fuse_composite)
    want = ({"K1": 2, "K3": 2, "K5": 2, "K6": 2, "K9": 2} if fuse_composite
            else {"K1": 2, "K3": 2, "K7": 2, "K8": 2, "K9": 2})
    assert l_k == {k: want.get(k, 0) for k in COUNTERS}
    assert not any(l_p.values())
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    _grads_ok(g_k, g_p, "step")


@pytest.mark.cuda
def test_fused_step_matches_fallback_step(card, monkeypatch):
    """The fused step (K1, K2, K3, K4) against the fallback step (K1, K5,
    K6, K9, K3), both through the kernels, float32, the same draws: the
    same forward, sums in another order, so every leaf within 1e-4
    L2-relative and at 0.9999 cosine (chip_smoke.FUSED_VS_FALLBACK; far
    inside ROADMAP's fused-vs-autograd ceiling of 5e-2)."""
    dev = card[0]
    loss_f, g_f, l_f = _f32_step(dev, monkeypatch, False, True)
    loss_b, g_b, _ = _f32_step(dev, monkeypatch, False, False)
    assert l_f["K2"] == 2 and l_f["K6"] == 0
    assert abs(loss_f - loss_b) <= 1e-5 * abs(loss_b)
    e = tree_errors(g_f, g_b)
    assert e["l2_rel"] <= 1e-4 and e["cosine"] >= 0.9999, e



# ---------------------------------------------------------------------------
# The per-point branch's kernels: K10 (the grid sample's backward), K11 (the
# per-point field) and K12 (its backward), and the steps that run them.
# Gates as the fallback's above; K10, linear in g with the same roundings
# on both sides, within 1e-5 in float32 and 2e-3 in bfloat16.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_grid_bwd_fused_kernel_matches_plain(card, rng, compute_dtype):
    """K10 on packed (P, 5) points inside the grid, on cell faces, on the
    grid's faces and outside it, from the corner rows the forward gathers:
    dG and dcoords."""
    dev, model, _, _ = card
    P = 50000
    pts = rng.uniform(-1.1, 1.1, (P, 5))
    pts[:500, :3] = 2.0 * rng.randint(0, 32, (500, 3)) / 31.0 - 1.0
    pts[500:504, :3] = [[-1, -1, -1], [1, 1, 1], [1.2, 0, 0], [0, 0, 1.0000001]]
    pts, g = _gpu(dev, pts), _gpu(dev, rng.randn(P, 32))
    dtype = torch.float32 if compute_dtype == "float32" else torch.bfloat16
    table = pack_corner_table(model.spatial_embeddings.detach(), dtype=dtype)
    vals = table[_cell_geometry(pts, GRID)[0]]
    shape = (32,) + GRID
    before = k4.grid_bwd_fused.launches
    dg_k, dc_k = k4.grid_bwd_fused(shape, pts, g, vals, compute_dtype)
    dg_p, dc_p = k4.grid_bwd_fused_plain(shape, pts, g, vals, compute_dtype)
    torch.cuda.synchronize()
    assert k4.grid_bwd_fused.launches == before + 1
    gate = 1e-5 if compute_dtype == "float32" else 2e-3
    for a, b in ((dg_k, dg_p), (dc_k, dc_p)):
        e = tree_errors(a, b)
        assert e["l2_rel"] <= gate and e["cosine"] >= 0.9999, e


# ---------------------------------------------------------------------------
# The binned grid backward (csrc/grid_bwd.cu: K4, K9 and K10 share one dG
# routine): repeat launches bit for bit, the layouts of
# tests/torch_grid_util.py (a hot cell of 50,000 points, every point
# outside the band, the grid's faces), P = 1 and ragged P, other channel
# counts, and K9 on both point orders. Gates as the tests above: K4 and K9
# GRAD_GATES["float32"], K10 within 1e-5 in float32 and 2e-3 in bfloat16.
# ---------------------------------------------------------------------------

GRID_KINDS = ("K4", "K9", "K10 float32", "K10 bfloat16")


def _grid_case(dev, rng, kind, c, C=32):
    """(kernel call, plain call) of ``kind`` on packed points ``c`` (P, 5)
    numpy with a random cotangent of C channels (and K4's addend, K10's
    corner rows from a random grid): each returns (dG, dcoords or None)."""
    P = len(c)
    pts, g = _gpu(dev, c), _gpu(dev, rng.randn(P, C))
    shape = (C,) + GRID
    if kind == "K4":
        g2 = _gpu(dev, rng.randn(P, C))
        rows, _, _ = _cell_geometry(pts, GRID)
        return ((lambda: (k4.grid_dg(pts, rows, g, g2, shape), None)),
                (lambda: (k4.grid_dg_plain(pts, rows, g, g2, shape), None)))
    if kind == "K9":
        return ((lambda: (k4.grid_dg_coords(pts, g, shape), None)),
                (lambda: (k4.grid_dg_coords_plain(pts, g, shape), None)))
    dtype = kind.split()[1]
    grid = _gpu(dev, rng.randn(*shape) * 0.1)
    table = pack_corner_table(grid, dtype=torch.bfloat16 if dtype == "bfloat16"
                              else torch.float32)
    vals = table[_cell_geometry(pts, GRID)[0]]
    return ((lambda: k4.grid_bwd_fused(shape, pts, g, vals, dtype)),
            (lambda: k4.grid_bwd_fused_plain(shape, pts, g, vals, dtype)))


def _grid_ok(kind, out_k, out_p):
    """The kernel's (dG, dcoords) against the plain version's."""
    if not kind.startswith("K10"):
        _grads_ok(out_k[0], out_p[0], "float32")
        return
    gate = 1e-5 if kind.endswith("float32") else 2e-3
    for a, b in zip(out_k, out_p):
        e = tree_errors(a, b)
        assert e["l2_rel"] <= gate and e["cosine"] >= 0.9999, e


def _ray_points(rng, R, S):
    """(R * S, 5) ray-major points: R rays through the grid, S sorted
    samples each, as a step's fine level lays them out."""
    o = np.concatenate([rng.uniform(-0.8, 0.8, (R, 2)), np.full((R, 1), -1.1)], 1)
    d = np.concatenate([rng.uniform(-0.8, 0.8, (R, 2)), np.full((R, 1), 1.1)], 1) - o
    t = np.sort(rng.uniform(0.0, 1.0, (R, S)), axis=1)
    xyz = (o[:, None, :] + t[..., None] * d[:, None, :]).reshape(R * S, 3)
    return np.concatenate([xyz, rng.uniform(-1, 1, (R * S, 2))], 1).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", GRID_KINDS)
def test_grid_backward_repeats_bit_for_bit(card, rng, kind):
    """Two launches on the same inputs (ray-major points, some outside the
    grid) give dG, and K10's dcoords, equal bit for bit: the routine has no
    float atomics and sums every voxel in a fixed order."""
    fk, fp = _grid_case(card[0], rng, kind, _ray_points(rng, 400, 128))
    a, b = fk(), fk()
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0])
    if a[1] is not None:
        assert torch.equal(a[1], b[1])
    _grid_ok(kind, a, fp())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", GRID_KINDS)
@pytest.mark.parametrize("layout", torch_grid_util.LAYOUTS)
def test_grid_backward_layouts_match_plain(card, rng, layout, kind):
    """A hot cell (50,000 points in one cell and 8 elsewhere), every point
    outside the band (dG and dcoords exactly 0), and points on the grid's
    faces and on cell faces."""
    c = torch_grid_util.layout(layout, rng, 50008)
    fk, fp = _grid_case(card[0], rng, kind, c)
    counts = (k4.grid_dg.launches, k4.grid_dg_coords.launches,
              k4.grid_bwd_fused.launches)
    out_k, out_p = fk(), fp()
    torch.cuda.synchronize()
    assert sum(f.launches for f in (k4.grid_dg, k4.grid_dg_coords,
                                    k4.grid_bwd_fused)) == sum(counts) + 1
    assert torch.isfinite(out_k[0]).all()
    if layout == "all_outside":
        assert not out_k[0].any() and not out_p[0].any()
        if out_k[1] is not None:
            assert not out_k[1].any()
        return
    if layout == "hot_cell":
        assert torch_grid_util.hot_corners(out_k[0].cpu().numpy()).all()
    _grid_ok(kind, out_k, out_p)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", GRID_KINDS)
@pytest.mark.parametrize("P", [1, 4097, 12345])
def test_grid_backward_ragged_points_match_plain(card, rng, kind, P):
    """One point, one past two of the sort's 2048-key tiles, and a count
    that tiles nothing."""
    c = rng.uniform(-1.1, 1.1, (P, 5)).astype(np.float32)
    fk, fp = _grid_case(card[0], rng, kind, c)
    out_k, out_p = fk(), fp()
    torch.cuda.synchronize()
    assert out_k[0].shape == (32,) + GRID
    if not out_p[0].any():                  # the one point outside the band
        assert not out_k[0].any()
        return
    _grid_ok(kind, out_k, out_p)


@pytest.mark.cuda
def test_grid_dg_coords_frame_chunk_matches_plain(card, rng):
    """K9 at a frame chunk's 4,194,304 ray-major points (32,768 rays x
    128): 2,048 of the sort's tiles, whose digit offsets are scanned in
    work linear in the tiles. Within the float32 gate, and a second launch
    equal bit for bit."""
    dev = card[0]
    R, S = 32768, 128
    c, g = _gpu(dev, _ray_points(rng, R, S)), _gpu(dev, rng.randn(R * S, 32))
    shape = (32,) + GRID
    a, b = k4.grid_dg_coords(c, g, shape), k4.grid_dg_coords(c, g, shape)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _grads_ok(a, k4.grid_dg_coords_plain(c, g, shape), "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", GRID_KINDS)
@pytest.mark.parametrize("C", [5, 12, 64, 160])
def test_grid_backward_channels_match_plain(card, rng, kind, C):
    """Channel counts other than 32: not a multiple of 4 (one float a
    lane), a multiple of 4 but not of 8 (K10's bf16 dcoords one value a
    lane), 64, and 160 (past one warp's 128 channels a pass)."""
    c = rng.uniform(-1.1, 1.1, (20000, 5)).astype(np.float32)
    fk, fp = _grid_case(card[0], rng, kind, c, C)
    out_k, out_p = fk(), fp()
    torch.cuda.synchronize()
    assert out_k[0].shape == (C,) + GRID
    _grid_ok(kind, out_k, out_p)


@pytest.mark.cuda
def test_grid_dg_coords_is_order_free(card, rng):
    """K9 on ray-major points and on the same points sample-major
    (``torch_grid_util.sample_major``, the fallback's former layout): the same
    dG within the float32 gate."""
    dev = card[0]
    R, S = 2048, 128
    c, g = _gpu(dev, _ray_points(rng, R, S)), _gpu(dev, rng.randn(R * S, 32))
    ray_major = k4.grid_dg_coords(c, g, (32,) + GRID)
    by_sample = k4.grid_dg_coords(torch_grid_util.sample_major(c, R, S),
                                  torch_grid_util.sample_major(g, R, S), (32,) + GRID)
    torch.cuda.synchronize()
    _grads_ok(ray_major, by_sample, "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P", [1000, 96 * 48])
def test_nerf_mlp_kernels_match_plain(card, rng, compute_dtype, P):
    """K11 against its plain version on per-point inputs (P not a multiple
    of the 64-point tile, and 96 rays of 48), then K12 from the cotangent
    of a loss of K11's plain output."""
    dev, _, _, level = card
    pts = _gpu(dev, np.concatenate([rng.uniform(-1.05, 1.05, (P, 3)),
                                    rng.uniform(-1, 1, (P, 2))], 1))
    extra = _gpu(dev, np.concatenate([rng.randn(P, 3) * 0.1 + [0, 0, -1],
                                      rng.randn(P, 32) * 0.3], 1))
    counts = (k11.nerf_mlp_forward_fused.launches, k2.nerf_mlp_vjp.launches)
    raw_k = k11.nerf_mlp_forward_fused(pts, extra, level, compute_dtype)
    raw_p = k11.nerf_mlp_plain(pts, extra, level, compute_dtype)
    torch.cuda.synchronize()
    assert raw_k.shape == (P, 16) and torch.isfinite(raw_k).all()
    if compute_dtype == "float32":
        assert float((raw_k - raw_p).abs().max()) <= 1e-4
    else:
        assert _scaled(raw_k, raw_p) <= 2e-2
    tgt = _gpu(dev, rng.rand(P, 16))
    g = 2.0 * (torch.sigmoid(raw_p) - tgt) * torch.sigmoid(raw_p) * (
        1.0 - torch.sigmoid(raw_p)) / P
    out_k = gx_k, ge_k, g_k = k2.nerf_mlp_vjp(pts, extra, g, level, compute_dtype)
    gx_p, ge_p, g_p = _plain_ref(k2.nerf_mlp_vjp_plain, pts, extra, g, level,
                                 compute_dtype, out_k=out_k)
    torch.cuda.synchronize()
    assert (k11.nerf_mlp_forward_fused.launches, k2.nerf_mlp_vjp.launches) == (
        counts[0] + 1, counts[1] + 1)
    assert gx_k.shape == (P, 5) and ge_k.shape == (P, 35)
    f32 = compute_dtype == "float32"
    _points_ok(gx_k, gx_p, f32)
    _points_ok(ge_k, ge_p, f32)
    _grads_ok(g_k, g_p, compute_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("use_pallas", [True, False])
def test_pointwise_step_kernel_path_matches_plain_path(card, monkeypatch,
                                                       use_pallas):
    """One float32 step at 48 + 48 samples, which neither level's count
    tiles, through the kernels against the same step on their plain
    versions: the per-point branch at both levels (K1, K11, then K12, K10,
    K3), and with use_pallas off the plain path (K10 only)."""
    dev = card[0]
    kw = dict(samples=(48, 48), use_pallas=use_pallas)
    loss_k, g_k, l_k = _f32_step(dev, monkeypatch, False, False, **kw)
    loss_p, g_p, l_p = _f32_step(dev, monkeypatch, True, False, **kw)
    want = ({"K1": 2, "K3": 2, "K10": 2, "K11": 2, "K12": 2} if use_pallas
            else {"K10": 2})
    assert l_k == {k: want.get(k, 0) for k in COUNTERS}, l_k
    assert not any(l_p.values())
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    _grads_ok(g_k, g_p, "step")


# ---------------------------------------------------------------------------
# The one-net deformation kernels: K13 (one deformation MLP), K14 (its
# backward, dW and the raw points' cotangent) and K15 (the sample
# positions), and the warp-only and ambient-only steps that run K13/K14.
# Gates as above; K15 bit for bit.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("net", ["warp", "hyper"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P", [1000, 96 * 48])
def test_skip_mlp_kernels_match_plain(card, rng, net, compute_dtype, P):
    """K13 against its plain version on raw points (P not a multiple of
    the 64-point tile, and 96 rays of 48), the warp net (6x128, tanh, 3)
    and the hyper net (6x64, linear, 2); then K14's dW and the points'
    cotangent from the cotangent of a loss of K13's plain output (in bf16
    against exact sums, and within PLAIN_MULTIPLE of the plain version's
    distance to them)."""
    dev, model, _, _ = card
    cond = _gpu(dev, rng.randn(76 + 36) * 0.5)
    weights = k13.prepare_skip(getattr(model, net), cond,
                               nerface.build_pe_groups(model.spec)[0],
                               "tanh" if net == "warp" else "linear")
    pts = _gpu(dev, rng.uniform(-1.05, 1.05, (P, 3)))
    counts = (k13.skip_mlp_forward.launches, k13.skip_mlp_vjp.launches)
    y_k = k13.skip_mlp_forward(pts, weights, compute_dtype)
    y_p = k13.skip_mlp_plain(pts, weights, compute_dtype)
    torch.cuda.synchronize()
    out = 3 if net == "warp" else 2
    assert y_k.shape == (P, out) and torch.isfinite(y_k).all()
    if compute_dtype == "float32":
        assert float((y_k - y_p).abs().max()) <= 1e-4
    else:
        assert _scaled(y_k, y_p) <= 2e-2
    g = 2.0 * (y_p - _gpu(dev, rng.randn(P, out) * 0.1)) / P
    gx_k, g_k = k13.skip_mlp_vjp(pts, weights, g, True, compute_dtype)
    # in bf16 against exact sums (``_plain_ref``)
    gx_p, g_p = _plain_ref(k13.skip_mlp_vjp_plain, pts, weights, g, True,
                           compute_dtype, out_k=(gx_k, g_k))
    none, g_n = k13.skip_mlp_vjp(pts, weights, g, False, compute_dtype)
    torch.cuda.synchronize()
    assert (k13.skip_mlp_forward.launches, k13.skip_mlp_vjp.launches) == (
        counts[0] + 1, counts[1] + 2)
    assert gx_k.shape == (P, 3) and none is None
    # the points' cotangent: PE frequencies to 2^9 make it the sum of a
    # few large terms, so a bf16 pre-activation that rounds across a ReLU
    # kink moves its point's cotangent wholly, and at a thousand points one
    # such point alone is ~1 % of the L2 norm: in bf16 the count of points
    # off stands beside the L2 gate
    e = point_errors(gx_k, gx_p, 1e-4)
    assert e["cosine"] >= 0.9999 and (
        e["n_over"] <= POINT_FLIPS if compute_dtype == "float32"
        else e["l2_rel"] <= 1e-2 or e["n_over"] <= POINT_FLIPS), e
    _grads_ok(g_k, g_p, compute_dtype)
    _grads_ok(g_n, g_p, compute_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("R,S", [(2048, 64), (2048, 128), (37, 63)])
def test_build_pts_kernel_matches_points(card, rng, R, S):
    """K15 bit for bit against the fused step's PyTorch expression."""
    dev, _, _, _ = card
    ro = _gpu(dev, rng.randn(R, 3) * 0.3)
    rd = _gpu(dev, rng.randn(R, 3) * 0.1 + [0, 0, -1])
    z = _gpu(dev, np.sort(rng.uniform(0.2, 0.8, (R, S)), axis=-1))
    before = k15.build_pts.launches
    out = k15.build_pts(ro, rd, z)
    torch.cuda.synchronize()
    assert k15.build_pts.launches == before + 1
    assert torch.equal(out, k15.build_pts_plain(ro, rd, z))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["warp_only", "ambient_only"])
def test_one_net_step_kernel_path_matches_plain_path(card, monkeypatch, kind):
    """One float32 step of a one-net model through the kernels against the
    same step on their plain versions: the warp-only model at 48 + 48 (the
    per-point branch at both levels: K13, K11, then K12, K10, K14) and the
    ambient-only model at 64 + 64 (K13, K5, then K6, K9, K14)."""
    dev = card[0]
    if kind == "warp_only":
        kw = dict(samples=(48, 48), models=(("hyper", "use_ambient", False),))
        want = {"K13": 2, "K14": 2, "K10": 2, "K11": 2, "K12": 2}
    else:
        kw = dict(models=(("warp", "use_warp", False),))
        want = {"K13": 2, "K14": 2, "K5": 2, "K6": 2, "K9": 2}
    loss_k, g_k, l_k = _f32_step(dev, monkeypatch, False, True, **kw)
    loss_p, g_p, l_p = _f32_step(dev, monkeypatch, True, True, **kw)
    assert l_k == {k: want.get(k, 0) for k in COUNTERS}, l_k
    assert not any(l_p.values())
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    _grads_ok(g_k, g_p, "step")


# ---------------------------------------------------------------------------
# The grid-free forms: a model without the spatial-embedding grid runs K1
# without rows and K2, K5-K8, K11 and K12 with C = 0 (no corner table, no
# gse, the per-point extra input the direction alone), and its steps never
# launch K4, K9 or K10. Gates as above.
# ---------------------------------------------------------------------------

GRID_FREE = (("coarse", "use_spatial_embeddings", False),)


@pytest.fixture(scope="module")
def grid_free(card):
    """The grid-free flagship model on the card (sigma active, varied
    colours, as ``card``'s), its folded pair and coarse level; the
    conditioning from a random state of its own."""
    dev = card[0]
    cfg = Config()
    cfg.models.coarse.use_spatial_embeddings = False
    spec = nerface.ModelSpec.from_config(cfg)
    model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
    with torch.no_grad():
        model.coarse.fc_alpha.bias.fill_(0.5)
        model.coarse.fc_rgb.weight.mul_(100.0)
    cond = _gpu(dev, np.random.RandomState(1).randn(76 + 36) * 0.5)
    warp_g, pts_g, dir_g = nerface.build_pe_groups(spec)
    pair = k1.prepare_pair(model.warp, model.hyper, cond, warp_g)
    level = k5.prepare_level(model.coarse, cond[76:], pts_g, dir_g)
    assert model.spatial_embeddings is None and level.dir0_se.shape[0] == 0
    return dev, pair, level


@pytest.fixture(scope="module")
def grid_free_varied(grid_free):
    """The grid-free coarse level with colours that vary along a ray
    (tools/level_exact.coarse_level, tools/sigma_head.py). At the seeded
    init the trunk's biases dominate its deep activations and a ray's colour logits agree to 0.2 %; without
    a background every ray's weights add up to 1, sigma's gradient is a
    difference of a ray's colours, and it is rounding alone (in bfloat16
    either side reads 0.3-0.9 from a float64 run)."""
    return level_exact.coarse_level("varied", False, torch.float32, grid_free[0])[0]


@pytest.fixture(scope="module")
def grid_varied(card):
    """The grid model's coarse level with colours that vary along a ray, as
    ``grid_free_varied``'s (the same table: only the coarse MLP changes)."""
    return level_exact.coarse_level("varied", True, torch.float32, card[0])[0]


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_grid_free_deform_pair_kernel_matches_plain(grid_free, rng, compute_dtype):
    """K1 without rows (grid_dims None): the packed points alone."""
    dev, pair, _ = grid_free
    pts = _gpu(dev, rng.uniform(-0.6, 0.6, (300 * 16, 3)))
    before = k1.deform_pair_forward.launches
    out_k, rows_k = k1.deform_pair_forward(pts, pair, compute_dtype, 16, None)
    out_p, rows_p = k1.deform_pair_plain(pts, pair, compute_dtype, 16, None)
    torch.cuda.synchronize()
    assert k1.deform_pair_forward.launches == before + 1
    assert rows_k is None and rows_p is None and torch.isfinite(out_k).all()
    if compute_dtype == "float32":
        assert float((out_k - out_p).abs().max()) <= 1e-4
    else:
        out_x = level_exact.exact_plain(k1.deform_pair_plain, pts, pair,
                                        compute_dtype, 16, None)[0]
        ok, d = _pair_exact(pts, out_k, out_p, out_x)
        assert ok, d


def _grid_free_case(dev, rng, R, S, with_bg, with_noise):
    pts = _gpu(dev, np.concatenate([rng.uniform(-1.05, 1.05, (R * S, 3)),
                                    rng.uniform(-1, 1, (R * S, 2))], 1))
    dirs = _gpu(dev, rng.randn(R, 3) * 0.1 + [0, 0, -1])
    z = _gpu(dev, np.sort(rng.uniform(0.48, 1.08, (R, S)), axis=-1))
    bg = _gpu(dev, rng.rand(R, 15)) if with_bg else None
    noise = _gpu(dev, rng.randn(R, S) * 0.5) if with_noise else None
    return pts, dirs, None, None, z, bg, noise


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,with_bg,with_noise", [
    (16, True, True), (64, True, False), (128, False, True)])
def test_grid_free_level_kernels_match_plain(grid_free, rng, grid_free_varied,
                                             compute_dtype, S, with_bg,
                                             with_noise):
    """K5, K6 and K2 with C = 0 (no table, no rows): the composited
    outputs, gx, g_bg and dW; gse is None. Without a background the level
    is ``grid_free_varied``'s, whose sigma gradient is not a cancelled sum."""
    dev, _, level = grid_free
    if not with_bg:
        level = grid_free_varied
    R = 96
    args = _grid_free_case(dev, rng, R, S, with_bg, with_noise)
    f32 = compute_dtype == "float32"
    before = (k5.nerf_level_forward.launches, k2.nerf_level_vjp.launches,
              k2.nerf_level_train.launches)
    rgb_k, w_k = k5.nerf_level_forward(*args, level, compute_dtype, None)
    rgb_p, w_p = k5.nerf_level_plain(*args, level, compute_dtype, None)
    torch.cuda.synchronize()
    if f32:
        assert float((rgb_k - rgb_p).abs().max()) <= 1e-4
        assert float((w_k - w_p).abs().max()) <= 1e-4
    else:
        ok, d = _level_exact((rgb_k, w_k), (rgb_p, w_p), level_exact.exact_plain(
            k5.nerf_level_plain, *args, level, compute_dtype, None))
        assert ok, d
    g_rgb, g_w = _loss_cotangents(dev, rng, rgb_p, w_p)
    vargs = args + (g_rgb, g_w, level, compute_dtype, None)
    out_k = gx_k, gse_k, gbg_k, g_k = k2.nerf_level_vjp(*vargs)
    kinks = None if f32 else _level_kinks(k2.nerf_level_vjp_plain, vargs)
    gx_p, gse_p, gbg_p, g_p = _plain_ref(k2.nerf_level_vjp_plain, *vargs, out_k=out_k,
                                         kinks=kinks)
    torch.cuda.synchronize()
    assert gse_k is None and gse_p is None and torch.isfinite(gx_k).all()
    _points_ok(gx_k, gx_p, f32, kinks)
    if with_bg:
        _points_ok(gbg_k, gbg_p, f32)
    _grads_ok(g_k, g_p, compute_dtype)
    tgt = _gpu(dev, np.concatenate([rng.rand(R, 3),
                                    np.eye(12)[rng.randint(0, 12, R)]], 1))
    lw = _gpu(dev, np.stack([np.full(R, 1.0 / R), np.full(R, 0.02 / R)], 1))
    targs = args + (tgt, lw, level, compute_dtype, None, 0.5 if with_bg else 0.0)
    out_k = rgb_k, w_k, gx_k, gse_k, gbg_k, g_k = k2.nerf_level_train(*targs)
    kinks = None if f32 else _level_kinks(k2.nerf_level_train_plain, targs)
    rgb_p, w_p, gx_p, gse_p, gbg_p, g_p = _plain_ref(k2.nerf_level_train_plain, *targs,
                                                     out_k=out_k, kinks=kinks)
    torch.cuda.synchronize()
    assert (k5.nerf_level_forward.launches, k2.nerf_level_vjp.launches,
            k2.nerf_level_train.launches) == tuple(b + 1 for b in before)
    assert gse_k is None and gse_p is None
    if f32:
        assert float((rgb_k - rgb_p).abs().max()) <= 1e-4
    else:
        assert _rel(rgb_k, rgb_p) <= 2e-2
    _points_ok(gx_k, gx_p, f32, kinks)
    if with_bg:
        _points_ok(gbg_k, gbg_p, f32)
    _grads_ok(g_k, g_p, compute_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_grid_free_rayd_and_point_kernels_match_plain(grid_free, rng, compute_dtype):
    """K7 and K8 with C = 0, and K11 and K12 on the direction alone (extra
    (P, 3)), each backward from the cotangent of a loss of the plain
    forward."""
    dev, _, level = grid_free
    R, S = 96, 48
    pts, dirs, _, _, _, _, _ = _grid_free_case(dev, rng, R, S, False, False)
    f32 = compute_dtype == "float32"
    counts = [f.launches for f in (k5.nerf_rayd_forward, k2.nerf_rayd_vjp,
                                   k11.nerf_mlp_forward_fused, k2.nerf_mlp_vjp)]
    extra = dirs.repeat_interleave(S, dim=0)
    for fwd, fwd_p, vjp, vjp_p, args in (
            (k5.nerf_rayd_forward, k5.nerf_raw_plain, k2.nerf_rayd_vjp,
             k2.nerf_rayd_vjp_plain, (pts, dirs, None, None)),
            (k11.nerf_mlp_forward_fused, k11.nerf_mlp_plain, k2.nerf_mlp_vjp,
             k2.nerf_mlp_vjp_plain, (pts, extra))):
        tail = (level, compute_dtype) + ((None,) if len(args) == 4 else ())
        raw_k, raw_p = fwd(*args, *tail), fwd_p(*args, *tail)
        torch.cuda.synchronize()
        assert raw_k.shape == (R * S, 16) and torch.isfinite(raw_k).all()
        if f32:
            assert float((raw_k - raw_p).abs().max()) <= 1e-4
        else:
            assert _scaled(raw_k, raw_p) <= 2e-2
        tgt = _gpu(dev, rng.rand(R * S, 16))
        sig = torch.sigmoid(raw_p)
        g = 2.0 * (sig - tgt) * sig * (1.0 - sig) / (R * S)
        out_k = gx_k, g2_k, g_k = vjp(*args, g, *tail)
        gx_p, g2_p, g_p = _plain_ref(vjp_p, *args, g, *tail, out_k=out_k)
        torch.cuda.synchronize()
        _points_ok(gx_k, gx_p, f32)
        if len(args) == 4:
            assert g2_k is None and g2_p is None        # no gse
        else:
            assert g2_k.shape == (R * S, 3)             # gextra: the direction's
            _points_ok(g2_k, g2_p, f32)
        _grads_ok(g_k, g_p, compute_dtype)
    assert [f.launches for f in (k5.nerf_rayd_forward, k2.nerf_rayd_vjp,
                                 k11.nerf_mlp_forward_fused, k2.nerf_mlp_vjp)
            ] == [c + 1 for c in counts]


# path -> (_f32_step's arguments, the launches of one step)
GRID_FREE_STEPS = {
    "fused": (dict(fused_grads=True), {"K1": 2, "K2": 2, "K3": 1, "K15": 2}),
    "fallback": (dict(fused_grads=False), {"K1": 2, "K3": 2, "K5": 2, "K6": 2}),
    "reuse": (dict(fused_grads=False, fuse_composite=False),
              {"K1": 2, "K3": 2, "K7": 2, "K8": 2}),
    "per_point": (dict(fused_grads=True, samples=(64, 128)),
                  {"K1": 2, "K3": 2, "K5": 1, "K6": 1, "K11": 1, "K12": 1}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(GRID_FREE_STEPS))
def test_grid_free_step_kernel_path_matches_plain_path(card, monkeypatch, path):
    """One float32 step of the grid-free model through the kernels against
    the same step on their plain versions, on each of its paths; no K4,
    K9 or K10."""
    dev = card[0]
    kw, want = GRID_FREE_STEPS[path]
    kw = dict(kw, models=GRID_FREE)
    fused_grads = kw.pop("fused_grads")
    loss_k, g_k, l_k = _f32_step(dev, monkeypatch, False, fused_grads, **kw)
    loss_p, g_p, l_p = _f32_step(dev, monkeypatch, True, fused_grads, **kw)
    assert l_k == {k: want.get(k, 0) for k in COUNTERS}, l_k
    assert not any(l_p.values())
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    _grads_ok(g_k, g_p, "step")


@pytest.mark.cuda
def test_grid_free_fused_step_matches_fallback_step(card, monkeypatch):
    """The grid-free fused step (K2 with C = 0) against its fallback step
    (K5/K6), both through the kernels: within FUSED_VS_FALLBACK."""
    dev = card[0]
    loss_f, g_f, l_f = _f32_step(dev, monkeypatch, False, True, models=GRID_FREE)
    loss_b, g_b, _ = _f32_step(dev, monkeypatch, False, False, models=GRID_FREE)
    assert l_f["K2"] == 2 and l_f["K4"] == 0
    assert abs(loss_f - loss_b) <= 1e-5 * abs(loss_b)
    e = tree_errors(g_f, g_b)
    assert e["l2_rel"] <= 1e-4 and e["cosine"] >= 0.9999, e


# ---------------------------------------------------------------------------
# The tools' experiment kernels X1-X6 against their plain versions, at
# 16,384 rows: X2 and X3 to float32 summation order (1e-6 L2-relative),
# X1's row sums within 1e-3 L2-relative and the worst row within 1e-2 of
# the largest, X4-X6 within 1e-3 L2-relative and 5e-2 on every entry.
# ---------------------------------------------------------------------------

def _l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.cuda
def test_exp_gather_kernels_match_plain(card):
    from sahs_tpu_torch.tools import exp_gather as xg
    dev = card[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = 16384
    counts = [f.launches for f in (xg.chain_rows, xg.dg_rows, xg.chunk_rows)]
    for n_layers, H in xg.CHAIN_CASES:
        x, w = xg.chain_inputs(H, gen, dev, rows)
        a, b = xg.chain_rows(x, w, n_layers), xg.chain_plain(x, w, n_layers)
        assert _l2(a, b) <= 1e-3 and _scaled(a, b) <= 1e-2
    for L, dt, n in xg.DG_CASES:
        x, idx = xg.dg_inputs(L, dt, gen, dev, rows)
        assert _l2(xg.dg_rows(x, idx, n), xg.dg_plain(x, idx, n)) <= 1e-6
    for N, L, dt in xg.CHUNK_CASES:
        tab, idx = xg.chunk_inputs(N, L, dt, gen, dev, rows)
        idx[::97] = N + 5
        a, b = xg.chunk_rows(tab, idx), xg.chunk_plain(tab, idx)
        assert not a[::97].any() and _l2(a, b) <= 1e-6
    torch.cuda.synchronize()
    assert [f.launches for f in (xg.chain_rows, xg.dg_rows, xg.chunk_rows)] == [
        counts[0] + 3, counts[1] + 4, counts[2] + 3]


# X2 (csrc/exp_gather.cu:dg_kernel): one persistent block an SM walks its
# tiles' column groups through a TMA-filled ring. The four DG_CASES, n
# = 1 in bf16 (one gather: a lane a row), n = 3 and 5 (the two lanes of a
# column word split the gathers unevenly), n = 0 and L = 160 (five bf16
# groups of 32 columns), at 16 tiles (a block each) and at 140 tiles
# (more than the card's 132 SMs: a block walks two, its ring running on
# from one tile into the next): within 1e-6 of the plain version (the same
# values summed in another order), the same bits on a second launch, and
# every index moved by one (phase 15's planted fault) outside that gate.
@pytest.mark.cuda
@pytest.mark.parametrize("L,dt,n,tiles", [
    (128, "float32", 1, 16), (128, "float32", 8, 16), (128, "bfloat16", 8, 16),
    (256, "float32", 8, 16), (128, "float32", 3, 16), (160, "bfloat16", 5, 16),
    (128, "float32", 0, 16), (128, "float32", 8, 140), (128, "bfloat16", 1, 140)])
def test_exp_dg_kernel_cases(card, rng, L, dt, n, tiles):
    from sahs_tpu_torch.tools import exp_gather as xg
    dev = card[0]
    rows = tiles * xg.TILE
    x = torch.from_numpy(rng.standard_normal((rows, L)).astype(np.float32)).to(
        dev).to(getattr(torch, dt))
    idx = torch.from_numpy(rng.randint(0, xg.TILE, (rows, L)).astype(np.int32)).to(dev)
    before = xg.dg_rows.launches
    a = xg.dg_rows(x, idx, n)
    again = xg.dg_rows(x, idx, n)
    fault = xg.dg_rows(x, (idx + 1) % xg.TILE, n)
    b = xg.dg_plain(x, idx, n)
    torch.cuda.synchronize()
    assert xg.dg_rows.launches == before + 3
    assert a.shape == (rows, 1) and a.dtype == torch.float32
    assert torch.equal(a, again)
    if n == 0:
        assert not a.any() and not fault.any()
        return
    assert _l2(a, b) <= 1e-6, _l2(a, b)
    assert _l2(fault, b) > 1e-6, _l2(fault, b)


@pytest.mark.cuda
def test_exp_pair2_kernels_match_plain(card):
    from sahs_tpu_torch.tools import exp_pair2 as xp
    dev = card[0]
    x, x2, ws, ws2 = xp.inputs(torch.Generator(device=dev).manual_seed(2), dev,
                               16384)
    counts = [f.launches for f in (xp.narrow_call, xp.paired_call, xp.reshape_call)]
    for a, b in ((xp.narrow_call(x, ws), xp.narrow_plain(x, ws)),
                 (xp.paired_call(x2, ws2), xp.paired_plain(x2, ws2)),
                 (xp.reshape_call(x, ws2, "reshape"), xp.reshape_plain(x, ws2, "reshape")),
                 (xp.reshape_call(x, ws2, "strided"), xp.reshape_plain(x, ws2, "strided"))):
        assert a.shape == b.shape and a.dtype == torch.bfloat16
        assert _l2(a.float(), b.float()) <= 1e-3
        assert float((a.float() - b.float()).abs().max()) <= 5e-2
    torch.cuda.synchronize()
    assert [f.launches for f in (xp.narrow_call, xp.paired_call, xp.reshape_call)] == [
        counts[0] + 1, counts[1] + 1, counts[2] + 2]


# The multi-step loop (train/stage1.make_multi_train_step): K = 3 flagship
# steps (2048 rays, 64 + 64, bf16, the fused path's kernels) on stacked
# synthetic frames against 3 single train_step calls on one generator of
# the same seed: the same launches a step, and every parameter, Adam moment
# and metric bit for bit (the step's kernels are deterministic: the grid
# backward bins without float atomics).
@pytest.mark.cuda
def test_multi_step_matches_single_steps_on_the_card(card):
    from sahs_tpu_torch.data.synthetic import SyntheticFaceDataset
    from sahs_tpu_torch.train import stage1
    dev = card[0]
    cfg = Config()
    spec, ts = nerface.ModelSpec.from_config(cfg), stage1.TrainSettings.from_config(cfg)
    ds = SyntheticFaceDataset(kind="audio", num_frames=3, H=96, W=96,
                              near=cfg.dataset.near, far=cfg.dataset.far)
    items, bg = [ds[j] for j in (2, 0, 1)], ds.background()
    a = stage1.init_train_state(spec, ts, seed=0, background=bg, device=dev)
    b = stage1.init_train_state(spec, ts, seed=0, background=bg, device=dev)
    held = (k1.deform_pair_forward, k2.nerf_level_train, k1.deform_pair_vjp, k4.grid_dg,
            k15.build_pts)
    before = [f.launches for f in held]
    a, ma = stage1.make_multi_train_step(spec, ts, device=dev)(
        a, stage1.stack_batches(items, bg, device=dev),
        generator=torch.Generator(device=dev).manual_seed(3))
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(held, before)] == [6, 6, 3, 3, 6]
    step = stage1.make_train_step(spec, ts, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    losses = []
    for item in items:
        b, mb = step(b, dict(item, background=bg), generator=gen)
        losses.append(mb["loss"])
    assert torch.equal(ma["loss"], torch.stack(losses))
    assert a.step == b.step == 3 and torch.equal(a.sample_prob, b.sample_prob)
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a.optimizer.state[p][k], b.optimizer.state[q][k]), (name, k)


# X1 and X4-X6 run persistent blocks (one an SM) that walk 64-row tiles
# staged by TMA: the last tile part empty must read as zeros and write no
# row past the end (the output buffer is longer, its tail a sentinel), and
# at H = 512, 65,553 rows (1,025 tiles, 513 tile pairs) make each of the
# card's blocks walk about four pairs, with W streamed anew for each.
SENTINEL_ROWS = 64


@pytest.mark.cuda
@pytest.mark.parametrize("n_layers,H,rows", [
    (8, 256, 16383), (16, 256, 16383), (8, 512, 16383), (8, 512, 65553)])
def test_exp_chain_kernel_ragged_tile_and_sweeps(card, n_layers, H, rows):
    from sahs_tpu_torch.tools import exp_gather as xg
    dev = card[0]
    x, w = xg.chain_inputs(H, torch.Generator(device=dev).manual_seed(3), dev, rows)
    out = torch.full((rows + SENTINEL_ROWS, 1), 7.0, device=dev)
    xg._chain_launch(x, w, n_layers, out)
    b = xg.chain_plain(x, w, n_layers)
    torch.cuda.synchronize()
    a = out[:rows]
    assert bool((out[rows:] == 7.0).all())
    assert _l2(a, b) <= 1e-3 and _scaled(a, b) <= 1e-2, (_l2(a, b), _scaled(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["narrow", "paired", "reshape"])
def test_exp_pair2_kernel_ragged_tile(card, case):
    """X4 at 16,383 rows; X5 at 8,191 rows; X6 on 16,382 input rows (8,191
    output rows): within the gates of the plain version, no row written
    past the end."""
    from sahs_tpu_torch.tools import exp_pair2 as xp
    dev = card[0]
    x, _, ws, ws2 = xp.inputs(torch.Generator(device=dev).manual_seed(4), dev, 16384)
    x = x[:16383] if case == "narrow" else x[:16382]
    arg, weights, mode, H, plain = {
        "narrow": (x, ws, xp._ROWS, 64, lambda: xp.narrow_plain(x, ws)),
        "paired": (x[:8191], ws2, xp._ROWS, 128, lambda: xp.paired_plain(x[:8191], ws2)),
        "reshape": (x, ws2, xp._PAIRED, 128, lambda: xp.reshape_plain(x, ws2, "reshape")),
    }[case]
    R = arg.shape[0] // 2 if mode == xp._PAIRED else arg.shape[0]
    out = torch.full((R + SENTINEL_ROWS, 128), 7.0, device=dev, dtype=torch.bfloat16)
    xp._launch(case, arg, weights, mode, H, out)
    b = plain()
    torch.cuda.synchronize()
    a = out[:R]
    assert bool((out[R:] == 7.0).all())
    assert _l2(a.float(), b.float()) <= 1e-3
    assert float((a.float() - b.float()).abs().max()) <= 5e-2


# ---------------------------------------------------------------------------
# The bf16 level backward on the tensor cores (csrc/mma.cuh): K2, K6, K8
# and K12 at a step's fine-level size with the last 64-point tile part
# empty (2047 rays x 127 samples), with and without a background, with the
# grid and grid-free (dir0's K = 27), against the plain versions with exact
# sums (``_plain_ref``) at chip_smoke.py's TRAIN_BF16_GATES; and two faults
# planted in the new code, each of which must miss them. At the card
# tests' usual 96 rays the plain version with float32 arithmetic itself
# reads up to 5.6e-3 (with a background) and 1.7e-2 (without) from exact
# sums on its worst dW leaf outside the sigma head (tools/level_exact.py),
# so the 2e-3 gate needs a step's size. The card fixture's levels; inputs
# from a random state of their own, so that the draw does not depend on
# which tests ran before.
# ---------------------------------------------------------------------------

# chip_smoke.TRAIN_BF16_GATES: composited outputs within out_rel, per-point
# cotangents within point_l2_rel, every dW leaf within l2_rel and cosine
TC_GATES = {"out_rel": 2e-2, "point_l2_rel": 1e-2, "l2_rel": 2e-3, "cosine": 0.9999}
TC_R, TC_S = 2047, 127


def _tc_points_ok(a, b) -> bool:
    e = point_errors(a, b, 1e-4)
    return e["l2_rel"] <= TC_GATES["point_l2_rel"] and e["cosine"] >= TC_GATES["cosine"]


def _tc_dw_ok(a, b) -> bool:
    e = tree_errors(a, b)
    return e["l2_rel"] <= TC_GATES["l2_rel"] and e["cosine"] >= TC_GATES["cosine"]


@pytest.fixture(scope="module")
def tc_levels(card, grid_free):
    """grid -> (folded coarse level, model): the card fixture's flagship
    level and the grid-free one."""
    _, model, _, level = card
    return {True: (level, model), False: (grid_free[2], None)}


@pytest.fixture(scope="module")
def tc_varied(grid_varied, grid_free_varied):
    """grid -> the level whose colours vary along a ray, on which K2's
    sigma head without a background is held at a step's size."""
    return {True: grid_varied, False: grid_free_varied}


def _tc_inputs(dev, rng, model, grid, with_bg):
    """pts, dirs, table, rows, z, bg, noise at TC_R x TC_S (table and rows
    None without the grid)."""
    P = TC_R * TC_S
    pts = _gpu(dev, np.concatenate([rng.uniform(-1.05, 1.05, (P, 3)),
                                    rng.uniform(-1, 1, (P, 2))], 1))
    dirs = _gpu(dev, rng.randn(TC_R, 3) * 0.1 + [0, 0, -1])
    z = _gpu(dev, np.sort(rng.uniform(0.48, 1.08, (TC_R, TC_S)), axis=-1))
    bg = _gpu(dev, rng.rand(TC_R, 15)) if with_bg else None
    noise = _gpu(dev, rng.randn(TC_R, TC_S) * 0.5)
    table = rows = None
    if grid:
        table = pack_corner_table(model.spatial_embeddings.detach(),
                                  dtype=torch.bfloat16)
        rows = _cell_geometry(pts, GRID)[0]
    return pts, dirs, table, rows, z, bg, noise


def _tc_cotangents(dev, rng, rgb_map, w, z):
    """Cotangents of the colour loss of ``_loss_cotangents`` plus an L2
    loss of the expected depth sum_s w z: without a background every ray's
    weights add up to 1 and sigma's gradient from the colours alone is a
    difference of a ray's nearly equal colours (rounding); the depth term
    gives it a part that is not."""
    g_rgb, g_w = _loss_cotangents(dev, rng, rgb_map, w)
    R = w.shape[0]
    depth = (w * z).sum(-1, keepdim=True)
    target = _gpu(dev, rng.uniform(0.5, 1.0, (R, 1)))
    return g_rgb, g_w + 2.0 * (depth - target) * z / R


def _tc_rayd_cotangent(rng, dev, raw, z, dirs, bg):
    """The cotangent of raw (P, 16) from the loss of ``_tc_cotangents`` of
    its composited colours and weights."""
    from sahs_tpu_torch.ops.rendering import volume_render_radiance_field
    raw = raw.clone().requires_grad_()
    r3 = raw.reshape(TC_R, TC_S, 16)
    if bg is not None:
        r3 = torch.cat([r3[:, :-1], torch.cat([bg, r3[:, -1:, -1]], -1)[:, None]], 1)
    out = volume_render_radiance_field(r3, z, dirs, background_prior=bg)
    g_rgb, g_w = _tc_cotangents(dev, rng, out.rgb.detach(), out.weights.detach(), z)
    (g,) = torch.autograd.grad((out.rgb, out.weights), raw,
                               (g_rgb[:, :out.rgb.shape[1]], g_w))
    return g


def _tc_check(out_k, out_p, n_points, dw_index, skip_sigma=False):
    for a, b in zip(out_k[:n_points], out_p[:n_points]):
        assert (a is None) == (b is None)
        assert a is None or _tc_points_ok(a, b), point_errors(a, b)
    g_k, g_p = out_k[dw_index], out_p[dw_index]
    if skip_sigma:
        g_k, g_p = _without_sigma_head(g_k), _without_sigma_head(g_p)
    assert _tc_dw_ok(g_k, g_p), tree_errors(g_k, g_p)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [True, False])
@pytest.mark.parametrize("with_bg", [True, False])
def test_tensor_core_level_kernels_match_plain(tc_levels, tc_varied, grid, with_bg):
    """K2, K6, K8 and K12 in bf16 at 2047 x 127 points against their plain
    versions (exact sums), at chip_smoke's TRAIN_BF16_GATES, every output
    and every dW leaf. K2 without a background: its sigma head's dW on the
    level whose colours vary along a ray (``tc_varied``), the rest on the
    flagship level. At a step's size each level conditions only its own
    part (tools/level_exact.py, PERF.md section 6): on the flagship level
    sigma's gradient is a difference of a ray's nearly equal colours and
    its head reads 0.2-41 % from exact sums in the plain version itself,
    while on the varied level the plain version's gx reads 1.7-2.0 % and
    its trunk's dW 8e-3-9e-3."""
    level, model = tc_levels[grid]
    dev = level.dir0_b.device
    rng = np.random.RandomState(11 + 2 * grid + with_bg)
    args = _tc_inputs(dev, rng, model, grid, with_bg)
    pts, dirs, table, rows, z, bg, noise = args
    dims = GRID if grid else None
    P = TC_R * TC_S
    assert P % k2.TP_BF16
    counts = [f.launches for f in (k2.nerf_level_train, k2.nerf_level_vjp,
                                   k2.nerf_rayd_vjp, k2.nerf_mlp_vjp)]
    # K2
    tgt = _gpu(dev, np.concatenate([rng.rand(TC_R, 3),
                                    np.eye(12)[rng.randint(0, 12, TC_R)]], 1))
    lw = _gpu(dev, np.stack([np.full(TC_R, 1.0 / TC_R), np.full(TC_R, 0.02 / TC_R)], 1))
    targs = args + (tgt, lw, level, "bfloat16", dims, 0.5 if with_bg else 0.0)
    out_k = k2.nerf_level_train(*targs)
    out_p = _plain_ref(k2.nerf_level_train_plain, *targs, out_k=out_k,
                       skip_sigma=not with_bg)
    torch.cuda.synchronize()
    assert _rel(out_k[0], out_p[0]) <= TC_GATES["out_rel"]
    assert _rel(out_k[1], out_p[1]) <= TC_GATES["out_rel"]
    assert all(t is None or bool(torch.isfinite(t).all()) for t in out_k[:5])
    _tc_check(out_k[2:], out_p[2:], 3, 3, skip_sigma=not with_bg)
    if not with_bg:
        vargs_k2 = targs[:9] + (tc_varied[grid],) + targs[10:]
        out_v = k2.nerf_level_train(*vargs_k2)
        head_k = out_v[5]["fc_alpha"]
        head_p = _plain_ref(k2.nerf_level_train_plain, *vargs_k2, out_k=out_v)[5]["fc_alpha"]
        torch.cuda.synchronize()
        assert _tc_dw_ok(head_k, head_p), tree_errors(head_k, head_p)
    # K6, from the cotangents of a loss of the plain forward
    rgb_p, w_p = k5.nerf_level_plain(*args, level, "bfloat16", dims)
    g_rgb, g_w = _tc_cotangents(dev, rng, rgb_p, w_p, z)
    vargs = args + (g_rgb, g_w, level, "bfloat16", dims)
    out_k = k2.nerf_level_vjp(*vargs)
    out_p = _plain_ref(k2.nerf_level_vjp_plain, *vargs, out_k=out_k)
    torch.cuda.synchronize()
    _tc_check(out_k, out_p, 3, 3)
    # K8, from the cotangent of a loss composited from the plain raw field
    raw_p = k5.nerf_raw_plain(pts, dirs, table, rows, level, "bfloat16", dims)
    g = _tc_rayd_cotangent(rng, dev, raw_p, z, dirs, bg)
    rargs = (pts, dirs, table, rows, g, level, "bfloat16", dims)
    out_k = k2.nerf_rayd_vjp(*rargs)
    out_p = _plain_ref(k2.nerf_rayd_vjp_plain, *rargs, out_k=out_k)
    torch.cuda.synchronize()
    _tc_check(out_k, out_p, 2, 2)
    # K12 on per-point inputs: [dir | se] (the grid) or the direction alone
    C = level.dir0_se.shape[0]
    extra = torch.cat([dirs.repeat_interleave(TC_S, dim=0),
                       _gpu(dev, rng.randn(P, C) * 0.3)], 1)
    raw_p = k11.nerf_mlp_plain(pts, extra, level, "bfloat16")
    sig = torch.sigmoid(raw_p)
    g = 2.0 * (sig - _gpu(dev, rng.rand(P, 16))) * sig * (1.0 - sig) / P
    out_k = k2.nerf_mlp_vjp(pts, extra, g, level, "bfloat16")
    out_p = _plain_ref(k2.nerf_mlp_vjp_plain, pts, extra, g, level, "bfloat16",
                       out_k=out_k)
    torch.cuda.synchronize()
    assert out_k[1].shape == (P, 3 + C)
    _tc_check(out_k, out_p, 2, 2)
    assert [f.launches for f in (k2.nerf_level_train, k2.nerf_level_vjp,
                                 k2.nerf_rayd_vjp, k2.nerf_mlp_vjp)
            ] == [counts[0] + 1 + (not with_bg)] + [c + 1 for c in counts[1:]]


def _k12_case(tc_levels):
    """K12's inputs at TC_R x TC_S points on the grid model's level, and the
    cotangent of a loss of its plain output."""
    level = tc_levels[True][0]
    dev = level.dir0_b.device
    rng = np.random.RandomState(17)
    P = TC_R * TC_S
    pts = _gpu(dev, np.concatenate([rng.uniform(-1.05, 1.05, (P, 3)),
                                    rng.uniform(-1, 1, (P, 2))], 1))
    extra = _gpu(dev, np.concatenate([rng.randn(P, 3) * 0.1 + [0, 0, -1],
                                      rng.randn(P, 32) * 0.3], 1))
    sig = torch.sigmoid(k11.nerf_mlp_plain(pts, extra, level, "bfloat16"))
    g = 2.0 * (sig - _gpu(dev, rng.rand(P, 16))) * sig * (1.0 - sig) / P
    return level, pts, extra, g


@pytest.mark.cuda
@pytest.mark.parametrize("blob,layer", [("fwd", 1), ("bwd", 10)])
def test_tensor_core_fault_weight_slice_misses_gates(tc_levels, blob, layer):
    """One 16-row K-slice of the weights the ring stages left out (rows
    16-31 of trunk[1] in the forward blob, or of feat^T in the transposed
    blob): K12's results must miss the gates its faultless run passes."""
    level, pts, extra, g = _k12_case(tc_levels)
    good = k2.nerf_mlp_vjp(pts, extra, g, level, "bfloat16")
    ref = _plain_ref(k2.nerf_mlp_vjp_plain, pts, extra, g, level, "bfloat16",
                     out_k=good)
    assert _tc_dw_ok(good[2], ref[2]), tree_errors(good[2], ref[2])
    faulty = dataclasses.replace(level, _blobs={})
    plan = k2.level_train_plan(faulty, torch.bfloat16)
    w, b, meta = getattr(plan, blob)
    w1, k1_, _, _, n = meta.reshape(-1, 7)[layer, :5].tolist()
    assert k1_ >= 32
    w = w.clone()
    w[w1 + 16 * n:w1 + 32 * n] = 0
    faulty._blobs[("train", torch.bfloat16)] = dataclasses.replace(
        plan, **{blob: (w, b, meta)})
    out = k2.nerf_mlp_vjp(pts, extra, g, faulty, "bfloat16")
    torch.cuda.synchronize()
    caught = [not _tc_points_ok(out[0], ref[0]), not _tc_dw_ok(out[2], ref[2])]
    assert any(caught), (point_errors(out[0], ref[0]), tree_errors(out[2], ref[2]))


@pytest.mark.cuda
def test_tensor_core_fault_split_k_chunk_misses_gates(tc_levels):
    """The points of the first chunk of the dW's point tiles dropped
    (csrc/level_dw.cuh: a block per work item and chunk; the plain dW over
    those points taken off K12's): must miss the dW gates."""
    level, pts, extra, g = _k12_case(tc_levels)
    P = pts.shape[0]
    n_tiles = -(-P // k2.TP_BF16)
    n = -(-n_tiles // k2.level_dw_chunks(n_tiles)) * k2.TP_BF16
    assert k2.level_dw_chunks(n_tiles) > 1 and n < P
    g_k = k2.nerf_mlp_vjp(pts, extra, g, level, "bfloat16")[2]
    g_p = _plain_ref(k2.nerf_mlp_vjp_plain, pts, extra, g, level, "bfloat16")[2]
    g_c = _plain_ref(k2.nerf_mlp_vjp_plain, pts[:n], extra[:n], g[:n], level,
                     "bfloat16")[2]
    torch.cuda.synchronize()
    assert _tc_dw_ok(g_k, g_p), tree_errors(g_k, g_p)
    dropped = _tree_sub(g_k, g_c)
    assert not _tc_dw_ok(dropped, g_p), tree_errors(dropped, g_p)


def _chunk_first_tiles(P):
    """The points of the first tile of every chunk of the bf16 level dW's
    point tiles (level_train.level_dw_chunks), and the points of the first
    chunk."""
    tp = k2.TP_BF16
    n_tiles = -(-P // tp)
    chunks = k2.level_dw_chunks(n_tiles)
    per = -(-n_tiles // chunks)
    assert chunks > 1
    first = torch.cat([torch.arange(c * per * tp, min(P, (c * per + 1) * tp))
                       for c in range(chunks) if c * per < n_tiles])
    return first, torch.arange(per * tp)


def _bias_sub(a, b):
    """``a`` with ``b``'s bias leaves ("b") taken off its own."""
    if isinstance(a, dict):
        return {k: a[k] - b[k] if k == "b" else _bias_sub(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return [_bias_sub(x, y) for x, y in zip(a, b)]
    return a


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["stash_block", "bias_partial"])
def test_tensor_core_fault_level_dw_misses_gates(tc_levels, fault):
    """Faults of the dW over the stash (csrc/level_dw.cuh), planted in K12's
    result: the first stash block (tile) of every chunk of point tiles
    dropped, as a producer that skipped it would (the plain dW over its
    points taken off), or the bias partials (the tiles' column sums of gz)
    of the first chunk dropped (the plain db over its points taken off db
    alone): each must miss the dW gates that the faultless result passes."""
    level, pts, extra, g = _k12_case(tc_levels)
    first, chunk = _chunk_first_tiles(pts.shape[0])
    idx = (first if fault == "stash_block" else chunk).to(pts.device)
    g_k = k2.nerf_mlp_vjp(pts, extra, g, level, "bfloat16")[2]
    g_p = _plain_ref(k2.nerf_mlp_vjp_plain, pts, extra, g, level, "bfloat16")[2]
    g_c = _plain_ref(k2.nerf_mlp_vjp_plain, pts[idx], extra[idx], g[idx], level,
                     "bfloat16")[2]
    torch.cuda.synchronize()
    assert _tc_dw_ok(g_k, g_p), tree_errors(g_k, g_p)
    dropped = _tree_sub(g_k, g_c) if fault == "stash_block" else _bias_sub(g_k, g_c)
    assert not _tc_dw_ok(dropped, g_p), tree_errors(dropped, g_p)


def _bwd_ring_stage_fault(level, q_fault):
    """A copy of ``level`` whose backward weight stages
    (``level_train.backward_stages``, which the wgmma backward tile streams)
    leave out one stage: the first 64 k of the first outputs of the tile's
    product ``q_fault`` (``level_train.backward_order``)."""
    faulty = dataclasses.replace(level, _blobs={})
    plan = k2.level_train_plan(faulty, torch.bfloat16)
    stages = k2.backward_stages(faulty, plan).clone()
    at = 0
    for q, _, _, _, _, rows, _ in k2.backward_stage_order(plan.descs_t, len(level.trunk),
                                                           level.skip):
        if q == q_fault:
            break
        at += rows * 64
    assert float(stages[at:at + rows * 64].float().abs().max()) > 0
    stages[at:at + rows * 64] = 0
    w = plan.bwd[0]
    faulty._blobs[("wgmma_bwd", torch.bfloat16)] = (w, w._version, stages)
    return faulty


@pytest.mark.cuda
@pytest.mark.parametrize("q", [2, 10])
def test_tensor_core_backward_fault_ring_stage_misses_gates(tc_levels, q):
    """One stage of the backward tile's ring left out (the first 64 k of
    dir2^T's outputs, product 2, or of feat^T's first 128, product 10):
    K12's results must miss the gates that its faultless run passes."""
    level, pts, extra, g = _k12_case(tc_levels)
    good = k2.nerf_mlp_vjp(pts, extra, g, level, "bfloat16")
    ref = _plain_ref(k2.nerf_mlp_vjp_plain, pts, extra, g, level, "bfloat16", out_k=good)
    assert _tc_points_ok(good[0], ref[0]) and _tc_points_ok(good[1], ref[1])
    assert _tc_dw_ok(good[2], ref[2]), tree_errors(good[2], ref[2])
    out = k2.nerf_mlp_vjp(pts, extra, g, _bwd_ring_stage_fault(level, q), "bfloat16")
    torch.cuda.synchronize()
    caught = [not _tc_points_ok(out[0], ref[0]), not _tc_points_ok(out[1], ref[1]),
              not _tc_dw_ok(out[2], ref[2])]
    assert any(caught), (point_errors(out[0], ref[0]), tree_errors(out[2], ref[2]))


@pytest.mark.cuda
def test_tensor_core_level_backward_repeats_bit_for_bit(tc_levels):
    """Two launches of bf16 K12 on the same inputs give the same bits: the
    backward tile's column sums and the dW's sums run in a fixed order."""
    level, pts, extra, g = _k12_case(tc_levels)
    a = k2.nerf_mlp_vjp(pts, extra, g, level, "bfloat16")
    b = k2.nerf_mlp_vjp(pts, extra, g, level, "bfloat16")
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a[2]), _leaves(b[2])))


@pytest.mark.cuda
def test_tensor_core_level_backward_keeps_a_ragged_last_tile(tc_levels):
    """A last tile that is only partly full (P = 64 x 300 + 17: 301 tiles, so
    the last pair's second warpgroup runs past the end too) gives bf16 K12
    the same results as the same points followed by 47 more whose
    cotangent is zero: the rows past P add nothing to dW, db or the point
    cotangents, and the tiles, chunks and sums are the same."""
    level, pts, extra, g = _k12_case(tc_levels)
    n, m = 64 * 300 + 17, 64 * 301
    a = k2.nerf_mlp_vjp(pts[:n], extra[:n], g[:n], level, "bfloat16")
    gz = g[:m].clone()
    gz[n:] = 0
    b = k2.nerf_mlp_vjp(pts[:m], extra[:m], gz, level, "bfloat16")
    torch.cuda.synchronize()
    assert torch.isfinite(a[0]).all() and torch.isfinite(a[1]).all()
    assert torch.equal(a[0], b[0][:n]) and torch.equal(a[1], b[1][:n])
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a[2]), _leaves(b[2])))


# ---------------------------------------------------------------------------
# The deformation nets' backward on wgmma (csrc/skip_bw.cuh, bf16 K3 and
# K14) and its dW (csrc/level_dw.cuh): faults planted in bf16 K3 and K14,
# each of which must miss the bf16 gates (GRAD_GATES) that the faultless
# kernel passes against exact sums. Inputs from a random state of their own.
# ---------------------------------------------------------------------------

def _deform_case(card, kernel):
    """(wrapper, plain version, plan function, arguments before the
    weights, weights, arguments after them) of bf16 K3 or K14 on the warp
    net (the points' cotangent asked for, the cotangent of a loss of K13's
    plain output) at P = 300 x 64 + 17 points."""
    dev, model, pair, _ = card
    rng = np.random.RandomState(29)
    P = 300 * 64 + 17
    if kernel == "K3":
        pts = _gpu(dev, rng.uniform(-0.6, 0.6, (P, 3)))
        g, g2 = _gpu(dev, rng.randn(P, 5) * 0.1), _gpu(dev, rng.randn(P, 5) * 0.1)
        return (k1.deform_pair_vjp, k1.deform_pair_vjp_plain, k1.pair_train_plan,
                (pts,), pair, (g, g2, "bfloat16"))
    cond = _gpu(dev, rng.randn(76 + 36) * 0.5)
    w = k13.prepare_skip(model.warp, cond, nerface.build_pe_groups(model.spec)[0], "tanh")
    pts = _gpu(dev, rng.uniform(-1.05, 1.05, (P, 3)))
    y = k13.skip_mlp_plain(pts, w, "bfloat16")
    g = 2.0 * (y - _gpu(dev, rng.randn(P, 3) * 0.1)) / P
    return (k13.skip_mlp_vjp, k13.skip_mlp_vjp_plain, k13.skip_train_plan,
            (pts,), w, (g, True, "bfloat16"))


def _deform_grads(out):
    """K3's gradient tree, or K14's (its second result)."""
    return out if isinstance(out, dict) else out[1]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,blob,layer", [
    ("K3", "fwd", 1), ("K3", "bwd", 7), ("K14", "fwd", 1), ("K14", "bwd", 1)])
def test_deform_net_fault_weight_slice_misses_gates(card, kernel, blob, layer):
    """One 16-row k-step of the weights the ring stages left out: rows
    16-31 of forward layer ``layer`` (the warp trunk[1]) or of transposed
    layer ``layer`` (K3: the hyper net's trunk[5]^T, a 64-wide product;
    K14: the warp net's trunk[5]^T). The faultless kernel passes the bf16
    gates against exact sums; the faulty one must miss them."""
    fn, plain, train_plan, pre, w, post = _deform_case(card, kernel)
    good = fn(*pre, w, *post)
    ref = _plain_ref(plain, *pre, w, *post)
    g_ref = _deform_grads(ref)
    assert _dw_within(_deform_grads(good), g_ref)
    faulty = dataclasses.replace(w, _blobs={})
    plan = train_plan(faulty, torch.bfloat16)
    wb, b, meta = getattr(plan, blob)
    w1, k1_, _, _, n = meta.reshape(-1, 7)[layer, :5].tolist()
    assert k1_ >= 32
    wb = wb.clone()
    wb[w1 + 16 * n:w1 + 32 * n] = 0
    faulty._blobs[("train", torch.bfloat16)] = dataclasses.replace(
        plan, **{blob: (wb, b, meta)})
    out = fn(*pre, faulty, *post)
    torch.cuda.synchronize()
    caught = not _dw_within(_deform_grads(out), g_ref)
    if kernel == "K14":
        e = point_errors(out[0], ref[0], 1e-4)
        caught = caught or not (e["l2_rel"] <= 1e-2 and e["cosine"] >= 0.9999)
    assert caught, tree_errors(_deform_grads(out), g_ref)


def _dw_within(a, b) -> bool:
    e = tree_errors(a, b)
    rel, cos = GRAD_GATES["bfloat16"]
    return e["l2_rel"] <= rel and e["cosine"] >= cos


@pytest.mark.cuda
def test_deform_net_fault_split_k_chunk_misses_gates(card):
    """The points of the first split-K chunk of bf16 K3's dW (64-point
    tiles) dropped, the plain dW over them taken off: must miss the bf16
    gates that the faultless kernel passes against exact sums."""
    from sahs_tpu_torch.ops.kernels.field_mlp import dw_chunks
    _, _, _, (pts,), pair, (g, g2, cdt) = _deform_case(card, "K3")
    P = pts.shape[0]
    n_tiles = -(-P // k2.TP_BF16)
    n = -(-n_tiles // dw_chunks(n_tiles)) * k2.TP_BF16
    assert dw_chunks(n_tiles) > 1 and n < P
    g_k = k1.deform_pair_vjp(pts, pair, g, g2, cdt)
    g_p = _plain_ref(k1.deform_pair_vjp_plain, pts, pair, g, g2, cdt)
    g_c = _plain_ref(k1.deform_pair_vjp_plain, pts[:n], pair, g[:n], g2[:n], cdt)
    torch.cuda.synchronize()
    assert _dw_within(g_k, g_p), tree_errors(g_k, g_p)
    dropped = _tree_sub(g_k, g_c)
    assert not _dw_within(dropped, g_p), tree_errors(dropped, g_p)


def _tree_sub(a, b):
    if isinstance(a, dict):
        return {k: _tree_sub(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return [_tree_sub(x, y) for x, y in zip(a, b)]
    return a - b


def _deform_backward_stage_fault(kernel, w, q_fault, need_gx):
    """A copy of ``w`` whose backward tile's transposed stages
    (``skip_mlp.backward_stages``) leave out one stage: the first 64 k of
    the outputs of the tile's transposed layer ``q_fault``
    (``skip_mlp.backward_stage_order``)."""
    faulty = dataclasses.replace(w, _blobs={})
    if kernel == "K3":
        plan = k1.pair_train_plan(faulty, torch.bfloat16, need_gx)
        nw, nh = len(w.warp_trunk), len(w.hyper_trunk)
        heads, trunks = [nw, nw + 1 + nh], [nw, nh]
    else:
        plan = k13.skip_train_plan(faulty, torch.bfloat16)
        heads = trunks = [len(w.trunk)]
    stages = k13.backward_stages(faulty, plan, heads, trunks, need_gx)[1].clone()
    at = 0
    for q, _, _, _, _, rows, _ in k13.backward_stage_order(plan.descs_t, trunks, need_gx):
        if q == q_fault:
            break
        at += rows * 64
    assert float(stages[at:at + rows * 64].float().abs().max()) > 0
    stages[at:at + rows * 64] = 0
    b = plan.bwd[0]
    faulty._blobs[(f"wgmma_train_bwd{int(need_gx)}", torch.bfloat16)] = (b, b._version, stages)
    return faulty


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,q", [("K3", 1), ("K3", 8), ("K14", 3), ("K14", 6)])
def test_deform_backward_fault_ring_stage_misses_gates(card, kernel, q):
    """One stage of the backward tile's ring left out: the first 64 k of
    a transposed layer's outputs (K3: the warp trunk[5]^T, product 1, or
    the hyper trunk[4]^T, product 8; K14 on the warp net with the points'
    cotangent: trunk[3]^T, product 3, or the layer back to the encoding,
    product 6): the results must miss the gates that the faultless run
    passes."""
    fn, plain, _, pre, w, post = _deform_case(card, kernel)
    good = fn(*pre, w, *post)
    ref = _plain_ref(plain, *pre, w, *post)
    assert _dw_within(_deform_grads(good), _deform_grads(ref))
    out = fn(*pre, _deform_backward_stage_fault(kernel, w, q, kernel == "K14"), *post)
    torch.cuda.synchronize()
    caught = not _dw_within(_deform_grads(out), _deform_grads(ref))
    if kernel == "K14":
        e = point_errors(out[0], ref[0], 1e-4)
        caught = caught or not (e["l2_rel"] <= 1e-2 and e["cosine"] >= 0.9999)
    assert caught, tree_errors(_deform_grads(out), _deform_grads(ref))


@pytest.mark.cuda
def test_deform_backward_fault_tile_column_sums_misses_gates(card):
    """One tile's column sums of gz dropped (bsum, db's only source), as
    an epilogue that skipped them would: the plain db over the tile's 64
    points taken off bf16 K3's db alone must miss the dW gates that the
    faultless result passes."""
    _, _, _, (pts,), pair, (g, g2, cdt) = _deform_case(card, "K3")
    tile = slice(64 * 10, 64 * 11)
    g_k = k1.deform_pair_vjp(pts, pair, g, g2, cdt)
    g_p = _plain_ref(k1.deform_pair_vjp_plain, pts, pair, g, g2, cdt)
    g_t = _plain_ref(k1.deform_pair_vjp_plain, pts[tile], pair, g[tile], g2[tile], cdt)
    torch.cuda.synchronize()
    assert _dw_within(g_k, g_p), tree_errors(g_k, g_p)
    dropped = _bias_sub(g_k, g_t)
    assert not _dw_within(dropped, g_p), tree_errors(dropped, g_p)


def _deform_gx_case(card, kernel):
    """(wrapper, points, weights, the arguments after them asking for the
    points' cotangent) of bf16 K3, K14 on raw points and K14 on the
    encoding, at P = 300 x 64 + 17 (the last of 301 tiles ragged)."""
    fn, _, _, (pts,), w, post = _deform_case(card, "K3" if kernel == "K3" else "K14")
    if kernel == "K3":
        return fn, pts, w, post + (True,)
    if kernel == "K14":
        return fn, pts, w, post
    dev, model, _, _ = card
    cond = _gpu(dev, np.random.RandomState(31).randn(76 + 36) * 0.5)
    w = k13.prepare_skip(model.warp, cond, None, "tanh")
    return fn, _encode(pts, nerface.build_pe_groups(model.spec)[0]), w, post


def _gx_of(out):
    return out[0]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K3", "K14", "K14 pre-encoded"])
def test_deform_backward_repeats_bit_for_bit(card, kernel):
    """Two launches of bf16 K3 and K14 (with the points' cotangent) on the
    same inputs give the same bits: the tile's column sums and the dW's
    sums run in a fixed order."""
    fn, pts, w, post = _deform_gx_case(card, kernel)
    a, b = fn(pts, w, *post), fn(pts, w, *post)
    torch.cuda.synchronize()
    assert torch.equal(_gx_of(a), _gx_of(b))
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a[1]), _leaves(b[1])))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K3", "K14", "K14 pre-encoded"])
def test_deform_backward_keeps_a_ragged_last_tile(card, kernel):
    """A last tile that is only partly full (P = 64 x 300 + 17: 301 tiles,
    so the last pair's second warpgroup runs past the end too) gives bf16
    K3 and K14 the same results as the same points followed by 47 more
    whose cotangent is zero: the rows past P add nothing to dW, db or the
    points' cotangent, and the tiles, chunks and sums are the same."""
    fn, pts, w, post = _deform_gx_case(card, kernel)
    n, m = pts.shape[0], 64 * 301
    more = pts[:m - n] * 0.5
    pad = lambda t: torch.cat([t, torch.zeros_like(t[:m - n])])
    post_m = tuple(pad(x) if isinstance(x, torch.Tensor) else x for x in post)
    a = fn(pts, w, *post)
    b = fn(torch.cat([pts, more]), w, *post_m)
    torch.cuda.synchronize()
    assert torch.isfinite(_gx_of(a)).all() and torch.equal(_gx_of(a), _gx_of(b)[:n])
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a[1]), _leaves(b[1])))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K3", "K14", "K14 pre-encoded"])
def test_deform_backward_writes_no_gx_row_past_p(card, kernel, monkeypatch):
    """bf16 K3 and K14 write the points' cotangent (P, 3), or the
    encoding's (P, 63), of their P rows and nothing past them: the
    wrapper's output is handed a view of a larger buffer whose rows past P
    hold a sentinel, and those rows keep it."""
    fn, pts, w, post = _deform_gx_case(card, kernel)
    P, width = pts.shape[0], 63 if kernel == "K14 pre-encoded" else 3
    empty, big = torch.empty, []

    def gx_in_big(*shape, **kw):
        if shape == ((P, width),) and kw.get("dtype") == torch.float32 and not big:
            big.append(empty((P + 64, width), dtype=torch.float32, device=kw["device"]))
            big[0].fill_(7.0)
            return big[0][:P]
        return empty(*shape, **kw)
    monkeypatch.setattr(torch, "empty", gx_in_big)
    out = fn(pts, w, *post)
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert big and _gx_of(out).data_ptr() == big[0].data_ptr()
    assert torch.isfinite(_gx_of(out)).all()
    assert bool((big[0][P:] == 7.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K3", "K14"])
def test_deform_backward_takes_trunks_a_multiple_of_8(kernel):
    """bf16 K3 and K14 on nets whose trunks are 72 (warp) and 40 (hyper)
    wide, which the forward tile of K1 and K13 refuses (multiples of
    skip_mlp.TC_K_STEP): the backward tile's stages are zero-padded to 64
    k and its epilogues guard the columns past the width, so it takes any
    multiple of 8; dW and the points' cotangent against the plain version
    with exact sums, within PLAIN_MULTIPLE of its distance to them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cfg = Config()
    cfg.models.warp.hidden_size, cfg.models.hyper.hidden_size = 72, 40
    spec = nerface.ModelSpec.from_config(cfg)
    model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
    rng = np.random.RandomState(37)
    cond = _gpu(dev, rng.randn(76 + 36) * 0.5)
    warp_g = nerface.build_pe_groups(spec)[0]
    P = 64 * 150 + 9
    pts = _gpu(dev, rng.uniform(-0.6, 0.6, (P, 3)))
    if kernel == "K3":
        w = k1.prepare_pair(model.warp, model.hyper, cond, warp_g)
        g, g2 = _gpu(dev, rng.randn(P, 5) * 0.1), _gpu(dev, rng.randn(P, 5) * 0.1)
        args = (pts, w, g, g2, "bfloat16", True)
        gx_k, g_k = k1.deform_pair_vjp(*args)
        gx_p, g_p = _plain_ref(k1.deform_pair_vjp_plain, *args, out_k=(gx_k, g_k))
        with pytest.raises(ValueError, match="multiples of 32"):
            k1.deform_pair_forward(pts, w, "bfloat16", 64, None)
    else:
        w = k13.prepare_skip(model.hyper, cond, warp_g, "linear")
        g = _gpu(dev, rng.randn(P, 2) * 0.1)
        args = (pts, w, g, True, "bfloat16")
        gx_k, g_k = k13.skip_mlp_vjp(*args)
        gx_p, g_p = _plain_ref(k13.skip_mlp_vjp_plain, *args, out_k=(gx_k, g_k))
        with pytest.raises(ValueError, match="multiples of 32"):
            k13.skip_mlp_forward(pts, w, "bfloat16")
    torch.cuda.synchronize()
    assert gx_k.shape == (P, 3)
    _points_ok(gx_k, gx_p, False)
    _grads_ok(g_k, g_p, "bfloat16")


# ---------------------------------------------------------------------------
# The bf16 forwards K7 and K11 on the tensor cores (field_tc_kernel of
# csrc/level_train.cu): the raw field against the plain version within the
# bf16 gate of each output group's scale, and against exact sums within
# PLAIN_MULTIPLE of the plain version's own distance in each group
# (_field_exact); the grid and grid-free levels, K7 at
# both levels' sample counts, K11 at a P that is not a multiple of the
# 64-point tile, with and without ambient coordinates.
# ---------------------------------------------------------------------------

FIELD_GATE = 2e-2   # the bf16 gate of PARITY_TPU.json, of each group's scale


@pytest.fixture(scope="module")
def no_ambient(card):
    """The flagship without ambient coordinates (models.hyper.use_ambient
    off: the packed point is the warped xyz alone, the trunk's input 63
    wide), its coarse level seeded as ``card``'s, and its corner table."""
    dev = card[0]
    cfg = Config()
    cfg.models.hyper.use_ambient = False
    spec = nerface.ModelSpec.from_config(cfg)
    model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
    with torch.no_grad():
        model.coarse.fc_alpha.bias.fill_(0.5)
        model.coarse.fc_rgb.weight.mul_(100.0)
    cond = _gpu(dev, np.random.RandomState(12).randn(36) * 0.5)
    _, pts_g, dir_g = nerface.build_pe_groups(spec)
    level = k5.prepare_level(model.coarse, cond, pts_g, dir_g)
    assert level.trunk[0]["w"].shape[0] == 63
    return level, pack_corner_table(model.spatial_embeddings.detach(),
                                    dtype=torch.bfloat16)


def _field_case(card, grid_free, no_ambient, kernel, grid, ambient, n, seed):
    """(wrapper, plain version, arguments) of bf16 K7 (96 rays x n samples)
    or K11 (n points) on the grid, grid-free or ambient-free level."""
    dev, model, _, level = card
    table = pack_corner_table(model.spatial_embeddings.detach(), dtype=torch.bfloat16)
    if not grid:
        level, table = grid_free[2], None
    elif not ambient:
        level, table = no_ambient
    rng = np.random.RandomState(seed)
    R = 96 if kernel == "K7" else n
    P = R * n if kernel == "K7" else n
    pts = _gpu(dev, np.concatenate([rng.uniform(-1.05, 1.05, (P, 3)),
                                    rng.uniform(-1, 1, (P, 2 if ambient else 0))], 1))
    dirs = _gpu(dev, rng.randn(R, 3) * 0.1 + [0, 0, -1])
    if kernel == "K7":
        rows = _cell_geometry(pts, GRID)[0] if grid else None
        return (k5.nerf_rayd_forward, k5.nerf_raw_plain,
                (pts, dirs, table, rows, level, "bfloat16", GRID if grid else None))
    C = level.dir0_se.shape[0]
    extra = torch.cat([dirs, _gpu(dev, rng.randn(P, C) * 0.3)], 1)
    return k11.nerf_mlp_forward_fused, k11.nerf_mlp_plain, (pts, extra, level, "bfloat16")


FIELD_CASES = [("K7", True, True, 64), ("K7", True, True, 128),
               ("K7", False, True, 64), ("K7", False, True, 128),
               ("K7", True, False, 128), ("K11", True, True, 1000),
               ("K11", False, True, 1000), ("K11", True, False, 4607)]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,grid,ambient,n", FIELD_CASES)
def test_tensor_core_field_kernels_match_plain(card, grid_free, no_ambient, kernel,
                                               grid, ambient, n):
    """bf16 K7 and K11 on the tensor cores against the plain version (the
    bf16 gate of each output group's scale) and against exact sums (at most
    PLAIN_MULTIPLE times the plain version's distance in each group), one
    launch each."""
    fk, fp, args = _field_case(card, grid_free, no_ambient, kernel, grid, ambient,
                               n, seed=n)
    before = fk.launches
    raw_k = fk(*args)
    ref = _plain_ref(fp, *args, out_k=raw_k)
    raw_p = fp(*args)
    torch.cuda.synchronize()
    assert fk.launches == before + 1
    assert raw_k.shape == raw_p.shape and torch.isfinite(raw_k).all()
    assert _field_scaled(raw_k, raw_p) <= FIELD_GATE, _field_scaled(raw_k, raw_p)
    assert ref.dtype == torch.float64


def _field_slice_fault(level, layer: int):
    """A copy of ``level`` whose bf16 forward blob (``point_blob``, which
    K7 and K11 read on the tensor cores) leaves out rows 16-31 of layer
    ``layer``'s weights: one 16-row K-slice of what the ring stages."""
    faulty = dataclasses.replace(level, _blobs={})
    w, b, meta = k5.point_blob(faulty, torch.bfloat16)
    w1, k1_, _, _, n = meta.reshape(-1, 7)[layer, :5].tolist()
    assert k1_ >= 32
    w = w.clone()
    w[w1 + 16 * n:w1 + 32 * n] = 0
    faulty._blobs[("point", torch.bfloat16)] = (w, b, meta)
    return faulty


@pytest.mark.cuda
@pytest.mark.parametrize("layer", ["trunk[1]", "rgb head"])
@pytest.mark.parametrize("kernel,grid", [("K7", True), ("K7", False), ("K11", True)])
def test_tensor_core_field_fault_weight_slice_misses_gate(card, grid_free, no_ambient,
                                                          kernel, grid, layer):
    """Rows 16-31 of trunk[1]'s or of the rgb head's weights left out of
    the forward blob: the raw field must miss the gates its faultless run
    passes (the plain version's, or exact sums within PLAIN_MULTIPLE of its
    distance, each in every output group)."""
    fk, fp, args = _field_case(card, grid_free, no_ambient, kernel, grid, True,
                               128 if kernel == "K7" else 1000, seed=21)
    raw_p, raw_k = fp(*args), fk(*args)
    raw_x = _plain_ref(fp, *args, out_k=raw_k)
    assert _field_scaled(raw_k, raw_p) <= FIELD_GATE
    li = 4 if kernel == "K7" else 2      # the folded level among the arguments
    faulty = list(args)
    index = 1 if layer == "trunk[1]" else len(args[li].trunk) + 6
    faulty[li] = _field_slice_fault(args[li], index)
    raw_f = fk(*faulty)
    torch.cuda.synchronize()
    ok, d = _field_exact(raw_f, raw_p, raw_x)
    assert _field_scaled(raw_f, raw_p) > FIELD_GATE or not ok, (
        _field_scaled(raw_f, raw_p), d)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K7", "K11"])
def test_tensor_core_field_mask_keeps_the_last_tile(card, grid_free, no_ambient, kernel):
    """P not a multiple of the 64-point tile (K7 at 37 rays x 63, K11 at
    1000 points): the kernel writes raw (P, 16) into the first P rows of a
    buffer and nothing past them (the guard rows stay NaN). The guard must
    see the launch that a kernel without its store mask makes: the same
    kernel told the tile's end as P, which writes the last tile's rows
    past P. That plants nothing in the kernel and tests the store mask
    alone; loads past P are not tested (the inputs are views of longer
    tensors)."""
    dev = card[0]
    if kernel == "K7":
        R, S = 37, 63
        _, fp, args = _field_case(card, grid_free, no_ambient, "K7", True, True, S,
                                  seed=31)
        pts, dirs, table, rows, level = args[:5]
        n_rays = lambda n: -(-n // S)     # rays that cover n points

        def run(n, out):
            r = n_rays(n)
            ints = k5.level_kernel_args(pts[:r * S], dirs[:r], table, rows[:r * S],
                                        level, "bfloat16", GRID, "K7")[4]
            k5.nerf_field_tc("K7", pts[:r * S], level, r, S, ints, dirs=dirs[:r],
                             table=table, rows=rows[:r * S].to(torch.int32),
                             out=out[:r * S])
        P = R * S
        raw_p = fp(pts[:P], dirs[:R], table, rows[:P], level, "bfloat16", GRID)
    else:
        P = 1000
        _, fp, args = _field_case(card, grid_free, no_ambient, "K11", True, True,
                                  1024, seed=32)
        pts, extra, level = args[:3]

        def run(n, out):
            ints = k11.point_kernel_args(pts[:n], extra[:n], level, "K11")[2]
            k5.nerf_field_tc("K11", pts[:n], level, n, 1, ints, extra=extra[:n],
                             out=out[:n])
        raw_p = fp(pts[:P], extra[:P], level, "bfloat16")
    n_pad = -(-P // 64) * 64
    guard_ok = lambda buf: bool(torch.isnan(buf[P:]).all())
    buf = torch.full((n_pad + 128, 16), float("nan"), device=dev)
    run(P, buf)
    torch.cuda.synchronize()
    assert guard_ok(buf), "the kernel wrote past the last point"
    assert _field_scaled(buf[:P], raw_p) <= FIELD_GATE
    bad = torch.full((n_pad + 128, 16), float("nan"), device=dev)
    run(n_pad, bad)
    torch.cuda.synchronize()
    assert not guard_ok(bad)


# The forward tile on wgmma (level_train.cu fw::tile; field_tc_kernel for
# K5's field, K7 and K11, fwd_tc_kernel for launch 1 of K2/K6/K8/K12) has
# risks of its own design: persistent blocks whose two warpgroups take one
# 64-point tile each (a tile count can leave the second without one), a
# ring of weight stages that both warpgroups read in one order, and the
# order of its float32 sums.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("tiles,tail", [(1, 37), (3, 64), (2 * 132 * 2 + 1, 41)])
def test_tensor_core_field_tile_counts_keep_rows_past_p(card, grid_free, no_ambient,
                                                       tiles, tail):
    """K11 at tile counts that leave a block's second warpgroup without a
    tile (one tile; three; 529, over two sweeps of 132 persistent blocks)
    and with a ragged last tile (P = (tiles - 1) x 64 + tail): the raw field
    written into the first P rows of a buffer keeps the plain gate and the
    exact-sum rule, and the guard rows past P stay NaN."""
    P = (tiles - 1) * 64 + tail
    dev = card[0]
    _, fp, args = _field_case(card, grid_free, no_ambient, "K11", True, True, P,
                              seed=40 + tiles)
    pts, extra, level = args[:3]
    ints = k11.point_kernel_args(pts, extra, level, "K11")[2]
    buf = torch.full((tiles * 64 + 128, 16), float("nan"), device=dev)
    k5.nerf_field_tc("K11", pts, level, P, 1, ints, extra=extra, out=buf[:P])
    raw_p = fp(*args)
    _plain_ref(fp, *args, out_k=buf[:P])        # the exact-sum rule
    torch.cuda.synchronize()
    assert bool(torch.isnan(buf[P:]).all()), "the kernel wrote past the last point"
    assert _field_scaled(buf[:P], raw_p) <= FIELD_GATE


def _same_bits(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_bits(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    return torch.equal(a, b)


@pytest.mark.cuda
def test_tensor_core_forward_tile_repeats_bit_for_bit(card, grid_free, no_ambient, rng):
    """Two launches on the same inputs give the same bits: K7
    (field_tc_kernel) and K2 (fwd_tc_kernel, then the backward over its
    stash: every output and gradient), each at 96 rays x 63 samples (95
    tiles, an odd count, the last ragged). The tile's sums run in a fixed
    order whatever block takes a tile and whichever warpgroup reads a
    stage first."""
    fk, _, args = _field_case(card, grid_free, no_ambient, "K7", True, True, 63, seed=51)
    assert _same_bits(fk(*args), fk(*args))
    largs = _tc_level_case(card, grid_free, rng, True, 63)
    R = largs[0].shape[0] // 63
    dev = largs[0].device
    tgt = _gpu(dev, np.concatenate([rng.rand(R, 3), np.eye(12)[rng.randint(0, 12, R)]], 1))
    lw = _gpu(dev, np.stack([np.full(R, 1.0 / R), np.full(R, 0.02 / R)], 1))
    run = lambda: k2.nerf_level_train(*largs[:7], tgt, lw, *largs[7:], 0.5)
    first, second = run(), run()
    torch.cuda.synchronize()
    assert _same_bits(first, second)


# the product whose first weight stage a ring-stage fault leaves out: a
# 128-wide chunk's (trunk[4]), or a head's (alpha: 8 outputs over the
# trunk's 256 k; the seg head: 16 outputs over the branch's 128), which
# issue their k16 steps in other orders (level_train.cu fw::field_product)
RING_STAGES = {"trunk[4]": lambda L: 4, "alpha head": lambda L: L + 1,
               "seg head": lambda L: L + 11}


def _ring_stage_fault(level, stage: str = "trunk[4]"):
    """A copy of ``level`` whose weight stages (``nerf_level.wgmma_blob``,
    which the wgmma tile streams) leave out the first stage of ``stage``'s
    product (RING_STAGES): its first 64 k of its first 128 outputs, or of
    a head's 8 or 16."""
    faulty = dataclasses.replace(level, _blobs={})
    w, _, meta = k5.point_blob(faulty, torch.bfloat16)
    stages = k5.wgmma_blob(faulty, w).clone()
    q_fault = RING_STAGES[stage](len(level.trunk))
    at = 0
    for q, _, _, _, _, rows, _ in k5.wgmma_stages(meta.reshape(-1, 7).tolist(),
                                                    len(level.trunk)):
        if q == q_fault:
            break
        at += rows * 64
    assert float(stages[at:at + rows * 64].float().abs().max()) > 0
    stages[at:at + rows * 64] = 0
    faulty._blobs[("wgmma", torch.bfloat16)] = (w, w._version, stages)
    return faulty


@pytest.mark.cuda
@pytest.mark.parametrize("stage", list(RING_STAGES))
@pytest.mark.parametrize("kernel", ["K5", "K7", "K11"])
def test_tensor_core_field_fault_ring_stage_misses_gates(card, grid_free, no_ambient,
                                                        rng, kernel, stage):
    """One ring stage left out of the weights the wgmma tile streams
    (trunk[4]'s first, or a head's first: RING_STAGES): K5's composited
    outputs and K7's and K11's raw field must miss the exact-sum rule that
    the faultless launch keeps."""
    if kernel == "K5":
        args = _tc_level_case(card, grid_free, rng, True, 64)
        out_p = k5.nerf_level_plain(*args)
        out_x = level_exact.exact_plain(k5.nerf_level_plain, *args)
        ok, d = _level_exact(k5.nerf_level_forward(*args), out_p, out_x)
        assert ok, d
        faulty = args[:7] + (_ring_stage_fault(args[7], stage),) + args[8:]
        ok, d = _level_exact(k5.nerf_level_forward(*faulty), out_p, out_x)
        assert not ok, d
        return
    fk, fp, args = _field_case(card, grid_free, no_ambient, kernel, True, True,
                               128 if kernel == "K7" else 1000, seed=52)
    raw_p = fp(*args)
    raw_x = _plain_ref(fp, *args, out_k=fk(*args))
    li = 4 if kernel == "K7" else 2      # the folded level among the arguments
    faulty = list(args)
    faulty[li] = _ring_stage_fault(args[li], stage)
    raw_f = fk(*faulty)
    torch.cuda.synchronize()
    ok, d = _field_exact(raw_f, raw_p, raw_x)
    assert not ok, d


# ptxas's report of a kernel in _build's log: the lines from its "entry
# function" line to the next kernel's
def _ptxas_blocks(log: str) -> dict:
    blocks, name = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            blocks[name] = []
        elif name is not None:
            blocks[name].append(line)
    return blocks


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["field_tc_kernelILi1E", "fwd_tc_kernel"])
def test_forward_tile_builds_without_spills_or_serialised_wgmma(card, kernel):
    """ptxas's report of the forward tile's kernels that the path runs
    (level_train.cu: field_tc_kernel<1> for K5's field, K7 and K11;
    fwd_tc_kernel for launch 1 of K2/K6/K8/K12), read from _build's log of
    level_train: no byte spilled (stores or loads) and no wgmma serialised
    (C7520, or C7514: a loop head reached with other groups in flight on
    other paths). A form of fw::field_product that holds more live values
    spills within 168 registers a thread, and a spill or a serialised
    wgmma each cost the tile more than its pipelining gains."""
    from sahs_tpu_torch.ops.kernels import _build
    _build.load("level_train")
    log = _build.build_log("level_train")
    assert "entry function" in log, "no ptxas report in the build log"
    (name, block), = [(n, b) for n, b in _ptxas_blocks(log).items() if kernel in n]
    spills = [int(n) for line in block for n in re.findall(r"(\d+) bytes spill", line)]
    assert spills and not any(spills), block
    flagged = [line for line in log.splitlines()
               if re.search(r"C7520|C7514|serializ", line)
               and (name in line or "'" not in line)]
    assert not flagged, flagged


# ---------------------------------------------------------------------------
# bf16 K13 on the tensor cores (skip_mlp.cu:skip_wg_kernel, the deformation
# nets' tile on wgmma, skip_wg.cuh): the warp and the hyper net against
# the plain version within the bf16 gate of the output's scale, and against
# exact sums within PLAIN_MULTIPLE of the plain version's own distance,
# with a floor of the forward's own (SKIP_FLOOR); faults planted in the
# forward blob must miss those gates; rows past P keep what they held.
# ---------------------------------------------------------------------------

# Below the plain forward's own L2-relative distance to exact sums on the
# card (as FIELD_FLOOR is the field's), so that the multiple, not the
# floor, decides.
SKIP_FLOOR = 1e-5
SKIP_SIZES = [1000, 96 * 48, 2048 * 128]


def _skip_case(card, rng, net, P):
    """(points (P, 3), folded weights) of the warp (6x128, tanh, 3) or hyper
    (6x64, linear, 2) net of the flagship's seeded model."""
    dev, model, _, _ = card
    cond = _gpu(dev, rng.randn(76 + 36) * 0.5)
    w = k13.prepare_skip(getattr(model, net), cond,
                         nerface.build_pe_groups(model.spec)[0],
                         "tanh" if net == "warp" else "linear")
    return _gpu(dev, rng.uniform(-1.05, 1.05, (P, 3))), w


def _skip_exact(y_k, y_p, y_x):
    """(the kernel keeps the rule, (d_k, d_p)): the L2-relative distances of
    ``y_k`` and ``y_p`` to exact sums ``y_x``."""
    d_k, d_p = point_errors(y_k, y_x)["l2_rel"], point_errors(y_p, y_x)["l2_rel"]
    return d_k <= PLAIN_MULTIPLE * max(d_p, SKIP_FLOOR), (d_k, d_p)


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["warp", "hyper"])
@pytest.mark.parametrize("P", SKIP_SIZES)
def test_tensor_core_skip_forward_matches_plain(card, rng, net, P):
    """bf16 K13 on the tensor cores at P = 1000 (a ragged last tile), 96 x
    48 and a step's 2048 x 128: one launch, finite, within the bf16 gate of
    the plain version's scale, and at most PLAIN_MULTIPLE times the plain
    version's distance from exact sums."""
    pts, w = _skip_case(card, rng, net, P)
    before = k13.skip_mlp_forward.launches
    y_k = k13.skip_mlp_forward(pts, w, "bfloat16")
    y_p = k13.skip_mlp_plain(pts, w, "bfloat16")
    y_x = level_exact.exact_plain(k13.skip_mlp_plain, pts, w, "bfloat16")
    torch.cuda.synchronize()
    assert k13.skip_mlp_forward.launches == before + 1
    assert y_k.shape == y_p.shape == (P, w.out["w"].shape[1])
    assert torch.isfinite(y_k).all() and y_x.dtype == torch.float64
    assert _scaled(y_k, y_p) <= FIELD_GATE, _scaled(y_k, y_p)
    ok, d = _skip_exact(y_k, y_p, y_x)
    assert ok, d


def _skip_blob_fault(w, fault: str):
    """A copy of ``w`` whose bf16 forward blob (K13's) leaves out rows 32-63
    of trunk[1]'s weights (half of one 64-k weight stage of the wgmma tile)
    or the head's bias."""
    faulty = dataclasses.replace(w, _blobs={})
    wb, b, meta = faulty.blob(torch.bfloat16)
    descs = meta.reshape(-1, 7).tolist()
    if fault == "trunk[1] rows 32-63":
        w1, k1_, _, _, n = descs[1][:5]
        assert k1_ >= 64
        wb = wb.clone()
        wb[w1 + 32 * n:w1 + 64 * n] = 0
    else:
        n, ob = descs[len(w.trunk)][4:6]
        assert float(b[ob:ob + n].abs().max()) > 0
        b = b.clone()
        b[ob:ob + n] = 0
    faulty._blobs[torch.bfloat16] = (wb, b, meta)
    return faulty


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["warp", "hyper"])
@pytest.mark.parametrize("fault", ["trunk[1] rows 32-63", "head bias"])
def test_tensor_core_skip_forward_fault_misses_gates(card, rng, net, fault):
    """A fault planted in what bf16 K13 reads (a 32-row slice of trunk[1]'s
    weights left out, or the head's bias dropped): the output must miss
    the gates that the faultless launch on the same inputs passes (the
    plain version's, or exact sums within PLAIN_MULTIPLE of its distance)."""
    pts, w = _skip_case(card, rng, net, 96 * 48)
    y_p = k13.skip_mlp_plain(pts, w, "bfloat16")
    y_x = level_exact.exact_plain(k13.skip_mlp_plain, pts, w, "bfloat16")
    y_k = k13.skip_mlp_forward(pts, w, "bfloat16")
    y_f = k13.skip_mlp_forward(pts, _skip_blob_fault(w, fault), "bfloat16")
    torch.cuda.synchronize()
    assert _scaled(y_k, y_p) <= FIELD_GATE and _skip_exact(y_k, y_p, y_x)[0]
    ok, d = _skip_exact(y_f, y_p, y_x)
    assert _scaled(y_f, y_p) > FIELD_GATE or not ok, (_scaled(y_f, y_p), d)


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["warp", "hyper"])
def test_tensor_core_skip_forward_keeps_rows_past_p(card, rng, net):
    """P = 1000, not a multiple of the 64-point tile: bf16 K13 writes its
    rows into the first P rows of a buffer and nothing past them (the
    guard rows stay NaN). The guard must see the launch that a kernel
    without its store mask makes: the same kernel told the tile's end as
    P, which writes the last tile's rows past P. A check of the store
    mask; it plants nothing in the kernel."""
    P = 1000
    n_pad = -(-P // k2.TP_BF16) * k2.TP_BF16
    pts, w = _skip_case(card, rng, net, n_pad)
    out_dim = w.out["w"].shape[1]
    y_p = k13.skip_mlp_plain(pts[:P], w, "bfloat16")
    guard_ok = lambda buf: bool(torch.isnan(buf[P:]).all())
    buf = torch.full((n_pad + 64, out_dim), float("nan"), device=pts.device)
    k13.skip_mlp_forward(pts[:P], w, "bfloat16", out=buf[:P])
    torch.cuda.synchronize()
    assert guard_ok(buf), "the kernel wrote past the last point"
    assert _scaled(buf[:P], y_p) <= FIELD_GATE
    bad = torch.full((n_pad + 64, out_dim), float("nan"), device=pts.device)
    k13.skip_mlp_forward(pts, w, "bfloat16", out=bad[:n_pad])
    torch.cuda.synchronize()
    assert not guard_ok(bad)


# ---------------------------------------------------------------------------
# bf16 K5 and K1 on the tensor cores: K5 as field_tc_kernel's raw field
# into a scratch and composite_fwd_kernel (level_train.cu), K1 as
# deform_pair_wg_kernel (deform_pair.cu, skip_wg.cuh's tile with both
# nets). Faults planted in what they read must miss the exact-sum rule that
# the faultless launch on the same inputs keeps; nothing is written past
# the last point of a ragged last tile; a point's deformation does not
# depend on its neighbours; K5's outputs are K2's forward outputs, bit for
# bit (the same tile routine at the same slice depth, the same compositing
# routine).
# ---------------------------------------------------------------------------

def _tc_level_case(card, grid_free, rng, grid, S, R=96):
    """K5's arguments in bf16 on the seeded grid or grid-free level: 96 rays
    of S samples, a background prior and sigma noise."""
    dev, model, _, level = card
    table = pack_corner_table(model.spatial_embeddings.detach(), dtype=torch.bfloat16)
    if grid:
        args = _level_case(dev, model, rng, R, S, True, True, "bfloat16")
        return args + (level, "bfloat16", GRID)
    args = _grid_free_case(dev, rng, R, S, True, True)
    return args + (grid_free[2], "bfloat16", None)


def _level_blob_fault(level, fault: str):
    """A copy of ``level`` whose bf16 forward blob (``point_blob``, which
    K5 reads on the tensor cores) leaves out rows 16-31 of trunk[1]'s or
    of the rgb head's weights, or drops the alpha head's bias."""
    if fault != "alpha bias":
        L = len(level.trunk)
        return _field_slice_fault(level, 1 if fault == "trunk[1] rows 16-31" else L + 6)
    faulty = dataclasses.replace(level, _blobs={})
    w, b, meta = k5.point_blob(faulty, torch.bfloat16)
    n, ob = meta.reshape(-1, 7)[len(level.trunk) + 1, 4:6].tolist()
    assert float(b[ob:ob + n].abs().max()) > 0
    b = b.clone()
    b[ob:ob + n] = 0
    faulty._blobs[("point", torch.bfloat16)] = (w, b, meta)
    return faulty


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["trunk[1] rows 16-31", "rgb head rows 16-31",
                                   "alpha bias"])
@pytest.mark.parametrize("grid", [True, False])
def test_tensor_core_level_forward_fault_misses_gates(card, grid_free, rng, grid, fault):
    """A fault planted in the forward blob that bf16 K5 reads: its outputs
    must miss the exact-sum rule that the faultless launch keeps."""
    args = _tc_level_case(card, grid_free, rng, grid, 64)
    out_p = k5.nerf_level_plain(*args)
    out_x = level_exact.exact_plain(k5.nerf_level_plain, *args)
    out_k = k5.nerf_level_forward(*args)
    faulty = args[:7] + (_level_blob_fault(args[7], fault),) + args[8:]
    out_f = k5.nerf_level_forward(*faulty)
    torch.cuda.synchronize()
    ok, d = _level_exact(out_k, out_p, out_x)
    assert ok, d
    ok, d = _level_exact(out_f, out_p, out_x)
    assert not ok, d


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [True, False])
def test_tensor_core_level_forward_matches_level_train_forward(card, grid_free, rng,
                                                               grid):
    """bf16 K5 and K2's forward outputs (rgb_map, weights) on the same
    inputs are bit-equal: both run fwd_tile at 16-row slices and the same
    compositing routine (composite_fwd)."""
    args = _tc_level_case(card, grid_free, rng, grid, 64)
    R = args[0].shape[0] // 64
    dev = args[0].device
    tgt = _gpu(dev, np.concatenate([rng.rand(R, 3), np.eye(12)[rng.randint(0, 12, R)]], 1))
    lw = _gpu(dev, np.stack([np.full(R, 1.0 / R), np.full(R, 0.02 / R)], 1))
    rgb_k, w_k = k5.nerf_level_forward(*args)
    out2 = k2.nerf_level_train(*args[:7], tgt, lw, *args[7:], 0.5)
    torch.cuda.synchronize()
    assert torch.equal(rgb_k, out2[0]) and torch.equal(w_k, out2[1])


@pytest.mark.cuda
def test_tensor_core_level_forward_keeps_the_last_tile(card, grid_free, rng):
    """R x S not a multiple of the 64-point tile (37 rays x 63): bf16 K5's
    raw-field scratch takes the first R*S rows of a buffer and nothing past
    them (the guard rows stay NaN); the launch told the tile's end as P
    (the rays that cover it) writes them."""
    dev, model, _, level = card
    R, S = 37, 63
    n_pad = -(-R * S // 64) * 64
    r_pad = -(-n_pad // S)
    pts, dirs, table, rows, z, bg, noise = _level_case(dev, model, rng, r_pad, S, True,
                                                       True, "bfloat16")
    rows32 = rows.to(torch.int32)

    def run(r, buf):
        ints = k5.level_kernel_args(pts[:r * S], dirs[:r], table, rows32[:r * S],
                                    level, "bfloat16", GRID, "K5")[4]
        return k5._nerf_level_tc(pts[:r * S], dirs[:r], table, rows32[:r * S], z[:r],
                                 bg[:r], noise[:r], level, r, S, ints, buf[:r * S])
    guard_ok = lambda buf: bool(torch.isnan(buf[R * S:]).all())
    buf = torch.full((r_pad * S + 128, 16), float("nan"), device=dev)
    rgb_k, w_k = run(R, buf)
    args = (pts[:R * S], dirs[:R], table, rows[:R * S], z[:R], bg[:R], noise[:R],
            level, "bfloat16", GRID)
    out_p = k5.nerf_level_plain(*args)
    out_x = level_exact.exact_plain(k5.nerf_level_plain, *args)
    torch.cuda.synchronize()
    assert guard_ok(buf), "the kernel wrote past the last point"
    ok, d = _level_exact((rgb_k, w_k), out_p, out_x)
    assert ok, d
    bad = torch.full((r_pad * S + 128, 16), float("nan"), device=dev)
    run(r_pad, bad)
    torch.cuda.synchronize()
    assert not guard_ok(bad)


def _pair_blob_fault(pair, fault: str):
    """A copy of ``pair`` whose bf16 blob (K1's, which K3 also reads)
    leaves out rows 32-63 of the warp trunk[1]'s weights (half of one
    64-k weight stage of the wgmma tile, one 32-row slice of K3's ring) or
    drops the hyper head's bias."""
    faulty = dataclasses.replace(pair, _blobs={})
    w, b, meta = faulty.blob(torch.bfloat16)
    descs = meta.reshape(-1, 7).tolist()
    if fault == "warp trunk[1] rows 32-63":
        w1, k1_, _, _, n = descs[1][:5]
        assert k1_ >= 64
        w = w.clone()
        w[w1 + 32 * n:w1 + 64 * n] = 0
    else:
        n, ob = descs[len(pair.warp_trunk) + 1 + len(pair.hyper_trunk)][4:6]
        assert float(b[ob:ob + n].abs().max()) > 0
        b = b.clone()
        b[ob:ob + n] = 0
    faulty._blobs[torch.bfloat16] = (w, b, meta)
    return faulty


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["warp trunk[1] rows 32-63", "hyper head bias"])
def test_tensor_core_deform_pair_fault_misses_gates(card, rng, fault):
    """A fault planted in the blob that bf16 K1 reads: its output must miss
    the exact-sum rule that the faultless launch keeps."""
    dev, _, pair, _ = card
    S = 64
    pts = _gpu(dev, rng.uniform(-0.6, 0.6, (300 * S, 3)))
    out_p = k1.deform_pair_plain(pts, pair, "bfloat16", S, GRID)[0]
    out_x = level_exact.exact_plain(k1.deform_pair_plain, pts, pair, "bfloat16", S,
                                    GRID)[0]
    out_k = k1.deform_pair_forward(pts, pair, "bfloat16", S, GRID)[0]
    out_f = k1.deform_pair_forward(pts, _pair_blob_fault(pair, fault), "bfloat16", S,
                                   GRID)[0]
    torch.cuda.synchronize()
    ok, d = _pair_exact(pts, out_k, out_p, out_x)
    assert ok, d
    ok, d = _pair_exact(pts, out_f, out_p, out_x)
    assert not ok, d


@pytest.mark.cuda
def test_tensor_core_deform_pair_keeps_the_last_tile(card, rng):
    """P = 1000 points (1 sample a ray), not a multiple of the 64-point
    tile: bf16 K1 writes its packed points and rows into the first P rows
    of buffers and nothing past them (the guard rows stay NaN and -1); the
    launch told the tile's end as P writes them."""
    dev, _, pair, _ = card
    P = 1000
    n_pad = -(-P // 64) * 64
    pts = _gpu(dev, rng.uniform(-0.6, 0.6, (n_pad, 3)))
    out_p = k1.deform_pair_plain(pts[:P], pair, "bfloat16", 1, GRID)[0]
    out_x = level_exact.exact_plain(k1.deform_pair_plain, pts[:P], pair, "bfloat16", 1,
                                    GRID)[0]

    def run(n):
        out = torch.full((n_pad + 64, 5), float("nan"), device=dev)
        rows = torch.full((n_pad + 64,), -1, dtype=torch.int32, device=dev)
        k1._launch(pts[:n], pair, torch.bfloat16, GRID, out[:n], rows[:n])
        torch.cuda.synchronize()
        return out, rows
    guard_ok = lambda out, rows: bool(torch.isnan(out[P:]).all() and (rows[P:] == -1).all())
    out, rows = run(P)
    assert guard_ok(out, rows), "the kernel wrote past the last point"
    ok, d = _pair_exact(pts[:P], out[:P], out_p, out_x)
    assert ok, d
    assert torch.equal(rows[:P].long(), _cell_geometry(out[:P, :3], GRID)[0])
    assert not guard_ok(*run(n_pad))


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [True, False])
def test_tensor_core_deform_pair_does_not_depend_on_a_points_tile(card, rng, grid):
    """bf16 K1 on permuted points gives each point's output and row bit for
    bit: a point's deformation does not depend on its neighbours or on its
    place in a tile (the fused step scatters coarse points into the fine
    pass by their positions)."""
    dev, _, pair, _ = card
    P = 300 * 64 + 17
    pts = _gpu(dev, rng.uniform(-1.05, 1.05, (P, 3)))
    perm = torch.as_tensor(rng.permutation(P), device=dev)
    dims = GRID if grid else None
    out_a, rows_a = k1.deform_pair_forward(pts, pair, "bfloat16", 1, dims)
    out_b, rows_b = k1.deform_pair_forward(pts[perm], pair, "bfloat16", 1, dims)
    torch.cuda.synchronize()
    assert torch.equal(out_a[perm], out_b)
    if grid:
        assert torch.equal(rows_a.reshape(-1)[perm], rows_b.reshape(-1))


# The deformation nets' forward tile on wgmma (skip_wg.cuh: deform_pair_wg_kernel
# for bf16 K1, skip_wg_kernel for bf16 K13) has the risks of the field's
# tile: persistent blocks whose two warpgroups take one 64-point tile each,
# a ring of weight stages both warpgroups read in one order, and the order
# of its float32 sums.
# ---------------------------------------------------------------------------

DEFORM_TILE_KERNELS = ["K1", "K13 warp", "K13 hyper"]


def _deform_tile_run(card, rng, kernel, P):
    """(run(n, buffers) launching the tile on the first n points into the
    first n rows of the buffers, guard buffers of ``rows`` rows, gate(buf)
    holding the first P rows against the plain version and exact sums)
    for K1 (the flagship pair, with the grid) or K13 (the warp or the hyper
    net), on P_pad points drawn for a tile count that covers P."""
    dev, _, pair, _ = card
    n_pad = -(-P // 64) * 64
    if kernel == "K1":
        pts = _gpu(dev, rng.uniform(-0.6, 0.6, (n_pad, 3)))
        out_p = k1.deform_pair_plain(pts[:P], pair, "bfloat16", 1, GRID)[0]
        out_x = level_exact.exact_plain(k1.deform_pair_plain, pts[:P], pair, "bfloat16",
                                        1, GRID)[0]

        def buffers(rows):
            return (torch.full((rows, 5), float("nan"), device=dev),
                    torch.full((rows,), -1, dtype=torch.int32, device=dev))

        def run(n, bufs):
            k1._launch(pts[:n], pair, torch.bfloat16, GRID, bufs[0][:n], bufs[1][:n])

        def guard_ok(bufs):
            return bool(torch.isnan(bufs[0][P:]).all() and (bufs[1][P:] == -1).all())

        def gate(bufs):
            ok, d = _pair_exact(pts[:P], bufs[0][:P], out_p, out_x)
            rows_ok = torch.equal(bufs[1][:P].long(), _cell_geometry(bufs[0][:P, :3], GRID)[0])
            return ok and rows_ok and _scaled(bufs[0][:P], out_p) <= FIELD_GATE, d
        return run, buffers, guard_ok, gate
    pts, w = _skip_case(card, rng, kernel.split()[1], n_pad)
    y_p = k13.skip_mlp_plain(pts[:P], w, "bfloat16")
    y_x = level_exact.exact_plain(k13.skip_mlp_plain, pts[:P], w, "bfloat16")
    od = w.out["w"].shape[1]

    def buffers(rows):
        return (torch.full((rows, od), float("nan"), device=dev),)

    def run(n, bufs):
        k13.skip_mlp_forward(pts[:n], w, "bfloat16", out=bufs[0][:n])

    def guard_ok(bufs):
        return bool(torch.isnan(bufs[0][P:]).all())

    def gate(bufs):
        ok, d = _skip_exact(bufs[0][:P], y_p, y_x)
        return ok and _scaled(bufs[0][:P], y_p) <= FIELD_GATE, d
    return run, buffers, guard_ok, gate


@pytest.mark.cuda
@pytest.mark.parametrize("tiles,tail", [(1, 37), (2 * 132 + 1, 41)])
@pytest.mark.parametrize("kernel", DEFORM_TILE_KERNELS)
def test_tensor_core_deform_tile_counts_keep_rows_past_p(card, rng, kernel, tiles, tail):
    """bf16 K1 and K13 at tile counts that leave a block's second warpgroup
    without a tile (one tile) and that cross the persistent grid (265
    tiles: one past two tiles for each of 132 blocks), the last tile ragged
    (P = (tiles - 1) x 64 + tail): the first P rows of the buffers keep the
    plain gate and the exact-sum rule (K1's rows the cells of its own
    output), and the guard rows past P keep what they held."""
    P = (tiles - 1) * 64 + tail
    run, buffers, guard_ok, gate = _deform_tile_run(card, rng, kernel, P)
    bufs = buffers(tiles * 64 + 128)
    run(P, bufs)
    torch.cuda.synchronize()
    assert guard_ok(bufs), "the kernel wrote past the last point"
    ok, d = gate(bufs)
    assert ok, d


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", DEFORM_TILE_KERNELS)
def test_tensor_core_deform_tile_repeats_bit_for_bit(card, rng, kernel):
    """Two launches of bf16 K1 or K13 on the same inputs give the same bits
    (95 tiles, an odd count, the last ragged): the tile's sums run in a
    fixed order whatever block takes a tile and whichever warpgroup reads a
    stage first."""
    P = 94 * 64 + 23
    run, buffers, _, gate = _deform_tile_run(card, rng, kernel, P)
    first, second = buffers(P), buffers(P)
    run(P, first)
    run(P, second)
    torch.cuda.synchronize()
    assert gate(first)[0]
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _deform_stage_fault(weights, heads, layer: int):
    """A copy of K1's or K13's folded ``weights`` whose weight stages
    (``skip_mlp.tile_stages``, which the wgmma tile streams) leave out a
    16-row slice (16 outputs x 64 k) of layer ``layer``'s first stage."""
    faulty = dataclasses.replace(weights, _blobs={})
    stages, descs = k13.tile_stages(faulty, heads)
    stages = stages.clone()
    at = 0
    for q, _, _, _, _, rows, _ in field_mlp.stage_order(descs.tolist(), heads):
        if q == layer:
            break
        at += rows * 64
    assert float(stages[at:at + 16 * 64].float().abs().max()) > 0
    stages[at:at + 16 * 64] = 0
    w = faulty.blob(torch.bfloat16)[0]
    faulty._blobs[("wgmma", torch.bfloat16)] = (w, w._version, stages)
    return faulty


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", DEFORM_TILE_KERNELS)
def test_tensor_core_deform_fault_ring_stage_misses_gates(card, rng, kernel):
    """A 16-row slice of one weight stage of trunk[1] (the warp net's in K1)
    left out of what the wgmma tile streams: the output must miss the
    exact-sum rule (or the plain gate) that the faultless launch keeps."""
    dev, _, pair, _ = card
    P = 300 * 64
    if kernel == "K1":
        pts = _gpu(dev, rng.uniform(-0.6, 0.6, (P, 3)))
        out_p = k1.deform_pair_plain(pts, pair, "bfloat16", 64, GRID)[0]
        out_x = level_exact.exact_plain(k1.deform_pair_plain, pts, pair, "bfloat16", 64,
                                        GRID)[0]
        nw = len(pair.warp_trunk)
        faulty = _deform_stage_fault(pair, [nw, nw + 1 + len(pair.hyper_trunk)], 1)
        out_k = k1.deform_pair_forward(pts, pair, "bfloat16", 64, GRID)[0]
        out_f = k1.deform_pair_forward(pts, faulty, "bfloat16", 64, GRID)[0]
        torch.cuda.synchronize()
        assert _pair_exact(pts, out_k, out_p, out_x)[0]
        ok, d = _pair_exact(pts, out_f, out_p, out_x)
        assert not ok or _scaled(out_f, out_p) > FIELD_GATE, d
        return
    pts, w = _skip_case(card, rng, kernel.split()[1], P)
    y_p = k13.skip_mlp_plain(pts, w, "bfloat16")
    y_x = level_exact.exact_plain(k13.skip_mlp_plain, pts, w, "bfloat16")
    y_k = k13.skip_mlp_forward(pts, w, "bfloat16")
    y_f = k13.skip_mlp_forward(pts, _deform_stage_fault(w, [len(w.trunk)], 1), "bfloat16")
    torch.cuda.synchronize()
    assert _skip_exact(y_k, y_p, y_x)[0]
    ok, d = _skip_exact(y_f, y_p, y_x)
    assert not ok or _scaled(y_f, y_p) > FIELD_GATE, d


@pytest.fixture
def f32_card():
    """The card with TF32 off for matmuls and cuDNN, restored after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.cuda
@pytest.mark.parametrize("audio", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_stage2_generator_on_the_card_matches_the_cpu(f32_card, rng, audio, train):
    """Stage II's generator (cuDNN convolutions) in float32 on the card
    against the same weights on the CPU at 128 x 128: the refined frame
    within 1e-4 absolute (chip_smoke.py's GEN_CPU_GATE ceiling) and, in
    train mode, the buffers it leaves (batch-norm statistics, spectral
    norm's u) within 1e-5."""
    import copy
    from sahs_tpu_torch.models import spade
    cpu = spade.Generator.init(audio=audio, seed=1, device="cpu")
    gpu = copy.deepcopy(cpu).to(f32_card)
    src, raw = (rng.rand(1, 3, 128, 128).astype(np.float32) for _ in range(2))
    aud = rng.randn(16, 29).astype(np.float32) if audio else None
    outs = []
    for g, d in ((cpu, "cpu"), (gpu, f32_card)):
        t = lambda a: None if a is None else torch.as_tensor(a, device=d)
        with torch.no_grad():
            outs.append(g(t(src), t(raw), t(aud), train=train).cpu())
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-4
    if train:
        for a, b in zip(cpu.buffers(), gpu.buffers()):
            assert float((a - b.cpu()).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_lpips_on_the_card_matches_the_cpu(f32_card, rng):
    from sahs_tpu_torch import lpips
    params = lpips.random_params(0)
    x = rng.rand(128, 128, 3).astype(np.float32)
    y = np.clip(x + rng.randn(128, 128, 3).astype(np.float32) * 0.05, 0, 1)
    a = lpips.lpips_distance(lpips.LpipsNet(params, "cpu"), x, y)
    b = lpips.lpips_distance(lpips.LpipsNet(params, f32_card), x, y)
    assert a > 0 and abs(a - b) <= 1e-4 * a


@pytest.fixture
def default_card():
    """The card under torch's default precision settings (cuDNN may use
    TF32; matmuls in float32), the process's settings restored after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("highest")
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = saved[0]
    torch.set_float32_matmul_precision(saved[1])


@pytest.mark.cuda
def test_stage2_and_lpips_entry_points_set_float32_themselves(default_card, rng):
    """Stage II's infer and train step and LPIPS's distance run in full
    float32 whatever the process allows: under torch's defaults the card
    holds the CPU within the float32 gates (the refined frame 1e-4
    absolute, as the generator test; the step's loss 1e-5 relative;
    LPIPS 1e-4 relative), and TF32 is allowed again after each call."""
    from sahs_tpu_torch import lpips
    from sahs_tpu_torch.train import stage2
    s = stage2.Stage2Settings(lr_G=2e-4, beta1=0.0, beta2=0.999, epochs=1,
                              epochs_decay=1, steps_per_epoch=1, audio=True)
    src, raw, tgt = (rng.rand(1, 128, 128, 3).astype(np.float32) for _ in range(3))
    aud = rng.randn(16, 29).astype(np.float32)
    infer, step = stage2.make_infer(s), stage2.make_train_step(s)
    outs, losses = [], []
    for d in ("cpu", default_card):
        t = lambda a: torch.as_tensor(a, device=d)
        state = stage2.init_stage2_state(s, seed=1, device=d)
        outs.append(infer(state.generator, t(src), t(raw), t(aud)).cpu())
        assert torch.backends.cudnn.allow_tf32
        losses.append(float(step(state, t(src), t(raw), t(tgt), t(aud))[1]["loss"]))
        assert torch.backends.cudnn.allow_tf32
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-4
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[0])
    params = lpips.random_params(0)
    x = rng.rand(128, 128, 3).astype(np.float32)
    y = np.clip(x + rng.randn(128, 128, 3).astype(np.float32) * 0.05, 0, 1)
    a = lpips.lpips_distance(lpips.LpipsNet(params, "cpu"), x, y)
    b = lpips.lpips_distance(lpips.LpipsNet(params, default_card), x, y)
    assert torch.backends.cudnn.allow_tf32
    assert a > 0 and abs(a - b) <= 1e-4 * a


# ---------------------------------------------------------------------------
# Data parallelism over rays (parallel/mesh.py) on the card
# ---------------------------------------------------------------------------

def _shard_case():
    import torch_dist_util as du
    return du, du.tiny_items(2), du.full_draws(0, 32, 32, 48)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_sharded_step_world_one_over_nccl_is_the_single_step(tmp_path, compute_dtype):
    """World size 1 over NCCL (a group of one with its collective): the
    sharded step bit for bit the single step's on the card, on the fused
    path and on the fallback (tests/torch_dist_util.world_one_rank)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sahs_tpu_torch.parallel import mesh
    du, items, draws = _shard_case()
    out = mesh.spawn_ranks(du.world_one_rank, 1,
                           (str(tmp_path), items, draws, "cuda", "nccl", compute_dtype),
                           device="cuda", timeout_s=300, workdir=str(tmp_path))[0]
    assert out == {"fused": [], "fallback": []}


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_two_ranks_over_gloo_on_one_card_match_the_single_step(tmp_path, compute_dtype):
    """Two ranks on the one card over gloo (NCCL refuses two ranks on one
    card): two steps on the fused path and on the fallback against the
    single step on the card, within tests/test_torch_sharding.py's gates
    (torch_dist_util.gates_missed), and the planted faults miss them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sahs_tpu_torch.parallel import mesh
    du, items, draws = _shard_case()
    lr = 5e-4
    single = {path: du.run_steps(None, du.tiny_cfg(fused=path == "fused",
                                                   compute_dtype=compute_dtype),
                                 items, "cuda", draws=draws, sgd=lr)
              for path in ("fused", "fallback")}
    res = mesh.spawn_ranks(du.paths_rank, 2,
                           (items, draws, "cuda", compute_dtype, 48, True, lr),
                           backend="gloo", device="cuda", timeout_s=300,
                           workdir=str(tmp_path))
    for path in ("fused", "fallback"):
        assert du.gates_missed([r[path] for r in res], single[path]) == [], path
    for fault in du.FAULTS:
        assert du.gates_missed([r[fault] for r in res], single["fused"][:1]), fault


# ---------------------------------------------------------------------------
# The kernels' remaining input forms: K13/K14 and K11/K12 on pre-encoded
# inputs, K3 with the points' cotangent, and K2, K5-K8 on a per-point
# spatial embedding se (P, C). float32 at a few thousand points (at most
# POINT_FLIPS flips), bfloat16 at TC_R x TC_S against exact sums
# (``_plain_ref``) and TC_GATES; each form with a planted fault that must
# miss the gates its faultless launch passes.
# ---------------------------------------------------------------------------

FORM_POINTS = {"float32": 96 * 48 + 17, "bfloat16": TC_R * TC_S}


def _encode(pts, groups):
    from sahs_tpu_torch.ops.kernels.field_mlp import kernel_pe
    return kernel_pe(pts, groups)


def _pre_skip_case(card, rng, net, P):
    """(the (P, 63) encoding of raw points, weights without PE groups, of
    the warp or hyper net)."""
    dev, model, _, _ = card
    cond = _gpu(dev, rng.randn(76 + 36) * 0.5)
    w = k13.prepare_skip(getattr(model, net), cond, None,
                         "tanh" if net == "warp" else "linear")
    pts = _gpu(dev, rng.uniform(-1.05, 1.05, (P, 3)))
    return _encode(pts, nerface.build_pe_groups(model.spec)[0]), w


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["warp", "hyper"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_pre_encoded_skip_kernels_match_plain(card, rng, net, compute_dtype):
    """K13 and K14 on the (P, 63) encoding (weights without PE groups):
    K13's output, K14's dW and the encoding's cotangent (P, 63) against
    the plain versions (bf16: exact sums, PLAIN_MULTIPLE), one launch
    each; planted fault: one column of the encoding left out of K13's
    input must miss the gates."""
    P = FORM_POINTS[compute_dtype]
    enc, w = _pre_skip_case(card, rng, net, P)
    dev = enc.device
    counts = (k13.skip_mlp_forward.launches, k13.skip_mlp_vjp.launches)
    y_k = k13.skip_mlp_forward(enc, w, compute_dtype)
    y_p = k13.skip_mlp_plain(enc, w, compute_dtype)
    f32 = compute_dtype == "float32"
    ok = lambda y: (float((y - y_p).abs().max()) <= 1e-4 if f32 else
                    _scaled(y, y_p) <= FIELD_GATE and _skip_exact(y, y_p, y_x)[0])
    y_x = None if f32 else level_exact.exact_plain(k13.skip_mlp_plain, enc, w, "bfloat16")
    torch.cuda.synchronize()
    assert y_k.shape == (P, w.out["w"].shape[1]) and torch.isfinite(y_k).all()
    assert ok(y_k)
    cut = enc.clone()
    cut[:, 40] = 0
    assert not ok(k13.skip_mlp_forward(cut, w, compute_dtype))
    g = 2.0 * (y_p - _gpu(dev, rng.randn(*y_p.shape) * 0.1)) / P
    gx_k, g_k = k13.skip_mlp_vjp(enc, w, g, True, compute_dtype)
    gx_p, g_p = _plain_ref(k13.skip_mlp_vjp_plain, enc, w, g, True, compute_dtype,
                           out_k=(gx_k, g_k))
    torch.cuda.synchronize()
    assert (k13.skip_mlp_forward.launches, k13.skip_mlp_vjp.launches) == (
        counts[0] + 2, counts[1] + 1)
    assert gx_k.shape == (P, 63)
    _points_ok(gx_k, gx_p, f32)
    _grads_ok(g_k, g_p, compute_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_deform_pair_vjp_points_cotangent_matches_plain(card, rng, compute_dtype):
    """K3 with need_gx: dW bit for bit the train path's (need_gx off, the
    same products), and gx (P, 3) = pe_bwd(x, gpe_warp + gpe_hyper) +
    (g + g2)[:, :3] against the plain version (bf16: exact sums,
    PLAIN_MULTIPLE); one launch a call; planted fault: the residual of the
    warped coordinates left out of gx must miss the points' gate."""
    dev, _, pair, _ = card
    P = FORM_POINTS[compute_dtype]
    pts = _gpu(dev, rng.uniform(-0.6, 0.6, (P, 3)))
    g = _gpu(dev, rng.randn(P, 5) * 0.1)
    g2 = _gpu(dev, rng.randn(P, 5) * 0.1)
    before = k1.deform_pair_vjp.launches
    gx_k, g_k = k1.deform_pair_vjp(pts, pair, g, g2, compute_dtype, need_gx=True)
    g_n = k1.deform_pair_vjp(pts, pair, g, g2, compute_dtype)
    gx_p, g_p = _plain_ref(k1.deform_pair_vjp_plain, pts, pair, g, g2, compute_dtype,
                           True, out_k=(gx_k, g_k))
    torch.cuda.synchronize()
    assert k1.deform_pair_vjp.launches == before + 2
    for (path, a), (_, b) in zip(compare.leaves(g_k), compare.leaves(g_n)):
        assert torch.equal(a, b), path
    assert gx_k.shape == (P, 3) and torch.isfinite(gx_k).all()
    f32 = compute_dtype == "float32"
    _points_ok(gx_k, gx_p, f32)
    _grads_ok(g_k, g_p, compute_dtype)
    with pytest.raises(AssertionError):
        _points_ok(gx_k - (g + g2)[:, :3], gx_p, f32)


def _pre_point_case(card, rng, P):
    """(pts_embed (P, 81), dir_extra (P, 59), the flagship level folded
    without PE groups)."""
    dev, model, _, _ = card
    _, pts_g, dir_g = nerface.build_pe_groups(model.spec)
    pts = _gpu(dev, np.concatenate([rng.uniform(-1.05, 1.05, (P, 3)),
                                    rng.uniform(-1, 1, (P, 2))], 1))
    dirs = _gpu(dev, rng.randn(P, 3) * 0.1 + [0, 0, -1])
    extra = torch.cat([_encode(dirs, dir_g), _gpu(dev, rng.randn(P, 32) * 0.3)], 1)
    level = k5.prepare_level(model.coarse, _gpu(dev, rng.randn(36) * 0.5), None, None)
    return _encode(pts, pts_g), extra, level


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_pre_encoded_nerf_mlp_kernels_match_plain(card, rng, compute_dtype):
    """K11 and K12 on pts_embed (P, 81) and dir_extra (P, 59): the raw
    field, then gx (P, 81), gextra (P, 59) and dW from a loss of the plain
    field, against the plain versions (bf16: exact sums, the field's rule
    and TC_GATES); one launch each; planted fault: the se block of the
    direction branch's first layer left out of K11's weights must miss."""
    P = FORM_POINTS[compute_dtype]
    x, e, level = _pre_point_case(card, rng, P)
    dev = x.device
    counts = (k11.nerf_mlp_forward_fused.launches, k2.nerf_mlp_vjp.launches)
    raw_k = k11.nerf_mlp_forward_fused(x, e, level, compute_dtype)
    raw_p = _plain_ref(k11.nerf_mlp_plain, x, e, level, compute_dtype, out_k=raw_k)
    f32 = compute_dtype == "float32"
    plain = k11.nerf_mlp_plain(x, e, level, compute_dtype)
    torch.cuda.synchronize()
    assert raw_k.shape == (P, 16) and torch.isfinite(raw_k).all()
    ok = lambda r: (float((r - raw_p).abs().max()) <= 1e-4 if f32 else
                    _field_scaled(r, plain) <= FIELD_GATE and _field_exact(r, plain, raw_p)[0])
    assert ok(raw_k)
    no_se = dataclasses.replace(level, dir0_se=torch.zeros_like(level.dir0_se), _blobs={})
    assert not ok(k11.nerf_mlp_forward_fused(x, e, no_se, compute_dtype))
    sig = torch.sigmoid(plain)
    g = 2.0 * (sig - _gpu(dev, rng.rand(P, 16))) * sig * (1.0 - sig) / P
    out_k = k2.nerf_mlp_vjp(x, e, g, level, compute_dtype)
    out_p = _plain_ref(k2.nerf_mlp_vjp_plain, x, e, g, level, compute_dtype, out_k=out_k)
    torch.cuda.synchronize()
    assert (k11.nerf_mlp_forward_fused.launches, k2.nerf_mlp_vjp.launches) == (
        counts[0] + 2, counts[1] + 1)
    assert out_k[0].shape == (P, 81) and out_k[1].shape == (P, 59)
    if f32:
        _points_ok(out_k[0], out_p[0], True)
        _points_ok(out_k[1], out_p[1], True)
        _grads_ok(out_k[2], out_p[2], "float32")
    else:
        _tc_check(out_k, out_p, 2, 2)


def _se_case(card, rng, compute_dtype):
    """Ray inputs at the form's size (f32: 96 rays of 48; bf16: TC_R x
    TC_S) with a background and sigma noise, and se (P, 32)."""
    dev = card[0]
    R, S = (96, 48) if compute_dtype == "float32" else (TC_R, TC_S)
    P = R * S
    pts = _gpu(dev, np.concatenate([rng.uniform(-1.05, 1.05, (P, 3)),
                                    rng.uniform(-1, 1, (P, 2))], 1))
    dirs = _gpu(dev, rng.randn(R, 3) * 0.1 + [0, 0, -1])
    z = _gpu(dev, np.sort(rng.uniform(0.48, 1.08, (R, S)), axis=-1))
    bg = _gpu(dev, rng.rand(R, 15))
    noise = _gpu(dev, rng.randn(R, S) * 0.5)
    se = _gpu(dev, rng.randn(P, 32) * 0.3)
    return R, S, pts, dirs, z, bg, noise, se


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_level_kernels_on_se_match_plain(card, rng, compute_dtype):
    """K7/K8, K5/K6 and K2 on a per-point se (P, 32) in place of the corner
    table: the raw field and the composited outputs against the plain
    versions (bf16: exact sums, the field's and the level's rules), gx (no
    trilinear term), gse (P, 32) float32, g_bg and dW from the plain
    outputs' loss cotangents (bf16: TC_GATES against exact sums); one
    launch a call; planted faults: the se block of the first direction
    layer left out of K7's and K5's weights, half of gse's channels dropped
    from K8's, K6's and K2's results, each missing its gate."""
    dev, _, _, level = card
    R, S, pts, dirs, z, bg, noise, se = _se_case(card, rng, compute_dtype)
    P = R * S
    f32 = compute_dtype == "float32"
    held = (k5.nerf_rayd_forward, k2.nerf_rayd_vjp, k5.nerf_level_forward,
            k2.nerf_level_vjp, k2.nerf_level_train)
    counts = [f.launches for f in held]
    no_se = dataclasses.replace(level, dir0_se=torch.zeros_like(level.dir0_se), _blobs={})
    half = lambda out, i: tuple(t.clone() if j == i else t for j, t in enumerate(out))

    def gse_fault(out, i):
        out = half(out, i)
        out[i][:, :16] = 0
        return out

    def check_bwd(out_k, out_p, n_points):
        if f32:
            for a, b in zip(out_k[:n_points], out_p[:n_points]):
                _points_ok(a, b, True)
            _grads_ok(out_k[-1], out_p[-1], "float32")
        else:
            _tc_check(out_k, out_p, n_points, len(out_k) - 1)

    # K7 / K8
    rayd = lambda lv: k5.nerf_rayd_forward(pts, dirs, None, None, lv, compute_dtype,
                                           None, se=se)
    raw_k = rayd(level)
    raw_x = _plain_ref(k5.nerf_raw_plain, pts, dirs, None, None, level, compute_dtype,
                       None, None, se, out_k=raw_k)
    raw_p = k5.nerf_raw_plain(pts, dirs, None, None, level, compute_dtype, None, se=se)
    ok7 = lambda r: (float((r - raw_x).abs().max()) <= 1e-4 if f32 else
                     _field_scaled(r, raw_p) <= FIELD_GATE and _field_exact(r, raw_p, raw_x)[0])
    assert raw_k.shape == (P, 16) and ok7(raw_k) and not ok7(rayd(no_se))
    g = _tc_rayd_cotangent(rng, dev, raw_p, z, dirs, bg) if not f32 else \
        _gpu(dev, rng.randn(P, 16) * 0.01)
    rargs = (pts, dirs, None, None, g, level, compute_dtype, None, se)
    out_k = k2.nerf_rayd_vjp(*rargs)
    out_p = _plain_ref(k2.nerf_rayd_vjp_plain, *rargs, out_k=out_k)
    torch.cuda.synchronize()
    assert out_k[1].shape == (P, 32) and out_k[1].dtype == torch.float32
    check_bwd(out_k, out_p, 2)
    with pytest.raises(AssertionError):
        check_bwd(gse_fault(out_k, 1), out_p, 2)
    # K5 / K6
    largs = (pts, dirs, None, None, z, bg, noise)
    level_k = lambda lv: k5.nerf_level_forward(*largs, lv, compute_dtype, None, se)
    rgb_k, w_k = level_k(level)
    rgb_p, w_p = k5.nerf_level_plain(*largs, level, compute_dtype, None, se)
    if f32:
        ok5 = lambda o: max(float((o[0] - rgb_p).abs().max()),
                            float((o[1] - w_p).abs().max())) <= 1e-4
    else:
        out_x = level_exact.exact_plain(k5.nerf_level_plain, *largs, level, "bfloat16",
                                        None, se)
        ok5 = lambda o: _level_exact(o, (rgb_p, w_p), out_x)[0]
    assert ok5((rgb_k, w_k)) and not ok5(level_k(no_se))
    g_rgb, g_w = _tc_cotangents(dev, rng, rgb_p, w_p, z)
    vargs = largs + (g_rgb, g_w, level, compute_dtype, None, se)
    out_k = k2.nerf_level_vjp(*vargs)
    out_p = _plain_ref(k2.nerf_level_vjp_plain, *vargs, out_k=out_k)
    torch.cuda.synchronize()
    check_bwd(out_k, out_p, 3)
    with pytest.raises(AssertionError):
        check_bwd(gse_fault(out_k, 1), out_p, 3)
    # K2
    tgt = _gpu(dev, np.concatenate([rng.rand(R, 3), np.eye(12)[rng.randint(0, 12, R)]], 1))
    lw = _gpu(dev, np.stack([np.full(R, 1.0 / R), np.full(R, 0.02 / R)], 1))
    targs = largs + (tgt, lw, level, compute_dtype, None, 0.5, se)
    out_k = k2.nerf_level_train(*targs)
    out_p = _plain_ref(k2.nerf_level_train_plain, *targs, out_k=out_k)
    torch.cuda.synchronize()
    if f32:
        assert max(float((out_k[i] - out_p[i]).abs().max()) for i in (0, 1)) <= 1e-4
    else:
        assert max(_rel(out_k[i], out_p[i]) for i in (0, 1)) <= TC_GATES["out_rel"]
    assert out_k[3].shape == (P, 32)
    check_bwd(out_k[2:], out_p[2:], 3)
    with pytest.raises(AssertionError):
        check_bwd(gse_fault(out_k[2:], 1), out_p[2:], 3)
    assert [f.launches for f in held] == [c + n for c, n in zip(counts, (2, 1, 2, 1, 1))]


# ---------------------------------------------------------------------------
# The fused step's variants: K1 and K3 in their rays= form, K2 in its pair=
# form (sahs_tpu_torch/train/fused.py: SAHS_PAIR_RAYS, SAHS_PAIR_FOLD)
# ---------------------------------------------------------------------------

def _variant_rays(dev, rng, R, S):
    """Rays from a camera at z = 1.2 looking down -z, sorted z in [0.3, 1.6]."""
    ro = _gpu(dev, rng.randn(R, 3) * 0.05 + [0, 0, 1.2])
    rd = _gpu(dev, rng.randn(R, 3) * 0.3 + [0, 0, -1])
    z = _gpu(dev, np.sort(rng.uniform(0.3, 1.6, (R, S)), axis=-1))
    return ro, rd, z


def _fma_points(ro, rd, z):
    """o + d z rounded once to float32 (float64 holds the product exactly),
    as an FMA rounds it: K15's contract is two roundings."""
    return (ro.double()[:, None, :] + rd.double()[:, None, :] * z.double()[..., None]
            ).float().reshape(-1, 3)


def _trees_equal(a, b):
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(compare.leaves(a),
                                                          compare.leaves(b)))


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,S", [(2048, 64), (1024, 128), (37, 63)])
def test_pair_rays_forms_equal_positional_forms(card, rng, compute_dtype, R, S):
    """K1's and K3's rays= forms equal K15 then the positional form bit for
    bit: K1's packed points and rows, K3's every dW leaf with g2 (a ragged
    last tile at 37 x 63); each call counts once under its kernel."""
    dev, _, pair, _ = card
    rays = _variant_rays(dev, rng, R, S)
    pts = k15.build_pts(*rays)
    g = _gpu(dev, rng.randn(R * S, 5) * 0.1)
    g2 = _gpu(dev, rng.randn(R * S, 5) * 0.1)
    before = (k1.deform_pair_forward.launches, k1.deform_pair_vjp.launches)
    out_r, rows_r = k1.deform_pair_forward(None, pair, compute_dtype, S, GRID, rays=rays)
    t_r = k1.deform_pair_vjp(None, pair, g, g2, compute_dtype, rays=rays)
    assert (k1.deform_pair_forward.launches, k1.deform_pair_vjp.launches) == (
        before[0] + 1, before[1] + 1)
    out_k, rows_k = k1.deform_pair_forward(pts, pair, compute_dtype, S, GRID)
    t_k = k1.deform_pair_vjp(pts, pair, g, g2, compute_dtype)
    torch.cuda.synchronize()
    assert torch.equal(out_r, out_k) and torch.equal(rows_r, rows_k)
    assert _trees_equal(t_r, t_k)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_pair_rays_forms_fail_an_fma_position(card, rng, compute_dtype):
    """Planted fault: the positional forms on positions rounded once (an
    FMA) must differ from the rays= forms, which round as K15 does."""
    dev, _, pair, _ = card
    R, S = 512, 64
    rays = _variant_rays(dev, rng, R, S)
    fma = _fma_points(*rays)
    assert bool((fma != k15.build_pts(*rays)).any())
    g = _gpu(dev, rng.randn(R * S, 5) * 0.1)
    out_r, _ = k1.deform_pair_forward(None, pair, compute_dtype, S, GRID, rays=rays)
    out_f, _ = k1.deform_pair_forward(fma, pair, compute_dtype, S, GRID)
    t_r = k1.deform_pair_vjp(None, pair, g, None, compute_dtype, rays=rays)
    t_f = k1.deform_pair_vjp(fma, pair, g, None, compute_dtype)
    torch.cuda.synchronize()
    assert not torch.equal(out_r, out_f)
    assert not _trees_equal(t_r, t_f)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_deform_pair_vjp_rays_form_matches_plain(card, rng, compute_dtype):
    """K3's rays= form with g2 against its plain version (in bf16 with
    exact sums, within PLAIN_MULTIPLE of the plain version's distance);
    planted fault: g2 dropped must miss the gate."""
    dev, _, pair, _ = card
    R, S = 300, 64
    rays = _variant_rays(dev, rng, R, S)
    g = _gpu(dev, rng.randn(R * S, 5) * 0.1)
    g2 = _gpu(dev, rng.randn(R * S, 5) * 0.1)
    out_k = k1.deform_pair_vjp(None, pair, g, g2, compute_dtype, rays=rays)
    out_p = _plain_ref(k1.deform_pair_vjp_plain, None, pair, g, g2, compute_dtype,
                       False, rays, out_k=out_k)
    torch.cuda.synchronize()
    _grads_ok(out_k, out_p, compute_dtype)
    with pytest.raises(AssertionError):
        _grads_ok(k1.deform_pair_vjp(None, pair, g, None, compute_dtype, rays=rays),
                  out_p, compute_dtype)


def _pair_form_case(dev, model, rng, level, R, S, compute_dtype):
    """K2's arguments at R rays of S samples with a background, sigma noise,
    loss targets and bg_sup 0.5, then se None and the pair (PairWeights,
    ro) of K2's pair= form."""
    pts, dirs, table, rows, z, bg, noise = _level_case(dev, model, rng, R, S, True,
                                                       True, compute_dtype)
    tgt = _gpu(dev, np.concatenate([rng.rand(R, 3), np.eye(12)[rng.randint(0, 12, R)]], 1))
    lw = _gpu(dev, np.stack([np.full(R, 1.0 / R), np.full(R, 0.02 / R)], 1))
    ro = _gpu(dev, rng.randn(R, 3) * 0.05 + [0, 0, 1.2])
    return (pts, dirs, table, rows, z, bg, noise, tgt, lw, level, compute_dtype, GRID,
            0.5, None), ro


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_level_train_pair_form_matches_plain(card, rng, compute_dtype):
    """K2's pair= form against its plain version: the outputs, gse, g_bg,
    every level dW leaf and every pair dW leaf (f32 per leaf; bf16 with
    exact sums, within PLAIN_MULTIPLE of the plain version's distance: the
    pair's dW takes K2's gx, whose kink points sit off exact sums in either
    side's bf16 run, so its leaves are held by that rule alone), and bit
    for bit K2 then K3's rays= form on K2's gx in either dtype: rgb, the
    weights, g_bg, gse, every level dW leaf and every pair dW leaf (the
    same launches: K2's with gx to a scratch, then K3's on the rays'
    points). Planted fault: the pair's hyper head bias gradient dropped
    must miss the gate."""
    dev, model, pair, level = card
    args, ro = _pair_form_case(dev, model, rng, level, 96, 64, compute_dtype)
    before = k2.nerf_level_train.launches
    out_k = k2.nerf_level_train(*args, (pair, ro))
    assert k2.nerf_level_train.launches == before + 1
    out_p = _plain_ref(k2.nerf_level_train_plain, *args, (pair, ro), out_k=out_k)
    torch.cuda.synchronize()
    rgb_k, w_k, pg_k, gse_k, gbg_k, g_k = out_k
    rgb_p, w_p, pg_p, gse_p, gbg_p, g_p = out_p
    assert all(bool(torch.isfinite(t).all()) for t in (rgb_k, w_k, gse_k, gbg_k))
    if compute_dtype == "float32":
        assert float((rgb_k - rgb_p).abs().max()) <= 1e-4
        assert float((w_k - w_p).abs().max()) <= 1e-4
        for a, b in ((gse_k, gse_p), (gbg_k, gbg_p)):
            e = point_errors(a, b, 1e-4)
            assert e["n_over"] <= POINT_FLIPS and e["cosine"] >= 0.9999, e
    else:
        assert _rel(rgb_k, rgb_p) <= 2e-2 and _rel(w_k, w_p) <= 2e-2
    _grads_ok(g_k, g_p, compute_dtype)
    fault = {**pg_k, "hyper": {**pg_k["hyper"], "out": {
        "w": pg_k["hyper"]["out"]["w"], "b": torch.zeros_like(pg_k["hyper"]["out"]["b"])}}}
    if compute_dtype == "float32":
        _grads_ok(pg_k, pg_p, compute_dtype)
        with pytest.raises(AssertionError):
            _grads_ok(fault, pg_p, compute_dtype)
    else:   # the exact-sum rule, which _plain_ref held pg_k to
        d_p = tree_errors(k2.nerf_level_train_plain(*args, (pair, ro))[2], pg_p)["l2_rel"]
        assert tree_errors(fault, pg_p)["l2_rel"] > PLAIN_MULTIPLE * max(d_p, PLAIN_FLOOR)
    # K2 then K3's rays= form on K2's gx
    rgb_d, w_d, gx_d, gse_d, gbg_d, g_d = k2.nerf_level_train(*args)
    pg_d = k1.deform_pair_vjp(None, pair, gx_d, None, compute_dtype,
                              rays=(ro, args[1], args[4]))
    torch.cuda.synchronize()
    for a, b in ((rgb_k, rgb_d), (w_k, w_d), (gbg_k, gbg_d), (gse_k, gse_d)):
        assert torch.equal(a, b)
    assert _trees_equal(g_k, g_d) and _trees_equal(pg_k, pg_d)


@pytest.mark.cuda
def test_fused_step_variants_match_default(card, monkeypatch):
    """Each structural variant's float32 fused step (256 rays, 64 + 64)
    against the default step on the same draws: the loss within 1e-5 (the
    split 1e-6), every gradient entry within rtol 2e-4 / atol 2e-6 (the
    split 1e-4 / 1e-6), tests/test_fused_train.py's tolerances; the
    variant's launches a step as its structure says."""
    dev = card[0]
    want = {(): {"K1": 2, "K2": 2, "K3": 1, "K4": 1, "K15": 2},
            ("_BWD_SPLIT",): {"K1": 2, "K2": 2, "K3": 2, "K4": 2, "K15": 2},
            ("_UNION",): {"K1": 2, "K2": 2, "K3": 1, "K9": 1, "K15": 2},
            ("_PAIR_RAYS",): {"K1": 2, "K2": 2, "K3": 1, "K4": 1},
            ("_PAIR_FOLD",): {"K1": 2, "K2": 2, "K4": 2, "K15": 2},
            ("_PAIR_RAYS", "_PAIR_FOLD"): {"K1": 2, "K2": 2, "K4": 2},
            ("_PAIR_RAYS", "_UNION"): {"K1": 2, "K2": 2, "K3": 1, "K9": 1, "K15": 2}}
    runs = {}
    for on, launches in want.items():
        for f in ("_BWD_SPLIT", "_UNION", "_PAIR_RAYS", "_PAIR_FOLD"):
            monkeypatch.setattr(fused, f, f in on)
        runs[on] = _f32_step(dev, monkeypatch, False, True)
        got = {k: n for k, n in runs[on][2].items() if n}
        assert got == launches, (on, got)
    loss_d, g_d = runs[()][:2]
    for on, (loss, g) in ((o, r[:2]) for o, r in runs.items() if o):
        l_tol, rtol, atol = (1e-6, 1e-4, 1e-6) if on == ("_BWD_SPLIT",) else (1e-5, 2e-4,
                                                                            2e-6)
        assert abs(loss - loss_d) <= l_tol * abs(loss_d), (on, loss, loss_d)
        for n, b in g_d.items():
            torch.testing.assert_close(g[n], b, rtol=rtol, atol=atol, msg=f"{on} {n}")
