"""The reference of the bf16 backward card tests, on the CPU:
``tools/level_exact.exact_plain`` (the plain version with its products'
operands rounded to bf16 and every product and sum in float64) and the
levels the card tests hold K2 on without a background.

  (a) every result of the four level plain versions (K2, K6, K8, K12), with
      and without the grid, and of the deformation nets' (K3, and K14 on
      the warp and the hyper net, the points' cotangent asked for), comes
      out in float64 and stays within bf16 rounding of the plain version
      itself; so does the raw field of the two forwards' (K7
      ``nerf_raw_plain``, K11 ``nerf_mlp_plain``), which in float32 agrees
      with their float32 run to float32 rounding, and the output of one
      deformation net's forward (K13 ``skip_mlp_plain``, warp and hyper);
  (b) a product whose operands bypass ``field_mlp.round_to`` raises
      inside ``exact_sums`` instead of summing in float32 unseen, and the
      patched functions are restored afterwards;
  (c) the grid model's "varied" level (tests/test_torch_cuda.py:grid_varied)
      keeps the plain version's sigma head within a gate of a float64 run,
      as tests/test_torch_gridfree.py holds the grid-free one;
  (d) ``tools/point_spread.spread`` finds where a per-point distance
      sits, and ``utils/compare``'s kink gate excuses the points off at a
      leaky ReLU's kink alone and counts them against its cap;
  (e) K5's and K1's plain versions (``nerf_level_plain``,
      ``deform_pair_plain``) run with exact sums in float64, the
      compositing too;
  (f) ``level_exact.exact_plain_at_branches`` (the Queue-3 reference
      that takes the kernel's side of the kink at the excused points):
      given every leaky unit's own branch it is ``exact_plain`` bit for
      bit; one unit's branch flipped at one point moves that point's gx
      and that ray's, and no other ray's; for K6's plain version and for
      K2's (``nerf_level_train_plain``).
"""
import numpy as np
import pytest
import torch

from sahs_tpu_torch.config import Config
from sahs_tpu_torch.models import nerface
from sahs_tpu_torch.ops.grid import _cell_geometry, pack_corner_table
from sahs_tpu_torch.ops.kernels import deform_pair as k1
from sahs_tpu_torch.ops.kernels import field_mlp
from sahs_tpu_torch.ops.kernels import level_train as k2
from sahs_tpu_torch.ops.kernels import nerf_level as k5
from sahs_tpu_torch.ops.kernels import nerf_mlp as k11
from sahs_tpu_torch.ops.kernels import skip_mlp as k13
from sahs_tpu_torch.tools import level_exact, point_spread, sigma_head
from sahs_tpu_torch.utils import compare
from sahs_tpu_torch.utils.compare import point_errors, tree_errors

torch.set_num_threads(2)

GRID = level_exact.GRID
R, S = 4, 16


@pytest.fixture(scope="module")
def levels():
    return {grid: level_exact.coarse_level("seeded", grid, torch.float32,
                                           torch.device("cpu"))
            for grid in (True, False)}


def _inputs(levels, grid):
    level, model = levels[grid]
    rng = np.random.RandomState(3)
    g = lambda a: torch.tensor(np.asarray(a, np.float32))
    P = R * S
    pts = g(np.concatenate([rng.uniform(-1.05, 1.05, (P, 3)),
                            rng.uniform(-1, 1, (P, 2))], 1))
    dirs = g(rng.randn(R, 3) * 0.1 + [0, 0, -1])
    z = g(np.sort(rng.uniform(0.48, 1.08, (R, S)), axis=-1))
    bg, noise = g(rng.rand(R, 15)), g(rng.randn(R, S) * 0.5)
    tgt = g(np.concatenate([rng.rand(R, 3), np.eye(12)[rng.randint(0, 12, R)]], 1))
    lw = g(np.stack([np.full(R, 1.0 / R), np.full(R, 0.02 / R)], 1))
    table = (pack_corner_table(model.spatial_embeddings.detach(), dtype=torch.bfloat16)
             if grid else None)
    rows = _cell_geometry(pts, GRID)[0] if grid else None
    dims = GRID if grid else None
    base = (pts, dirs, table, rows)
    C = level.dir0_se.shape[0]
    extra = torch.cat([dirs.repeat_interleave(S, dim=0), g(rng.randn(P, C) * 0.3)], 1)
    graw = g(rng.randn(P, 16) * 1e-2)
    return {
        "K2": (k2.nerf_level_train_plain, base + (z, bg, noise, tgt, lw, level,
                                                   "bfloat16", dims, 0.5)),
        "K6": (k2.nerf_level_vjp_plain, base + (z, bg, noise, g(rng.randn(R, 16) * 1e-2),
                                                 g(rng.randn(R, S) * 1e-3), level,
                                                 "bfloat16", dims)),
        "K8": (k2.nerf_rayd_vjp_plain, base + (graw, level, "bfloat16", dims)),
        "K12": (k2.nerf_mlp_vjp_plain, (pts, extra, graw, level, "bfloat16")),
        "K7": (k5.nerf_raw_plain, base + (level, "bfloat16", dims)),
        "K11": (k11.nerf_mlp_plain, (pts, extra, level, "bfloat16")),
    }


@pytest.mark.parametrize("grid", [True, False])
@pytest.mark.parametrize("kernel", ["K2", "K6", "K8", "K12"])
def test_exact_plain_sums_every_product_in_float64(levels, grid, kernel):
    plain, args = _inputs(levels, grid)[kernel]
    out_x = level_exact.exact_plain(plain, *args)
    out_p = plain(*args)
    assert field_mlp.round_to(torch.ones(2), torch.bfloat16).dtype == torch.float32
    for x, p in zip(out_x, out_p):
        if isinstance(p, dict):
            for path_x, path_p in zip(_leaves(x), _leaves(p)):
                assert path_x.dtype == torch.float64
            e = tree_errors(x, p)
            assert e["l2_rel"] <= 5e-2 and e["cosine"] >= 0.999, e
        elif p is not None:
            assert x.dtype == torch.float64
            assert point_errors(x, p)["l2_rel"] <= 5e-2


# float32 sums against float64 ones over the flagship's widths: a few
# float32 ulps of each raw value
F32_VS_F64 = 1e-6


@pytest.mark.parametrize("grid", [True, False])
@pytest.mark.parametrize("kernel", ["K7", "K11"])
def test_exact_plain_runs_the_forwards_in_float64(levels, grid, kernel):
    """The reference of the tensor-core K7 and K11 on the card: the raw
    field comes out in float64, within bf16 rounding of the plain version
    in bfloat16, and in float32 (no operand rounded) within F32_VS_F64 of
    the plain version's float32 run."""
    plain, args = _inputs(levels, grid)[kernel]
    out_x, out_p = level_exact.exact_plain(plain, *args), plain(*args)
    assert out_x.dtype == torch.float64 and out_p.dtype == torch.float32
    assert out_x.shape == out_p.shape == (R * S, 16)
    assert point_errors(out_x, out_p)["l2_rel"] <= 5e-2
    f32 = tuple("float32" if isinstance(a, str) else a for a in args)
    out_x, out_p = level_exact.exact_plain(plain, *f32), plain(*f32)
    assert out_x.dtype == torch.float64
    e = point_errors(out_x, out_p)
    assert e["l2_rel"] <= F32_VS_F64 and e["cosine"] >= 1 - 1e-9, e
    assert field_mlp.round_to(torch.ones(2), torch.bfloat16).dtype == torch.float32
    assert k5._cell_geometry is _cell_geometry


@pytest.mark.parametrize("with_bg", [True, False])
@pytest.mark.parametrize("grid", [True, False])
def test_exact_plain_runs_the_level_forward_in_float64(levels, grid, with_bg):
    """The reference of the tensor-core K5 on the card: rgb_map and the
    weights come out in float64 (the compositing too), within bf16
    rounding of the plain version in bfloat16, and in float32 (no operand
    rounded) within F32_VS_F64 of the plain version's float32 run."""
    _, args = _inputs(levels, grid)["K6"]
    args = args[:5] + (args[5] if with_bg else None,) + args[6:7] + args[9:]
    for dtype, gate, cosine in (("bfloat16", 5e-2, 0.999),
                                ("float32", F32_VS_F64, 1 - 1e-9)):
        a = args[:8] + (dtype,) + args[9:]
        out_x = level_exact.exact_plain(k5.nerf_level_plain, *a)
        out_p = k5.nerf_level_plain(*a)
        assert [t.dtype for t in out_x] == [torch.float64] * 2
        assert [t.dtype for t in out_p] == [torch.float32] * 2
        assert out_x[0].shape == (R, 16) and out_x[1].shape == (R, S)
        for x, p in zip(out_x, out_p):
            e = point_errors(x, p)
            assert e["l2_rel"] <= gate and e["cosine"] >= cosine, (dtype, e)
    assert k5._cell_geometry is _cell_geometry


@pytest.mark.parametrize("grid", [True, False])
def test_exact_plain_runs_the_deformation_pair_in_float64(grid):
    """The reference of the tensor-core K1 on the card: the packed points
    come out in float64, within bf16 rounding of the plain version in
    bfloat16, and in float32 (no operand rounded) within F32_VS_F64 of the
    plain version's float32 run; the rows (of the float64 output) are
    those of the plain version's own output but where a coordinate sits on
    a cell's face within float32 rounding."""
    _, (pts, pair, _, _, _) = _deform_inputs("K3")
    dims = GRID if grid else None
    for dtype, gate in (("bfloat16", 5e-2), ("float32", F32_VS_F64)):
        (out_x, rows_x) = level_exact.exact_plain(k1.deform_pair_plain, pts, pair, dtype,
                                                  1, dims)
        out_p, rows_p = k1.deform_pair_plain(pts, pair, dtype, 1, dims)
        assert out_x.dtype == torch.float64 and out_p.dtype == torch.float32
        assert out_x.shape == out_p.shape == (pts.shape[0], 5)
        for cols in (slice(0, 3), slice(3, 5)):
            e = point_errors(out_x[:, cols] - (pts.double() if cols.start == 0 else 0),
                             out_p[:, cols] - (pts if cols.start == 0 else 0))
            assert e["l2_rel"] <= gate, (dtype, e)
        assert (rows_x is None) == (rows_p is None) == (not grid)
        if grid:
            assert (rows_x != rows_p).float().mean() <= 0.01
    assert field_mlp.round_to(torch.ones(2), torch.bfloat16).dtype == torch.float32


def _deform_inputs(kernel):
    """(plain version, arguments) of K3 or K14 on the flagship's seeded
    deformation nets, 200 points (not a multiple of the 64-point tile)."""
    spec = nerface.ModelSpec.from_config(Config())
    model = nerface.NeRFaceModel.init(spec, seed=0, device="cpu")
    rng = np.random.RandomState(5)
    g = lambda a: torch.tensor(np.asarray(a, np.float32))
    cond = g(rng.randn(76 + 36) * 0.5)
    warp_g = nerface.build_pe_groups(spec)[0]
    P = 200
    pts = g(rng.uniform(-1.05, 1.05, (P, 3)))
    if kernel == "K3":
        pair = k1.prepare_pair(model.warp, model.hyper, cond, warp_g)
        return k1.deform_pair_vjp_plain, (pts, pair, g(rng.randn(P, 5) * 0.1),
                                          g(rng.randn(P, 5) * 0.1), "bfloat16")
    net, act, out = {"K14 warp": ("warp", "tanh", 3),
                     "K14 hyper": ("hyper", "linear", 2)}[kernel]
    w = k13.prepare_skip(getattr(model, net), cond, warp_g, act)
    return k13.skip_mlp_vjp_plain, (pts, w, g(rng.randn(P, out) * 0.1), True,
                                    "bfloat16")


@pytest.mark.parametrize("kernel", ["K3", "K14 warp", "K14 hyper"])
def test_exact_plain_sums_the_deformation_nets_in_float64(kernel):
    plain, args = _deform_inputs(kernel)
    out_x = level_exact.exact_plain(plain, *args)
    out_p = plain(*args)
    assert field_mlp.round_to(torch.ones(2), torch.bfloat16).dtype == torch.float32
    assert k13.pe_backward is field_mlp.pe_backward
    if kernel == "K3":
        out_x, out_p = (None, out_x), (None, out_p)
    gx_x, g_x = out_x
    gx_p, g_p = out_p
    assert all(t.dtype == torch.float64 for t in _leaves(g_x))
    e = tree_errors(g_x, g_p)
    assert e["l2_rel"] <= 5e-2 and e["cosine"] >= 0.999, e
    if gx_p is not None:
        assert gx_x.dtype == torch.float64 and gx_x.shape == gx_p.shape
        assert point_errors(gx_x, gx_p)["l2_rel"] <= 5e-2


@pytest.mark.parametrize("net", ["warp", "hyper"])
def test_exact_plain_runs_one_deformation_net_in_float64(net):
    """The reference of the tensor-core K13 on the card: the output comes
    out in float64, within bf16 rounding of the plain version in bfloat16,
    and in float32 (no operand rounded) within F32_VS_F64 of its float32
    run."""
    _, (pts, w, g, _, _) = _deform_inputs(f"K14 {net}")
    out_x = level_exact.exact_plain(k13.skip_mlp_plain, pts, w, "bfloat16")
    out_p = k13.skip_mlp_plain(pts, w, "bfloat16")
    assert out_x.dtype == torch.float64 and out_x.shape == out_p.shape == g.shape
    assert point_errors(out_x, out_p)["l2_rel"] <= 5e-2
    out_x = level_exact.exact_plain(k13.skip_mlp_plain, pts, w, "float32")
    e = point_errors(out_x, k13.skip_mlp_plain(pts, w, "float32"))
    assert e["l2_rel"] <= F32_VS_F64 and e["cosine"] >= 1 - 1e-9, e
    assert field_mlp.round_to(torch.ones(2), torch.bfloat16).dtype == torch.float32


def test_point_spread_finds_the_points_that_carry_a_distance():
    """(d) A distance planted in 3 of 1000 points: they carry all of the
    squared distance (worst 10 and worst 1 %), and without the worst 1 %
    the rest reads the background error alone."""
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.randn(1000, 3))
    a = x + 1e-6 * torch.tensor(rng.randn(1000, 3))
    a[[5, 50, 500]] += 1.0
    s = point_spread.spread(a, x)
    assert s["top10_share"] > 0.999 and s["top1pct_share"] > 0.999
    assert sorted(s["worst10"][:3]) == [5, 50, 500]
    assert s["l2_rel"] > 1e-2 and s["l2_rel_without_top1pct"] < 2e-6


def _kink_case(kink_at, P=1000, seed=4):
    """Synthetic leaky-ReLU outputs of a level (two trunk layers, one layer
    of each branch) whose pre-activations all lie at least 0.1 of their
    unit's RMS from 0 but at the points ``kink_at``, where one unit's lies
    within 1e-4 of it (on the negative side at every other such point)."""
    rng = np.random.RandomState(seed)
    leaky = lambda v: torch.where(v >= 0, v, 0.01 * v)
    layers = []
    for width in (64, 64, 32, 32):
        v = rng.randn(P, width)
        v = np.sign(v) * np.maximum(np.abs(v), 0.2)
        for i, p in enumerate(kink_at):
            v[p, (7 * i) % width] = 1e-4 * (-1) ** i
        layers.append(leaky(torch.tensor(v)))
    return {"trunk": layers[:2], "dacts": layers[2:3], "sacts": layers[3:]}


def test_kink_points_excuse_points_off_at_a_kink_only():
    """utils/compare's kink gate on synthetic data: the points planted at a
    kink (either side of 0) are the kink points; off by far more than
    KINK_TOL there, they are excused (within the cap) and the rest reads
    the background error; a point off as far but away from any kink is not
    excused, and the gate over the rest fails; more kink points off than
    the cap (KINK_SHARE of the points) fail the cap."""
    P = 1000
    at = [5, 50, 500]
    kinks = compare.kink_points(_kink_case(at))
    assert kinks.shape == (P,) and sorted(torch.nonzero(kinks)[:, 0].tolist()) == at
    assert compare.kink_cap(P) == 10
    rng = np.random.RandomState(5)
    x = torch.tensor(rng.randn(P, 3))
    a = x + 1e-6 * torch.tensor(rng.randn(P, 3))
    a[at] += 1.0
    off = compare.excused_points(a, x, kinks)
    assert sorted(torch.nonzero(off)[:, 0].tolist()) == at
    assert int(off.sum()) <= compare.kink_cap(P)
    assert point_errors(a, x)["l2_rel"] > 1e-2
    assert point_errors(a[~off], x[~off])["l2_rel"] < 1e-5
    b = a.clone()
    b[7] += 1.0                      # off, but at no kink
    off = compare.excused_points(b, x, kinks)
    assert not bool(off[7]) and int(off.sum()) == 3
    assert point_errors(b[~off], x[~off])["l2_rel"] > 1e-2
    many = list(range(0, P, 90))     # 12 points, more than the cap
    kinks = compare.kink_points(_kink_case(many))
    c = x.clone()
    c[many] += 1.0
    off = compare.excused_points(c, x, kinks)
    assert sorted(torch.nonzero(off)[:, 0].tolist()) == many
    assert int(off.sum()) > compare.kink_cap(P)


def _leaves(tree):
    from sahs_tpu_torch.utils.compare import leaves
    return [t for _, t in leaves(tree)]


def test_exact_sums_refuses_a_product_past_round_to(levels, monkeypatch):
    plain, args = _inputs(levels, True)["K12"]
    bf = lambda x: x.to(torch.bfloat16).to(torch.float32)
    monkeypatch.setattr(k2, "mm", lambda a, w, dtype: bf(a) @ bf(w))
    with pytest.raises(RuntimeError, match="exact_sums"):
        level_exact.exact_plain(plain, *args)
    assert field_mlp.round_to(torch.ones(2, dtype=torch.float64),
                              torch.bfloat16).dtype == torch.float32
    assert k2.pe_backward is field_mlp.pe_backward


@pytest.mark.parametrize("compute_dtype,gate", [("float32", 1e-4),
                                                ("bfloat16", 5e-2)])
def test_grid_varied_level_conditions_the_sigma_head(compute_dtype, gate):
    """The grid model's level whose colours vary along a ray keeps the
    plain version's sigma head within ``gate`` of a float64 run (the seeded
    level's does not: tools/sigma_head.py), so the card tests can hold K2
    without a background there at the gates."""
    row = sigma_head.case("varied", True, 1, compute_dtype, torch.device("cpu"))
    assert row["head_plain_vs_float64"] <= gate, row


def _own_branches(vargs):
    """K6's exact-sum run's own leaky branches, as ``kernel_branches``
    lays a kernel's out."""
    acts = level_exact.exact_acts(k5.nerf_raw_plain, *vargs[:4], *vargs[9:12])
    return [y > 0 for y in list(acts["trunk"]) + list(acts["dacts"]) + list(acts["sacts"])]


def _check_given_branches(plain, vargs, gx, grads):
    """``exact_plain_at_branches`` on ``vargs`` (gx and the grads tree at
    results ``gx`` and ``grads``): every unit's own branch at every point
    gives ``exact_plain`` bit for bit; one unit's branch flipped at point 5
    moves that point's gx and its ray's, and no other ray's; a branch list
    of the wrong length raises. Returns the two runs' results."""
    ref = level_exact.exact_plain(plain, *vargs)
    own = _own_branches(vargs)
    P = vargs[0].shape[0]
    every = torch.ones(P, dtype=torch.bool)
    same = level_exact.exact_plain_at_branches(plain, vargs, every, own)
    assert torch.equal(same[gx], ref[gx])
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(compare.leaves(same[grads]),
                                                           compare.leaves(ref[grads])))
    # flip the branch of the trunk[2] unit closest to its kink at point 5
    acts = level_exact.exact_acts(k5.nerf_raw_plain, *vargs[:4], *vargs[9:12])
    y = acts["trunk"][2][5]
    unit = int(torch.where(y >= 0, y, y / 0.01).abs().argmin())
    flipped = [b.clone() for b in own]
    flipped[2][5, unit] = ~flipped[2][5, unit]
    at = torch.zeros(P, dtype=torch.bool)
    at[5] = True
    moved = level_exact.exact_plain_at_branches(plain, vargs, at, flipped)
    d = (moved[gx] - ref[gx]).abs().amax(dim=1)
    assert float(d[5]) > 0
    assert not d[S:].any()             # point 5 is on ray 0; the other rays hold
    with pytest.raises(RuntimeError, match="leaky layers"):
        level_exact.exact_plain_at_branches(plain, vargs, at, flipped + flipped[:1])
    return ref, moved


@pytest.mark.parametrize("grid", [True, False])
def test_exact_plain_at_branches_takes_the_given_branch_at_the_given_points(levels, grid):
    plain, vargs = _inputs(levels, grid)["K6"]
    _check_given_branches(plain, vargs, 0, 3)


@pytest.mark.parametrize("grid", [True, False])
def test_exact_plain_at_branches_takes_the_given_branch_in_k2(levels, grid):
    """The same for K2's plain version (gx its result 2, the grads 5), the
    reference of K2 in the grid-free Queue-3 card test; the composited
    colours of the other rays hold too, and ``plain_branches`` reads K2's
    arguments as it reads K6's."""
    plain, targs = _inputs(levels, grid)["K2"]
    ref, moved = _check_given_branches(plain, targs, 2, 5)
    assert torch.equal(moved[0][1:], ref[0][1:])
    _, vargs = _inputs(levels, grid)["K6"]
    assert all(torch.equal(a, b) for a, b in zip(level_exact.plain_branches(targs),
                                                 level_exact.plain_branches(vargs)))
