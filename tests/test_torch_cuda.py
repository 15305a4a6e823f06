"""The port's CUDA kernels on the card: K1 (deform pair), K5 (NeRF level),
K2 (level train), K3 (pair backward) and K4 (dGrid) against their plain
versions, the kernel path of render_rays against the plain path, and a
train step through the kernels against the same step on the plain versions.
Marked ``cuda``; without a CUDA device they skip. This file imports no JAX,
so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances: float32 within 1e-4 absolute (the kernels sum in another order
than cuBLAS) and corner rows exact; bfloat16 within 2e-2 relative, the bf16
gate of PARITY_TPU.json (the two sides round the same operands to bf16 but
sum them in another order, so a value rounds differently now and then).
"""
import numpy as np
import pytest
import torch

from sahs_tpu_torch.config import Config
from sahs_tpu_torch.models import nerface
from sahs_tpu_torch.ops.grid import _cell_geometry, pack_corner_table
from sahs_tpu_torch.ops.kernels import deform_pair as k1
from sahs_tpu_torch.ops.kernels import grid_bwd as k4
from sahs_tpu_torch.ops.kernels import level_train as k2
from sahs_tpu_torch.ops.kernels import nerf_level as k5
from sahs_tpu_torch.render.pipeline import RenderSettings, render_rays
from sahs_tpu_torch.train import fused
from sahs_tpu_torch.utils.compare import point_errors, tree_errors

GRID = (32, 32, 32)


@pytest.fixture(scope="module")
def card():
    """The flagship model with seeded weights on the card, its per-frame
    folded weights, and a numpy random state for the inputs."""
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
    yield dev, model, pair, level, rng
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32


def _gpu(dev, a):
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def _rel(a, b):
    """max |a - b| / (|b| + 1e-3), the metric of PARITY_TPU.json."""
    return float(((a.double() - b.double()).abs() / (b.double().abs() + 1e-3)).max())


def _scaled(a, b):
    """max |a - b| / max |b|, for outputs that pass through zero."""
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [16, 128])
def test_deform_pair_kernel_matches_plain(card, compute_dtype, S):
    dev, _, pair, _, rng = card
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
        assert _scaled(out_k, out_p) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,with_bg,with_noise", [
    (16, True, True), (16, False, False), (128, True, False), (64, False, True)])
def test_nerf_level_kernel_matches_plain(card, compute_dtype, S, with_bg,
                                         with_noise):
    dev, model, _, level, rng = card
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
        assert _rel(rgb_k, rgb_p) <= 2e-2
        assert _rel(w_k, w_p) <= 2e-2


@pytest.mark.cuda
def test_wrapper_refuses_weights_on_another_device(card):
    dev, _, pair, _, _ = card
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
def test_render_rays_kernel_path_matches_plain_path(card):
    """render_rays on the card, 64 + 64 samples, float32, deterministic:
    K1 + K5 against the plain path, which runs no kernel."""
    dev, model, _, _, rng = card
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
def test_level_train_kernel_matches_plain(card, compute_dtype, S, with_bg,
                                          with_noise, bg_sup):
    dev, model, _, level, rng = card
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
    out_p = k2.nerf_level_train_plain(*args)
    torch.cuda.synchronize()
    assert k2.nerf_level_train.launches == before + 1
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
    _grads_ok(g_k, g_p, compute_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_deform_pair_vjp_kernel_matches_plain(card, compute_dtype):
    dev, _, pair, _, rng = card
    P = 300 * 64 + 17
    pts = _gpu(dev, rng.uniform(-0.6, 0.6, (P, 3)))
    g = _gpu(dev, rng.randn(P, 5) * 0.1)
    g2 = _gpu(dev, rng.randn(P, 5) * 0.1)
    before = k1.deform_pair_vjp.launches
    out_k = k1.deform_pair_vjp(pts, pair, g, g2, compute_dtype)
    out_p = k1.deform_pair_vjp_plain(pts, pair, g, g2, compute_dtype)
    torch.cuda.synchronize()
    assert k1.deform_pair_vjp.launches == before + 1
    _grads_ok(out_k, out_p, compute_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("with_addend", [False, True])
def test_grid_dg_kernel_matches_plain(card, with_addend):
    dev, _, _, _, rng = card
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
    """One float32 train step (256 rays, 64 + 64 samples) through K1-K4
    against the same step with the plain versions put in the kernels'
    place (no kernel launches then), same weights and draws: the loss
    within 1e-5 relative, the gradients within the step's gates."""
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
                  k1.deform_pair_vjp.launches, k4.grid_dg.launches)
        step = stage1.make_train_step(spec, ts, device=dev)
        with monkeypatch.context() as mp:
            if not use_kernels:
                mp.setattr(fused, "deform_pair_forward", k1.deform_pair_plain)
                mp.setattr(fused, "deform_pair_vjp", k1.deform_pair_vjp_plain)
                mp.setattr(fused, "grid_dg", k4.grid_dg_plain)
                mp.setattr(k2, "nerf_level_train", k2.nerf_level_train_plain)
            st, m = step(st, batch, draws=draws)
        launches = (k1.deform_pair_forward.launches - before[0],
                    k2.nerf_level_train.launches - before[1],
                    k1.deform_pair_vjp.launches - before[2],
                    k4.grid_dg.launches - before[3])
        grads = {n: p.grad for n, p in st.model.named_parameters()}
        res[use_kernels] = (m, grads, launches, st.sample_prob)
    (m_k, g_k, l_k, sp_k), (m_p, g_p, l_p, sp_p) = res[True], res[False]
    assert l_k == (2, 2, 1, 1) and l_p == (0, 0, 0, 0)
    assert abs(float(m_k["loss"]) - float(m_p["loss"])) <= 1e-5 * abs(float(m_p["loss"]))
    _grads_ok(g_k, g_p, "step")
    assert float((sp_k - sp_p).abs().max()) <= 1e-4
