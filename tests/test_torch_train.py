"""The port's Stage-I train step and the plain versions of its new kernels
against the JAX package (Pallas in interpret mode, float32, the exact-f32
PE angle):

  (a) losses, ray_loss_weights, get_rays_at
  (b) weighted_ray_indices: the same indices
  (c) K3 deform_pair_vjp_plain vs field_mlp.deform_pair_vjp (with g2)
  (d) K4 grid_dg_plain vs grid_dg_slab_packed and _grid_cotangent
  (e) K2 level_train_apply vs level_train.level_train_apply
  (f) stage1_fused vs train/fused.stage1_fused
  (g) one train_step vs the JAX train_step under SGD(1.0)
  (h) the port's Adam and schedule vs optax

Tolerances: outputs within 3e-5 relative. A kernel's gradients, on the
same inputs as JAX's, within rtol 5e-3 (tests/test_fused_train.py's, the
sums being taken in another order) and an absolute 1e-3 of each leaf's
own largest JAX entry, so that a small leaf (a bias gradient near 1e-7) is
held to its own scale. A whole step's gradients, leaf by leaf (every
weight and every bias on its own), within 5e-2 L2-relative (ROADMAP's
fused-vs-autograd f32 gate) and 0.998 cosine: the points reach the NeRF
through K1 and a positional encoding of frequency up to 2^9, so one
rounding step of a point flips the ReLUs whose input lies within ~1e-5 of
0 and moves the early layers' gradients by some 1e-3 (chip_smoke.py
prints what moving the camera one ulp does to a step), and the two sides
round K1's output differently. Indices and rows exactly.
"""
import dataclasses

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from sahs_tpu.config import Config
from sahs_tpu.data.synthetic import SyntheticFaceDataset
from sahs_tpu.models import nerface as jn
from sahs_tpu.ops import grid as jgrid
from sahs_tpu.ops import losses as jl
from sahs_tpu.ops import rays as jrays
from sahs_tpu.ops import sampling as jsamp
from sahs_tpu.ops.pallas import field_mlp as jfm
from sahs_tpu.ops.pallas import grid_bwd as jgb
from sahs_tpu.ops.pallas import level_train as jlt
from sahs_tpu.ops.pallas.field_grid import gather_corners_from_rows
from sahs_tpu.train import fused as jfused
from sahs_tpu.train import stage1 as jstage1

from sahs_tpu_torch.config import Config as TConfig
from sahs_tpu_torch.models import nerface as tn
from sahs_tpu_torch.ops import losses as tl
from sahs_tpu_torch.ops import rays as trays
from sahs_tpu_torch.ops import sampling as tsamp
from sahs_tpu_torch.ops.grid import _cell_geometry, pack_corner_table
from sahs_tpu_torch.ops.kernels import deform_pair as k1
from sahs_tpu_torch.ops.kernels import grid_bwd as k4
from sahs_tpu_torch.ops.kernels import level_train as k2
from sahs_tpu_torch.train import fused as tfused
from sahs_tpu_torch.train import stage1 as tstage1
from sahs_tpu_torch.utils.weights import grads_to_jax, params_from_jax, params_to_jax

torch.set_num_threads(2)

GRID = (32, 32, 32)
OUT_RTOL = 3e-5
G_RTOL, G_SCALE = 5e-3, 1e-3
STEP_L2, STEP_COS = 5e-2, 0.998


def _t(x):
    return torch.tensor(np.asarray(x))


def _n(x):
    return np.asarray(x.detach().cpu()) if torch.is_tensor(x) else np.asarray(x)


def _gscale(b):
    """The absolute tolerance of a gradient: G_SCALE of its largest entry."""
    return G_SCALE * float(np.abs(np.asarray(b)).max(initial=0.0))


def _tree_pairs(a, b, path="grads"):
    """(path, port leaf, JAX leaf) over the JAX tree layout."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            yield from _tree_pairs(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _tree_pairs(x, y, f"{path}[{i}]")
    else:
        yield path, _n(a), np.asarray(b)


def _leaf_norm_close(path, x, y):
    x, y = x.astype(np.float64).ravel(), y.astype(np.float64).ravel()
    ny = np.linalg.norm(y)
    assert ny > 0, path
    rel = np.linalg.norm(x - y) / ny
    cos = float(x @ y) / (np.linalg.norm(x) * ny + 1e-300)
    assert rel <= STEP_L2 and cos >= STEP_COS, (path, rel, cos)


def assert_tree_close(a, b, rtol=G_RTOL, by_norm=()):
    """Leaf by leaf, each within ``rtol`` and G_SCALE of its own largest
    entry; a leaf whose path holds one of ``by_norm`` by its norm and
    cosine instead (STEP_L2, STEP_COS)."""
    for path, x, y in _tree_pairs(a, b):
        if any(n in path for n in by_norm):
            _leaf_norm_close(path, x, y)
        else:
            np.testing.assert_allclose(x, y, rtol=rtol, atol=_gscale(y),
                                       err_msg=path)


def assert_step_grads_close(a, b):
    """A whole step's gradients: every leaf within STEP_L2 of its own norm
    and at a cosine of at least STEP_COS."""
    for path, x, y in _tree_pairs(a, b):
        _leaf_norm_close(path, x, y)


def tiny_cfg(cls=Config, **runtime):
    """tests/test_fused_train.py's tiny_cfg: 48 rays, 8 + 8 samples, f32."""
    cfg = cls()
    cfg.nerf.train.num_random_rays = 48
    cfg.nerf.train.num_coarse = 8
    cfg.nerf.train.num_fine = 8
    cfg.runtime.use_pallas = True
    cfg.runtime.compute_dtype = "float32"
    for k, v in runtime.items():
        setattr(cfg.runtime, k, v)
    return cfg


@pytest.fixture(scope="module")
def flagship():
    """Flagship widths: the port's seeded weights, handed to JAX as its
    parameter tree. The sigma bias is lifted so that the weights are live,
    and the rgb head scaled so that colours vary along a ray: at the seeded
    init they are all but equal, and sigma's gradient, a difference of a
    ray's colours, would be rounding alone."""
    model = tn.NeRFaceModel.init(tn.ModelSpec.from_config(TConfig()), seed=0,
                                 device="cpu")
    with torch.no_grad():
        for lvl in (model.coarse, model.fine):
            lvl.fc_alpha.bias.fill_(0.5)
            lvl.fc_rgb.weight.mul_(100.0)
    params = jax.tree.map(jnp.asarray, params_to_jax(model))
    return jn.ModelSpec.from_config(Config()), params, model


# ---------------------------------------------------------------------------
# (a), (b), (h): small ops
# ---------------------------------------------------------------------------

def test_losses_rays_and_loss_weights():
    rng = np.random.RandomState(0)
    N = 40
    labels = rng.randint(0, 12, N)
    labels[:3] = 7
    mask = np.eye(12, dtype=np.float32)[labels]
    mask[:, 5] = 0.0                                   # an empty class
    pred = rng.rand(N, 15).astype(np.float32)
    tgt = rng.rand(N, 3).astype(np.float32)
    cw = np.ones(12, np.float32)
    cw[7:9] = 2.0
    for fj, ft, args in (
            (jl.mask_mse_loss, tl.mask_mse_loss, (mask, pred[:, :3], tgt, cw)),
            (jl.mask_cross_entropy_loss, tl.mask_cross_entropy_loss,
             (mask, pred[:, 3:], mask, cw))):
        for a, b in zip(ft(*map(_t, args)), fj(*map(jnp.asarray, args))):
            np.testing.assert_allclose(_n(a), np.asarray(b), rtol=OUT_RTOL)
    np.testing.assert_allclose(
        _n(tl.img2mse(_t(pred), _t(pred[::-1].copy()))),
        np.asarray(jl.img2mse(pred, pred[::-1])), rtol=OUT_RTOL)
    assert tl.mse2psnr(0.01) == jl.mse2psnr(0.01)
    np.testing.assert_allclose(
        _n(tfused.ray_loss_weights(_t(mask), 0.02, 0.005)),
        np.asarray(jfused.ray_loss_weights(jnp.asarray(mask), 0.02, 0.005)),
        rtol=OUT_RTOL)
    ds = SyntheticFaceDataset(kind="audio", num_frames=1, H=24, W=32)
    idx = rng.choice(24 * 32, 50, replace=False)
    item = ds[0]
    ro_t, rd_t = trays.get_rays_at(_t(idx), 24, 32, _t(item["intrinsics"]),
                                   _t(item["pose"]))
    ro_j, rd_j = jrays.get_rays_at(jnp.asarray(idx), 24, 32,
                                   jnp.asarray(item["intrinsics"]),
                                   jnp.asarray(item["pose"]))
    np.testing.assert_allclose(_n(ro_t), np.asarray(ro_j), rtol=OUT_RTOL)
    np.testing.assert_allclose(_n(rd_t), np.asarray(rd_j), rtol=OUT_RTOL, atol=1e-7)


def test_weighted_ray_indices_match_jax():
    """Same Gumbel noise (JAX's draw) -> the same indices, in order; the
    semantic probabilities agree; the categorical branch draws in range."""
    ds = SyntheticFaceDataset(kind="audio", num_frames=1, H=32, W=32)
    mask = ds[0]["mask"]
    sp = np.linspace(0.5, 2.0, 12).astype(np.float32)
    probs_j = jsamp.semantic_ray_probs(jnp.asarray(sp), jnp.asarray(mask))
    probs_t = tsamp.semantic_ray_probs(_t(sp), _t(mask))
    np.testing.assert_allclose(_n(probs_t), np.asarray(probs_j), rtol=OUT_RTOL)
    key = jax.random.PRNGKey(3)
    idx_j = jsamp.weighted_ray_indices(key, probs_j.reshape(-1), 64)
    gumbel = jax.random.gumbel(key, (32 * 32,), jnp.float32)
    idx_t = tsamp.weighted_ray_indices(probs_t.reshape(-1), 64,
                                       gumbel=_t(gumbel))
    np.testing.assert_array_equal(_n(idx_t), np.asarray(idx_j))
    bbox = np.array([4, 20, 6, 28])
    np.testing.assert_allclose(
        _n(tsamp.bbox_ray_probs(_t(bbox), 32, 32)),
        np.asarray(jsamp.bbox_ray_probs(jnp.asarray(bbox), 32, 32)),
        rtol=OUT_RTOL)
    rep = tsamp.weighted_ray_indices(probs_t.reshape(-1), 500, replace=True,
                                     generator=torch.Generator().manual_seed(0))
    assert rep.shape == (500,) and int(rep.min()) >= 0 and int(rep.max()) < 1024
    assert bool((probs_t.reshape(-1)[rep] > 0).all())


def test_weighted_ray_indices_break_ties_as_lax_top_k():
    """Equal scores are taken lower index first, as lax.top_k takes them,
    whatever the device: ties cut through the picked set and its order."""
    rng = np.random.RandomState(6)
    n, k = 4096, 300
    probs = np.where(rng.rand(n) < 0.5, 1.0, 2.0).astype(np.float32)
    probs /= probs.sum()
    gumbel = np.round(rng.gumbel(size=n), 1).astype(np.float32)   # many ties
    scores = jnp.log(jnp.asarray(probs) + 1e-12) + jnp.asarray(gumbel)
    _, idx_j = jax.lax.top_k(scores, k)
    idx_t = tsamp.weighted_ray_indices(_t(probs), k, gumbel=_t(gumbel))
    assert len(np.unique(np.asarray(scores)[np.asarray(idx_j)])) < k // 2
    np.testing.assert_array_equal(_n(idx_t), np.asarray(idx_j))


def test_adam_and_schedule_match_optax():
    """Three steps of fixed gradients: the port's Adam with its schedule
    (rate taken at the pre-update count) against optax.adam."""
    cfg = Config()
    cfg.scheduler.lr_decay = 1            # a visible decay over 3 steps
    ts_j = jstage1.TrainSettings.from_config(cfg)
    ts_t = tstage1.TrainSettings.from_config(tiny_cfg(TConfig))
    ts_t = dataclasses.replace(ts_t, lr=ts_j.lr, lr_decay=1,
                               lr_decay_factor=ts_j.lr_decay_factor)
    rng = np.random.RandomState(1)
    w0 = rng.randn(5, 4).astype(np.float32)
    grads = [rng.randn(5, 4).astype(np.float32) for _ in range(3)]
    opt = jstage1.make_optimizer(ts_j)
    pj = {"w": jnp.asarray(w0)}
    sj = opt.init(pj)
    p = torch.nn.Parameter(_t(w0))
    topt = tstage1.make_optimizer([p], ts_t)
    lr_fn = tstage1.lr_schedule(ts_t)
    for i, g in enumerate(grads):
        upd, sj = opt.update({"w": jnp.asarray(g)}, sj, pj)
        pj = optax.apply_updates(pj, upd)
        p.grad = _t(g)
        for group in topt.param_groups:
            group["lr"] = lr_fn(i)
        topt.step()
    np.testing.assert_allclose(_n(p), np.asarray(pj["w"]), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# (c), (d), (e): the plain versions of K3, K4, K2
# ---------------------------------------------------------------------------

def test_deform_pair_vjp_plain_matches_pallas(flagship, monkeypatch):
    """K3's plain version vs deform_pair_vjp(need_gx=False, g2=...) at a P
    above PAIR_BWD_TILE (two tiles)."""
    spec, params, model = flagship
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    rng = np.random.RandomState(2)
    P = jfm.PAIR_BWD_TILE + 76
    pts = rng.uniform(-0.6, 0.6, (P, 3)).astype(np.float32)
    g = (rng.randn(P, 5) * 0.1).astype(np.float32)
    g2 = (rng.randn(P, 5) * 0.1).astype(np.float32)
    cond = (rng.randn(76 + 36) * 0.5).astype(np.float32)
    warp_pe, _, _ = jn.build_pe_specs(spec)
    pe_dim = warp_pe.raw_out
    wp, hp = (6, 128, 4, 3, "tanh"), (6, 64, 4, 2, "linear")
    wspec, hspec = jfm._pair_specs(wp, hp, pe_dim, "float32")
    fold = lambda t, h: jfm.fold_skip_conditioning(
        h, jfm.fold_conditioning(t, jnp.asarray(cond), pe_dim), 4,
        jnp.asarray(cond), pe_dim)
    wt, ht = fold(params["warp"]["trunk"], 128), fold(params["hyper"]["trunk"], 64)
    pad = lambda a: jnp.pad(jnp.asarray(a), ((0, 0), (0, 128 - a.shape[1])))
    _, wt_g, wo_g, ht_g, ho_g = jfm.deform_pair_vjp(
        wspec, hspec, jnp.pad(jnp.asarray(pts), ((0, 0), (0, 5))), wt,
        params["warp"]["out"], ht, params["hyper"]["out"], pad(g), warp_pe,
        3, 2, need_gx=False, g2=pad(g2))
    warp_g, _, _ = tn.build_pe_groups(model.spec)
    pair = k1.prepare_pair(model.warp, model.hyper, _t(cond), warp_g)
    before = k1.deform_pair_vjp.launches
    out = k1.deform_pair_vjp(_t(pts), pair, _t(g), _t(g2), "float32")
    assert k1.deform_pair_vjp.launches == before     # CPU: the plain version
    assert_tree_close(out, {"warp": {"trunk": wt_g, "out": wo_g},
                            "hyper": {"trunk": ht_g, "out": ho_g}})


def test_grid_dg_plain_matches_pallas_and_xla():
    """K4's plain version vs grid_dg_slab_packed (3 tiles, with the addend)
    and vs the XLA _grid_cotangent, on points inside, on cell faces, on the
    grid's faces and outside it."""
    rng = np.random.RandomState(3)
    P = 2500
    pts = rng.uniform(-1.1, 1.1, (P, 5)).astype(np.float32)
    faces = (2.0 * rng.randint(0, 32, (200, 3)) / 31.0 - 1.0).astype(np.float32)
    pts[:200, :3] = faces                               # on cell faces
    pts[200:210, :3] = [[-1, -1, -1], [1, 1, 1], [1, -1, 0.3], [-1, 0.2, 1],
                        [1.2, 0, 0], [0, -1.3, 0], [0, 0, 1.0000001],
                        [-1.0000001, 0.5, 0.5], [0.999, 0.999, -0.999],
                        [-3, 3, 0]]
    gse = rng.randn(P, 32).astype(np.float32)
    gse2 = rng.randn(P, 32).astype(np.float32)
    shape = (32,) + GRID
    rows, _, _ = _cell_geometry(_t(pts), GRID)
    before = k4.grid_dg.launches
    dg_t = k4.grid_dg(_t(pts), rows, _t(gse), _t(gse2), shape)
    assert k4.grid_dg.launches == before
    packed = lambda g: jnp.asarray(np.concatenate(
        [pts[:, :3], np.zeros((P, 6), np.float32), g,
         np.zeros((P, 23), np.float32)], 1))
    dg_j = jgb.grid_dg_slab_packed(shape, packed(gse), "float32",
                                   packed2=packed(gse2))
    scale = float(np.abs(np.asarray(dg_j)).max())
    np.testing.assert_allclose(_n(dg_t), np.asarray(dg_j), rtol=1e-4,
                               atol=1e-5 * scale)
    dg_x = jgrid._grid_cotangent(shape, jnp.asarray(pts[:, :3]),
                                 jnp.asarray(gse + gse2), jnp.float32)
    np.testing.assert_allclose(_n(dg_t), np.asarray(dg_x), rtol=1e-4,
                               atol=1e-5 * scale)
    with pytest.raises(ValueError, match="addend"):
        k4.grid_dg(_t(pts), rows, _t(gse), _t(gse2[:, :16]), shape)


@pytest.mark.parametrize("with_bg,with_noise,bg_sup",
                         [(True, True, 0.0), (True, False, 0.4),
                          (False, True, 0.0)])
def test_level_train_plain_matches_pallas(flagship, monkeypatch, with_bg,
                                          with_noise, bg_sup):
    """K2 through level_train_apply (fold, kernel, unfold) vs the JAX
    level_train_apply: rgb_map, weights, gx, gse, g_bg, every grad leaf
    and dcond."""
    spec, params, model = flagship
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    rng = np.random.RandomState(4)
    R, S = 16, 16
    pts = np.concatenate([rng.uniform(-1.05, 1.05, (R * S, 3)),
                          rng.uniform(-1, 1, (R * S, 2))], 1).astype(np.float32)
    dirs = (rng.randn(R, 3) * 0.1 + [0, 0, -1]).astype(np.float32)
    z = np.sort(rng.uniform(0.48, 1.08, (R, S)), axis=-1).astype(np.float32)
    bg = rng.rand(R, 15).astype(np.float32) if with_bg else None
    noise = (rng.randn(R, S) * 0.5).astype(np.float32) if with_noise else None
    labels = rng.randint(0, 12, R)
    tgt = np.concatenate([rng.rand(R, 3), np.eye(12)[labels]], 1).astype(np.float32)
    lw = jfused.ray_loss_weights(jnp.asarray(tgt[:, 3:]), 0.02, 0.005)
    cond = rng.randn(36).astype(np.float32)
    _, pts_pe, dir_pe = jn.build_pe_specs(spec)
    opt = lambda a: None if a is None else jnp.asarray(a)
    grid = params["spatial_embeddings"]
    rows, _, _ = _cell_geometry(_t(pts), GRID)
    corners = gather_corners_from_rows(grid, jnp.asarray(_n(rows)), "float32")
    (rgb_j, w_j, gx_j, gse_j, gbg_j, grads_j, dcond_j, _) = jlt.level_train_apply(
        params["coarse"], 8, 3, jnp.asarray(pts), jnp.asarray(dirs), corners, S,
        jnp.asarray(z), opt(bg), opt(noise), jnp.asarray(cond),
        jnp.asarray(tgt), lw, "float32", pts_pe, dir_pe, grid_dims=GRID,
        bg_sup=bg_sup)
    _, pts_g, dir_g = tn.build_pe_groups(model.spec)
    table = pack_corner_table(model.spatial_embeddings.detach())
    topt = lambda a: None if a is None else _t(a)
    before = k2.nerf_level_train.launches
    rgb_t, w_t, gx_t, gse_t, gbg_t, grads_t, dcond_t = k2.level_train_apply(
        model.coarse, _t(cond), _t(pts), _t(dirs), table, rows, _t(z),
        topt(bg), topt(noise), _t(tgt), _t(np.asarray(lw)), pts_g, dir_g,
        "float32", GRID, bg_sup)
    assert k2.nerf_level_train.launches == before
    assert float(w_t.sum()) > 0.1 * R
    np.testing.assert_allclose(_n(rgb_t), np.asarray(rgb_j), rtol=OUT_RTOL, atol=1e-6)
    np.testing.assert_allclose(_n(w_t), np.asarray(w_j), rtol=OUT_RTOL, atol=1e-6)
    np.testing.assert_allclose(_n(gx_t), np.asarray(gx_j), rtol=G_RTOL,
                               atol=_gscale(gx_j))
    gse_jc = np.asarray(gse_j)[:, 9:41]
    np.testing.assert_allclose(_n(gse_t), gse_jc, rtol=G_RTOL, atol=_gscale(gse_jc))
    if with_bg:
        np.testing.assert_allclose(_n(gbg_t), np.asarray(gbg_j), rtol=G_RTOL,
                                   atol=_gscale(gbg_j))
    else:
        assert gbg_t is None and gbg_j is None
    # Without a background sigma's gradient is a nearly cancelled sum (every
    # ray's weights add up to 1), where the JAX kernel in interpret mode and
    # the plain version part by more than the elementwise tolerance (a
    # float64 evaluation sides with the plain version), so that head is
    # held by its norm.
    assert_tree_close(grads_t, grads_j, by_norm=() if with_bg else ("fc_alpha",))
    np.testing.assert_allclose(_n(dcond_t), np.asarray(dcond_j), rtol=G_RTOL,
                               atol=_gscale(dcond_j))


# ---------------------------------------------------------------------------
# (f), (g): the fused path and the train step
# ---------------------------------------------------------------------------

def _jax_draws(key, H, W, R, Sc, Sn):
    """JAX's draws of one train step, split from the key as train_step and
    _stage1_fused_fwd split it."""
    k_sel, k_render = jax.random.split(key)
    keys = jax.random.split(k_render, 4)
    f32 = jnp.float32
    return k_render, tfused.TrainDraws(
        gumbel=_t(jax.random.gumbel(k_sel, (H * W,), f32)),
        t_rand=_t(jax.random.uniform(keys[0], (R, Sc), f32)),
        noise_coarse=_t(jax.random.normal(keys[1], (R, Sc), f32)),
        u=_t(jax.random.uniform(keys[2], (R, Sn), f32)),
        noise_fine=_t(jax.random.normal(keys[3], (R, Sc + Sn), f32)))


@pytest.fixture(scope="module")
def tiny_setup():
    cfg = tiny_cfg()
    spec = jn.ModelSpec.from_config(cfg)
    ts = jstage1.TrainSettings.from_config(cfg)
    ds = SyntheticFaceDataset(kind="audio", num_frames=1, H=32, W=32,
                              near=cfg.dataset.near, far=cfg.dataset.far)
    item = dict(ds[0])
    item["background"] = ds.background()
    state = jstage1.init_train_state(jax.random.PRNGKey(0), spec, ts)
    params = dict(state.params)
    model = dict(params["model"])
    for lvl in ("coarse", "fine"):       # live sigma (test_fused_train.py)
        model[lvl] = dict(model[lvl])
        model[lvl]["fc_alpha"] = {"w": model[lvl]["fc_alpha"]["w"],
                                  "b": model[lvl]["fc_alpha"]["b"] + 0.5}
    params["model"] = model
    state = state._replace(params=params)
    tcfg = tiny_cfg(TConfig)
    tspec = tn.ModelSpec.from_config(tcfg)
    tts = tstage1.TrainSettings.from_config(tcfg)
    return cfg, spec, ts, item, state, tcfg, tspec, tts


def _port_state(tiny, train_background=False):
    _, _, _, item, state, _, tspec, tts = tiny
    tst = tstage1.init_train_state(tspec, tts, seed=0, device="cpu")
    params_from_jax(tst.model, jax.tree.map(np.asarray, state.params["model"]))
    tst.optimizer = torch.optim.SGD(tst.model.parameters(), lr=1.0)
    tst.lr_fn = None
    return tst


def test_stage1_fused_matches_jax(tiny_setup):
    """The fused Function vs JAX's stage1_fused on the same rays and draws:
    loss, rgb_c, rgb_f, w_f, and every gradient (into the model through
    autograd, and d(driving))."""
    cfg, spec, ts, item, state, _, tspec, tts = tiny_setup
    tst = _port_state(tiny_setup)
    R, Sc, Sn = 48, 8, 8
    key = jax.random.PRNGKey(11)
    k_render, draws = _jax_draws(key, 32, 32, R, Sc, Sn)
    rng = np.random.RandomState(5)
    idx = rng.choice(32 * 32, R, replace=False)
    ro, rd = jrays.get_rays_at(jnp.asarray(idx), 32, 32,
                               jnp.asarray(item["intrinsics"]),
                               jnp.asarray(item["pose"]))
    mask = item["mask"].reshape(-1, 12)[idx]
    tgt = np.concatenate([item["image"].reshape(-1, 3)[idx], mask], 1)
    bg = item["background"].reshape(-1, 15)[idx]
    lw = jfused.ray_loss_weights(jnp.asarray(mask), 0.02, 0.005)
    fcfg = jfused.FusedCfg(num_coarse=Sc, num_fine=Sn, near=cfg.dataset.near,
                           far=cfg.dataset.far, perturb=True, noise_std=0.1,
                           lindisp=False, compute_dtype="float32",
                           bg_sup_weight=0.3)
    pm = state.params["model"]
    pose_enc = jn.encode_pose(jnp.asarray(item["pose"]))

    def jloss(pm, bgv):
        driving = jn.compute_driving(pm, spec, jnp.asarray(item["driving"]))
        out = jfused.stage1_fused(spec, fcfg, pm, driving, pose_enc, None, ro,
                                  rd, jnp.asarray(tgt), lw, bgv, k_render)
        return out[0], out
    (loss_j, out_j), (g_j, gbg_j) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(pm, jnp.asarray(bg))

    m = tst.model
    bg_t = _t(bg).requires_grad_(True)
    driving = tn.compute_driving(m, _t(item["driving"]))
    tcf = tfused.FusedCfg(**dataclasses.asdict(fcfg))
    loss_t, rgb_c, rgb_f, w_f = tfused.stage1_fused(
        m, tcf, driving, tn.encode_pose(_t(item["pose"])), _t(ro), _t(rd),
        _t(tgt), _t(np.asarray(lw)), bg_t, draws=draws)
    assert not (rgb_c.requires_grad or rgb_f.requires_grad or w_f.requires_grad)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=OUT_RTOL)
    for a, b in zip((rgb_c, rgb_f, w_f), out_j[1:]):
        np.testing.assert_allclose(_n(a), np.asarray(b), rtol=OUT_RTOL, atol=1e-6)
    assert_step_grads_close(grads_to_jax(m), g_j)
    assert_step_grads_close({"bg": bg_t.grad}, {"bg": gbg_j})


def test_train_step_matches_jax(tiny_setup):
    """One port train_step vs the JAX train_step (fused path, SGD(1.0), the
    same draws): metrics, sample_prob, every gradient and the new params."""
    cfg, spec, ts, item, state, _, tspec, tts = tiny_setup
    # SGD(1.0) behind a transformation that keeps the step's gradients in
    # its state (a difference of parameters would round them)
    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    opt = optax.chain(keep, optax.sgd(1.0))
    jst = state._replace(opt_state=opt.init(state.params))
    key = jax.random.PRNGKey(7)
    batch = {k: jnp.asarray(v) for k, v in item.items() if k != "fname"}
    st2, m_j = jax.jit(lambda s, b, k: jstage1.train_step(s, b, k, spec, ts, opt)
                       )(jst, batch, key)
    g_j = st2.opt_state[0]["model"]

    tst = _port_state(tiny_setup)
    _, draws = _jax_draws(key, 32, 32, 48, 8, 8)
    step = tstage1.make_train_step(tspec, tts, device="cpu")
    tst, m_t = step(tst, item, draws=draws)
    assert tst.step == 1
    for k in ("loss", "coarse_l2", "fine_l2", "coarse_ce", "fine_ce",
              "bg_loss", "psnr"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=OUT_RTOL,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(_n(tst.sample_prob), np.asarray(st2.sample_prob),
                               rtol=OUT_RTOL)
    assert_step_grads_close(grads_to_jax(tst.model), g_j)
    for path, x, y in _tree_pairs(params_to_jax(tst.model),
                                  jax.tree.map(np.asarray, st2.params["model"])):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=5e-5, err_msg=path)


def test_train_entry_points_refuse_what_is_not_ported(tiny_setup, monkeypatch):
    """Every configuration is taken on the kernel path now: the grid-free
    model (view directions, no spatial-embedding grid: the grid-free forms
    of K1, K2, K5-K8, K11, K12) in training and in rendering, a sample
    count that does not tile the level kernels (the per-point branch), a
    train step with use_pallas off (the plain path), and the warp-only and
    ambient-only models (K13, K14). Without CUDA and without a device the
    entry points raise."""
    _, _, _, _, _, _, tspec, tts = tiny_setup
    plain = dataclasses.replace(tts, render=dataclasses.replace(tts.render,
                                                                use_pallas=False))
    odd = dataclasses.replace(tts, render=dataclasses.replace(tts.render,
                                                              num_coarse=12))
    taken = [(tspec, plain), (tspec, odd)]
    for sub, field in (("hyper", "use_ambient"), ("warp", "use_warp"),
                       ("coarse", "use_spatial_embeddings")):
        c = tiny_cfg(TConfig)
        setattr(getattr(c.models, sub), field, False)
        spec, ts = tn.ModelSpec.from_config(c), tstage1.TrainSettings.from_config(c)
        taken.append((spec, ts))
    grid_free, grid_free_ts = spec, ts
    assert grid_free_ts.render.use_pallas and not grid_free.use_spatial_embeddings
    assert tfused.stage1_fused_eligible(grid_free, grid_free_ts.render)
    taken.append((grid_free, dataclasses.replace(
        grid_free_ts, render=dataclasses.replace(grid_free_ts.render,
                                                 use_pallas=False))))
    for spec, ts in taken:
        st = tstage1.init_train_state(spec, ts, device="cpu")
        assert callable(tstage1.make_train_step(spec, ts, device="cpu"))
        assert next(st.model.parameters()).device.type == "cpu"
    model = tn.NeRFaceModel.init(grid_free, seed=0, device="cpu")
    fns = tn.make_render_fns(model, torch.zeros(16, 29), torch.eye(4)[:3],
                             use_pallas=True)
    assert fns.level_fn is not None and fns.nerf_fn is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstage1.make_train_step(tspec, tts)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstage1.init_train_state(tspec, tts)
