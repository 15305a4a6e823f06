"""The fused step's variants on a model without the spatial-embedding grid,
and the plain versions of the three kernel forms the variants reach,
against the JAX package (float32, Pallas in interpret mode):

  (a) each variant of tests/test_torch_fused_variants.py on the grid-free
      model (K2 with C = 0, no K4 or K9), against JAX's same variant and
      the port's default step, with the same checks;
  (b) K1 and K3 in their rays= form (field_mlp.deform_pair_forward /
      deform_pair_vjp with rays=, the latter with g2) and K2 in its pair=
      form (level_train.level_train_apply with pair=): outputs, level
      gradients and the pair's gradients; each form's plain version is,
      bit for bit, the positional form on K15's points (K2's: K2 then K3).

In interpret mode on the CPU the JAX kernels' in-kernel position o + d z
may round once (ROADMAP, faults of the reference), while the port holds
K15's two roundings; outputs at a point are compared only where both
roundings give the same position. Gradients within 5e-3 and 1e-3 of each
leaf's largest entry (tests/test_torch_train.py's kernel tolerances).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sahs_tpu.config import Config
from sahs_tpu.models import nerface as jn
from sahs_tpu.ops.pallas import field_mlp as jfm
from sahs_tpu.ops.pallas import level_train as jlt
from sahs_tpu.ops.pallas.field_grid import gather_corners_from_rows
from sahs_tpu.train import fused as jfused

import torch

from sahs_tpu_torch.config import Config as TConfig
from sahs_tpu_torch.models import nerface as tn
from sahs_tpu_torch.ops.grid import _cell_geometry, pack_corner_table
from sahs_tpu_torch.ops.kernels import deform_pair as k1
from sahs_tpu_torch.ops.kernels import level_train as k2
from sahs_tpu_torch.ops.kernels.points import build_pts_plain
from sahs_tpu_torch.utils.weights import params_to_jax

from torch_fallback_util import OUT_RTOL, _n, _t
from torch_variant_util import (VARIANTS, _leaves, check_step, check_variant,
                                run_port, run_port_step, variant_setup)

torch.set_num_threads(2)

GRID = (32, 32, 32)
G_RTOL, G_SCALE = 5e-3, 1e-3


@pytest.fixture(scope="module")
def grid_free_setup():
    su = variant_setup(False)
    return su, run_port(su, ()), run_port_step(su, ())


@pytest.mark.parametrize("name", list(VARIANTS))
def test_grid_free_variant_matches_jax_and_default(grid_free_setup, name):
    su, default, default_step = grid_free_setup
    check_variant(su, name, default)
    check_step(su, name, default_step)


# ---------------------------------------------------------------------------
# (b) the kernel forms' plain versions against the JAX kernels
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flagship():
    """Flagship widths: the port's seeded weights handed to JAX, sigma's
    bias lifted and the rgb head scaled (tests/test_torch_train.py)."""
    model = tn.NeRFaceModel.init(tn.ModelSpec.from_config(TConfig()), seed=0,
                                 device="cpu")
    with torch.no_grad():
        for lvl in (model.coarse, model.fine):
            lvl.fc_alpha.bias.fill_(0.5)
            lvl.fc_rgb.weight.mul_(100.0)
    params = jax.tree.map(jnp.asarray, params_to_jax(model))
    return jn.ModelSpec.from_config(Config()), params, model


def _rays(rng, R, S):
    ro = (rng.randn(R, 3) * 0.05 + [0, 0, 1.2]).astype(np.float32)
    rd = (rng.randn(R, 3) * 0.3 + [0, 0, -1]).astype(np.float32)
    z = np.sort(rng.uniform(0.3, 1.6, (R, S)), axis=-1).astype(np.float32)
    return ro, rd, z


def _agree(ro, rd, z):
    """(P,) True where one rounding of o + d z and two give one position."""
    two = _n(build_pts_plain(_t(ro), _t(rd), _t(z)))
    one = (ro[:, None, :].astype(np.float64)
           + rd[:, None, :].astype(np.float64) * z[..., None]).astype(np.float32)
    return np.all(two == one.reshape(-1, 3), axis=-1)


def _pair_fold(spec, params, cond):
    """JAX's folded pair: specs, folded trunks and the PE spec."""
    warp_pe, _, _ = jn.build_pe_specs(spec)
    pe_dim = warp_pe.raw_out
    wp, hp = (6, 128, 4, 3, "tanh"), (6, 64, 4, 2, "linear")
    wspec, hspec = jfm._pair_specs(wp, hp, pe_dim, "float32")
    fold = lambda t, h: jfm.fold_skip_conditioning(
        h, jfm.fold_conditioning(t, jnp.asarray(cond), pe_dim), 4,
        jnp.asarray(cond), pe_dim)
    return (wspec, hspec, fold(params["warp"]["trunk"], 128),
            fold(params["hyper"]["trunk"], 64), warp_pe)


def _tree_close(a, b, by_norm=()):
    """Leaf by leaf within G_RTOL and G_SCALE of the leaf's largest entry; a
    leaf whose path holds one of ``by_norm`` within 5e-2 of its norm."""
    for (path, x), (_, y) in zip(_leaves(a), _leaves(b)):
        if any(n in path for n in by_norm):
            assert np.linalg.norm(x - y) <= 5e-2 * np.linalg.norm(y), path
            continue
        np.testing.assert_allclose(x, y, rtol=G_RTOL,
                                   atol=G_SCALE * float(np.abs(y).max(initial=0.0)),
                                   err_msg=path)


def test_pair_rays_forms_plain_match_pallas(flagship, monkeypatch):
    """K1's and K3's rays= forms (plain versions) against
    deform_pair_forward(rays=, emit_rows=) and deform_pair_vjp(rays=, g2=)
    at 2 x 1024 points of 64 samples a ray; the plain forms equal the
    positional plain versions on build_pts_plain's points bit for bit."""
    spec, params, model = flagship
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    rng = np.random.RandomState(8)
    R, S = 2 * jfm.PAIR_TILE // 64, 64
    ro, rd, z = _rays(rng, R, S)
    cond = (rng.randn(76 + 36) * 0.5).astype(np.float32)
    g = (rng.randn(R * S, 5) * 0.1).astype(np.float32)
    g2 = (rng.randn(R * S, 5) * 0.1).astype(np.float32)
    wspec, hspec, wt, ht, warp_pe = _pair_fold(spec, params, cond)
    j_rays = (jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z), S)
    packed_j, rows_j = jfm.deform_pair_forward(
        wspec, hspec, None, wt, params["warp"]["out"], ht, params["hyper"]["out"],
        warp_pe, 3, 2, rays=j_rays, emit_rows=(S, GRID))
    pad = lambda a: jnp.pad(jnp.asarray(a), ((0, 0), (0, 128 - a.shape[1])))
    _, wt_g, wo_g, ht_g, ho_g = jfm.deform_pair_vjp(
        wspec, hspec, None, wt, params["warp"]["out"], ht, params["hyper"]["out"],
        pad(g), warp_pe, 3, 2, need_gx=False, rays=j_rays, g2=pad(g2))

    warp_g, _, _ = tn.build_pe_groups(model.spec)
    pair = k1.prepare_pair(model.warp, model.hyper, _t(cond), warp_g)
    t_rays = (_t(ro), _t(rd), _t(z))
    before = (k1.deform_pair_forward.launches, k1.deform_pair_vjp.launches)
    packed_t, rows_t = k1.deform_pair_forward(None, pair, "float32", S, GRID, rays=t_rays)
    tree_t = k1.deform_pair_vjp(None, pair, _t(g), _t(g2), "float32", rays=t_rays)
    assert (k1.deform_pair_forward.launches, k1.deform_pair_vjp.launches) == before
    # the rays= forms are the positional forms on K15's points
    pts = build_pts_plain(*t_rays)
    packed_p, rows_p = k1.deform_pair_plain(pts, pair, "float32", S, GRID)
    assert torch.equal(packed_t, packed_p) and torch.equal(rows_t, rows_p)
    for (path, a), (_, b) in zip(_leaves(tree_t), _leaves(k1.deform_pair_vjp_plain(
            pts, pair, _t(g), _t(g2), "float32"))):
        assert np.array_equal(a, b), path
    # against JAX, point by point where the positions agree
    ok = _agree(ro, rd, z)
    assert ok.mean() > 0.1, ok.mean()
    np.testing.assert_allclose(_n(packed_t)[ok], np.asarray(packed_j)[ok, :5],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(_n(rows_t).reshape(-1)[ok],
                                  np.asarray(rows_j).reshape(-1)[ok].astype(np.int32))
    _tree_close(tree_t, {"warp": {"trunk": wt_g, "out": wo_g},
                         "hyper": {"trunk": ht_g, "out": ho_g}})


@pytest.mark.parametrize("with_bg,bg_sup", [(True, 0.4), (False, 0.0)])
def test_level_train_pair_form_plain_matches_pallas(flagship, monkeypatch, with_bg,
                                                    bg_sup):
    """K2's pair= form (plain version, through level_train_apply) against
    level_train_apply(pair=): rgb_map, weights, gse, g_bg, every level
    gradient and dcond, and the pair's gradients (unpacked from JAX's flat
    partials) in gx's place, at 16 rays x 64 samples (one BWD_TILE)."""
    spec, params, model = flagship
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    rng = np.random.RandomState(9)
    R, S = 16, 64
    ro, rd, z = _rays(rng, R, S)
    pts = np.concatenate([rng.uniform(-1.05, 1.05, (R * S, 3)),
                          rng.uniform(-1, 1, (R * S, 2))], 1).astype(np.float32)
    bg = rng.rand(R, 15).astype(np.float32) if with_bg else None
    noise = (rng.randn(R, S) * 0.5).astype(np.float32)
    labels = rng.randint(0, 12, R)
    tgt = np.concatenate([rng.rand(R, 3), np.eye(12)[labels]], 1).astype(np.float32)
    lw = jfused.ray_loss_weights(jnp.asarray(tgt[:, 3:]), 0.02, 0.005)
    cond = (rng.randn(76 + 36) * 0.5).astype(np.float32)
    wspec, hspec, wt, ht, warp_pe = _pair_fold(spec, params, cond)
    _, pts_pe, dir_pe = jn.build_pe_specs(spec)
    grid = params["spatial_embeddings"]
    rows, _, _ = _cell_geometry(_t(pts), GRID)
    corners = gather_corners_from_rows(grid, jnp.asarray(_n(rows)), "float32")
    opt = lambda a: None if a is None else jnp.asarray(a)
    j_pair = (wspec, hspec,
              jfm._flatten_trunk_weights(wspec, wt, params["warp"]["out"]),
              jfm._flatten_trunk_weights(hspec, ht, params["hyper"]["out"]),
              warp_pe, 3, 2, jnp.pad(jnp.asarray(ro), ((0, 0), (0, 5))))
    (rgb_j, w_j, gx_j, gse_j, gbg_j, grads_j, dcond_j, pg_j) = jlt.level_train_apply(
        params["coarse"], 8, 3, jnp.asarray(pts), jnp.asarray(rd), corners, S,
        jnp.asarray(z), opt(bg), jnp.asarray(noise), jnp.asarray(cond[76:]),
        jnp.asarray(tgt), lw, "float32", pts_pe, dir_pe, grid_dims=GRID,
        bg_sup=bg_sup, pair=j_pair)
    assert gx_j is None
    it = iter(pg_j)
    wt_g, wo_g = jfm._unpack_trunk_grads(wspec, wt, params["warp"]["out"], it)
    ht_g, ho_g = jfm._unpack_trunk_grads(hspec, ht, params["hyper"]["out"], it)

    warp_g, pts_g, dir_g = tn.build_pe_groups(model.spec)
    pair = k1.prepare_pair(model.warp, model.hyper, _t(cond), warp_g)
    table = pack_corner_table(model.spatial_embeddings.detach())
    topt = lambda a: None if a is None else _t(a)
    args = (model.coarse, _t(cond[76:]), _t(pts), _t(rd), table, rows, _t(z),
            topt(bg), _t(noise), _t(tgt), _t(np.asarray(lw)), pts_g, dir_g,
            "float32", GRID, bg_sup)
    before = k2.nerf_level_train.launches
    rgb_t, w_t, pg_t, gse_t, gbg_t, grads_t, dcond_t = k2.level_train_apply(
        *args, pair=(pair, _t(ro)))
    assert k2.nerf_level_train.launches == before
    # the form is K2 then K3 on the rays' points, exactly
    rgb_d, w_d, gx_d, gse_d, gbg_d, grads_d, dcond_d = k2.level_train_apply(*args)
    for x, y in ((rgb_t, rgb_d), (w_t, w_d), (gse_t, gse_d), (dcond_t, dcond_d)):
        assert torch.equal(x, y)
    want = k1.deform_pair_vjp_plain(None, pair, gx_d, None, "float32",
                                    rays=(_t(ro), _t(rd), _t(z)))
    for (path, a), (_, b) in zip(_leaves(pg_t), _leaves(want)):
        assert np.array_equal(a, b), path
    # against JAX
    np.testing.assert_allclose(_n(rgb_t), np.asarray(rgb_j), rtol=OUT_RTOL, atol=1e-6)
    np.testing.assert_allclose(_n(w_t), np.asarray(w_j), rtol=OUT_RTOL, atol=1e-6)
    gse_jc = np.asarray(gse_j)[:, 9:41]
    np.testing.assert_allclose(_n(gse_t), gse_jc, rtol=G_RTOL,
                               atol=G_SCALE * np.abs(gse_jc).max())
    if with_bg:
        np.testing.assert_allclose(_n(gbg_t), np.asarray(gbg_j), rtol=G_RTOL,
                                   atol=G_SCALE * np.abs(np.asarray(gbg_j)).max())
    # without a background sigma's gradient is a nearly cancelled sum, held
    # by its norm (tests/test_torch_train.py's K2 test gives the reason)
    _tree_close(grads_t, grads_j, by_norm=() if with_bg else ("fc_alpha",))
    np.testing.assert_allclose(_n(dcond_t), np.asarray(dcond_j), rtol=G_RTOL,
                               atol=G_SCALE * np.abs(np.asarray(dcond_j)).max())
    _tree_close(pg_t, {"warp": {"trunk": wt_g, "out": wo_g},
                       "hyper": {"trunk": ht_g, "out": ho_g}})
