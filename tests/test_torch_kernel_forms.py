"""The kernels' remaining input forms, their plain versions and autograd
Functions against the JAX package (Pallas in interpret mode with the
exact-f32 PE angle, on the setups of tests/test_pallas.py: P = 300 points
in [-0.3, 0.3], R = 25 rays of S = 16 samples, C = 32 embedding channels):

  (a) K13/K14 pre-encoded: skip_mlp_plain / skip_mlp_vjp_plain and
      deform_mlp_apply_fused on the (P, 63) encoding (weights without PE
      groups) vs field_mlp.deform_mlp_apply_fused with pe_spec None;
  (b) K3 with the points' cotangent: deform_pair_vjp_plain(need_gx=True)
      and deform_pair_apply_fused's gradient of the points vs jax.vjp of
      field_mlp.deform_pair_apply_fused (need_input_grad=True);
  (c) K11/K12 pre-encoded: field_grid.nerf_mlp_apply_fused on pts_embed
      (P, 81) and dir_extra (P, 59) vs field_mlp.nerf_mlp_apply_fused
      without pe specs;
  (d) the level kernels on a per-point spatial embedding se (P, 32): K7/K8
      (nerf_mlp_apply_rayd_se), K5/K6 (nerf_render_level_se) and K2
      (level_train_apply with se) vs nerf_mlp_apply_rayd, nerf_render_level
      and level_train.level_train_apply with se (P, C), gse included.

Tolerances (tests/test_pallas.py's): forwards within 1e-5 absolute for the
deformation nets and 2e-5 for the NeRF field (float32); every gradient leaf,
the points' and se's cotangents included, within rtol 2e-3 and an absolute
2e-4 of max(1, the leaf's largest JAX entry). bfloat16 (K13/K14, K11): the
output within 2e-2 of its scale (the two sides round the same operands and
sum in another order), each gradient leaf within 5e-2 L2-relative at a
cosine of 0.999 (tests/test_torch_skip_kernels.py's).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sahs_tpu.config import Config
from sahs_tpu.models import nerface as jn
from sahs_tpu.ops.encoding import positional_encoding
from sahs_tpu.ops.pallas import field_mlp as jfm
from sahs_tpu.ops.pallas import level_train as jlt

from sahs_tpu_torch.config import Config as TConfig
from sahs_tpu_torch.models import nerface as tn
from sahs_tpu_torch.ops.kernels import deform_pair as k1
from sahs_tpu_torch.ops.kernels import field_grid as tfg
from sahs_tpu_torch.ops.kernels import level_train as k2
from sahs_tpu_torch.ops.kernels import nerf_level as k5
from sahs_tpu_torch.ops.kernels import skip_mlp as k13
from sahs_tpu_torch.utils.weights import params_from_jax

torch.set_num_threads(2)

P, R, S, C = 300, 25, 16, 32
# net -> (layers, hidden, skip, outputs, head)
NETS = {"warp": (6, 128, 4, 3, "tanh"), "hyper": (6, 64, 4, 2, "linear")}
G_RTOL, G_ATOL = 2e-3, 2e-4
BF16_OUT, BF16_L2, BF16_COS = 2e-2, 5e-2, 0.999


def _t(x):
    return torch.tensor(np.asarray(x))


def _n(x):
    return np.asarray(x.detach().cpu()) if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def setup():
    """tests/test_pallas.py's setup: JAX's seeded flagship weights, loaded
    into the port's model, and its points, encodings and conditioning."""
    spec = jn.ModelSpec.from_config(Config())
    params = jax.tree.map(np.asarray, jn.init_model_params(jax.random.PRNGKey(0), spec))
    model = tn.NeRFaceModel.init(tn.ModelSpec.from_config(TConfig()), seed=1,
                                 device="cpu")
    params_from_jax(model, params)
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.3, 0.3, (P, 3)).astype(np.float32)
    pe_x = np.asarray(positional_encoding(jnp.asarray(pts), 10))
    cond = np.concatenate([rng.randn(76) * 0.1, rng.randn(36)]).astype(np.float32)
    return spec, params, model, rng, pts, pe_x, cond


@pytest.fixture(autouse=True)
def _exact_pe_angle(monkeypatch):
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)


def _leaves(a, b, path="grads"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            yield from _leaves(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _leaves(x, y, f"{path}[{i}]")
    else:
        yield path, a, b


def _close(x, y, path, compute_dtype="float32"):
    x, y = _n(x).astype(np.float64), np.asarray(y, np.float64)
    assert x.shape == y.shape, (path, x.shape, y.shape)
    if compute_dtype == "float32":
        atol = G_ATOL * max(float(np.abs(y).max(initial=0.0)), 1.0)
        np.testing.assert_allclose(x, y, rtol=G_RTOL, atol=atol, err_msg=path)
        return
    x, y = x.ravel(), y.ravel()
    rel = np.linalg.norm(x - y) / np.linalg.norm(y)
    cos = float(x @ y) / (np.linalg.norm(x) * np.linalg.norm(y))
    assert rel <= BF16_L2 and cos >= BF16_COS, (path, rel, cos)


def _close_tree(a, b, compute_dtype="float32"):
    for path, x, y in _leaves(a, b):
        _close(x, y, path, compute_dtype)


def _lin(lin):
    return {"w": _n(lin.weight.grad).T, "b": _n(lin.bias.grad)}


def _net_grads(net):
    return {"trunk": [_lin(l) for l in net.trunk.layers], "out": _lin(net.out)}


def _nerf_grads(nerf):
    """A NeRF level's .grad fields in the JAX tree layout."""
    return {"trunk": [_lin(l) for l in nerf.trunk.layers],
            "fc_feat": _lin(nerf.fc_feat), "fc_alpha": _lin(nerf.fc_alpha),
            "dir": [_lin(l) for l in nerf.dir], "fc_rgb": _lin(nerf.fc_rgb),
            "seg": [_lin(l) for l in nerf.seg], "fc_seg": _lin(nerf.fc_seg)}


def _out_close(x, y, atol, compute_dtype):
    if compute_dtype == "float32":
        np.testing.assert_allclose(_n(x), np.asarray(y), atol=atol)
    else:
        y = np.asarray(y, np.float32)
        assert np.abs(_n(x) - y).max() <= BF16_OUT * np.abs(y).max()


# ---------------------------------------------------------------------------
# (a) K13/K14 pre-encoded
# ---------------------------------------------------------------------------

def _skip_jax(params, name, compute_dtype, x, c):
    L, hid, skip, out, act = NETS[name]
    return jfm.deform_mlp_apply_fused(params[name], L, hid, skip, x, c, out,
                                      out_act=act, compute_dtype=compute_dtype)


@pytest.mark.parametrize("name", sorted(NETS))
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_pre_encoded_skip_mlp_matches_jax(setup, name, compute_dtype):
    """K13's and K14's plain versions on the (P, 63) encoding: the output,
    every folded gradient leaf unfolded, d(cond) and the encoding's
    cotangent (P, 63), from a loss cotangent of the output."""
    _, params, model, rng, _, pe_x, cond = setup
    cot = np.random.RandomState(1).randn(P, NETS[name][3]).astype(np.float32)
    out_j, vjp = jax.vjp(lambda p, x, c: _skip_jax({name: p}, name, compute_dtype,
                                                   x, c),
                         params[name], jnp.asarray(pe_x), jnp.asarray(cond))
    g_p, gx_j, gc_j = vjp(jnp.asarray(cot))
    net = getattr(model, name)
    w = k13.prepare_skip(net, _t(cond), None, NETS[name][4])
    out_t = k13.skip_mlp_plain(_t(pe_x), w, compute_dtype)
    _out_close(out_t, out_j, 1e-5, compute_dtype)
    gx, folded = k13.skip_mlp_vjp_plain(_t(pe_x), w, _t(cot), True, compute_dtype)
    assert gx.shape == (P, 63) and gx.dtype == torch.float32
    by_param, dcond = k13.skip_param_grads(net, folded, _t(cond))
    lin = lambda l: {"w": _n(by_param[l.weight]).T, "b": _n(by_param[l.bias])}
    _close_tree({"trunk": [lin(l) for l in net.trunk.layers], "out": lin(net.out)},
                jax.tree.map(np.asarray, g_p), compute_dtype)
    _close(dcond, gc_j, "dcond", compute_dtype)
    _close(gx, gx_j, "gx", compute_dtype)


@pytest.mark.parametrize("name", sorted(NETS))
def test_pre_encoded_deform_mlp_function_matches_jax(setup, name):
    """deform_mlp_apply_fused on the encoding (forward K13, backward K14)
    vs JAX's custom VJP, float32: the output, every parameter's gradient,
    d(cond) and the encoding's gradient."""
    _, params, model, rng, _, pe_x, cond = setup
    cot = np.random.RandomState(2).randn(P, NETS[name][3]).astype(np.float32)
    out_j, vjp = jax.vjp(lambda p, x, c: _skip_jax({name: p}, name, "float32", x, c),
                         params[name], jnp.asarray(pe_x), jnp.asarray(cond))
    g_p, gx_j, gc_j = vjp(jnp.asarray(cot))
    net = getattr(model, name)
    net.zero_grad(set_to_none=True)
    x = _t(pe_x).requires_grad_()
    c = _t(cond).requires_grad_()
    op = k13.SkipOp(net, list(net.parameters()),
                    k13.prepare_skip(net, c.detach(), None, NETS[name][4]), x,
                    "float32")
    y = k13.deform_mlp_apply_fused(op, c)
    np.testing.assert_allclose(_n(y), np.asarray(out_j), atol=1e-5)
    torch.sum(y * _t(cot)).backward()
    _close_tree(_net_grads(net), jax.tree.map(np.asarray, g_p))
    _close(c.grad, gc_j, "dcond")
    _close(x.grad, gx_j, "gx")


# ---------------------------------------------------------------------------
# (b) K3 with the points' cotangent
# ---------------------------------------------------------------------------

def _pair_jax(spec, params, pts, cond, compute_dtype, need_gx):
    warp_pe, _, _ = jn.build_pe_specs(spec)

    def fn(pw, ph, x, c):
        return jfm.deform_pair_apply_fused(
            pw, ph, NETS["warp"], NETS["hyper"], x, c, compute_dtype=compute_dtype,
            pe_spec=warp_pe, need_input_grad=need_gx)[:, :5]
    return jax.vjp(fn, params["warp"], params["hyper"], jnp.asarray(pts),
                   jnp.asarray(cond))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_pair_vjp_points_cotangent_matches_jax(setup, compute_dtype):
    """K3's plain version with need_gx: every folded leaf (unfolded), d(cond)
    and gx (P, 3) = pe_bwd(x, gpe_warp + gpe_hyper) + g[:, :3], vs the
    JAX pair's vjp with need_input_grad; without need_gx the same tree."""
    spec, params, model, rng, pts, _, cond = setup
    cot = (np.random.RandomState(3).randn(P, 5) * 0.1).astype(np.float32)
    _, vjp = _pair_jax(spec, params, pts, cond, compute_dtype, True)
    g_w, g_h, gx_j, gc_j = vjp(jnp.asarray(cot))
    warp_g = tn.build_pe_groups(model.spec)[0]
    pair = k1.prepare_pair(model.warp, model.hyper, _t(cond), warp_g)
    gx, folded = k1.deform_pair_vjp_plain(_t(pts), pair, _t(cot), None,
                                          compute_dtype, need_gx=True)
    assert gx.shape == (P, 3) and gx.dtype == torch.float32
    by_param, dcond = k1.pair_param_grads(model.warp, model.hyper, folded, _t(cond))
    lin = lambda l: {"w": _n(by_param[l.weight]).T, "b": _n(by_param[l.bias])}
    tree = {n: {"trunk": [lin(l) for l in getattr(model, n).trunk.layers],
                "out": lin(getattr(model, n).out)} for n in ("warp", "hyper")}
    _close_tree(tree, jax.tree.map(np.asarray, {"warp": g_w, "hyper": g_h}),
                compute_dtype)
    _close(dcond, gc_j, "dcond", compute_dtype)
    _close(gx, gx_j, "gx", compute_dtype)
    plain = k1.deform_pair_vjp_plain(_t(pts), pair, _t(cot), None, compute_dtype)
    for path, x, y in _leaves(plain, folded):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=path)


def test_deform_pair_op_points_gradient_matches_jax(setup, monkeypatch):
    """deform_pair_apply_fused with points that ask for a gradient (forward
    K1, backward K3 with need_gx) vs jax.vjp of the JAX op with
    need_input_grad: the packed output and the gradients of the warp and
    hyper nets, the conditioning and the points; points that ask for none
    get none, and K3 is then asked for no gx."""
    spec, params, model, rng, pts, _, cond = setup
    cot = (np.random.RandomState(4).randn(P, 5) * 0.1).astype(np.float32)
    out_j, vjp = _pair_jax(spec, params, pts, cond, "float32", True)
    g_w, g_h, gx_j, gc_j = vjp(jnp.asarray(cot))
    asked = []
    vjp_plain = k1.deform_pair_vjp

    def spy(*a, **k):
        asked.append(k.get("need_gx", False))
        return vjp_plain(*a, **k)
    monkeypatch.setattr(k1, "deform_pair_vjp", spy)
    warp_g = tn.build_pe_groups(model.spec)[0]
    nets = (model.warp, model.hyper)
    for wants_gx in (True, False):
        model.zero_grad(set_to_none=True)
        x = _t(pts).requires_grad_(wants_gx)
        c = _t(cond).requires_grad_()
        pair = k1.prepare_pair(*nets, c.detach(), warp_g)
        op = k1.PairOp(*nets, [p for n in nets for p in n.parameters()], pair, x,
                       P, None, "float32")
        packed, rows = k1.deform_pair_apply_fused(op, c)
        assert rows is None
        np.testing.assert_allclose(_n(packed), np.asarray(out_j), atol=1e-5)
        packed.backward(_t(cot))
        _close_tree({n: _net_grads(getattr(model, n)) for n in ("warp", "hyper")},
                    jax.tree.map(np.asarray, {"warp": g_w, "hyper": g_h}))
        _close(c.grad, gc_j, "dcond")
        if wants_gx:
            _close(x.grad, gx_j, "gx")
        else:
            assert x.grad is None
    assert asked == [True, False]


# ---------------------------------------------------------------------------
# (c) K11/K12 pre-encoded
# ---------------------------------------------------------------------------

def _point_inputs(setup):
    """test_pallas.py's per-point inputs: pts_embed = pe(xyz) | pe(ambient)
    (P, 81), dir_extra = pe(dir) | se (P, 59), the pose conditioning."""
    _, _, _, _, _, pe_x, cond = setup
    rng = np.random.RandomState(5)
    pe_amb = positional_encoding(jnp.asarray(rng.uniform(-1, 1, (P, 2)).astype(np.float32)), 4)
    pts_embed = np.asarray(jnp.concatenate([jnp.asarray(pe_x), pe_amb], -1))
    dirs_embed = positional_encoding(jnp.asarray(rng.randn(P, 3).astype(np.float32)), 4)
    se = jnp.asarray(rng.randn(P, C).astype(np.float32) * 0.1)
    extra = np.asarray(jnp.concatenate([dirs_embed, se], -1))
    return pts_embed, extra, cond[76:]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_pre_encoded_nerf_mlp_matches_jax(setup, compute_dtype):
    """field_grid.nerf_mlp_apply_fused on the encodings (forward K11,
    backward K12, their plain versions here) vs field_mlp.nerf_mlp_apply_fused
    without pe specs: the raw field (P, 16), every parameter's gradient,
    d(cond) and the cotangents of pts_embed (P, 81) and dir_extra (P, 59)."""
    _, params, model, _, _, _, _ = setup
    pts_embed, extra, pose = _point_inputs(setup)
    assert pts_embed.shape == (P, 81) and extra.shape == (P, 59)
    cot = np.random.RandomState(6).randn(P, 16).astype(np.float32)
    out_j, vjp = jax.vjp(
        lambda p, x, e, c: jfm.nerf_mlp_apply_fused(p, 8, 3, x, e, c,
                                                    compute_dtype=compute_dtype),
        params["coarse"], jnp.asarray(pts_embed), jnp.asarray(extra),
        jnp.asarray(pose))
    g_p, gx_j, ge_j, gc_j = vjp(jnp.asarray(cot))
    nerf = model.coarse
    nerf.zero_grad(set_to_none=True)
    x, e = _t(pts_embed).requires_grad_(), _t(extra).requires_grad_()
    c = _t(pose).requires_grad_()
    op = tfg.PointOp(nerf, list(nerf.parameters()),
                     k5.prepare_level(nerf, c.detach(), None, None), compute_dtype)
    y = tfg.nerf_mlp_apply_fused(op, x, e, c)
    _out_close(y, out_j, 2e-5, compute_dtype)
    torch.sum(y * _t(cot)).backward()
    _close_tree(_nerf_grads(nerf), jax.tree.map(np.asarray, g_p), compute_dtype)
    _close(c.grad, gc_j, "dcond", compute_dtype)
    _close(x.grad, gx_j, "gx", compute_dtype)
    _close(e.grad, ge_j, "gextra", compute_dtype)


# ---------------------------------------------------------------------------
# (d) the level kernels on a per-point se (P, C)
# ---------------------------------------------------------------------------

def _level_inputs():
    """R rays of S samples: packed points [xyz | ambient] in the
    test_pallas.py range, directions, sorted z, a background prior, sigma
    noise, se (R*S, C), the target and the per-ray loss weights."""
    rng = np.random.RandomState(7)
    pts = np.concatenate([rng.uniform(-0.3, 0.3, (R * S, 3)),
                          rng.uniform(-1, 1, (R * S, 2))], 1).astype(np.float32)
    dirs = (rng.randn(R, 3) * 0.1 + [0, 0, -1]).astype(np.float32)
    z = np.sort(rng.uniform(0.48, 1.08, (R, S)), axis=-1).astype(np.float32)
    bg = rng.rand(R, 15).astype(np.float32)
    noise = (rng.randn(R, S) * 0.5).astype(np.float32)
    se = (rng.randn(R * S, C) * 0.1).astype(np.float32)
    tgt = np.concatenate([rng.rand(R, 3), np.eye(12)[rng.randint(0, 12, R)]],
                         1).astype(np.float32)
    lw = rng.rand(R, 2).astype(np.float32)
    return pts, dirs, z, bg, noise, se, tgt, lw


def _level_op(model, pose, dirs, z=None, noise=None):
    _, pts_g, dir_g = tn.build_pe_groups(model.spec)
    nerf = model.coarse
    c = _t(pose).requires_grad_()
    op = tfg.GridLevelOp(nerf, list(nerf.parameters()),
                         k5.prepare_level(nerf, c.detach(), pts_g, dir_g), None,
                         None, _t(dirs), S, "float32", None,
                         None if z is None else _t(z),
                         None if noise is None else _t(noise))
    return op, c


def test_rayd_on_se_matches_jax(setup):
    """K7/K8 (nerf_mlp_apply_rayd_se) vs nerf_mlp_apply_rayd with se (P, C),
    float32: the raw field and the gradients of the parameters, the packed
    points (no trilinear term), se and the conditioning."""
    spec, params, model, _, _, _, cond = setup
    _, pts_pe, dir_pe = jn.build_pe_specs(spec)
    pts, dirs, _, _, _, se, _, _ = _level_inputs()
    pose = cond[76:]
    cot = np.random.RandomState(8).randn(R * S, 16).astype(np.float32)
    out_j, vjp = jax.vjp(
        lambda p, x, s, c: jfm.nerf_mlp_apply_rayd(
            p, 8, 3, x, jnp.asarray(dirs), s, S, c, compute_dtype="float32",
            pe_spec=pts_pe, dir_pe_spec=dir_pe),
        params["coarse"], jnp.asarray(pts), jnp.asarray(se), jnp.asarray(pose))
    g_p, gx_j, gse_j, gc_j = vjp(jnp.asarray(cot))
    model.coarse.zero_grad(set_to_none=True)
    op, c = _level_op(model, pose, dirs)
    x, s = _t(pts).requires_grad_(), _t(se).requires_grad_()
    y = tfg.nerf_mlp_apply_rayd_se(op, s, x, c)
    np.testing.assert_allclose(_n(y), np.asarray(out_j), atol=2e-5)
    torch.sum(y * _t(cot)).backward()
    _close_tree(_nerf_grads(model.coarse), jax.tree.map(np.asarray, g_p))
    _close(c.grad, gc_j, "dcond")
    _close(x.grad, gx_j, "gx")
    _close(s.grad, gse_j, "gse")


def test_render_level_on_se_matches_jax(setup):
    """K5/K6 (nerf_render_level_se) vs nerf_render_level with se (P, C),
    float32, with a background prior and sigma noise: rgb_map and the
    weights, and the gradients of the parameters, the points, se, the
    prior and the conditioning from cotangents of both outputs."""
    spec, params, model, _, _, _, cond = setup
    _, pts_pe, dir_pe = jn.build_pe_specs(spec)
    pts, dirs, z, bg, noise, se, _, _ = _level_inputs()
    pose = cond[76:]
    rng = np.random.RandomState(9)
    g_rgb = rng.randn(R, 16).astype(np.float32)
    g_w = rng.randn(R, S).astype(np.float32)
    out_j, vjp = jax.vjp(
        lambda p, x, s, b, c: jfm.nerf_render_level(
            p, 8, 3, x, jnp.asarray(dirs), s, S, jnp.asarray(z), b,
            jnp.asarray(noise), c, compute_dtype="float32", pe_spec=pts_pe,
            dir_pe_spec=dir_pe),
        params["coarse"], jnp.asarray(pts), jnp.asarray(se), jnp.asarray(bg),
        jnp.asarray(pose))
    g_p, gx_j, gse_j, gbg_j, gc_j = vjp((jnp.asarray(g_rgb), jnp.asarray(g_w)))
    model.coarse.zero_grad(set_to_none=True)
    op, c = _level_op(model, pose, dirs, z, noise)
    x, s, b = (_t(a).requires_grad_() for a in (pts, se, bg))
    rgb_map, w = tfg.nerf_render_level_se(op, s, x, b, c)
    np.testing.assert_allclose(_n(rgb_map), np.asarray(out_j[0]), atol=2e-5)
    np.testing.assert_allclose(_n(w), np.asarray(out_j[1]), atol=2e-5)
    (torch.sum(rgb_map * _t(g_rgb)) + torch.sum(w * _t(g_w))).backward()
    _close_tree(_nerf_grads(model.coarse), jax.tree.map(np.asarray, g_p))
    _close(c.grad, gc_j, "dcond")
    _close(x.grad, gx_j, "gx")
    _close(s.grad, gse_j, "gse")
    _close(b.grad, gbg_j, "g_bg")


def test_level_train_on_se_matches_jax(setup):
    """K2 (level_train_apply with se (P, C) and no grid) vs JAX's
    level_train_apply with se and grid_dims None, float32, with a
    background prior, sigma noise and its supervision: rgb_map, weights,
    gx (no trilinear term), gse (P, C) float32, g_bg, every gradient leaf
    (trunk unfolded) and d(cond)."""
    spec, params, model, _, _, _, cond = setup
    _, pts_pe, dir_pe = jn.build_pe_specs(spec)
    pts, dirs, z, bg, noise, se, tgt, lw = _level_inputs()
    pose = cond[76:]
    out_j = jlt.level_train_apply(
        params["coarse"], 8, 3, jnp.asarray(pts), jnp.asarray(dirs),
        jnp.asarray(se), S, jnp.asarray(z), jnp.asarray(bg), jnp.asarray(noise),
        jnp.asarray(pose), jnp.asarray(tgt), jnp.asarray(lw), "float32", pts_pe,
        dir_pe, grid_dims=None, bg_sup=0.3)
    rgb_j, w_j, gx_j, gse_j, gbg_j, grads_j, dc_j, _ = out_j
    _, pts_g, dir_g = tn.build_pe_groups(model.spec)
    rgb_t, w_t, gx_t, gse_t, gbg_t, grads_t, dc_t = k2.level_train_apply(
        model.coarse, _t(pose), _t(pts), _t(dirs), None, None, _t(z), _t(bg),
        _t(noise), _t(tgt), _t(lw), pts_g, dir_g, "float32", None, bg_sup=0.3,
        se=_t(se))
    np.testing.assert_allclose(_n(rgb_t), np.asarray(rgb_j), atol=2e-5)
    np.testing.assert_allclose(_n(w_t), np.asarray(w_j), atol=2e-5)
    assert gse_t.shape == (R * S, C) and gse_t.dtype == torch.float32
    _close(gx_t, np.asarray(gx_j)[:, :5], "gx")
    _close(gse_t, gse_j, "gse")
    _close(gbg_t, gbg_j, "g_bg")
    _close_tree(grads_t, jax.tree.map(np.asarray, grads_j))
    _close(dc_t, dc_j, "dcond")
