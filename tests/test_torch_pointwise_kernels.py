"""The per-point branch's kernels against the JAX package, Pallas in
interpret mode (the exact-f32 PE angle, _PE_SPLIT_DOT off, as
tests/test_torch_kernels.py runs it):

  K10 grid_bwd_fused_plain          vs grid_bwd.grid_bwd_fused
  grid.grid_sample_3d (K10 backward) vs jax.vjp of grid.grid_sample_3d
  field_grid.nerf_mlp_apply_fused   vs jax.vjp of field_mlp.nerf_mlp_apply_fused
  (K11 nerf_mlp_plain forward, K12 nerf_mlp_vjp_plain backward and the
  conditioning unfold), and K11 / K12 on their own against
  field_mlp.nerf_mlp_forward_fused / nerf_mlp_vjp

Tolerances. K10 is linear in g and its two sides round the same values the
same way (in bf16 too: the axis weights, g and both products rounded to
bf16 before a float32 product), so dG and dcoords agree to the order of
their float32 sums: within 1e-5 L2-relative in both types. The NeRF field:
float32 outputs within 3e-5 relative and 1e-4 absolute; float32 gradients
leaf by leaf (each weight, each bias, the points, the extra input and the
conditioning) within 1e-4 L2-relative to the leaf's own norm. Random
cotangents at every point make a leaky-ReLU pre-activation within rounding
of 0 take the other slope on one side: that point's input cotangents move
by some 10 % and the weight leaves it feeds by ~1 %. At most POINT_FLIPS
points may differ so; if any does, the test runs again without them and
holds every leaf on the rest. bfloat16: each side rounds every activation
to bf16 after its own float32 sums, so a sum that lands on a rounding
boundary rounds the other way, and at random weights the seg branch's
activations sit close to the leaky-ReLU kink: one ulp more of the
conditioning moves the port's own bf16 seg leaves by 1.5 % (against JAX's,
they read 2.3 %, every other leaf <= 0.7 %). Outputs within 2e-2 of
their scale, every leaf within 5e-2 L2-relative at a cosine of at least
0.999.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sahs_tpu.config import Config
from sahs_tpu.models import nerface as jn
from sahs_tpu.ops import grid as jgrid
from sahs_tpu.ops.pallas import field_mlp as jfm
from sahs_tpu.ops.pallas import grid_bwd as jgb

from sahs_tpu_torch.config import Config as TConfig
from sahs_tpu_torch.models import nerface as tn
from sahs_tpu_torch.ops import grid as tgrid
from sahs_tpu_torch.ops.kernels import field_grid as tfg
from sahs_tpu_torch.ops.kernels import grid_bwd as k10
from sahs_tpu_torch.ops.kernels import level_train as k12
from sahs_tpu_torch.ops.kernels import nerf_level as k57
from sahs_tpu_torch.ops.kernels import nerf_mlp as k11
from sahs_tpu_torch.utils.weights import grads_to_jax, params_to_jax

torch.set_num_threads(2)

GRID = (32, 32, 32)
K10_L2 = 1e-5
OUT_RTOL, OUT_ATOL = 3e-5, 1e-4
F32_L2 = 1e-4
BF16_OUT, BF16_L2, BF16_COS = 2e-2, 5e-2, 0.999
POINT_FLIPS = 4


def _t(x):
    return torch.tensor(np.asarray(x))


def _n(x):
    return np.asarray(x.detach().cpu()) if torch.is_tensor(x) else np.asarray(x)


def _l2(x, y):
    x, y = _n(x).astype(np.float64).ravel(), np.asarray(y, np.float64).ravel()
    ny = np.linalg.norm(y)
    return (np.linalg.norm(x - y) / ny if ny else np.linalg.norm(x),
            float(x @ y) / (np.linalg.norm(x) * ny) if ny else 1.0)


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


def _coords(rng, P, width):
    """Points inside the grid, on cell faces, on the grid's faces and
    outside it; ``width`` - 3 further columns of ambient coordinates."""
    c = rng.uniform(-1.15, 1.15, (P, width)).astype(np.float32)
    c[:P // 4, :3] = 2.0 * rng.randint(0, 32, (P // 4, 3)) / 31.0 - 1.0
    c[P // 4:P // 4 + 6, :3] = [[-1, -1, -1], [1, 1, 1], [1.2, 0, 0],
                                [0, 0, 1.0000001], [0.999, 0.999, -0.999],
                                [-3, 3, 0]]
    return c


# ---------------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_grid_bwd_fused_plain_matches_pallas(compute_dtype):
    """K10's plain version vs grid_bwd_fused (32 channels, 32^3) on the
    corner rows the JAX forward stashes: dG and dcoords."""
    rng = np.random.RandomState(0)
    G = jnp.asarray(rng.randn(32, *GRID).astype(np.float32) * 0.1)
    P = 520
    c = _coords(rng, P, 5)
    g = rng.randn(P, 32).astype(np.float32)
    _, (_, _, vals) = jgrid._grid_sample_fwd(G, jnp.asarray(c), compute_dtype)
    shape = (32,) + GRID
    dg_j, dc_j = jgb.grid_bwd_fused(shape, jnp.asarray(c), jnp.asarray(g), vals,
                                    compute_dtype=compute_dtype)
    tdt = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    vals_t = _t(np.asarray(vals.astype(jnp.float32))).to(tdt)
    before = k10.grid_bwd_fused.launches
    dg_t, dc_t = k10.grid_bwd_fused(shape, _t(c), _t(g), vals_t, compute_dtype)
    assert k10.grid_bwd_fused.launches == before     # CPU: the plain version
    assert dg_t.shape == shape and dc_t.shape == (P, 3)
    for name, x, y in (("dG", dg_t, dg_j), ("dcoords", dc_t, dc_j)):
        rel, _ = _l2(x, y)
        assert rel <= K10_L2, (name, rel)
    # outside the band: no coordinate gradient
    far = np.abs(c[:, :3]).max(axis=1) > 1.0 + 2.0 / 31
    assert far.any() and not _n(dc_t)[far].any()


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_grid_sample_3d_matches_jax_vjp(compute_dtype):
    """ops/grid.grid_sample_3d (the packed gather; K10 backward) against
    jax.vjp of the JAX op on packed (P, 5) coordinates: the sample, dG, and
    dcoords zero past column 3."""
    rng = np.random.RandomState(1)
    G = rng.randn(32, *GRID).astype(np.float32) * 0.1
    P = 300
    c = _coords(rng, P, 5)
    ct = rng.randn(P, 32).astype(np.float32)
    out_j, vjp = jax.vjp(lambda a, b: jgrid.grid_sample_3d(a, b, compute_dtype),
                         jnp.asarray(G), jnp.asarray(c))
    dg_j, dc_j = vjp(jnp.asarray(ct))
    g_t, c_t = _t(G).requires_grad_(), _t(c).requires_grad_()
    out_t = tgrid.grid_sample_3d(g_t, c_t, compute_dtype)
    out_t.backward(_t(ct))
    np.testing.assert_allclose(_n(out_t), np.asarray(out_j), rtol=1e-6, atol=1e-7)
    for name, x, y in (("dG", g_t.grad, dg_j), ("dcoords", c_t.grad, dc_j)):
        rel, _ = _l2(x, y)
        assert rel <= K10_L2, (name, rel)
    assert not _n(c_t.grad)[:, 3:].any()
    # no gradient wanted: nothing kept for a backward
    with torch.no_grad():
        assert not tgrid.grid_sample_3d(g_t, c_t, compute_dtype).requires_grad


# ---------------------------------------------------------------------------
# K11, K12
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flagship():
    """Flagship widths: the port's seeded weights, handed to JAX as its
    parameter tree; a live sigma head and a scaled rgb head, as
    tests/test_torch_fallback_kernels.py sets them."""
    model = tn.NeRFaceModel.init(tn.ModelSpec.from_config(TConfig()), seed=0,
                                 device="cpu")
    with torch.no_grad():
        model.fine.fc_alpha.bias.fill_(0.5)
        model.fine.fc_rgb.weight.mul_(100.0)
    params = jax.tree.map(jnp.asarray, params_to_jax(model))
    return jn.ModelSpec.from_config(Config()), params, model


def _extra_pe(spec):
    """The extra input's PE spec, as make_render_fns builds it
    (nerface.py:324-331)."""
    groups = ((0, 3, spec.num_encoding_fn_dir, spec.include_input_dir,
               spec.log_sampling_dir), (3, 32, 0, True, True))
    return jfm.PESpec(groups=groups, in_width=40, out_width=jfm._rup(27 + 32))


def _point_inputs(rng, P):
    pts = _coords(rng, P, 5)
    dirs = (rng.randn(P, 3) * 0.1 + [0, 0, -1]).astype(np.float32)
    se = (rng.randn(P, 32) * 0.3).astype(np.float32)
    extra = np.concatenate([dirs, se], axis=1)
    cond = rng.randn(36).astype(np.float32)
    return pts, extra, cond


def _check_leaf(path, x, y, compute_dtype):
    rel, cos = _l2(x, y)
    if compute_dtype == "float32":
        assert rel <= F32_L2, (path, rel)
    else:
        assert rel <= BF16_L2 and cos >= BF16_COS, (path, rel, cos)


def _flipped(x, y):
    """Points whose cotangent row differs beyond float32 rounding."""
    x, y = _n(x).astype(np.float64), np.asarray(y, np.float64)
    tol = 1e-4 * float(np.abs(y).max()) + 1e-3 * np.abs(y)
    return np.flatnonzero(~np.all(np.abs(x - y) <= tol, axis=1))


def _run_op(spec, params, model, pts, extra, cond, ct, compute_dtype):
    """jax.vjp of nerf_mlp_apply_fused and the port's op on the same
    inputs and cotangent. Returns (outputs, port grads, JAX grads), the
    grads as (params tree, pts, extra, cond)."""
    _, pts_pe, _ = jn.build_pe_specs(spec)
    fn_j = lambda p, x, e, c: jfm.nerf_mlp_apply_fused(
        p, 8, 3, x, e, c, compute_dtype=compute_dtype, pe_spec=pts_pe,
        extra_pe_spec=_extra_pe(spec))
    out_j, vjp = jax.vjp(fn_j, params["fine"], jnp.asarray(pts),
                         jnp.asarray(extra), jnp.asarray(cond))
    g_j = vjp(jnp.asarray(ct))
    model.zero_grad(set_to_none=True)
    _, pts_g, dir_g = tn.build_pe_groups(model.spec)
    nerf = model.fine
    x, e, c = (_t(a).requires_grad_() for a in (pts, extra, cond))
    lvl = k57.prepare_level(nerf, c.detach(), pts_g, dir_g)
    op = tfg.PointOp(nerf, list(nerf.parameters()), lvl, compute_dtype)
    counts = (k11.nerf_mlp_forward_fused.launches, k12.nerf_mlp_vjp.launches)
    out_t = tfg.nerf_mlp_apply_fused(op, x, e, c)
    out_t.backward(_t(ct))
    assert (k11.nerf_mlp_forward_fused.launches,
            k12.nerf_mlp_vjp.launches) == counts      # CPU: the plain versions
    port = (grads_to_jax(model)["fine"], x.grad, e.grad, c.grad)
    return (out_t, out_j), port, g_j


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_nerf_mlp_apply_fused_matches_jax_vjp(flagship, monkeypatch, compute_dtype):
    """field_grid.nerf_mlp_apply_fused (K11 forward; K12, the conditioning
    unfold backward) against jax.vjp of the JAX op, from a random cotangent
    of the raw field: the output and the gradients of every NeRF parameter
    (raw trunk), the packed points, the extra input [dir | se] and the
    conditioning."""
    spec, params, model = flagship
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    rng = np.random.RandomState(2)
    P = 300        # not a multiple of a tile
    pts, extra, cond = _point_inputs(rng, P)
    ct = rng.randn(P, 16).astype(np.float32)
    keep = np.arange(P)
    (out_t, out_j), port, g_j = _run_op(spec, params, model, pts, extra, cond,
                                        ct, compute_dtype)
    if compute_dtype == "float32":
        np.testing.assert_allclose(_n(out_t), np.asarray(out_j), rtol=OUT_RTOL,
                                   atol=OUT_ATOL)
        flipped = np.union1d(_flipped(port[1], g_j[1]), _flipped(port[2], g_j[2]))
        assert len(flipped) <= POINT_FLIPS, flipped
        if len(flipped):
            keep = np.setdiff1d(keep, flipped)
            _, port, g_j = _run_op(spec, params, model, pts[keep], extra[keep],
                                   cond, ct[keep], compute_dtype)
    else:
        scale = float(np.abs(np.asarray(out_j)).max())
        np.testing.assert_allclose(_n(out_t), np.asarray(out_j),
                                   atol=BF16_OUT * scale)
    for path, x, y in _leaves(port[0], g_j[0]):
        _check_leaf(path, x, y, compute_dtype)
    for name, x, y in zip(("pts", "extra", "cond"), port[1:], g_j[1:]):
        _check_leaf(name, x, y, compute_dtype)


def test_nerf_mlp_kernels_plain_match_pallas(flagship, monkeypatch):
    """K11 and K12 on their own (folded weights) against
    nerf_mlp_forward_fused and nerf_mlp_vjp, float32: the raw field, gx,
    gextra and every folded gradient leaf, and the wrappers' launch
    counters untouched on the CPU."""
    spec, params, model = flagship
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    rng = np.random.RandomState(3)
    P = 200
    pts, extra, cond = _point_inputs(rng, P)
    ct = rng.randn(P, 16).astype(np.float32)
    _, pts_pe, _ = jn.build_pe_specs(spec)
    epe = _extra_pe(spec)
    kspec, hidden = jfm._nerf_spec_of(8, 3, pts_pe.raw_out, epe.raw_out,
                                      "float32", params["fine"])
    trunk = jfm.fold_conditioning(params["fine"]["trunk"], jnp.asarray(cond),
                                  pts_pe.raw_out)
    p2 = dict(params["fine"], trunk=jfm.fold_skip_conditioning(
        hidden, trunk, 3, jnp.asarray(cond), pts_pe.raw_out))
    raw_j = jfm.nerf_mlp_forward_fused(kspec, jnp.asarray(pts), jnp.asarray(extra),
                                       p2, pts_pe, epe)
    gx_j, ge_j, grads_j = jfm.nerf_mlp_vjp(kspec, jnp.asarray(pts),
                                           jnp.asarray(extra), p2,
                                           jnp.asarray(ct), pts_pe, epe)
    _, pts_g, dir_g = tn.build_pe_groups(model.spec)
    lvl = k57.prepare_level(model.fine, _t(cond), pts_g, dir_g)
    raw_t = k11.nerf_mlp_forward_fused(_t(pts), _t(extra), lvl, "float32")
    gx_t, ge_t, grads_t = k12.nerf_mlp_vjp(_t(pts), _t(extra), _t(ct), lvl,
                                           "float32")
    assert raw_t.shape == (P, 16) and gx_t.shape == (P, 5) and ge_t.shape == (P, 35)
    np.testing.assert_allclose(_n(raw_t), np.asarray(raw_j), rtol=OUT_RTOL,
                               atol=OUT_ATOL)
    flipped = np.union1d(_flipped(gx_t, gx_j), _flipped(ge_t, ge_j))
    assert len(flipped) <= POINT_FLIPS, flipped
    keep = np.setdiff1d(np.arange(P), flipped)
    if len(flipped):
        gx_j, ge_j, grads_j = jfm.nerf_mlp_vjp(
            kspec, jnp.asarray(pts[keep]), jnp.asarray(extra[keep]), p2,
            jnp.asarray(ct[keep]), pts_pe, epe)
        gx_t, ge_t, grads_t = k12.nerf_mlp_vjp(_t(pts[keep]), _t(extra[keep]),
                                               _t(ct[keep]), lvl, "float32")
    for path, x, y in _leaves(grads_t, grads_j):
        _check_leaf(path, x, y, "float32")
    _check_leaf("gx", gx_t, gx_j, "float32")
    _check_leaf("gextra", ge_t, ge_j, "float32")


@pytest.mark.parametrize("P", [200, 64 * 3])
def test_nerf_mlp_forward_plain_matches_pallas_bfloat16(flagship, monkeypatch, P):
    """K11's plain version in bfloat16 (the reference of the tensor-core
    K11 on the card) against nerf_mlp_forward_fused in bfloat16, at a P
    that is not a multiple of the 64-point tile and at one that is: every
    product's operands rounded to bf16 on both sides, float32 sums in
    another order, so the raw field agrees within BF16_OUT of its scale."""
    spec, params, model = flagship
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    rng = np.random.RandomState(4)
    pts, extra, cond = _point_inputs(rng, P)
    _, pts_pe, _ = jn.build_pe_specs(spec)
    epe = _extra_pe(spec)
    kspec, hidden = jfm._nerf_spec_of(8, 3, pts_pe.raw_out, epe.raw_out,
                                      "bfloat16", params["fine"])
    trunk = jfm.fold_conditioning(params["fine"]["trunk"], jnp.asarray(cond),
                                  pts_pe.raw_out)
    p2 = dict(params["fine"], trunk=jfm.fold_skip_conditioning(
        hidden, trunk, 3, jnp.asarray(cond), pts_pe.raw_out))
    raw_j = np.asarray(jfm.nerf_mlp_forward_fused(
        kspec, jnp.asarray(pts), jnp.asarray(extra), p2, pts_pe, epe), np.float32)
    _, pts_g, dir_g = tn.build_pe_groups(model.spec)
    lvl = k57.prepare_level(model.fine, _t(cond), pts_g, dir_g)
    before = k11.nerf_mlp_forward_fused.launches
    raw_t = k11.nerf_mlp_forward_fused(_t(pts), _t(extra), lvl, "bfloat16")
    assert k11.nerf_mlp_forward_fused.launches == before   # CPU: the plain version
    assert raw_t.shape == (P, 16) and torch.isfinite(raw_t).all()
    np.testing.assert_allclose(_n(raw_t), raw_j,
                               atol=BF16_OUT * float(np.abs(raw_j).max()))


def test_point_kernel_wrappers_refuse_bad_shapes(flagship):
    """A CUDA call with an extra input of the wrong width, or on a device
    other than the CPU and CUDA, raises before any launch."""
    _, _, model = flagship
    _, pts_g, dir_g = tn.build_pe_groups(model.spec)
    lvl = k57.prepare_level(model.fine, torch.zeros(36), pts_g, dir_g)
    with pytest.raises(ValueError, match="K11 shapes"):
        k11.point_kernel_args(torch.zeros(8, 5), torch.zeros(8, 34), lvl, "K11")
    with pytest.raises(ValueError, match="unsupported device"):
        k11.nerf_mlp_forward_fused(torch.zeros((4, 5), device="meta"),
                                   torch.zeros((4, 35), device="meta"), lvl)
    with pytest.raises(ValueError, match="unsupported device"):
        k10.grid_bwd_fused((32,) + GRID, torch.zeros((4, 3), device="meta"),
                           torch.zeros((4, 32), device="meta"),
                           torch.zeros((4, 256), device="meta"))
