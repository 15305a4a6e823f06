"""The autograd fallback's kernels and ops against the JAX package, float32,
Pallas in interpret mode with the exact-f32 PE angle (_PE_SPLIT_DOT off,
as tests/test_torch_kernels.py runs it):

  K6 nerf_level_vjp_plain  vs field_mlp.nerf_level_vjp
  K7 nerf_raw_plain        vs field_mlp.nerf_rayd_forward
  K8 nerf_rayd_vjp_plain   vs field_mlp.nerf_rayd_vjp
  K9 grid_dg_coords_plain  vs grid_bwd.grid_dg_slab and grid._grid_cotangent
  field_grid.nerf_render_level_grid and nerf_mlp_apply_rayd_grid (the
  autograd Functions over K5/K6/K9 and K7/K8/K9) vs jax.vjp of the JAX ops
  deform_pair_apply_fused (K1/K3) vs jax.vjp of the JAX op

Tolerances: outputs within 3e-5 relative and 1e-6 absolute. A gradient, on
the same inputs as JAX's, within rtol 5e-3 (tests/test_fused_train.py's,
the sums being taken in another order) and an absolute 1e-3 of its own
largest JAX entry, so that a small leaf is held to its own scale. A point
cotangent (gx, gse) point by point the same way, but for at most
POINT_FLIPS points, and at a cosine of 0.9999 over all points: where a
trunk pre-activation lies within rounding of 0 the two sides take the
other slope of the leaky ReLU and that one point's cotangent moves by some
10 % (chip_smoke.py counts the same flips on the card). Such a point
also moves the weight gradients that it feeds, so when one flips the test
runs again without the rays that hold one, and holds every gradient leaf
at the tolerance above on the rest. Without a
background sigma's head gradient is a nearly cancelled sum (every ray's
weights add up to 1): that head is held by its norm, 5e-2 L2-relative and
0.998 cosine (tests/test_torch_train.py's reading of the same sum).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sahs_tpu.config import Config
from sahs_tpu.models import nerface as jn
from sahs_tpu.ops import grid as jgrid
from sahs_tpu.ops.pallas import field_grid as jfg
from sahs_tpu.ops.pallas import field_mlp as jfm
from sahs_tpu.ops.pallas import grid_bwd as jgb

from sahs_tpu_torch.config import Config as TConfig
from sahs_tpu_torch.models import nerface as tn
from sahs_tpu_torch.ops.grid import _cell_geometry, pack_corner_table
from sahs_tpu_torch.ops.kernels import deform_pair as k1
from sahs_tpu_torch.ops.kernels import field_grid as tfg
from sahs_tpu_torch.ops.kernels import grid_bwd as k9
from sahs_tpu_torch.ops.kernels import level_train as k68
from sahs_tpu_torch.ops.kernels import nerf_level as k57
from sahs_tpu_torch.utils.weights import grads_to_jax, params_to_jax

torch.set_num_threads(2)

GRID = (32, 32, 32)
OUT_RTOL, OUT_ATOL = 3e-5, 1e-6
G_RTOL, G_SCALE = 5e-3, 1e-3
NORM_L2, NORM_COS = 5e-2, 0.998
POINT_FLIPS = 4


def _t(x):
    return torch.tensor(np.asarray(x))


def _n(x):
    return np.asarray(x.detach().cpu()) if torch.is_tensor(x) else np.asarray(x)


def _close_grad(x, y, path):
    y = np.asarray(y)
    np.testing.assert_allclose(_n(x), y, rtol=G_RTOL,
                               atol=G_SCALE * float(np.abs(y).max(initial=0.0)),
                               err_msg=path)


def _close_points(x, y, path):
    """Per-point cotangents (P, k): all but POINT_FLIPS points within the
    gradient tolerance, and a cosine of at least 0.9999. Returns the
    indices of the points outside it."""
    x, y = _n(x).astype(np.float64), np.asarray(y, np.float64)
    atol = G_SCALE * float(np.abs(y).max(initial=0.0))
    bad = ~np.all(np.abs(x - y) <= atol + G_RTOL * np.abs(y), axis=1)
    cos = float((x * y).sum()) / (np.linalg.norm(x) * np.linalg.norm(y))
    assert int(bad.sum()) <= POINT_FLIPS and cos >= 0.9999, (
        path, np.flatnonzero(bad), cos)
    return np.flatnonzero(bad)


def _flip_free(run, R, S):
    """``run(rays)`` evaluates both sides on those rays and returns (point
    cotangents [(name, port, jax)], the rest). The point cotangents are
    held with the POINT_FLIPS allowance; if a point flipped, ``run`` is
    called again without the rays that hold one, and its point cotangents
    must then agree everywhere. Returns the last call's rest."""
    rays = np.arange(R)
    points, rest = run(rays)
    flipped = set()
    for name, x, y in points:
        flipped |= {int(p) // S for p in _close_points(x, y, name)}
    if flipped:
        rays = np.array([r for r in rays if r not in flipped])
        points, rest = run(rays)
        for name, x, y in points:
            assert not len(_close_points(x, y, name)), name
    return rest


def _close_norm(x, y, path):
    x, y = _n(x).astype(np.float64).ravel(), np.asarray(y, np.float64).ravel()
    rel = np.linalg.norm(x - y) / np.linalg.norm(y)
    cos = float(x @ y) / (np.linalg.norm(x) * np.linalg.norm(y))
    assert rel <= NORM_L2 and cos >= NORM_COS, (path, rel, cos)


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


def assert_grads_close(a, b, by_norm=()):
    """Every leaf against its own scale; a leaf whose path holds one of
    ``by_norm`` by its norm and cosine."""
    for path, x, y in _leaves(a, b):
        if any(n in path for n in by_norm):
            _close_norm(x, y, path)
        else:
            _close_grad(x, y, path)


@pytest.fixture(scope="module")
def flagship():
    """Flagship widths: the port's seeded weights, handed to JAX as its
    parameter tree. A live sigma head and a scaled rgb head, as
    tests/test_torch_train.py sets them, so that the gradients are not
    rounding alone."""
    model = tn.NeRFaceModel.init(tn.ModelSpec.from_config(TConfig()), seed=0,
                                 device="cpu")
    with torch.no_grad():
        model.coarse.fc_alpha.bias.fill_(0.5)
        model.coarse.fc_rgb.weight.mul_(100.0)
    params = jax.tree.map(jnp.asarray, params_to_jax(model))
    return jn.ModelSpec.from_config(Config()), params, model


def _level_inputs(rng, R, S, with_bg, with_noise):
    """Packed points (inside, on cell faces, past the grid), rays, z, bg,
    noise and a 36-d conditioning (the flagship level's pose)."""
    pts = np.concatenate([rng.uniform(-1.05, 1.05, (R * S, 3)),
                          rng.uniform(-1, 1, (R * S, 2))], 1).astype(np.float32)
    pts[:8, :3] = (2.0 * rng.randint(0, 32, (8, 3)) / 31.0 - 1.0)
    dirs = (rng.randn(R, 3) * 0.1 + [0, 0, -1]).astype(np.float32)
    z = np.sort(rng.uniform(0.48, 1.08, (R, S)), axis=-1).astype(np.float32)
    bg = rng.rand(R, 15).astype(np.float32) if with_bg else None
    noise = (rng.randn(R, S) * 0.5).astype(np.float32) if with_noise else None
    cond = rng.randn(36).astype(np.float32)
    return pts, dirs, z, bg, noise, cond


def _jax_level(spec, params, cond, S):
    """The JAX kernels' spec, folded parameters and PE specs."""
    _, pts_pe, dir_pe = jn.build_pe_specs(spec)
    grid = params["spatial_embeddings"]
    kspec, hidden = jfg._grid_spec(8, 3, pts_pe.raw_out, S, "float32",
                                   dir_pe.raw_out, grid.shape, params["coarse"])
    p2 = jfg._fold(params["coarse"], jnp.asarray(cond), pts_pe.raw_out, 3, hidden)
    return kspec, p2, pts_pe, dir_pe


def _port_level(model, cond, pts):
    _, pts_g, dir_g = tn.build_pe_groups(model.spec)
    lvl = k57.prepare_level(model.coarse, _t(cond), pts_g, dir_g)
    table = pack_corner_table(model.spatial_embeddings.detach())
    rows, _, _ = _cell_geometry(_t(pts), GRID)
    return lvl, table, rows


def _opt(a, f):
    return None if a is None else f(a)


# ---------------------------------------------------------------------------
# K6, K7, K8, K9: the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_bg,with_noise", [(True, True), (False, False)])
def test_nerf_level_vjp_plain_matches_pallas(flagship, monkeypatch, with_bg,
                                             with_noise):
    """K6's plain version vs nerf_level_vjp: gx, gse, g_bg and every folded
    gradient leaf, from random cotangents of rgb_map and the weights."""
    spec, params, model = flagship
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    rng = np.random.RandomState(4)
    R, S = 16, 16
    pts, dirs, z, bg, noise, cond = _level_inputs(rng, R, S, with_bg, with_noise)
    g_rgb = rng.randn(R, 16).astype(np.float32)
    g_w = rng.randn(R, S).astype(np.float32)

    def run(rays):
        sel = lambda a: None if a is None else a[rays]
        x = pts.reshape(R, S, -1)[rays].reshape(-1, pts.shape[1])
        args = (dirs[rays], z[rays], sel(bg), sel(noise), g_rgb[rays],
                g_w[rays])
        kspec, p2, pts_pe, dir_pe = _jax_level(spec, params, cond, S)
        corners = jfg.gather_corners(params["spatial_embeddings"],
                                     jnp.asarray(x), "float32")
        d, zz, b, nz, gr, gw = (_opt(a, jnp.asarray) for a in args)
        gx_j, gse_j, gbg_j, grads_j = jfm.nerf_level_vjp(
            kspec, jnp.asarray(x), d, corners, zz, b, nz, p2, gr, gw, pts_pe,
            dir_pe)
        lvl, table, rows = _port_level(model, cond, x)
        before = k68.nerf_level_vjp.launches
        d, zz, b, nz, gr, gw = (_opt(a, _t) for a in args)
        gx_t, gse_t, gbg_t, grads_t = k68.nerf_level_vjp(
            _t(x), d, table, rows, zz, b, nz, gr, gw, lvl, "float32", GRID)
        assert k68.nerf_level_vjp.launches == before   # CPU: the plain version
        return ([("gx", gx_t, gx_j), ("gse", gse_t, gse_j)],
                (gbg_t, gbg_j, grads_t, grads_j))

    gbg_t, gbg_j, grads_t, grads_j = _flip_free(run, R, S)
    if with_bg:
        _close_grad(gbg_t, gbg_j, "g_bg")
    else:
        assert gbg_t is None and gbg_j is None
    assert_grads_close(grads_t, grads_j, by_norm=() if with_bg else ("fc_alpha",))


def test_nerf_rayd_plain_matches_pallas(flagship, monkeypatch):
    """K7's plain version vs nerf_rayd_forward, and K8's vs nerf_rayd_vjp
    from a random cotangent of the raw field."""
    spec, params, model = flagship
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    rng = np.random.RandomState(5)
    R, S = 16, 16
    pts, dirs, _, _, _, cond = _level_inputs(rng, R, S, False, False)
    g = rng.randn(R * S, 16).astype(np.float32)

    def run(rays):
        x = pts.reshape(R, S, -1)[rays].reshape(-1, pts.shape[1])
        gr = g.reshape(R, S, -1)[rays].reshape(-1, 16)
        kspec, p2, pts_pe, dir_pe = _jax_level(spec, params, cond, S)
        corners = jfg.gather_corners(params["spatial_embeddings"],
                                     jnp.asarray(x), "float32")
        raw_j = jfm.nerf_rayd_forward(kspec, jnp.asarray(x),
                                      jnp.asarray(dirs[rays]), corners, p2,
                                      pts_pe, dir_pe)
        gx_j, gse_j, grads_j = jfm.nerf_rayd_vjp(
            kspec, jnp.asarray(x), jnp.asarray(dirs[rays]), corners, p2,
            jnp.asarray(gr), pts_pe, dir_pe)
        lvl, table, rows = _port_level(model, cond, x)
        counts = (k57.nerf_rayd_forward.launches, k68.nerf_rayd_vjp.launches)
        raw_t = k57.nerf_rayd_forward(_t(x), _t(dirs[rays]), table, rows, lvl,
                                      "float32", GRID)
        gx_t, gse_t, grads_t = k68.nerf_rayd_vjp(
            _t(x), _t(dirs[rays]), table, rows, _t(gr), lvl, "float32", GRID)
        assert (k57.nerf_rayd_forward.launches,
                k68.nerf_rayd_vjp.launches) == counts
        assert raw_t.shape == (len(rays) * S, 16)
        np.testing.assert_allclose(_n(raw_t), np.asarray(raw_j), rtol=OUT_RTOL,
                                   atol=OUT_ATOL * float(np.abs(raw_j).max()))
        return [("gx", gx_t, gx_j), ("gse", gse_t, gse_j)], (grads_t, grads_j)

    grads_t, grads_j = _flip_free(run, R, S)
    assert_grads_close(grads_t, grads_j)


BF16_OUT = 2e-2   # the bf16 gate of PARITY_TPU.json, of the output's scale


def test_nerf_rayd_plain_matches_pallas_bfloat16(flagship, monkeypatch):
    """K7's plain version in bfloat16 (the reference of the tensor-core K7
    on the card) vs nerf_rayd_forward in bfloat16: the corner table and
    every product's operands in bf16 on both sides, float32 sums in another
    order, so the raw field agrees within the bf16 gate of its scale."""
    spec, params, model = flagship
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    rng = np.random.RandomState(6)
    R, S = 16, 16
    pts, dirs, _, _, _, cond = _level_inputs(rng, R, S, False, False)
    _, pts_pe, dir_pe = jn.build_pe_specs(spec)
    grid = params["spatial_embeddings"]
    kspec, hidden = jfg._grid_spec(8, 3, pts_pe.raw_out, S, "bfloat16",
                                   dir_pe.raw_out, grid.shape, params["coarse"])
    p2 = jfg._fold(params["coarse"], jnp.asarray(cond), pts_pe.raw_out, 3, hidden)
    corners = jfg.gather_corners(grid, jnp.asarray(pts), "bfloat16")
    raw_j = np.asarray(jfm.nerf_rayd_forward(kspec, jnp.asarray(pts),
                                             jnp.asarray(dirs), corners, p2,
                                             pts_pe, dir_pe), np.float32)
    lvl, _, rows = _port_level(model, cond, pts)
    table = pack_corner_table(model.spatial_embeddings.detach(), dtype=torch.bfloat16)
    before = k57.nerf_rayd_forward.launches
    raw_t = k57.nerf_rayd_forward(_t(pts), _t(dirs), table, rows, lvl,
                                  "bfloat16", GRID)
    assert k57.nerf_rayd_forward.launches == before   # CPU: the plain version
    assert raw_t.shape == (R * S, 16) and torch.isfinite(raw_t).all()
    np.testing.assert_allclose(_n(raw_t), raw_j,
                               atol=BF16_OUT * float(np.abs(raw_j).max()))


def test_grid_dg_coords_plain_matches_pallas_and_xla():
    """K9's plain version vs grid_dg_slab and the XLA _grid_cotangent, on
    sample-major points inside the grid, on cell faces, on the grid's faces
    and outside it."""
    rng = np.random.RandomState(3)
    R, S = 50, 48
    P = R * S
    pts = rng.uniform(-1.1, 1.1, (P, 5)).astype(np.float32)
    pts[:200, :3] = (2.0 * rng.randint(0, 32, (200, 3)) / 31.0 - 1.0)
    pts[200:206, :3] = [[-1, -1, -1], [1, 1, 1], [1.2, 0, 0], [0, 0, 1.0000001],
                        [0.999, 0.999, -0.999], [-3, 3, 0]]
    g = rng.randn(P, 32).astype(np.float32)
    coords = tfg.sample_major(_t(pts), R, S)
    g_sm = tfg.sample_major(_t(g), R, S)
    shape = (32,) + GRID
    before = k9.grid_dg_coords.launches
    dg_t = k9.grid_dg_coords(coords, g_sm, shape)
    assert k9.grid_dg_coords.launches == before
    dg_j = jgb.grid_dg_slab(shape, jnp.asarray(_n(coords)), jnp.asarray(_n(g_sm)),
                            "float32")
    dg_x = jgrid._grid_cotangent(shape, jnp.asarray(pts[:, :3]), jnp.asarray(g),
                                 jnp.float32)
    scale = float(np.abs(np.asarray(dg_j)).max())
    for ref in (dg_j, dg_x):
        np.testing.assert_allclose(_n(dg_t), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5 * scale)
    np.testing.assert_array_equal(
        _n(coords).reshape(S, R, 5).transpose(1, 0, 2).reshape(P, 5), pts)


# ---------------------------------------------------------------------------
# The autograd ops against jax.vjp of the JAX ops
# ---------------------------------------------------------------------------

def _level_grads(model, nerf_name="coarse"):
    return grads_to_jax(model)[nerf_name]


@pytest.mark.parametrize("raw_field", [False, True])
def test_grid_ops_match_jax_vjp(flagship, monkeypatch, raw_field):
    """field_grid.nerf_render_level_grid (raw_field False: K5 forward, K6 +
    unfold + K9 backward) and nerf_mlp_apply_rayd_grid (True: K7, K8 +
    unfold + K9) against jax.vjp of the JAX ops, on the same random
    cotangents: the outputs and the gradients of the NeRF parameters (raw
    trunk), the grid, the points, the background and the conditioning."""
    spec, params, model = flagship
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    rng = np.random.RandomState(6)
    R, S = 16, 16
    pts, dirs, z, bg, noise, cond = _level_inputs(rng, R, S, True, True)
    cts = ((rng.randn(R * S, 16).astype(np.float32),) if raw_field else
           (rng.randn(R, 16).astype(np.float32), rng.randn(R, S).astype(np.float32)))
    _, pts_pe, dir_pe = jn.build_pe_specs(spec)

    def run(rays):
        x_np = pts.reshape(R, S, -1)[rays].reshape(-1, pts.shape[1])
        n = len(rays)
        d, zz, nz, bb = dirs[rays], z[rays], noise[rays], bg[rays]
        ct = ((cts[0].reshape(R, S, 16)[rays].reshape(-1, 16),) if raw_field
              else (cts[0][rays], cts[1][rays]))
        if raw_field:
            fn_j = lambda p, gr, x, b, c: jfg.nerf_mlp_apply_rayd_grid(
                p, gr, 8, 3, x, jnp.asarray(d), S, c, compute_dtype="float32",
                pe_spec=pts_pe, dir_pe_spec=dir_pe)
        else:
            fn_j = lambda p, gr, x, b, c: jfg.nerf_render_level_grid(
                p, gr, 8, 3, x, jnp.asarray(d), S, jnp.asarray(zz), b,
                jnp.asarray(nz), c, compute_dtype="float32", pe_spec=pts_pe,
                dir_pe_spec=dir_pe)
        out_j, vjp = jax.vjp(fn_j, params["coarse"], params["spatial_embeddings"],
                             jnp.asarray(x_np), jnp.asarray(bb), jnp.asarray(cond))
        g_j = vjp(jnp.asarray(ct[0]) if raw_field else tuple(map(jnp.asarray, ct)))

        model.zero_grad(set_to_none=True)
        _, pts_g, dir_g = tn.build_pe_groups(model.spec)
        nerf = model.coarse
        lvl = k57.prepare_level(nerf, _t(cond), pts_g, dir_g)
        table = tfg.corner_table(model.spatial_embeddings, "float32")
        rows, _, _ = _cell_geometry(_t(x_np), GRID)
        op = tfg.GridLevelOp(nerf, list(nerf.parameters()), lvl, table,
                             rows.to(torch.int32).reshape(n, S), _t(d), S,
                             "float32", (32,) + GRID, _t(zz), _t(nz))
        x, b, c = (_t(a).requires_grad_() for a in (x_np, bb, cond))
        if raw_field:
            out_t = (tfg.nerf_mlp_apply_rayd_grid(op, model.spatial_embeddings,
                                                  x, c),)
        else:
            out_t = tfg.nerf_render_level_grid(op, model.spatial_embeddings, x,
                                               b, c)
        torch.autograd.backward(out_t, [_t(a) for a in ct])
        for a, o in zip(out_t, (out_j,) if raw_field else out_j):
            np.testing.assert_allclose(_n(a), np.asarray(o), rtol=OUT_RTOL,
                                       atol=OUT_ATOL * float(np.abs(o).max()))
        port = (grads_to_jax(model)["coarse"], model.spatial_embeddings.grad,
                c.grad, b.grad)
        return [("pts", x.grad, g_j[2])], (port, g_j)

    (g_params, g_grid, g_cond, g_bg), g_j = _flip_free(run, R, S)
    assert_grads_close(g_params, g_j[0])
    _close_grad(g_grid, g_j[1], "grid")
    _close_grad(g_cond, g_j[4], "cond")
    if raw_field:
        assert g_bg is None
    else:
        _close_grad(g_bg, g_j[3], "bg")


def test_deform_pair_op_matches_jax_vjp(flagship, monkeypatch):
    """deform_pair_apply_fused (K1 forward, K3 + unfold backward) against
    jax.vjp of the JAX op (need_input_grad=False): the packed output, the
    rows, and the warp, hyper and conditioning gradients."""
    spec, params, model = flagship
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    rng = np.random.RandomState(7)
    S = 16
    P = 64 * S
    pts = rng.uniform(-0.6, 0.6, (P, 3)).astype(np.float32)
    cond = (rng.randn(76 + 36) * 0.5).astype(np.float32)
    ct = (rng.randn(P, 5) * 0.1).astype(np.float32)
    warp_pe, _, _ = jn.build_pe_specs(spec)

    def fn_j(pw, ph, c):
        packed, _ = jfm.deform_pair_apply_fused(
            pw, ph, (6, 128, 4, 3, "tanh"), (6, 64, 4, 2, "linear"),
            jnp.asarray(pts), c, compute_dtype="float32", pe_spec=warp_pe,
            need_input_grad=False, emit_rows=(S, GRID))
        return packed[:, :5]
    out_j, vjp = jax.vjp(fn_j, params["warp"], params["hyper"], jnp.asarray(cond))
    g_w, g_h, g_c = vjp(jnp.asarray(ct))

    model.zero_grad(set_to_none=True)
    warp_g, _, _ = tn.build_pe_groups(model.spec)
    nets = (model.warp, model.hyper)
    c = _t(cond).requires_grad_()
    pair = k1.prepare_pair(*nets, c.detach(), warp_g)
    op = k1.PairOp(*nets, [p for n in nets for p in n.parameters()], pair,
                   _t(pts), S, GRID, "float32")
    packed, rows = k1.deform_pair_apply_fused(op, c)
    assert not rows.requires_grad and rows.shape == (P // S, S)
    packed.backward(_t(ct))
    np.testing.assert_allclose(_n(packed), np.asarray(out_j), atol=1e-5)
    tree = grads_to_jax(model)
    assert_grads_close({"warp": tree["warp"], "hyper": tree["hyper"]},
                       {"warp": g_w, "hyper": g_h})
    _close_grad(c.grad, g_c, "cond")
