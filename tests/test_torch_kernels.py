"""The plain versions of the port's kernels against the JAX package's Pallas
kernels (interpret mode, float32). The kernels themselves are held against
these plain versions on the card by tests/test_torch_cuda.py.

K1 deform_pair_forward vs field_mlp.deform_pair_apply_fused(emit_rows=...)
K5 nerf_level_forward  vs field_grid.nerf_render_level_grid
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sahs_tpu.config import Config
from sahs_tpu.models import nerface as jn
from sahs_tpu.ops.pallas import field_grid as jfg
from sahs_tpu.ops.pallas import field_mlp as jfm

from sahs_tpu_torch.config import Config as TConfig
from sahs_tpu_torch.models import nerface as tn
from sahs_tpu_torch.ops.grid import _cell_geometry, pack_corner_table
from sahs_tpu_torch.ops.kernels import deform_pair as k1
from sahs_tpu_torch.ops.kernels import nerf_level as k5
from sahs_tpu_torch.ops.kernels.field_grid import gather_corners_from_rows
from sahs_tpu_torch.ops.kernels.field_mlp import kernel_pe, torch_dtype
from sahs_tpu_torch.utils.weights import params_to_jax

torch.set_num_threads(2)

GRID = (32, 32, 32)


@pytest.fixture(scope="module")
def flagship():
    """Flagship widths (the shapes the CUDA kernels take): the port's
    seeded weights, handed to JAX as its parameter tree."""
    spec = jn.ModelSpec.from_config(Config())
    model = tn.NeRFaceModel.init(tn.ModelSpec.from_config(TConfig()), seed=0,
                                device="cpu")
    params = jax.tree.map(jnp.asarray, params_to_jax(model))
    rng = np.random.RandomState(0)
    cond = rng.randn(76 + 36).astype(np.float32) * 0.5
    return spec, params, model, rng, cond


def _t(x):
    return torch.tensor(np.asarray(x))


def test_kernel_pe_matches_pallas_pe():
    """The kernels' in-kernel PE (sin(x f + phase)) vs the Pallas one, on
    the warp and the point groups."""
    spec = jn.ModelSpec.from_config(Config())
    warp_pe, pts_pe, _ = jn.build_pe_specs(spec)
    x = np.random.RandomState(1).uniform(-1.5, 1.5, (64, 8)).astype(np.float32)
    for pe in (warp_pe, pts_pe):
        refs = [jnp.asarray(a) for a in jfm._pe_tables(pe)]
        out_j = np.asarray(jfm._pe_apply(jnp.asarray(x), refs))[:, :pe.raw_out]
        out_t = kernel_pe(_t(x), pe.groups)
        # the Pallas angle x@scale sums a two-term bf16 split of x, which
        # drops x's last bits: ~4e-3 of angle error at f = 2^9 here
        np.testing.assert_allclose(out_t.numpy(), out_j, atol=1e-2)
    # against the exact f32 angle the two agree to float32 rounding
    _, pts_t, _ = tn.build_pe_groups(tn.ModelSpec.from_config(TConfig()))
    exact = np.concatenate(
        [x[:, :3]] + [f(x[:, :3] * np.float32(2.0 ** k))
                      for k in range(10) for f in (np.sin, np.cos)]
        + [x[:, 3:5]] + [f(x[:, 3:5] * np.float32(2.0 ** k))
                         for k in range(4) for f in (np.sin, np.cos)], axis=1)
    np.testing.assert_allclose(kernel_pe(_t(x), pts_t).numpy(), exact, atol=1e-4)


@pytest.mark.parametrize("S", [8, 16])
def test_deform_pair_plain_matches_pallas(flagship, monkeypatch, S):
    """K1's plain version vs deform_pair_apply_fused(emit_rows=(S, grid)),
    float32: packed outputs within 1e-5, corner-table rows exactly equal.
    The Pallas PE runs with its exact-f32 angle (SAHS_PE_SPLIT_DOT=0)."""
    spec, params, model, rng, cond = flagship
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    P = 16 * S
    pts = rng.uniform(-0.45, 0.45, (P, 3)).astype(np.float32)
    warp_pe, _, _ = jn.build_pe_specs(spec)
    packed_j, rows_j = jfm.deform_pair_apply_fused(
        params["warp"], params["hyper"], (6, 128, 4, 3, "tanh"),
        (6, 64, 4, 2, "linear"), jnp.asarray(pts), jnp.asarray(cond),
        compute_dtype="float32", pe_spec=warp_pe, need_input_grad=False,
        emit_rows=(S, GRID))
    warp_g, _, _ = tn.build_pe_groups(model.spec)
    weights = k1.prepare_pair(model.warp, model.hyper, _t(cond), warp_g)
    before = k1.deform_pair_forward.launches
    packed_t, rows_t = k1.deform_pair_forward(_t(pts), weights, "float32",
                                              samples=S, grid_dims=GRID)
    assert k1.deform_pair_forward.launches == before   # CPU: plain version
    np.testing.assert_allclose(packed_t.numpy(), np.asarray(packed_j)[:, :5],
                               atol=1e-5)
    assert rows_t.shape == (P // S, S) and rows_t.dtype == torch.int32
    np.testing.assert_array_equal(rows_t.numpy(),
                                  np.asarray(rows_j).astype(np.int32))
    # and the rows are _cell_geometry's of the emitted coordinates
    rows_c, _, _ = _cell_geometry(packed_t[:, :3], GRID)
    np.testing.assert_array_equal(rows_t.reshape(-1).numpy(), rows_c.numpy())


@pytest.mark.parametrize("with_bg,with_noise", [(True, True), (False, True),
                                                (True, False)])
def test_nerf_level_plain_matches_pallas(flagship, monkeypatch, with_bg,
                                         with_noise):
    """K5's plain version vs nerf_render_level_grid (float32, in-kernel
    corner interp and compositing): rgb_map within 1e-4, weights 1e-5."""
    spec, params, model, rng, _ = flagship
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    R, S = 8, 8
    pts = np.concatenate([rng.uniform(-1.05, 1.05, (R * S, 3)),
                          rng.uniform(-1, 1, (R * S, 2))], 1).astype(np.float32)
    pts[:4, 0] = [-1.0, 1.0, np.nextafter(np.float32(-1), np.float32(0)), 0.0]
    dirs = (rng.randn(R, 3) * 0.1 + [0, 0, -1]).astype(np.float32)
    z = np.sort(rng.uniform(0.48, 1.08, (R, S)), axis=-1).astype(np.float32)
    bg = rng.rand(R, 15).astype(np.float32) if with_bg else None
    noise = (rng.randn(R, S) * 0.5).astype(np.float32) if with_noise else None
    cond = rng.randn(36).astype(np.float32)
    # sigma active: a positive alpha bias so the weights are not all ~0
    with torch.no_grad():
        model.coarse.fc_alpha.bias.fill_(0.5)
    params = dict(params)
    params["coarse"] = dict(params["coarse"])
    params["coarse"]["fc_alpha"] = {"w": params["coarse"]["fc_alpha"]["w"],
                                    "b": jnp.full((1,), 0.5, jnp.float32)}
    _, pts_pe, dir_pe = jn.build_pe_specs(spec)
    opt = lambda a: None if a is None else jnp.asarray(a)
    rgb_j, w_j = jfg.nerf_render_level_grid(
        params["coarse"], params["spatial_embeddings"], 8, 3, jnp.asarray(pts),
        jnp.asarray(dirs), S, jnp.asarray(z), opt(bg), opt(noise),
        jnp.asarray(cond), compute_dtype="float32", pe_spec=pts_pe,
        dir_pe_spec=dir_pe)
    _, pts_g, dir_g = tn.build_pe_groups(model.spec)
    weights = k5.prepare_level(model.coarse, _t(cond), pts_g, dir_g)
    table = pack_corner_table(model.spatial_embeddings.detach())
    rows, _, _ = _cell_geometry(_t(pts), GRID)
    topt = lambda a: None if a is None else _t(a)
    before = k5.nerf_level_forward.launches
    rgb_t, w_t = k5.nerf_level_forward(_t(pts), _t(dirs), table, rows, _t(z),
                                       topt(bg), topt(noise), weights,
                                       "float32", GRID)
    assert k5.nerf_level_forward.launches == before
    assert rgb_t.shape == (R, 16) and w_t.shape == (R, S)
    assert float(w_t.sum()) > 0.5
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=1e-4)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-5)


def test_wrappers_refuse_other_devices(flagship):
    """A tensor on neither the CPU nor a CUDA device is refused, not
    silently computed elsewhere."""
    _, _, model, _, cond = flagship
    warp_g, _, _ = tn.build_pe_groups(model.spec)
    weights = k1.prepare_pair(model.warp, model.hyper, _t(cond), warp_g)
    with pytest.raises(ValueError, match="unsupported device"):
        k1.deform_pair_forward(torch.zeros((4, 3), device="meta"), weights,
                               "float32", 4, GRID)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_gather_corners_from_rows_matches_jax(compute_dtype):
    """The corner rows of the table by row index, in the compute dtype."""
    rng = np.random.RandomState(2)
    grid = rng.randn(4, 3, 5, 6).astype(np.float32)
    rows = rng.randint(0, 4 * 6 * 7, (5, 8))
    out_j = jfg.gather_corners_from_rows(jnp.asarray(grid),
                                         jnp.asarray(rows, jnp.float32),
                                         compute_dtype)
    out_t = gather_corners_from_rows(_t(grid), torch.tensor(rows), compute_dtype)
    assert out_t.shape == (40, 32) and out_t.dtype == torch_dtype(compute_dtype)
    np.testing.assert_array_equal(out_t.float().numpy(),
                                  np.asarray(out_j.astype(jnp.float32)))
