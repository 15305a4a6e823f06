"""Models without the spatial-embedding grid on the port's kernel path,
against the JAX package (float32, Pallas in interpret mode; the port's
kernels as their plain versions on the CPU):

  (a) the render of a grid-free flagship model (view directions, no grid)
      with fuse_composite on (K1 without rows, K5 with C = 0) and off (the
      reuse path: K7), and at 8 + 12 (the fine level per point: K11 on
      the direction alone), against JAX's render_rays with use_pallas on,
      which takes the same grid-free kernels (nerface.py:413-485);
  (b) one train step of that model on the fused path (K2 with C = 0, no
      K4), fallback path 1 (fused_grads off: K5/K6), the reuse path
      (fuse_composite off: K7/K8) and the per-point step (8 + 12: K11/K12)
      against JAX's train_step on the same draws, leaf by leaf;
  (c) the port's stage1_fused_eligible equals JAX's over a grid of models
      and render settings;
  (d) a grid-free warp-only model (its warp net on K13/K14) renders and
      trains against the JAX plain path: JAX's kernel path of a warp-only
      model raises (ROADMAP, faults of the reference).

Tolerances: the render as tests/test_torch_render.py holds it (1e-4
absolute, disparity and depth 1e-3 relative); a step's metrics within
3e-5 relative and every gradient leaf within 5e-2 L2-relative at a
cosine of 0.998 (tests/test_torch_fallback_steps.py gives the reason).
"""
import itertools

import numpy as np
import pytest

import jax

from sahs_tpu.config import Config
from sahs_tpu.models import nerface as jn
from sahs_tpu.ops.pallas import field_mlp as jfm
from sahs_tpu.train import fused as jfused
from sahs_tpu.train import stage1 as jstage1

import torch

from sahs_tpu_torch.config import Config as TConfig
from sahs_tpu_torch.models import nerface as tn
from sahs_tpu_torch.tools import sigma_head
from sahs_tpu_torch.train import fused as tfused
from sahs_tpu_torch.train import stage1 as tstage1
from sahs_tpu_torch.utils.weights import grads_to_jax

from torch_fallback_util import (OUT_RTOL, _n, assert_metrics_close,
                                 assert_render_close, assert_step_grads_close,
                                 jax_draws, jax_step, port_state, tiny_cfg)
from torch_skip_util import GRID_FREE, MODELS, model_cfg, model_setup, render_both

torch.set_num_threads(2)


class KernelCalls:
    """Counts, in ``n``, the calls of every kernel wrapper that a train or
    render path can reach, where the path looks it up (the plain versions
    run inside on the CPU)."""

    def __init__(self, monkeypatch):
        from sahs_tpu_torch.ops.kernels import deform_pair as k1
        from sahs_tpu_torch.ops.kernels import field_grid
        from sahs_tpu_torch.ops.kernels import grid_bwd as k4
        from sahs_tpu_torch.ops.kernels import level_train as k2
        from sahs_tpu_torch.ops.kernels import skip_mlp as k13
        sites = {"K1": [(k1, "deform_pair_forward"), (tfused, "deform_pair_forward")],
                 "K2": [(k2, "nerf_level_train")],
                 "K3": [(k1, "deform_pair_vjp"), (tfused, "deform_pair_vjp")],
                 "K4": [(tfused, "grid_dg")],
                 "K5": [(field_grid, "nerf_level_forward")],
                 "K6": [(field_grid, "nerf_level_vjp")],
                 "K7": [(field_grid, "nerf_rayd_forward")],
                 "K8": [(field_grid, "nerf_rayd_vjp")],
                 "K9": [(field_grid, "grid_dg_coords")],
                 "K10": [(k4, "grid_bwd_fused")],
                 "K11": [(field_grid, "nerf_mlp_forward_fused")],
                 "K12": [(field_grid, "nerf_mlp_vjp")],
                 "K13": [(k13, "skip_mlp_forward")],
                 "K14": [(k13, "skip_mlp_vjp")],
                 "K15": [(tfused, "build_pts")]}
        self.n = {k: 0 for k in sites}
        for key, where in sites.items():
            for module, name in where:
                monkeypatch.setattr(module, name, self._wrap(key, getattr(module, name)))

    def _wrap(self, key, orig):
        def run(*a, **k):
            self.n[key] += 1
            return orig(*a, **k)
        return run

    def called(self):
        return {k: v for k, v in self.n.items() if v}


@pytest.fixture(scope="module")
def setups():
    return {kind: model_setup(kind) for kind in GRID_FREE}


# ---------------------------------------------------------------------------
# (a) the render
# ---------------------------------------------------------------------------

# (coarse, fine, fuse_composite) -> the kernels a render calls
RENDERS = {(8, 8, True): {"K1": 2, "K5": 2},
           (8, 8, False): {"K1": 2, "K7": 2},
           (8, 12, True): {"K1": 2, "K5": 1, "K11": 1}}


@pytest.mark.parametrize("Sc,Sn,fuse", sorted(RENDERS))
def test_grid_free_render_matches_jax_kernel_path(setups, monkeypatch, Sc, Sn,
                                                  fuse):
    """render_rays of the grid-free model on the port's kernel path against
    JAX's kernel path (use_pallas on), the same weights: no corner rows,
    no grid sample, no dGrid kernel."""
    _, item, state = setups["grid_free"]
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    calls = KernelCalls(monkeypatch)
    out_t, out_j = render_both("grid_free", state.params, item, Sc, Sn, fuse,
                               jax_pallas=True)
    assert calls.called() == RENDERS[(Sc, Sn, fuse)]
    assert_render_close(out_t, out_j)


# ---------------------------------------------------------------------------
# (b) the train steps
# ---------------------------------------------------------------------------

# path -> (runtime settings, fine samples, the kernels a step calls)
STEPS = {
    "fused": ({}, 8, {"K1": 2, "K2": 2, "K3": 1, "K15": 2}),
    "fallback": ({"fused_grads": False}, 8,
                 {"K1": 2, "K3": 2, "K5": 2, "K6": 2}),
    "reuse": ({"fused_grads": False, "fuse_composite": False}, 8,
              {"K1": 2, "K3": 2, "K7": 2, "K8": 2}),
    "per_point": ({}, 12, {"K1": 2, "K3": 2, "K5": 1, "K6": 1, "K11": 1,
                           "K12": 1}),
}


@pytest.mark.parametrize("path", sorted(STEPS))
def test_grid_free_train_step_matches_jax(setups, monkeypatch, path):
    """One port train_step of the grid-free model (SGD 1.0, the same
    draws) against the JAX train_step on the same path: metrics,
    sample_prob, every gradient leaf; the kernels it called, K4, K9 and
    K10 never."""
    runtime, Sn, want = STEPS[path]
    _, item, state = setups["grid_free"]
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    key = jax.random.PRNGKey(23)
    cfg = model_cfg("grid_free", num_fine=Sn, **runtime)
    m_j, g_j, st_j = jax_step(cfg, state, item, key)
    spec_j = jn.ModelSpec.from_config(cfg)
    ts_j = jstage1.TrainSettings.from_config(cfg)
    fused = path == "fused"
    assert (ts_j.fused_grads and jfused.stage1_fused_eligible(spec_j, ts_j.render)) == fused
    spec, ts, st = port_state(model_cfg("grid_free", TConfig, num_fine=Sn,
                                        **runtime), state.params)
    assert not spec.use_spatial_embeddings and ts.render.use_pallas
    assert (ts.fused_grads and tfused.stage1_fused_eligible(spec, ts.render)) == fused
    calls = KernelCalls(monkeypatch)
    st, m_t = tstage1.make_train_step(spec, ts, device="cpu")(
        st, item, draws=jax_draws(key, 32, 32, 48, 8, Sn))
    assert calls.called() == want
    assert_metrics_close(m_t, m_j)
    np.testing.assert_allclose(_n(st.sample_prob), np.asarray(st_j.sample_prob),
                               rtol=OUT_RTOL)
    g_t, g_j = grads_to_jax(st.model), g_j["model"]
    assert "spatial_embeddings" not in g_t and "spatial_embeddings" not in g_j
    assert_step_grads_close(g_t, g_j)


# ---------------------------------------------------------------------------
# (c) the fused path's predicate
# ---------------------------------------------------------------------------

def test_stage1_fused_eligible_matches_jax():
    """The port's stage1_fused_eligible equals the JAX package's for every
    model of the tests (with and without the grid, one net or two, no view
    directions) and every combination of use_pallas, fuse_composite,
    white_background and sample counts (tiling the level kernels or not,
    no fine level)."""
    def cfg_of(kind, cls, Sn):
        if kind == "flagship":
            cfg = tiny_cfg(cls)
            cfg.nerf.train.num_fine = Sn
            return cfg
        return model_cfg(kind, cls, num_fine=Sn)

    taken = []
    for kind, pallas, fuse, white, Sc, Sn in itertools.product(
            ["flagship"] + sorted(MODELS) + sorted(GRID_FREE), (True, False),
            (True, False), (False, True), (8, 12), (0, 8, 12)):
        got = []
        for cls, ModelSpec, TrainSettings, eligible in (
                (Config, jn.ModelSpec, jstage1.TrainSettings,
                 jfused.stage1_fused_eligible),
                (TConfig, tn.ModelSpec, tstage1.TrainSettings,
                 tfused.stage1_fused_eligible)):
            cfg = cfg_of(kind, cls, Sn)
            cfg.nerf.train.num_coarse = Sc
            cfg.nerf.train.white_background = white
            cfg.runtime.use_pallas = pallas
            cfg.runtime.fuse_composite = fuse
            got.append(bool(eligible(ModelSpec.from_config(cfg),
                                     TrainSettings.from_config(cfg).render)))
        assert got[0] == got[1], (kind, pallas, fuse, white, Sc, Sn, got)
        if got[0]:
            taken.append(kind)
    # the pair's models at 8 + 8 on the kernel path, composited in the kernel
    assert sorted(taken) == ["flagship", "grid_free"], taken


# ---------------------------------------------------------------------------
# (d) a grid-free warp-only model
# ---------------------------------------------------------------------------

def test_grid_free_warp_only_render_and_step_match_jax_plain_path(setups,
                                                                 monkeypatch):
    """The grid-free warp-only model on the port's kernel path (its warp
    net on K13 and K14, the level on K5/K6 with C = 0) against the JAX
    plain path, the same weights: the render (8 + 8, composited in the
    kernel) and one train step (the fallback), leaf by leaf."""
    _, item, state = setups["grid_free_warp_only"]
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    calls = KernelCalls(monkeypatch)
    out_t, out_j = render_both("grid_free_warp_only", state.params, item, 8, 8,
                               True, jax_pallas=False)
    assert calls.called() == {"K13": 2, "K5": 2}
    assert_render_close(out_t, out_j)
    key = jax.random.PRNGKey(29)
    m_j, g_j, st_j = jax_step(model_cfg("grid_free_warp_only", use_pallas=False),
                              state, item, key)
    spec, ts, st = port_state(model_cfg("grid_free_warp_only", TConfig),
                              state.params)
    assert not tfused.stage1_fused_eligible(spec, ts.render)
    calls.n = dict.fromkeys(calls.n, 0)
    st, m_t = tstage1.make_train_step(spec, ts, device="cpu")(
        st, item, draws=jax_draws(key, 32, 32, 48, 8, 8))
    assert calls.called() == {"K13": 2, "K14": 2, "K5": 2, "K6": 2}
    assert_metrics_close(m_t, m_j)
    assert_step_grads_close(grads_to_jax(st.model), g_j["model"])


# ---------------------------------------------------------------------------
# (e) the level of the card test of K2 without a background
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute_dtype,gate", [("float32", 1e-4),
                                                ("bfloat16", 5e-2)])
def test_varied_level_conditions_the_sigma_head(compute_dtype, gate):
    """Without a background sigma's gradient is a difference of a ray's
    colours; at the seeded init they agree along a ray to 0.2 % and that
    gradient is rounding in bfloat16. The level whose colours vary
    (tools/sigma_head.py; tests/test_torch_cuda.py:grid_free_varied) keeps
    the plain version's sigma head within ``gate`` of a float64 run, so
    the card test can hold K2 there at the gates."""
    row = sigma_head.case("varied", False, 1, compute_dtype, torch.device("cpu"))
    assert row["head_plain_vs_float64"] <= gate, row
    assert row["logit_spread_along_ray"] >= 0.2 * row["logit_mean_abs"], row
