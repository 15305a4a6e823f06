"""The per-point branch and the plain-path train step against the JAX
package (float32, Pallas in interpret mode; the port's kernels as their
plain versions on the CPU):

  (a) render_rays and the train step at sample counts the level kernels do
      not take, the JAX dispatch kept (nerface.py:442-460): 12 + 12 (both
      levels per point: the grid sample, then K11; K12 and K10 in the
      backward) and 8 + 12 (the coarse level on K5/K6, the fine level's 20
      per point), with fuse_composite on and off (off: the fine level
      reuses the coarse points' front half, per point too);
  (b) configs/expression/person_1_ablation.yml (no deformation: the points
      go to the grid sample and to K11 as they are) at 12 + 12;
  (c) the plain path's train step (use_pallas off: autograd of the plain
      modules, K10 in float32 for the grid sample).

Tolerances: the render as tests/test_torch_render.py holds it (1e-4
absolute, disparity and depth 1e-3 relative); a step's metrics within 3e-5
relative and its gradients leaf by leaf within 5e-2 L2-relative and 0.998
cosine (tests/test_torch_fallback_steps.py gives the reason).
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sahs_tpu.config import load_config
from sahs_tpu.data.synthetic import SyntheticFaceDataset
from sahs_tpu.models import nerface as jn
from sahs_tpu.ops.pallas import field_mlp as jfm
from sahs_tpu.ops.rays import get_rays_at
from sahs_tpu.render import pipeline as jpipe
from sahs_tpu.train import stage1 as jstage1

from sahs_tpu_torch.config import Config as TConfig
from sahs_tpu_torch.config import load_config as tload_config
from sahs_tpu_torch.models import nerface as tn
from sahs_tpu_torch.ops.kernels import field_grid as tfg
from sahs_tpu_torch.render import pipeline as tpipe
from sahs_tpu_torch.train import fused as tfused
from sahs_tpu_torch.train import stage1 as tstage1
from sahs_tpu_torch.utils.weights import grads_to_jax

from torch_fallback_util import (OUT_RTOL, _n, _t, assert_metrics_close,
                                 assert_render_close, assert_step_grads_close,
                                 audio_setup, jax_draws, jax_step, live_sigma,
                                 port_state, tiny_cfg)

torch.set_num_threads(2)

ABLATION = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "expression", "person_1_ablation.yml")
# (coarse, fine, fuse_composite)
COUNTS = [(12, 12, True), (8, 12, True), (12, 12, False), (8, 12, False)]

audio = pytest.fixture(scope="module")(audio_setup)


@pytest.fixture(scope="module")
def ablation():
    cfg = load_config(ABLATION)
    spec = jn.ModelSpec.from_config(cfg)
    assert not (spec.use_warp or spec.use_ambient)
    ts = jstage1.TrainSettings.from_config(cfg)
    ds = SyntheticFaceDataset(kind="expression", num_frames=1, H=32, W=32,
                              near=cfg.dataset.near, far=cfg.dataset.far)
    item = dict(ds[0])
    item["background"] = ds.background()
    state = jstage1.init_train_state(jax.random.PRNGKey(1), spec, ts)
    state = state._replace(params=live_sigma(state.params))
    return item, state


def _sized(cfg, Sc, Sn, **runtime):
    """cfg at 48 rays, Sc + Sn samples, float32, with ``runtime`` set."""
    cfg.nerf.train.num_random_rays = 48
    cfg.nerf.train.num_coarse = Sc
    cfg.nerf.train.num_fine = Sn
    cfg.runtime.compute_dtype = "float32"
    for k, v in runtime.items():
        setattr(cfg.runtime, k, v)
    return cfg


class _Launches:
    """Counts the per-point op's and the level ops' calls in a render."""

    def __init__(self, monkeypatch):
        self.n = {"point": 0, "level": 0, "rayd": 0}
        for key, name in (("point", "nerf_mlp_apply_fused"),
                          ("level", "nerf_render_level_grid"),
                          ("rayd", "nerf_mlp_apply_rayd_grid")):
            orig = getattr(tfg, name)
            monkeypatch.setattr(tfg, name, self._wrap(key, orig))

    def _wrap(self, key, orig):
        def run(*a, **k):
            self.n[key] += 1
            return orig(*a, **k)
        return run


def _render_both(cfg, jparams, tcfg, item, Sc, Sn, fuse, R=24, seed=2):
    spec = jn.ModelSpec.from_config(cfg)
    idx = np.random.RandomState(seed).choice(32 * 32, R, replace=False)
    ro, rd = get_rays_at(jnp.asarray(idx), 32, 32, jnp.asarray(item["intrinsics"]),
                         jnp.asarray(item["pose"]))
    bg = item["background"].reshape(-1, 15)[idx]
    kw = dict(num_coarse=Sc, num_fine=Sn, perturb=False, use_pallas=True,
              compute_dtype="float32", fuse_composite=fuse)
    out_j = jpipe.render_rays(jparams["model"], spec, jpipe.RenderSettings(**kw),
                              ro, rd, cfg.dataset.near, cfg.dataset.far,
                              jnp.asarray(item["driving"]),
                              jnp.asarray(item["pose"]),
                              background_prior=jnp.asarray(bg))
    _, _, st = port_state(tcfg, jparams)
    out_t = tpipe.render_rays(st.model, tpipe.RenderSettings(**kw), _t(ro), _t(rd),
                              cfg.dataset.near, cfg.dataset.far,
                              _t(item["driving"]), _t(item["pose"]),
                              background_prior=_t(bg))
    return out_t, out_j


# ---------------------------------------------------------------------------
# (a) the flagship model at non-tiling sample counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Sc,Sn,fuse", COUNTS)
def test_pointwise_render_matches_jax(audio, monkeypatch, Sc, Sn, fuse):
    """render_rays at Sc + Sn samples: each level whose count does not tile
    the level kernels on the per-point branch, as JAX dispatches it."""
    cfg, item, state = audio
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    calls = _Launches(monkeypatch)
    out_t, out_j = _render_both(_sized(tiny_cfg(), Sc, Sn, fuse_composite=fuse),
                                state.params,
                                _sized(tiny_cfg(TConfig), Sc, Sn,
                                       fuse_composite=fuse),
                                item, Sc, Sn, fuse)
    coarse_point = not tn.level_kernel_compatible(Sc)
    assert not tn.level_kernel_compatible(Sc + Sn)
    want_point = 1 + int(coarse_point)
    assert calls.n == {"point": want_point,
                       "level": int(fuse and not coarse_point),
                       "rayd": int(not fuse and not coarse_point)}, calls.n
    assert_render_close(out_t, out_j)


@pytest.mark.parametrize("Sc,Sn,fuse", COUNTS)
def test_pointwise_train_step_matches_jax(audio, monkeypatch, Sc, Sn, fuse):
    """One port train_step at Sc + Sn samples (outside the fused path: the
    fallback, with the per-point branch at each non-tiling level) vs the
    JAX train_step, SGD(1.0), the same draws: metrics, sample_prob, every
    gradient leaf."""
    cfg, item, state = audio
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    key = jax.random.PRNGKey(13)
    m_j, g_j, st_j = jax_step(_sized(tiny_cfg(), Sc, Sn, fuse_composite=fuse),
                              state, item, key)
    spec, ts, st = port_state(_sized(tiny_cfg(TConfig), Sc, Sn,
                                     fuse_composite=fuse), state.params)
    assert ts.fused_grads and not tfused.stage1_fused_eligible(spec, ts.render)
    st, m_t = tstage1.make_train_step(spec, ts, device="cpu")(
        st, item, draws=jax_draws(key, 32, 32, 48, Sc, Sn))
    assert_metrics_close(m_t, m_j)
    np.testing.assert_allclose(_n(st.sample_prob), np.asarray(st_j.sample_prob),
                               rtol=OUT_RTOL)
    assert_step_grads_close(grads_to_jax(st.model), g_j["model"])


# ---------------------------------------------------------------------------
# (b) the ablation config
# ---------------------------------------------------------------------------

def test_ablation_pointwise_render_matches_jax(ablation, monkeypatch):
    """The ablation config at 12 + 12: the points themselves go to the grid
    sample and to K11 at both levels."""
    item, state = ablation
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    calls = _Launches(monkeypatch)
    out_t, out_j = _render_both(_sized(load_config(ABLATION), 12, 12),
                                state.params,
                                _sized(tload_config(ABLATION), 12, 12),
                                item, 12, 12, True, seed=4)
    assert calls.n == {"point": 2, "level": 0, "rayd": 0}
    assert_render_close(out_t, out_j)


def test_ablation_pointwise_train_step_matches_jax(ablation, monkeypatch):
    """One train step of the ablation config at 12 + 12 vs JAX's."""
    item, state = ablation
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    key = jax.random.PRNGKey(3)
    m_j, g_j, st_j = jax_step(_sized(load_config(ABLATION), 12, 12), state,
                              item, key)
    spec, ts, st = port_state(_sized(tload_config(ABLATION), 12, 12),
                              state.params)
    st, m_t = tstage1.make_train_step(spec, ts, device="cpu")(
        st, item, draws=jax_draws(key, 32, 32, 48, 12, 12))
    assert_metrics_close(m_t, m_j)
    assert st.model.warp is None and st.model.hyper is None
    assert_step_grads_close(grads_to_jax(st.model), g_j["model"])


# ---------------------------------------------------------------------------
# (c) the plain path's train step
# ---------------------------------------------------------------------------

def test_plain_path_train_step_matches_jax(audio, monkeypatch):
    """use_pallas off: one port train_step (autograd of the plain modules,
    the grid sample's backward K10 in float32) vs the JAX train_step on its
    plain path, 8 + 8 samples: metrics, sample_prob, every gradient leaf."""
    cfg, item, state = audio
    key = jax.random.PRNGKey(17)
    m_j, g_j, st_j = jax_step(tiny_cfg(use_pallas=False), state, item, key)
    spec, ts, st = port_state(tiny_cfg(TConfig, use_pallas=False), state.params)
    assert not ts.render.use_pallas
    from sahs_tpu_torch.ops.kernels import grid_bwd as k10
    calls = []
    orig = k10.grid_bwd_fused
    monkeypatch.setattr(k10, "grid_bwd_fused",
                        lambda *a, **k: calls.append(a[-1] if len(a) > 4 else
                                                     k.get("compute_dtype"))
                        or orig(*a, **k))
    st, m_t = tstage1.make_train_step(spec, ts, device="cpu")(
        st, item, draws=jax_draws(key, 32, 32, 48, 8, 8))
    assert calls == ["float32", "float32"]       # one grid sample a level
    assert_metrics_close(m_t, m_j)
    np.testing.assert_allclose(_n(st.sample_prob), np.asarray(st_j.sample_prob),
                               rtol=OUT_RTOL)
    assert_step_grads_close(grads_to_jax(st.model), g_j["model"])
