"""Two configurations the autograd fallback carries, against the JAX
package (float32, Pallas in interpret mode; the port's kernels as their
plain versions on the CPU):

  (a) configs/expression/person_1_ablation.yml: the canonical NeRF with no
      warp and no hyper-sheet (a 4 x 256 trunk, 15 PE frequencies), which
      JAX trains only through the fallback: K5/K6 with corner rows from
      _cell_geometry and K9, no K1 or K3; its render and one train step
  (b) active latent codes (tests/test_fused_train.py::
      test_fused_latent_codes_match_autodiff's setup): the code rides the
      levels' conditioning; the port's fused step and its fallback step
      against the JAX step, the latent table's gradient included

Tolerances: the render as tests/test_torch_render.py holds it (1e-4
absolute, disparity and depth 1e-3 relative); a step's metrics within 3e-5
relative and its gradients leaf by leaf within 5e-2 L2-relative and 0.998
cosine (tests/test_torch_fallback_steps.py gives the reason); the latent
table's gradient the same way.
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
from sahs_tpu_torch.render import pipeline as tpipe
from sahs_tpu_torch.train import fused as tfused
from sahs_tpu_torch.train import stage1 as tstage1
from sahs_tpu_torch.utils.weights import grads_to_jax

from torch_fallback_util import (OUT_RTOL, _n, _t, assert_metrics_close,
                                 assert_render_close,
                                 assert_step_grads_close, jax_draws, jax_step,
                                 live_sigma, port_state, tiny_cfg)

torch.set_num_threads(2)

ABLATION = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "expression", "person_1_ablation.yml")


def _tiny(cfg):
    cfg.nerf.train.num_random_rays = 48
    cfg.nerf.train.num_coarse = 8
    cfg.nerf.train.num_fine = 8
    cfg.runtime.compute_dtype = "float32"
    return cfg


@pytest.fixture(scope="module")
def ablation():
    cfg = _tiny(load_config(ABLATION))
    spec = jn.ModelSpec.from_config(cfg)
    assert not (spec.use_warp or spec.use_ambient) and cfg.runtime.use_pallas
    assert spec.coarse.num_layers == 4 and spec.num_encoding_fn_xyz == 15
    ts = jstage1.TrainSettings.from_config(cfg)
    ds = SyntheticFaceDataset(kind="expression", num_frames=1, H=32, W=32,
                              near=cfg.dataset.near, far=cfg.dataset.far)
    item = dict(ds[0])
    item["background"] = ds.background()
    state = jstage1.init_train_state(jax.random.PRNGKey(1), spec, ts)
    state = state._replace(params=live_sigma(state.params))
    return cfg, item, state


def test_ablation_config_render_matches_jax(ablation, monkeypatch):
    """The ablation config's render on the kernel path (K5 with rows from
    _cell_geometry at 15 PE frequencies, no deformation) vs JAX."""
    cfg, item, state = ablation
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    spec = jn.ModelSpec.from_config(cfg)
    R = 32
    idx = np.random.RandomState(4).choice(32 * 32, R, replace=False)
    ro, rd = get_rays_at(jnp.asarray(idx), 32, 32, jnp.asarray(item["intrinsics"]),
                         jnp.asarray(item["pose"]))
    bg = item["background"].reshape(-1, 15)[idx]
    js = jpipe.RenderSettings(num_coarse=8, num_fine=8, perturb=False,
                              use_pallas=True, compute_dtype="float32")
    out_j = jpipe.render_rays(state.params["model"], spec, js, ro, rd,
                              cfg.dataset.near, cfg.dataset.far,
                              jnp.asarray(item["driving"]),
                              jnp.asarray(item["pose"]),
                              background_prior=jnp.asarray(bg))
    tcfg = _tiny(tload_config(ABLATION))
    _, _, st = port_state(tcfg, state.params)
    ts_ = tpipe.RenderSettings(num_coarse=8, num_fine=8, perturb=False,
                               use_pallas=True, compute_dtype="float32")
    out_t = tpipe.render_rays(st.model, ts_, _t(ro), _t(rd), cfg.dataset.near,
                              cfg.dataset.far, _t(item["driving"]),
                              _t(item["pose"]), background_prior=_t(bg))
    assert_render_close(out_t, out_j)


def test_ablation_config_train_step_matches_jax(ablation, monkeypatch):
    """One train step of the ablation config (the fallback: K5, then K6 and
    K9 through autograd; no K1, no K3) vs the JAX train_step."""
    cfg, item, state = ablation
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    key = jax.random.PRNGKey(3)
    m_j, g_j, st_j = jax_step(cfg, state, item, key)
    tcfg = _tiny(tload_config(ABLATION))
    spec, ts, st = port_state(tcfg, state.params)
    assert not tfused.stage1_fused_eligible(spec, ts.render)
    st, m_t = tstage1.make_train_step(spec, ts, device="cpu")(
        st, item, draws=jax_draws(key, 32, 32, 48, 8, 8))
    assert_metrics_close(m_t, m_j)
    np.testing.assert_allclose(_n(st.sample_prob), np.asarray(st_j.sample_prob),
                               rtol=OUT_RTOL)
    assert st.model.warp is None and st.model.hyper is None
    assert_step_grads_close(grads_to_jax(st.model), g_j["model"])


@pytest.mark.parametrize("fused_grads", [True, False])
def test_latent_code_steps_match_jax(monkeypatch, fused_grads):
    """Active latent codes (frame 1 of 2, nonzero codes, the norm
    regularizer on): the port's fused step and its fallback step against
    the JAX step, every gradient leaf and the latent table's."""
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    rt = dict(train_latent_codes=True, disable_latent_codes=False,
              regularize_latent_codes=True)
    cfg = tiny_cfg(**rt)
    cfg.models.mask.latent_code_dim = 32
    spec = jn.ModelSpec.from_config(cfg)
    ts = jstage1.TrainSettings.from_config(cfg)
    ds = SyntheticFaceDataset(kind="audio", num_frames=2, H=32, W=32,
                              near=cfg.dataset.near, far=cfg.dataset.far)
    item = dict(ds[1])
    item["background"] = ds.background()
    state = jstage1.init_train_state(jax.random.PRNGKey(0), spec, ts,
                                     num_latent_frames=2)
    params = live_sigma(state.params)
    params["latent_codes"] = 0.1 * jax.random.normal(
        jax.random.PRNGKey(5), params["latent_codes"].shape)
    state = state._replace(params=params)
    key = jax.random.PRNGKey(11)
    m_j, g_j, _ = jax_step(cfg, state, item, key)

    tcfg = tiny_cfg(TConfig, fused_grads=fused_grads, **rt)
    tcfg.models.mask.latent_code_dim = 32
    spec_t, ts_t, st = port_state(tcfg, state.params, num_latent_frames=2)
    assert tfused.stage1_fused_eligible(spec_t, ts_t.render)
    st, m_t = tstage1.make_train_step(spec_t, ts_t, device="cpu")(
        st, item, draws=jax_draws(key, 32, 32, 48, 8, 8))
    assert_metrics_close(m_t, m_j)
    g_t = grads_to_jax(st.model, latent_codes=st.latent_codes)
    assert np.abs(g_t["latent_codes"][1]).max() > 0
    assert not np.abs(g_t["latent_codes"][0]).any()
    assert_step_grads_close(g_t, {"model": g_j["model"],
                                  "latent_codes": g_j["latent_codes"]})
