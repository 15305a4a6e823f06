"""The deformation-reuse path (fuse_composite off: K1 on the coarse and
on the importance points, K7 on their concatenation, K8 in the backward)
against the JAX package, float32, Pallas in interpret mode:

  (a) render_rays vs JAX render_rays, with importance samples that tie
      coarse ones: the same stable sort order as jnp.argsort
  (b) the train step vs the JAX train_step on that path

Tolerances: the render as tests/test_torch_render.py holds it (1e-4
absolute, disparity and depth 1e-3 relative); a step's metrics within 3e-5
relative, its gradients leaf by leaf within 5e-2 L2-relative and 0.998
cosine (tests/test_torch_fallback_steps.py gives the reason).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sahs_tpu.models import nerface as jn
from sahs_tpu.ops.pallas import field_mlp as jfm
from sahs_tpu.ops.rays import get_rays_at
from sahs_tpu.render import pipeline as jpipe

from sahs_tpu_torch.config import Config as TConfig
from sahs_tpu_torch.render import pipeline as tpipe
from sahs_tpu_torch.train import fused as tfused
from sahs_tpu_torch.train import stage1 as tstage1
from sahs_tpu_torch.utils.weights import grads_to_jax

from torch_fallback_util import (OUT_RTOL, _n, _t, assert_metrics_close,
                                 assert_render_close,
                                 assert_step_grads_close, audio_setup, jax_draws,
                                 jax_step, port_state, tiny_cfg)

torch.set_num_threads(2)

audio = pytest.fixture(scope="module")(audio_setup)


# ---------------------------------------------------------------------------
# (a) the render, (b) the train step
# ---------------------------------------------------------------------------

def test_render_rays_reuse_path_matches_jax(audio, monkeypatch):
    """fuse_composite off: K1 on the coarse and on the importance points,
    K7 on their concatenation, the raw samples sorted by z for the plain
    compositing. Importance samples that tie coarse ones exactly: the
    port's stable sort must order them as jnp.argsort does."""
    cfg, item, state = audio
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    spec = jn.ModelSpec.from_config(cfg)
    R, Sc, Sn = 24, 8, 8
    rng = np.random.RandomState(2)
    idx = rng.choice(32 * 32, R, replace=False)
    ro, rd = get_rays_at(jnp.asarray(idx), 32, 32, jnp.asarray(item["intrinsics"]),
                         jnp.asarray(item["pose"]))
    bg = item["background"].reshape(-1, 15)[idx]
    # importance samples: interior z, four of them equal to coarse z
    zc = np.asarray(jnp.linspace(cfg.dataset.near, cfg.dataset.far, Sc))
    zs = np.sort(rng.uniform(zc[1], zc[-2], (R, Sn)), axis=-1).astype(np.float32)
    zs[:, 1], zs[:, 5] = zc[2], zc[5]
    zs = np.sort(zs, axis=-1)
    fixed = lambda *a, **k: jnp.asarray(zs)
    monkeypatch.setattr(jpipe, "sample_pdf", fixed)
    monkeypatch.setattr(tpipe, "sample_pdf", lambda *a, **k: _t(zs))
    perms = []
    orig = tpipe.permute_samples
    monkeypatch.setattr(tpipe, "permute_samples",
                        lambda x, p: perms.append(p) or orig(x, p))
    js = jpipe.RenderSettings(num_coarse=Sc, num_fine=Sn, perturb=False,
                              use_pallas=True, compute_dtype="float32",
                              fuse_composite=False)
    out_j = jpipe.render_rays(state.params["model"], spec, js, ro, rd,
                              cfg.dataset.near, cfg.dataset.far,
                              jnp.asarray(item["driving"]),
                              jnp.asarray(item["pose"]),
                              background_prior=jnp.asarray(bg))
    tcfg = tiny_cfg(TConfig, fused_grads=False)
    _, _, st = port_state(tcfg, state.params)
    ts_ = tpipe.RenderSettings(num_coarse=Sc, num_fine=Sn, perturb=False,
                               use_pallas=True, compute_dtype="float32",
                               fuse_composite=False)
    out_t = tpipe.render_rays(st.model, ts_, _t(ro), _t(rd), cfg.dataset.near,
                              cfg.dataset.far, _t(item["driving"]),
                              _t(item["pose"]), background_prior=_t(bg))
    z_cat = np.concatenate([np.broadcast_to(zc, (R, Sc)), zs], axis=-1)
    assert len(perms) == 1
    np.testing.assert_array_equal(_n(perms[0]),
                                  np.asarray(jnp.argsort(jnp.asarray(z_cat), axis=-1)))
    assert (np.diff(np.sort(z_cat, axis=-1), axis=-1) == 0).sum(axis=-1).min() >= 2
    assert_render_close(out_t, out_j)


def test_reuse_train_step_matches_jax(audio, monkeypatch):
    """fused_grads off, fuse_composite off: one port train_step (K1 twice,
    K7 twice, then K8, K9 and K3 through autograd) vs the JAX train_step on
    the same path, SGD(1.0), the same draws: metrics, sample_prob, every
    gradient leaf."""
    cfg, item, state = audio
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    cfg = tiny_cfg(fused_grads=False, fuse_composite=False)
    key = jax.random.PRNGKey(8)
    m_j, g_j, st_j = jax_step(cfg, state, item, key)
    tcfg = tiny_cfg(TConfig, fused_grads=False, fuse_composite=False)
    spec, ts, st = port_state(tcfg, state.params)
    assert not tfused.stage1_fused_eligible(spec, ts.render)
    st, m_t = tstage1.make_train_step(spec, ts, device="cpu")(
        st, item, draws=jax_draws(key, 32, 32, 48, 8, 8))
    assert_metrics_close(m_t, m_j)
    np.testing.assert_allclose(_n(st.sample_prob), np.asarray(st_j.sample_prob),
                               rtol=OUT_RTOL)
    assert_step_grads_close(grads_to_jax(st.model), g_j["model"])
