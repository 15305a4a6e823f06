"""The autograd fallback's train step against the JAX package
(float32, Pallas in interpret mode; the port's kernels as their plain
versions on the CPU), and the port's fused step against its own fallback:

  (a) train_step with fused_grads off vs the JAX train_step (K5/K6, K9,
      K1/K3 through autograd)
  (b) the fused step vs the fallback step, the same draws (the port's
      tests/test_fused_train.py::test_fused_grads_match_autodiff)
  (c) folded weights are rebuilt after an optimizer step

Tolerances: outputs within 3e-5 relative; a whole step's gradients leaf by
leaf (each weight and each bias) within 5e-2 L2-relative and 0.998 cosine,
tests/test_torch_train.py's gate and ROADMAP's fused-vs-autograd ceiling:
the two sides round K1's outputs differently and a PE of frequency up to
2^9 turns one rounding step of a point into flipped ReLUs. The port's fused
and fallback steps run the same plain versions and differ only in the
order of their sums (the coarse cotangents scattered into the fine pass,
against one pass per level): within rtol 5e-3 and 1e-3 of each leaf's
largest entry, the kernel gate of tests/test_torch_train.py.
"""
import numpy as np
import pytest

import jax
import torch

from sahs_tpu.ops.pallas import field_mlp as jfm

from sahs_tpu_torch.config import Config as TConfig
from sahs_tpu_torch.models import nerface as tn
from sahs_tpu_torch.train import fused as tfused
from sahs_tpu_torch.train import stage1 as tstage1
from sahs_tpu_torch.utils.weights import grads_to_jax

from torch_fallback_util import (G_RTOL, G_SCALE, OUT_RTOL, _n, _pairs, _t,
                                 assert_metrics_close,
                                 assert_step_grads_close, audio_setup, jax_draws,
                                 jax_step, port_state, tiny_cfg)

torch.set_num_threads(2)

audio = pytest.fixture(scope="module")(audio_setup)


# ---------------------------------------------------------------------------
# (a), (b): whole steps
# ---------------------------------------------------------------------------

def test_fallback_train_step_matches_jax(audio, monkeypatch):
    """fused_grads off, fuse_composite on: one port train_step (K1, K5,
    then K6, K9, K3 through autograd) vs the JAX train_step's fallback,
    SGD(1.0), the same draws: metrics, sample_prob, every gradient leaf."""
    cfg, item, state = audio
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    key = jax.random.PRNGKey(7)
    m_j, g_j, st_j = jax_step(cfg, state, item, key)
    tcfg = tiny_cfg(TConfig, fused_grads=False)
    spec, ts, st = port_state(tcfg, state.params)
    assert not tfused.stage1_fused_eligible(spec, ts.render) or not ts.fused_grads
    st, m_t = tstage1.make_train_step(spec, ts, device="cpu")(
        st, item, draws=jax_draws(key, 32, 32, 48, 8, 8))
    assert_metrics_close(m_t, m_j)
    np.testing.assert_allclose(_n(st.sample_prob), np.asarray(st_j.sample_prob),
                               rtol=OUT_RTOL)
    assert_step_grads_close(grads_to_jax(st.model), g_j["model"])


def test_fused_step_matches_fallback_step(audio):
    """The port's fused step (K2, K3, K4) against its fallback step (K5/K6,
    K9, K3 through autograd), the same weights and draws: the loss and
    every gradient leaf."""
    cfg, item, state = audio
    draws = jax_draws(jax.random.PRNGKey(9), 32, 32, 48, 8, 8)
    res = {}
    for fused in (True, False):
        tcfg = tiny_cfg(TConfig, fused_grads=fused)
        spec, ts, st = port_state(tcfg, state.params)
        assert tfused.stage1_fused_eligible(spec, ts.render)
        st, m = tstage1.make_train_step(spec, ts, device="cpu")(st, item,
                                                               draws=draws)
        res[fused] = (m, grads_to_jax(st.model))
    np.testing.assert_allclose(float(res[True][0]["loss"]),
                               float(res[False][0]["loss"]), rtol=1e-5)
    for path, x, y in _pairs(res[True][1], res[False][1]):
        np.testing.assert_allclose(x, y, rtol=G_RTOL,
                                   atol=G_SCALE * np.abs(y).max(initial=0.0),
                                   err_msg=path)


# ---------------------------------------------------------------------------
# (c) folded weights after an optimizer step
# ---------------------------------------------------------------------------

def test_folded_weights_follow_optimizer_steps():
    """Evaluators built once give, after an optimizer step, what evaluators
    built anew give: the folded weights and the corner table are rebuilt
    when their parameters change in place."""
    tcfg = tiny_cfg(TConfig)
    spec = tn.ModelSpec.from_config(tcfg)
    model = tn.NeRFaceModel.init(spec, seed=0, device="cpu")
    rng = np.random.RandomState(3)
    audio, pose = _t(rng.randn(16, 29).astype(np.float32)), _t(np.eye(4)[:3])
    ro = torch.zeros((8, 3))
    rd = _t((rng.randn(8, 3) * 0.05 + [0, 0, -1]).astype(np.float32))
    z = torch.linspace(0.5, 1.0, 8).expand(8, 8).contiguous()
    pts = (ro[:, None] + rd[:, None] * z[..., None]).reshape(-1, 3)
    with torch.no_grad():
        fns = tn.make_render_fns(model, audio, pose, use_pallas=True,
                                 compute_dtype="float32")
        before = fns.level_fn("coarse", pts, rd, 8, z, None, None)[0]
    # the level and the grid change; AudioNet, whose output the evaluators
    # take once per frame, does not
    stepped = list(model.coarse.parameters()) + [model.spatial_embeddings]
    opt = torch.optim.SGD(stepped, lr=1.0)
    for p in stepped:
        p.grad = torch.full_like(p, 1e-2)
    opt.step()
    with torch.no_grad():
        again = fns.level_fn("coarse", pts, rd, 8, z, None, None)[0]
        fresh = tn.make_render_fns(model, audio, pose, use_pallas=True,
                                   compute_dtype="float32").level_fn(
            "coarse", pts, rd, 8, z, None, None)[0]
    assert not torch.equal(before, fresh)
    torch.testing.assert_close(again, fresh, rtol=0, atol=0)
