"""One train step of each model whose deformation nets run one at a time,
and of the model without view directions, against the JAX train_step
(float32, Pallas in interpret mode; the port's kernels as their plain
versions on the CPU):

  - warp-only, ambient-only and split-conditioning: the port's kernel path
    (outside the fused path, so the autograd fallback: K13 forward and K14
    backward for each net, K5/K6 and K9) against JAX's plain path
    (use_pallas off): JAX's kernel path raises for the warp-only and split
    models and leaves out the ambient coordinates of the ambient-only one
    (tests/test_torch_skip_paths.py gives both);
  - no view directions: both sides with use_pallas on, which takes the
    plain path on both.

Tolerances: metrics within 3e-5 relative, every gradient leaf (AudioNet's
included) within 5e-2 L2-relative at a cosine of 0.998
(tests/test_torch_fallback_steps.py gives the reason).
"""
import numpy as np
import pytest

import jax
import torch

from sahs_tpu.ops.pallas import field_mlp as jfm

from sahs_tpu_torch.config import Config as TConfig
from sahs_tpu_torch.train import fused as tfused
from sahs_tpu_torch.train import stage1 as tstage1
from sahs_tpu_torch.utils.weights import grads_to_jax

from torch_fallback_util import (OUT_RTOL, _n, assert_metrics_close,
                                 assert_step_grads_close, jax_draws, jax_step,
                                 port_state)
from torch_skip_util import SkipCalls, model_cfg, model_setup

torch.set_num_threads(2)

# model -> (K13 and K14 calls a step, the JAX side's use_pallas)
STEPS = {"warp_only": (2, False), "ambient_only": (2, False),
         "split": (4, False), "no_viewdirs": (0, True)}


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_one_net_train_step_matches_jax(monkeypatch, kind):
    """One port train_step (SGD 1.0, the same draws) against the JAX
    train_step: metrics, sample_prob, every gradient leaf."""
    cfg, item, state = model_setup(kind)
    calls_per_step, jax_pallas = STEPS[kind]
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    calls = SkipCalls(monkeypatch)
    key = jax.random.PRNGKey(19)
    m_j, g_j, st_j = jax_step(model_cfg(kind, use_pallas=jax_pallas), state,
                              item, key)
    spec, ts, st = port_state(model_cfg(kind, TConfig), state.params)
    assert ts.render.use_pallas and not tfused.stage1_fused_eligible(spec, ts.render)
    st, m_t = tstage1.make_train_step(spec, ts, device="cpu")(
        st, item, draws=jax_draws(key, 32, 32, 48, 8, 8))
    assert calls.n == {"K13": calls_per_step, "K14": calls_per_step}, calls.n
    assert_metrics_close(m_t, m_j)
    np.testing.assert_allclose(_n(st.sample_prob), np.asarray(st_j.sample_prob),
                               rtol=OUT_RTOL)
    g_t, g_j = grads_to_jax(st.model), dict(g_j["model"])
    if kind == "no_viewdirs":
        # the grid feeds only the direction branch, which this model lacks
        assert not np.asarray(g_j.pop("spatial_embeddings")).any()
        assert not g_t.pop("spatial_embeddings").any()
    assert_step_grads_close(g_t, g_j)
