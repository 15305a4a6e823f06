"""The render paths of the models whose deformation nets run one at a time
(K13, and K14 in the backward), the model without view directions, K15 on
the fused step, and the weights of the one-net models, against the JAX
package (float32, Pallas in interpret mode; the port's kernels as their
plain versions on the CPU):

  (a) the warp-only, ambient-only and split-conditioning models' render on
      the kernel path, fuse_composite on and off and at 8 + 12 (the fine
      level on the per-point branch), against the JAX plain path: the JAX
      kernel path of a warp-only or split model raises (its 8-wide points
      meet K13's 3-wide warp, nerface.py:388), and that of an
      ambient-only model reads the points' zero padding where the
      ambient coordinates stand, which (d) shows;
  (b) a model without view directions on the kernel path takes the plain
      path, as JAX's does (nerface.py:299-314);
  (c) the fused step, whose positions K15 builds at both levels, equals
      the step with the PyTorch expression in K15's place bit for bit;
  (d) the JAX ambient-only kernel path's render equals its plain path's
      with the hyper head zeroed;
  (e) the warp-only and ambient-only parameter trees round-trip.

Tolerances: the render as tests/test_torch_render.py holds it (1e-4
absolute, disparity and depth 1e-3 relative).
"""
import numpy as np
import pytest

import jax
import torch

from sahs_tpu.models import nerface as jn
from sahs_tpu.ops.pallas import field_mlp as jfm

from sahs_tpu_torch.config import Config as TConfig
from sahs_tpu_torch.models import nerface as tn
from sahs_tpu_torch.ops.kernels import points as k15
from sahs_tpu_torch.train import fused as tfused
from sahs_tpu_torch.train import stage1 as tstage1
from sahs_tpu_torch.utils.weights import (grads_to_jax, params_from_jax,
                                          params_to_jax)

from torch_fallback_util import (_n, _pairs, assert_render_close, audio_setup,
                                 jax_draws, port_state, tiny_cfg)
from torch_skip_util import MODELS, SkipCalls, model_cfg, model_setup, render_both

torch.set_num_threads(2)

# (coarse, fine, fuse_composite)
COUNTS = [(8, 8, True), (8, 8, False), (8, 12, True)]


@pytest.fixture(scope="module")
def setups():
    return {kind: model_setup(kind) for kind in MODELS}


# ---------------------------------------------------------------------------
# (a) the one-net models' render
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["warp_only", "ambient_only", "split"])
@pytest.mark.parametrize("Sc,Sn,fuse", COUNTS)
def test_one_net_render_matches_jax_plain_path(setups, monkeypatch, kind, Sc,
                                               Sn, fuse):
    """render_rays of each one-net model on the port's kernel path (each
    deformation net on K13, x + dx in PyTorch, corner rows from
    _cell_geometry) against the JAX plain path, the same weights."""
    _, item, state = setups[kind]
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    calls = SkipCalls(monkeypatch)
    out_t, out_j = render_both(kind, state.params, item, Sc, Sn, fuse,
                               jax_pallas=False)
    nets = 2 if kind == "split" else 1
    # one front half a level (on the reuse path, the fine level's is that
    # of its importance points alone)
    assert calls.n == {"K13": 2 * nets, "K14": 0}, calls.n
    assert_render_close(out_t, out_j)


def test_jax_ambient_only_kernel_path_drops_the_ambient_coordinates(setups,
                                                                    monkeypatch):
    """Why (a) holds the ambient-only model against the JAX plain path: the
    JAX kernel path builds its points 8 wide and appends the hyper net's
    output after them, so the level kernels read the zero padding where
    the ambient coordinates should be. Its render equals the JAX plain
    path's with the hyper head zeroed, not the plain path's."""
    _, item, state = setups["ambient_only"]
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    params = jax.tree.map(np.asarray, state.params)
    rng = np.random.RandomState(5)
    out = params["model"]["hyper"]["out"]
    params["model"]["hyper"]["out"] = {
        "w": (rng.randn(*out["w"].shape) * 0.2).astype(np.float32),
        "b": (out["b"] + 0.1).astype(np.float32)}
    zeroed = jax.tree.map(lambda x: x, params)
    zeroed["model"]["hyper"]["out"] = jax.tree.map(np.zeros_like, out)
    port, kern = render_both("ambient_only", params, item, 8, 8, True, True)
    _, plain = render_both("ambient_only", params, item, 8, 8, True, False)
    _, plain0 = render_both("ambient_only", zeroed, item, 8, 8, True, False)
    rgb = lambda o: _n(o.rgb_fine)
    assert np.abs(rgb(kern) - rgb(plain0)).max() < 1e-5
    assert np.abs(rgb(kern) - rgb(plain)).max() > 1e-4
    assert np.abs(rgb(port) - rgb(plain)).max() < 1e-5


# ---------------------------------------------------------------------------
# (b) no view directions
# ---------------------------------------------------------------------------

def test_no_viewdirs_render_takes_the_plain_path(setups, monkeypatch):
    """A model without view directions, use_pallas on: the port takes the
    plain path, as JAX does; the two renders agree."""
    _, item, state = setups["no_viewdirs"]
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    spec = tn.ModelSpec.from_config(model_cfg("no_viewdirs", TConfig))
    assert not spec.use_viewdirs
    model = tn.NeRFaceModel.init(spec, seed=0, device="cpu")
    fns = tn.make_render_fns(model, torch.zeros(16, 29), torch.eye(4)[:3],
                             use_pallas=True)
    assert fns.level_fn is None and fns.front_fn is None
    out_t, out_j = render_both("no_viewdirs", state.params, item, 8, 8, True,
                               jax_pallas=True)
    assert_render_close(out_t, out_j)


# ---------------------------------------------------------------------------
# (c) K15 on the fused step
# ---------------------------------------------------------------------------

def test_fused_step_with_k15_equals_the_expression(monkeypatch):
    """The fused step (K15, its plain version on the CPU, builds both
    levels' positions) against the same step with the PyTorch expression
    ro + rd z written out in K15's place, the same weights and draws: K15
    called once a level, and the loss and every gradient leaf bit for
    bit."""
    cfg, item, state = audio_setup()
    draws = jax_draws(jax.random.PRNGKey(9), 32, 32, 48, 8, 8)
    calls = []
    orig = k15.build_pts
    expression = lambda ro, rd, z: (ro[:, None, :] + rd[:, None, :]
                                    * z[..., None]).reshape(-1, 3)
    res = {}
    for on in (True, False):
        monkeypatch.setattr(tfused, "build_pts",
                            (lambda *a: calls.append(a[2].shape) or orig(*a))
                            if on else expression)
        spec, ts, st = port_state(tiny_cfg(TConfig), state.params)
        assert tfused.stage1_fused_eligible(spec, ts.render)
        st, m = tstage1.make_train_step(spec, ts, device="cpu")(st, item,
                                                               draws=draws)
        res[on] = (float(m["loss"]), grads_to_jax(st.model))
    assert calls == [(48, 8), (48, 16)]
    assert res[True][0] == res[False][0]
    for path, x, y in _pairs(res[True][1], res[False][1]):
        np.testing.assert_array_equal(x, y, err_msg=path)


# ---------------------------------------------------------------------------
# (e) the one-net models' weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["warp_only", "ambient_only"])
def test_one_net_params_round_trip(setups, kind):
    """params_from_jax then params_to_jax gives back JAX's tree of a
    warp-only or an ambient-only model, the missing net absent."""
    _, _, state = setups[kind]
    tree = jax.tree.map(np.asarray, state.params["model"])
    spec = tn.ModelSpec.from_config(model_cfg(kind, TConfig))
    assert jn.ModelSpec.from_config(model_cfg(kind)).use_warp == spec.use_warp
    model = params_from_jax(tn.NeRFaceModel.init(spec, seed=3, device="cpu"), tree)
    assert (model.warp is None) == (kind == "ambient_only")
    assert (model.hyper is None) == (kind == "warp_only")
    back = params_to_jax(model)
    assert sorted(back) == sorted(tree)
    for path, x, y in _pairs(back, tree, "params"):
        np.testing.assert_array_equal(x, y, err_msg=path)
    grads = grads_to_jax(model)
    assert sorted(grads) == sorted(tree)
