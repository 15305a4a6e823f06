"""The port's multi-step loop (``train/stage1.make_multi_train_step``,
``stack_batches``) on the CPU, tiny config (32x32 frames, 48 rays, 8 + 8
samples, float32; the fused path on the kernels' plain versions but in
(c)):

  (a) ``stack_batches`` gives JAX's stacked batch, key for key, exactly;
  (b) K = 3 steps of the multi-step loop equal 3 ``train_step`` calls fed the same
      draws, bit for bit (the same step on the same bits);
  (c) the multi-step loop against JAX's ``make_multi_train_step`` (its ``lax.scan``)
      under the draws of the scan's key splits (``ky, sub = split(ky)``,
      then train_step's own split), both on the plain path (use_pallas
      off: on this draw JAX's fused path, its Pallas kernels in interpret
      mode, reads 3.7 % from JAX's own plain path on the deformation nets'
      first-layer gradients, and the port's fused step 0.8 % from it; the
      kernel paths are held one step at a time in test_torch_train.py, and
      the loop is the same over either step), both under SGD at the
      config's rate:
      each step's metrics and the final sample_prob within OUT_RTOL of
      JAX's (test_torch_train.py's output gate), the sum of the three
      steps' gradients leaf by leaf within its whole-step gradient gate
      (STEP_L2 of the leaf's own norm, cosine STEP_COS), and the
      parameters within its one-step rtol 1e-5 / atol 5e-5.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax

from sahs_tpu.data.synthetic import SyntheticFaceDataset
from sahs_tpu.models import nerface as jn
from sahs_tpu.train import stage1 as jstage1

from sahs_tpu_torch.config import Config as TConfig
from sahs_tpu_torch.models import nerface as tn
from sahs_tpu_torch.train import stage1 as tstage1
from sahs_tpu_torch.train.fused import TrainDraws
from sahs_tpu_torch.utils.weights import params_from_jax, params_to_jax

from test_torch_train import (OUT_RTOL, _jax_draws, _tree_pairs, assert_step_grads_close,
                              tiny_cfg)

torch.set_num_threads(2)

K, R, S = 3, 48, 8


def _items(n=K):
    cfg = tiny_cfg()
    ds = SyntheticFaceDataset(kind="audio", num_frames=4, H=32, W=32,
                              near=cfg.dataset.near, far=cfg.dataset.far)
    return [ds[j] for j in (2, 0, 3)][:n], ds.background()


def _stacked_draws(key):
    """JAX's scan splits ``ky, sub = split(ky)`` a step; each step's draws
    from ``sub`` as train_step splits it. -> TrainDraws stacked along K."""
    per_step, ky = [], key
    for _ in range(K):
        ky, sub = jax.random.split(ky)
        per_step.append(_jax_draws(sub, 32, 32, R, S, S)[1])
    return TrainDraws(*(torch.stack(f) for f in zip(*per_step)))


def test_stack_batches_matches_jax():
    items, bg = _items()
    got = tstage1.stack_batches(items, bg, device="cpu")
    want = jstage1.stack_batches(items, jnp.asarray(bg))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and str(got[k].dtype).endswith(str(v.dtype)), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    assert got["background"].stride(0) == 0      # broadcast, not copied


def _port(cfg=None):
    cfg = cfg or tiny_cfg(TConfig)
    spec, ts = tn.ModelSpec.from_config(cfg), tstage1.TrainSettings.from_config(cfg)
    return spec, ts, tstage1.init_train_state(spec, ts, seed=0, device="cpu")


def test_multi_step_equals_single_steps():
    items, bg = _items()
    draws = _stacked_draws(jax.random.PRNGKey(4))
    spec, ts, a = _port()
    _, _, b = _port()
    multi = tstage1.make_multi_train_step(spec, ts, device="cpu")
    a, ms = multi(a, tstage1.stack_batches(items, bg, device="cpu"), draws=draws)
    step = tstage1.make_train_step(spec, ts, device="cpu")
    singles = []
    for k, item in enumerate(items):
        b, m = step(b, dict(item, background=bg), draws=TrainDraws(*(f[k] for f in draws)))
        singles.append(m)
    assert a.step == b.step == K
    for name, v in ms.items():
        assert v.shape == (K,)
        assert torch.equal(v, torch.stack([m[name] for m in singles])), name
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)
        for moment in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a.optimizer.state[pa][moment], b.optimizer.state[pb][moment])
    assert torch.equal(a.sample_prob, b.sample_prob)
    # and from a generator: the same draws as single steps on one generator
    _, _, c = _port()
    _, _, d = _port()
    c, mc = multi(c, tstage1.stack_batches(items, bg, device="cpu"),
                  generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    for item in items:
        d, md = step(d, dict(item, background=bg), generator=gen)
    assert torch.equal(mc["loss"][-1], md["loss"])
    for pc, pd in zip(c.model.parameters(), d.model.parameters()):
        assert torch.equal(pc, pd)


class _SumSGD(torch.optim.SGD):
    """SGD that also keeps the sum of the gradients it was given."""

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    st = self.state[p]
                    st["gsum"] = st.get("gsum", torch.zeros_like(p)) + p.grad
        return super().step(closure)


def test_multi_step_matches_jax(monkeypatch):
    """Both under SGD at the config's rate behind a transformation that
    sums the gradients (test_torch_train.py's one-step comparison keeps
    the step's gradients so; a difference of parameters would round
    them)."""
    cfg = tiny_cfg(use_pallas=False)
    spec, ts = jn.ModelSpec.from_config(cfg), jstage1.TrainSettings.from_config(cfg)
    gsum = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, jax.tree.map(jnp.add, s, g)))
    opt = optax.chain(gsum, optax.sgd(ts.lr))
    monkeypatch.setattr(jstage1, "make_optimizer", lambda ts: opt)
    jst = jstage1.init_train_state(jax.random.PRNGKey(0), spec, ts)
    pm = dict(jst.params["model"])
    for lvl in ("coarse", "fine"):        # live sigma (test_torch_train.py)
        pm[lvl] = dict(pm[lvl], fc_alpha={"w": pm[lvl]["fc_alpha"]["w"],
                                          "b": pm[lvl]["fc_alpha"]["b"] + 0.5})
    jst = jst._replace(params={"model": pm}, opt_state=opt.init({"model": pm}))
    items, bg = _items()
    key = jax.random.PRNGKey(9)
    multi_j = jstage1.make_multi_train_step(spec, ts, donate=False)
    jend, m_j = multi_j(jst, jstage1.stack_batches(items, jnp.asarray(bg)), key)

    tspec, tts, tst = _port(tiny_cfg(TConfig, use_pallas=False))
    params_from_jax(tst.model, jax.tree.map(np.asarray, pm))
    tst.optimizer = _SumSGD(tst.model.parameters(), lr=tts.lr)
    tst.lr_fn = None
    multi = tstage1.make_multi_train_step(tspec, tts, device="cpu")
    tst, m_t = multi(tst, tstage1.stack_batches(items, bg, device="cpu"),
                     draws=_stacked_draws(key))
    assert tst.step == K
    for name in ("loss", "coarse_l2", "fine_l2", "coarse_ce", "fine_ce", "bg_loss", "psnr"):
        np.testing.assert_allclose(m_t[name].numpy(), np.asarray(m_j[name]),
                                   rtol=OUT_RTOL, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(tst.sample_prob.numpy(), np.asarray(jend.sample_prob),
                               rtol=OUT_RTOL)
    assert_step_grads_close(params_to_jax(tst.model, lambda p: tst.optimizer.state[p]["gsum"]),
                            jend.opt_state[0]["model"])
    for path, x, y in _tree_pairs(params_to_jax(tst.model),
                                  jax.tree.map(np.asarray, jend.params["model"])):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=5e-5, err_msg=path)
