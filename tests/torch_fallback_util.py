"""Shared pieces of the autograd-fallback tests (tests/test_torch_fallback_*):
the tiny configuration, JAX's draws of a step, a JAX train step whose
gradients are kept, the port's state on the same weights, and the
gradient and metric comparisons with their tolerances (the test files'
docstrings give the reasons)."""
import numpy as np
import optax

import jax
import jax.numpy as jnp
import torch

from sahs_tpu.config import Config
from sahs_tpu.data.synthetic import SyntheticFaceDataset
from sahs_tpu.models import nerface as jn
from sahs_tpu.train import stage1 as jstage1

from sahs_tpu_torch.models import nerface as tn
from sahs_tpu_torch.train import fused as tfused
from sahs_tpu_torch.train import stage1 as tstage1
from sahs_tpu_torch.utils.weights import params_from_jax

OUT_RTOL = 3e-5
STEP_L2, STEP_COS = 5e-2, 0.998
G_RTOL, G_SCALE = 5e-3, 1e-3


def _t(x):
    return torch.tensor(np.asarray(x))


def _n(x):
    return np.asarray(x.detach().cpu()) if torch.is_tensor(x) else np.asarray(x)


def _pairs(a, b, path="grads"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{path}[{i}]")
    else:
        yield path, _n(a).astype(np.float64).ravel(), np.asarray(b, np.float64).ravel()


def assert_step_grads_close(a, b):
    for path, x, y in _pairs(a, b):
        ny = np.linalg.norm(y)
        assert ny > 0, path
        rel = np.linalg.norm(x - y) / ny
        cos = float(x @ y) / (np.linalg.norm(x) * ny + 1e-300)
        assert rel <= STEP_L2 and cos >= STEP_COS, (path, rel, cos)


def tiny_cfg(cls=Config, **runtime):
    """48 rays, 8 + 8 samples, float32, the kernel path."""
    cfg = cls()
    cfg.nerf.train.num_random_rays = 48
    cfg.nerf.train.num_coarse = 8
    cfg.nerf.train.num_fine = 8
    cfg.runtime.use_pallas = True
    cfg.runtime.compute_dtype = "float32"
    for k, v in runtime.items():
        setattr(cfg.runtime, k, v)
    return cfg


def jax_draws(key, H, W, R, Sc, Sn):
    """JAX's draws of one train step, split from the key as train_step and
    render_rays split it."""
    k_sel, k_render = jax.random.split(key)
    keys = jax.random.split(k_render, 4)
    f32 = jnp.float32
    return tfused.TrainDraws(
        gumbel=_t(jax.random.gumbel(k_sel, (H * W,), f32)),
        t_rand=_t(jax.random.uniform(keys[0], (R, Sc), f32)),
        noise_coarse=_t(jax.random.normal(keys[1], (R, Sc), f32)),
        u=_t(jax.random.uniform(keys[2], (R, Sn), f32)),
        noise_fine=_t(jax.random.normal(keys[3], (R, Sc + Sn), f32)))


def live_sigma(params):
    """The JAX tree with the sigma bias lifted by 0.5 at both levels, so
    that the weights are live (tests/test_fused_train.py)."""
    params = dict(params)
    model = dict(params["model"])
    for lvl in ("coarse", "fine"):
        model[lvl] = dict(model[lvl])
        model[lvl]["fc_alpha"] = {"w": model[lvl]["fc_alpha"]["w"],
                                  "b": model[lvl]["fc_alpha"]["b"] + 0.5}
    params["model"] = model
    return params


def jax_step(cfg, state, item, key):
    """One JAX train_step under SGD(1.0) behind a transformation that keeps
    the step's gradients. Returns (metrics, grads tree, new state)."""
    spec = jn.ModelSpec.from_config(cfg)
    ts = jstage1.TrainSettings.from_config(cfg)
    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    opt = optax.chain(keep, optax.sgd(1.0))
    st = state._replace(opt_state=opt.init(state.params))
    batch = {k: jnp.asarray(v) for k, v in item.items() if k != "fname"}
    st2, m = jax.jit(lambda s, b, k: jstage1.train_step(s, b, k, spec, ts, opt)
                     )(st, batch, key)
    return m, st2.opt_state[0], st2


def port_state(tcfg, jparams, num_latent_frames=0):
    spec = tn.ModelSpec.from_config(tcfg)
    ts = tstage1.TrainSettings.from_config(tcfg)
    st = tstage1.init_train_state(spec, ts, seed=0, device="cpu",
                                  num_latent_frames=num_latent_frames)
    tree = jax.tree.map(np.asarray, jparams)
    if st.latent_codes is not None:
        params_from_jax(st.model, tree, latent_codes=st.latent_codes)
    else:
        params_from_jax(st.model, tree["model"])
    params = list(st.model.parameters()) + (
        [st.latent_codes] if st.latent_codes is not None else [])
    st.optimizer = torch.optim.SGD(params, lr=1.0)
    st.lr_fn = None
    return spec, ts, st


def assert_metrics_close(m_t, m_j):
    for k in ("loss", "coarse_l2", "fine_l2", "coarse_ce", "fine_ce",
              "bg_loss", "psnr"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=OUT_RTOL,
                                   atol=1e-7, err_msg=k)


def audio_setup():
    cfg = tiny_cfg(fused_grads=False)
    spec = jn.ModelSpec.from_config(cfg)
    ts = jstage1.TrainSettings.from_config(cfg)
    ds = SyntheticFaceDataset(kind="audio", num_frames=1, H=32, W=32,
                              near=cfg.dataset.near, far=cfg.dataset.far)
    item = dict(ds[0])
    item["background"] = ds.background()
    state = jstage1.init_train_state(jax.random.PRNGKey(0), spec, ts)
    state = state._replace(params=live_sigma(state.params))
    return cfg, item, state


def assert_render_close(out_t, out_j):
    """Two RayRenderResults, tests/test_torch_render.py's tolerances: the
    composited channels, acc and weights within 1e-4 absolute, disparity
    and depth within 1e-3 relative."""
    for name, a, b in zip(out_t._fields, out_t, out_j):
        if a is None:
            assert b is None, name
        elif name.startswith(("disp", "depth")):
            np.testing.assert_allclose(_n(a), np.asarray(b), rtol=1e-3, err_msg=name)
        else:
            np.testing.assert_allclose(_n(a), np.asarray(b), atol=1e-4, err_msg=name)

