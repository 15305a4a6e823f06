"""Helpers of the fused step's variant tests
(tests/test_torch_fused_variants.py, tests/test_torch_fused_variant_forms.py):
the tiny setup with or without the grid, both packages' stage1_fused with
the variant's flags, the port's train_step, and the checks against JAX's
variant and the port's default step. Imports JAX and the port.
"""
import contextlib
import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from sahs_tpu.data.synthetic import SyntheticFaceDataset
from sahs_tpu.models import nerface as jn
from sahs_tpu.ops import rays as jrays
from sahs_tpu.train import fused as jfused
from sahs_tpu.train import stage1 as jstage1

import torch

from sahs_tpu_torch.config import Config as TConfig
from sahs_tpu_torch.models import nerface as tn
from sahs_tpu_torch.train import fused as tfused
from sahs_tpu_torch.train import stage1 as tstage1
from sahs_tpu_torch.utils.weights import grads_to_jax, params_from_jax, params_to_jax

from torch_fallback_util import (OUT_RTOL, _n, _t, assert_step_grads_close,
                                 jax_draws, live_sigma, tiny_cfg)


FLAGS = ("_BWD_SPLIT", "_UNION", "_PAIR_RAYS", "_PAIR_FOLD")
VARIANTS = {"split": ("_BWD_SPLIT",), "union": ("_UNION",),
            "rays": ("_PAIR_RAYS",), "fold": ("_PAIR_FOLD",),
            "rays_fold": ("_PAIR_RAYS", "_PAIR_FOLD"),
            "rays_union": ("_PAIR_RAYS", "_UNION")}
# the port's variant against its default step: tests/test_fused_train.py's
# tolerances, (loss rtol, gradient rtol, gradient atol)
DEFAULT_TOLS = {"split": (1e-6, 1e-4, 1e-6)}
DEFAULT_TOL = (1e-5, 2e-4, 2e-6)


@contextlib.contextmanager
def flags(on):
    """Both packages' fused modules with exactly the flags ``on`` set."""
    saved = [(m, f, getattr(m, f)) for m in (jfused, tfused) for f in FLAGS]
    try:
        for m in (jfused, tfused):
            for f in FLAGS:
                setattr(m, f, f in on)
        yield
    finally:
        for m, f, v in saved:
            setattr(m, f, v)


def variant_setup(grid: bool):
    """tests/test_torch_train.py's tiny_setup (48 rays, 8 + 8, float32, a
    live sigma), with or without the spatial-embedding grid, and one
    step's rays, draws and targets."""
    cfg, tcfg = tiny_cfg(), tiny_cfg(TConfig)
    for c in (cfg, tcfg):
        c.models.coarse.use_spatial_embeddings = grid
    spec = jn.ModelSpec.from_config(cfg)
    ts = jstage1.TrainSettings.from_config(cfg)
    ds = SyntheticFaceDataset(kind="audio", num_frames=1, H=32, W=32,
                              near=cfg.dataset.near, far=cfg.dataset.far)
    item = dict(ds[0])
    item["background"] = ds.background()
    state = jstage1.init_train_state(jax.random.PRNGKey(0), spec, ts)
    state = state._replace(params=live_sigma(state.params))
    tspec = tn.ModelSpec.from_config(tcfg)
    tts = tstage1.TrainSettings.from_config(tcfg)
    R, Sc, Sn = 48, 8, 8
    key = jax.random.PRNGKey(11)
    k_render = jax.random.split(key)[1]
    draws = jax_draws(key, 32, 32, R, Sc, Sn)
    rng = np.random.RandomState(5)
    idx = rng.choice(32 * 32, R, replace=False)
    ro, rd = jrays.get_rays_at(jnp.asarray(idx), 32, 32,
                               jnp.asarray(item["intrinsics"]),
                               jnp.asarray(item["pose"]))
    mask = item["mask"].reshape(-1, 12)[idx]
    tgt = np.concatenate([item["image"].reshape(-1, 3)[idx], mask], 1)
    bg = item["background"].reshape(-1, 15)[idx]
    lw = jfused.ray_loss_weights(jnp.asarray(mask), 0.02, 0.005)
    fcfg = jfused.FusedCfg(num_coarse=Sc, num_fine=Sn, near=cfg.dataset.near,
                           far=cfg.dataset.far, perturb=True, noise_std=0.1,
                           lindisp=False, compute_dtype="float32",
                           bg_sup_weight=0.3)
    return dict(cfg=cfg, spec=spec, state=state, item=item, tspec=tspec, tts=tts,
                k_render=k_render, draws=draws, ro=ro, rd=rd, tgt=tgt, bg=bg,
                lw=lw, fcfg=fcfg)


def run_jax(su, on):
    """JAX's stage1_fused with the flags ``on``: (loss, outputs, model
    gradients, background gradient)."""
    spec, item = su["spec"], su["item"]
    pose_enc = jn.encode_pose(jnp.asarray(item["pose"]))

    def jloss(pm, bgv):
        driving = jn.compute_driving(pm, spec, jnp.asarray(item["driving"]))
        out = jfused.stage1_fused(spec, su["fcfg"], pm, driving, pose_enc, None,
                                  su["ro"], su["rd"], jnp.asarray(su["tgt"]),
                                  su["lw"], bgv, su["k_render"])
        return out[0], out
    with flags(on):
        (loss, out), (g, gbg) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(su["state"].params["model"],
                                                  jnp.asarray(su["bg"]))
    return float(loss), [np.asarray(o) for o in out[1:]], g, np.asarray(gbg)


def port_state(su):
    tst = tstage1.init_train_state(su["tspec"], su["tts"], seed=0, device="cpu")
    params_from_jax(tst.model, jax.tree.map(np.asarray, su["state"].params["model"]))
    tst.optimizer = torch.optim.SGD(tst.model.parameters(), lr=1.0)
    tst.lr_fn = None
    return tst


def run_port(su, on):
    """The port's stage1_fused with the flags ``on``: (loss, outputs,
    model gradients as JAX's tree, background gradient)."""
    m = port_state(su).model
    item = su["item"]
    bg_t = _t(su["bg"]).requires_grad_(True)
    with flags(on):
        driving = tn.compute_driving(m, _t(item["driving"]))
        loss, rgb_c, rgb_f, w_f = tfused.stage1_fused(
            m, tfused.FusedCfg(**dataclasses.asdict(su["fcfg"])), driving,
            tn.encode_pose(_t(item["pose"])), _t(su["ro"]), _t(su["rd"]),
            _t(su["tgt"]), _t(np.asarray(su["lw"])), bg_t, draws=su["draws"])
        loss.backward()
    return (float(loss.detach()), [_n(o) for o in (rgb_c, rgb_f, w_f)],
            grads_to_jax(m), _n(bg_t.grad))


def run_port_step(su, on):
    """One port train_step with the flags ``on`` (SGD(1.0)): (metrics, new
    parameters as JAX's tree)."""
    tst = port_state(su)
    step = tstage1.make_train_step(su["tspec"], su["tts"], device="cpu")
    with flags(on):
        tst, m = step(tst, su["item"], draws=su["draws"])
    return {k: float(v) for k, v in m.items()}, params_to_jax(tst.model)


def _leaves(tree, path="g"):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, _n(tree) if torch.is_tensor(tree) else np.asarray(tree)


def check_variant(su, name, default):
    """(a) for the variant ``name``; ``default`` the port's default run."""
    on = VARIANTS[name]
    loss_j, out_j, g_j, gbg_j = run_jax(su, on)
    loss_t, out_t, g_t, gbg_t = run_port(su, on)
    # against JAX's same variant
    np.testing.assert_allclose(loss_t, loss_j, rtol=OUT_RTOL)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a, b, rtol=OUT_RTOL, atol=1e-6)
    assert_step_grads_close(g_t, g_j)
    assert_step_grads_close({"bg": gbg_t}, {"bg": gbg_j})
    # against the port's default step
    loss_d, out_d, g_d, gbg_d = default
    l_tol, g_rtol, g_atol = DEFAULT_TOLS.get(name, DEFAULT_TOL)
    np.testing.assert_allclose(loss_t, loss_d, rtol=l_tol)
    for a, b in zip(out_t, out_d):
        np.testing.assert_allclose(a, b, rtol=OUT_RTOL, atol=1e-6)
    for (path, a), (_, b) in zip(_leaves(g_t), _leaves(g_d)):
        np.testing.assert_allclose(a, b, rtol=g_rtol, atol=g_atol, err_msg=path)
    np.testing.assert_allclose(gbg_t, gbg_d, rtol=g_rtol, atol=g_atol)


def check_step(su, name, default_step):
    """The variant through train_step against the default's step."""
    m_v, p_v = run_port_step(su, VARIANTS[name])
    m_d, p_d = default_step
    for k in ("loss", "coarse_l2", "fine_l2", "psnr"):
        np.testing.assert_allclose(m_v[k], m_d[k], rtol=1e-5, err_msg=k)
    _, _, g_atol = DEFAULT_TOLS.get(name, DEFAULT_TOL)
    for (path, a), (_, b) in zip(_leaves(p_v), _leaves(p_d)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=g_atol, err_msg=path)
