"""Shared pieces of tests/test_torch_skip_{paths,steps}.py and
tests/test_torch_gridfree.py: the three models whose warp and hyper nets
cannot share K1's kernel, the model without view directions and the
models without the spatial-embedding grid, at the tiny size of
tests/torch_fallback_util.py (48 rays of a 32 x 32 audio frame, 8 + 8
samples, float32), with JAX's seeded weights and live sigma."""
import numpy as np

import jax
import jax.numpy as jnp

from sahs_tpu.config import Config
from sahs_tpu.data.synthetic import SyntheticFaceDataset
from sahs_tpu.models import nerface as jn
from sahs_tpu.ops.rays import get_rays_at
from sahs_tpu.render import pipeline as jpipe
from sahs_tpu.train import stage1 as jstage1

from sahs_tpu_torch.config import Config as TConfig
from sahs_tpu_torch.render import pipeline as tpipe

from torch_fallback_util import _t, live_sigma, port_state, tiny_cfg

# model -> the flagship Config() with these model fields set
MODELS = {
    "warp_only": (("hyper", "use_ambient", False),),
    "ambient_only": (("warp", "use_warp", False),),
    "split": (("hyper", "include_driving", False),),
    "no_viewdirs": (("coarse", "use_viewdirs", False),
                    ("fine", "use_viewdirs", False)),
}
# the models without the spatial-embedding grid (tests/test_torch_gridfree.py)
GRID_FREE = {
    "grid_free": (("coarse", "use_spatial_embeddings", False),),
    "grid_free_warp_only": (("coarse", "use_spatial_embeddings", False),
                            ("hyper", "use_ambient", False)),
}


class SkipCalls:
    """Counts the calls of K13's and K14's wrappers in ``n``."""

    def __init__(self, monkeypatch):
        from sahs_tpu_torch.ops.kernels import skip_mlp as k13
        self.n = {"K13": 0, "K14": 0}
        for key, name in (("K13", "skip_mlp_forward"), ("K14", "skip_mlp_vjp")):
            monkeypatch.setattr(k13, name, self._wrap(key, getattr(k13, name)))

    def _wrap(self, key, orig):
        def run(*a, **k):
            self.n[key] += 1
            return orig(*a, **k)
        return run


def model_cfg(kind, cls=Config, num_fine=8, **runtime):
    """tiny_cfg (of ``cls``, JAX's Config by default) with ``kind``'s model
    and ``num_fine`` fine samples."""
    cfg = tiny_cfg(cls, **runtime)
    cfg.nerf.train.num_fine = num_fine
    for sub, field, value in {**MODELS, **GRID_FREE}[kind]:
        setattr(getattr(cfg.models, sub), field, value)
    return cfg


def model_setup(kind, seed=0):
    """(JAX cfg, the frame with its background, a JAX train state with
    live sigma) for ``kind``."""
    cfg = model_cfg(kind)
    spec = jn.ModelSpec.from_config(cfg)
    ts = jstage1.TrainSettings.from_config(cfg)
    ds = SyntheticFaceDataset(kind="audio", num_frames=1, H=32, W=32,
                              near=cfg.dataset.near, far=cfg.dataset.far)
    item = dict(ds[0])
    item["background"] = ds.background()
    state = jstage1.init_train_state(jax.random.PRNGKey(seed), spec, ts)
    return cfg, item, state._replace(params=live_sigma(state.params))


def render_both(kind, jparams, item, Sc, Sn, fuse, jax_pallas, R=24, seed=2):
    """render_rays of ``kind``'s model on R rays of the frame, perturb off:
    the port on its kernel path, the JAX package with ``jax_pallas``.
    Returns (port result, JAX result)."""
    cfg = model_cfg(kind)
    spec = jn.ModelSpec.from_config(cfg)
    idx = np.random.RandomState(seed).choice(32 * 32, R, replace=False)
    ro, rd = get_rays_at(jnp.asarray(idx), 32, 32, jnp.asarray(item["intrinsics"]),
                         jnp.asarray(item["pose"]))
    bg = item["background"].reshape(-1, 15)[idx]
    kw = dict(num_coarse=Sc, num_fine=Sn, perturb=False, compute_dtype="float32",
              fuse_composite=fuse)
    out_j = jpipe.render_rays(jparams["model"], spec,
                              jpipe.RenderSettings(use_pallas=jax_pallas, **kw),
                              ro, rd, cfg.dataset.near, cfg.dataset.far,
                              jnp.asarray(item["driving"]), jnp.asarray(item["pose"]),
                              background_prior=jnp.asarray(bg))
    _, _, st = port_state(model_cfg(kind, TConfig), jparams)
    out_t = tpipe.render_rays(st.model, tpipe.RenderSettings(use_pallas=True, **kw),
                              _t(ro), _t(rd), cfg.dataset.near, cfg.dataset.far,
                              _t(item["driving"]), _t(item["pose"]),
                              background_prior=_t(bg))
    return out_t, out_j
