"""The PyTorch port's models against the JAX package, at float32: the weight
bridge, AudioNet, the warp / hyper / NeRF MLPs, the folded conditioning and
the per-frame conditioning (driving, pose PE)."""
import dataclasses
import glob
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sahs_tpu.config import Config
from sahs_tpu.models import fields as jf
from sahs_tpu.models import nerface as jn
from sahs_tpu.ops.encoding import positional_encoding

from sahs_tpu_torch.config import Config as TConfig
from sahs_tpu_torch.models import nerface as tn
from sahs_tpu_torch.ops.kernels.field_mlp import (fold_trunk, trunk_forward,
                                                  trunk_params)
from sahs_tpu_torch.utils.weights import params_from_jax, params_to_jax

torch.set_num_threads(2)

ATOL = 1e-5


def _small_config():
    """Narrow, shallow widths (the shapes the reference quirks need: warp
    and hyper skips at 2, NeRF skip at 3 regardless of the config)."""
    cfg = Config()
    cfg.models.warp.num_layers, cfg.models.warp.hidden_size = 4, 32
    cfg.models.warp.skip_connect_every = 2
    cfg.models.hyper.num_layers, cfg.models.hyper.hidden_size = 4, 16
    cfg.models.hyper.skip_connect_every = 2
    for m in (cfg.models.coarse, cfg.models.fine):
        m.num_layers, m.hidden_size = 5, 32
    return cfg


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def small():
    cfg = _small_config()
    spec = jn.ModelSpec.from_config(cfg)
    params = jn.init_model_params(jax.random.PRNGKey(0), spec)
    tcfg = TConfig()
    for sec in ("warp", "hyper", "coarse", "fine"):
        setattr(tcfg.models, sec, dataclasses.replace(getattr(cfg.models, sec)))
    tspec = tn.ModelSpec.from_config(tcfg)
    model = tn.NeRFaceModel(tspec)
    params_from_jax(model, jax.tree.map(np.asarray, params))
    rng = np.random.RandomState(0)
    x = dict(pts=rng.uniform(-0.5, 0.5, (40, 3)).astype(np.float32),
             dirs=(rng.randn(40, 3) * 0.1 + [0, 0, -1]).astype(np.float32),
             audio=rng.randn(16, 29).astype(np.float32),
             pose=np.concatenate([np.linalg.qr(rng.randn(3, 3))[0],
                                  [[0.1], [0.0], [0.6]]], 1).astype(np.float32))
    return spec, params, model, x


@pytest.mark.parametrize("path", [None] + sorted(
    glob.glob(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "*", "*.yml"))))
def test_config_matches_jax(path):
    """The port's copy of config.py reads the defaults and every shipped
    YAML exactly as the JAX package does."""
    from sahs_tpu.config import load_config
    from sahs_tpu_torch.config import load_config as tload_config
    if path is None:
        js, ts = Config(), TConfig()
    else:
        js, ts = load_config(path), tload_config(path)
    assert dataclasses.asdict(js) == dataclasses.asdict(ts)


def test_spec_matches_jax():
    js = jn.ModelSpec.from_config(Config())
    ts = tn.ModelSpec.from_config(TConfig())
    assert dataclasses.asdict(js) == dataclasses.asdict(ts)
    assert ts.coarse.skip_connect_every == 3 and ts.warp.skip_connect_every == 4


def test_params_round_trip(small):
    """JAX tree -> port modules -> JAX tree is the identity, the linear
    weights are transposed and the conv weights permuted to (cout, cin, k)."""
    spec, params, model, _ = small
    back = params_to_jax(model)
    flat_a, tree_a = jax.tree.flatten(jax.tree.map(np.asarray, params))
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(model.warp.trunk.layers[0].weight.detach().numpy(),
                                  np.asarray(params["warp"]["trunk"][0]["w"]).T)
    np.testing.assert_array_equal(model.audnet.convs[1].weight.detach().numpy(),
                                  np.asarray(params["audnet"]["convs"][1]["w"]).transpose(2, 1, 0))


def test_seeded_init_is_reproducible():
    spec = tn.ModelSpec.from_config(TConfig())
    a = tn.NeRFaceModel.init(spec, seed=5, device="cpu")
    b = tn.NeRFaceModel.init(spec, seed=5, device="cpu")
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    bound = 1 / np.sqrt(a.coarse.trunk.layers[0].in_features)
    assert float(a.coarse.trunk.layers[0].weight.detach().abs().max()) <= bound


def test_audionet_and_pose(small):
    spec, params, model, x = small
    with torch.no_grad():
        _close(tn.compute_driving(model, _t(x["audio"])),
               jn.compute_driving(params, spec, jnp.asarray(x["audio"])))
        _close(tn.encode_pose(_t(x["pose"])), jn.encode_pose(jnp.asarray(x["pose"])))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol)


def test_warp_and_hyper(small):
    spec, params, model, x = small
    pe = positional_encoding(jnp.asarray(x["pts"]), 10)
    drv = np.random.RandomState(1).randn(76).astype(np.float32) * 0.1
    pose = np.random.RandomState(2).randn(36).astype(np.float32)
    wj = jf.warp_field_apply(params["warp"], spec.warp, pe, jnp.asarray(drv),
                             jnp.asarray(pose))
    hj = jf.hyper_sheet_apply(params["hyper"], spec.hyper, pe, jnp.asarray(drv),
                              jnp.asarray(pose))
    with torch.no_grad():
        wt = model.warp(_t(pe), _t(drv), _t(pose))
        ht = model.hyper(_t(pe), _t(drv), _t(pose))
    _close(wt, wj)
    _close(ht, hj)


def test_map_points_and_nerf(small):
    """map_points, the grid sample and the NeRF MLP (query_template), both
    levels, against the JAX package."""
    from sahs_tpu.ops.grid import grid_sample_3d as jgs
    from sahs_tpu_torch.ops.grid import grid_sample_3d as tgs
    spec, params, model, x = small
    drv_j = jn.compute_driving(params, spec, jnp.asarray(x["audio"]))
    pose_j = jn.encode_pose(jnp.asarray(x["pose"]))
    mj = jn.map_points(params, spec, jnp.asarray(x["pts"]), drv_j, pose_j)
    se_j = jgs(params["spatial_embeddings"], mj[..., :3])
    with torch.no_grad():
        drv_t = tn.compute_driving(model, _t(x["audio"]))
        pose_t = tn.encode_pose(_t(x["pose"]))
        mt = tn.map_points(model, _t(x["pts"]), drv_t, pose_t)
        se_t = tgs(model.spatial_embeddings, mt[..., :3])
        _close(mt, mj)
        _close(se_t, se_j)
        for level in ("coarse", "fine"):
            rj = jn.query_template(params, spec, level, mj, jnp.asarray(x["dirs"]),
                                   drv_j, pose_j, None, se_j)
            rt = tn.query_template(model, level, mt, _t(x["dirs"]), drv_t,
                                   pose_t, None, se_t)
            _close(rt, rj, atol=2e-5)


@pytest.mark.parametrize("net", ["warp", "coarse"])
def test_folded_conditioning_matches_concat(small, net):
    """Folding driving/pose into the input and skip biases gives the same
    trunk output as concatenating them to every point."""
    spec, params, model, x = small
    rng = np.random.RandomState(3)
    mod = getattr(model, net)
    pe_dim = 63 if net == "warp" else mod.spec.pe_xyz_dim + mod.spec.ambient_pe_dim
    in_dim = mod.trunk.layers[0].in_features
    pe = _t(rng.uniform(-1, 1, (30, pe_dim)).astype(np.float32))
    cond = _t(rng.randn(in_dim - pe_dim).astype(np.float32))
    skip = mod.trunk.skip_every
    act = torch.relu if net == "warp" else (lambda v: torch.where(v >= 0, v, 0.01 * v))
    with torch.no_grad():
        full = mod.trunk(torch.cat([pe, cond.expand(30, -1)], -1), act)
        hid = mod.trunk.layers[0].out_features
        folded = fold_trunk(trunk_params(mod.trunk), cond, pe_dim, hid, skip)
        out = trunk_forward(folded, pe, skip, act, torch.float32)
    _close(out, full.numpy())
