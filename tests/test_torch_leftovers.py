"""The leftover modules of the port against the JAX package (CPU):

  (a) models/fields.py: AudioAttNet, MaskGeneratorMLP (its seg[3] and
      dir[0:3] quirks), WarpEmbeddingMLP on JAX's seeded weights
      (utils/weights.net_from_jax, and back with net_to_jax), and each
      one's init from an explicit generator;
  (b) ops/rays.py: get_ray_bundle_by_mask and so3_exponential_map;
  (c) utils/seg.py: color2label and shrink, bit for bit;
  (d) models/nerface.py: apply_field against JAX's, and make_field_fn's
      kernel path (the plain versions on the CPU) and plain path against
      apply_field, for both model kinds;
  (e) utils/profiling.py: a trace file of a step, and a capture through
      the profiler server;
  (f) native/: the parse-map codec bit for bit against the JAX package's
      numpy path and its native path, and read_parse_map through it;
  (g) a Stage-I checkpoint written by JAX under SAHS_OPT_FLATTEN=1 (one
      raveled mu and nu), restored into the port: one plain-path step from
      it against JAX's step from the same checkpoint.

Tolerances: the nets and apply_field within 1e-5 absolute (float32, the
same operations in another order), the rays and rotations within 1e-6;
make_field_fn against apply_field within tests/test_smoke.py's 2e-3
absolute and 2e-2 relative (the kernel path folds the conditioning into
biases and rounds its sums otherwise); the step's metrics within
tests/test_torch_train.py's OUT_RTOL and each parameter's update within
its STEP_L2 / STEP_COS.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sahs_tpu import native as jnative
from sahs_tpu.config import Config
from sahs_tpu.data import common as jcommon
from sahs_tpu.models import fields as jf
from sahs_tpu.models import nerface as jn
from sahs_tpu.ops import rays as jrays
from sahs_tpu.train import stage1 as jstage1
from sahs_tpu.utils import checkpoint as jck
from sahs_tpu.utils import seg as jseg

from sahs_tpu_torch import native as tnative
from sahs_tpu_torch.config import Config as TConfig
from sahs_tpu_torch.data import common as tcommon
from sahs_tpu_torch.data.synthetic import SyntheticFaceDataset
from sahs_tpu_torch.models import fields as tf
from sahs_tpu_torch.models import nerface as tn
from sahs_tpu_torch.ops import rays as trays
from sahs_tpu_torch.train import stage1 as tstage1
from sahs_tpu_torch.utils import checkpoint as tck
from sahs_tpu_torch.utils import profiling as tprof
from sahs_tpu_torch.utils import seg as tseg
from sahs_tpu_torch.utils.weights import (net_from_jax, net_to_jax, params_from_jax,
                                          params_to_jax)

from torch_fallback_util import assert_metrics_close, jax_draws, tiny_cfg

torch.set_num_threads(2)

STEP_L2, STEP_COS = 5e-2, 0.998   # tests/test_torch_train.py's


def _t(x):
    return torch.tensor(np.asarray(x))


def _n(x):
    return np.asarray(x.detach().cpu()) if torch.is_tensor(x) else np.asarray(x)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)


# ---------------------------------------------------------------------------
# (a) the three nets
# ---------------------------------------------------------------------------

NETS = {
    "audio_att": (lambda k: jf.audio_att_net_init(k),
                  lambda g: tf.AudioAttNet(generator=g)),
    "mask_generator": (lambda k: jf.mask_generator_init(k),
                       lambda g: tf.MaskGeneratorMLP(generator=g)),
    "warp_embedding": (lambda k: jf.warp_embedding_init(k),
                       lambda g: tf.WarpEmbeddingMLP(generator=g)),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_small_nets_match_jax(name):
    """Each net on JAX's seeded weights against the JAX apply, the weights
    back through net_to_jax leaf for leaf; two inits from generators of one
    seed give the same weights, of another seed other ones, in [-b, b]."""
    init_j, make_t = NETS[name]
    params = jax.tree.map(np.asarray, init_j(jax.random.PRNGKey(3)))
    net = net_from_jax(make_t(torch.Generator().manual_seed(0)), params)
    back = dict(_flat(net_to_jax(net)))
    assert sorted(back) == sorted(dict(_flat(params)))
    for k, v in _flat(params):
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    rng = np.random.RandomState(4)
    with torch.no_grad():
        if name == "audio_att":
            x = rng.randn(8, 76).astype(np.float32)
            out_t = net(_t(x))
            out_j = jf.audio_att_net_apply(params, jnp.asarray(x))
        elif name == "mask_generator":
            P = 64
            xyz, dirs = rng.randn(P, 63), rng.randn(P, 27)
            drv, lat = rng.randn(76), rng.randn(32) * 0.1
            xyz, dirs, drv, lat = (a.astype(np.float32) for a in (xyz, dirs, drv, lat))
            out_t = net(_t(xyz), _t(dirs), _t(drv), _t(lat))
            out_j = jf.mask_generator_apply(params, *map(jnp.asarray, (xyz, dirs, drv, lat)))
            assert out_t.shape == (P, 5)
            # the quirk: seg[0:3] and dir[3] do not reach the output
            with torch.no_grad():
                for lin in list(net.seg[:3]) + [net.dir[3]]:
                    lin.weight.add_(1.0)
            np.testing.assert_array_equal(_n(net(_t(xyz), _t(dirs), _t(drv), _t(lat))),
                                          _n(out_t))
        else:
            x = rng.randn(16, 36).astype(np.float32)
            out_t = net(_t(x))
            out_j = jf.warp_embedding_apply(params, jnp.asarray(x))
    np.testing.assert_allclose(_n(out_t), np.asarray(out_j), atol=1e-5)
    a, b, c = (make_t(torch.Generator().manual_seed(s)) for s in (7, 7, 8))
    for (pa, pb, pc) in zip(a.parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb) and not torch.equal(pa, pc)
        bound = 1.0 / np.sqrt(pa.shape[1] * (pa.shape[2] if pa.dim() == 3 else 1)) \
            if pa.dim() > 1 else None
        if bound is not None:
            assert float(pa.detach().abs().max()) <= bound


# ---------------------------------------------------------------------------
# (b) rays, (c) seg codecs
# ---------------------------------------------------------------------------

def test_ray_bundle_by_mask_and_so3_match_jax():
    rng = np.random.RandomState(0)
    H, W = 12, 16
    intr = np.array([20.0, 22.0, 0.5, 0.45], np.float32)
    Rm = np.linalg.qr(rng.randn(3, 3))[0]
    c2w = np.concatenate([Rm, [[0.1], [-0.2], [0.7]]], 1).astype(np.float32)
    mask = (rng.rand(H, W) > 0.5).astype(np.float32)
    o_t, d_t = trays.get_ray_bundle_by_mask(H, W, _t(intr), _t(c2w), _t(mask))
    o_j, d_j = jrays.get_ray_bundle_by_mask(H, W, jnp.asarray(intr), jnp.asarray(c2w),
                                            jnp.asarray(mask))
    assert o_t.shape == d_t.shape == (H, W, 3)
    np.testing.assert_allclose(_n(o_t), np.asarray(o_j), atol=1e-6)
    np.testing.assert_allclose(_n(d_t), np.asarray(d_j), atol=1e-6)
    log_rot = np.concatenate([rng.randn(6, 3), np.zeros((1, 3)), [[1e-5, 0, 0]]]
                             ).astype(np.float32)
    R_t = trays.so3_exponential_map(_t(log_rot))
    R_j = jrays.so3_exponential_map(jnp.asarray(log_rot))
    assert R_t.shape == (8, 3, 3)
    np.testing.assert_allclose(_n(R_t), np.asarray(R_j), atol=1e-6)
    eye = np.broadcast_to(np.eye(3), (8, 3, 3))
    np.testing.assert_allclose(_n(R_t @ R_t.transpose(1, 2)), eye, atol=1e-5)


def test_seg_codecs_match_jax():
    """color2label on palette colours and unknown ones, and shrink on a
    soft mask with ties, bit for bit with JAX's (tests/test_data.py)."""
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 12, size=(16, 16))
    colors = tseg.PALETTE[labels].copy()
    colors[:2] = 17
    got, want = tseg.color2label(colors), jseg.color2label(colors)
    assert got.dtype == want.dtype and got.shape == (16, 16, 12)
    np.testing.assert_array_equal(got, want)
    assert got[:2].sum() == 0
    soft = rng.rand(8, 8, 12)
    soft[0, 0] = 0.5                         # a tie: the first class wins
    got, want = tseg.shrink(soft), jseg.shrink(soft)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# (d) apply_field and make_field_fn
# ---------------------------------------------------------------------------

def _field_setup(kind):
    cfg, tcfg = Config(), TConfig()
    if kind == "NeRFaceModel":
        for c in (cfg, tcfg):
            c.models.mask.type = "NeRFaceModel"
            c.dataset.type = "expression"
    spec = jn.ModelSpec.from_config(cfg)
    params = jax.tree.map(np.asarray, jn.init_model_params(jax.random.PRNGKey(0), spec))
    model = tn.NeRFaceModel.init(tn.ModelSpec.from_config(tcfg), seed=1, device="cpu")
    params_from_jax(model, params)
    rng = np.random.RandomState(0)
    R, S = 4, 32
    pts = (rng.randn(R * S, 3) * 0.2).astype(np.float32)
    dirs = rng.randn(R, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    driving = (rng.randn(16, 29) if spec.is_audio else rng.randn(76)).astype(np.float32)
    Rm = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
    pose = np.concatenate([Rm, np.array([[0], [0], [0.6]], np.float32)], 1)
    return spec, params, model, pts, dirs, driving, pose, R, S


@pytest.mark.parametrize("kind", ["AudioFaceModel", "NeRFaceModel"])
def test_apply_field_and_field_fn_match_jax(kind):
    spec, params, model, pts, dirs, driving, pose, R, S = _field_setup(kind)
    dirs_flat = np.repeat(dirs, S, axis=0)
    with torch.no_grad():
        oracle = tn.apply_field(model, "fine", _t(pts), _t(dirs_flat), _t(driving),
                                _t(pose))
        assert oracle.shape == (R * S, 16)
        want = jn.apply_field(jax.tree.map(jnp.asarray, params), spec, "fine",
                              jnp.asarray(pts), jnp.asarray(dirs_flat),
                              jnp.asarray(driving), jnp.asarray(pose))
        np.testing.assert_allclose(_n(oracle), np.asarray(want), atol=1e-5)
        for use_pallas in (True, False):
            field_fn = tn.make_field_fn(model, _t(driving), _t(pose),
                                        use_pallas=use_pallas, compute_dtype="float32")
            out = field_fn("fine", _t(pts), _t(dirs), S)
            assert out.shape == (R * S, 16) and torch.isfinite(out).all()
            np.testing.assert_allclose(_n(out), _n(oracle), atol=2e-3, rtol=2e-2)


# ---------------------------------------------------------------------------
# (e) profiling
# ---------------------------------------------------------------------------

def test_trace_and_profiler_server(tmp_path):
    """trace() writes one Chrome trace naming the ops run inside and the
    program's spans around them; a capture asked of the profiler server
    while the process computes writes another into the directory asked
    for; a bad request gets an error, and the server goes on."""
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with tprof.trace(str(tmp_path / "t")) as prof:
        with tprof.span("serve.chunk"):
            torch.mm(a, b)
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "t")
    with open(prof.trace_path) as fp:
        events = json.load(fp)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.get("name") == "serve.chunk" for e in events)
    server = tprof.start_profiler_server(0)
    stop = threading.Event()

    def work():
        while not stop.is_set():
            torch.mm(a, b)
    worker = threading.Thread(target=work)
    worker.start()
    try:
        path = tprof.capture(server.port, str(tmp_path / "cap"), duration_ms=300)
        afile = tmp_path / "a_file"
        afile.write_text("")
        with pytest.raises(RuntimeError, match="profiler server"):
            tprof.capture(server.port, str(afile), duration_ms=0)
        path2 = tprof.capture(server.port, str(tmp_path / "cap"), duration_ms=100)
    finally:
        stop.set()
        worker.join()
        server.close()
    assert os.path.dirname(path) == str(tmp_path / "cap") and path != path2
    with open(path) as fp:
        assert json.load(fp)["traceEvents"]


# ---------------------------------------------------------------------------
# (f) the codec
# ---------------------------------------------------------------------------

def test_codec_matches_jax_bit_for_bit(tmp_path):
    """The port's native codec on a 64x48 parse map (palette colours and
    unknown ones) against the JAX package's numpy and native paths and the
    port's plain version; its one-hot and colour inverses against numpy;
    read_parse_map through it against JAX's."""
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 12, size=(64, 48))
    bgr = tseg.PALETTE[labels].astype(np.uint8)
    bgr[:3] = 17
    got = tnative.palette_to_labels(bgr)
    assert got.dtype == np.uint8 and got.shape == (64, 48)
    np.testing.assert_array_equal(got, tcommon.palette_labels(bgr))
    np.testing.assert_array_equal(got, jnative.palette_to_labels(bgr))
    flat = bgr.reshape(-1, 3).astype(np.int32)
    eq = (flat[:, None, :] == jseg.PALETTE[None]).all(-1)
    np.testing.assert_array_equal(got.reshape(-1), np.where(eq.any(-1), eq.argmax(-1), 0))
    np.testing.assert_array_equal(tnative.labels_to_onehot(got),
                                  tcommon.labels_to_onehot(got))
    np.testing.assert_array_equal(tnative.labels_to_colors_bgr(got),
                                  tseg.PALETTE[got][..., ::-1].astype(np.uint8))
    assert os.path.dirname(tnative.library_path()) == tnative.BUILD_DIR
    assert tnative.library_path() != os.path.abspath(jnative._SO)
    import cv2
    p = str(tmp_path / "parse.png")
    cv2.imwrite(p, bgr)
    for h, w in ((64, 48), (32, 24)):
        np.testing.assert_array_equal(tcommon.read_parse_map(p, h, w),
                                      jcommon.read_parse_map(p, h, w))


def test_codec_build_failure_raises(monkeypatch, tmp_path):
    """A source g++ cannot build raises, naming the compiler; nothing falls
    back to numpy."""
    bad = tmp_path / "codec.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.palette_to_labels(np.zeros((2, 2, 3), np.uint8))


# ---------------------------------------------------------------------------
# (g) a checkpoint written under SAHS_OPT_FLATTEN=1
# ---------------------------------------------------------------------------

def test_flattened_adam_checkpoint_resumes_and_steps_as_jax(tmp_path, monkeypatch):
    """JAX trains one step with optax.flatten's Adam (SAHS_OPT_FLATTEN=1)
    and saves; the port restores the file (every parameter and both
    raveled moments, split in the tree's leaf order, exactly) and takes one
    plain-path step from it on JAX's draws; JAX takes its step from the
    same file. The metrics agree within OUT_RTOL, each parameter's update
    within STEP_L2 of its norm at a cosine of STEP_COS."""
    monkeypatch.setenv("SAHS_OPT_FLATTEN", "1")
    cfg, tcfg = tiny_cfg(Config, use_pallas=False), tiny_cfg(TConfig, use_pallas=False)
    spec, ts = jn.ModelSpec.from_config(cfg), jstage1.TrainSettings.from_config(cfg)
    ds = SyntheticFaceDataset(kind="audio", num_frames=1, H=32, W=32,
                              near=cfg.dataset.near, far=cfg.dataset.far)
    item = dict(ds[0], background=ds.background())
    batch = {k: jnp.asarray(v) for k, v in item.items() if k != "fname"}
    opt = jstage1.make_optimizer(ts)
    step_j = jax.jit(lambda s, b, k: jstage1.train_step(s, b, k, spec, ts, opt))
    jst = jstage1.init_train_state(jax.random.PRNGKey(0), spec, ts)
    assert jst.opt_state[0].mu.ndim == 1        # one raveled vector
    jst, _ = step_j(jst, batch, jax.random.PRNGKey(1))
    path = str(tmp_path / "flat.ckpt")
    jck.save_checkpoint(path, jst)
    jst, _ = jck.restore_train_state(path, jst)
    key = jax.random.PRNGKey(2)
    jst2, m_j = step_j(jst, batch, key)

    tspec, tts = tn.ModelSpec.from_config(tcfg), tstage1.TrainSettings.from_config(tcfg)
    st = tstage1.init_train_state(tspec, tts, seed=5, device="cpu")
    st, _ = tck.restore_train_state(path, st)
    assert st.step == 1
    before = {p: p.detach().clone() for p in st.model.parameters()}
    leaves = jax.tree.leaves(jst.params)
    assert sum(np.size(v) for v in leaves) == jst.opt_state[0].mu.size
    moments = [st.optimizer.state[p]["exp_avg"] for p in st.model.parameters()
               if p in st.optimizer.state]
    assert moments and all(torch.isfinite(m).all() for m in moments)
    st, m_t = tstage1.make_train_step(tspec, tts, device="cpu")(
        st, item, draws=jax_draws(key, 32, 32, 48, 8, 8))
    assert_metrics_close(m_t, m_j)
    new_t = dict(_flat(params_to_jax(st.model)))
    old_t = {k: v for k, v in _flat(params_to_jax(st.model, lambda p: before[p]))}
    new_j = dict(_flat(jax.tree.map(np.asarray, jst2.params["model"])))
    old_j = dict(_flat(jax.tree.map(np.asarray, jst.params["model"])))
    assert sorted(new_t) == sorted(new_j)
    for k in new_t:
        x = (new_t[k] - old_t[k]).astype(np.float64).ravel()
        y = (new_j[k] - old_j[k]).astype(np.float64).ravel()
        np.testing.assert_array_equal(old_t[k], old_j[k], err_msg=k)
        ny = np.linalg.norm(y)
        if ny == 0:
            assert np.linalg.norm(x) == 0, k
            continue
        rel = np.linalg.norm(x - y) / ny
        cos = float(x @ y) / (np.linalg.norm(x) * ny)
        assert rel <= STEP_L2 and cos >= STEP_COS, (k, rel, cos)
