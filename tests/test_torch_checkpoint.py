"""The port's checkpoints (``sahs_tpu_torch/utils/checkpoint.py``) against
the JAX package's (``sahs_tpu/utils/checkpoint.py``): the Stage-I cases
of ``tests/test_checkpoint.py`` (sections, bf16 leaves, a corrupt file, a
structure mismatch, the reference state-dict export and import), and a
checkpoint written by either package resumed in the other with equal
parameters, Adam moments and counts. Every comparison is exact: the
checkpoint moves float32 bits, and the two layouts differ only by
transposes. A resumed port step equals an uninterrupted one bit for bit
(the same draws, the same arithmetic on the same bits).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sahs_tpu.config import Config
from sahs_tpu.models import nerface as jn
from sahs_tpu.train import stage1 as jstage1
from sahs_tpu.utils import checkpoint as jck

from sahs_tpu_torch.config import Config as TConfig
from sahs_tpu_torch.data.synthetic import SyntheticFaceDataset
from sahs_tpu_torch.models import nerface as tn
from sahs_tpu_torch.train import stage1 as tstage1
from sahs_tpu_torch.train.fused import TrainDraws
from sahs_tpu_torch.utils import checkpoint as tck
from sahs_tpu_torch.utils.weights import params_to_jax

torch.set_num_threads(2)

FRAMES = 3


def _cfg(cls, models=()):
    """A Stage-I config with a trained background and latent codes (every
    section of the train state), 64 rays and 8 + 8 samples, float32."""
    cfg = cls()
    cfg.nerf.train.num_random_rays = 64
    cfg.nerf.train.num_coarse = 8
    cfg.nerf.train.num_fine = 8
    cfg.runtime.compute_dtype = "float32"
    cfg.runtime.train_background = True
    cfg.runtime.train_latent_codes = True
    for (sub, field), v in models:
        setattr(getattr(cfg.models, sub), field, v)
    return cfg


def _bg(seed=0):
    return np.random.RandomState(seed).rand(8, 8, 15).astype(np.float32)


def _jax_state():
    cfg = _cfg(Config)
    spec, ts = jn.ModelSpec.from_config(cfg), jstage1.TrainSettings.from_config(cfg)
    st = jstage1.init_train_state(jax.random.PRNGKey(0), spec, ts,
                                  background=jnp.asarray(_bg()), num_latent_frames=FRAMES)
    return spec, ts, st


def _port_state(seed=1, models=()):
    cfg = _cfg(TConfig, models)
    spec, ts = tn.ModelSpec.from_config(cfg), tstage1.TrainSettings.from_config(cfg)
    st = tstage1.init_train_state(spec, ts, seed=seed, background=_bg(seed),
                                  device="cpu", num_latent_frames=FRAMES)
    return spec, ts, st


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, _np(tree)


def _assert_trees_equal(a, b):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert sorted(fa) == sorted(fb)
    for k, v in fa.items():
        np.testing.assert_array_equal(v, fb[k], err_msg=k)


def _port_tree(st, get=lambda p: p):
    tree = {"model": params_to_jax(st.model, get)}
    for name in ("background", "latent_codes"):
        tree[name] = _np(get(getattr(st, name)))
    return tree


def _moment(st, name):
    """A parameter's Adam moment, zeros where Adam keeps no state for it
    (as the checkpoint writes it)."""
    return lambda p: st.optimizer.state[p][name] if p in st.optimizer.state \
        else torch.zeros_like(p)


def test_sections_roundtrip(tmp_path):
    tree = {"a": [{"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                   "b": torch.zeros(3)}],
            "nested": {"x": np.ones((4,), np.float32)}}
    bufs = {"u": np.full((5,), 2.0, np.float32)}
    path = str(tmp_path / "c.ckpt")
    tck.save_sections(path, {"params": tree, "bufs": bufs}, scalars={"epoch": 3, "step": 17})
    assert tck.is_native_checkpoint(path)
    sections, scalars = tck.restore_sections(path)
    assert scalars == {"epoch": 3, "step": 17}
    assert isinstance(sections["params"]["a"], list)
    _assert_trees_equal(sections["params"], tree)
    _assert_trees_equal(sections["bufs"], bufs)
    # and the JAX package reads it as its own
    jsections, jscalars = jck.restore_sections(path)
    assert jscalars == scalars
    _assert_trees_equal(jax.tree.map(np.asarray, jsections["params"]), tree)


def test_bf16_leaves_roundtrip_both_ways(tmp_path):
    w = torch.linspace(-2, 2, 8).to(torch.bfloat16)
    path = str(tmp_path / "b.ckpt")
    tck.save_sections(path, {"params": {"w": w}})
    got = tck.restore_sections(path)[0]["params"]["w"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, w)
    jgot = jck.restore_sections(path)[0]["params"]["w"]
    assert jgot.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jgot, np.float32), w.float().numpy())
    jpath = str(tmp_path / "j.ckpt")
    jck.save_sections(jpath, {"params": {"w": jnp.asarray(w.float().numpy(), jnp.bfloat16)}})
    got = tck.restore_sections(jpath)[0]["params"]["w"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, w)


def test_corrupt_file_raises_clear_error(tmp_path):
    path = str(tmp_path / "junk.ckpt")
    with open(path, "wb") as fp:
        fp.write(b"\x80\x04 this is not a checkpoint")
    assert not tck.is_native_checkpoint(path)
    with pytest.raises(tck.CheckpointError):
        tck.load_checkpoint(path)
    torch.save({"iter": 1}, str(tmp_path / "t.ckpt"))        # a zip without the schema
    assert not tck.is_native_checkpoint(str(tmp_path / "t.ckpt"))
    with pytest.raises(tck.CheckpointError):
        tck.load_checkpoint(str(tmp_path / "t.ckpt"))


def test_structure_mismatch_raises(tmp_path):
    path = str(tmp_path / "c.ckpt")
    tck.save_sections(path, {"opt": {"m": np.zeros(3, np.float32)}})
    with pytest.raises(tck.CheckpointError):
        tck.restore_sections(path, templates={"opt": {"m": np.zeros(3), "extra": np.zeros(2)}})
    # a warp-only model's train state into the flagship's: no hyper net
    _, _, other = _port_state(models=((("hyper", "use_ambient"), False),))
    tck.save_checkpoint(path, other)
    _, _, st = _port_state()
    with pytest.raises(tck.CheckpointError, match="hyper"):
        tck.restore_train_state(path, st)
    tck.save_checkpoint(path, st)
    # the same keys at another shape: a latent-code table of more frames
    cfg = _cfg(TConfig)
    more = tstage1.init_train_state(tn.ModelSpec.from_config(cfg),
                                    tstage1.TrainSettings.from_config(cfg), background=_bg(),
                                    device="cpu", num_latent_frames=FRAMES + 1)
    with pytest.raises(tck.CheckpointError, match="latent_codes"):
        tck.restore_train_state(path, more)


def test_jax_flattened_optimizer_checkpoint_raises(tmp_path, monkeypatch):
    """A checkpoint the JAX package wrote under SAHS_OPT_FLATTEN=1 (one
    raveled mu and nu) restores into the port; the same file with a
    raveled moment one element short raises, naming the entry."""
    monkeypatch.setenv("SAHS_OPT_FLATTEN", "1")
    cfg = _cfg(Config)
    spec, ts = jn.ModelSpec.from_config(cfg), jstage1.TrainSettings.from_config(cfg)
    jst = jstage1.init_train_state(jax.random.PRNGKey(0), spec, ts,
                                   background=jnp.asarray(_bg()), num_latent_frames=FRAMES)
    path = str(tmp_path / "flat.ckpt")
    jck.save_checkpoint(path, jst)
    _, _, st = _port_state()
    tck.restore_train_state(path, st)
    with np.load(path) as z:
        entries = {k: z[k] for k in z.files}
    entries["opt|0/mu"] = entries["opt|0/mu"][:-1]
    short = str(tmp_path / "short.ckpt")
    with open(short, "wb") as fp:
        np.savez(fp, **entries)
    _, _, st = _port_state()
    with pytest.raises(tck.CheckpointError, match="opt"):
        tck.restore_train_state(short, st)


def test_export_import_roundtrip_matches_jax(tmp_path):
    """export_torch_state_dict inverts import_torch_state_dict, and both
    give what the JAX package's give; import_torch_checkpoint reads a
    reference torch.save file as JAX's importer does."""
    spec_t, _, st = _port_state()
    spec_j = jn.ModelSpec.from_config(_cfg(Config))
    tree = params_to_jax(st.model)
    sd = tck.export_torch_state_dict(tree, spec_t)
    sd_j = jck.export_torch_state_dict(jax.tree.map(jnp.asarray, tree), spec_j)
    assert sorted(sd) == sorted(sd_j)
    for k in sd:
        np.testing.assert_array_equal(sd[k], sd_j[k], err_msg=k)
    _assert_trees_equal(tck.import_torch_state_dict(sd, spec_t), tree)
    ref = {"model_state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
           "iter": 12, "background": torch.from_numpy(_bg(3)),
           "sample_prob": torch.linspace(0.1, 1.0, 12), "pose_c": torch.eye(4)[:3],
           "height": 8, "width": 8}
    path = str(tmp_path / "ref.ckpt")
    torch.save(ref, path)
    got, want = tck.import_torch_checkpoint(path, spec_t), jck.import_torch_checkpoint(path, spec_j)
    assert sorted(got) == sorted(want)
    _assert_trees_equal(got["model"], jax.tree.map(np.asarray, want["model"]))
    for k in ("background", "sample_prob", "pose_c"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
    assert (got["iter"], got["height"], got["width"]) == (12, 8, 8)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX train state with drawn Adam moments (count 5, iter 5) saved by
    the JAX package: the port restores every parameter, moment and count
    exactly, in its own layout."""
    spec, ts, jst = _jax_state()
    rng = np.random.RandomState(2)
    draw = lambda x: jnp.asarray(rng.rand(*x.shape).astype(np.float32))
    adam, sched = jst.opt_state
    adam = adam._replace(count=jnp.asarray(5, jnp.int32), mu=jax.tree.map(draw, adam.mu),
                         nu=jax.tree.map(draw, adam.nu))
    jst = jst._replace(step=jnp.asarray(5, jnp.int32), params=jax.tree.map(draw, jst.params),
                       opt_state=(adam, sched._replace(count=jnp.asarray(5, jnp.int32))),
                       sample_prob=draw(jst.sample_prob))
    path = str(tmp_path / "j.ckpt")
    jck.save_checkpoint(path, jst, extras={"pose_c": jnp.eye(4)[:3], "height": 8})
    _, _, st = _port_state()
    assert len(list(st.model.parameters())) == len(list(_flat(params_to_jax(st.model))))
    st, extras = tck.restore_train_state(path, st)
    assert st.step == 5 and extras["height"] == 8
    np.testing.assert_array_equal(_np(extras["pose_c"]), np.eye(4)[:3])
    _assert_trees_equal(_port_tree(st), jax.tree.map(np.asarray, jst.params))
    _assert_trees_equal(_port_tree(st, _moment(st, "exp_avg")),
                        jax.tree.map(np.asarray, adam.mu))
    _assert_trees_equal(_port_tree(st, _moment(st, "exp_avg_sq")),
                        jax.tree.map(np.asarray, adam.nu))
    assert {float(s["step"]) for s in st.optimizer.state.values()} == {5.0}
    np.testing.assert_array_equal(_np(st.sample_prob), np.asarray(jst.sample_prob))


def test_port_checkpoint_resumes_in_jax(tmp_path):
    """A port train state after two Adam steps of drawn gradients, saved by
    the port: JAX's restore_train_state takes it into its own template
    with every parameter, moment and count equal."""
    _, _, st = _port_state()
    rng = np.random.RandomState(3)
    params = [p for group in st.optimizer.param_groups for p in group["params"]]
    for _ in range(2):
        for p in params:
            p.grad = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
        st.optimizer.step()
        st.step += 1
    st.sample_prob = torch.from_numpy(rng.rand(12).astype(np.float32))
    path = str(tmp_path / "t.ckpt")
    tck.save_checkpoint(path, st, extras={"background": st.background, "height": 8})
    spec, ts, jst = _jax_state()
    jst, extras = jck.restore_train_state(path, jst)
    assert int(jst.step) == 2 and extras["height"] == 8
    adam, sched = jst.opt_state
    assert int(adam.count) == 2 and int(sched.count) == 2
    _assert_trees_equal(jax.tree.map(np.asarray, jst.params), _port_tree(st))
    _assert_trees_equal(jax.tree.map(np.asarray, adam.mu), _port_tree(st, _moment(st, "exp_avg")))
    _assert_trees_equal(jax.tree.map(np.asarray, adam.nu),
                        _port_tree(st, _moment(st, "exp_avg_sq")))
    np.testing.assert_array_equal(np.asarray(jst.sample_prob), _np(st.sample_prob))
    np.testing.assert_array_equal(np.asarray(extras["background"]), _np(st.background))


def _draws(seed, H, W, R=64, Sc=8, Sn=8):
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(rng.rand(*s).astype(np.float32))
    n = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    return TrainDraws(gumbel=torch.from_numpy(-np.log(-np.log(
        rng.rand(H * W).astype(np.float32) * 0.999 + 5e-4))),
        t_rand=t(R, Sc), u=t(R, Sn), noise_coarse=n(R, Sc), noise_fine=n(R, Sc + Sn))


def test_resumed_step_equals_uninterrupted(tmp_path):
    """Two port steps against one step, a checkpoint, a fresh state resumed
    from it and the second step on the same draws: the same parameters,
    moments, Adam counts, sample_prob and metrics, bit for bit; the
    learning rate goes on from the restored step. (The latent codes get no
    gradient here: Adam keeps no state for them, before and after.)"""
    spec, ts, st = _port_state()
    ts = dataclasses.replace(ts, lr_decay=1)          # a visible decay a step
    ds = SyntheticFaceDataset("audio", num_frames=FRAMES, H=8, W=8)
    items = [dict(ds[i], background=ds.background()) for i in (0, 2)]
    step = tstage1.make_train_step(spec, ts, device="cpu")
    st.lr_fn = tstage1.lr_schedule(ts)
    st, _ = step(st, items[0], draws=_draws(0, 8, 8))
    path = str(tmp_path / "mid.ckpt")
    tck.save_checkpoint(path, st)
    st, m_a = step(st, items[1], draws=_draws(1, 8, 8))
    _, _, fresh = _port_state(seed=9)
    fresh.lr_fn = tstage1.lr_schedule(ts)
    fresh, _ = tck.restore_train_state(path, fresh)
    assert fresh.step == 1
    fresh, m_b = step(fresh, items[1], draws=_draws(1, 8, 8))
    assert fresh.optimizer.param_groups[0]["lr"] == st.optimizer.param_groups[0]["lr"] \
        == tstage1.lr_schedule(ts)(1)
    _assert_trees_equal(_port_tree(fresh), _port_tree(st))
    for name in ("exp_avg", "exp_avg_sq"):
        _assert_trees_equal(_port_tree(fresh, _moment(fresh, name)),
                            _port_tree(st, _moment(st, name)))
    assert sorted(id(p) for p in fresh.optimizer.state) != []
    assert [float(fresh.optimizer.state[p]["step"]) if p in fresh.optimizer.state else None
            for p in fresh.optimizer.param_groups[0]["params"]] == \
        [float(st.optimizer.state[p]["step"]) if p in st.optimizer.state else None
         for p in st.optimizer.param_groups[0]["params"]]
    assert torch.equal(fresh.sample_prob, st.sample_prob)
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k
