"""The port's Stage-II trainer (``sahs_tpu_torch/train/stage2.py``, its
checkpoints and CLIs) against the JAX package's on the CPU: one train
step's loss and every gradient leaf on the same weights and inputs (MSE
only, with and without audio; with a random-weight VGG perceptual term;
with the GAN and feature matching, the discriminator's step too), Adam
against optax's, the learning-rate schedule, checkpoints written by
either package resumed in the other, and ``train_stage2`` ->
``eval_stage2`` end to end on the synthetic fixture, with a resume.
Generators at 32 x 32 (64 x 64 with the discriminator, whose last conv
needs 4 x 4).

The loss, its terms and the buffers the train-mode forward leaves are
held in float32 against JAX's float64 run (within LOSS_RTOL; the buffers
to 1e-4), and in float64 on both sides to 1e-9. The gradients are held
in float64 on both sides (``jax.enable_x64``), leaf by leaf,
L2-relative to JAX's leaf (GRAD_RTOL): in float32 either package flips a
few leaky-ReLU kinks against a float64 run (6 of 3.8 M activations of the
GAN case's generator in the port, some in JAX's at 32 x 32) and moves the
leaves whose gradient is a cancelled sum by up to 8e-3 (the SPADE
blocks' biases), whichever side flips. A conv bias that feeds a batch or
instance norm has a zero gradient in exact arithmetic (the norm takes the
mean out), so both give rounding there: such a leaf is held by its norm,
below ZERO_LEAF_SHARE of the largest leaf's, in both.
"""
import copy
import glob
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from sahs_tpu.models import spade as js
from sahs_tpu.models import vgg as jvgg
from sahs_tpu.train import stage2 as jst
from sahs_tpu.utils import checkpoint as jck

from sahs_tpu_torch.models import spade as ts
from sahs_tpu_torch.models import vgg as tvgg
from sahs_tpu_torch.train import stage2 as tst
from sahs_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)

GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-5
ZERO_LEAF_SHARE = 1e-5


def _settings(**kw):
    base = dict(lr_G=2e-4, beta1=0.0, beta2=0.999, epochs=2, epochs_decay=2,
                steps_per_epoch=4, audio=False)
    base.update(kw)
    return base


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(seed=0, **kw):
    """The same initial state in both packages: JAX's init carried into
    the port's modules."""
    js_ = jst.Stage2Settings(**_settings(**kw))
    ts_ = tst.Stage2Settings(**_settings(**kw))
    jstate = jst.init_stage2_state(jax.random.PRNGKey(seed), js_)
    tstate = tst.init_stage2_state(ts_, device="cpu")
    ts.from_jax(tstate.generator, _np_tree(jstate.params), _np_tree(jstate.bufs))
    if ts_.use_gan:
        ts.from_jax(tstate.discriminator, _np_tree(jstate.d_params), _np_tree(jstate.d_bufs))
    return js_, ts_, jstate, tstate


def _inputs(seed=0, hw=32, audio=False):
    rng = np.random.RandomState(seed)
    out = [rng.rand(1, hw, hw, 3).astype(np.float32) for _ in range(3)]
    out.append(rng.randn(16, 29).astype(np.float32) if audio else None)
    return out


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _grad_tree(module, grads, params):
    gmap = {p: (g if g is not None else torch.zeros_like(p)) for p, g in zip(params, grads)}
    return ts.to_jax(module, "params", gmap.__getitem__)


def _check_grads(got, want):
    gl, gd = jax.tree_util.tree_flatten(got)
    wl, wd = jax.tree_util.tree_flatten(_np_tree(want))
    assert gd == wd
    top = max(float(np.linalg.norm(w)) for w in wl)
    worst = 0.0
    for path_g, a, b in zip(jax.tree_util.tree_flatten_with_path(got)[0], gl, wl):
        na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
        if nb <= ZERO_LEAF_SHARE * top:
            assert na <= ZERO_LEAF_SHARE * top, (path_g[0], na, nb, top)
            continue
        err = float(np.linalg.norm(np.asarray(a, np.float64) - b)) / nb
        worst = max(worst, err)
        assert err <= GRAD_RTOL, (jax.tree_util.keystr(path_g[0]), err)
    return worst


def _f64(tree):
    return jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64)), tree)


def _double(tstate):
    """A float64 copy of a port state (the same weights and buffers)."""
    st = copy.deepcopy(tstate)
    st.generator.double()
    if st.discriminator is not None:
        st.discriminator.double()
    return st


def _g_step_parity(js_, ts_, jstate, tstate, data, vgg_params=None, vgg_net=None):
    """The generator's loss, its terms and the buffers it leaves in float32
    against JAX's float64 run, and its gradients in float64 on both sides;
    returns the float64 state and fake for the D step."""
    src, raw, tgt, aud = data
    t64 = _double(tstate)
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        j64 = jstate._replace(params=_f64(jstate.params), bufs=_f64(jstate.bufs),
                              d_params=_f64(jstate.d_params), d_bufs=_f64(jstate.d_bufs))
        d = lambda x: None if x is None else jnp.asarray(np.asarray(x, np.float64))
        vp = None if vgg_params is None else _f64(vgg_params)
        (jl, (_, jbufs, jaux)), jgrads = jax.jit(jax.value_and_grad(
            lambda p: jst._g_losses(js_, p, j64, d(src), d(raw), d(tgt), d(aud), vp),
            has_aux=True))(j64.params)
        jl, jbufs, jaux, jgrads = float(jl), _np_tree(jbufs), _np_tree(jaux), _np_tree(jgrads)

    with torch.no_grad():
        loss, _, aux = tst.g_losses(ts_, tstate, _t(src), _t(raw), _t(tgt), _t(aud), vgg_net)
    assert abs(float(loss) - jl) <= LOSS_RTOL * abs(jl)
    assert set(aux) == set(jaux)
    for k in aux:
        assert abs(float(aux[k]) - float(jaux[k])) <= LOSS_RTOL * max(abs(float(jaux[k])), 1e-6), k
    for x, y in zip(jax.tree_util.tree_leaves(ts.to_jax(tstate.generator, "bufs")),
                    jax.tree_util.tree_leaves(jbufs)):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-6)

    dt = lambda x: None if x is None else torch.from_numpy(np.asarray(x, np.float64))
    net64 = None if vgg_net is None else copy.deepcopy(vgg_net).double()
    loss64, fake64, _ = tst.g_losses(ts_, t64, dt(src), dt(raw), dt(tgt), dt(aud), net64)
    assert abs(float(loss64.detach()) - jl) <= 1e-9 * abs(jl)
    params = list(t64.generator.parameters())
    grads = torch.autograd.grad(loss64, params, allow_unused=True)
    _check_grads(_grad_tree(t64.generator, grads, params), jgrads)
    for x, y in zip(jax.tree_util.tree_leaves(ts.to_jax(t64.generator, "bufs")),
                    jax.tree_util.tree_leaves(jbufs)):
        np.testing.assert_allclose(x, y, rtol=1e-9, atol=1e-12)
    return t64, fake64.detach()


@pytest.mark.parametrize("audio", [False, True])
def test_mse_step_gradients_match_jax(audio):
    js_, ts_, jstate, tstate = _pair(audio=audio)
    _g_step_parity(js_, ts_, jstate, tstate, _inputs(1, audio=audio))


def test_perceptual_step_gradients_match_jax():
    js_, ts_, jstate, tstate = _pair(use_perceptual=True, perceptual_weight=1.0)
    vp = jvgg.vgg19_features_init(jax.random.PRNGKey(7))
    net = tvgg.from_jax_params(_np_tree(vp))
    _g_step_parity(js_, ts_, jstate, tstate, _inputs(2), vgg_params=vp, vgg_net=net)


def test_gan_step_gradients_match_jax():
    """The GAN branch with feature matching: the generator's gradients
    through the discriminator in eval mode, then the discriminator's hinge
    step in train mode on the same fake (its gradients and buffers)."""
    js_, ts_, jstate, tstate = _pair(use_gan=True, gan_weight=0.05, gan_feat_weight=1.0)
    src, raw, tgt, _ = data = _inputs(3, hw=64)
    t64, fake64 = _g_step_parity(js_, ts_, jstate, tstate, data)

    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        d = lambda x: jnp.asarray(np.asarray(x, np.float64))
        fake_j = d(fake64.permute(0, 2, 3, 1).numpy())
        d_bufs = _f64(jstate.d_bufs)

        def jd_loss(dp):
            fr, db1 = js.discriminator_apply(dp, d_bufs, d(raw), d(tgt), train=True)
            ff, db2 = js.discriminator_apply(dp, db1, d(raw), fake_j, train=True)
            return (jnp.mean(jax.nn.relu(1.0 - fr[-1]))
                    + jnp.mean(jax.nn.relu(1.0 + ff[-1]))), db2

        (jl, jdb), jg = jax.jit(jax.value_and_grad(jd_loss, has_aux=True))(
            _f64(jstate.d_params))
        jl, jdb, jg = float(jl), _np_tree(jdb), _np_tree(jg)
    dt = lambda x: torch.from_numpy(np.asarray(x, np.float64))
    dl = tst.d_loss(t64, dt(raw), dt(tgt), fake64)
    assert abs(float(dl) - jl) <= 1e-9 * abs(jl)
    params = list(t64.discriminator.parameters())
    grads = torch.autograd.grad(dl, params)
    _check_grads(_grad_tree(t64.discriminator, grads, params), jg)
    for a, b in zip(jax.tree_util.tree_leaves(ts.to_jax(t64.discriminator, "bufs")),
                    jax.tree_util.tree_leaves(jdb)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


def test_gan_train_step_updates_both_networks():
    """train_step with the GAN: the metrics JAX's step reports, and both
    networks' parameters moved."""
    _, ts_, _, tstate = _pair(use_gan=True, gan_weight=0.05, gan_feat_weight=1.0)
    src, raw, tgt, _ = _inputs(4, hw=64)
    g0 = [p.detach().clone() for p in tstate.generator.parameters()]
    d0 = [p.detach().clone() for p in tstate.discriminator.parameters()]
    tstate, m = tst.make_train_step(ts_)(tstate, _t(src), _t(raw), _t(tgt))
    assert set(m) == {"loss", "psnr", "mse", "g_adv", "gan_feat", "d_loss"}
    assert tstate.step == 1 and tst.adam_count(tstate.opt) == tst.adam_count(tstate.d_opt) == 1
    assert all(np.isfinite(float(v)) for v in m.values())
    for before, after in ((g0, tstate.generator.parameters()),
                          (d0, tstate.discriminator.parameters())):
        assert max(float((a.detach() - b).abs().max()) for a, b in zip(after, before)) > 0


def test_adam_matches_optax():
    """The port's Adam step (torch's Adam through ``adam_step``) against
    optax.adam with the stage's schedule, over steps that cross into the
    decay, b1 = 0 (the config's default) and b1 = 0.5; a None gradient is
    a zero one."""
    rng = np.random.RandomState(8)
    for b1 in (0.0, 0.5):
        s = tst.Stage2Settings(**_settings(beta1=b1, epochs=1, epochs_decay=1,
                                           steps_per_epoch=3))
        sj = jst.Stage2Settings(**_settings(beta1=b1, epochs=1, epochs_decay=1,
                                            steps_per_epoch=3))
        p0 = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
        tp = [torch.from_numpy(p.copy()) for p in p0]
        opt, schedule = tst.make_adam(tp, s), tst._schedule(s, s.lr_G)
        jopt = jst.make_optimizer(sj)
        jp = [jnp.asarray(p) for p in p0]
        jstate = jopt.init(jp)
        for k in range(7):
            g = [rng.randn(*p.shape).astype(np.float32) for p in p0]
            if k == 2:
                g[1] = np.zeros_like(g[1])
            tst.adam_step(opt, schedule, [torch.from_numpy(g[0]),
                                          None if k == 2 else torch.from_numpy(g[1])])
            upd, jstate = jopt.update([jnp.asarray(x) for x in g], jstate, jp)
            jp = optax.apply_updates(jp, upd)
            for a, b in zip(tp, jp):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-7)
        assert tst.adam_count(opt) == int(jstate[0].count) == int(jstate[1].count)
        for a, b in zip((opt.state[p]["exp_avg_sq"] for p in tp), jstate[0].nu):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_schedule_equals_jax():
    s = tst.Stage2Settings(**_settings(epochs=3, epochs_decay=5, steps_per_epoch=7))
    sj = jst.Stage2Settings(**_settings(epochs=3, epochs_decay=5, steps_per_epoch=7))
    for lr in (1e-4, 2e-4, 3.3e-5):
        f, jf = tst._schedule(s, lr), jax.jit(jst._schedule(sj, lr))
        for step in (0, 1, 20, 21, 22, 30, 55, 56, 57, 100):
            assert f(step) == np.float32(jf(jnp.asarray(step, jnp.int32))), (lr, step)


def _assert_states_equal(a, b):
    for sa, sb in zip(tck.stage2_sections(a).values(), tck.stage2_sections(b).values()):
        la, lb = jax.tree_util.tree_leaves(sa), jax.tree_util.tree_leaves(sb)
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("gan", [False, True])
def test_checkpoints_both_ways(tmp_path, gan):
    """The port's sections restore in JAX (its CLI's templates) leaf for
    leaf, JAX's sections restore in the port, and a resumed step equals an
    uninterrupted one bit for bit."""
    kw = dict(use_gan=True, gan_weight=0.05, gan_feat_weight=1.0) if gan else {}
    hw = 64 if gan else 32
    js_, ts_, jstate, tstate = _pair(**kw)
    step = tst.make_train_step(ts_)
    data = [_t(x) for x in _inputs(5, hw=hw)[:3]]
    tstate, _ = step(tstate, *data)

    # port -> JAX
    path = str(tmp_path / "port.ckpt")
    tck.save_sections(path, tck.stage2_sections(tstate), scalars={"epoch": 0, "step": tstate.step})
    templates = {"opt": jstate.opt_state}
    if gan:
        templates["d_opt"] = jstate.d_opt_state
    sections, scalars = jck.restore_sections(path, templates=templates)
    assert scalars["step"] == 1
    want = tck.stage2_sections(tstate)
    for name in want:
        got = sections[name]
        assert jax.tree_util.tree_structure(jax.tree.map(np.asarray, got)) == \
            jax.tree_util.tree_structure(
                jax.tree.map(np.asarray, jstate.opt_state if name == "opt" else
                             jstate.d_opt_state if name == "d_opt" else want[name]))
        for x, y in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want[name])):
            np.testing.assert_array_equal(np.asarray(x), y)

    # JAX -> port
    jpath = str(tmp_path / "jax.ckpt")
    jsec = {"params": jstate.params, "bufs": jstate.bufs, "opt": jstate.opt_state}
    if gan:
        jsec.update(d_params=jstate.d_params, d_bufs=jstate.d_bufs, d_opt=jstate.d_opt_state)
    jck.save_sections(jpath, jsec, scalars={"epoch": 0, "step": 0})
    fresh = tst.init_stage2_state(ts_, seed=3, device="cpu")
    fresh, _ = tck.restore_stage2_state(jpath, fresh)
    ref = _pair(**kw)[3]
    _assert_states_equal(fresh, ref)

    # a resumed step equals an uninterrupted one
    again = tst.init_stage2_state(ts_, seed=4, device="cpu")
    again, _ = tck.restore_stage2_state(path, again)
    _assert_states_equal(again, tstate)
    data2 = [_t(x) for x in _inputs(6, hw=hw)[:3]]
    a, ma = step(tstate, *data2)
    b, mb = step(again, *data2)
    _assert_states_equal(a, b)
    assert torch.equal(ma["loss"], mb["loss"])


def test_scan_step_equals_single_steps():
    _, ts_, _, a = _pair()
    b = _pair()[3]
    src, raw, tgt, _ = _inputs(7)
    rng = np.random.RandomState(9)
    raws = torch.from_numpy(rng.rand(3, 1, 32, 32, 3).astype(np.float32))
    tgts = torch.from_numpy(rng.rand(3, 1, 32, 32, 3).astype(np.float32))
    a, ms = tst.make_scan_step(ts_)(a, _t(src), raws, tgts)
    losses = []
    for k in range(3):
        b, m = tst.make_train_step(ts_)(b, _t(src), raws[k], tgts[k])
        losses.append(m["loss"])
    assert ms["loss"].shape == (3,)
    assert torch.equal(ms["loss"], torch.stack(losses))
    _assert_states_equal(a, b)


def test_perceptual_needs_weights(monkeypatch):
    with pytest.raises(ValueError):
        tst.load_vgg_params("", device="cpu")
    assert tst.load_vgg_params("", allow_random=True, device="cpu") is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tst.load_vgg_params("", allow_random=True)


def test_vgg_importer_reads_torchvision_keys(tmp_path):
    vp = _np_tree(jvgg.vgg19_features_init(jax.random.PRNGKey(1)))
    net = tvgg.from_jax_params(vp)
    convs = [m for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    idx = [item[1] for sl in tvgg.VGG19_SLICES for item in sl if item != "pool"]
    sd = {}
    for i, c in zip(idx, convs):
        sd[f"features.{i}.weight"] = c.weight.detach().clone()
        sd[f"features.{i}.bias"] = c.bias.detach().clone()
    path = str(tmp_path / "vgg.pth")
    torch.save(sd, path)
    loaded = tst.load_vgg_params(path, device="cpu")
    x = torch.from_numpy(np.random.RandomState(2).rand(1, 3, 32, 32).astype(np.float32))
    want = jvgg.vgg19_slice_features(jvgg.import_torch_vgg_features(sd),
                                     jnp.asarray(x.permute(0, 2, 3, 1).numpy()))
    for a, b in zip(tvgg.vgg19_slice_features(loaded, x), want):
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(), np.asarray(b),
                                   rtol=1e-4, atol=1e-4 * float(np.abs(np.asarray(b)).max()))


def _write_cfg(tmp_path, basedir, renders):
    cfg_path = str(tmp_path / "cfg.yml")
    with open(cfg_path, "w") as fp:
        fp.write(f"""
experiment:
  id: s2test
  logdir: {tmp_path}/log
dataset:
  type: audio
  basedir: {basedir}
texture_refine:
  lr_G: 0.0001
  texture_photo: "{basedir}/com_imgs/0.jpg"
  train_basedir: "{renders}"
  test_basedir: "{renders}"
  val_basedir: "{renders}"
  train_num: 3
  test_num: 3
  val_num: 3
  epochs: 1
  epochs_decay: 0
  log_iters: 1
  scan_frames: 2
""")
    return cfg_path


def test_train_and_eval_clis_end_to_end(tmp_path, capsys):
    """train_stage2 one epoch (chunks of 2 frames over 3, the last wrapping
    round), a checkpoint; a resumed run goes on from it; eval_stage2
    writes every refined frame under its source name; JAX's eval CLI reads
    the port's checkpoint and writes frames within one uint8 level."""
    import shutil
    from sahs_tpu.cli import eval_stage2 as jeval
    from sahs_tpu_torch.cli import eval_stage2 as teval
    from sahs_tpu_torch.cli import train_stage2 as ttrain
    from sahs_tpu_torch.data.synthetic import write_synthetic_dataset
    from sahs_tpu_torch.utils.images import imread

    basedir = str(tmp_path / "audio_ds")
    write_synthetic_dataset(basedir, kind="audio", num_frames=3, H=32, W=32)
    renders = str(tmp_path / "renders")
    os.makedirs(renders)
    for i in range(3):
        shutil.copy(os.path.join(basedir, "com_imgs", f"{i}.jpg"),
                    os.path.join(renders, f"{i}.jpg"))
    cfg_path = _write_cfg(tmp_path, basedir, renders)

    state = ttrain.main(["--config", cfg_path, "--max-epochs", "1", "--device", "cpu"])
    assert state.step == 4           # 2 chunks of 2 frames
    out = capsys.readouterr().out
    assert "[S2] epoch 0 it 0" in out and "[S2 VAL] epoch 0 PSNR" in out
    logdir = str(tmp_path / "log" / "s2test_stage2")
    ckpt = os.path.join(logdir, "checkpoint_ep0000.ckpt")
    assert os.path.exists(ckpt)

    resumed = ttrain.main(["--config", cfg_path, "--max-epochs", "1", "--device", "cpu",
                           "--load-checkpoint", ckpt])
    assert resumed.step == 8 and "resumed stage-2 from" in capsys.readouterr().out

    outdir = str(tmp_path / "refined")
    written = teval.main(["--config", cfg_path, "--checkpoint", ckpt, "--savedir", outdir,
                          "--device", "cpu"])
    assert sorted(os.path.basename(w) for w in written) == ["0.jpg", "1.jpg", "2.jpg"]
    for w in written:
        img = imread(w)
        assert img.shape == (32, 32, 3)

    joutdir = str(tmp_path / "refined_jax")
    jeval.main(["--config", cfg_path, "--checkpoint", ckpt, "--savedir", joutdir])
    import imageio.v2 as imageio
    for w in written:
        a = imageio.imread(w).astype(int)
        b = imageio.imread(os.path.join(joutdir, os.path.basename(w))).astype(int)
        # JPEG at the same quality on renders one level apart
        assert np.abs(a - b).max() <= 3
    assert glob.glob(os.path.join(logdir, "metrics.jsonl"))


def test_clis_need_cuda_unless_told(tmp_path, monkeypatch):
    from sahs_tpu_torch.cli import eval_stage2 as teval
    from sahs_tpu_torch.cli import train_stage2 as ttrain
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, extra in ((ttrain.main, []), (teval.main, ["--checkpoint", "x", "--savedir", "y"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--config", "unused.yml"] + extra)


def test_train_step_and_infer_run_in_full_float32():
    """train_step and infer turn TF32 off for their own convolutions and
    products (the JAX package computes Stage II in float32) and give the
    process's settings back after."""
    _, ts_, _, tstate = _pair()
    seen = []
    tstate.generator.register_forward_hook(lambda *_: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())))
    saved = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        src, raw, tgt, _ = _inputs(10)
        tst.make_infer(ts_)(tstate.generator, _t(src), _t(raw))
        tst.make_train_step(ts_)(tstate, _t(src), _t(raw), _t(tgt))
        after = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    assert seen == [(False, "highest")] * 2
    assert after == (True, "high")
