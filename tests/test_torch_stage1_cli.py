"""The port's Stage-I training CLI (``sahs_tpu_torch/cli/train_stage1.py``)
on the CPU, the counterparts of ``tests/test_stage1_cli.py``'s training
half: train and resume from a checkpoint, the trainable-background
average init; and against the JAX package's CLI, run with its steps
replaced by stand-ins that only count (so nothing compiles): the same
frames picked in the same order (numpy's global generator seeded from the
config), the same ``[TRAIN]`` lines and ``metrics.jsonl`` keys. The
eval / metrics half of the JAX test waits for the port's eval CLI.
Tiny config: 64x64 synthetic frames, 32 rays, 4 + 4 samples, float32.
"""
import glob
import json
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sahs_tpu.cli import train_stage1 as jcli
from sahs_tpu.data import synthetic as jsynthetic
from sahs_tpu.data.common import average_background
from sahs_tpu.train import stage1 as jstage1
from sahs_tpu.utils import checkpoint as jck

from sahs_tpu_torch.cli import train_stage1 as tcli
from sahs_tpu_torch.data import synthetic as tsynthetic
from sahs_tpu_torch.models import nerface as tn
from sahs_tpu_torch.utils import checkpoint as tck
from sahs_tpu_torch.utils.weights import params_to_jax

torch.set_num_threads(2)

METRICS = ("loss", "psnr", "bg_loss", "coarse_l2", "fine_l2", "coarse_ce", "fine_ce")


def write_cfg(tmp_path, extra="", validate_every=0):
    cfg_path = str(tmp_path / "cfg.yml")
    with open(cfg_path, "w") as fp:
        fp.write(f"""
experiment:
  id: s1test
  logdir: {tmp_path}/log
  randomseed: 7
  print_every: 2
  save_every: 1000000
  validate_every: {validate_every}
dataset:
  type: audio
  basedir: {tmp_path}/nonexistent
  near: 0.2
  far: 2.0
nerf:
  train:
    num_random_rays: 32
    num_coarse: 4
    num_fine: 4
    chunksize: 4096
  validation:
    num_coarse: 4
    num_fine: 4
    chunksize: 4096
runtime:
  compute_dtype: float32
{extra}""")
    return cfg_path


def test_cli_trains_validates_saves_and_resumes(tmp_path, capsys):
    """Two launches of 2 steps and one single step to iteration 5, with a
    validation frame at 4; a resumed run goes on to 7 from the checkpoint
    at 5 with its parameters and Adam state (restored exactly)."""
    cfg_path = write_cfg(tmp_path, extra="  validate_frames: 1\n", validate_every=4)
    args = ["--config", cfg_path, "--synthetic", "--steps-per-launch", "2", "--device", "cpu"]
    state = tcli.main(args + ["--max-iters", "5"])
    logdir = str(tmp_path / "log" / "s1test")
    assert state.step == 5
    assert os.path.exists(os.path.join(logdir, "config.yml"))
    ckpt = os.path.join(logdir, "checkpoint0000005.ckpt")
    assert tck.is_native_checkpoint(ckpt)
    with open(os.path.join(logdir, "metrics.jsonl")) as fp:
        recs = [json.loads(line) for line in fp]
    assert [r["step"] for r in recs if "train/loss" in r] == [2, 4, 5]
    assert any("val/psnr" in r and np.isfinite(r["val/psnr"]) for r in recs)
    out = capsys.readouterr().out
    assert "[VAL] Iter: 4" in out and f"saved {ckpt}" in out
    resumed = tcli.main(args + ["--max-iters", "7", "--load-checkpoint", ckpt])
    assert resumed.step == 7
    ckpts = sorted(glob.glob(os.path.join(logdir, "checkpoint*.ckpt")))
    assert os.path.basename(ckpts[-1]) == "checkpoint0000007.ckpt"
    assert "resumed from" in capsys.readouterr().out
    # the checkpoint at 5 holds the first run's final state
    entries, schema = tck.load_checkpoint(ckpt)
    assert schema["scalars"]["iter"] == 5
    tree = params_to_jax(state.model)
    np.testing.assert_array_equal(entries["params|model/coarse/trunk/0/w"].numpy(),
                                  tree["coarse"]["trunk"][0]["w"])
    p = state.model.coarse.trunk.layers[0].weight
    np.testing.assert_array_equal(entries["opt|0/mu/model/coarse/trunk/0/w"].numpy(),
                                  state.optimizer.state[p]["exp_avg"].numpy().T)
    assert int(entries["opt|0/count"]) == 5


class _Recorder:
    """Wraps a dataset class's __getitem__ to record the indices read."""

    def __init__(self, monkeypatch, cls):
        self.read = []
        orig = cls.__getitem__

        def getitem(ds, idx):
            self.read.append((len(ds), int(idx)))
            return orig(ds, idx)
        monkeypatch.setattr(cls, "__getitem__", getitem)


def _fake_steps(monkeypatch, module, jax_side):
    """Stand-ins for the train steps that count and return fixed metrics."""
    metrics = {k: 0.25 + 0.01 * i for i, k in enumerate(METRICS)}

    def one(state, batch, *a, **kw):
        if jax_side:
            return state._replace(step=state.step + 1), {k: jnp.float32(v)
                                                         for k, v in metrics.items()}
        state.step += 1
        return state, {k: torch.tensor(v) for k, v in metrics.items()}

    def multi(state, batches, *a, **kw):
        K = batches["image"].shape[0]
        for _ in range(K):
            state, m = one(state, None)
        stack = (lambda v: jnp.full((K,), v)) if jax_side else (lambda v: v.repeat(K))
        return state, {k: stack(v) for k, v in m.items()}
    monkeypatch.setattr(module, "make_train_step", lambda *a, **kw: one)
    monkeypatch.setattr(jstage1 if jax_side else tcli, "make_multi_train_step",
                        lambda *a, **kw: multi)


def test_cli_picks_frames_and_logs_as_jax(tmp_path, monkeypatch, capsys):
    """Both CLIs with stand-in steps, 3 steps a launch to iteration 8 (two
    launches, then two single steps): the same frames read in the same
    order, the same [TRAIN] lines (rays/s aside) and metrics.jsonl keys."""
    runs = {}
    for name, cli, synth, module, jax_side in (
            ("jax", jcli, jsynthetic, jcli, True), ("port", tcli, tsynthetic, tcli, False)):
        with monkeypatch.context() as mp:
            rec = _Recorder(mp, synth.SyntheticFaceDataset)
            _fake_steps(mp, module, jax_side)
            os.makedirs(tmp_path / name)
            path = write_cfg(tmp_path / name)
            argv = ["--config", path, "--synthetic", "--max-iters", "8",
                    "--steps-per-launch", "3"] + (["--device", "cpu"] if not jax_side else [])
            cli.main(argv)
            out = capsys.readouterr().out
            with open(os.path.join(tmp_path, name, "log", "s1test", "metrics.jsonl")) as fp:
                keys = [sorted(k for k in json.loads(line) if k != "time") for line in fp]
            runs[name] = (rec.read, [re.sub(r"rays/s: [\d,]+", "", line)
                                     for line in out.splitlines() if line.startswith("[TRAIN]")],
                          keys)
    assert runs["port"][0] == runs["jax"][0] and len(runs["jax"][0]) > 8
    assert runs["port"][1] == runs["jax"][1] and len(runs["jax"][1]) == 3
    assert runs["port"][2] == runs["jax"][2]


def test_trainable_background_average_init(tmp_path, monkeypatch):
    """train_background on, fixed_background off: the trained background
    starts from the mean of the training frames, blurred as
    blur_background says (reference train_stage_rays_auto.py:143-157), as
    the JAX package's average_background gives it, and lives in the
    optimized parameters."""
    cfg_path = write_cfg(tmp_path, extra="""
  train_background: true
  fixed_background: false
  blur_background: true
  supervised_train_background: true
""")
    captured = {}
    orig = tcli.init_train_state

    def spy(spec, ts, background=None, **kw):
        captured["background"] = None if background is None else background.cpu().numpy().copy()
        captured["state"] = orig(spec, ts, background=background, **kw)
        return captured["state"]

    monkeypatch.setattr(tcli, "init_train_state", spy)
    tcli.main(["--config", cfg_path, "--synthetic", "--max-iters", "1", "--device", "cpu"])
    ds = jsynthetic.SyntheticFaceDataset(kind="audio", num_frames=8, H=64, W=64,
                                         near=0.2, far=2.0)
    imgs = np.stack([np.asarray(ds[j]["image"], np.float32) for j in range(len(ds))])
    bg = captured["background"]
    assert bg is not None and bg.shape == (64, 64, 15)
    np.testing.assert_allclose(bg, average_background(imgs, blur=True), atol=1e-5)
    st = captured["state"]
    assert st.background is not None
    assert any(p is st.background for g in st.optimizer.param_groups for p in g["params"])


def test_cli_imports_a_reference_checkpoint(tmp_path, monkeypatch):
    """--import-torch-checkpoint: the reference state dict's weights are
    in the model when training starts (the JAX package's importer reads
    the same file to the same tree), its sample_prob too."""
    cfg_path = write_cfg(tmp_path)
    model = tn.NeRFaceModel.init(tn.ModelSpec.from_config(tcli.load_config(cfg_path)),
                                 seed=5, device="cpu")
    spec = tn.ModelSpec.from_config(tcli.load_config(cfg_path))
    sd = tck.export_torch_state_dict(params_to_jax(model), spec)
    path = str(tmp_path / "ref.ckpt")
    torch.save({"model_state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
                "iter": 3, "sample_prob": torch.linspace(0.5, 1.5, 12)}, path)
    seen = {}

    def first_step(state, batch, *a, **kw):
        seen.setdefault("params", {k: v.copy() for k, v in
                                   params_to_jax(state.model)["coarse"]["trunk"][0].items()})
        seen.setdefault("sample_prob", state.sample_prob.clone())
        state.step += 1
        return state, {k: torch.tensor(0.5) for k in METRICS}
    monkeypatch.setattr(tcli, "make_train_step", lambda *a, **kw: first_step)
    tcli.main(["--config", cfg_path, "--synthetic", "--max-iters", "1", "--device", "cpu",
               "--import-torch-checkpoint", path])
    want = jck.import_torch_checkpoint(path, jax_spec(cfg_path))
    for k in ("w", "b"):
        np.testing.assert_array_equal(seen["params"][k],
                                      np.asarray(want["model"]["coarse"]["trunk"][0][k]))
    np.testing.assert_array_equal(seen["sample_prob"].numpy(), np.asarray(want["sample_prob"]))


def jax_spec(cfg_path):
    from sahs_tpu.config import load_config
    from sahs_tpu.models.nerface import ModelSpec
    return ModelSpec.from_config(load_config(cfg_path))


def test_cli_runs_on_cuda_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["--config", write_cfg(tmp_path), "--synthetic", "--max-iters", "1"])
