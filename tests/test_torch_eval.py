"""The port's Stage-I evaluation (``sahs_tpu_torch/evaluation.py`` and
``cli/eval_stage1.py``) against the JAX package's on the CPU: each host
function on the same arrays (exact, or within 1e-6 where float32 math
meets another summation order), ``evaluate_dataset`` with and without
latent codes and with ``frontalize`` (every output file against JAX's on
the same weights, at most one uint8 level apart; the point clouds within
DEPTH_TOL), and the eval CLI on a checkpoint that JAX's ``save_checkpoint``
wrote and on a reference-layout torch checkpoint, against JAX's CLI on
the same files (the weights scaled by WEIGHT_SCALE). Tiny configs: 8 x 8 and 64 x 64 frames, 4 + 4 samples,
the plain path in float32.
"""
import glob
import os

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sahs_tpu import evaluation as jev
from sahs_tpu.config import Config as JConfig
from sahs_tpu.models.nerface import ModelSpec as JSpec
from sahs_tpu.models.nerface import init_model_params

from sahs_tpu_torch import evaluation as tev
from sahs_tpu_torch.config import Config as TConfig
from sahs_tpu_torch.models import nerface as tn
from sahs_tpu_torch.utils.weights import params_from_jax

torch.set_num_threads(2)

# The weights' scale: untrained renders are near constant, so the weights
# are scaled until pose and latent code show in uint8 (the JAX test takes
# 3). The scale comes back raised to the trunk's 8 layers: at 3 the two
# packages' float32 coarse colours sit up to 4e-3 apart (summation order)
# and a deterministic fine sample lands in another bin (19 levels at one
# pixel); at 2 the colours agree to 1e-5 but the depth, and the disparity
# image normalised by its largest value, move by up to 2e-3 (3 levels),
# each package's 0.7e-3 to 1.9e-3 from a float64 run; at 1.5 both render
# the same depths to the bit, and frames still differ by pose.
WEIGHT_SCALE = 1.5
DEPTH_TOL = 1e-5


def test_normal_map_matches_jax():
    rng = np.random.RandomState(0)
    # square, as the reference's (its Wd names the rows; a non-square map
    # does not broadcast in either package)
    disp = rng.rand(9, 9).astype(np.float32) + 0.5
    wmap = rng.rand(9, 9).astype(np.float32)
    intr = np.array([11.0, 13.0, 0.4, 0.6], np.float32)
    for w, clean, central in ((wmap, True, False), (wmap, True, True), (None, True, False),
                              (wmap, False, False)):
        got = tev.normal_map(disp, intr, w, clean=clean, central_difference=central)
        want = jev.normal_map(disp, intr, w, clean=clean, central_difference=central)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_point_cloud_and_ply_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    depth = rng.rand(6, 7).astype(np.float32) + 1.0
    intr = np.array([5.0, 6.0, 3.0, 2.5], np.float32)
    pose = np.concatenate([np.linalg.qr(rng.randn(3, 3))[0], rng.randn(3, 1)], 1).astype(np.float32)
    for p in (None, pose):
        np.testing.assert_allclose(tev.unproject_depth(depth, intr, p),
                                   jev.unproject_depth(depth, intr, p), rtol=1e-6, atol=1e-6)
    pts = tev.unproject_depth(depth, intr)
    tev.save_point_cloud(pts, str(tmp_path / "a.obj"))
    jev.save_point_cloud(pts, str(tmp_path / "b.obj"))
    assert open(tmp_path / "a.obj").read() == open(tmp_path / "b.obj").read()

    R, S = 32, 8
    xyz = rng.randn(R, S, 3).astype(np.float32)
    rf = rng.rand(R, S, 16).astype(np.float32)
    rf[..., 3] = -10.0
    rf[:16, :, 3] = 40.0
    for stride in (1, 3):
        n = tev.dump_rays(xyz, rf, str(tmp_path / "a.ply"), stride=stride)
        assert n == jev.dump_rays(xyz, rf, str(tmp_path / "b.ply"), stride=stride)
        assert open(tmp_path / "a.ply").read() == open(tmp_path / "b.ply").read()


def test_casts_and_error_image_match_jax():
    rng = np.random.RandomState(2)
    img = rng.randn(5, 6, 15).astype(np.float32)
    disp = rng.rand(5, 6).astype(np.float32) * 3
    gt = rng.rand(5, 6, 3).astype(np.float32)
    np.testing.assert_array_equal(tev.cast_to_image(img), jev.cast_to_image(img))
    np.testing.assert_array_equal(tev.cast_to_image(torch.from_numpy(img)), jev.cast_to_image(img))
    np.testing.assert_array_equal(tev.cast_to_disparity_image(disp),
                                  jev.cast_to_disparity_image(disp))
    np.testing.assert_array_equal(tev.cast_to_disparity_image(np.zeros((3, 3), np.float32)),
                                  jev.cast_to_disparity_image(np.zeros((3, 3), np.float32)))
    np.testing.assert_array_equal(tev.error_image(gt, img), jev.error_image(gt, img))


def test_select_eval_latent_code_matches_jax():
    codes = np.arange(20, dtype=np.float32).reshape(5, 4)
    maps = [None, np.zeros((11, 2), np.int64), np.zeros((4, 2), np.int64)]
    maps[1][10, 1] = 3
    maps[2][3, 1] = 2                      # short map: row 10 clamps to its last row
    bad = np.zeros((11, 2), np.int64)
    bad[10, 1] = 99                        # out of range: code 0
    for m in maps + [bad]:
        got = tev.select_eval_latent_code(codes, m)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jev.select_eval_latent_code(codes, m)))
    assert tev.select_eval_latent_code(None) is None


class _FakeDataset:
    """Two frames: identical driving, different poses (the JAX test's)."""

    H = W = 8

    def __init__(self):
        rng = np.random.RandomState(0)
        self.driving = rng.randn(16, 29).astype(np.float32)
        Rm1 = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
        self.poses = [
            np.concatenate([np.eye(3, dtype=np.float32), np.array([[0], [0], [0.6]], np.float32)], 1),
            np.concatenate([Rm1, np.array([[0], [0], [0.7]], np.float32)], 1)]
        self.img = rng.rand(self.H, self.W, 3).astype(np.float32)

    def __len__(self):
        return 2

    def __getitem__(self, i):
        return {"image": self.img, "pose": self.poses[i],
                "intrinsics": np.array([10.0, 10.0, 0.5, 0.5], np.float32),
                "driving": self.driving, "fname": f"{i}.png"}


def _tiny(cls, latent):
    cfg = cls()
    cfg.nerf.validation.num_coarse = 4
    cfg.nerf.validation.num_fine = 4
    cfg.nerf.validation.chunksize = 4096
    cfg.runtime.use_pallas = False
    cfg.runtime.compute_dtype = "float32"
    if latent:
        cfg.models.mask.latent_code_dim = 32
    return cfg


def _assert_outputs_match(got_dir, want_dir):
    """Every file JAX wrote, in the port's directory too: images at most
    one uint8 level apart, point clouds within DEPTH_TOL."""
    want = sorted(os.path.relpath(p, want_dir) for p in glob.glob(f"{want_dir}/**/*.*",
                                                                    recursive=True))
    got = sorted(os.path.relpath(p, got_dir) for p in glob.glob(f"{got_dir}/**/*.*",
                                                                  recursive=True))
    assert got == want and want
    for rel in want:
        a, b = os.path.join(got_dir, rel), os.path.join(want_dir, rel)
        if rel.endswith(".obj"):
            pa = np.array([l.split()[1:] for l in open(a).read().splitlines()], np.float64)
            pb = np.array([l.split()[1:] for l in open(b).read().splitlines()], np.float64)
            np.testing.assert_allclose(pa, pb, rtol=0, atol=DEPTH_TOL)
        else:
            ia, ib = imageio.imread(a).astype(int), imageio.imread(b).astype(int)
            assert ia.shape == ib.shape, rel
            assert np.abs(ia - ib).max() <= 1, rel


@pytest.mark.parametrize("latent", [False, True])
def test_evaluate_dataset_matches_jax(tmp_path, latent):
    """With and without latent codes, and frontalized: the port's files
    against JAX's, every output switched on."""
    jcfg, tcfg = _tiny(JConfig, latent), _tiny(TConfig, latent)
    jspec, tspec = JSpec.from_config(jcfg), tn.ModelSpec.from_config(tcfg)
    params = jax.tree.map(lambda x: x * WEIGHT_SCALE,
                          init_model_params(jax.random.PRNGKey(0), jspec))
    model = params_from_jax(tn.NeRFaceModel.init(tspec, device="cpu"),
                            jax.tree.map(np.asarray, params))
    codes = (np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 32)))
             if latent else None)
    ds = _FakeDataset()
    kw = dict(deterministic=True, save_disparity=True, save_error=True, save_mesh=True,
              latent_codes=codes)
    for name, extra in (("plain", {}), ("front", {"frontalize": True})):
        jdir, tdir = str(tmp_path / f"jax_{name}"), str(tmp_path / f"port_{name}")
        jev.evaluate_dataset(jcfg, jspec, params, ds, jdir, **kw, **extra)
        times = tev.evaluate_dataset(tcfg, tspec, model, ds, tdir, device="cpu", **kw, **extra)
        assert len(times) == 2
        _assert_outputs_match(tdir, jdir)
    f0, f1 = (imageio.imread(str(tmp_path / f"port_front/{i}.png")) for i in (0, 1))
    np.testing.assert_array_equal(f0, f1)
    p0, p1 = (imageio.imread(str(tmp_path / f"port_plain/{i}.png")) for i in (0, 1))
    assert np.any(p0 != p1)           # the pose shows


def _cli_cfg(tmp_path):
    cfg_path = str(tmp_path / "cfg.yml")
    with open(cfg_path, "w") as fp:
        fp.write(f"""
experiment:
  id: evtest
  logdir: {tmp_path}/log
dataset:
  type: audio
  basedir: {tmp_path}/nonexistent
  near: 0.2
  far: 2.0
models:
  mask:
    latent_code_dim: 32
nerf:
  validation:
    num_coarse: 4
    num_fine: 4
    chunksize: 4096
runtime:
  use_pallas: False
  compute_dtype: float32
""")
    return cfg_path


def _run_both_clis(tmp_path, cfg_path, ckpt, tag):
    from sahs_tpu.cli import eval_stage1 as jcli
    from sahs_tpu_torch.cli import eval_stage1 as tcli
    args = ["--config", cfg_path, "--checkpoint", ckpt, "--synthetic", "--limit", "2",
            "--deterministic", "--save-disparity-image", "--save-error-image", "--save-mesh"]
    jdir, tdir = str(tmp_path / f"jax_{tag}"), str(tmp_path / f"port_{tag}")
    jcli.main(args + ["--savedir", jdir])
    tcli.main(args + ["--savedir", tdir, "--device", "cpu"])
    _assert_outputs_match(tdir, jdir)
    assert os.path.exists(os.path.join(tdir, "f_0001.png"))


def test_eval_cli_on_a_jax_checkpoint(tmp_path):
    """A checkpoint JAX's save_checkpoint wrote (its latent codes and
    background in it), through both CLIs."""
    from sahs_tpu.config import load_config
    from sahs_tpu.train import stage1 as jstage1
    from sahs_tpu.utils import checkpoint as jck
    cfg_path = _cli_cfg(tmp_path)
    cfg = load_config(cfg_path)
    spec, ts = JSpec.from_config(cfg), jstage1.TrainSettings.from_config(cfg)
    bg = np.random.RandomState(3).rand(64, 64, 15).astype(np.float32)
    st = jstage1.init_train_state(jax.random.PRNGKey(0), spec, ts, num_latent_frames=4)
    st = st._replace(params={**st.params,
                             "model": jax.tree.map(lambda x: x * WEIGHT_SCALE,
                                                   st.params["model"]),
                             "latent_codes": jax.random.normal(jax.random.PRNGKey(2), (4, 32))})
    path = str(tmp_path / "jax.ckpt")
    jck.save_checkpoint(path, st, extras={"background": jnp.asarray(bg)})
    _run_both_clis(tmp_path, cfg_path, path, "native")


def test_eval_cli_on_a_reference_torch_checkpoint(tmp_path):
    from sahs_tpu_torch.config import load_config
    from sahs_tpu_torch.utils import checkpoint as tck
    from sahs_tpu_torch.utils.weights import params_to_jax
    cfg_path = _cli_cfg(tmp_path)
    spec = tn.ModelSpec.from_config(load_config(cfg_path))
    model = tn.NeRFaceModel.init(spec, seed=4, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(WEIGHT_SCALE)
    sd = tck.export_torch_state_dict(params_to_jax(model), spec)
    path = str(tmp_path / "ref.ckpt")
    torch.save({"model_state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
                "iter": 3, "latent_codes": torch.randn(4, 32)}, path)
    _run_both_clis(tmp_path, cfg_path, path, "ref")


def test_eval_cli_runs_on_cuda_unless_told(tmp_path, monkeypatch):
    from sahs_tpu_torch.cli import eval_stage1 as tcli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["--config", _cli_cfg(tmp_path), "--checkpoint", "x", "--savedir",
                   str(tmp_path / "out"), "--synthetic"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tev.evaluate_dataset(_tiny(TConfig, False), None, None, _FakeDataset(),
                             str(tmp_path / "out2"))
