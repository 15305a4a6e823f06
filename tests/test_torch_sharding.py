"""The port's data parallelism over rays (``parallel/mesh.py``, the ray
group of ``train/stage1.train_step`` and of the eval renderer), on the
CPU with gloo processes (``mesh.spawn_ranks``: spawn, a file:// rendezvous
under tmp_path, one thread a rank, a timeout on the group, every
collective and the join):

  (a) the sharded step at world size 2 and 4 against the port's single
      step, on the fused path and on the fallback, two steps with given
      full-width TrainDraws under SGD at the config's rate:
      tests/test_sharding.py's tolerances (loss rtol 2e-4, weights atol
      2e-5, sample_prob rtol 2e-4), each step's summed gradient leaf by
      leaf within GRAD_L2 of the single step's, and every rank's
      parameters equal bit for bit. SGD, because Adam's first step divides
      each gradient entry by its own size plus 1e-8: an entry near 1e-8
      moves its weight by a good part of the rate when the sums' order
      moves it by 1e-7 (5.9e-5 on coarse.trunk[0].w, against the 2e-5
      gate), whichever side is right;
  (b) world size 1 over a real group of one, under Adam: bit-equal to the
      single step (parameters, gradients, Adam's moments, metrics);
  (c) faults planted in one rank (its gradient left unreduced, its block
      one ray on, a normaliser of its block's own rays) miss (a)'s gates;
  (d) the 2-rank step against JAX's train_step on the same weights and
      JAX's draws (test_torch_train.py's one-step comparison and gates);
  (e) the 2-rank eval frame against the single frame
      (test_sharded_eval_render_matches_single_device's tolerances),
      deterministic and perturbed with sigma noise at a chunk of 51 rays
      (odd: the chunk is padded to the world size);
  (f) the eval CLI on 2 ranks (its own group, ``evaluate_dataset``'s
      default of the run's group): only rank 0 writes, and every file
      equals the single-process CLI's, perturbed and deterministic;
  (g) ``entry()`` finite, ``dryrun_multichip(4)`` and
      ``parallel/scaling.measure`` at 1 and 2 ranks on the CPU.
"""
import glob
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from sahs_tpu.data.synthetic import SyntheticFaceDataset
from sahs_tpu.models import nerface as jn
from sahs_tpu.train import stage1 as jstage1

from sahs_tpu_torch.parallel import mesh

import torch_dist_util as du
from test_torch_train import (OUT_RTOL, _jax_draws, _tree_pairs, assert_step_grads_close,
                              tiny_cfg)

torch.set_num_threads(2)

TIMEOUT_S = 300.0
RAYS, H = 48, 32
LR = 5e-4           # Config().optimizer.lr
gates_missed = du.gates_missed


@pytest.fixture(scope="module")
def case():
    items = du.tiny_items(2)
    draws = du.full_draws(0, H, H, RAYS)
    single = {path: du.run_steps(None, du.tiny_cfg(fused=path == "fused"), items,
                                 draws=draws, sgd=LR)
              for path in ("fused", "fallback")}
    return items, draws, single


@pytest.fixture(scope="module")
def runs(case, tmp_path_factory):
    items, draws, _ = case
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = mesh.spawn_ranks(
                du.paths_rank, world, (items, draws, "cpu", "float32", RAYS, world == 2, LR),
                device="cpu", timeout_s=TIMEOUT_S, workdir=str(tmp_path_factory.mktemp(f"w{world}")))
        return cache[world]
    return get


@pytest.mark.parametrize("path", ["fused", "fallback"])
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_step_matches_single_step(case, runs, world, path):
    _, _, single = case
    res = runs(world)
    assert len(res) == world
    assert gates_missed([r[path] for r in res], single[path]) == []
    assert res[0][path][-1]["step"] == 2


@pytest.mark.parametrize("fault", du.FAULTS)
def test_planted_faults_miss_the_gates(case, runs, fault):
    _, _, single = case
    res = runs(2)
    assert gates_missed([r[fault] for r in res], single["fused"][:1])


def test_world_size_one_is_the_single_step(case, tmp_path):
    items, draws, _ = case
    out = mesh.spawn_ranks(du.world_one_rank, 1, (str(tmp_path), items, draws),
                           device="cpu", timeout_s=TIMEOUT_S, workdir=str(tmp_path))[0]
    assert out == {"fused": [], "fallback": []}


def test_two_rank_step_matches_jax(tmp_path):
    """test_torch_train.py's test_train_step_matches_jax with the port's
    step over 2 ranks: the same weights (live sigma), frame, key 7 and
    JAX's draws, both under SGD(1.0)."""
    cfg = tiny_cfg()
    spec, ts = jn.ModelSpec.from_config(cfg), jstage1.TrainSettings.from_config(cfg)
    ds = SyntheticFaceDataset(kind="audio", num_frames=1, H=32, W=32,
                              near=cfg.dataset.near, far=cfg.dataset.far)
    item = dict(ds[0])
    item["background"] = ds.background()
    state = jstage1.init_train_state(jax.random.PRNGKey(0), spec, ts)
    pm = dict(state.params["model"])
    for lvl in ("coarse", "fine"):
        pm[lvl] = dict(pm[lvl], fc_alpha={"w": pm[lvl]["fc_alpha"]["w"],
                                          "b": pm[lvl]["fc_alpha"]["b"] + 0.5})
    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    opt = optax.chain(keep, optax.sgd(1.0))
    jst = state._replace(params={"model": pm}, opt_state=opt.init({"model": pm}))
    key = jax.random.PRNGKey(7)
    batch = {k: jnp.asarray(v) for k, v in item.items() if k != "fname"}
    st2, m_j = jax.jit(lambda s, b, k: jstage1.train_step(s, b, k, spec, ts, opt)
                       )(jst, batch, key)
    _, draws = _jax_draws(key, 32, 32, RAYS, 8, 8)
    draws = type(draws)(*(d.numpy() for d in draws))
    res = mesh.spawn_ranks(du.run_steps, 2,
                           (du.tiny_cfg(), [item], "cpu",
                            jax.tree.map(np.asarray, pm), 1.0, [draws]),
                           device="cpu", timeout_s=TIMEOUT_S, workdir=str(tmp_path))
    got = res[0][0]
    for k in ("loss", "coarse_l2", "fine_l2", "coarse_ce", "fine_ce", "bg_loss", "psnr"):
        np.testing.assert_allclose(got["metrics"][k], float(m_j[k]), rtol=OUT_RTOL,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(got["sample_prob"], np.asarray(st2.sample_prob),
                               rtol=OUT_RTOL)
    assert_step_grads_close(got["grads"], st2.opt_state[0]["model"])
    for path, x, y in _tree_pairs(got["params"],
                                  jax.tree.map(np.asarray, st2.params["model"])):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=5e-5, err_msg=path)
    assert all(np.array_equal(x, y)
               for _, x, y in du.leaf_pairs(res[1][0]["params"], got["params"]))


EVAL_CASES = [dict(num_coarse=8, num_fine=8, perturb=False, radiance_field_noise_std=0.0,
                   chunksize=64, use_pallas=True, compute_dtype="float32"),
              dict(num_coarse=8, num_fine=8, perturb=True, radiance_field_noise_std=0.5,
                   chunksize=51, use_pallas=True, compute_dtype="float32")]


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    single = du.eval_rank(None, EVAL_CASES)
    sharded = mesh.spawn_ranks(du.eval_rank, 2, (EVAL_CASES,), device="cpu", timeout_s=TIMEOUT_S,
                               workdir=str(tmp_path_factory.mktemp("eval")))
    return single, sharded


@pytest.mark.parametrize("case_i", [0, 1], ids=["deterministic", "perturbed_odd_chunk"])
def test_sharded_eval_render_matches_single_render(eval_runs, case_i):
    single, sharded = eval_runs
    for k in ("rgb_fine", "rgb_coarse", "disp_fine", "acc_fine", "weights", "depth_fine"):
        for r in sharded:
            np.testing.assert_allclose(r[case_i][k], single[case_i][k], rtol=2e-4,
                                       atol=2e-5, err_msg=k)
        np.testing.assert_array_equal(sharded[1][case_i][k], sharded[0][case_i][k])


def _eval_checkpoint(tmp_path):
    """test_torch_eval.py's CLI config (plain modules, 4 + 4 samples, a
    32-wide latent code) and a native checkpoint of a seeded state."""
    from sahs_tpu_torch.config import load_config
    from sahs_tpu_torch.models.nerface import ModelSpec
    from sahs_tpu_torch.train import stage1
    from sahs_tpu_torch.utils import checkpoint as ck
    from test_torch_eval import _cli_cfg
    cfg_path = _cli_cfg(tmp_path)
    cfg = load_config(cfg_path)
    spec, ts = ModelSpec.from_config(cfg), stage1.TrainSettings.from_config(cfg)
    st = stage1.init_train_state(spec, ts, seed=4, device="cpu")
    st.latent_codes = torch.nn.Parameter(
        torch.randn(4, 32, generator=torch.Generator().manual_seed(2)))
    path = str(tmp_path / "s.ckpt")
    ck.save_checkpoint(path, st, extras={
        "background": np.random.RandomState(3).rand(64, 64, 15).astype(np.float32)})
    return cfg_path, path


def _files(d):
    return sorted(os.path.relpath(p, d) for p in glob.glob(f"{d}/**/*.*", recursive=True))


@pytest.mark.parametrize("mode", ["perturbed", "deterministic"])
def test_eval_cli_on_two_ranks_writes_the_single_runs_files_from_rank_0(tmp_path, mode):
    from sahs_tpu_torch.cli import eval_stage1 as tcli
    cfg_path, ckpt = _eval_checkpoint(tmp_path)
    args = ["--config", cfg_path, "--checkpoint", ckpt, "--synthetic", "--limit", "2",
            "--device", "cpu", "--save-disparity-image", "--save-error-image", "--save-mesh"]
    args += ["--deterministic"] if mode == "deterministic" else []
    single = str(tmp_path / "single")
    assert len(tcli.main(args + ["--savedir", single])) == 2
    dirs = [str(tmp_path / f"rank{r}") for r in range(2)]
    times = mesh.spawn_ranks(du.eval_cli_rank, 2, (args, dirs), device="cpu",
                             timeout_s=TIMEOUT_S, workdir=str(tmp_path / "ranks"))
    assert [len(t) for t in times] == [2, 2]
    assert not os.path.exists(dirs[1])
    want = _files(single)
    assert _files(dirs[0]) == want and "f_0001.png" in want and len(want) == 10
    for rel in want:
        with open(os.path.join(dirs[0], rel), "rb") as a, open(os.path.join(single, rel),
                                                               "rb") as b:
            assert a.read() == b.read(), rel


@pytest.mark.parametrize("world", [1, 2])
def test_scaling_measures_cpu_ranks(world):
    from sahs_tpu_torch.parallel import scaling
    rps = scaling.measure(world, 16, iters=1, device="cpu", timeout_s=TIMEOUT_S)
    assert np.isfinite(rps) and rps > 0


def test_entry_renders_finite_rgb():
    from sahs_tpu_torch import entry
    fn, args = entry.entry(device="cpu")
    out = fn(*args)
    assert tuple(out.shape) == (64, 15) and bool(torch.isfinite(out).all())


def test_dryrun_multichip_on_four_cpu_ranks():
    from sahs_tpu_torch import entry
    m = entry.dryrun_multichip(4, device="cpu", timeout_s=TIMEOUT_S)
    assert np.isfinite(m["loss"]) and m["loss"] > 0


def test_ray_group_blocks_and_refusals(tmp_path):
    g = mesh.RayGroup(rank=1, world=4)
    assert g.block(48) == slice(12, 24)
    with pytest.raises(ValueError, match="do not divide"):
        g.block(50)
    x = torch.arange(48).reshape(24, 2)
    assert torch.equal(mesh.shard_rays(mesh.RayGroup(rank=1, world=2), x), x[12:])
    assert mesh.initialize_distributed(world_size=1).world == 1
    assert mesh.make_ray_group() == mesh.RayGroup()
    with pytest.raises(RuntimeError, match="a rank failed"):
        mesh.spawn_ranks(du.failing_rank, 2, device="cpu", timeout_s=60.0, workdir=str(tmp_path))
