"""The port's per-rank frame sharding (``sahs_tpu_torch/data/sharded.py``)
and the training CLI's multi-process branch, on the CPU with gloo
processes (``parallel/mesh.spawn_ranks``; each join and collective under
a timeout):

  (a) every schedule and ownership function bit-equal to
      ``sahs_tpu.data.sharded``'s on the same seeds, and HostShardedFrames'
      contract (only owned frames decode, each once);
  (b) a 2-rank ``assemble_sharded_batches`` equal, on every rank, to the
      JAX package's single-host assembly of the same schedule, bit for
      bit, each rank decoding only frames of its own shard (a blocked
      schedule, and a one-slot schedule as the CLI's last single steps
      take);
  (c) the CLI's 2-rank run (32 rays, 4 + 4 samples, float32): K = 3
      rounded to 2, two launches and a single step to iteration 5, a
      resume to 7; both ranks' states equal bit for bit after each run,
      and the checkpoint restored by the JAX package's
      ``restore_train_state`` equal to the run's parameters and Adam
      moments.
"""
import os

import numpy as np
import pytest
import torch

import jax

from sahs_tpu.data import sharded as jsh
from sahs_tpu.data.synthetic import SyntheticFaceDataset as JSynthetic
from sahs_tpu.models.nerface import ModelSpec as JSpec
from sahs_tpu.config import load_config as jload_config
from sahs_tpu.train import stage1 as jstage1
from sahs_tpu.utils import checkpoint as jck

from sahs_tpu_torch.data import sharded as tsh
from sahs_tpu_torch.data.synthetic import SyntheticFaceDataset
from sahs_tpu_torch.parallel import mesh

import torch_dist_util as du
from test_torch_stage1_cli import write_cfg

torch.set_num_threads(2)
TIMEOUT_S = 300.0


@pytest.mark.parametrize("n_frames,steps,count,seed",
                         [(10, 8, 2, 0), (5, 8, 2, 123), (7, 12, 3, 9), (4, 4, 4, 31),
                          (9, 6, 1, 5)])
def test_schedules_and_ownership_match_jax(n_frames, steps, count, seed):
    for h in range(count):
        assert tsh.shard_indices(n_frames, h, count) == jsh.shard_indices(n_frames, h, count)
    np.testing.assert_array_equal(tsh.frame_schedule(seed, n_frames, steps),
                                  jsh.frame_schedule(seed, n_frames, steps))
    s_t = tsh.blocked_frame_schedule(seed, n_frames, steps, count)
    s_j = jsh.blocked_frame_schedule(seed, n_frames, steps, count)
    assert s_t.dtype == s_j.dtype
    np.testing.assert_array_equal(s_t, s_j)
    for h in range(count):
        assert tsh.owned_slots(s_t, h, count) == jsh.owned_slots(s_j, h, count)
        shard = set(tsh.shard_indices(n_frames, h, count))
        assert all(int(s_t[t]) in shard for t in tsh.owned_slots(s_t, h, count))
    for mod in (tsh, jsh):
        with pytest.raises(ValueError):
            mod.blocked_frame_schedule(seed, n_frames, 2 * count + 1, 2 * count)
        with pytest.raises(ValueError):
            mod.shard_indices(n_frames, count, count)


def test_host_sharded_frames_decode_only_owned():
    ds = SyntheticFaceDataset(kind="audio", num_frames=4, H=16, W=16)
    fr0, fr1 = tsh.HostShardedFrames(ds, 0, 2), tsh.HostShardedFrames(ds, 1, 2)
    assert fr0.owned == {0, 2} and fr1.owned == {1, 3} and len(fr0) == 4
    fr0.get(0)
    fr0.get(2)
    fr0.get(0)                 # cached
    assert fr0.decode_count == 2
    with pytest.raises(KeyError, match="owned by rank 1"):
        fr0.get(1)


def test_two_rank_assembly_matches_jax_single_host(tmp_path):
    jds = JSynthetic(kind="audio", num_frames=4, H=16, W=16)
    sched = jsh.blocked_frame_schedule(7, len(jds), 6, 2)
    tail = [3]
    want = [jsh.assemble_sharded_batches(jsh.HostShardedFrames(jds, 0, 1), s,
                                         background=np.asarray(jds.background()))
            for s in (sched, tail)]
    res = mesh.spawn_ranks(du.assemble_rank, 2, ([sched, tail],), device="cpu", timeout_s=TIMEOUT_S,
                           workdir=str(tmp_path))
    for r, got in enumerate(res):
        assert set(got["decoded"]) <= set(got["owned"]) == set(range(r, 4, 2))
        assert got["decode_count"] == len(got["decoded"])
        for g, w in zip(got["batches"], want):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)


def test_cli_two_ranks_agree_resume_and_restore_in_jax(tmp_path):
    cfg_path = write_cfg(tmp_path)
    args = ["--config", cfg_path, "--synthetic", "--synthetic-size", "32",
            "--steps-per-launch", "3", "--device", "cpu"]
    ckpt5 = str(tmp_path / "log" / "s1test" / "checkpoint0000005.ckpt")
    runs = [args + ["--max-iters", "5"],
            args + ["--max-iters", "7", "--load-checkpoint", ckpt5]]
    res = mesh.spawn_ranks(du.cli_rank, 2, (runs,), device="cpu", timeout_s=TIMEOUT_S,
                           workdir=str(tmp_path / "ranks"))
    for run, want_step in zip(range(2), (5, 7)):
        a, b = res[0][run], res[1][run]
        assert a["step"] == b["step"] == want_step
        diff = [p for p, x, y in du.leaf_pairs({k: a[k] for k in ("params", "mu", "nu",
                                                                   "sample_prob")},
                                               {k: b[k] for k in ("params", "mu", "nu",
                                                                  "sample_prob")})
                if not np.array_equal(x, y)]
        assert diff == []
    assert os.path.exists(str(tmp_path / "log" / "s1test" / "checkpoint0000007.ckpt"))
    # the checkpoint at 5 in the JAX package
    cfg = jload_config(cfg_path)
    spec, ts = JSpec.from_config(cfg), jstage1.TrainSettings.from_config(cfg)
    template = jstage1.init_train_state(jax.random.PRNGKey(1), spec, ts)
    restored, _ = jck.restore_train_state(ckpt5, template)
    assert int(restored.step) == 5
    got = res[0][0]
    for p, x, y in du.leaf_pairs(jax.tree.map(np.asarray, restored.params["model"]),
                                 got["params"]):
        np.testing.assert_array_equal(x, y, err_msg=p)
    mu = jax.tree.map(np.asarray, restored.opt_state[0].mu["model"])
    for p, x, y in du.leaf_pairs(mu, got["mu"]):
        np.testing.assert_array_equal(x, y, err_msg=p)
    np.testing.assert_array_equal(np.asarray(restored.sample_prob), got["sample_prob"])
