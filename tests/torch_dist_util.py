"""Rank functions for the sharding tests: each runs in a process of its
own (``parallel/mesh.spawn_ranks``), imports no JAX and returns numpy or
CPU tensors. Shared by tests/test_torch_sharding.py,
tests/test_torch_multihost_data.py, the card tests and chip_smoke.py's
phase 18 (its step runner and planted faults)."""
import dataclasses

import numpy as np
import torch

from sahs_tpu_torch.config import Config
from sahs_tpu_torch.data.synthetic import SyntheticFaceDataset
from sahs_tpu_torch.models.nerface import ModelSpec
from sahs_tpu_torch.parallel import mesh
from sahs_tpu_torch.train import stage1
from sahs_tpu_torch.train.fused import TrainDraws
from sahs_tpu_torch.utils.weights import params_from_jax, params_to_jax


def tiny_cfg(rays=48, fused=True, compute_dtype="float32", **runtime):
    """test_torch_train.py's tiny config: 48 rays, 8 + 8 samples, f32."""
    cfg = Config()
    cfg.nerf.train.num_random_rays = rays
    cfg.nerf.train.num_coarse = 8
    cfg.nerf.train.num_fine = 8
    cfg.runtime.use_pallas = True
    cfg.runtime.compute_dtype = compute_dtype
    cfg.runtime.fused_grads = fused
    for k, v in runtime.items():
        setattr(cfg.runtime, k, v)
    return cfg


def tiny_items(n=3, size=32, seed_frames=(2, 0, 3)):
    cfg = tiny_cfg()
    ds = SyntheticFaceDataset(kind="audio", num_frames=4, H=size, W=size,
                              near=cfg.dataset.near, far=cfg.dataset.far)
    items = []
    for j in seed_frames[:n]:
        it = dict(ds[j])
        it["background"] = ds.background()
        items.append(it)
    return items


def state_for(cfg, device, params=None, sgd=None, background=None):
    """A seeded train state; ``params`` (a JAX-layout tree of numpy arrays)
    loaded when given; ``sgd``: plain SGD at that rate, no schedule;
    ``background``: the (H, W, 15) trained background's start."""
    spec, ts = ModelSpec.from_config(cfg), stage1.TrainSettings.from_config(cfg)
    st = stage1.init_train_state(spec, ts, seed=0, background=background, device=device)
    if params is not None:
        params_from_jax(st.model, params)
    if sgd is not None:
        st.optimizer = torch.optim.SGD(st.model.parameters(), lr=sgd)
        st.lr_fn = None
    return spec, ts, st


def snapshot(st, metrics=None) -> dict:
    """The state's parameters, gradients, Adam moments and sample_prob as
    numpy (JAX tree layout for the model), and the metrics."""
    grad = lambda p: p.grad if p.grad is not None else torch.zeros_like(p)
    moment = lambda k: (lambda p: st.optimizer.state[p][k] if p in st.optimizer.state
                        else torch.zeros_like(p))
    out = {"params": params_to_jax(st.model), "grads": params_to_jax(st.model, grad),
           "sample_prob": st.sample_prob.detach().cpu().numpy(), "step": st.step}
    if isinstance(st.optimizer, torch.optim.Adam):
        out["mu"] = params_to_jax(st.model, moment("exp_avg"))
        out["nu"] = params_to_jax(st.model, moment("exp_avg_sq"))
    if metrics is not None:
        out["metrics"] = {k: np.asarray(v.detach().cpu()) for k, v in metrics.items()}
    return out


def draws_to(draws, device):
    if draws is None:
        return TrainDraws()
    return TrainDraws(*(None if d is None else torch.as_tensor(np.asarray(d)).to(device)
                        for d in draws))


def run_steps(group, cfg, items, device="cpu", params=None, sgd=None, draws=None,
              seed=3, background=None, observe=None):
    """``len(items)`` steps, sharded over ``group`` (None: the single step),
    from one seeded state (``state_for``); each step takes draws[k] when
    given, else the generator (seeded ``seed``). Returns
    ``observe(state, metrics)`` after each step (default: ``snapshot``)."""
    device = torch.device(device)
    observe = observe or snapshot
    spec, ts, st = state_for(cfg, device, params, sgd, background)
    if group is not None:
        mesh.replicate(group, st)
    step = (stage1.make_train_step(spec, ts, device=device) if group is None
            else mesh.make_sharded_train_step(spec, ts, group, device=device))
    gen = torch.Generator(device=device).manual_seed(seed)
    # float32 on the card is float32: TF32 would round AudioNet's conv1d
    # backward differently for inputs a rounding apart
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = []
    try:
        for k, it in enumerate(items):
            d = draws_to(None if draws is None else draws[k], device)
            st, m = step(st, it, generator=gen, draws=d)
            out.append(observe(st, m))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return out


def plant_fault(fault, group):
    """Replaces one of train/stage1.py's sharding helpers in this process:
    'unreduced' (rank 1 keeps its own gradients after the all-reduce),
    'shifted' (rank 0's block one ray on), 'own_norm' (the loss
    normalisers of the block's own rays). Returns the undo."""
    if fault == "unreduced":
        name, orig = "_reduce_step", stage1._reduce_step

        def patched(rg, optimizer, sums):
            grads = [p.grad for g in optimizer.param_groups for p in g["params"]
                     if p.grad is not None]
            own = [g.clone() for g in grads]
            out = orig(rg, optimizer, sums)
            if rg.rank == 1:
                for g, o in zip(grads, own):
                    g.copy_(o)
            return out
    elif fault == "shifted":
        name, orig = "_ray_block", stage1._ray_block

        def patched(rg, R):
            sl = orig(rg, R)
            return slice(sl.start + 1, sl.stop + 1) if rg.rank == 0 else sl
    elif fault == "own_norm":
        name, orig = "_batch_normalisers", stage1._batch_normalisers

        def patched(ts, mask_s, fused, sharded):
            R = mask_s.shape[0]
            sl = group.block(R)
            lw, norm = orig(ts, mask_s[sl], fused, sharded)
            if lw is not None:
                full = torch.zeros((R, 2), dtype=lw.dtype, device=lw.device)
                full[sl] = lw
                lw = full
            return lw, norm
    else:
        raise ValueError(fault)
    setattr(stage1, name, patched)
    return lambda: setattr(stage1, name, orig)


FAULTS = ("unreduced", "shifted", "own_norm")


def paths_rank(group, items, draws, steps_device="cpu", compute_dtype="float32",
               rays=48, faults=False, sgd=None):
    """The fused and the fallback path's sharded steps on ``items`` with
    the given full-width draws (``sgd``: under SGD at that rate, else
    Adam); with ``faults``, also one step under each planted fault
    (FAULTS) on the fused path."""
    out = {}
    for path in ("fused", "fallback"):
        cfg = tiny_cfg(rays=rays, fused=path == "fused", compute_dtype=compute_dtype)
        out[path] = run_steps(group, cfg, items, steps_device, draws=draws, sgd=sgd)
    if faults:
        cfg = tiny_cfg(rays=rays, compute_dtype=compute_dtype)
        for fault in FAULTS:
            undo = plant_fault(fault, group)
            try:
                out[fault] = run_steps(group, cfg, items[:1], steps_device,
                                       draws=draws[:1], sgd=sgd)
            finally:
                undo()
    return out


def world_one_rank(_, workdir, items, draws, device="cpu", backend="gloo",
                   compute_dtype="float32"):
    """At world size 1 over a real process group (a group of one with its
    collective): the sharded step against the single step in this process,
    on both paths. Returns the leaves that differ, per path ([] when every
    parameter, gradient, Adam moment, metric and sample_prob is equal bit
    for bit)."""
    import os
    import torch.distributed as dist
    dist.init_process_group(backend, init_method="file://" + os.path.join(workdir, "one"),
                            world_size=1, rank=0)
    group = mesh.make_ray_group()
    assert group.world == 1 and group.group is not None
    out = {}
    for path in ("fused", "fallback"):
        cfg = tiny_cfg(fused=path == "fused", compute_dtype=compute_dtype)
        a = run_steps(None, cfg, items, device, draws=draws)
        b = run_steps(group, cfg, items, device, draws=draws)
        out[path] = [p for p, x, y in leaf_pairs(a, b) if not np.array_equal(x, y)]
    dist.destroy_process_group()
    return out


def leaf_pairs(a, b, path=""):
    """(path, a's leaf, b's leaf) over two nested dicts / lists of arrays."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            yield from leaf_pairs(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from leaf_pairs(x, y, f"{path}[{i}]")
    else:
        yield path, np.asarray(a), np.asarray(b)


def full_draws(seed, H, W, R, Sc=8, Sn=8, steps=2):
    """Seeded full-width TrainDraws (numpy) for ``steps`` steps."""
    rng = np.random.RandomState(seed)
    f = np.float32
    return [TrainDraws(gumbel=rng.gumbel(size=(H * W,)).astype(f),
                       t_rand=rng.rand(R, Sc).astype(f), u=rng.rand(R, Sn).astype(f),
                       noise_coarse=rng.randn(R, Sc).astype(f),
                       noise_fine=rng.randn(R, Sc + Sn).astype(f))
            for _ in range(steps)]


def eval_rank(group, cases, device="cpu"):
    """The seeded flagship-shaped tiny model's 16x16 frame through
    ``make_eval_renderer`` with ``group`` for each case (RenderSettings
    keyword arguments), a generator seeded 3 a frame."""
    from sahs_tpu_torch.evaluation import make_eval_renderer
    from sahs_tpu_torch.models.nerface import NeRFaceModel
    from sahs_tpu_torch.render.pipeline import RenderSettings
    cfg = tiny_cfg()
    spec = ModelSpec.from_config(cfg)
    model = NeRFaceModel.init(spec, seed=0, device=device)
    it = tiny_items(1, size=16)[0]
    out = []
    for kw in cases:
        r = make_eval_renderer(spec, RenderSettings(**kw), 16, 16, float(cfg.dataset.near),
                               float(cfg.dataset.far), device=device, ray_group=group)
        o = r(model, it["intrinsics"], it["pose"], it["driving"], it["background"],
              torch.Generator(device=device).manual_seed(3))
        out.append({k: None if v is None else v.detach().cpu().numpy() for k, v in o.items()})
    return out


def eval_cli_rank(group, args, savedirs):
    """``cli.eval_stage1.main`` in this rank's group, each rank given its
    own ``savedirs[rank]``; returns the run's seconds a frame."""
    from sahs_tpu_torch.cli import eval_stage1 as cli
    return cli.main(args + ["--savedir", savedirs[group.rank]])


def failing_rank(group):
    """Rank 1 fails while rank 0 waits in a collective."""
    if group.rank == 1:
        raise RuntimeError("a planted failure")
    group.all_reduce_(torch.zeros(1))


def assemble_rank(group, schedules, n_frames=4, size=16):
    """``assemble_sharded_batches`` of each schedule over ``group`` on a
    seeded synthetic dataset; returns each batch as numpy, and the frames
    this rank decoded."""
    from sahs_tpu_torch.data.sharded import HostShardedFrames, assemble_sharded_batches
    ds = SyntheticFaceDataset(kind="audio", num_frames=n_frames, H=size, W=size)
    frames = HostShardedFrames(ds, group.rank, group.world)
    out = [{k: v.numpy() for k, v in assemble_sharded_batches(
        frames, s, ds.background(), group, device="cpu").items()} for s in schedules]
    return {"batches": out, "decoded": sorted(frames._cache),
            "decode_count": frames.decode_count, "owned": sorted(frames.owned)}


def cli_rank(group, runs):
    """``cli.train_stage1.main`` for each argument list in turn, in this
    rank's process group; returns each run's final state's snapshot."""
    from sahs_tpu_torch.cli import train_stage1 as cli
    return [snapshot(cli.main(args)) for args in runs]


# tests/test_sharding.py:52-73
LOSS_RTOL, W_ATOL, PROB_RTOL = 2e-4, 2e-5, 2e-4
# a step's summed gradient against the single step's, each leaf against
# its own norm: the sums' order alone moves them by ~5e-7 (2 and 4 ranks,
# on the CPU)
GRAD_L2 = 1e-5


def _rel(x, y):
    x, y = np.asarray(x, np.float64).ravel(), np.asarray(y, np.float64).ravel()
    return np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-30)


def gates_missed(runs, single) -> list:
    """The sharding tests' gates over every step of the ranks' ``runs``
    (snapshots, rank by rank) against the single step's: the loss and
    sample_prob (LOSS_RTOL, PROB_RTOL), every parameter (W_ATOL), every
    summed gradient leaf (GRAD_L2 of its own norm), and every rank's
    parameters equal to rank 0's bit for bit. [] when they hold."""
    missed = []
    for k, (want, *ranks) in enumerate(zip(single, *runs)):
        got = ranks[0]
        if not np.allclose(got["metrics"]["loss"], want["metrics"]["loss"], rtol=LOSS_RTOL):
            missed.append(f"step {k} loss")
        if not np.allclose(got["sample_prob"], want["sample_prob"], rtol=PROB_RTOL):
            missed.append(f"step {k} sample_prob")
        for p, x, y in leaf_pairs(got["params"], want["params"]):
            if not np.allclose(x, y, rtol=0, atol=W_ATOL):
                missed.append(f"step {k} param {p}")
        for p, x, y in leaf_pairs(got["grads"], want["grads"]):
            if _rel(x, y) > GRAD_L2:
                missed.append(f"step {k} grad {p} {_rel(x, y):.2e}")
        for r, other in enumerate(ranks[1:], 1):
            if any(not np.array_equal(x, y)
                   for _, x, y in leaf_pairs(other["params"], got["params"])):
                missed.append(f"step {k} rank {r} params differ from rank 0's")
    return missed
