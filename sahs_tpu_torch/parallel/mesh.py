"""Ray groups, ray sharding and multi-process set-up (counterpart of
``sahs_tpu/parallel/mesh.py``).

The JAX package's only parallelism is data parallelism over rays: a 1-D
mesh with one ray axis, parameters replicated, and one collective, the
gradient all-reduce, which XLA inserts from the sharding annotations
(mesh.py:1-21). The port keeps those semantics with one process per card
(``torchrun``; ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``):

  - a ``RayGroup`` (rank, world size, process group) stands for the mesh;
    rank r holds the r-th contiguous block of every ray batch, the way a
    ``NamedSharding`` partitions dim 0;
  - the train step is ``train/stage1.train_step`` with a ray group: every
    rank draws the whole step, renders its block, and one sum all-reduce
    of a flat bucket (every parameter's gradient and the step's metric
    sums) comes before Adam, so every rank takes the same Adam step and
    the parameters, Adam's state and ``sample_prob`` stay replicated;
  - ``DistributedDataParallel`` is not used: the fused path's gradients
    come from kernels through ``autograd.Function``s whose forward
    computes them all, and the step never calls the model through a
    wrapper, so there is no module forward for DDP's hooks to follow;
  - NCCL on CUDA; gloo where the caller asks for it (the CPU tests, or
    several ranks on one card, which NCCL refuses).

World size 1 is exactly the single-process path: ``initialize_distributed``
does nothing and ``make_ray_group`` returns a group of one with no
collective.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch

from ..utils.device import resolve_device

# seconds a collective or the group's set-up may wait on a rank before it
# fails the run (torchrun's own default is 10 minutes for NCCL)
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class RayGroup:
    """The ranks that share one ray batch (the JAX package's 1-D mesh):
    ``rank`` of ``world``, and the process group that joins them (None: one
    process, no collective)."""
    rank: int = 0
    world: int = 1
    group: Optional[Any] = None

    def block(self, n: int) -> slice:
        """The rows of an n-row batch that this rank holds: the rank-th of
        ``world`` contiguous blocks. Raises unless n divides by the world
        size (the JAX package leaves padding to the caller)."""
        if n % self.world:
            raise ValueError(f"{n} rays do not divide into {self.world} blocks")
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place."""
        if self.group is not None:
            import torch.distributed as dist
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` of rank ``src`` on every rank, in place."""
        if self.group is not None:
            import torch.distributed as dist
            dist.broadcast(t, src=dist.get_global_rank(self.group, src)
                           if self.group is not dist.group.WORLD else src,
                           group=self.group)
        return t

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (the same shape on each), concatenated along
        dim 0 in rank order."""
        if self.group is None:
            return t
        import torch.distributed as dist
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, dim=0)


def rank_device(device=None) -> torch.device:
    """This process's device: CUDA unless the caller names another (with
    no device given and no CUDA present this raises); on CUDA the card
    ``LOCAL_RANK`` (torchrun's) modulo the cards present, so several ranks
    may share one card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def initialize_distributed(backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None, device=None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> RayGroup:
    """Joins this process to its ray group and returns it; a no-op that
    returns a group of one at world size 1. ``world_size`` and ``rank``
    default to torchrun's ``WORLD_SIZE`` and ``RANK``, ``init_method`` to
    ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``), ``backend`` to NCCL on
    CUDA and gloo on the CPU. Raises when the group cannot form within
    ``timeout_s``: the run never carries on alone."""
    import torch.distributed as dist
    world = int(world_size if world_size is not None
                else os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return RayGroup()
    if rank is None:
        if "RANK" not in os.environ:
            raise RuntimeError(f"world size {world} but no RANK: start each "
                               "process with torchrun or pass rank")
        rank = int(os.environ["RANK"])
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    group = make_ray_group()
    if group.world != world or group.rank != rank:
        raise RuntimeError(f"the process group is rank {group.rank} of "
                           f"{group.world}, asked for {rank} of {world}")
    return group


@contextlib.contextmanager
def run_group(device=None):
    """The run's ray group for a command-line entry point: joins it
    (``initialize_distributed``) unless this process is in a group
    already, and leaves it at the end if it joined it here."""
    import torch.distributed as dist
    owns = not dist.is_initialized()
    group = initialize_distributed(device=device) if owns else make_ray_group()
    try:
        yield group
    finally:
        if owns and dist.is_initialized():
            dist.destroy_process_group()


def make_ray_group(group=None) -> RayGroup:
    """The ray group of ``group`` (default: every process of the run;
    the counterpart of ``make_mesh``). Without an initialised process
    group: a group of one."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return RayGroup()
    pg = group if group is not None else dist.group.WORLD
    return RayGroup(rank=dist.get_rank(pg), world=dist.get_world_size(pg),
                    group=pg)


def shard_rays(group: RayGroup, *arrays):
    """This rank's contiguous block of dim 0 of each ray-major array (None
    passes through). Raises unless each row count divides by the world
    size."""
    out = [None if a is None else a[group.block(a.shape[0])] for a in arrays]
    return out[0] if len(out) == 1 else tuple(out)


def _state_tensors(state) -> list:
    """The replicated tensors of a TrainState, in a fixed order: every
    trained parameter (the optimizer's), each parameter's Adam moments,
    and sample_prob."""
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    out = [p.data for p in params]
    for p in params:
        st = state.optimizer.state.get(p, {})
        out += [st[k] for k in sorted(st) if k != "step" and torch.is_tensor(st[k])]
    out.append(state.sample_prob)
    return out


def replicate(group: RayGroup, state):
    """Rank 0's TrainState on every rank, in place: the parameters, Adam's
    state (which parameters have it, its moments and counts), the step
    and sample_prob, broadcast from rank 0. Returns the state."""
    if group.group is None:
        return state
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    dev = state.sample_prob.device
    # which parameters hold Adam state, their step counts and the step: one
    # small broadcast, so every rank allocates what rank 0 holds
    head = torch.tensor([float(state.step)]
                        + [float(p in state.optimizer.state) for p in params]
                        + [float(state.optimizer.state[p]["step"])
                           if p in state.optimizer.state else 0.0 for p in params],
                        dtype=torch.float64, device=dev)
    group.broadcast_(head)
    head = head.cpu().tolist()
    state.step = int(head[0])
    n = len(params)
    for i, p in enumerate(params):
        if head[1 + i]:
            st = state.optimizer.state.setdefault(p, {})
            for k in ("exp_avg", "exp_avg_sq"):
                if k not in st:
                    st[k] = torch.zeros_like(p, memory_format=torch.preserve_format)
            st["step"] = torch.tensor(head[1 + n + i], dtype=torch.float32)
        else:
            state.optimizer.state.pop(p, None)
    tensors = _state_tensors(state)
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
        group.broadcast_(flat)
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))
    return state


def make_sharded_train_step(spec, ts, group: RayGroup, device=None):
    """The train step over ``group``'s ranks (``train/stage1.make_train_step``
    with a ray group): step(state, batch, generator=None, draws=TrainDraws())
    -> (state, metrics). Every rank passes the same batch, the same
    replicated state and a generator in the same state. K steps a call:
    ``train/stage1.make_multi_train_step`` with ``ray_group``."""
    from ..train import stage1
    return stage1.make_train_step(spec, ts, device=device, ray_group=group)


# ---------------------------------------------------------------------------
# Ranks as processes of one host (the tests, the smoke run, the dry run)
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, world, backend, device, init_method, timeout_s,
               workdir, args):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    path = os.path.join(workdir, f"rank{rank}")
    try:
        group = initialize_distributed(backend, init_method, world, rank,
                                       device, timeout_s)
        result = fn(group, *args)
        torch.save(result, path + ".pt")
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    except BaseException:
        with open(path + ".err", "w") as fp:
            fp.write(traceback.format_exc())
        raise


def spawn_ranks(fn: Callable, world: int, args: Sequence = (),
                backend: Optional[str] = None, device=None,
                timeout_s: float = 300.0,
                workdir: Optional[str] = None) -> List[Any]:
    """Runs ``fn(group, *args)`` in ``world`` new processes (the ``spawn``
    start method, a ``file://`` rendezvous under ``workdir``) joined in one
    ray group on ``device`` (CUDA unless the caller names another; with no
    device given and no CUDA present the ranks raise), and returns each
    rank's result (saved with ``torch.save``), in rank order. ``fn`` must
    be importable by name. Each rank uses one CPU thread; on CUDA rank r
    takes card r modulo the cards present.
    Raises when a rank fails (the others are stopped at once) or when the
    ranks have not all ended within ``timeout_s``, which is also every
    collective's timeout."""
    import multiprocessing
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="ray_group_")
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "rendezvous")
    if os.path.exists(store):
        os.remove(store)
    for r in range(world):
        for ext in (".pt", ".err"):
            if os.path.exists(os.path.join(workdir, f"rank{r}{ext}")):
                os.remove(os.path.join(workdir, f"rank{r}{ext}"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, device,
                               "file://" + store, timeout_s, workdir, tuple(args)),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout_s + 30.0
    failed = None
    while any(p.is_alive() for p in procs):
        failed = next((r for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)), None)
        if failed is not None or time.time() > deadline:
            break
        time.sleep(0.05)
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join()
    if failed is None:
        failed = next((r for r, p in enumerate(procs) if p.exitcode != 0), None)
    if failed is not None or any(p.exitcode != 0 for p in procs):
        errs = []
        for r in range(world):
            e = os.path.join(workdir, f"rank{r}.err")
            if os.path.exists(e):
                errs.append(f"rank {r}:\n" + open(e).read())
        codes = [p.exitcode for p in procs]
        reason = ("a rank failed" if failed is not None
                  else f"the ranks did not end within {timeout_s:.0f} s")
        raise RuntimeError(f"{reason} (exit codes {codes})\n" + "\n".join(errs))
    out = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
           for r in range(world)]
    if own:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    return out
