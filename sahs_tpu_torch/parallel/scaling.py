"""Rays/s of the sharded train step against the world size (counterpart
of ``sahs_tpu/parallel/scaling.py``), one process per rank.

    python -m sahs_tpu_torch.parallel.scaling [--rays 2048] [--world 1 2 4]
        [--iters 10] [--device cuda|cpu] [--backend nccl|gloo]

On CUDA rank r takes card r modulo the cards present, so on one card the
ranks share it (NCCL refuses that: pass ``--backend gloo``) and the
numbers say what the sharding costs, not how it scales. At world size 1
the step runs in one process with no collective. Each reading is the
flagship ``Config()`` step (``--rays`` rays, 64 + 64 samples, bf16 on
CUDA, float32 on the CPU) on a synthetic 256x256 frame, ``--iters``
steps after two warm-up steps, timed on rank 0 between two barriers.
"""
from __future__ import annotations

import argparse
import time

import torch

from . import mesh


def _rank_rays_per_s(group: mesh.RayGroup, num_rays: int, iters: int,
                     device: str) -> float:
    from ..config import Config
    from ..entry import _tiny_batch
    from ..models.nerface import ModelSpec
    from ..train.stage1 import TrainSettings, init_train_state
    dev = mesh.rank_device(device)
    cfg = Config()
    cfg.nerf.train.num_random_rays = num_rays
    if dev.type == "cpu":
        cfg.runtime.compute_dtype = "float32"
    spec, ts = ModelSpec.from_config(cfg), TrainSettings.from_config(cfg)
    state = mesh.replicate(group, init_train_state(spec, ts, seed=0, device=dev))
    step = mesh.make_sharded_train_step(spec, ts, group, device=dev)
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in _tiny_batch(256, 256, 300.0).items()}
    gen = torch.Generator(device=dev).manual_seed(0)

    def sync():
        group.all_reduce_(torch.zeros(1, device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(2):
        state, _ = step(state, batch, generator=gen)
    sync()
    t0 = time.time()
    for _ in range(iters):
        state, _ = step(state, batch, generator=gen)
    sync()
    return num_rays * iters / (time.time() - t0)


def measure(world: int, num_rays: int, iters: int = 10, device: str = "cuda",
            backend=None, timeout_s: float = 600.0) -> float:
    """Rays/s of the whole group (rank 0's clock) at ``world`` ranks."""
    if world == 1:
        return _rank_rays_per_s(mesh.RayGroup(), num_rays, iters, device)
    return mesh.spawn_ranks(_rank_rays_per_s, world, (num_rays, iters, device),
                            backend=backend, device=device,
                            timeout_s=timeout_s)[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=2048)
    ap.add_argument("--world", type=int, nargs="+", default=None)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--backend", type=str, default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu")
    counts = args.world or sorted({1, max(1, torch.cuda.device_count()
                                          if args.device == "cuda" else 1)})
    base = None
    out = {}
    for n in counts:
        rps = measure(n, args.rays, args.iters, args.device, args.backend)
        base = base or rps / n
        out[n] = rps
        print(f"world={n}: {rps:,.0f} rays/s  scaling_eff={rps / (n * base):.2%}",
              flush=True)
    return out


if __name__ == "__main__":
    main()
