"""Entry points of the port (counterpart of ``__graft_entry__.py``):

- ``entry()``: the flagship AudioFaceModel's forward render (coarse and
  fine) of a small ray batch, with its inputs; on the card unless the
  caller names the CPU.
- ``dryrun_multichip(n)``: one sharded Stage-I train step at tiny sizes
  over n ranks, one process each: gloo processes on the CPU when asked,
  one card a rank otherwise (NCCL).
"""
from __future__ import annotations

import numpy as np
import torch


def _tiny_inputs(R=64):
    rng = np.random.RandomState(0)
    ro = np.zeros((R, 3), np.float32)
    rd = (rng.randn(R, 3) * 0.05 + np.array([0, 0, -1.0])).astype(np.float32)
    audio = rng.randn(16, 29).astype(np.float32)
    Rm = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
    pose = np.concatenate([Rm, np.array([[0], [0], [0.6]], np.float32)], 1)
    bg = rng.rand(R, 15).astype(np.float32)
    return ro, rd, audio, pose, bg


def entry(device=None):
    """(fn, args): fn(*args) renders 64 rays of the flagship Config() at
    16 + 16 samples, perturbed, with sigma noise 0.1 and a background
    prior, through ``render/pipeline.render_rays`` on the kernel path
    (bf16 on CUDA, float32 on the CPU), and returns the fine rgb (64, 15)."""
    from .config import Config
    from .models.nerface import ModelSpec, NeRFaceModel
    from .render.pipeline import RenderSettings, render_rays
    from .utils.device import resolve_device
    dev = resolve_device(device)
    cfg = Config()
    spec = ModelSpec.from_config(cfg)
    model = NeRFaceModel.init(spec, seed=0, device=dev)
    settings = RenderSettings(num_coarse=16, num_fine=16, perturb=True,
                              radiance_field_noise_std=0.1, use_pallas=True,
                              compute_dtype="bfloat16" if dev.type == "cuda"
                              else "float32")
    args = tuple(torch.as_tensor(x).to(dev) for x in _tiny_inputs())

    def fn(ro, rd, audio, pose, bg, generator=None):
        gen = generator or torch.Generator(device=dev).manual_seed(1)
        out = render_rays(model, settings, ro, rd, 0.48, 1.08, audio, pose,
                          generator=gen, background_prior=bg)
        return out.rgb_fine

    return fn, args


def _tiny_batch(H=16, W=16, focal=20.0):
    """A seeded synthetic frame (H, W) with a background prior."""
    rng = np.random.RandomState(0)
    Rm = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
    return {
        "image": rng.rand(H, W, 3).astype(np.float32),
        "mask": np.eye(12, dtype=np.float32)[rng.randint(0, 12, size=(H, W))],
        "pose": np.concatenate([Rm, np.array([[0], [0], [0.6]], np.float32)], 1),
        "intrinsics": np.array([focal, focal, 0.5, 0.5], np.float32),
        "driving": rng.randn(16, 29).astype(np.float32),
        "background": np.concatenate(
            [rng.rand(H, W, 3).astype(np.float32), np.ones((H, W, 1), np.float32),
             np.zeros((H, W, 11), np.float32)], -1),
        "frame_idx": np.int32(0),
    }


def _dryrun_rank(group, device):
    from .config import Config
    from .models.nerface import ModelSpec
    from .parallel import mesh
    from .train.stage1 import TrainSettings, init_train_state
    dev = mesh.rank_device(device)
    cfg = Config()
    cfg.nerf.train.num_random_rays = 8 * group.world
    cfg.nerf.train.num_coarse = 8
    cfg.nerf.train.num_fine = 8
    if dev.type == "cpu":
        cfg.runtime.compute_dtype = "float32"
    spec, ts = ModelSpec.from_config(cfg), TrainSettings.from_config(cfg)
    state = mesh.replicate(group, init_train_state(spec, ts, seed=0, device=dev))
    step = mesh.make_sharded_train_step(spec, ts, group, device=dev)
    state, metrics = step(state, _tiny_batch(),
                          generator=torch.Generator(device=dev).manual_seed(1))
    return {k: float(v) for k, v in metrics.items()}


def dryrun_multichip(n_devices: int, device=None, timeout_s: float = 300.0) -> dict:
    """One sharded train step (flagship Config(), 8 rays a rank, 8 + 8
    samples) over ``n_devices`` ranks: gloo processes with
    ``device="cpu"``, else one card a rank over NCCL. Raises unless every
    rank returns the same finite metrics; returns rank 0's."""
    from .parallel import mesh
    from .utils.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"{n_devices} ranks need {n_devices} cards, "
                           f"{torch.cuda.device_count()} present")
    out = mesh.spawn_ranks(_dryrun_rank, n_devices, (dev.type,), device=dev.type,
                           timeout_s=timeout_s)
    if any(m != out[0] for m in out[1:]) or not all(
            np.isfinite(v) for v in out[0].values()):
        raise RuntimeError(f"the ranks' metrics differ or are not finite: {out}")
    print(f"dryrun_multichip({n_devices}) OK: loss={out[0]['loss']:.4f}")
    return out[0]


if __name__ == "__main__":
    fn, args = entry()
    print("entry OK:", tuple(fn(*args).shape))
    dryrun_multichip(torch.cuda.device_count() if torch.cuda.is_available() else 1)
