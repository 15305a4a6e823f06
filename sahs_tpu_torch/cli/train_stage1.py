"""Stage-I training CLI (counterpart of ``sahs_tpu/cli/train_stage1.py``;
reference nerf-pytorch/train_stage_rays_auto.py):

    python -m sahs_tpu_torch.cli.train_stage1 --config cfg.yml \
        [--load-checkpoint ckpt] [--import-torch-checkpoint ref.ckpt] \
        [--synthetic [--synthetic-size N]] [--max-iters N] \
        [--steps-per-launch K] [--device cuda|cpu]

Runs on ``cuda`` unless ``--device`` names another device. The frames are
picked with numpy's global generator seeded from
``cfg.experiment.randomseed`` (``np.random.choice``), as the JAX package
picks them, so both packages train on the same frames in the same order;
the step's random draws come from a torch generator of the same seed.
With ``--steps-per-launch K`` > 1, K steps run through
``train/stage1.make_multi_train_step`` on K stacked frames; the metrics
stay on the device and are read only at ``print_every``. Checkpoints are
the native npz schema of ``utils/checkpoint.py``, shared with the JAX
package. ``--synthetic`` trains on the procedural fixture
(``SyntheticFaceDataset``: 8 frames of ``--synthetic-size`` pixels a side,
64 by default, as the JAX package).

Across several cards, one process each (the JAX package's multi-host
branch, cli/train_stage1.py:123-172):

    torchrun --nproc_per_node=N -m sahs_tpu_torch.cli.train_stage1 \
        --config cfg.yml --steps-per-launch K

Every rank runs the sharded step (``parallel/mesh.py``: each renders its
block of every step's rays; one all-reduce a step); K is rounded to a
multiple of the world size; each launch's frames follow
``data/sharded.blocked_frame_schedule`` seeded ``randomseed + i``, each
rank decoding only the frames it owns and broadcasting them
(``assemble_sharded_batches``); only rank 0 prints, logs, validates and
writes checkpoints; a resume restores the checkpoint on every rank. NCCL
on CUDA, gloo with ``--device cpu``. A rank that fails raises, so its
process exits nonzero, and its peers' next collective fails within
``parallel/mesh.DEFAULT_TIMEOUT_S`` seconds.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..config import load_config
from ..data.audio import AudioDataset
from ..data.nerface import NerfaceDataset
from ..data.synthetic import SyntheticFaceDataset
from ..models.nerface import ModelSpec
from ..parallel import mesh
from ..train.stage1 import (TrainSettings, init_train_state,
                            make_multi_train_step, make_train_step,
                            stack_batches)
from ..utils import checkpoint as ckpt_lib
from ..utils.device import resolve_device
from ..utils.logging import MetricLogger
from ..utils.weights import params_from_jax


def build_dataset(cfg, mode, synthetic=False, size=64):
    if synthetic:
        return SyntheticFaceDataset(kind=cfg.dataset.type, num_frames=8, H=size,
                                    W=size, near=cfg.dataset.near, far=cfg.dataset.far)
    if cfg.dataset.type.lower() == "audio":
        return AudioDataset(mode, cfg,
                            testskip=cfg.dataset.testskip if mode != "train" else 1)
    return NerfaceDataset(mode, cfg)


def device_batch(item, background, device):
    b = {k: torch.as_tensor(np.asarray(v)).to(device)
         for k, v in item.items() if k != "fname"}
    if background is not None:
        b["background"] = background
    return b


def main(argv=None):
    """Trains as the config says; returns the final TrainState."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, required=True)
    ap.add_argument("--load-checkpoint", type=str, default="")
    ap.add_argument("--import-torch-checkpoint", type=str, default="")
    ap.add_argument("--synthetic", action="store_true",
                    help="use the procedural fixture dataset")
    ap.add_argument("--synthetic-size", type=int, default=64,
                    help="the fixture's frames' side in pixels")
    ap.add_argument("--max-iters", type=int, default=0,
                    help="override cfg.experiment.train_iters")
    ap.add_argument("--steps-per-launch", type=int, default=1,
                    help=">1 runs K steps a call of the multi-step loop")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    if resolve_device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to train on the CPU")
    with mesh.run_group(args.device) as group:
        return _train(args, group)


def _train(args, group: mesh.RayGroup):
    pc, pi = group.world, group.rank
    lead = pi == 0
    say = print if lead else (lambda *a, **k: None)
    dev = mesh.rank_device(args.device)
    cfg = load_config(args.config)
    spec = ModelSpec.from_config(cfg)
    ts = TrainSettings.from_config(cfg)
    seed = cfg.experiment.randomseed
    np.random.seed(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)

    train_data = build_dataset(cfg, "train", args.synthetic, args.synthetic_size)
    val_data = build_dataset(cfg, "val", args.synthetic, args.synthetic_size)
    say(f"dataset: {len(train_data)} train / {len(val_data)} val frames, "
        f"{train_data.H}x{train_data.W}")
    sharded_frames = None
    if pc > 1:
        from ..data.sharded import HostShardedFrames
        sharded_frames = HostShardedFrames(train_data, pi, pc)

    background = None
    if ts.train_background and not ts.fixed_background:
        # trainable background: the mean of the training frames, optionally
        # blurred (reference train_stage_rays_auto.py:143-157)
        from ..data.common import average_background
        acc = None
        # across ranks each sums the frames it owns and the sums are summed
        for j in (sorted(sharded_frames.owned) if sharded_frames else range(len(train_data))):
            item = sharded_frames.get(j) if sharded_frames else train_data[j]
            img = np.asarray(item["image"], np.float32)
            acc = img.copy() if acc is None else acc + img
        if sharded_frames:
            acc = group.all_reduce_(torch.from_numpy(acc).to(dev)).cpu().numpy()
        background = torch.from_numpy(average_background(
            acc[None] / len(train_data), blur=cfg.runtime.blur_background)).to(dev)
    elif ts.fixed_background or ts.train_background:
        bg = train_data.background()
        background = torch.from_numpy(bg).to(dev) if bg is not None else None

    state = init_train_state(spec, ts, seed=seed, background=background, device=dev,
                             num_latent_frames=len(train_data))
    # canonical pose: frame 0 (rank 0's, which alone writes checkpoints)
    pose_c = torch.as_tensor(train_data[0]["pose"]).to(dev) if lead else None

    if args.import_torch_checkpoint:
        imported = ckpt_lib.import_torch_checkpoint(args.import_torch_checkpoint, spec)
        params_from_jax(state.model, imported["model"])
        if "sample_prob" in imported:
            state.sample_prob = imported["sample_prob"].to(dev, torch.float32)
        if "background" in imported:
            background = imported["background"].to(dev, torch.float32)
    if args.load_checkpoint and os.path.exists(args.load_checkpoint):
        state, extras = ckpt_lib.restore_train_state(args.load_checkpoint, state)
        if extras.get("background") is not None:
            background = extras["background"].to(dev, torch.float32)
        if extras.get("pose_c") is not None:
            pose_c = extras["pose_c"].to(dev)
        say(f"resumed from {args.load_checkpoint} at iter {state.step}")
    ray_group = None              # one process: the single step
    if pc > 1:
        # every rank holds rank 0's state, whatever its own start was
        mesh.replicate(group, state)
        ray_group = group

    logdir = os.path.join(cfg.experiment.logdir, cfg.experiment.id)
    logger = None
    if lead:
        logger = MetricLogger(logdir)
        with open(os.path.join(logdir, "config.yml"), "w") as fp:
            fp.write(cfg.dump())

    K = max(1, args.steps_per_launch)
    if pc > 1 and K % pc:
        K = pc * max(1, K // pc)
        say(f"steps-per-launch rounded to {K} (a multiple of the world size {pc})")
    multi_fn = (make_multi_train_step(spec, ts, device=dev, ray_group=ray_group)
                if K > 1 else None)
    step_fn = make_train_step(spec, ts, device=dev, ray_group=ray_group)
    n_iters = args.max_iters or cfg.experiment.train_iters

    def crossed(prev, cur, every):
        return every > 0 and (prev // every) != (cur // every)

    t_report = time.time()
    rays_done = 0
    i = state.step
    while i < n_iters:
        i_prev = i
        if K > 1 and i + K <= n_iters:
            if sharded_frames is not None:
                from ..data.sharded import (assemble_sharded_batches,
                                            blocked_frame_schedule)
                sched = blocked_frame_schedule(cfg.experiment.randomseed + i,
                                               len(train_data), K, pc)
                batches = assemble_sharded_batches(sharded_frames, sched, background,
                                                   group, device=dev)
            else:
                frame_ids = np.random.choice(len(train_data), size=K)
                batches = stack_batches([train_data[j] for j in frame_ids],
                                        background, device=dev)
            state, ms = multi_fn(state, batches, generator=gen)
            metrics = {k: v[-1] for k, v in ms.items()}
            rays_done += ts.num_random_rays * K
            i += K
        else:
            img_i = np.random.choice(len(train_data))
            if sharded_frames is not None:
                from ..data.sharded import assemble_sharded_batches
                # rank 0's pick: a library on one rank may draw from numpy's
                # global generator (tensorboard's import, under the logger)
                img_i = int(group.broadcast_(torch.tensor([img_i], device=dev))[0])
                batch = {k: v[0] for k, v in assemble_sharded_batches(
                    sharded_frames, [img_i], background, group, device=dev).items()}
            else:
                batch = device_batch(train_data[img_i], background, dev)
            state, metrics = step_fn(state, batch, generator=gen)
            rays_done += ts.num_random_rays
            i += 1

        if lead and (crossed(i_prev, i, cfg.experiment.print_every) or i >= n_iters):
            m = {k: float(v) for k, v in metrics.items()}   # the only read-back
            dt = time.time() - t_report
            rps = rays_done / max(dt, 1e-9)
            print(f"[TRAIN] Iter: {i} Loss: {m['loss']:.6f} "
                  f"PSNR_RGB: {m['psnr']:.3f} BG Loss: {m['bg_loss']:.6f} "
                  f"rays/s: {rps:,.0f}")
            logger.scalars(i, {"train/loss": m["loss"], "train/psnr": m["psnr"],
                               "train/coarse_l2": m["coarse_l2"],
                               "train/fine_l2": m["fine_l2"],
                               "train/coarse_ce": m["coarse_ce"],
                               "train/fine_ce": m["fine_ce"],
                               "perf/rays_per_s": rps})
            t_report = time.time()
            rays_done = 0

        bg_now = state.background if ts.train_background else background
        if lead and crossed(i_prev, i, cfg.experiment.validate_every) and i > 0:
            _validate(cfg, spec, state, val_data, bg_now, logger, i, dev)

        if lead and ((crossed(i_prev, i, cfg.experiment.save_every) and i > 0)
                     or i >= n_iters):
            path = os.path.join(logdir, f"checkpoint{i:07d}.ckpt")
            ckpt_lib.save_checkpoint(path, state, extras={
                "background": bg_now, "pose_c": pose_c,
                "height": train_data.H, "width": train_data.W,
                "focal_length": train_data.intrinsics})
            print(f"saved {path}")
    if lead:
        logger.close()
    if pc > 1:
        # no rank returns before rank 0's last checkpoint is on disk
        group.all_reduce_(torch.zeros(1, device=dev))
    return state


@torch.no_grad()
def _validate(cfg, spec, state, val_data, background, logger, step, device):
    """Validation over the val set with logged images, as the reference's
    in-training loop (train_stage_rays_auto.py:577-694: TB scalars and
    rgb / seg / disparity images); cfg.runtime.validate_frames caps the
    frame count (0: the whole set)."""
    from ..evaluation import make_eval_renderer
    from ..ops.losses import img2mse, mse2psnr
    from ..render.pipeline import RenderSettings
    from ..utils.seg import label2color

    settings = RenderSettings.from_config(cfg, "validation")
    renderer = make_eval_renderer(spec, settings, val_data.H, val_data.W,
                                  float(cfg.dataset.near), float(cfg.dataset.far),
                                  device=device)
    gen = torch.Generator(device=device).manual_seed(cfg.experiment.randomseed + step)
    n = len(val_data)
    if cfg.runtime.validate_frames:
        n = min(n, cfg.runtime.validate_frames)
    n_img = min(n, cfg.runtime.validate_image_frames)
    psnrs, coarse_psnrs = [], []
    for i in range(n):
        item = val_data[i]
        out = renderer(state.model, item["intrinsics"], item["pose"], item["driving"],
                       background, gen)
        rgb = out["rgb_fine"] if out["rgb_fine"] is not None else out["rgb_coarse"]
        target = torch.as_tensor(item["image"]).to(device)
        psnrs.append(mse2psnr(img2mse(rgb[..., :3].float(), target)))
        coarse_psnrs.append(mse2psnr(img2mse(out["rgb_coarse"][..., :3].float(), target)))
        if i < n_img:
            sfx = f"_{i}" if n_img > 1 else ""
            host = lambda x: x.float().cpu().numpy()
            logger.image(step, f"val/rgb{sfx}", host(rgb[..., :3]))
            logger.image(step, f"val/rgb_coarse{sfx}", host(out["rgb_coarse"][..., :3]))
            logger.image(step, f"val/target{sfx}", np.asarray(item["image"]))
            if rgb.shape[-1] > 3:
                logger.image(step, f"val/seg{sfx}", label2color(host(rgb[..., 3:15])))
            disp = out["disp_fine"] if out["disp_fine"] is not None else out["disp_coarse"]
            if disp is not None:
                d = host(disp)
                d = (d - d.min()) / max(d.max() - d.min(), 1e-8)
                logger.image(step, f"val/disparity{sfx}", d[..., None])
    logger.scalars(step, {"val/psnr": float(np.mean(psnrs)),
                          "val/psnr_coarse": float(np.mean(coarse_psnrs))})
    print(f"[VAL] Iter: {step} PSNR: {np.mean(psnrs):.3f} ({n} frames)")


if __name__ == "__main__":
    main()
