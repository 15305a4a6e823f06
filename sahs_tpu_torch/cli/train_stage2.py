"""Stage-II training CLI, the SPADE texture refinement (counterpart of
``sahs_tpu/cli/train_stage2.py``; reference
nerf-pytorch/train_get_texture_photo{,_audio}.py):

    python -m sahs_tpu_torch.cli.train_stage2 --config cfg.yml \
        [--load-checkpoint ckpt] [--max-epochs N] [--device cuda|cpu]

cfg.dataset.type picks the audio or the 3DMM variant. Frames go through
``train/stage2.make_scan_step`` in chunks of cfg.texture_refine.scan_frames;
the last chunk wraps round to its last frame, as the JAX package's does.
Every 2 epochs: the validation PSNR over up to 8 frames and a checkpoint
(``checkpoint_ep%04d.ckpt``: params, bufs and Adam's state, the
discriminator's too with use_gan), in the JAX package's layout, so that
either package resumes the other's. Runs on ``cuda`` unless ``--device``
names another device. Returns the final state.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..config import load_config
from ..data.audio import AudioDataset
from ..data.texture import identity_photo, spade_gt_dataset, spade_output_dataset
from ..train.stage2 import (Stage2Settings, init_stage2_state, load_vgg_params,
                            make_infer, make_scan_step)
from ..utils import checkpoint as ckpt_lib
from ..utils.device import resolve_device
from ..utils.logging import MetricLogger


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, required=True)
    ap.add_argument("--load-checkpoint", type=str, default="")
    ap.add_argument("--max-epochs", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to train on the CPU")
    cfg = load_config(args.config)
    audio_mode = cfg.dataset.type.lower() == "audio"

    gt_train = spade_gt_dataset("train", cfg)
    gt_val = spade_gt_dataset("val", cfg)
    out_train = spade_output_dataset("train", cfg)
    out_val = spade_output_dataset("val", cfg)
    n_train = min(len(gt_train), len(out_train), cfg.texture_refine.train_num
                  or len(out_train))
    n_val = min(len(gt_val), len(out_val), cfg.texture_refine.val_num
                or len(out_val))
    auds = AudioDataset("train", cfg).get_all_auds() if audio_mode else None

    s = Stage2Settings.from_config(cfg, steps_per_epoch=n_train)
    seed = cfg.experiment.randomseed
    vgg_net = (load_vgg_params(cfg.texture_refine.vgg_weights, seed, device=dev)
               if s.use_perceptual else None)
    state = init_stage2_state(s, seed=seed, device=dev)

    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    i_src = t(identity_photo(cfg))[None]
    scan_fn = make_scan_step(s, vgg_net=vgg_net)
    infer_fn = make_infer(s)
    K = max(1, s.scan_frames)

    logdir = os.path.join(cfg.experiment.logdir, cfg.experiment.id + "_stage2")
    logger = MetricLogger(logdir)

    if args.load_checkpoint and os.path.exists(args.load_checkpoint):
        state, _ = ckpt_lib.restore_stage2_state(args.load_checkpoint, state)
        print(f"resumed stage-2 from {args.load_checkpoint}")

    def stack_chunk(lo, hi):
        """Frames [lo, hi) stacked for the scan, indices past the last frame
        clipped to it: the last partial chunk wraps so every chunk has K
        frames (the repeated frames' extra updates match the reference's
        shuffle-free epoch up to step order)."""
        idxs = [min(i, n_train - 1) for i in range(lo, hi)]
        raws = t(np.stack([np.asarray(out_train[i])[None] for i in idxs]))
        tgts = t(np.stack([np.asarray(gt_train[i])[None] for i in idxs]))
        if audio_mode:
            return raws, tgts, t(np.stack([auds[min(i, len(auds) - 1)] for i in idxs]))
        return raws, tgts

    total_epochs = args.max_epochs or (s.epochs + s.epochs_decay)
    for epoch in range(total_epochs):
        for lo in range(0, n_train, K):
            state, m = scan_fn(state, i_src, *stack_chunk(lo, lo + K))
            if (lo // K) % max(1, cfg.texture_refine.log_iters // K) == 0:
                mm = {k: float(v[-1]) for k, v in m.items()}
                print(f"[S2] epoch {epoch} it {lo} loss {mm['loss']:.6f} "
                      f"psnr {mm['psnr']:.2f}")
                logger.scalars(state.step, {f"stage2/{k}": v for k, v in mm.items()})
        if epoch % 2 == 0:
            psnrs = []
            for i in range(min(n_val, 8)):
                raw, tgt = t(out_val[i])[None], t(gt_val[i])[None]
                aud = t(auds[min(i, len(auds) - 1)]) if audio_mode else None
                fake = infer_fn(state.generator, i_src, raw, aud)
                mse = float(torch.mean(torch.square(fake - tgt)))
                psnrs.append(-10 * np.log10(max(mse, 1e-10)))
            print(f"[S2 VAL] epoch {epoch} PSNR {np.mean(psnrs):.3f}")
            logger.scalars(state.step, {"stage2/val_psnr": float(np.mean(psnrs))})
            ckpt_lib.save_sections(
                os.path.join(logdir, f"checkpoint_ep{epoch:04d}.ckpt"),
                ckpt_lib.stage2_sections(state),
                scalars={"epoch": epoch, "step": int(state.step)})
    logger.close()
    return state


if __name__ == "__main__":
    main()
