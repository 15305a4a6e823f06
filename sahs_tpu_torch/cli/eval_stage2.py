"""Stage-II evaluation CLI (counterpart of ``sahs_tpu/cli/eval_stage2.py``;
reference nerf-pytorch/eval_get_texture_photo_{3dmm,audio}.py): a
checkpoint, then for each frame G(identity, render[, audio]), clipped, to
a PNG or JPEG.

    python -m sahs_tpu_torch.cli.eval_stage2 --config cfg.yml \
        --checkpoint ckpt --savedir out/ [--limit N] [--device cuda|cpu]

Takes a native Stage-II checkpoint of either package or a reference
Generator checkpoint. Renders cfg.texture_refine.val_basedir's frames, at
most texture_refine.test_num (0: all) and ``--limit``; audio frames keep
their source names, expression frames are f_%04d.png. Runs on ``cuda``
unless ``--device`` names another device. Returns the frames' paths.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..config import load_config
from ..data.audio import AudioDataset
from ..data.texture import identity_photo, spade_output_dataset
from ..evaluation import cast_to_image
from ..models import spade
from ..train.stage2 import Stage2Settings, make_infer
from ..utils import checkpoint as ckpt_lib
from ..utils.device import resolve_device
from ..utils.images import imwrite


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, required=True)
    ap.add_argument("--checkpoint", type=str, required=True)
    ap.add_argument("--savedir", type=str, required=True)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to evaluate on the CPU")
    cfg = load_config(args.config)
    audio_mode = cfg.dataset.type.lower() == "audio"
    out_val = spade_output_dataset("val", cfg)
    n = min(len(out_val), cfg.texture_refine.test_num or len(out_val))
    if args.limit:
        n = min(n, args.limit)
    auds = AudioDataset("val", cfg).get_all_auds() if audio_mode else None

    if ckpt_lib.is_native_checkpoint(args.checkpoint):
        sections, _ = ckpt_lib.restore_sections(args.checkpoint)
        params, bufs = sections["params"], sections["bufs"]
    else:   # a released reference torch Generator checkpoint
        imported = ckpt_lib.import_torch_generator_checkpoint(args.checkpoint,
                                                              audio=audio_mode)
        params, bufs = imported["params"], imported["bufs"]
    generator = spade.from_jax(spade.Generator(audio=audio_mode).to(dev), params, bufs)

    s = Stage2Settings.from_config(cfg, steps_per_epoch=1)
    infer_fn = make_infer(s)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    i_src = t(identity_photo(cfg))[None]

    os.makedirs(args.savedir, exist_ok=True)
    written = []
    for i in range(n):
        aud = t(auds[min(i, len(auds) - 1)]) if audio_mode else None
        fake = infer_fn(generator, i_src, t(out_val[i])[None], aud)
        name = os.path.basename(out_val.paths[i]) if audio_mode else f"f_{i:04d}.png"
        written.append(os.path.join(args.savedir, name))
        imwrite(written[-1], cast_to_image(fake[0]))
    print(f"wrote {n} refined frames to {args.savedir}")
    return written


if __name__ == "__main__":
    main()
