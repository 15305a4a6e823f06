"""Stage-I evaluation CLI (counterpart of ``sahs_tpu/cli/eval_stage1.py``;
reference nerf-pytorch/eval_stage_rays.py):

    python -m sahs_tpu_torch.cli.eval_stage1 --config cfg.yml \
        --checkpoint ckpt --savedir out/ [--save-disparity-image] \
        [--save-error-image] [--save-mesh] [--no-normals] [--deterministic] \
        [--frontalize] [--synthetic] [--limit N] [--device cuda|cpu]

Renders the validation set (``build_dataset`` of ``cli/train_stage1.py``)
through ``evaluation.evaluate_dataset``. Takes the native checkpoints of
either package (the npz schema of ``utils/checkpoint.py``) and reference
torch checkpoints. Runs on ``cuda`` unless ``--device`` names another
device.

Across several cards, one process each (the JAX package's eval mesh,
evaluation.py:232-242):

    torchrun --nproc_per_node=N -m sahs_tpu_torch.cli.eval_stage1 ...

every rank renders its block of each frame's rays (``evaluate_dataset``
takes the run's group) and only rank 0 writes files. NCCL on CUDA, gloo
with ``--device cpu``.

Rank 0 ends with one line ``[PROGRAM] {...}``: the process's phase
aggregates and counters (utils/profiling.snapshot). ``kernels.built``
is absent (0) when every kernel library was already built (a count
names a slow start); ``fold.built`` and ``fold.reused`` are the folded weights a run
built and reused (``serve.frame``'s count gives them a frame);
``serve.chunks`` the chunks rendered.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..config import load_config
from ..evaluation import evaluate_dataset
from ..models.nerface import ModelSpec, NeRFaceModel
from ..parallel import mesh
from ..utils import checkpoint as ckpt_lib
from ..utils import profiling
from ..utils.device import resolve_device
from ..utils.weights import params_from_jax
from .train_stage1 import build_dataset


def load_any_checkpoint(path: str, spec):
    """-> (the model's parameter tree, extras). A native checkpoint is told
    by its schema header; anything else goes to the reference torch
    importer. A corrupt native file raises CheckpointError rather than
    falling through."""
    if ckpt_lib.is_native_checkpoint(path):
        entries, schema = ckpt_lib.load_checkpoint(path)
        params = ckpt_lib.unflatten_params(entries)
        extras = {k: v for k, v in entries.items() if "|" not in k}
        # the parameter groups trained beside the model (the train state's
        # tree: background, latent_codes)
        for k in ("background", "latent_codes"):
            if k in params and k not in extras:
                extras[k] = params[k]
        extras.update(schema.get("scalars", {}))
        return params["model"], extras
    imported = ckpt_lib.import_torch_checkpoint(path, spec)
    return imported["model"], imported


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, required=True)
    ap.add_argument("--checkpoint", type=str, required=True)
    ap.add_argument("--savedir", type=str, required=True)
    ap.add_argument("--save-disparity-image", action="store_true")
    ap.add_argument("--save-error-image", action="store_true")
    ap.add_argument("--save-mesh", action="store_true")
    ap.add_argument("--no-normals", action="store_true")
    ap.add_argument("--deterministic", action="store_true",
                    help="perturb=False, noise=0 (parity mode)")
    ap.add_argument("--frontalize", action="store_true",
                    help="render every frame from frame 0's pose "
                         "(reference eval_stage_rays.py:376,415-416)")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--limit", type=int, default=1500)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    if resolve_device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to evaluate on the CPU")
    with mesh.run_group(args.device) as group:
        return _evaluate(args, group)


def _evaluate(args, group: mesh.RayGroup):
    dev = mesh.rank_device(args.device)
    cfg = load_config(args.config)
    spec = ModelSpec.from_config(cfg)
    tree, extras = load_any_checkpoint(args.checkpoint, spec)
    model = params_from_jax(NeRFaceModel.init(spec, device="cpu"), tree).to(dev)

    val_data = build_dataset(cfg, "val", args.synthetic)
    background = extras.get("background")
    if background is None:
        background = val_data.background()

    # the checkpoint's latent codes go into every render through the
    # dataset's index map (reference eval_stage_rays.py:316-323,450-452)
    latent_codes = extras.get("latent_codes")
    index_map = None
    if latent_codes is not None:
        map_path = os.path.join(str(cfg.dataset.basedir), "index_map.npy")
        if os.path.exists(map_path):
            index_map = np.load(map_path)

    if group.rank == 0:
        os.makedirs(args.savedir, exist_ok=True)
    result = evaluate_dataset(cfg, spec, model, val_data, args.savedir,
                            background=background,
                            save_disparity=args.save_disparity_image,
                            save_error=args.save_error_image,
                            save_mesh=args.save_mesh,
                            save_normals=not args.no_normals,
                            limit=args.limit,
                            deterministic=args.deterministic,
                            latent_codes=latent_codes,
                            latent_index_map=index_map,
                            frontalize=args.frontalize or None, device=dev)
    if group.rank == 0:
        print("[PROGRAM] " + json.dumps(profiling.snapshot(), sort_keys=True), flush=True)
    return result


if __name__ == "__main__":
    main()
