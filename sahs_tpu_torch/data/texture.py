"""Stage-II texture-refinement datasets (a copy of
``sahs_tpu/data/texture.py``; reference nerf-pytorch/nerf/texture_loader.py):
  - spade_gt_dataset: the ground-truth frames (expression:
    basedir/{mode}/<file_path>.png; audio: basedir/com_imgs/{img_id}.jpg)
  - spade_output_dataset: the Stage-I renders in
    cfg.texture_refine.{train,test,val}_basedir (files only, in numeric
    order: f_%04d.png for expression, the source file names for audio)
All return float32 HWC images in [0, 1].
"""
from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from ..config import Config
from .common import imread_rgb


class _ImageFolder:
    def __init__(self, paths: List[str]):
        self.paths = paths

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int) -> np.ndarray:
        return imread_rgb(self.paths[idx]).astype(np.float32) / 255.0


def spade_gt_dataset(mode: str, cfg: Config) -> _ImageFolder:
    """The ground-truth frames that supervise Stage II."""
    basedir = cfg.dataset.basedir
    with open(os.path.join(basedir, f"transforms_{mode}.json")) as fp:
        metas = json.load(fp)
    if cfg.dataset.type.lower() == "audio":
        paths = [os.path.join(basedir, "com_imgs", f"{f['img_id']}.jpg")
                 for f in metas["frames"]]
    else:
        paths = [os.path.join(basedir, mode, f["file_path"] + ".png")
                 for f in metas["frames"]]
    return _ImageFolder(paths)


def spade_output_dataset(mode: str, cfg: Config) -> _ImageFolder:
    """The Stage-I renders (the generator's input)."""
    tr = cfg.texture_refine
    basedir = {"train": tr.train_basedir, "test": tr.test_basedir,
               "val": tr.val_basedir}[mode]
    files = sorted(
        [f for f in os.listdir(basedir)
         if os.path.splitext(f)[1].lower() in (".png", ".jpg")
         and os.path.isfile(os.path.join(basedir, f))],
        key=lambda f: int("".join(filter(str.isdigit, f)) or 0))
    return _ImageFolder([os.path.join(basedir, f) for f in files])


def identity_photo(cfg: Config) -> np.ndarray:
    """The fixed identity photo that conditions the generator
    (reference train_get_texture_photo_audio.py:34-44,152-156)."""
    return imread_rgb(cfg.texture_refine.texture_photo).astype(np.float32) / 255.0
