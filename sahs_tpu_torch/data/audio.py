"""AD-NeRF-layout dataset, DeepSpeech audio driving (a copy of
``sahs_tpu/data/audio.py``; the port never imports the JAX package).

Layout as the reference's nerf-pytorch/nerf/audio_dataloader.py:13-188:
  basedir/aud.npy                       (N, 16, 29) DeepSpeech features
  basedir/transforms_{mode}.json:       focal_len, cx, cy, frames[]:
      img_id, aud_id, transform_matrix, optional face_rect
  images:      basedir/com_imgs/{img_id}.jpg
  parse maps:  basedir/com_imgs/masks/{img_id}.png
Intrinsics are [focal, focal, cx/H, cy/W] (audio_dataloader.py:34-37: the
reference divides cx by H and cy by W; kept for parity).
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from ..config import Config
from .common import FrameCache, _cv2, load_background


class AudioDataset:
    def __init__(self, mode: str, cfg: Config, testskip: int = 1,
                 debug: bool = False):
        self.mode = mode
        self.cfg = cfg
        basedir = cfg.dataset.basedir
        self.basedir = basedir
        self.load_segmaps = cfg.models.mask.use_mask
        debug = debug or cfg.dataset.debug

        aud_features = np.load(os.path.join(basedir, "aud.npy"))
        with open(os.path.join(basedir, f"transforms_{mode}.json")) as fp:
            metas = json.load(fp)

        frame0 = metas["frames"][0]
        im0 = _cv2().imread(self._img_path(frame0["img_id"]))
        if im0 is None:
            raise FileNotFoundError(self._img_path(frame0["img_id"]))
        self.H, self.W = im0.shape[:2]

        focal = float(metas["focal_len"])
        cx, cy = float(metas["cx"]), float(metas["cy"])
        self.intrinsics = np.array([focal, focal, cx / self.H, cy / self.W],
                                   np.float32)
        if debug:
            self.H //= 32
            self.W //= 32
            self.intrinsics = self.intrinsics.copy()
            self.intrinsics[:2] /= 32.0
        if cfg.dataset.half_res:
            self.H //= 2
            self.W //= 2
            self.intrinsics = self.intrinsics.copy()
            self.intrinsics[:2] *= 0.5

        frames = metas["frames"][::max(1, testskip)]
        self.poses = np.array([f["transform_matrix"] for f in frames], np.float32)
        self.auds = np.array(
            [aud_features[min(f["aud_id"], aud_features.shape[0] - 1)]
             for f in frames], np.float32)
        self.fnames = [self._img_path(f["img_id"]) for f in frames]
        self.segnames = [self._seg_path(f["img_id"]) for f in frames] \
            if self.load_segmaps else [None] * len(self.fnames)
        self._cache = FrameCache(len(self.fnames), self.H, self.W,
                                 self.load_segmaps)

    def _img_path(self, img_id) -> str:
        return os.path.join(self.basedir, "com_imgs", f"{img_id}.jpg")

    def _seg_path(self, img_id) -> str:
        return os.path.join(self.basedir, "com_imgs", "masks", f"{img_id}.png")

    def __len__(self) -> int:
        return self.poses.shape[0]

    def get_all_auds(self) -> np.ndarray:
        return self.auds

    def background(self):
        return load_background(self.basedir, "audio", self.H, self.W)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        self._cache.ensure(idx, self.fnames[idx], self.segnames[idx],
                           self.H, self.W)
        out = self._cache.frame(idx)
        out.update(
            pose=self.poses[idx][:3, :4],
            intrinsics=self.intrinsics,
            driving=self.auds[idx],
            frame_idx=np.int32(idx),
            fname=os.path.basename(self.fnames[idx]),
        )
        return out
