"""NerFACE-layout dataset, 3DMM expression driving (a copy of
``sahs_tpu/data/nerface.py``; the port never imports the JAX package).

Layout as the reference's nerf-pytorch/nerf/nerface_dataloader.py:13-185:
  basedir/transforms_{mode}.json:
    camera_angle_x, optional intrinsics [fx fy cx cy], frames[]:
      file_path, transform_matrix (4x4), expression (76), optional bbox
  images:      basedir/{mode}/{file_path}.png
  parse maps:  basedir/{mode}/masks/{file_path}.png
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from ..config import Config
from .common import FrameCache, _cv2, load_background


class NerfaceDataset:
    def __init__(self, mode: str, cfg: Config, debug: bool = False):
        self.mode = mode
        self.cfg = cfg
        basedir = cfg.dataset.basedir
        self.basedir = basedir
        self.load_segmaps = cfg.models.mask.use_mask
        debug = debug or cfg.dataset.debug

        with open(os.path.join(basedir, f"transforms_{mode}.json")) as fp:
            metas = json.load(fp)

        frame0 = metas["frames"][0]
        im0 = _cv2().imread(self._img_path(frame0["file_path"]))
        if im0 is None:
            raise FileNotFoundError(self._img_path(frame0["file_path"]))
        self.H, self.W = im0.shape[:2]

        camera_angle_x = float(metas.get("camera_angle_x", 0.6911))
        focal = 0.5 * self.W / np.tan(0.5 * camera_angle_x)
        if metas.get("intrinsics"):
            self.intrinsics = np.array(metas["intrinsics"], np.float32)
        else:
            self.intrinsics = np.array([focal, focal, 0.5, 0.5], np.float32)

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

        self.poses = np.array([f["transform_matrix"] for f in metas["frames"]],
                              np.float32)
        self.expressions = np.array([f["expression"] for f in metas["frames"]],
                                    np.float32)
        self.bboxs = []
        for f in metas["frames"]:
            if "bbox" not in f:
                self.bboxs.append(np.array([0.0, 1.0, 0.0, 1.0]))
            else:
                b = np.array(f["bbox"], np.float64)
                b[0:2] *= self.H
                b[2:4] *= self.W
                self.bboxs.append(np.floor(b).astype(np.int32))
        self.fnames = [self._img_path(f["file_path"]) for f in metas["frames"]]
        self.segnames = [self._seg_path(f["file_path"]) for f in metas["frames"]] \
            if self.load_segmaps else [None] * len(self.fnames)
        self._cache = FrameCache(len(self.fnames), self.H, self.W,
                                 self.load_segmaps)
        # RGBA frames composited onto white at decode (common.imread_rgb_white)
        self.white_background = bool(cfg.nerf.train.white_background)

    def _img_path(self, file_path: str) -> str:
        return os.path.join(self.basedir, self.mode, file_path + ".png")

    def _seg_path(self, file_path: str) -> str:
        return os.path.join(self.basedir, self.mode, "masks", file_path + ".png")

    def __len__(self) -> int:
        return self.poses.shape[0]

    def background(self):
        return load_background(self.basedir, "expression", self.H, self.W)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        self._cache.ensure(idx, self.fnames[idx], self.segnames[idx],
                           self.H, self.W,
                           white_background=self.white_background)
        out = self._cache.frame(idx)
        out.update(
            pose=self.poses[idx][:3, :4],
            intrinsics=self.intrinsics,
            driving=self.expressions[idx],
            bbox=np.asarray(self.bboxs[idx]),
            frame_idx=np.int32(idx),
            fname=os.path.basename(self.fnames[idx]),
        )
        return out
