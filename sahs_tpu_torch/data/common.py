"""Shared host-side data utilities (a copy of ``sahs_tpu/data/common.py``;
the port never imports the JAX package).

Frames are decoded once into compact uint8 caches (images) and uint8 label
maps (parse masks), and expanded to float / one-hot per item. OpenCV is
imported where a file is read or written, as in the JAX package: the
in-memory synthetic dataset needs none, and without ``cv2`` a disk loader
raises an ImportError that names it. Parse maps are matched against the
palette in numpy (the JAX package's C++ codec, ``sahs_tpu/native``, is its
fast path only; the numpy path gives the same labels).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..utils.seg import NUM_CLASSES, PALETTE


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("reading or writing the on-disk datasets needs "
                          "OpenCV (cv2), which is not installed") from e
    return cv2


def imread_rgb(path: str) -> np.ndarray:
    """uint8 RGB image."""
    cv2 = _cv2()
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def imread_rgb_white(path: str) -> np.ndarray:
    """uint8 RGB image with any alpha channel composited onto white: rgb a
    + (1 - a), the white_background semantics the reference intends
    (nerface_dataloader.py:175-176; its own reader never sees an alpha
    plane). A file without alpha reads as plain RGB."""
    cv2 = _cv2()
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 3 and img.shape[2] == 4:
        a = img[..., 3:4].astype(np.float32) / 255.0
        rgb = cv2.cvtColor(img[..., :3], cv2.COLOR_BGR2RGB).astype(np.float32)
        return np.clip(rgb * a + (1.0 - a) * 255.0, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        return cv2.cvtColor(img, cv2.COLOR_GRAY2RGB)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def resize_area(img: np.ndarray, h: int, w: int) -> np.ndarray:
    if img.shape[0] == h and img.shape[1] == w:
        return img
    cv2 = _cv2()
    return cv2.resize(img, dsize=(w, h), interpolation=cv2.INTER_AREA)


def palette_labels(bgr: np.ndarray) -> np.ndarray:
    """(H, W, 3) BGR-read parse map -> (H, W) uint8 class labels; a pixel
    that matches no palette entry is background."""
    flat = bgr.reshape(-1, 3).astype(np.int32)
    eq = (flat[:, None, :] == PALETTE[None, :, :]).all(axis=-1)
    labels = np.where(eq.any(axis=-1), eq.argmax(axis=-1), 0).astype(np.uint8)
    return labels.reshape(bgr.shape[:2])


def read_parse_map(path: str, h: int, w: int) -> np.ndarray:
    """Disk parse map -> (H, W) uint8 class labels. The reference reads
    parse maps with cv2 (BGR) and matches them against the RGB palette
    (nerface_dataloader.py:180-183, utils.py:27-66): the files store the
    palette's colours in BGR order, and the BGR-read pixels are matched
    against the RGB palette, as the reference does. The match runs in the
    host C++ codec (``native.palette_to_labels``; ``palette_labels`` is its
    plain version)."""
    from ..native import palette_to_labels
    cv2 = _cv2()
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    if bgr is None:
        raise FileNotFoundError(path)
    labels = palette_to_labels(bgr)
    if labels.shape != (h, w):
        labels = cv2.resize(labels, dsize=(w, h), interpolation=cv2.INTER_NEAREST)
    return labels


def labels_to_onehot(labels: np.ndarray) -> np.ndarray:
    """(H, W) class labels -> (H, W, 12) one-hot float32."""
    return np.eye(NUM_CLASSES, dtype=np.float32)[labels]


def gaussian_blur(img: np.ndarray, kernel_size: int = 11,
                  sigma: float = 11.0) -> np.ndarray:
    """Depthwise gaussian blur for the optional blurred-background init
    (reference GaussianSmoothing, nerf/train_utils.py:409-473 and
    train_stage_rays_auto.py:147-152)."""
    return _cv2().GaussianBlur(img, (kernel_size, kernel_size), sigma)


def _pad15(rgb: np.ndarray) -> np.ndarray:
    """rgb (H, W, 3) -> rgb, the background class's one-hot and 11 zeros."""
    h, w = rgb.shape[:2]
    return np.concatenate([rgb[..., :3], np.ones((h, w, 1), np.float32),
                           np.zeros((h, w, 11), np.float32)], axis=-1)


def average_background(images: np.ndarray, blur: bool = False) -> np.ndarray:
    """Trainable-background initialisation: the mean over the training
    frames, optionally blurred (reference train_stage_rays_auto.py:143-157),
    padded to 15 channels."""
    avg = np.mean(images, axis=0).astype(np.float32)
    if blur:
        avg = gaussian_blur(avg)
    return _pad15(avg)


def load_background(basedir: str, dataset_type: str, h: int, w: int
                    ) -> Optional[np.ndarray]:
    """The fixed background image padded to 15 channels: rgb (3), the
    background class's one-hot (1), zeros (11) (reference
    train_stage_rays_auto.py:159-174); expression datasets read
    bg/00050.png, audio datasets bc.jpg. None when the file is missing."""
    if dataset_type.lower() == "expression":
        path = os.path.join(basedir, "bg", "00050.png")
    else:
        path = os.path.join(basedir, "bc.jpg")
    if not os.path.exists(path):
        return None
    # the reference's PIL.thumbnail keeps the aspect; the datasets are
    # square, so a plain resize is the same
    img = resize_area(imread_rgb(path), h, w).astype(np.float32) / 255.0
    return _pad15(img)


class FrameCache:
    """Decode-once in-RAM store: uint8 images and uint8 label maps."""

    def __init__(self, n: int, h: int, w: int, with_seg: bool):
        self.images = np.zeros((n, h, w, 3), np.uint8)
        self.labels = np.zeros((n, h, w), np.uint8) if with_seg else None
        self.loaded = np.zeros((n,), bool)

    def ensure(self, idx: int, img_path: str, seg_path: Optional[str],
               h: int, w: int, white_background: bool = False):
        if self.loaded[idx]:
            return
        reader = imread_rgb_white if white_background else imread_rgb
        self.images[idx] = resize_area(reader(img_path), h, w)
        if self.labels is not None and seg_path is not None:
            self.labels[idx] = read_parse_map(seg_path, h, w)
        self.loaded[idx] = True

    def frame(self, idx: int) -> Dict[str, np.ndarray]:
        out = {"image": self.images[idx].astype(np.float32) / 255.0}
        if self.labels is not None:
            out["mask"] = labels_to_onehot(self.labels[idx])
        return out
