"""Synthetic fixture dataset (a copy of ``sahs_tpu/data/synthetic.py``; the
port never imports the JAX package).

The reference's NerFACE/AD-NeRF datasets are not redistributable, so tests,
benchmarks and CI smoke-train on a procedurally generated stand-in: random
camera poses orbiting a colored-blob "head" with concentric semantic regions
(face / nose / eyes / lips / hair / torso / background) plus random driving
vectors (76-d expression or (16,29) DeepSpeech-like windows) and a fixed
background. ``write_synthetic_dataset`` writes it to disk in both reference
layouts, so that the disk loaders (data/audio.py, data/nerface.py) run end
to end.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from ..utils.seg import PALETTE
from .common import _cv2, labels_to_onehot


def _look_at_pose(rng: np.random.RandomState, radius: float) -> np.ndarray:
    """Camera at a jittered position on a sphere, -z looking at the origin."""
    theta = rng.uniform(-0.3, 0.3)
    phi = rng.uniform(-0.2, 0.2)
    eye = radius * np.array([np.sin(theta) * np.cos(phi),
                             np.sin(phi),
                             np.cos(theta) * np.cos(phi)])
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = up
    c2w[:3, 2] = -fwd   # camera looks along -z
    c2w[:3, 3] = eye
    return c2w


def _render_frame(h: int, w: int, seed: int):
    """Procedural face-ish image + parse labels."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cx = w / 2 + rng.uniform(-w * 0.05, w * 0.05)
    cy = h / 2 + rng.uniform(-h * 0.05, h * 0.05)
    r = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2) / (0.5 * min(h, w))
    labels = np.zeros((h, w), np.uint8)           # background
    labels[r < 0.8] = 9                            # hair
    labels[r < 0.6] = 1                            # face
    labels[r < 0.15] = 2                           # nose
    labels[(r > 0.2) & (r < 0.3) & (yy < cy)] = 4  # eyes
    labels[(r < 0.25) & (yy > cy + 0.25 * h / 2)] = 8   # lips
    labels[(r < 0.12) & (yy > cy + 0.3 * h / 2)] = 7    # mouth interior
    labels[yy > cy + 0.45 * h] = 11                # torso
    base = PALETTE[labels].astype(np.float32) / 255.0
    tint = rng.uniform(0.6, 1.0, size=(1, 1, 3)).astype(np.float32)
    img = np.clip(base * tint + rng.normal(0, 0.02, base.shape), 0, 1)
    return img.astype(np.float32), labels


class SyntheticFaceDataset:
    """In-memory fixture with the same item schema as NerfaceDataset /
    AudioDataset."""

    def __init__(self, kind: str = "audio", num_frames: int = 8, H: int = 64,
                 W: int = 64, seed: int = 0, near: float = 0.48,
                 far: float = 1.08):
        assert kind in ("audio", "expression")
        rng = np.random.RandomState(seed)
        self.kind = kind
        self.H, self.W = H, W
        focal = 1.2 * W
        self.intrinsics = np.array([focal, focal, 0.5, 0.5], np.float32)
        mid = 0.5 * (near + far)
        self.poses = np.stack([_look_at_pose(rng, mid)[:3, :4]
                               for _ in range(num_frames)]).astype(np.float32)
        frames = [_render_frame(H, W, seed * 1000 + i)
                  for i in range(num_frames)]
        self.images = np.stack([f[0] for f in frames])
        self.labels = np.stack([f[1] for f in frames])
        if kind == "audio":
            self.driving = rng.randn(num_frames, 16, 29).astype(np.float32)
        else:
            self.driving = (rng.randn(num_frames, 76) * 0.1).astype(np.float32)
        bg_img, _ = _render_frame(H, W, seed + 77777)
        self._bg = np.concatenate(
            [bg_img, np.ones((H, W, 1), np.float32),
             np.zeros((H, W, 11), np.float32)], axis=-1)

    def __len__(self):
        return self.poses.shape[0]

    def background(self) -> np.ndarray:
        return self._bg

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return {
            "image": self.images[idx],
            "mask": labels_to_onehot(self.labels[idx]),
            "pose": self.poses[idx],
            "intrinsics": self.intrinsics,
            "driving": self.driving[idx],
            "frame_idx": np.int32(idx),
            "fname": f"f_{idx:04d}.png",
        }


def write_synthetic_dataset(basedir: str, kind: str = "audio",
                            num_frames: int = 4, H: int = 64, W: int = 64,
                            seed: int = 0, modes=("train", "val")) -> None:
    """Write a synthetic dataset to disk in the reference's layout (the
    JAX package's writer, file for file), so that the disk loaders can be
    tested end to end. Needs OpenCV."""
    cv2 = _cv2()
    ds = SyntheticFaceDataset(kind, num_frames * len(modes), H, W, seed)
    os.makedirs(basedir, exist_ok=True)

    def write_mask(path, labels):
        # parse maps are stored BGR-matched (data/common.read_parse_map)
        cv2.imwrite(path, PALETTE[labels].astype(np.uint8))

    def pose4(g):
        return np.vstack([ds.poses[g], [0, 0, 0, 1]]).tolist()

    if kind == "audio":
        np.save(os.path.join(basedir, "aud.npy"), ds.driving)
        imdir = os.path.join(basedir, "com_imgs")
        os.makedirs(os.path.join(imdir, "masks"), exist_ok=True)
        cv2.imwrite(os.path.join(basedir, "bc.jpg"),
                    (ds._bg[..., 2::-1] * 255).astype(np.uint8))
        for m, mode in enumerate(modes):
            frames = []
            for i in range(num_frames):
                g = m * num_frames + i
                cv2.imwrite(os.path.join(imdir, f"{g}.jpg"),
                            (ds.images[g][..., ::-1] * 255).astype(np.uint8))
                write_mask(os.path.join(imdir, "masks", f"{g}.png"), ds.labels[g])
                frames.append({"img_id": g, "aud_id": g,
                               "transform_matrix": pose4(g)})
            meta = {"focal_len": float(ds.intrinsics[0]),
                    "cx": float(ds.intrinsics[2] * H),
                    "cy": float(ds.intrinsics[3] * W),
                    "frames": frames}
            with open(os.path.join(basedir, f"transforms_{mode}.json"), "w") as fp:
                json.dump(meta, fp)
    else:
        os.makedirs(os.path.join(basedir, "bg"), exist_ok=True)
        cv2.imwrite(os.path.join(basedir, "bg", "00050.png"),
                    (ds._bg[..., 2::-1] * 255).astype(np.uint8))
        for m, mode in enumerate(modes):
            mdir = os.path.join(basedir, mode)
            os.makedirs(os.path.join(mdir, "masks"), exist_ok=True)
            frames = []
            for i in range(num_frames):
                g = m * num_frames + i
                name = f"{g:04d}"
                cv2.imwrite(os.path.join(mdir, name + ".png"),
                            (ds.images[g][..., ::-1] * 255).astype(np.uint8))
                write_mask(os.path.join(mdir, "masks", name + ".png"), ds.labels[g])
                frames.append({"file_path": name, "transform_matrix": pose4(g),
                               "expression": ds.driving[g].tolist()})
            meta = {"camera_angle_x": float(2 * np.arctan(0.5 * W / ds.intrinsics[0])),
                    "intrinsics": [float(v) for v in ds.intrinsics],
                    "frames": frames}
            with open(os.path.join(basedir, f"transforms_{mode}.json"), "w") as fp:
                json.dump(meta, fp)
