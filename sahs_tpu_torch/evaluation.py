"""Stage-I evaluation: the full-frame renderer that serves a trained model,
the loop that renders a dataset to disk and its derived outputs
(counterpart of ``sahs_tpu/evaluation.py``; reference
nerf-pytorch/eval_stage_rays.py):
  - normal_map                :116-151  (finite-difference normals of the
                                         disparity map, cleaned by the last
                                         sample's weight map)
  - unproject_depth / save_point_cloud :42-71 (depth -> point cloud .obj)
  - cast_to_image / disparity, error images, per-image timing, output
    naming (f_%04d.png for expression, the source file name for audio)
                                         :480-553
The host-side math stays in numpy, as in the JAX package; images are
written through PIL (``utils/images.py``).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from .config import Config
from .models.nerface import ModelSpec, NeRFaceModel
from .render.pipeline import RenderSettings, render_image
from .utils.device import resolve_device
from .utils.images import imwrite
from .utils.seg import label2color


def normal_map(disp: np.ndarray, intrinsics: np.ndarray,
               weight_map: Optional[np.ndarray] = None, clean: bool = True,
               central_difference: bool = False) -> np.ndarray:
    """Disparity/depth map -> uint8 normal map (reference
    eval_stage_rays.py:116-151: cross products of forward differences of
    the unprojected point map; weight-mask cleanup at threshold 0.22).
    As the reference, ``Wd`` names the row count and scales ``cx``."""
    disp = np.asarray(disp, np.float32)
    Wd, Hd = disp.shape
    cx = intrinsics[2] * Wd
    cy = intrinsics[3] * Hd
    fx, fy = intrinsics[0], intrinsics[1]
    ii = np.broadcast_to(np.arange(Wd, dtype=np.float32)[None, :], disp.shape)
    jj = np.broadcast_to(np.arange(Hd, dtype=np.float32)[:, None], disp.shape)
    points = np.stack([((ii - cx) * disp) / fx,
                       -((jj - cy) * disp) / fy,
                       disp], axis=-1)
    d = 2 if central_difference else 1
    dx = points[d:, :, :] - points[:-d, :, :]
    dy = points[:, d:, :] - points[:, :-d, :]
    normals = np.cross(dy[:-d, :, :], dx[:, :-d, :])
    norm = np.sqrt(np.sum(normals * normals, axis=2, keepdims=True))
    normals = normals / np.maximum(norm, 1e-12)
    normals = normals * 0.5 + 0.5
    if clean and weight_map is not None:
        m = np.asarray(weight_map, np.float32)[..., None]
        m = m[:-d, :-d]
        normals = np.where(m > 0.22, 1.0, normals)
        normals = (1 - m) * normals + m
    return (normals * 255).astype(np.uint8)


def unproject_depth(depth: np.ndarray, intrinsics: np.ndarray,
                    pose: Optional[np.ndarray] = None) -> np.ndarray:
    """Depth map -> (N, 3) point cloud, (N, 4) world coordinates when a
    pose is given (reference eval_stage_rays.py:42-56); ``intrinsics`` in
    pixels, unscaled."""
    H, W = depth.shape
    u = np.broadcast_to(np.arange(W, dtype=np.float32)[None, :], depth.shape)
    v = np.broadcast_to(np.arange(H, dtype=np.float32)[:, None], depth.shape)
    x = (u - intrinsics[2]) * depth / intrinsics[0]
    y = (v - intrinsics[3]) * depth / intrinsics[1]
    pts = np.stack([x, y, depth], axis=-1).reshape(-1, 3)
    if pose is not None:
        p4 = np.eye(4, dtype=np.float32)
        p4[:3, :4] = pose[:3, :4]
        hom = np.concatenate([pts, np.ones((pts.shape[0], 1), np.float32)], 1)
        pts = (np.linalg.inv(p4) @ hom.T).T
    return pts


def save_point_cloud(pts: np.ndarray, path: str) -> None:
    with open(path, "w") as fp:
        fp.write("\n".join(f"v {p[0]} {p[1]} {p[2]}" for p in pts))


def dump_rays(points: np.ndarray, radiance_field: np.ndarray,
              path: str = "rays_small.ply", threshold: float = 0.9999996,
              stride: int = 100) -> int:
    """Debug dump of high-density sample points as a coloured ascii .ply
    (reference nerf_helpers.py:499-543 ``dump_rays``): points where
    sigmoid(relu(sigma)) > threshold over the raw field, then the
    reference's subsample (the first total // 10, every ``stride``-th
    written). points (R, S, 3); radiance_field (R, S, C >= 4), sigma at
    channel 3. Returns the number of vertices written."""
    points = np.asarray(points, np.float32)
    rf = np.asarray(radiance_field, np.float32)
    sig = 1.0 / (1.0 + np.exp(-np.maximum(rf[..., 3], 0.0)))
    ray_idx, depth_idx = np.where(sig > threshold)
    total = int(ray_idx.shape[0] // 10)
    keep = np.arange(0, total, stride)
    ray_idx, depth_idx = ray_idx[keep], depth_idx[keep]
    xyz = points[ray_idx, depth_idx]
    rgb = np.clip(rf[ray_idx, depth_idx, :3] * 255, 0, 255).astype(np.int32)
    with open(path, "w") as fid:
        fid.write("ply\nformat ascii 1.0\n"
                  f"element vertex {len(keep)}\n"
                  "property float x\nproperty float y\nproperty float z\n"
                  "property uchar red\nproperty uchar green\n"
                  "property uchar blue\nend_header\n")
        for p, c in zip(xyz, rgb):
            fid.write(f"{p[0]:f} {p[1]:f} {p[2]:f} {c[0]}  {c[1]} {c[2]}\n")
    return len(keep)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def cast_to_image(img) -> np.ndarray:
    return (np.clip(_host(img), 0.0, 1.0) * 255).astype(np.uint8)


def cast_to_disparity_image(disp) -> np.ndarray:
    d = _host(disp).astype(np.float32)
    d = d / max(float(d.max()), 1e-10)
    return (np.clip(d, 0, 1) * 255).astype(np.uint8)


def error_image(gt, pred) -> np.ndarray:
    """Per-pixel L2 error heat image as uint8 (the reference draws a
    matplotlib figure; this is its raw heat map, as in the JAX package)."""
    err = np.sqrt(np.sum((_host(gt).astype(np.float32)
                          - _host(pred).astype(np.float32)[..., :3]) ** 2, -1))
    err = err / max(float(err.max()), 1e-10)
    return (err * 255).astype(np.uint8)


def make_eval_renderer(spec: ModelSpec, settings: RenderSettings, H: int,
                       W: int, near: float, far: float,
                       chunksize: Optional[int] = None,
                       with_latent: bool = False, device=None, ray_group=None):
    """A full-image renderer on ``device`` (CUDA unless the caller names
    another; with no device given and no CUDA present this raises).
    ``ray_group`` (parallel/mesh.RayGroup; the JAX package's ``mesh=``,
    evaluation.py:134-173): each rank renders its block of every chunk and
    every rank gets the whole frame; each rank passes the same inputs and a
    generator in the same state.

    Returns render(model, intrinsics, pose, driving, background, generator
    [, latent_code]) -> dict of (H, W, ...) tensors, as render_image. The
    model must already be on the device; the other inputs are moved there.

    On CUDA with the kernel path, chunks are clamped to 32768 rays as the
    JAX package clamps them on the TPU: a fine chunk is then 4.19 M
    points at 64 + 64 samples (6.29 M at 64 + 128), and the plain versions
    used to check the kernels still fit in device memory at that size."""
    dev = resolve_device(device)
    if chunksize is None and settings.use_pallas and dev.type == "cuda":
        chunksize = min(settings.chunksize, 32768)

    def _to(x):
        if x is None:
            return None
        return torch.as_tensor(x, dtype=torch.float32).to(dev)

    def render(model, intrinsics, pose, driving, background=None,
               generator: Optional[torch.Generator] = None, latent_code=None):
        if with_latent and latent_code is None:
            raise ValueError("this renderer was built with_latent=True")
        return render_image(model, settings, H, W, _to(intrinsics), _to(pose),
                            near, far, _to(driving), generator=generator,
                            background=_to(background),
                            latent_code=_to(latent_code), chunksize=chunksize,
                            ray_group=ray_group)

    return render


def select_eval_latent_code(latent_codes, index_map=None,
                            fixed_row: int = 10) -> Optional[torch.Tensor]:
    """The reference's latent code at eval (eval_stage_rays.py:316-323,
    443-452): the checkpoint's per-train-frame codes are indexed through
    the dataset's ``index_map.npy`` at the hardcoded row 10 (clamped to the
    map's last row), and ONE fixed code serves every eval frame; without a
    map, or with a mapped index out of range, code 0. Returns a float32
    CPU tensor, or None without codes."""
    if latent_codes is None:
        return None
    codes = _host(latent_codes)
    idx = 0
    if index_map is not None:
        index_map = np.asarray(index_map).astype(int)
        row = min(fixed_row, index_map.shape[0] - 1)
        mapped = int(index_map[row, 1])
        if 0 <= mapped < codes.shape[0]:
            idx = mapped
    return torch.as_tensor(codes[idx], dtype=torch.float32)


def evaluate_dataset(cfg: Config, spec: ModelSpec, model: NeRFaceModel, dataset,
                     savedir: str, background=None,
                     save_disparity: bool = False, save_error: bool = False,
                     save_normals: bool = True, save_mesh: bool = False,
                     limit: int = 1500, seed: int = 0,
                     deterministic: bool = False,
                     latent_codes=None, latent_index_map=None,
                     frontalize: Optional[bool] = None, device=None,
                     ray_group=None):
    """The reference's eval loop (eval_stage_rays.py:355-556): renders
    every frame of ``dataset`` with ``model`` (already on ``device``:
    CUDA unless the caller names another), saves rgb, the colourised seg
    (masks/) and normals (normals/), and optionally disparity/, error/ and
    a point cloud (mesh/), and prints the running average time per image.
    Returns the per-frame seconds.

    ``deterministic``: perturb off and no sigma noise, on the config's own
    path (the JAX package rebuilds its settings from five fields there, so
    it renders on its plain path; the port keeps the kernel path).
    ``latent_codes``: the checkpoint's (num_train_frames, D) codes; one
    fixed code (``select_eval_latent_code``) serves every frame
    (eval_stage_rays.py:450-452). ``frontalize`` (default
    cfg.runtime.frontalize): every frame from frame 0's pose
    (eval_stage_rays.py:415-416). Random draws come from one torch
    generator seeded with ``seed``.

    Across several processes (``ray_group``, by default the run's group
    when it has more than one rank, as the JAX package takes a mesh when
    more than one device is visible, evaluation.py:232-242) every rank
    renders its block of each frame's rays and only rank 0 writes files
    and prints."""
    dev = resolve_device(device)
    if ray_group is None:
        from .parallel.mesh import make_ray_group
        ray_group = make_ray_group()
    lead = ray_group.rank == 0
    if ray_group.world == 1:
        ray_group = None
    settings = RenderSettings.from_config(cfg, "validation")
    if deterministic:
        settings = dataclasses.replace(settings, perturb=False,
                                       radiance_field_noise_std=0.0)
    subs = ("masks", "normals") + (("disparity",) if save_disparity else ()) \
        + (("error",) if save_error else ()) + (("mesh",) if save_mesh else ())
    for sub in subs if lead else ():
        os.makedirs(os.path.join(savedir, sub), exist_ok=True)

    H, W = dataset.H, dataset.W
    latent_code = select_eval_latent_code(latent_codes, latent_index_map)
    renderer = make_eval_renderer(spec, settings, H, W, float(cfg.dataset.near),
                                  float(cfg.dataset.far),
                                  with_latent=latent_code is not None, device=dev,
                                  ray_group=ray_group)
    if frontalize is None:
        frontalize = bool(getattr(cfg.runtime, "frontalize", False))
    gen = torch.Generator(device=dev).manual_seed(seed)
    times = []
    is_expression = cfg.dataset.type.lower() == "expression"
    n = min(len(dataset), limit)
    frontal_pose = dataset[0]["pose"] if frontalize else None
    with torch.no_grad():
        for i in range(n):
            item = dataset[i]
            t0 = time.time()
            pose = frontal_pose if frontalize else item["pose"]
            out = renderer(model, item["intrinsics"], pose, item["driving"],
                           background, gen, latent_code)
            rgb = _host(out["rgb_fine"] if out["rgb_fine"] is not None
                        else out["rgb_coarse"])
            disp = _host(out["disp_fine"] if out["disp_fine"] is not None
                         else out["disp_coarse"])
            # each pixel's weight of the last (background) sample, for the
            # normals' cleanup
            wmap = _host(out["weights"][:, -1]).reshape(H, W)
            times.append(time.time() - t0)
            if not lead:
                continue

            fname = (f"f_{i:04d}.png" if is_expression
                     else os.path.basename(item.get("fname", f"{i}.jpg")))
            stem = os.path.splitext(fname)[0]
            imwrite(os.path.join(savedir, fname), cast_to_image(rgb[..., :3]))
            if rgb.shape[-1] > 3:
                imwrite(os.path.join(savedir, "masks", stem + ".png"),
                        cast_to_image(label2color(rgb[..., 3:])))
            if save_normals:
                imwrite(os.path.join(savedir, "normals", stem + ".png"),
                        normal_map(disp, item["intrinsics"], wmap, clean=True))
            if save_disparity:
                imwrite(os.path.join(savedir, "disparity", stem + ".png"),
                        cast_to_disparity_image(disp))
            if save_error:
                imwrite(os.path.join(savedir, "error", stem + ".png"),
                        error_image(item["image"], rgb))
            if save_mesh and out["depth_fine"] is not None:
                pts = unproject_depth(_host(out["depth_fine"]), item["intrinsics"])
                save_point_cloud(pts, os.path.join(savedir, "mesh", stem + ".obj"))
            print(f"Avg time per image: {sum(times) / (i + 1):.3f}s")
    return times
