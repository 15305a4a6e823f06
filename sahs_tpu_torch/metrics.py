"""Image metrics, folder against folder: PSNR / SSIM / L1 / LPIPS
(counterpart of ``sahs_tpu/metrics.py``; reference
nerf-pytorch/nerf/metrics.py:110-216, ``two_folders`` writing per-file and
summary lines to ``metrics.txt`` and L2 heat images).

PSNR, SSIM and L1 are the JAX package's numpy float64 code, so the numbers
are its numbers (SSIM is skimage's default algorithm: a uniform 7x7
window, K1 = 0.01, K2 = 0.03, the edge cropped). LPIPS comes from the
``lpips`` package if it is importable, else from ``lpips.py`` with the
weights of ``SAHS_LPIPS_WEIGHTS`` on the device, else it is left out.

    python -m sahs_tpu_torch.metrics --gt_path DIR --images_path DIR \
        [--device cuda|cpu]

Runs on ``cuda`` unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from .utils.device import full_float32, resolve_device
from .utils.images import imread, imwrite


class ScalarMetric:
    """Running mean (reference metrics.py:22-44)."""

    def __init__(self):
        self.aggregated_value = 0.0
        self.num_observations = 0.0

    def update(self, x):
        self.aggregated_value += x
        self.num_observations += 1

    def peek(self):
        return self.aggregated_value / (self.num_observations or 1)


def psnr(im1: np.ndarray, im2: np.ndarray, data_range: float = 1.0) -> float:
    mse = float(np.mean((im1.astype(np.float64) - im2.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range ** 2 / mse)


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """Valid-region uniform filter through integral images."""
    c = np.cumsum(np.cumsum(x, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)), mode="constant")
    s = (c[size:, size:] - c[:-size, size:] - c[size:, :-size]
         + c[:-size, :-size])
    return s / (size * size)


def ssim(im1: np.ndarray, im2: np.ndarray, data_range: float = 1.0,
         win_size: int = 7, K1: float = 0.01, K2: float = 0.03) -> float:
    """Channel-averaged SSIM, skimage's default algorithm (uniform window,
    sample covariance normalisation, edge crop)."""
    im1 = np.asarray(im1, np.float64)
    im2 = np.asarray(im2, np.float64)
    if im1.ndim == 2:
        im1 = im1[..., None]
        im2 = im2[..., None]
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    NP = win_size * win_size
    cov_norm = NP / (NP - 1)
    vals = []
    for c in range(im1.shape[-1]):
        x, y = im1[..., c], im2[..., c]
        ux = _uniform_filter(x, win_size)
        uy = _uniform_filter(y, win_size)
        uxx = _uniform_filter(x * x, win_size)
        uyy = _uniform_filter(y * y, win_size)
        uxy = _uniform_filter(x * y, win_size)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
        B1, B2 = ux ** 2 + uy ** 2 + C1, vx + vy + C2
        vals.append(np.mean((A1 * A2) / (B1 * B2)))
    return float(np.mean(vals))


def l1(im1: np.ndarray, im2: np.ndarray) -> float:
    return float(np.mean(np.abs(np.asarray(im1, np.float64)
                                - np.asarray(im2, np.float64))))


class LpipsPair:
    """LPIPS(alex) of two (H, W, 3) images in [0, 1] on ``device``: the
    ``lpips`` package if it is importable, else ``lpips.py`` with the
    weights of ``SAHS_LPIPS_WEIGHTS`` (read at the first call), else None
    (offline). Each is built once, at its first call, and runs in full
    float32 (no TF32)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._fn = None
        self._net = None
        self._loaded = False

    def __call__(self, im1: np.ndarray, im2: np.ndarray) -> Optional[float]:
        try:
            import lpips  # type: ignore
        except ImportError:
            lpips = None
        if lpips is not None:
            if self._fn is None:
                self._fn = lpips.LPIPS(net="alex").to(self.device)
            t = lambda im: torch.as_tensor(im.astype("float32"), device=self.device
                                           ).permute(2, 0, 1)[None]
            with torch.no_grad(), full_float32():
                return float(self._fn(t(im1), t(im2)).item())
        from .lpips import LpipsNet, load_lpips_params, lpips_distance
        if not self._loaded:
            params = load_lpips_params(os.environ.get("SAHS_LPIPS_WEIGHTS", ""))
            self._net = LpipsNet(params, self.device) if params is not None else None
            self._loaded = True
        if self._net is None:
            return None
        return lpips_distance(self._net, im1, im2)

    def label(self) -> str:
        """The label of reported LPIPS values: flags the uniform 1/C lin
        weights (torchvision-only checkpoints), so that numbers of the
        architecture alone are told from the reference's LPIPS."""
        if self._net is not None and self._net.uniform_lins:
            return "LPIPS(uniform-lin, NOT parity)"
        return "LPIPS"


def save_l2_image(im1: np.ndarray, im2: np.ndarray, outname: str) -> None:
    diff = np.linalg.norm(np.asarray(im1, np.float64)
                          - np.asarray(im2, np.float64), axis=2)
    diff = diff / max(float(diff.max()), 1e-10)
    imwrite(outname, (diff * 255).astype(np.uint8))


def _numeric_sort(files):
    return sorted(files, key=lambda f: int("".join(filter(str.isdigit, f)) or 0))


def two_folders(path_gt: str, path_generated: str,
                exts=(".png", ".jpg"), device=None) -> dict:
    """Folder against folder, with per-file lines and a summary block in
    ``<generated>/metrics.txt`` (reference metrics.py:110-186). LPIPS runs
    on ``device`` (CUDA unless the caller names another; with no device
    given and no CUDA present this raises)."""
    lpips_pair = LpipsPair(resolve_device(device))

    def listdir(p):
        return _numeric_sort([f for f in os.listdir(p)
                              if os.path.isfile(os.path.join(p, f))
                              and os.path.splitext(f)[1].lower() in exts])

    files_gt = listdir(path_gt)
    files_gen = listdir(path_generated)
    if len(files_gen) > len(files_gt):
        raise ValueError(f"more generated ({len(files_gen)}) than GT "
                         f"({len(files_gt)}) images")
    os.makedirs(os.path.join(path_generated, "L2"), exist_ok=True)

    S, P, L, LP = ScalarMetric(), ScalarMetric(), ScalarMetric(), ScalarMetric()
    have_lpips = True
    lines = []
    for fg, fr in zip(files_gen, files_gt):
        im_real = imread(os.path.join(path_gt, fr))[..., :3] / 255
        im_gen = imread(os.path.join(path_generated, fg))[..., :3] / 255
        if im_real.shape != im_gen.shape:
            raise ValueError(f"{fr} {im_real.shape} and {fg} {im_gen.shape} differ in shape")
        save_l2_image(im_real, im_gen,
                      os.path.join(path_generated, "L2",
                                   os.path.splitext(fg)[0] + ".png"))
        c_l1, c_psnr, c_ssim = l1(im_real, im_gen), psnr(im_real, im_gen), \
            ssim(im_real, im_gen)
        c_lpips = lpips_pair(im_real, im_gen) if have_lpips else None
        if c_lpips is None:
            have_lpips = False
        L.update(c_l1)
        P.update(c_psnr)
        S.update(c_ssim)
        if c_lpips is not None:
            LP.update(c_lpips)
        lines.append(f"{fg}   L1:  \t{c_l1:5f} \n"
                     f"{fg}   PSNR:\t{c_psnr:5f} \n"
                     f"{fg}   SSIM:\t{c_ssim:5f} \n"
                     f"{fg}   LPIPS:\t{c_lpips if c_lpips is not None else float('nan'):5f}\n\n")

    summary = {"L1": L.peek(), "PSNR": P.peek(), "SSIM": S.peek(),
               "LPIPS": LP.peek() if have_lpips else None}
    with open(os.path.join(path_generated, "metrics.txt"), "w") as fo:
        fo.writelines(lines)
        fo.write("=" * 80)
        fo.write(f"\n Summary \n folder 1: {path_gt} \n folder 2: {path_generated} \n")
        fo.write("-" * 80)
        fo.write("\n mean L1:\t%5f" % summary["L1"])
        fo.write("\n mean PSNR:\t%5f" % summary["PSNR"])
        fo.write("\n mean SSIM:\t%5f" % summary["SSIM"])
        if summary["LPIPS"] is not None:
            fo.write("\n mean %s\t%5f\n" % (lpips_pair.label(), summary["LPIPS"]))
        else:
            fo.write("\n mean LPIPS\tn/a (offline: no lpips package and no "
                     "SAHS_LPIPS_WEIGHTS file)\n")
    print(summary)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gt_path", type=str, required=True)
    ap.add_argument("--images_path", type=str, required=True)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to score on the CPU")
    return two_folders(args.gt_path, args.images_path, device=dev)


if __name__ == "__main__":
    main()
