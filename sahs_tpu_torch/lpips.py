"""LPIPS(alex): the architecture and a torch-weight importer, without the
``lpips`` or torchvision packages (counterpart of ``sahs_tpu/lpips.py``).

The reference computes LPIPS with the ``lpips`` package (reference
nerf-pytorch/nerf/metrics.py:95-107,160: ``lpips.LPIPS(net='alex')``),
which downloads its weights. This module computes the same thing from a
local weight file:

  d(x, y) = sum_l mean_hw( lin_l · (nx_l - ny_l)^2 )

where nx_l / ny_l are the channel-unit-normalised AlexNet activations
(after each of the 5 ReLUs) of the inputs scaled to [-1, 1] and
channel-standardised, and lin_l the LPIPS-learned nonnegative 1x1 weights.
The convolutions run in ``F.conv2d`` on the device the caller names.

Weights: ``load_lpips_params(path)`` reads a local ``.pth`` only: a full
``lpips.LPIPS`` state_dict (net.slice*.<i>.weight + lin*.model.1.weight)
or a torchvision ``alexnet`` state_dict (features.<i>.weight; the lin
weights are then 1/C, which is NOT the reference's LPIPS, and the params
carry ``uniform_lins``). Nothing is downloaded.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .utils.device import full_float32

# AlexNet's feature convs: (out_ch, in_ch, kernel, stride, pad), with a
# 3x3/2 max-pool after taps 0 and 1
_CONVS = [(64, 3, 11, 4, 2), (192, 64, 5, 1, 2), (384, 192, 3, 1, 1),
          (256, 384, 3, 1, 1), (256, 256, 3, 1, 1)]
_POOL_AFTER = {0, 1}
# LPIPS's input scaling layer (lpips/lpips.py ScalingLayer constants)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LpipsNet:
    """The weights of ``params`` (numpy, as ``load_lpips_params`` or
    ``random_params`` give them) as tensors on ``device``."""

    def __init__(self, params: Dict, device):
        dev = torch.device(device)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        self.device = dev
        self.convs = [(t(c["w"]), t(c["b"])) for c in params["convs"]]
        self.lins = [t(l).view(1, -1, 1, 1) for l in params["lins"]]
        self.shift = t(_SHIFT).view(1, 3, 1, 1)
        self.scale = t(_SCALE).view(1, 3, 1, 1)
        self.uniform_lins = bool(params.get("uniform_lins", False))


def alex_features(net: LpipsNet, x: torch.Tensor) -> List[torch.Tensor]:
    """x (N, 3, H, W) in [-1, 1] -> the 5 tap activations (after ReLU)."""
    h = (x - net.shift) / net.scale
    taps = []
    for i, ((w, b), (_, _, _, s, p)) in enumerate(zip(net.convs, _CONVS)):
        h = F.relu(F.conv2d(h, w, b, stride=s, padding=p))
        taps.append(h)
        if i in _POOL_AFTER:
            h = F.max_pool2d(h, 3, stride=2)
    return taps


@torch.no_grad()
@full_float32()
def lpips_distance(net: LpipsNet, x, y) -> float:
    """LPIPS(alex) between x and y, each (H, W, 3) in [0, 1] (numpy or
    tensors), computed on ``net``'s device in full float32 (no TF32)."""
    def prep(im):
        im = torch.as_tensor(np.asarray(im, np.float32), device=net.device)
        return (im * 2.0 - 1.0).permute(2, 0, 1)[None]

    d = torch.zeros((), device=net.device)
    for ax, ay, lin in zip(alex_features(net, prep(x)),
                           alex_features(net, prep(y)), net.lins):
        nx = ax / torch.sqrt(torch.sum(ax * ax, dim=1, keepdim=True) + 1e-10)
        ny = ay / torch.sqrt(torch.sum(ay * ay, dim=1, keepdim=True) + 1e-10)
        d = d + torch.mean(torch.sum((nx - ny) ** 2 * lin, dim=1))
    return float(d)


def load_lpips_params(path: str) -> Optional[Dict]:
    """Conv and lin weights (numpy) from a local torch ``.pth``: a full
    ``lpips.LPIPS`` state_dict, or a torchvision ``alexnet`` one (lin
    weights uniform 1/C, architecture only). None when ``path`` is empty
    or missing, or the file lacks a conv of the right width."""
    if not path or not os.path.exists(path):
        return None
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}

    def find(*suffixes) -> Dict[str, np.ndarray]:
        out = {}
        for k, v in sd.items():
            for sfx in suffixes:
                if k.endswith(sfx):
                    out[sfx] = v
        return out

    convs = []
    # convs are net.slice<j>.<i>.weight (lpips) or features.<i>.weight
    # (torchvision); both index them 0, 3, 6, 8, 10
    for li, ci in enumerate([0, 3, 6, 8, 10]):
        got = find(f".{ci}.weight", f".{ci}.bias")
        w = got.get(f".{ci}.weight")
        b = got.get(f".{ci}.bias")
        if w is None or w.shape[0] != _CONVS[li][0]:
            return None
        convs.append({"w": w, "b": b})
    lins = []
    for l in range(5):
        key = [k for k in sd if f"lin{l}" in k and k.endswith("weight")]
        if key:
            lins.append(np.maximum(sd[key[0]][:, :, 0, 0][0], 0.0))
        else:
            C = _CONVS[l][0]
            lins.append(np.full((C,), 1.0 / C, np.float32))
    uniform = not any(f"lin{l}" in k for l in range(5) for k in sd)
    if uniform:
        print("lpips: no lin weights in checkpoint — using uniform 1/C "
              "(NOT reference-parity)")
    # "uniform_lins" goes into the metrics.txt label, so that numbers of
    # the architecture alone are never taken for the reference's LPIPS
    return {"convs": convs, "lins": lins, "uniform_lins": uniform}


def random_params(seed: int = 0) -> Dict:
    """Random weights (tests and architecture checks only), the JAX
    package's draw."""
    rng = np.random.RandomState(seed)
    convs = [{"w": (rng.randn(o, i, k, k) * (1.0 / np.sqrt(i * k * k)))
              .astype(np.float32),
              "b": rng.randn(o).astype(np.float32) * 0.1}
             for (o, i, k, _, _) in _CONVS]
    lins = [np.abs(rng.randn(o).astype(np.float32)) for (o, _, _, _, _)
            in _CONVS]
    return {"convs": convs, "lins": lins}
