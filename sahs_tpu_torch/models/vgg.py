"""VGG19 feature slices for the Stage-II perceptual loss (counterpart of
``sahs_tpu/models/vgg.py``; reference nerf-pytorch/nerf/_init_spade.py
:415-451): torchvision vgg19's ``features`` cut into five slices ending at
relu1_1, relu2_1, relu3_1, relu4_1 and relu5_1, with the SPADE perceptual
weights [1/32, 1/16, 1/8, 1/4, 1].

The reference loads ImageNet weights through ``models.vgg19(pretrained=
True)``; here ``import_torch_vgg_features`` takes a local torchvision
``vgg19().features.state_dict()`` (or a whole model's, with the
``features.`` prefix), and ``vgg19_features_init`` builds the same
architecture with torch's default random init (architecture checks only).
All convs are 3x3 pad 1, pooling is 2x2 max. Inputs are NCHW in [0, 1];
``normalize_input`` is the reference's normalisation (x + 0.5, then the
ImageNet mean and std: it assumed inputs in [-0.5, 0.5]). The weights are
frozen: no parameter of this module is trained.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# torchvision vgg19's ``features`` convs in the reference's 5 slices, each
# ("conv", torch index, cin, cout) or "pool"; slice k ends at relu{k}_1
VGG19_SLICES: Sequence[Sequence] = (
    (("conv", 0, 3, 64),),                                        # relu1_1
    (("conv", 2, 64, 64), "pool", ("conv", 5, 64, 128)),          # relu2_1
    (("conv", 7, 128, 128), "pool", ("conv", 10, 128, 256)),      # relu3_1
    (("conv", 12, 256, 256), ("conv", 14, 256, 256),
     ("conv", 16, 256, 256), "pool", ("conv", 19, 256, 512)),     # relu4_1
    (("conv", 21, 512, 512), ("conv", 23, 512, 512),
     ("conv", 25, 512, 512), "pool", ("conv", 28, 512, 512)),     # relu5_1
)

SLICE_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class VGG19Features(nn.Module):
    """``slices[k][j]``: the j-th conv of slice k, weight (O, I, 3, 3) and
    bias, frozen."""

    def __init__(self):
        super().__init__()
        self.slices = nn.ModuleList()
        for sl in VGG19_SLICES:
            self.slices.append(nn.ModuleList(
                [torch.nn.utils.skip_init(nn.Conv2d, item[2], item[3], 3, padding=1)
                 for item in sl if item != "pool"]))
        self.requires_grad_(False)


def vgg19_features_init(seed: int = 0, device="cpu") -> VGG19Features:
    """Random VGG19 slices, torch's conv default init
    (U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and biases)."""
    net = VGG19Features()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for conv in net.modules():
            if isinstance(conv, nn.Conv2d):
                bound = 1.0 / math.sqrt(conv.weight[0].numel())
                for p in (conv.weight, conv.bias):
                    p.copy_(torch.rand(p.shape, generator=gen) * (2 * bound) - bound)
    return net.to(device)


def _load(convs_w_b, device) -> VGG19Features:
    net = VGG19Features()
    with torch.no_grad():
        for conv, (w, b) in zip([m for m in net.modules() if isinstance(m, nn.Conv2d)],
                                convs_w_b):
            if tuple(w.shape) != tuple(conv.weight.shape):
                raise ValueError(f"vgg19 conv of shape {tuple(w.shape)}, expected "
                                 f"{tuple(conv.weight.shape)}")
            conv.weight.copy_(w)
            conv.bias.copy_(b)
    return net.to(device)


def import_torch_vgg_features(state_dict: Dict[str, Any], device="cpu") -> VGG19Features:
    """A torchvision ``vgg19().features`` state_dict (keys ``{i}.weight`` /
    ``{i}.bias``, or ``features.{i}.weight``; tensors or numpy arrays) ->
    the slices."""
    def get(i, leaf):
        for k in (f"{i}.{leaf}", f"features.{i}.{leaf}"):
            if k in state_dict:
                return torch.as_tensor(np.asarray(state_dict[k], np.float32))
        raise KeyError(f"vgg19 features index {i} ({leaf}) not found")

    return _load([(get(item[1], "weight"), get(item[1], "bias"))
                  for sl in VGG19_SLICES for item in sl if item != "pool"], device)


def from_jax_params(params: Dict[str, Any], device="cpu") -> VGG19Features:
    """The JAX package's pytree ({"slices": [[{"w" HWIO, "b"}, ...], ...]})
    -> the slices."""
    return _load([(torch.from_numpy(np.ascontiguousarray(
                       np.transpose(np.asarray(c["w"], np.float32), (3, 2, 0, 1)))),
                   torch.from_numpy(np.asarray(c["b"], np.float32)))
                  for sl in params["slices"] for c in sl], device)


def vgg19_slice_features(net: VGG19Features, x: torch.Tensor,
                         normalize_input: bool = True) -> List[torch.Tensor]:
    """x (N, 3, H, W) -> [h_relu1_1, ..., h_relu5_1]
    (reference _init_spade.py:437-451)."""
    if normalize_input:
        mean = torch.tensor(_IMAGENET_MEAN, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
        std = torch.tensor(_IMAGENET_STD, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
        x = (x + 0.5 - mean) / std
    feats = []
    for sl, convs in zip(VGG19_SLICES, net.slices):
        ci = 0
        for item in sl:
            if item == "pool":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(convs[ci](x))
                ci += 1
        feats.append(x)
    return feats


def perceptual_loss(net: VGG19Features, fake: torch.Tensor, real: torch.Tensor,
                    normalize_input: bool = True) -> torch.Tensor:
    """SPADE's weighted L1 over the five slices; the real image's features
    carry no gradient."""
    ff = vgg19_slice_features(net, fake, normalize_input)
    with torch.no_grad():
        fr = vgg19_slice_features(net, real, normalize_input)
    loss = torch.zeros((), dtype=fake.dtype, device=fake.device)
    for w, a, b in zip(SLICE_WEIGHTS, ff, fr):
        loss = loss + w * torch.mean(torch.abs(a - b))
    return loss
