"""Seeded weights in the port's parameter layout, made on the device.

Every linear and convolution weight and bias is first drawn U(-1/sqrt(fan_in),
1/sqrt(fan_in)) and the feature grid N(0, 0.01^2), the initialisation of
the reference repository (and of the port's ``init_uniform_``), in two large
calls of a generator seeded from the run's seed. At that initialisation a
deep MLP's output hardly varies over space and its density is below zero
nearly everywhere, so a frame shows the background prior alone and does not
depend on the field. Three changes give the field a trained one's shape,
so that a frame depends on every layer:

- the hidden layers' weights are scaled by ``GAIN``, which keeps the
  signal's variance through the ReLU trunks;
- in every layer that reads a positional encoding, the columns of frequency
  k are scaled by 2^-k, so the field is smooth, as a trained one is, and a
  sample moved by a rounding does not swing the field;
- the density head is set from a probe of the field at points of the
  seed's first view, so that its median point sits at density 0 with a
  spread of ``DENSITY_SPREAD``: about half of the volume is dense and a ray
  through the head is partly opaque.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch

from .shapes import Net, Spec, layout

GAIN = 2.0
DENSITY_SPREAD = 6.0
PROBE_RAYS, PROBE_DEPTHS = 1024, 16
HEADS = ("warp.out", "hyper.out", "fc_alpha", "fc_rgb", "fc_seg", "audnet")


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose of a run, from the run's seed (any
    whole number) and a tag."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def pe_octaves(d: int, num_freqs: int, include_input: bool):
    """The frequency index of each column of an encoding (the input's own
    columns count as 0)."""
    cols = [0] * (d if include_input else 0)
    for k in range(num_freqs):
        cols += [k] * (2 * d)
    return cols


def _smooth(w: Dict[str, torch.Tensor], name: str, first: int, octaves) -> None:
    """Scale the columns ``first``.. of weight ``name`` by 2^-octave."""
    f = torch.tensor([2.0 ** -k for k in octaves], device=w[name].device)
    w[name][:, first:first + len(octaves)] *= f


def make_weights(spec: Spec, seed: int, device, near: float, far: float
                 ) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for every parameter; ``near``
    and ``far`` bound the probed depths."""
    items = layout(spec)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    dense = [(n, s, f) for n, s, f in items if f > 0]
    total = sum(math.prod(s) for _, s, _ in dense)
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    w: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, fan_in in dense:
        n = math.prod(shape)
        b = 1.0 / math.sqrt(fan_in)
        w[name] = (flat[at:at + n] * (2 * b) - b).reshape(shape)
        if name.endswith(".weight") and not any(h in name for h in HEADS):
            w[name] *= GAIN
        at += n
    for name, shape, fan_in in items:
        if fan_in == 0:
            w[name] = torch.randn(shape, generator=gen, device=device,
                                  dtype=torch.float32) * 0.01

    def net_pe(prefix: str, net: Net, octaves) -> None:
        _smooth(w, f"{prefix}.trunk.layers.0.weight", 0, octaves)
        _smooth(w, f"{prefix}.trunk.layers.{net.skip}.weight", net.layers[0][1], octaves)

    deform = pe_octaves(3, spec.xyz_freqs, True)
    for prefix in ("warp", "hyper"):
        if getattr(spec, prefix) is not None:
            net_pe(prefix, getattr(spec, prefix), deform)
    nerf = pe_octaves(3, spec.nerf_xyz_freqs, spec.nerf_include_xyz)
    if spec.ambient_dim:
        nerf += pe_octaves(spec.ambient_dim, spec.ambient_freqs, spec.ambient_include)
    for level in ("coarse", "fine"):
        nf = getattr(spec, level)
        net_pe(level, nf.trunk, nerf)
        _smooth(w, f"{level}.dir.0.weight", nf.hidden,
                pe_octaves(3, spec.dir_freqs, spec.dir_include))
    _set_density(spec, w, seed, device, near, far)
    return w


def _set_density(spec: Spec, w: Dict[str, torch.Tensor], seed: int, device, near: float,
                 far: float) -> None:
    """fc_alpha of each level from a probe: the field's pre-density at
    points along rays of the seed's first view, centred at its median and
    scaled to ``DENSITY_SPREAD``."""
    from . import inputs
    from .reference.model import Field, encode_pose, ray_bundle
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "probe"))
    W = 512
    pose = inputs.poses(1, 0.5 * (near + far), seed, device)[0]
    drv = inputs.driving(1, spec.audio, seed, device)[0]
    idx = torch.randint(0, W * W, (PROBE_RAYS,), generator=g, device=device)
    ro, rd = ray_bundle(W, W, inputs.intrinsics(W, device), pose, idx)
    z = near + (far - near) * torch.rand((PROBE_RAYS, PROBE_DEPTHS), generator=g, device=device)
    pts = (ro[:, None] + rd[:, None] * z[..., None]).reshape(-1, 3)
    dirs = rd[:, None].expand(-1, PROBE_DEPTHS, 3).reshape(-1, 3)
    field = Field(spec, w)
    with torch.no_grad():
        driving, pose_enc = field.driving(drv), encode_pose(pose)
        for level in ("coarse", "fine"):
            raw = field.raw(level, pts, dirs, driving, pose_enc)[:, 15]
            med = torch.median(raw)
            s = DENSITY_SPREAD / torch.std(raw).clamp(min=1e-12)
            w[f"{level}.fc_alpha.weight"] *= s
            w[f"{level}.fc_alpha.bias"] = (w[f"{level}.fc_alpha.bias"] - med) * s
