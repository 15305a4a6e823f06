"""The yardstick: the operations and bytes of the port's kernels and of a
whole frame or train step, from the configuration's widths (shapes.py), the
card's published peaks, and the grouping of CUDA kernel names by the
port's kernels.

A frozen copy of ``chip_smoke.py``'s arithmetic (``k1_macs``, ``k5_macs``,
``level_train_macs``, ``pair_vjp_macs``, ``bound`` and the peaks) and of
``sahs_tpu_torch/train/trace_step.py``'s ``short_name`` and ``OWNERS``,
reading widths from the configuration instead of the port's objects. The
per-frame conditioning ([driving | pose]) is folded into the first layer's
and the skip layer's biases by the kernels, once a frame, so a point's
products count the encoded-point columns of those layers alone.
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

from .shapes import GRID_CHANNELS, GRID_RES, SEG_CLASSES, Net, NeRF, Spec

# NVIDIA H100 SXM data sheet, dense: bf16 on the tensor cores, float32
# outside them, HBM3. They assume the 700 W power limit; the runs print
# the card's limit beside every share.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def net_macs(net: Net) -> int:
    """Multiply-adds a point of one skip MLP and its head, conditioning
    folded into the biases."""
    total = 0
    for i, (fi, fo) in enumerate(net.layers):
        if i == 0 or i == net.skip:
            fi -= net.cond
        total += fi * fo
    return total + net.layers[-1][1] * net.head


def to_pe_macs(net: Net) -> int:
    """The products of a net's backward that go back to its encoded input:
    its first layer's and its skip layer's encoded-point columns."""
    return sum(net.enc * fo for i, (_, fo) in enumerate(net.layers)
               if i == 0 or i == net.skip)


def k1_macs(spec: Spec) -> int:
    """K1, the deformation pair: both nets a point."""
    return sum(net_macs(n) for n in (spec.warp, spec.hyper) if n is not None)


def k5_macs(spec: Spec, level: str) -> int:
    """K5, one NeRF level a point: trunk, feature and alpha heads, the
    direction branch's feature and grid columns and its rest, rgb, the
    segmentation branch and its head. The direction's own columns of the
    first branch layer are a ray's (``k5_ray_macs``)."""
    nf: NeRF = getattr(spec, level)
    H, B = nf.hidden, nf.branch
    trunk = net_macs(nf.trunk) - H * nf.trunk.head        # the alpha head below
    return (trunk + H * H + H + H * B + (GRID_CHANNELS * B if nf.grid else 0)
            + 3 * B * B + B * 3 + H * B + 3 * B * B + B * SEG_CLASSES)


def k5_ray_macs(spec: Spec, level: str) -> int:
    nf: NeRF = getattr(spec, level)
    return nf.dir_pe * nf.branch


def level_train_macs(spec: Spec, level: str) -> int:
    """K2 a point: forward, backward chain, dW."""
    return 3 * k5_macs(spec, level)


def pair_vjp_macs(spec: Spec) -> int:
    """K3 a point: the forward, the backward chain without the products
    back to the encoding, and dW."""
    return 3 * k1_macs(spec) - sum(to_pe_macs(n) for n in (spec.warp, spec.hyper)
                                   if n is not None)


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS
          ) -> Tuple[float, str]:
    """The least milliseconds of a call: (ms, what bounds it)."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def table_bytes(spec: Spec) -> int:
    """The bf16 corner table of the grid: (res + 1)^3 rows of 8 corners."""
    return (GRID_RES + 1) ** 3 * 8 * GRID_CHANNELS * 2 if spec.coarse.grid else 0


def k1_call(spec: Spec, rays: int, samples: int) -> Tuple[float, float]:
    """(operations, bytes) of one K1 call: points in, canonical points and
    grid rows out."""
    P = rays * samples
    return 2 * k1_macs(spec) * P, P * 3 * 4 + P * (3 + spec.ambient_dim + 1) * 4


def k5_call(spec: Spec, level: str, rays: int, samples: int) -> Tuple[float, float]:
    """(operations, bytes) of one K5 call: canonical points and rows, the
    rays' directions, z, background and the corner table in, the rays'
    16 channels and weights out."""
    P = rays * samples
    flops = 2 * (k5_macs(spec, level) * P + k5_ray_macs(spec, level) * rays)
    nbytes = (P * (3 + spec.ambient_dim + 1) * 4 + rays * (3 + samples + 15) * 4
              + table_bytes(spec) + rays * (16 + samples) * 4)
    return flops, nbytes


def frame_work(spec: Spec, rays: int, chunk: int, coarse: int, fine: int) -> Dict[str, float]:
    """A frame of ``rays`` rays in chunks of ``chunk``: the least seconds of
    K1's and of K5's calls (each call's bound, summed), and the model's
    operations (each net's products once a point)."""
    k1_s = k5_s = flops = 0.0
    for start in range(0, rays, chunk):
        r = min(chunk, rays - start)
        for level, S in (("coarse", coarse), ("fine", coarse + fine)):
            if spec.warp is not None or spec.hyper is not None:
                f1, b1 = k1_call(spec, r, S)
                k1_s += bound(f1, b1)[0] / 1e3
                flops += f1
            f5, b5 = k5_call(spec, level, r, S)
            k5_s += bound(f5, b5)[0] / 1e3
            flops += f5
    return {"k1_s": k1_s, "k5_s": k5_s, "model_flops": flops}


def step_flops(spec: Spec, rays: int, coarse: int, fine: int) -> float:
    """A train step's model operations: the forward once and the backward
    twice (the cotangents and dW), no recompute; the products back to an
    encoded input that holds no parameter are left out (the deformation
    nets' always, the NeRF's where no deformation net moves its points)."""
    deform = spec.warp is not None or spec.hyper is not None
    macs = 0
    for level, S in (("coarse", coarse), ("fine", coarse + fine)):
        P = rays * S
        if deform:
            macs += pair_vjp_macs(spec) * P
        nf: NeRF = getattr(spec, level)
        macs += level_train_macs(spec, level) * P + 3 * k5_ray_macs(spec, level) * rays
        if not deform:
            macs -= to_pe_macs(nf.trunk) * P
    return 2.0 * macs


def short_name(kernel: str) -> str:
    """A demangled kernel name without its argument list, return type and
    anonymous namespace, at most 60 characters."""
    name = kernel[5:] if kernel.startswith("void ") else kernel
    name = name.replace("(anonymous namespace)::", "")
    name = re.split(r"\(", name, maxsplit=1)[0]
    return name[:60]


# CUDA kernel -> the port's kernels (K1-K15) whose launch it is
OWNERS = {
    "deform_pair_wg_kernel": "K1", "deform_pair_kernel": "K1",
    "field_tc_kernel": "K5 raw field, K7, K11",
    "composite_fwd_kernel": "K5 compositing",
    "nerf_level_kernel": "K5, K7 (float32)", "nerf_mlp_kernel": "K11 (float32)",
    "fwd_tc_kernel": "K2, K6, K8, K12 forward", "fwd_kernel": "K2, K6, K8, K12 forward",
    "composite_kernel": "K2, K6 compositing and its backward",
    "bwd_tc_kernel": "K2, K6, K8, K12 backward", "bwd_kernel": "K2, K6, K8, K12 backward",
    "level_dw_kernel": "dW of K2, K6, K8, K12, K3, K14",
    "bias_dw_kernel": "db of K2, K6, K8, K12, K3, K14",
    "dw_kernel": "dW (float32)", "dw_reduce": "dW's split-K sum",
    "pair_bwd_wg_kernel": "K3, K2's pair= form", "pair_vjp_kernel": "K3, K2's pair= form",
    "skip_wg_kernel": "K13", "skip_mlp_kernel": "K13",
    "skip_bwd_wg_kernel": "K14", "skip_vjp_kernel": "K14",
    "build_pts_kernel": "K15",
    "dg_cells_kernel": "K4, K9, K10 dG: cells", "dg_hist_kernel": "K4, K9, K10 dG: sort",
    "dg_tile_offsets_kernel": "K4, K9, K10 dG: sort",
    "dg_cell_sums_kernel": "K4, K9, K10 dG: offsets",
    "dg_cell_offsets_kernel": "K4, K9, K10 dG: offsets",
    "dg_scatter_kernel": "K4, K9, K10 dG: sort",
    "dg_chunk_kernel": "K4, K9, K10 dG: cell sums",
    "dg_voxel_kernel": "K4, K9, K10 dG: voxel sums", "dg_dcoords_kernel": "K10 dcoords"}


def owner(name: str) -> str:
    """The port's kernels that launch ``name`` (a ``short_name``), or ""."""
    return OWNERS.get(name.split("<")[0].split("::")[-1], "")


def base_name(name: str) -> str:
    """A ``short_name`` without template arguments and namespaces, the key
    of ``OWNERS``."""
    return name.split("<")[0].split("::")[-1]
