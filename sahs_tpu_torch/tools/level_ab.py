"""Times the bf16 kernels on the tensor cores (the level backward K2, K6,
K8, K12, the deformation nets' K3, K14, the NeRF field's forwards K7, K11
and one deformation net's forward K13, per call), K15, the train steps and
the frames that run them, for one tree of the port, on the card:

    python sahs_tpu_torch/tools/level_ab.py --tree <root of a checkout>
    python sahs_tpu_torch/tools/level_ab.py --tree <root> --fields-only
    python sahs_tpu_torch/tools/level_ab.py --tree <root> --skip-only
    python sahs_tpu_torch/tools/level_ab.py --tree <root> --serve-only
    python sahs_tpu_torch/tools/level_ab.py --tree <root> --grid-only
    python sahs_tpu_torch/tools/level_ab.py --tree <root> --chains-only
    python sahs_tpu_torch/tools/level_ab.py --tree <root> --dg-only

imports ``sahs_tpu_torch`` from ``--tree`` (default: the checkout this file
is in), so that two versions are compared in one call by running it once
per tree in turns, e.g. for a copy of the parent commit unpacked under
``build/parent``:

    for t in build/parent . . build/parent; do
        python sahs_tpu_torch/tools/level_ab.py --tree $t; done

Per call: K5 and K1 (the serving frame's kernels) at a frame's fine
chunk (32,768 rays x 128 = 4,194,304 points) and coarse chunk (x 64), on
the flagship's seeded coarse level and deformation nets, each beside its
library call (the plain version under bf16 autocast), TFLOP/s and share
of the bound; K2, K6, K8 at a step's fine level (2048 rays x 128) and coarse
level (x 64), K12 at the per-point step's fine level (2048 x 192 =
393,216 points), on the flagship model's coarse level at its seeded init
and seeded inputs; K3 at the fused step's fine points (262,144, with the
addend g2) and K14 on the warp and on the hyper net at a step's fine level
(262,144, no points' cotangent), on the flagship's seeded deformation nets,
each beside its library call in the same run (autograd of the module under
bf16 autocast, which the port never calls), its TFLOP/s and its share of
the bound (operations at 989 TFLOP/s); the minimum over 3 rounds of the
mean of 3 calls, CUDA events. K7 at a step's fine (2048 x 128) and coarse
(x 64) level, K11 at the per-point step's 393,216 points and at the
per-point frame's fine chunk (32,768 rays x 192 = 6,291,456 points), on
the flagship's seeded coarse level, each beside its library call (the
module's forward under bf16 autocast), TFLOP/s and share of the bound.
K13 on the warp and on the hyper net at a frame's fine chunk (32,768 rays
x 128 = 4,194,304 points) and at a step's fine level (262,144), on the
flagship's seeded nets, each beside its library call (the module's forward
under bf16 autocast), TFLOP/s and share of the bound. K15 at the fused
step's two levels (2048 x 64, 2048 x 128) and at the per-point step's 2048
x 192, beside ``torch.addcmul``'s counterpart, three readings each
(``k15_readings``): device time (``torch.profiler``, 200 calls), per-call
time (CUDA events around 200 calls) and the host's time (its clock around
200 calls, synchronised at the end only). Steps (``train/trace_step.py``'s PATHS and ``build_step``, from this
checkout, run on the tree's code): the flagship fused step, fallback path
1 (fused_grads off), the reuse path (fuse_composite off too), the
per-point step (``pointwise``, 64 + 128), the plain path's step
(``plain``, float32, no kernels but K10) and the warp-only and
ambient-only steps, each 2 warm-up steps and then the mean of 5, CUDA
events. Frames: the 512x512 flagship, warp-only and ambient-only frames
(64 + 64, through ``make_eval_renderer``), the per-point frame (64 + 128)
and one 32,768-ray chunk of the reuse path's frame
(``render_rays_chunked`` with fuse_composite off), each one warm-up and the
minimum of 2, CUDA events. ``--fields-only`` times K7 and K11 alone,
``--skip-only`` K13 alone (to compare two builds of a kernel),
``--serve-only`` K5, K1 and the flagship, warp-only and ambient-only
frames (the serving readings), ``--grid-only`` the grid backward (K4, K9
and K10 at their paths' shapes, ``_grid_times``), ``--chains-only`` the
tools' chain kernels X1 and X4-X6 with their gates' readings
(``_chain_times``), ``--dg-only`` X2 in its four cases beside its
library call (``_dg_times``), ``--steps-only`` the
steps alone. Prints one JSON line: the tree, the card's name and power
limit, and the readings (ms; TFLOP/s and the bound's share for K3, K14,
K7, K11 and K13).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

_HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _kernel_times(dev, reps: int = 3) -> dict:
    import numpy as np
    import torch

    from sahs_tpu_torch.config import Config
    from sahs_tpu_torch.models import nerface
    from sahs_tpu_torch.ops.grid import _cell_geometry, pack_corner_table
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.ops.kernels import nerf_level as k5
    from sahs_tpu_torch.utils.device import cuda_ms

    spec = nerface.ModelSpec.from_config(Config())
    model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
    rng = np.random.RandomState(0)
    g = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    cond = g(rng.randn(36) * 0.5)
    _, pts_g, dir_g = nerface.build_pe_groups(spec)
    level = k5.prepare_level(model.coarse, cond, pts_g, dir_g)
    table = pack_corner_table(model.spatial_embeddings.detach(), dtype=torch.bfloat16)
    grid = (32, 32, 32)
    best = lambda fn: cuda_ms(fn, reps, runs=3)
    out = {}
    R = 2048
    for S, lvl_name in ((128, "fine"), (64, "coarse")):
        P = R * S
        pts = g(np.concatenate([rng.uniform(-1.05, 1.05, (P, 3)),
                                rng.uniform(-1, 1, (P, 2))], 1))
        dirs = g(rng.randn(R, 3) * 0.1 + [0, 0, -1])
        z = g(np.sort(rng.uniform(0.48, 1.08, (R, S)), axis=-1))
        bg, noise = g(rng.rand(R, 15)), g(rng.randn(R, S) * 0.5)
        tgt = g(np.concatenate([rng.rand(R, 3), np.eye(12)[rng.randint(0, 12, R)]], 1))
        lw = g(np.stack([np.full(R, 1.0 / R), np.full(R, 0.02 / R)], 1))
        rows = _cell_geometry(pts, grid)[0]
        a = (pts, dirs, table, rows, z, bg, noise)
        out[f"K2 {lvl_name}"] = best(lambda: k2.nerf_level_train(
            *a, tgt, lw, level, "bfloat16", grid, 0.5))
        g_rgb, g_w = g(rng.randn(R, 16) * 1e-3), g(rng.randn(R, S) * 1e-3)
        out[f"K6 {lvl_name}"] = best(lambda: k2.nerf_level_vjp(
            *a, g_rgb, g_w, level, "bfloat16", grid))
        graw = g(rng.randn(P, 16) * 1e-3)
        out[f"K8 {lvl_name}"] = best(lambda: k2.nerf_rayd_vjp(
            pts, dirs, table, rows, graw, level, "bfloat16", grid))
        del a, pts, rows, graw
    P = R * 192
    pts = g(np.concatenate([rng.uniform(-1.05, 1.05, (P, 3)), rng.uniform(-1, 1, (P, 2))], 1))
    extra = g(np.concatenate([rng.randn(P, 3) * 0.1 + [0, 0, -1], rng.randn(P, 32) * 0.3], 1))
    gg = g(rng.randn(P, 16) * 1e-3)
    out["K12 fine"] = best(lambda: k2.nerf_mlp_vjp(pts, extra, gg, level, "bfloat16"))
    return out


PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense bf16 tensor cores
PEAK_BYTES = 3.35e12       # its HBM3


def _net_macs(trunk, out) -> int:
    """Multiply-adds a point of one deformation net's forward (the skip
    layer's pe rows included)."""
    return sum(p["w"].numel() for p in trunk) + out["w"].numel()


def _vjp_macs(trunk, out, skip) -> int:
    """Multiply-adds a point of a net's backward without the product back
    to the encoding: the forward, the backward chain and dW."""
    hid = trunk[0]["w"].shape[1]
    return (3 * _net_macs(trunk, out) - trunk[0]["w"].numel()
            - trunk[skip]["w"][hid:].numel())


def _deform_times(dev, reps: int = 3) -> dict:
    """K3 and K14 per call, each beside its library call, TFLOP/s and the
    share of its bound."""
    import numpy as np
    import torch

    from sahs_tpu_torch.config import Config
    from sahs_tpu_torch.models import nerface
    from sahs_tpu_torch.ops.kernels import deform_pair as k1
    from sahs_tpu_torch.ops.kernels import skip_mlp as k13
    from sahs_tpu_torch.ops.kernels.field_mlp import kernel_pe
    from sahs_tpu_torch.utils.device import cuda_ms

    spec = nerface.ModelSpec.from_config(Config())
    model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
    rng = np.random.RandomState(1)
    g = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    cond = g(rng.randn(76 + 36) * 0.5)
    driving, pose = cond[:76], cond[76:]
    warp_g = nerface.build_pe_groups(spec)[0]
    best = lambda fn: cuda_ms(fn, reps, runs=3)
    P = 2048 * 128
    pts = g(rng.uniform(-0.6, 0.6, (P, 3)))
    pe = kernel_pe(pts, warp_g)

    def library(nets, gsum):
        params = [p for n in nets for p in n.parameters()]

        def run():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                o = torch.cat([n(pe, driving, pose) for n in nets], dim=-1)
            return torch.autograd.grad((o.float() * gsum).sum(), params)
        return run

    def row(ms, lib_ms, macs):
        flops = 2 * macs * P
        bound = flops / PEAK_BF16_FLOPS * 1e3
        return {"ms": ms, "library_ms": lib_ms, "tflops": flops / (ms / 1e3) / 1e12,
                "bound_ms": bound, "bound_share": bound / ms}

    out = {}
    pair = k1.prepare_pair(model.warp, model.hyper, cond, warp_g)
    gp, gp2 = g(rng.randn(P, 5) * 1e-3), g(rng.randn(P, 5) * 1e-3)
    out["K3 fine"] = row(
        best(lambda: k1.deform_pair_vjp(pts, pair, gp, gp2, "bfloat16")),
        best(library((model.warp, model.hyper), gp + gp2)),
        _vjp_macs(pair.warp_trunk, pair.warp_out, pair.warp_skip)
        + _vjp_macs(pair.hyper_trunk, pair.hyper_out, pair.hyper_skip))
    for name, act, cols in (("warp", "tanh", slice(0, 3)), ("hyper", "linear", slice(3, 5))):
        net = getattr(model, name)
        w = k13.prepare_skip(net, cond, warp_g, act)
        gs = gp[:, cols].contiguous()
        out[f"K14 {name} fine"] = row(
            best(lambda: k13.skip_mlp_vjp(pts, w, gs, False, "bfloat16")),
            best(library((net,), gs)), _vjp_macs(w.trunk, w.out, w.skip))
    return out


def _field_times(dev, reps: int = 3) -> dict:
    """K7 and K11 per call, each beside its library call, TFLOP/s and the
    share of its bound."""
    import numpy as np
    import torch

    from sahs_tpu_torch.config import Config
    from sahs_tpu_torch.models import nerface
    from sahs_tpu_torch.ops.grid import _cell_geometry, interp_corners, pack_corner_table
    from sahs_tpu_torch.ops.kernels import nerf_level as k5
    from sahs_tpu_torch.ops.kernels import nerf_mlp as k11
    from sahs_tpu_torch.ops.kernels.field_mlp import kernel_pe
    from sahs_tpu_torch.utils.device import cuda_ms

    spec = nerface.ModelSpec.from_config(Config())
    model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
    rng = np.random.RandomState(2)
    g = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    cond = g(rng.randn(76 + 36) * 0.5)
    driving, pose = cond[:76], cond[76:]
    _, pts_g, dir_g = nerface.build_pe_groups(spec)
    level = k5.prepare_level(model.coarse, pose, pts_g, dir_g)
    table = pack_corner_table(model.spatial_embeddings.detach(), dtype=torch.bfloat16)
    grid = (32, 32, 32)
    best = lambda fn: cuda_ms(fn, reps, runs=3)
    mats = ([p["w"] for p in level.trunk] + [level.feat["w"], level.alpha["w"],
            level.dir0_feat, level.dir0_se] + [p["w"] for p in level.dir_rest]
            + [level.rgb["w"]] + [p["w"] for p in level.seg] + [level.seg_out["w"]])
    macs = sum(m.numel() for m in mats)       # a point, the direction term aside
    dmacs = level.dir0_dir.numel()

    def library(x, dpe, se):
        def run():
            with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
                return model.coarse(x, dpe, driving=driving, pose=pose,
                                    spatial_embedding=se)
        return run

    def row(ms, lib_ms, flops, nbytes):
        bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        return {"ms": ms, "library_ms": lib_ms, "tflops": flops / (ms / 1e3) / 1e12,
                "bound_ms": bound, "bound_share": bound / ms}

    out = {}
    R = 2048
    for S, name in ((128, "fine"), (64, "coarse")):
        P = R * S
        pts = g(np.concatenate([rng.uniform(-1.05, 1.05, (P, 3)),
                                rng.uniform(-1, 1, (P, 2))], 1))
        dirs = g(rng.randn(R, 3) * 0.1 + [0, 0, -1])
        rows, fs, ok = _cell_geometry(pts, grid)
        lib = library(kernel_pe(pts, level.pts_groups),
                      kernel_pe(dirs, level.dir_groups).repeat_interleave(S, dim=0),
                      interp_corners(table[rows], fs, ok))
        out[f"K7 {name}"] = row(
            best(lambda: k5.nerf_rayd_forward(pts, dirs, table, rows, level,
                                              "bfloat16", grid)),
            best(lib), 2 * (macs * P + dmacs * R),
            P * 6 * 4 + R * 3 * 4 + table.numel() * 2 + P * 16 * 4)
        del pts, rows, fs, ok, lib
    for P, name in ((R * 192, "step"), (32768 * 192, "frame chunk")):
        pts = g(np.concatenate([rng.uniform(-1.05, 1.05, (P, 3)),
                                rng.uniform(-1, 1, (P, 2))], 1))
        extra = g(np.concatenate([rng.randn(P, 3) * 0.1 + [0, 0, -1],
                                  rng.randn(P, 32) * 0.3], 1))
        lib = library(kernel_pe(pts, level.pts_groups),
                      kernel_pe(extra[:, :3], level.dir_groups), extra[:, 3:])
        out[f"K11 {name}"] = row(
            best(lambda: k11.nerf_mlp_forward_fused(pts, extra, level, "bfloat16")),
            best(lib), 2 * (macs + dmacs) * P, P * (5 + 35 + 16) * 4)
        del pts, extra, lib
        torch.cuda.empty_cache()
    return out


def _skip_times(dev, reps: int = 3) -> dict:
    """K13 per call on the warp and the hyper net, each beside its library
    call, TFLOP/s and the share of its bound."""
    import numpy as np
    import torch

    from sahs_tpu_torch.config import Config
    from sahs_tpu_torch.models import nerface
    from sahs_tpu_torch.ops.kernels import skip_mlp as k13
    from sahs_tpu_torch.ops.kernels.field_mlp import kernel_pe
    from sahs_tpu_torch.utils.device import cuda_ms

    spec = nerface.ModelSpec.from_config(Config())
    model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
    rng = np.random.RandomState(3)
    g = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    cond = g(rng.randn(76 + 36) * 0.5)
    driving, pose = cond[:76], cond[76:]
    warp_g = nerface.build_pe_groups(spec)[0]
    best = lambda fn: cuda_ms(fn, reps, runs=3)
    out = {}
    for P, where in ((32768 * 128, "frame chunk"), (2048 * 128, "step")):
        pts = g(rng.uniform(-1.05, 1.05, (P, 3)))
        pe = kernel_pe(pts, warp_g)
        for name, act in (("warp", "tanh"), ("hyper", "linear")):
            net = getattr(model, name)
            w = k13.prepare_skip(net, cond, warp_g, act)

            def library():
                with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
                    return net(pe, driving, pose)
            ms = best(lambda: k13.skip_mlp_forward(pts, w, "bfloat16"))
            flops = 2 * _net_macs(w.trunk, w.out) * P
            bound = max(flops / PEAK_BF16_FLOPS,
                        P * (3 + w.out["w"].shape[1]) * 4 / PEAK_BYTES) * 1e3
            out[f"K13 {name} {where}"] = {
                "ms": ms, "library_ms": best(library),
                "tflops": flops / (ms / 1e3) / 1e12, "bound_ms": bound,
                "bound_share": bound / ms}
        del pts, pe
        torch.cuda.empty_cache()
    return out


def _serve_kernel_times(dev, reps: int = 3) -> dict:
    """K5 and K1 per call at a frame's fine (32,768 rays x 128) and coarse
    (x 64) chunk, on the flagship's seeded coarse level and deformation
    nets, each beside its library call (the plain version under bf16
    autocast, which the port never calls), TFLOP/s and share of the bound
    (operations at 989 TFLOP/s)."""
    import numpy as np
    import torch

    from sahs_tpu_torch.config import Config
    from sahs_tpu_torch.models import nerface
    from sahs_tpu_torch.ops.grid import pack_corner_table
    from sahs_tpu_torch.ops.kernels import deform_pair as k1
    from sahs_tpu_torch.ops.kernels import nerf_level as k5
    from sahs_tpu_torch.utils.device import cuda_ms

    spec = nerface.ModelSpec.from_config(Config())
    model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
    rng = np.random.RandomState(5)
    g = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    cond = g(rng.randn(76 + 36) * 0.5)
    warp_g, pts_g, dir_g = nerface.build_pe_groups(spec)
    pair = k1.prepare_pair(model.warp, model.hyper, cond, warp_g)
    level = k5.prepare_level(model.coarse, cond[76:], pts_g, dir_g)
    table = pack_corner_table(model.spatial_embeddings.detach(), dtype=torch.bfloat16)
    grid = (32, 32, 32)
    best = lambda fn: cuda_ms(fn, reps, runs=3)
    mats = ([p["w"] for p in level.trunk] + [level.feat["w"], level.alpha["w"],
            level.dir0_feat, level.dir0_se] + [p["w"] for p in level.dir_rest]
            + [level.rgb["w"]] + [p["w"] for p in level.seg] + [level.seg_out["w"]])
    k5_macs = sum(m.numel() for m in mats)    # a point; the direction term a ray
    k1_macs = (_net_macs(pair.warp_trunk, pair.warp_out)
               + _net_macs(pair.hyper_trunk, pair.hyper_out))

    def autocast(fn):
        def run():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                return fn()
        return run

    def row(ms, lib_ms, flops):
        bound = flops / PEAK_BF16_FLOPS * 1e3
        return {"ms": ms, "library_ms": lib_ms, "tflops": flops / (ms / 1e3) / 1e12,
                "bound_ms": bound, "bound_share": bound / ms}

    out = {}
    R = 32768
    dirs = g(rng.randn(R, 3) * 0.1 + [0, 0, -1])
    bg = g(rng.rand(R, 15))
    for S, name in ((128, "fine"), (64, "coarse")):
        P = R * S
        pts = g(rng.uniform(-0.6, 0.6, (P, 3)))
        args1 = (pts, pair, "bfloat16", S, grid)
        out[f"K1 {name} chunk"] = row(
            best(lambda: k1.deform_pair_forward(*args1)),
            best(autocast(lambda: k1.deform_pair_plain(*args1))), 2 * k1_macs * P)
        packed, rows = k1.deform_pair_plain(*args1)
        z = g(np.sort(rng.uniform(0.48, 1.08, (R, S)), axis=-1))
        args5 = (packed, dirs, table, rows, z, bg, None, level, "bfloat16", grid)
        out[f"K5 {name} chunk"] = row(
            best(lambda: k5.nerf_level_forward(*args5)),
            best(autocast(lambda: k5.nerf_level_plain(*args5))),
            2 * (k5_macs * P + level.dir0_dir.numel() * R))
        del pts, packed, rows, z, args1, args5
        torch.cuda.empty_cache()
    return out


def k15_readings(k15, ro, rd, z, launches: int = 200) -> dict:
    """K15 (``k15``: the ``ops.kernels.points`` module under test) and
    ``torch.addcmul``, the one PyTorch call computing o + d z (the port
    never calls it), on the same inputs, three readings each in ms a call:
    ``device`` (the kernels' own time, ``torch.profiler``), ``per_call``
    (CUDA events around ``launches`` calls: the device's time, or the
    host's where it issues calls more slowly than the device runs them)
    and ``host`` (the host's clock around ``launches`` calls, synchronised
    at the end only); the plain version's device and per-call times too,
    and the wrapper's host time by part (``host_parts``)."""
    import torch

    timers = _checkout_module("utils/device.py")
    cuda_ms, device_ms, host_ms = timers.cuda_ms, timers.device_ms, timers.host_ms
    ro3, rd3, z3 = ro[:, None, :], rd[:, None, :], z[..., None]
    calls = {"kernel": lambda: k15.build_pts(ro, rd, z),
             "addcmul": lambda: torch.addcmul(ro3, rd3, z3),
             "plain": lambda: k15.build_pts_plain(ro, rd, z)}
    out = {}
    for name, fn in calls.items():
        out[name] = {"device": device_ms(fn, launches),
                     "per_call": cuda_ms(fn, launches, runs=3)}
        if name != "plain":
            out[name]["host"] = min(host_ms(fn, launches) for _ in range(3))
    # the wrapper's host time by part: the launch (the C call on arguments
    # made beforehand), the output's allocation and the stream's handle;
    # the rest of "host" is its checks and bookkeeping in Python
    R, S = z.shape
    b = k15._build
    res = torch.empty((R * S, 3), dtype=torch.float32, device=ro.device)
    fn = b.function("build_pts", "sahs_build_pts", "ppplipp")
    args = (ro.data_ptr(), rd.data_ptr(), z.data_ptr(), R, S, res.data_ptr(),
            b.stream_ptr(ro.device))
    parts = {"launch": lambda: fn(*args),
             "empty": lambda: torch.empty((R * S, 3), dtype=torch.float32,
                                          device=ro.device),
             "stream": lambda: b.stream_ptr(ro.device)}
    out["kernel"]["host_parts"] = {n: min(host_ms(f, launches) for _ in range(3))
                                   for n, f in parts.items()}
    return out


def _k15_times(dev) -> dict:
    """K15's readings (``k15_readings``) at 2048 rays x 64, 128 and 192."""
    import numpy as np
    import torch

    from sahs_tpu_torch.ops.kernels import points as k15

    rng = np.random.RandomState(4)
    g = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    out = {}
    for S in (64, 128, 192):
        ro, rd = g(rng.randn(2048, 3) * 0.3), g(rng.randn(2048, 3) * 0.1 + [0, 0, -1])
        z = g(np.sort(rng.uniform(0.2, 0.8, (2048, S)), axis=-1))
        out[f"2048x{S}"] = k15_readings(k15, ro, rd, z)
    return out


def _frame_ms(dev, cfg) -> float:
    """One 512x512 frame of the model that ``cfg`` (a flagship Config(),
    changed) describes, seeded weights and a synthetic audio frame, through
    ``make_eval_renderer``: one warm-up and the minimum of 2, CUDA events."""
    from sahs_tpu_torch.data.synthetic import SyntheticFaceDataset
    from sahs_tpu_torch.evaluation import make_eval_renderer
    from sahs_tpu_torch.models import nerface
    from sahs_tpu_torch.render.pipeline import RenderSettings
    from sahs_tpu_torch.utils.device import cuda_ms

    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    spec = nerface.ModelSpec.from_config(cfg)
    model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
    ds = SyntheticFaceDataset(kind="audio", num_frames=1, H=512, W=512,
                              near=near, far=far)
    item = ds[0]
    render = make_eval_renderer(spec, RenderSettings.from_config(cfg, "validation"),
                                512, 512, near, far, device=dev)
    return cuda_ms(lambda: render(model, item["intrinsics"], item["pose"],
                                  item["driving"], ds.background()), 1, runs=2)


def _one_net_configs():
    """(name, Config()) of the warp-only and the ambient-only model."""
    from sahs_tpu_torch.config import Config
    out = []
    for name, section, field in (("warp-only", "hyper", "use_ambient"),
                                 ("ambient-only", "warp", "use_warp")):
        cfg = Config()
        setattr(getattr(cfg.models, section), field, False)
        out.append((name, cfg))
    return out


def _serve_frame_times(dev) -> dict:
    """The flagship, warp-only and ambient-only 512x512 frames (64 + 64)."""
    from sahs_tpu_torch.config import Config
    return {f"{name} frame": _frame_ms(dev, cfg)
            for name, cfg in [("flagship", Config())] + _one_net_configs()}


def _frame_times(dev) -> dict:
    """The per-point frame (512x512, 64 + 128) and one 32,768-ray chunk of
    the reuse path's frame, ms on the card."""
    import torch

    from sahs_tpu_torch.config import Config
    from sahs_tpu_torch.data.synthetic import SyntheticFaceDataset
    from sahs_tpu_torch.models import nerface
    from sahs_tpu_torch.ops.rays import get_ray_bundle
    from sahs_tpu_torch.render.pipeline import RenderSettings, render_rays_chunked
    from sahs_tpu_torch.utils.device import cuda_ms

    cfg = Config()
    cfg.nerf.validation.num_fine = 128
    out = {"per-point frame": _frame_ms(dev, cfg)}
    cfg = Config()
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    model = nerface.NeRFaceModel.init(nerface.ModelSpec.from_config(cfg), seed=0,
                                      device=dev)
    ds = SyntheticFaceDataset(kind="audio", num_frames=1, H=512, W=512,
                              near=near, far=far)
    item = ds[0]
    cfg.runtime.fused_grads = False
    cfg.runtime.fuse_composite = False
    s = RenderSettings.from_config(cfg, "validation")
    t = lambda k: torch.as_tensor(item[k]).to(dev)
    ro, rd = get_ray_bundle(512, 512, t("intrinsics"), t("pose"))
    ro, rd = ro.reshape(-1, 3)[:32768], rd.reshape(-1, 3)[:32768]
    bg = torch.as_tensor(ds.background()).to(dev).reshape(-1, 15)[:32768]
    out["reuse frame chunk"] = cuda_ms(lambda: render_rays_chunked(
        model, s, ro, rd, near, far, t("driving"), t("pose"), background_prior=bg,
        chunksize=32768), 1, runs=2)
    return out


def _grid_times(dev, reps: int = 20) -> dict:
    """K4, K9 and K10 per call at their paths' shapes, on the points of
    2048 random pixels' rays of the synthetic 512x512 frame, sorted samples
    between the flagship's near and far planes, ray by ray as a step lays
    them out (a step's fine points: 262,144 in ~700 of the grid's cells, up
    to ~3,000 a cell): K4 at the fused step's 262,144 fine points with the
    addend, K9 there on ray-major points and on the sample-major copies the
    JAX slab kernel wants (the fallback's layout before K9 binned its
    points by cell; the two copies are timed too), K10 in bfloat16 and
    float32 at the per-point step's 393,216, and K9 at a frame chunk's
    4,194,304 points (32,768 rays x 128: 2,048 of the sort's tiles); each
    its per-call time (CUDA events, the minimum over 3 runs of ``reps``
    calls) and its device time by CUDA kernel (torch.profiler)."""
    import numpy as np
    import torch

    from sahs_tpu_torch.config import Config
    from sahs_tpu_torch.data.synthetic import SyntheticFaceDataset
    from sahs_tpu_torch.ops.grid import _cell_geometry, pack_corner_table
    from sahs_tpu_torch.ops.kernels import grid_bwd as k4
    from sahs_tpu_torch.ops.rays import get_rays_at
    from sahs_tpu_torch.utils.device import cuda_ms, device_ms_by_kernel

    rng = np.random.RandomState(2)
    g = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    shape = (32, 32, 32, 32)
    cfg = Config()
    near, far = cfg.dataset.near, cfg.dataset.far
    item = SyntheticFaceDataset(kind="audio", num_frames=1, H=512, W=512,
                                near=near, far=far)[0]
    idx = torch.tensor(rng.choice(512 * 512, 2048, replace=False), device=dev)
    camera = [torch.as_tensor(item[k]).to(dev) for k in ("intrinsics", "pose")]
    ro, rd = get_rays_at(idx, 512, 512, *camera)

    def rays(R, S):
        z = g(np.sort(rng.uniform(near, far, (R, S)), axis=1))
        xyz = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(R * S, 3)
        return torch.cat([xyz, g(rng.uniform(-1, 1, (R * S, 2)))], 1)

    def reading(fn, counter=None, reps=reps):
        return {"ms": cuda_ms(fn, reps, runs=3),
                "launch_ms": device_ms_by_kernel(fn, launches=reps, counter=counter)}

    out = {}
    R = 2048
    pts = rays(R, 128)
    gse, gse2 = g(rng.randn(R * 128, 32) * 1e-3), g(rng.randn(R * 128, 32) * 1e-3)
    rows = _cell_geometry(pts, shape[1:])[0].to(torch.int32).reshape(R, 128)
    out["K4 fine"] = reading(lambda: k4.grid_dg(pts, rows, gse, gse2, shape), k4.grid_dg)
    out["K9 fine, ray-major"] = reading(lambda: k4.grid_dg_coords(pts, gse, shape),
                                    k4.grid_dg_coords)
    # ray-major -> sample-major: all rays' sample s adjacent
    sample_major = lambda x: x.reshape(R, 128, -1).transpose(0, 1).reshape(R * 128, -1)
    pts_sm, g_sm = sample_major(pts[:, :3]), sample_major(gse)
    out["K9 fine, sample-major"] = reading(lambda: k4.grid_dg_coords(pts_sm, g_sm, shape),
                                       k4.grid_dg_coords)
    out["sample_major copies"] = reading(
        lambda: (sample_major(pts[:, :3]), sample_major(gse)))
    pts = rays(R, 192)
    gp = g(rng.randn(R * 192, 32) * 1e-3)
    rows = _cell_geometry(pts, shape[1:])[0]
    grid = g(rng.randn(*shape) * 0.1)
    for dtype, tdt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        vals = pack_corner_table(grid, dtype=tdt)[rows]
        out[f"K10 {dtype}"] = reading(
            lambda: k4.grid_bwd_fused(shape, pts, gp, vals, dtype), k4.grid_bwd_fused)
        del vals
    idx = torch.tensor(rng.choice(512 * 512, 32768, replace=False), device=dev)
    ro, rd = get_rays_at(idx, 512, 512, *camera)      # ``rays`` reads these
    pts = rays(32768, 128)
    gc = g(rng.randn(32768 * 128, 32) * 1e-3)
    out["K9 frame chunk"] = reading(lambda: k4.grid_dg_coords(pts, gc, shape),
                                 k4.grid_dg_coords, reps=5)
    return out


def _chain_times(dev, reps: int = 20) -> dict:
    """The tools' chain kernels per call at the tools' 262,144 rows (CUDA
    events, the minimum over 3 runs of ``reps`` calls): X1 at every
    CHAIN_CASE, X4, X5 and X6 (reshape), each with its TFLOP/s and its
    distance to its plain version (L2-relative, and the worst row against
    the largest for X1, the worst entry for X4-X6: phase 15's TOOL_GATES);
    X4-X6 also on the card tests' draw (16,384 rows, seed 2)."""
    import torch

    from sahs_tpu_torch.tools import exp_gather as xg
    from sahs_tpu_torch.tools import exp_pair2 as xp
    from sahs_tpu_torch.utils.device import cuda_ms

    def dist(a, b, rows: bool):
        a, b = a.double(), b.double()
        worst = (a - b).abs().max() / (b.abs().max() if rows else 1.0)
        return {"l2_rel": float((a - b).norm() / b.norm()), "worst": float(worst)}

    out = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    P = xg.P
    for n, H in xg.CHAIN_CASES:
        x, w = xg.chain_inputs(H, gen, dev)
        ms = cuda_ms(lambda: xg.chain_rows(x, w, n), reps, runs=3)
        out[f"X1 {n}x{H}"] = {"ms": ms, "tflops": 2 * P * H * H * n / ms / 1e9,
                              **dist(xg.chain_rows(x, w, n), xg.chain_plain(x, w, n), True)}
    x, x2, ws, ws2 = xp.inputs(gen, dev)
    sx, sx2, sws, sws2 = xp.inputs(torch.Generator(device=dev).manual_seed(2), dev, 16384)
    for name, call, plain, width, small in (
            ("X4", xp.narrow_call, xp.narrow_plain, 64, (sx, sws)),
            ("X5", xp.paired_call, xp.paired_plain, 128, (sx2, sws2)),
            ("X6", lambda a, w: xp.reshape_call(a, w, "reshape"),
             lambda a, w: xp.reshape_plain(a, w, "reshape"), 128, (sx, sws2))):
        args = {"X4": (x, ws), "X5": (x2, ws2), "X6": (x, ws2)}[name]
        ms = cuda_ms(lambda: call(*args), reps, runs=3)
        rows = P if width == 64 else P // 2
        out[name] = {"ms": ms, "tflops": 2 * rows * width * width * xp.L / ms / 1e9,
                     **dist(call(*args), plain(*args), False),
                     "16384 rows": dist(call(*small), plain(*small), False)}
    return out


def _dg_times(dev, reps: int = 30) -> dict:
    """X2 per call at every DG_CASE at the tool's 262,144 rows (CUDA events,
    the minimum over 3 runs of ``reps`` calls), its L2-relative distance
    to its plain version, whether a second launch gives the same bits, and
    its library call (``torch.gather`` on the tiled view, as phase 15)."""
    import torch

    from sahs_tpu_torch.tools import exp_gather as xg
    from sahs_tpu_torch.utils.device import cuda_ms

    out = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    T = xg.TILE
    for L, dt, n in xg.DG_CASES:
        x, idx = xg.dg_inputs(L, dt, gen, dev)

        def lib():
            h, i = x.reshape(-1, T, L), idx.reshape(-1, T, L).long()
            acc = torch.zeros(h.shape, dtype=torch.float32, device=dev)
            for _ in range(n):
                acc += torch.gather(h, 1, i).float()
                i = (i + 7) % T
            return acc.sum(-1)
        a, b = xg.dg_rows(x, idx, n), xg.dg_plain(x, idx, n)
        out[f"X2 L={L} x{n} {dt}"] = {
            "ms": cuda_ms(lambda: xg.dg_rows(x, idx, n), reps, runs=3),
            "library_ms": cuda_ms(lib, 3, runs=1),
            "l2_rel": float((a.double() - b.double()).norm() / b.double().norm()),
            "repeat_equal": bool(torch.equal(a, xg.dg_rows(x, idx, n)))}
    return out


def _checkout_module(path: str):
    """This checkout's ``sahs_tpu_torch/<path>``, loaded beside the
    ``sahs_tpu_torch`` imported from the tree under test (its relative
    imports resolve in that package): every tree runs one definition of
    the measurement, on its own code."""
    import importlib.util

    import sahs_tpu_torch.train  # noqa: F401  (the package its imports resolve in)
    package = "sahs_tpu_torch." + os.path.dirname(path).replace("/", ".")
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(
        f"{package}._level_ab_{name}", os.path.join(_HERE, "sahs_tpu_torch", path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trace_step():
    """This checkout's ``train/trace_step.py`` (PATHS and ``build_step``)
    on the tree's code."""
    return _checkout_module("train/trace_step.py")


def _step_times(dev, n_steps: int = 5) -> dict:
    from sahs_tpu_torch.utils.device import cuda_ms

    steps = _trace_step()
    out = {}
    for name in ("fused", "fallback", "reuse", "pointwise", "plain", "warp_only",
                 "ambient_only"):
        step, state, batch, gen = steps.build_step(name, dev)
        held = [state]

        def one():
            held[0], _ = step(held[0], batch, generator=gen)
        out[name] = cuda_ms(one, n_steps, warmup=2)
        del held, step
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=_HERE)
    ap.add_argument("--fields-only", action="store_true",
                    help="time K7 and K11 alone")
    ap.add_argument("--skip-only", action="store_true", help="time K13 alone")
    ap.add_argument("--serve-only", action="store_true",
                    help="time K5 and K1 at a frame's chunks and the frames")
    ap.add_argument("--grid-only", action="store_true",
                    help="time K4, K9 and K10 at their paths' shapes")
    ap.add_argument("--chains-only", action="store_true",
                    help="time the tools' chain kernels X1 and X4-X6")
    ap.add_argument("--dg-only", action="store_true",
                    help="time X2 in its four cases")
    ap.add_argument("--steps-only", action="store_true",
                    help="time the train steps of train/trace_step.py alone")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import sahs_tpu_torch
    from sahs_tpu_torch.utils.device import card_line
    dev = torch.device("cuda")
    res = {"tree": os.path.dirname(os.path.dirname(os.path.abspath(sahs_tpu_torch.__file__))),
           "card": f"{torch.cuda.get_device_name(dev)} | {card_line()}"}
    if args.grid_only:
        res["grid"] = _grid_times(dev)
    elif args.chains_only:
        res["chains"] = _chain_times(dev)
    elif args.dg_only:
        res["dg"] = _dg_times(dev)
    elif args.steps_only:
        res["steps_ms"] = _step_times(dev)
    elif args.skip_only:
        res["skip_net"] = _skip_times(dev)
    elif args.serve_only:
        res.update(serve=_serve_kernel_times(dev), frames_ms=_serve_frame_times(dev))
    elif args.fields_only:
        res["fields"] = _field_times(dev)
    else:
        res.update(serve=_serve_kernel_times(dev), fields=_field_times(dev),
                   skip_net=_skip_times(dev), k15=_k15_times(dev),
                   kernels_ms=_kernel_times(dev), deform_nets=_deform_times(dev),
                   grid=_grid_times(dev),
                   steps_ms=_step_times(dev),
                   frames_ms={**_serve_frame_times(dev), **_frame_times(dev)})
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
