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
    python sahs_tpu_torch/tools/level_ab.py --tree <root> --bwd-only
    python sahs_tpu_torch/tools/level_ab.py --tree <root> --deform-only [--k3-bits FILE]
    python sahs_tpu_torch/tools/level_ab.py --tree <root> --pair-only
    python sahs_tpu_torch/tools/level_ab.py --tree <root> --k5-bits FILE

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
minimum of 2, CUDA events. ``--fields-only`` times K7 and K11 alone
and the launches of K2, K6, K8 and K12 by device time
(``_launch1_times``: their launch 1, ``fwd_tc_kernel``, is the forward tile
with the stash),
``--skip-only`` the deformation nets' forwards alone, K13 and K1 at a
frame's chunks (``_pair_times``; to compare two builds of their tile),
``--serve-only`` K5, K1 and the frames (the flagship, warp-only,
ambient-only and per-point frames and the reuse chunk: the serving
readings; with ``--k1-bits FILE`` K1's fine-chunk output is saved to FILE,
or held bit for bit against the one another tree saved there),
``--grid-only`` the grid backward (K4, K9
and K10 at their paths' shapes, ``_grid_times``), ``--chains-only`` the
tools' chain kernels X1 and X4-X6 with their gates' readings
(``_chain_times``), ``--dg-only`` X2 in its four cases beside its
library call (``_dg_times``), ``--deform-only`` the deformation nets'
backwards: K3 and K14 per call, by launch (device ms, torch.profiler) and
in their other forms (``_deform_times``; with ``--k3-bits FILE`` K3's
activation stash, bf16 K1's and K13's outputs and float32 K3's and K14's
results are saved to FILE, or held bit for bit against the ones another
tree saved there, the stash slot by slot), then the traced fused,
fallback-1, per-point and warp-only steps, ``--pair-only`` K2's pair=
form (``_fold_times``: per call, by launch, beside K2 then K3's rays=
form on K2's gx, its library calls and its bound) and the traced fused
step in its default and fold variants, ``--k5-bits FILE`` the forward
tile's outputs (``_k5_bits``: K5's raw field and composited outputs at a
frame's chunks on the flagship's and the ablation's level, K7's and K11's
raw field, K2's launch 1 with its stash and the call's outputs) saved to
FILE, or held bit for bit against the ones another tree saved there,
alone or before another mode's readings, ``--steps-only`` the
steps alone, ``--bwd-only`` the level backward: K2, K6 and K8 at a step's
fine and coarse level and K12 at the per-point step's 393,216 points per
call (``_kernel_times``) and by launch (device ms, torch.profiler,
``_launch1_times``), then the traced fused, fallback-1 and per-point steps
(``train/trace_step.py``'s ``trace_train_step``, 3 steps each: kernel ms,
idle share, step ms, and each kernel's ms a step). Prints one JSON line: the tree, the card's name and power
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


def _deform_times(dev, reps: int = 3, by_launch: bool = False,
                  k3_bits: str = None) -> dict:
    """K3 and K14 per call, each beside its library call, TFLOP/s and the
    share of its bound. With ``by_launch``, also each call's launches by
    device time (torch.profiler) and the other forms per call: K3 with the
    points' cotangent and in the rays= form, K14 with the points' cotangent
    and on a given encoding. With ``k3_bits``, a file path: K3's activation
    stash (the recomputed forward), and what must not change beside it
    (bf16 K1's and K13's outputs at the same points, float32 K3's and K14's
    dW and points' cotangent on the first 8,192), saved there, or held bit
    for bit against the ones another tree saved (``_held_bits``)."""
    import numpy as np
    import torch

    from sahs_tpu_torch.config import Config
    from sahs_tpu_torch.models import nerface
    from sahs_tpu_torch.ops.kernels import deform_pair as k1
    from sahs_tpu_torch.ops.kernels import skip_mlp as k13
    from sahs_tpu_torch.ops.kernels.field_mlp import kernel_pe
    from sahs_tpu_torch.utils.device import cuda_ms, device_ms_by_kernel, profiler_windows

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

    def row(fn, counter, lib_ms, macs):
        ms = best(fn)
        flops = 2 * macs * P
        bound = flops / PEAK_BF16_FLOPS * 1e3
        out = {"ms": ms, "library_ms": lib_ms, "tflops": flops / (ms / 1e3) / 1e12,
               "bound_ms": bound, "bound_share": bound / ms}
        if by_launch:
            out["launch_ms"] = device_ms_by_kernel(fn, 5, counter=counter)
            out["profiler_windows"] = profiler_windows()
        return out

    out = {}
    pair = k1.prepare_pair(model.warp, model.hyper, cond, warp_g)
    gp, gp2 = g(rng.randn(P, 5) * 1e-3), g(rng.randn(P, 5) * 1e-3)
    k3 = lambda: k1.deform_pair_vjp(pts, pair, gp, gp2, "bfloat16")
    k3_macs = (_vjp_macs(pair.warp_trunk, pair.warp_out, pair.warp_skip)
               + _vjp_macs(pair.hyper_trunk, pair.hyper_out, pair.hyper_skip))
    out["K3 fine"] = row(k3, k1.deform_pair_vjp,
                         best(library((model.warp, model.hyper), gp + gp2)), k3_macs)
    if k3_bits:
        plan = k1.pair_train_plan(pair, torch.bfloat16)
        named = {"K3 stash": _k3_stash(k3, (P // 64) * plan.act_stride)}
        named["K1 packed"], named["K1 rows"] = k1.deform_pair_forward(
            pts, pair, "bfloat16", 128, (32, 32, 32))
        n = 8192
        gx, tree = k1.deform_pair_vjp(pts[:n], pair, gp[:n], gp2[:n], "float32",
                                      need_gx=True)
        named["K3 float32 gx"] = gx
        for net in ("warp", "hyper"):
            for i, lay in enumerate(tree[net]["trunk"] + [tree[net]["out"]]):
                named[f"K3 float32 {net} layer {i}"] = torch.cat([lay["w"].reshape(-1), lay["b"]])
        for name, act, cols in (("warp", "tanh", slice(0, 3)), ("hyper", "linear", slice(3, 5))):
            w = k13.prepare_skip(getattr(model, name), cond, warp_g, act)
            named[f"K13 {name}"] = k13.skip_mlp_forward(pts, w, "bfloat16")
            gx, tree = k13.skip_mlp_vjp(pts[:n], w, gp[:n, cols].contiguous(), True, "float32")
            named[f"K14 float32 {name} gx"] = gx
            for i, lay in enumerate(tree["trunk"] + [tree["out"]]):
                named[f"K14 float32 {name} layer {i}"] = torch.cat([lay["w"].reshape(-1),
                                                                   lay["b"]])
        out["K3 bits"] = _held_bits(named, plan.slots[:plan.n_act].tolist(), plan.act_stride,
                                    k3_bits)
    if by_launch:
        ro, rd = g(rng.randn(2048, 3) * 0.1), g(rng.randn(2048, 3) * 0.3 + [0, 0, -1])
        z = g(np.sort(rng.uniform(0.5, 1.5, (2048, 128)), axis=-1))
        out["K3 fine, points' cotangent"] = {"ms": best(
            lambda: k1.deform_pair_vjp(pts, pair, gp, gp2, "bfloat16", need_gx=True))}
        out["K3 fine, rays="] = {"ms": best(
            lambda: k1.deform_pair_vjp(None, pair, gp, gp2, "bfloat16", rays=(ro, rd, z)))}
    for name, act, cols in (("warp", "tanh", slice(0, 3)), ("hyper", "linear", slice(3, 5))):
        net = getattr(model, name)
        w = k13.prepare_skip(net, cond, warp_g, act)
        gs = gp[:, cols].contiguous()
        out[f"K14 {name} fine"] = row(
            lambda: k13.skip_mlp_vjp(pts, w, gs, False, "bfloat16"), k13.skip_mlp_vjp,
            best(library((net,), gs)), _vjp_macs(w.trunk, w.out, w.skip))
        if by_launch:
            out[f"K14 {name} fine, points' cotangent"] = {"ms": best(
                lambda: k13.skip_mlp_vjp(pts, w, gs, True, "bfloat16"))}
            we = k13.prepare_skip(net, cond, None, act)
            out[f"K14 {name} fine, pre-encoded"] = {"ms": best(
                lambda: k13.skip_mlp_vjp(pe, we, gs, True, "bfloat16"))}
    return out


def _level_macs(level) -> int:
    """Multiply-adds a point of a NeRF level's forward (K5's products)."""
    mats = ([p["w"] for p in level.trunk] + [level.feat["w"], level.alpha["w"],
            level.dir0_feat, level.dir0_se] + [p["w"] for p in level.dir_rest]
            + [level.rgb["w"]] + [p["w"] for p in level.seg] + [level.seg_out["w"]])
    return sum(m.numel() for m in mats)


def _fold_times(dev, reps: int = 3) -> dict:
    """K2's pair= form in bf16 at a step's fine level (2048 rays x 128 =
    262,144 points) on the flagship's seeded coarse level and deformation
    pair: ms per call (CUDA events, the minimum over 3 rounds of the mean
    of 3 calls) and by launch (device ms, torch.profiler), beside the same
    function as two calls (K2, then K3's rays= form on K2's gx); its
    library time, K2's chain (the level's module under bf16 autocast, the
    compositing and the loss, autograd to its parameters, the encoding and
    the sampled embedding) plus K3's rays= chain (the pair's modules under
    bf16 autocast on the rays' points, autograd with K2's gx as the
    cotangent), each timed apart; and its bound: K2's operations (forward,
    backward chain, dW: 3 x the level's forward) and K3's (the same without
    the products back to the encoding) at 989 TFLOP/s, against each input
    read once and each output written once at 3.35 TB/s."""
    import numpy as np
    import torch

    from sahs_tpu_torch.config import Config
    from sahs_tpu_torch.models import nerface
    from sahs_tpu_torch.ops.grid import _cell_geometry, interp_corners, pack_corner_table
    from sahs_tpu_torch.ops.kernels import deform_pair as k1
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.ops.kernels import nerf_level as k5
    from sahs_tpu_torch.ops.kernels.field_mlp import kernel_pe
    from sahs_tpu_torch.ops.kernels.nerf_level import composite_plain
    from sahs_tpu_torch.ops.kernels.points import build_pts_plain
    from sahs_tpu_torch.train.fused import _level_loss
    from sahs_tpu_torch.utils.device import cuda_ms, device_ms_by_kernel, profiler_windows

    spec = nerface.ModelSpec.from_config(Config())
    model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
    rng = np.random.RandomState(2)
    g = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    driving, pose = g(rng.randn(76) * 0.5), g(rng.randn(36) * 0.5)
    nerf = model.coarse
    ncond = torch.cat([driving, pose]) if nerf.spec.include_driving else pose
    warp_g, pts_g, dir_g = nerface.build_pe_groups(spec)
    level = k5.prepare_level(nerf, ncond, pts_g, dir_g)
    pair = k1.prepare_pair(model.warp, model.hyper, torch.cat([driving, pose]), warp_g)
    table = pack_corner_table(model.spatial_embeddings.detach(), dtype=torch.bfloat16)
    grid, R, S = (32, 32, 32), 2048, 128
    P = R * S
    pts = g(np.concatenate([rng.uniform(-1.05, 1.05, (P, 3)), rng.uniform(-1, 1, (P, 2))], 1))
    dirs = g(rng.randn(R, 3) * 0.1 + [0, 0, -1])
    ro = g(rng.randn(R, 3) * 0.05 + [0, 0, 1.2])
    z = g(np.sort(rng.uniform(0.48, 1.08, (R, S)), axis=-1))
    bg, noise = g(rng.rand(R, 15)), g(rng.randn(R, S) * 0.5)
    tgt = g(np.concatenate([rng.rand(R, 3), np.eye(12)[rng.randint(0, 12, R)]], 1))
    lw = g(np.stack([np.full(R, 1.0 / R), np.full(R, 0.02 / R)], 1))
    rows = _cell_geometry(pts, grid)[0]
    a = (pts, dirs, table, rows, z, bg, noise, tgt, lw, level, "bfloat16", grid, 0.5)
    best = lambda fn: cuda_ms(fn, reps, runs=3)
    fold = lambda: k2.nerf_level_train(*a, pair=(pair, ro))
    two = lambda: k1.deform_pair_vjp(None, pair, k2.nerf_level_train(*a)[2], None,
                                     "bfloat16", rays=(ro, dirs, z))
    gx = k2.nerf_level_train(*a)[2]

    def k2_library():
        x = kernel_pe(pts, level.pts_groups).requires_grad_()
        dpe = kernel_pe(dirs, level.dir_groups).repeat_interleave(S, dim=0)
        _, fs, ok = _cell_geometry(pts, grid)
        se = interp_corners(table[rows.reshape(-1).long()], fs, ok).requires_grad_()
        params = [x, se] + list(nerf.parameters())
        with torch.autocast("cuda", dtype=torch.bfloat16):
            raw = nerf(x, dpe, driving=driving, pose=pose, spatial_embedding=se)
        rgb, _ = composite_plain(raw.float().reshape(R, S, 16), z, dirs, bg, noise)
        return torch.autograd.grad(_level_loss(rgb, tgt, lw), params)

    def k3_library():
        pe = kernel_pe(build_pts_plain(ro, dirs, z), warp_g)
        nets = (model.warp, model.hyper)
        params = [p for n in nets for p in n.parameters()]
        with torch.autocast("cuda", dtype=torch.bfloat16):
            o = torch.cat([n(pe, driving, pose) for n in nets], dim=-1)
        return torch.autograd.grad((o.float() * gx).sum(), params)

    k3_macs = (_vjp_macs(pair.warp_trunk, pair.warp_out, pair.warp_skip)
               + _vjp_macs(pair.hyper_trunk, pair.hyper_out, pair.hyper_skip))
    flops = 2 * (3 * _level_macs(level) + k3_macs) * P
    plans = (k2.level_train_plan(level, torch.bfloat16), k1.pair_train_plan(pair, torch.bfloat16))
    C = level.dir0_se.shape[0]
    nbytes = (4 * (P * 5 + P + R * (3 + 3 + 2 * S + 15 + 15 + 2)) + 2 * table.numel()
              + 4 * (R * (16 + S + 15) + P * C) + sum(6 * pl.out_len for pl in plans))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    out = {"ms": best(fold), "two_calls_ms": best(two),
           "launch_ms": device_ms_by_kernel(fold, 5, counter=k2.nerf_level_train),
           "two_calls_launch_ms": device_ms_by_kernel(two, 5, counter=k1.deform_pair_vjp),
           "library_k2_ms": best(k2_library), "library_k3_rays_ms": best(k3_library),
           "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "bound_ops_ms": t_ops, "bound_bytes_ms": t_bytes, "gx_scratch_bytes": P * 5 * 4}
    out["library_ms"] = out["library_k2_ms"] + out["library_k3_rays_ms"]
    out["profiler_windows"] = profiler_windows()
    out["bound_share"] = out["bound_ms"] / out["ms"]
    return out


def _k3_stash(fn, n: int):
    """The activation stash of one call of ``fn`` (a bf16 K3): the bf16
    tensor of ``n`` elements it allocates (``_caught_empty``)."""
    import torch
    _, made = _caught_empty(fn)
    return next(t for t in made if t.dtype == torch.bfloat16 and t.numel() == n)


def _held_bits(named: dict, slots, block: int, path: str) -> dict:
    """The tensors of ``named`` saved to ``path``, or held against the ones
    saved there, bit for bit (compared as integers): whether each is equal,
    and for K3's activation stash the elements that differ by slot (the
    encoding, then each net's h_0 ..., ``slots`` their offsets in a
    64-point tile's block of ``block`` elements) and the first differing
    slot."""
    import torch
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32, torch.int32: torch.int32}
    got = {k: v.detach().contiguous().view(ints[v.dtype]).cpu() for k, v in named.items()}
    if not os.path.exists(path):
        torch.save(got, path)
        return {"saved": path}
    ref = torch.load(path)
    stash, ref_stash = got["K3 stash"], ref["K3 stash"]
    diff = (stash != ref_stash).reshape(stash.numel() // block, block)
    by_slot = [int(diff[:, a:b].sum()) for a, b in zip(slots, slots[1:] + [block])]
    return {"equal": {k: bool(torch.equal(v, ref[k])) for k, v in got.items()},
            "elements": stash.numel(), "differing_by_slot": by_slot,
            "first_differing_slot": next((i for i, n in enumerate(by_slot) if n), None)}


def _digest(t) -> list:
    """A tensor's bits as three integers: its element count, the sum of its
    elements read as integers, and that sum weighted by a pseudo-random
    int64 of each position (products and sums wrap modulo 2^64, so the
    order of the sums does not matter)."""
    import torch
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    x = t.detach().contiguous().view(ints[t.dtype]).reshape(-1).to(torch.int64)
    w = torch.arange(x.numel(), device=x.device, dtype=torch.int64)
    w = w * 6364136223846793005 + 1442695040888963407
    return [x.numel(), int(x.sum()), int((x * w).sum())]


def _caught_empty(fn):
    """``fn()``'s result and every tensor it allocated through
    ``torch.empty``, in order (each tree's wrapper allocates its raw field
    and stash there and returns neither)."""
    import torch
    made, empty = [], torch.empty

    def catch(*args, **kw):
        t = empty(*args, **kw)
        made.append(t)
        return t
    torch.empty = catch
    try:
        out = fn()
    finally:
        torch.empty = empty
    torch.cuda.synchronize()
    return out, made


def _flat(prefix: str, tree) -> dict:
    """The tensors of a nested dict or list, named by their path."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(f"{prefix} {key}", tree[key]).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in _flat(f"{prefix} {i}", x).items()}
    return {} if tree is None else {prefix: tree}


def _k5_bits(dev, path: str) -> dict:
    """The forward tile's outputs (level_train.cu fw::tile) on seeded
    inputs, saved to ``path`` when it does not exist, and otherwise held
    bit for bit against the ones another tree saved there: K5's raw field
    (``field_tc_kernel``, into the scratch of ``nerf_level._nerf_level_tc``)
    and composited outputs at a frame's fine (32,768 rays x 128) and coarse
    (x 64) chunk, on the flagship's seeded coarse level and on the ablation
    config's (4 x 256, 15 PE frequencies, a 76-d code, the points
    themselves); K7's raw at a step's fine level (2048 x 128) and K11's at
    the per-point step's 2048 x 192, on the flagship's; and a K2 call at a
    step's fine level (``fwd_tc_kernel``'s raw field and activation stash,
    then every output and gradient of the call). The stash (1.8 GB) is held
    slot by slot through ``_digest``, everything else element for element.
    Returns whether each is equal and, where not, the elements that
    differ."""
    import numpy as np
    import torch

    from sahs_tpu_torch.config import Config, load_config
    from sahs_tpu_torch.models import nerface
    from sahs_tpu_torch.ops.grid import _cell_geometry, pack_corner_table
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.ops.kernels import nerf_level as k5
    from sahs_tpu_torch.ops.kernels import nerf_mlp as k11

    g = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    grid = (32, 32, 32)
    ablation = load_config(os.path.join(_HERE, "configs", "expression",
                                        "person_1_ablation.yml"))
    named, digests = {}, {}
    for cname, cfg, PW, n_cond in (("flagship", Config(), 5, 36),
                                   ("ablation", ablation, 3, 76)):
        spec = nerface.ModelSpec.from_config(cfg)
        model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
        rng = np.random.RandomState(27)
        _, pts_g, dir_g = nerface.build_pe_groups(spec)
        level = k5.prepare_level(model.coarse, g(rng.randn(n_cond) * 0.5), pts_g, dir_g)
        table = pack_corner_table(model.spatial_embeddings.detach(), dtype=torch.bfloat16)
        R = 32768
        dirs = g(rng.randn(R, 3) * 0.1 + [0, 0, -1])
        bg = g(rng.rand(R, 15))
        for S, chunk in ((128, "fine"), (64, "coarse")):
            P = R * S
            pts = g(np.concatenate([rng.uniform(-0.6, 0.6, (P, 3)),
                                    rng.uniform(-1, 1, (P, PW - 3))], 1))
            rows = _cell_geometry(pts, grid)[0]
            z = g(np.sort(rng.uniform(0.48, 1.08, (R, S)), axis=-1))
            ints = k5.level_kernel_args(pts, dirs, table, rows, level, "bfloat16", grid,
                                        "K5")[4]
            rows_i, table_c = k5._grid_args(rows, table)
            raw = torch.empty((P, 16), dtype=torch.float32, device=dev)
            rgb, w = k5._nerf_level_tc(pts, dirs, table_c, rows_i, z, bg, None, level, R, S,
                                       ints, raw)
            named.update({f"K5 {cname} {chunk} raw": raw, f"K5 {cname} {chunk} rgb_map": rgb,
                          f"K5 {cname} {chunk} weights": w})
            del pts, rows, z, rows_i, raw
            torch.cuda.empty_cache()
        if cname == "ablation":
            continue
        R = 2048
        rng = np.random.RandomState(28)
        P = R * 128
        pts = g(np.concatenate([rng.uniform(-1.05, 1.05, (P, 3)),
                                rng.uniform(-1, 1, (P, 2))], 1))
        dirs = g(rng.randn(R, 3) * 0.1 + [0, 0, -1])
        rows = _cell_geometry(pts, grid)[0]
        named["K7 fine raw"] = k5.nerf_rayd_forward(pts, dirs, table, rows, level,
                                                    "bfloat16", grid)
        z = g(np.sort(rng.uniform(0.48, 1.08, (R, 128)), axis=-1))
        bg, noise = g(rng.rand(R, 15)), g(rng.randn(R, 128) * 0.5)
        tgt = g(np.concatenate([rng.rand(R, 3), np.eye(12)[rng.randint(0, 12, R)]], 1))
        lw = g(np.stack([np.full(R, 1.0 / R), np.full(R, 0.02 / R)], 1))
        out, made = _caught_empty(lambda: k2._launch(
            "loss", "nerf_level_train", pts, dirs, table, rows, level, "bfloat16", grid,
            z=z, bg=bg, noise=noise, tgt=tgt, lw=lw, bg_sup=0.5))
        *outs, acts = out
        named["K2 launch 1 raw"] = next(t for t in made if t.dtype == torch.float32
                                        and tuple(t.shape) == (P, 16))
        named.update(_flat("K2", {"rgb_map": outs[0], "weights": outs[1], "gx": outs[2],
                                  "gse": outs[3], "g_bg": outs[4], "grads": outs[5]}))
        plan = k2.level_train_plan(level, torch.bfloat16)
        blocks = acts.reshape(-1, plan.act_stride)
        offs = plan.slots[:plan.n_act].tolist() + [plan.act_stride]
        for i, (a, b) in enumerate(zip(offs, offs[1:])):
            digests[f"K2 launch 1 stash slot {i}"] = _digest(blocks[:, a:b])
        del out, made, outs, acts, blocks
        P = R * 192
        pts = g(np.concatenate([rng.uniform(-1.05, 1.05, (P, 3)),
                                rng.uniform(-1, 1, (P, 2))], 1))
        extra = g(np.concatenate([rng.randn(P, 3) * 0.1 + [0, 0, -1],
                                  rng.randn(P, level.dir0_se.shape[0]) * 0.3], 1))
        named["K11 step raw"] = k11.nerf_mlp_forward_fused(pts, extra, level, "bfloat16")
        del pts, extra
    torch.cuda.synchronize()
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    got = {k: v.detach().contiguous().view(ints[v.dtype]).cpu() for k, v in named.items()}
    if not os.path.exists(path):
        torch.save({"tensors": got, "digests": digests}, path)
        return {"saved": path, "tensors": len(got), "digests": len(digests)}
    ref = torch.load(path)
    equal = {k: bool(torch.equal(v, ref["tensors"][k])) for k, v in got.items()}
    equal.update({k: v == ref["digests"][k] for k, v in digests.items()})
    return {"all_equal": all(equal.values()), "equal": equal,
            "differing": {k: int((v != ref["tensors"][k]).sum()) for k, v in got.items()
                          if not equal[k]}}


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


def _launch1_times(dev, launches: int = 5) -> dict:
    """Launch 1 of K2, K6 and K8 (``fwd_tc_kernel``, the forward tile with
    the stash) by device time (torch.profiler), in a call of each at a
    step's fine (2048 rays x 128) and coarse (x 64) level, and of K12 at the
    per-point step's 2048 x 192, on the flagship's seeded coarse level,
    beside the call's other launches."""
    import numpy as np
    import torch

    from sahs_tpu_torch.config import Config
    from sahs_tpu_torch.models import nerface
    from sahs_tpu_torch.ops.grid import _cell_geometry, pack_corner_table
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.ops.kernels import nerf_level as k5
    from sahs_tpu_torch.utils.device import device_ms_by_kernel, profiler_windows

    spec = nerface.ModelSpec.from_config(Config())
    model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
    rng = np.random.RandomState(0)
    g = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    _, pts_g, dir_g = nerface.build_pe_groups(spec)
    level = k5.prepare_level(model.coarse, g(rng.randn(36) * 0.5), pts_g, dir_g)
    table = pack_corner_table(model.spatial_embeddings.detach(), dtype=torch.bfloat16)
    grid = (32, 32, 32)
    out = {}
    R = 2048
    for S, name in ((128, "fine"), (64, "coarse")):
        P = R * S
        pts = g(np.concatenate([rng.uniform(-1.05, 1.05, (P, 3)),
                                rng.uniform(-1, 1, (P, 2))], 1))
        dirs = g(rng.randn(R, 3) * 0.1 + [0, 0, -1])
        z = g(np.sort(rng.uniform(0.48, 1.08, (R, S)), axis=-1))
        bg, noise = g(rng.rand(R, 15)), g(rng.randn(R, S) * 0.5)
        tgt = g(np.concatenate([rng.rand(R, 3), np.eye(12)[rng.randint(0, 12, R)]], 1))
        lw = g(np.stack([np.full(R, 1.0 / R), np.full(R, 0.02 / R)], 1))
        rows = _cell_geometry(pts, grid)[0]
        args = (pts, dirs, table, rows, z, bg, noise, tgt, lw, level, "bfloat16", grid, 0.5)
        out[f"K2 {name}"] = device_ms_by_kernel(lambda: k2.nerf_level_train(*args),
                                                launches, counter=k2.nerf_level_train)
        g_rgb, g_w = g(rng.randn(R, 16) * 1e-3), g(rng.randn(R, S) * 1e-3)
        out[f"K6 {name}"] = device_ms_by_kernel(lambda: k2.nerf_level_vjp(
            pts, dirs, table, rows, z, bg, noise, g_rgb, g_w, level, "bfloat16", grid),
            launches, counter=k2.nerf_level_vjp)
        graw = g(rng.randn(P, 16) * 1e-3)
        out[f"K8 {name}"] = device_ms_by_kernel(lambda: k2.nerf_rayd_vjp(
            pts, dirs, table, rows, graw, level, "bfloat16", grid),
            launches, counter=k2.nerf_rayd_vjp)
    P = R * 192
    pts = g(np.concatenate([rng.uniform(-1.05, 1.05, (P, 3)), rng.uniform(-1, 1, (P, 2))], 1))
    extra = g(np.concatenate([rng.randn(P, 3) * 0.1 + [0, 0, -1], rng.randn(P, 32) * 0.3], 1))
    gg = g(rng.randn(P, 16) * 1e-3)
    out["K12 fine"] = device_ms_by_kernel(lambda: k2.nerf_mlp_vjp(pts, extra, gg, level,
                                                                  "bfloat16"),
                                          launches, counter=k2.nerf_mlp_vjp)
    out["profiler_windows"] = profiler_windows()
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


def _pair_times(dev, reps: int = 3) -> dict:
    """K1 alone per call at a frame's fine (32,768 rays x 128) and coarse
    (x 64) chunk, on the flagship's seeded deformation nets (the draw of
    ``_serve_kernel_times``), TFLOP/s and share of the bound."""
    import numpy as np
    import torch

    from sahs_tpu_torch.config import Config
    from sahs_tpu_torch.models import nerface
    from sahs_tpu_torch.ops.kernels import deform_pair as k1
    from sahs_tpu_torch.utils.device import cuda_ms

    spec = nerface.ModelSpec.from_config(Config())
    model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
    rng = np.random.RandomState(5)
    g = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    cond = g(rng.randn(76 + 36) * 0.5)
    pair = k1.prepare_pair(model.warp, model.hyper, cond, nerface.build_pe_groups(spec)[0])
    macs = _net_macs(pair.warp_trunk, pair.warp_out) + _net_macs(pair.hyper_trunk,
                                                                  pair.hyper_out)
    out = {}
    for S, name in ((128, "fine"), (64, "coarse")):
        P = 32768 * S
        pts = g(rng.uniform(-0.6, 0.6, (P, 3)))
        ms = cuda_ms(lambda: k1.deform_pair_forward(pts, pair, "bfloat16", S, (32, 32, 32)),
                     reps, runs=3)
        bound = 2 * macs * P / PEAK_BF16_FLOPS * 1e3
        out[f"K1 {name} chunk"] = {"ms": ms, "tflops": 2 * macs * P / (ms / 1e3) / 1e12,
                                   "bound_ms": bound, "bound_share": bound / ms}
        del pts
        torch.cuda.empty_cache()
    return out


def _serve_kernel_times(dev, reps: int = 3, k1_bits: str = None) -> dict:
    """K5 and K1 per call at a frame's fine (32,768 rays x 128) and coarse
    (x 64) chunk, on the flagship's seeded coarse level and deformation
    nets, each beside its library call (the plain version under bf16
    autocast, which the port never calls), TFLOP/s and share of the bound
    (operations at 989 TFLOP/s). With ``k1_bits``, a file path: K1's output
    and rows at the fine chunk are saved there when it does not exist, and
    otherwise held against the saved ones (another tree's, on the same
    draw), under "K1 bits"."""
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
        if k1_bits and name == "fine":
            out["K1 bits"] = _k1_bits(k1.deform_pair_forward(*args1), k1_bits)
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


def _k1_bits(got, path: str) -> dict:
    """K1's (packed, rows) saved to ``path``, or held against the ones saved
    there: whether each is equal bit for bit, the points whose packed row
    differs and the largest absolute difference."""
    import torch
    packed, rows = (t.cpu() for t in got)
    if not os.path.exists(path):
        torch.save({"packed": packed, "rows": rows}, path)
        return {"saved": path}
    ref = torch.load(path)
    differ = (packed != ref["packed"]).any(dim=1)
    return {"packed_equal": torch.equal(packed, ref["packed"]),
            "rows_equal": torch.equal(rows, ref["rows"]),
            "points_differing": int(differ.sum()), "points": packed.shape[0],
            "max_abs": float((packed - ref["packed"]).abs().max()),
            "max_abs_warp": float((packed[:, :3] - ref["packed"][:, :3]).abs().max()),
            "max_abs_ambient": float((packed[:, 3:] - ref["packed"][:, 3:]).abs().max())}


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
    from sahs_tpu_torch.utils.device import cuda_ms, device_ms_by_kernel, profiler_windows

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
        by = device_ms_by_kernel(fn, launches=reps, counter=counter)
        return {"ms": cuda_ms(fn, reps, runs=3), "launch_ms": by,
                "profiler_windows": profiler_windows()}

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


def _step_traces(paths=("fused", "fallback", "pointwise"), n_steps: int = 3,
                 variants=("default",)) -> dict:
    """The traced steps of ``paths`` (this checkout's ``trace_train_step``
    on the tree's code), each in the fused step's ``variants`` (named
    ``path variant`` past the default): step ms (CUDA events), kernel ms,
    idle share and each kernel's ms a step."""
    steps = _trace_step()
    out = {}
    for path in paths:
        for v in variants:
            name = path if v == "default" else f"{path} {v}"
            res = steps.trace_train_step(n_steps, path, v)
            kernels = {}
            for k in res["kernels"]:     # a kernel may have a row for each launching span
                kernels[k["name"]] = kernels.get(k["name"], 0.0) + k["ms_per_step"]
            out[name] = {"step_ms": res["step_ms"], "kernel_ms": res["kernel_ms"],
                         "idle_share": res["idle_share"], "kernels": kernels}
    return out


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
    ap.add_argument("--skip-only", action="store_true",
                    help="time the deformation nets' forwards alone (K13, K1)")
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
    ap.add_argument("--bwd-only", action="store_true",
                    help="time the level backward (K2, K6, K8, K12) per call and by "
                         "launch, and trace the fused, fallback and per-point steps")
    ap.add_argument("--deform-only", action="store_true",
                    help="time the deformation nets' backwards (K3, K14) per call, by "
                         "launch and in their other forms, and trace the fused, "
                         "fallback, per-point and warp-only steps")
    ap.add_argument("--pair-only", action="store_true",
                    help="time K2's pair= form per call and by launch beside K2 then "
                         "K3's rays= form, and trace the fused step's default and fold")
    ap.add_argument("--k3-bits", default=None,
                    help="with --deform-only: save K3's activation stash (and K1's, "
                         "K13's and float32 K3's and K14's results) to this file, or "
                         "hold them bit for bit against the ones saved there")
    ap.add_argument("--k5-bits", default=None,
                    help="save the forward tile's outputs (K5's raw field at a frame's "
                         "chunks for the flagship and the ablation, K7's, K11's, K2's "
                         "launch 1 and its stash) to this file, or hold them bit for bit "
                         "against the ones saved there; alone, or before another mode")
    ap.add_argument("--k1-bits", default=None,
                    help="with --serve-only: save K1's fine-chunk output to this file, "
                         "or hold it against the one saved there")
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
    if args.k5_bits:
        res["K5 bits"] = _k5_bits(dev, args.k5_bits)
        if not any(v for k, v in vars(args).items() if k.endswith("_only")):
            print(json.dumps(res), flush=True)
            return 0
    if args.grid_only:
        res["grid"] = _grid_times(dev)
    elif args.chains_only:
        res["chains"] = _chain_times(dev)
    elif args.dg_only:
        res["dg"] = _dg_times(dev)
    elif args.steps_only:
        res["steps_ms"] = _step_times(dev)
    elif args.bwd_only:
        res.update(kernels_ms=_kernel_times(dev), launches=_launch1_times(dev),
                   traces=_step_traces())
    elif args.deform_only:
        res.update(deform_nets=_deform_times(dev, by_launch=True, k3_bits=args.k3_bits),
                   traces=_step_traces(("fused", "fallback", "pointwise", "warp_only")))
    elif args.pair_only:
        res.update(pair_form=_fold_times(dev),
                   traces=_step_traces(("fused",), variants=("default", "fold")))
    elif args.skip_only:
        res.update(skip_net=_skip_times(dev), pair=_pair_times(dev))
    elif args.serve_only:
        res.update(serve=_serve_kernel_times(dev, k1_bits=args.k1_bits),
                   frames_ms={**_serve_frame_times(dev), **_frame_times(dev)})
    elif args.fields_only:
        res.update(fields=_field_times(dev), launch1=_launch1_times(dev))
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
