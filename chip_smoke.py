#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                      # build, parity, frame, timings
    python3 chip_smoke.py --report out/r.json  # and the full report as JSON

Phases, in order (any failure exits non-zero and prints no result):
  1. build every CUDA kernel of sahs_tpu_torch/csrc (one nvcc per source,
     in parallel) and print the build time and ptxas' register report;
  2. kernel parity: K1 (deform pair) and K5 (NeRF level) against their
     plain PyTorch versions on the card, on rays of the synthetic frame at
     S = 64 and 128 samples, with a background prior and with sigma noise,
     in float32 (gate: max abs error <= 1e-4, corner rows exact) and in
     bfloat16 (gate 2e-2 relative, the bf16 gate of PARITY_TPU.json: for
     K5's rgb_map and weights as max |a - b| / (|b| + 1e-3), the metric of
     that file; for K1's outputs, which pass through zero, as
     max |a - b| / max |b| taken separately over the warp offset
     (output xyz less the input point) and over the ambient coordinates);
     in both types K1's rows must be, bit for bit, the cells of K1's own
     output coordinates;
  3. the main path: the flagship Config() (AudioFaceModel, 64 + 64 samples,
     32-channel 32^3 grid, background prior, bf16) with seeded random
     weights renders a synthetic 512x512 audio frame through
     evaluation.make_eval_renderer; the K1 and K5 launch counters, set to
     0 just before the timed frame, must each show 2 launches per chunk;
     the output must be finite, in [0, 1], of the expected shapes, and a
     256-ray crop rendered by the kernel path in float32 must agree with
     the plain path (no kernels) within 1e-3; it prints ms/frame on the
     device (CUDA events) and on the host clock;
  4. at the main path's fine-chunk shape (32768 rays x 128 samples, bf16)
     both kernels are held once more against their plain versions, with
     phase 2's bf16 gates and K1's rows checked against its own output;
     then per-kernel times at that shape (CUDA events):
     the kernel, its plain version, and the same function as one chain of
     PyTorch calls under bf16 autocast (cuBLAS; a yardstick only), beside
     the least time the card could take (bound_ms); the kernels again at
     the coarse level's shapes, which with the fine times gives the
     frame's kernel time;
  5. train-kernel parity: K2 (both levels), K3 and K4 against their plain
     versions on the train path's own inputs, float32 at 256 rays (with
     bg_sup 0 and 0.5) and bfloat16 at the main path's 2048 rays, with the
     gates of TRAIN_F32_GATES and TRAIN_BF16_GATES (every gradient leaf,
     each weight and each bias, against its own norm); faults planted in
     the kernels' bf16 results (a bias gradient dropped, one split-K
     chunk's points dropped, K4's addend left out) must each miss those
     gates; one whole float32 step through the kernels against the same
     step on the plain versions (STEP_GATES), printed beside the plain
     step with the camera moved one ulp and the plain step on the CPU;
  6. the main path of training: the flagship Stage-I train step (2048
     rays, 64 + 64, bf16, Adam) through train/stage1.make_train_step, 2
     warm-up and 10 timed steps; the launch counters, set to 0 just before,
     must show K1 = 2, K2 = 2, K3 = 1, K4 = 1, K5 = 0 a step; loss, params
     and sample_prob finite, every param changed, sample_prob summing to 1;
     ms/step on the device and the host clock, rays/s; then per-kernel
     times at the step's shapes beside the plain versions, the library
     yardsticks and the bounds.
Then it prints the `kernels` JSON line, the nvidia-smi name and power
limit, and as the last line {"ok": true, "device": {...}}. With --report
PATH, everything measured is also written to PATH as JSON.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_time(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(a, b) -> float:
    a, b = a.double(), b.double()
    return float(((a - b).abs() / (b.abs() + 1e-3)).max())


def scaled_err(a, b) -> float:
    """max |a - b| / max |b|: relative error against the output's scale."""
    return abs_err(a, b) / max(float(b.abs().max()), 1e-30)


def abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def k1_errors(out_k, out_p, pts) -> dict:
    """K1's bf16 errors per output group, each against its own scale: the
    warp offset (output xyz less the input point) and the ambient part."""
    return {"k1_scaled_warp": scaled_err(out_k[:, :3] - pts, out_p[:, :3] - pts),
            "k1_scaled_ambient": scaled_err(out_k[:, 3:], out_p[:, 3:])}


BF16_GATE = 2e-2   # the bf16 gate of PARITY_TPU.json


# MACs per point of the two kernels, from the flagship layer shapes
def k1_macs(pair) -> int:
    total = 0
    for trunk, out in ((pair.warp_trunk, pair.warp_out),
                       (pair.hyper_trunk, pair.hyper_out)):
        total += sum(p["w"].numel() for p in trunk) + out["w"].numel()
    return total


def k5_macs(lw) -> int:
    mats = ([p["w"] for p in lw.trunk] + [lw.feat["w"], lw.alpha["w"],
            lw.dir0_feat, lw.dir0_se] + [p["w"] for p in lw.dir_rest]
            + [lw.rgb["w"]] + [p["w"] for p in lw.seg] + [lw.seg_out["w"]])
    return sum(m.numel() for m in mats)


def frame_rays(ds, idx, device, n=None, offset=0):
    """Rays of frame ``idx`` of the synthetic dataset (first n pixels)."""
    import torch
    from sahs_tpu_torch.ops.rays import get_ray_bundle
    item = ds[idx]
    ro, rd = get_ray_bundle(ds.H, ds.W, torch.as_tensor(item["intrinsics"]).to(device),
                            torch.as_tensor(item["pose"]).to(device))
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    bg = torch.as_tensor(ds.background()).to(device).reshape(-1, 15)
    sl = slice(offset, None if n is None else offset + n)
    return ro[sl].contiguous(), rd[sl].contiguous(), bg[sl].contiguous(), item


def level_inputs(ro, rd, near, far, S, gen, device):
    """z (R, S) as the pipeline makes them: stratified coarse z for S = 64,
    coarse merged with importance samples for S = 128; points o + d z."""
    import torch
    from sahs_tpu_torch.ops.sampling import coarse_z_vals, merge_z_vals, sample_pdf
    R = ro.shape[0]
    nearv = torch.full((R,), near, device=device)
    farv = torch.full((R,), far, device=device)
    zc = coarse_z_vals(nearv, farv, 64, perturb=True,
                       t_rand=torch.rand((R, 64), generator=gen).to(device))
    z = zc
    if S == 128:
        w = torch.rand((R, 62), generator=gen).to(device)
        zs = sample_pdf(0.5 * (zc[:, 1:] + zc[:, :-1]), w, 64,
                        u=torch.rand((R, 64), generator=gen).to(device))
        z = merge_z_vals(zc, zs)
    pts = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3)
    return z.contiguous(), pts.contiguous()


# Phase 5's gates. Every dW and dGrid leaf (each weight and each bias on
# its own, against its own norm; utils/compare.tree_errors) within
# "l2_rel" and at a cosine of at least "cosine" (measured on an H100:
# f32 <= 3.3e-5, bf16 <= 1.1e-4). float32 (256 rays): K2's rgb_map and
# weights within 1e-4 absolute; each point cotangent (gx, gse, g_bg) at
# that cosine, with at most "point_flips" points whose error exceeds 1e-4
# of the largest point's norm (a pre-activation within rounding of a ReLU
# kink flips its derivative there; 0-1 such points in 32,768 measured).
# bfloat16 at the main path's shapes (2048 rays): the outputs within 2e-2
# relative, the point cotangents within "point_l2_rel" (measured <=
# 2.4e-3) and at that cosine.
TRAIN_F32_GATES = {"out_abs": 1e-4, "point_tol": 1e-4, "point_flips": 4,
                   "l2_rel": 1e-3, "cosine": 0.9999}
TRAIN_BF16_GATES = {"out_rel": BF16_GATE, "point_l2_rel": 1e-2,
                    "l2_rel": 2e-3, "cosine": 0.9999}
# One whole float32 step through the kernels against the same step on the
# plain versions: the loss within 1e-5 relative, every parameter's
# gradient leaf within "l2_rel" and at "cosine". Each side rounds K1's
# output its own way, and the points reach the NeRF through a positional
# encoding of frequency up to 2^9, so one rounding step of a point moves a
# ReLU input by ~1e-5 and flips the few that lie that close to 0: moving
# the camera one ulp moves the plain step's leaves by up to 4.8e-3.
STEP_GATES = {"loss_rel": 1e-5, "l2_rel": 2e-2, "cosine": 0.9999}


@contextlib.contextmanager
def plain_versions():
    """The fused train path with the plain versions of K1-K4 in place of
    the kernels, whatever the device. Raises if a kernel launched inside
    (the swap did not take)."""
    from sahs_tpu_torch.ops.kernels import deform_pair as k1
    from sahs_tpu_torch.ops.kernels import grid_bwd as k4
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.train import fused
    swaps = [(fused, "deform_pair_forward", k1.deform_pair_plain),
             (fused, "deform_pair_vjp", k1.deform_pair_vjp_plain),
             (fused, "grid_dg", k4.grid_dg_plain),
             (k2, "nerf_level_train", k2.nerf_level_train_plain)]
    counters = (k1.deform_pair_forward, k1.deform_pair_vjp, k4.grid_dg,
                k2.nerf_level_train)
    before = [f.launches for f in counters]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    if [f.launches for f in counters] != before:
        raise RuntimeError("a kernel launched on the plain versions' path")


def train_level_inputs(model, ds, near, far, dev, R, compute_dtype, gen,
                       bg_sup):
    """The inputs the fused train path gives K2 (both levels), K3 and K4,
    built with the plain versions from R random pixels of frame 0, as
    train/fused.py builds them. Returns a dict of per-level argument tuples
    and the K3 / K4 arguments."""
    import torch
    from sahs_tpu_torch.models import nerface
    from sahs_tpu_torch.ops.kernels import deform_pair as k1
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.ops.kernels.field_grid import corner_table
    from sahs_tpu_torch.ops.kernels.nerf_level import prepare_level
    from sahs_tpu_torch.ops.rays import get_rays_at
    from sahs_tpu_torch.ops.sampling import coarse_z_vals, sample_pdf
    from sahs_tpu_torch.train.fused import ray_loss_weights
    spec = model.spec
    item = ds[0]
    H, W = ds.H, ds.W
    idx = torch.randperm(H * W, generator=gen)[:R].to(dev)
    ro, rd = get_rays_at(idx, H, W, torch.as_tensor(item["intrinsics"]).to(dev),
                         torch.as_tensor(item["pose"]).to(dev))
    img = torch.as_tensor(item["image"]).to(dev).reshape(-1, 3)[idx]
    mask = torch.as_tensor(item["mask"]).to(dev).reshape(-1, 12)[idx]
    bg = torch.as_tensor(ds.background()).to(dev).reshape(-1, 15)[idx]
    tgt = torch.cat([img, mask], dim=-1)
    lw = ray_loss_weights(mask, 0.02, 0.005)
    warp_g, pts_g, dir_g = nerface.build_pe_groups(spec)
    with torch.no_grad():
        driving = nerface.compute_driving(model, torch.as_tensor(item["driving"]).to(dev))
        pose_enc = nerface.encode_pose(torch.as_tensor(item["pose"]).to(dev))
    pair = k1.prepare_pair(model.warp, model.hyper, torch.cat([driving, pose_enc]), warp_g)
    grid = model.spatial_embeddings.detach()
    dims = tuple(grid.shape[1:])
    table = corner_table(grid, compute_dtype)
    rnd = lambda *shape: torch.rand(shape, generator=gen).to(dev)
    nrm = lambda *shape: 0.1 * torch.randn(shape, generator=gen).to(dev)
    z_c = coarse_z_vals(torch.full((R,), near, device=dev),
                        torch.full((R,), far, device=dev), 64,
                        perturb=True, t_rand=rnd(R, 64))
    pts = lambda z: (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3)
    out = {"table": table, "dims": dims, "pair": pair}
    levels = {}
    for name, z, sup in (("coarse", z_c, 0.0), ("fine", None, bg_sup)):
        if z is None:
            w_c = levels["coarse"]["plain"][1]
            z_new = sample_pdf(0.5 * (z_c[:, 1:] + z_c[:, :-1]), w_c[:, 1:-1], 64,
                               u=rnd(R, 64))
            z = torch.sort(torch.cat([z_c, z_new], -1), dim=-1, stable=True).values
        p = pts(z)
        packed, rows = k1.deform_pair_plain(p, pair, compute_dtype, z.shape[1], dims)
        lvl = prepare_level(getattr(model, name), pose_enc, pts_g, dir_g)
        args = (packed, rd, table, rows, z, bg, nrm(*z.shape), tgt, lw, lvl,
                compute_dtype, dims, sup)
        levels[name] = {"args": args, "pts": p, "plain": k2.nerf_level_train_plain(*args)}
    Sc, Sf = 64, 128
    pos_c = (torch.arange(Sc, device=dev)[None, :]
             + torch.sum(z_new[:, None, :] < z_c[:, :, None], dim=-1))
    slot = (torch.arange(R, device=dev)[:, None] * Sf + pos_c).reshape(-1)
    gx_c, gse_c = levels["coarse"]["plain"][2:4]
    gx_f, gse_f = levels["fine"]["plain"][2:4]
    gx_add = torch.zeros_like(gx_f).index_add_(0, slot, gx_c)
    gse_add = torch.zeros_like(gse_f).index_add_(0, slot, gse_c)
    out["levels"] = levels
    out["k3"] = (levels["fine"]["pts"], pair, gx_f, gx_add, compute_dtype)
    fine_args = levels["fine"]["args"]
    out["k4"] = (fine_args[0], fine_args[3], gse_f, gse_add, tuple(grid.shape))
    out["bg_sup"] = bg_sup
    return out


def train_kernel_parity(inp, compute_dtype):
    """K2 at both levels, K3 and K4 against their plain versions on the
    same inputs. Returns the measured errors and the kernels' dW trees
    (and raises nothing)."""
    import torch
    from sahs_tpu_torch.ops.kernels import deform_pair as k1
    from sahs_tpu_torch.ops.kernels import grid_bwd as k4
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.utils.compare import leaves, point_errors, tree_errors
    res, trees = {}, {}
    tol = TRAIN_F32_GATES["point_tol"]
    for name, lv in inp["levels"].items():
        rgb_k, w_k, gx_k, gse_k, gbg_k, g_k = k2.nerf_level_train(*lv["args"])
        trees[f"k2_{name}"] = g_k
        rgb_p, w_p, gx_p, gse_p, gbg_p, g_p = lv["plain"]
        e = tree_errors(g_k, g_p)
        res[f"k2_{name}"] = {
            "rgb_abs": abs_err(rgb_k, rgb_p), "w_abs": abs_err(w_k, w_p),
            "rgb_rel": rel_err(rgb_k, rgb_p), "w_rel": rel_err(w_k, w_p),
            "gx": point_errors(gx_k, gx_p, tol), "gse": point_errors(gse_k, gse_p, tol),
            "gbg": point_errors(gbg_k, gbg_p, tol), "dw_l2_rel": e["l2_rel"],
            "max_abs_err": max(abs_err(rgb_k, rgb_p), abs_err(w_k, w_p)),
            "dw_cosine": e["cosine"], "dw_worst_leaf": e["worst_leaf"],
            "finite": bool(all(torch.isfinite(t).all() for t in
                               (rgb_k, w_k, gx_k, gse_k, gbg_k)))}
    worst_abs = lambda a, b: max(abs_err(x, y) for (_, x), (_, y)
                                 in zip(leaves(a), leaves(b)))
    g_k, g_p = k1.deform_pair_vjp(*inp["k3"]), k1.deform_pair_vjp_plain(*inp["k3"])
    trees["k3"] = g_k
    e = tree_errors(g_k, g_p)
    res["k3"] = {"dw_l2_rel": e["l2_rel"], "dw_cosine": e["cosine"],
                 "dw_worst_leaf": e["worst_leaf"], "max_abs_err": worst_abs(g_k, g_p)}
    g_k, g_p = k4.grid_dg(*inp["k4"]), k4.grid_dg_plain(*inp["k4"])
    e = tree_errors(g_k, g_p)
    res["k4"] = {"dw_l2_rel": e["l2_rel"], "dw_cosine": e["cosine"],
                 "max_abs_err": abs_err(g_k, g_p)}
    torch.cuda.synchronize()
    return res, trees


def dw_ok(e: dict, g: dict) -> bool:
    """A dW / dGrid tree's worst leaf within the gates ``g``."""
    return e["l2_rel"] <= g["l2_rel"] and e["cosine"] >= g["cosine"]


def train_gates_missed(res, compute_dtype) -> list:
    """The phase-5 gates (TRAIN_F32_GATES, TRAIN_BF16_GATES) that ``res``
    misses, by kernel."""
    missed = []
    f32 = compute_dtype == "float32"
    g = TRAIN_F32_GATES if f32 else TRAIN_BF16_GATES
    for name, r in res.items():
        if name.startswith("k2"):
            out_ok = (max(r["rgb_abs"], r["w_abs"]) <= g["out_abs"] if f32
                      else max(r["rgb_rel"], r["w_rel"]) <= g["out_rel"])
            points_ok = all(
                r[q]["cosine"] >= g["cosine"]
                and (r[q]["n_over"] <= g["point_flips"] if f32
                     else r[q]["l2_rel"] <= g["point_l2_rel"])
                for q in ("gx", "gse", "gbg"))
            if not (r["finite"] and out_ok and points_ok):
                missed.append(name)
        if not dw_ok({"l2_rel": r["dw_l2_rel"], "cosine": r["dw_cosine"]}, g):
            missed.append(name + " dW")
    return missed


def _tree_sub(a, b):
    if isinstance(a, dict):
        return {k: _tree_sub(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return [_tree_sub(x, y) for x, y in zip(a, b)]
    return a - b


def _drop_bias(tree, path):
    """A copy of ``tree`` with the bias gradient at ``path`` zeroed."""
    if not path:
        return {**tree, "b": tree["b"] * 0}
    head, rest = path[0], path[1:]
    if isinstance(tree, list):
        return [_drop_bias(v, rest) if i == head else v for i, v in enumerate(tree)]
    return {k: _drop_bias(v, rest) if k == head else v for k, v in tree.items()}


def planted_faults(inp, trees) -> dict:
    """What the dW gates see in the kernels' own results with a fault
    planted: one bias gradient dropped (K2 fine, K3); the points of one
    split-K chunk dropped (K2 fine, K3: the plain version's dW over those
    points taken off); the coarse-in-fine addend left out (K4). Every
    planted fault must miss the gates."""
    from sahs_tpu_torch.ops.kernels import deform_pair as k1
    from sahs_tpu_torch.ops.kernels import grid_bwd as k4
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.ops.kernels.field_mlp import dw_chunks
    from sahs_tpu_torch.utils.compare import tree_errors

    def chunk_points(P, tile):
        n_tiles = -(-P // tile)
        return -(-n_tiles // dw_chunks(n_tiles)) * tile

    out = {}
    lv = inp["levels"]["fine"]
    args, g_p = lv["args"], lv["plain"][5]
    g_k = trees["k2_fine"]
    out["k2_fine bias trunk[1]"] = tree_errors(_drop_bias(g_k, ["trunk", 1]), g_p)
    S = args[4].shape[1]
    n = chunk_points(args[0].shape[0], k2.TP) // S
    cut = lambda t: None if t is None else t[:n]
    sub = (args[0][:n * S], args[1][:n], args[2], args[3][:n], args[4][:n],
           cut(args[5]), cut(args[6]), args[7][:n], args[8][:n]) + tuple(args[9:])
    g_c = k2.nerf_level_train_plain(*sub)[5]
    out[f"k2_fine chunk 0 ({n} rays)"] = tree_errors(_tree_sub(g_k, g_c), g_p)
    pts, pair, g, g2, cdt = inp["k3"]
    g_p3 = k1.deform_pair_vjp_plain(*inp["k3"])
    out["k3 bias warp.trunk[2]"] = tree_errors(
        _drop_bias(trees["k3"], ["warp", "trunk", 2]), g_p3)
    m = chunk_points(pts.shape[0], k1.TP_BWD)
    g_c = k1.deform_pair_vjp_plain(pts[:m], pair, g[:m], g2[:m], cdt)
    out[f"k3 chunk 0 ({m} points)"] = tree_errors(_tree_sub(trees["k3"], g_c), g_p3)
    packed, rows, gse, gse2, shape = inp["k4"]
    out["k4 without the addend"] = tree_errors(
        k4.grid_dg(packed, rows, gse, None, shape),
        k4.grid_dg_plain(packed, rows, gse, gse2, shape))
    return out


def level_train_macs(lw) -> int:
    """Multiply-adds a point of K2: forward, backward chain, dW."""
    return 3 * k5_macs(lw)


def pair_vjp_macs(pair) -> int:
    """Multiply-adds a point of K3: the forward, the backward chain (no
    product back to the PE: need_gx is off) and dW."""
    fwd = k1_macs(pair)
    to_pe = 0
    for trunk, skip in ((pair.warp_trunk, pair.warp_skip),
                        (pair.hyper_trunk, pair.hyper_skip)):
        hid = trunk[0]["w"].shape[1]
        to_pe += trunk[0]["w"].numel() + trunk[skip]["w"][hid:].numel()
    return 3 * fwd - to_pe


def bound(flops, nbytes):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def main(argv) -> int:
    report_path = argv[argv.index("--report") + 1] if "--report" in argv else None
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    try:
        from sahs_tpu_torch.config import Config
        from sahs_tpu_torch.data.synthetic import SyntheticFaceDataset
        from sahs_tpu_torch.evaluation import make_eval_renderer
        from sahs_tpu_torch.models import nerface
        from sahs_tpu_torch.ops.grid import _cell_geometry, pack_corner_table
        from sahs_tpu_torch.ops.kernels import _build
        from sahs_tpu_torch.ops.kernels import deform_pair as k1
        from sahs_tpu_torch.ops.kernels import nerf_level as k5
        from sahs_tpu_torch.render.pipeline import RenderSettings, render_rays
    except ImportError as e:
        return fail(f"the sahs_tpu_torch package is not beside this script ({e})")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    report = {"device": torch.cuda.get_device_name(0),
              "nvidia_smi": nvidia_smi_line()}
    print(f"device: {report['device']} | {report['nvidia_smi']} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 1. build --------------------------------------------------------------
    t0 = time.time()
    _build.build_all()
    report["build_s"] = time.time() - t0
    print(f"kernel build: {report['build_s']:.1f} s", flush=True)
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    cfg = Config()
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    spec = nerface.ModelSpec.from_config(cfg)
    model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
    H = W = 512
    ds = SyntheticFaceDataset(kind="audio", num_frames=1, H=H, W=W,
                              near=near, far=far)
    warp_g, pts_g, dir_g = nerface.build_pe_groups(spec)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        driving = nerface.compute_driving(model, torch.as_tensor(ds[0]["driving"]).to(dev))
        pose_enc = nerface.encode_pose(torch.as_tensor(ds[0]["pose"]).to(dev))
    cond = torch.cat([driving, pose_enc])
    pair = k1.prepare_pair(model.warp, model.hyper, cond, warp_g)
    lw = k5.prepare_level(model.coarse, pose_enc, pts_g, dir_g)
    grid = model.spatial_embeddings.detach()
    dims = tuple(grid.shape[1:])

    # 2. kernel parity --------------------------------------------------------
    R_par = 2048
    ro, rd, bgr, _ = frame_rays(ds, 0, dev, n=R_par, offset=(H * W - R_par) // 2)
    parity = []
    for compute_dtype in ("float32", "bfloat16"):
        tdt = torch.float32 if compute_dtype == "float32" else torch.bfloat16
        table = pack_corner_table(grid, dtype=tdt)
        for S, noise_std in ((64, 0.0), (128, 0.0), (64, 0.5)):
            z, pts = level_inputs(ro, rd, near, far, S, gen, dev)
            noise = (torch.randn((R_par, S), generator=gen) * noise_std).to(dev) \
                if noise_std > 0 else None
            out_k, rows_k = k1.deform_pair_forward(pts, pair, compute_dtype, S, dims)
            out_p, rows_p = k1.deform_pair_plain(pts, pair, compute_dtype, S, dims)
            rgb_k, w_k = k5.nerf_level_forward(out_p, rd, table, rows_p, z, bgr,
                                               noise, lw, compute_dtype, dims)
            rgb_p, w_p = k5.nerf_level_plain(out_p, rd, table, rows_p, z, bgr,
                                             noise, lw, compute_dtype, dims)
            torch.cuda.synchronize()
            row = {"dtype": compute_dtype, "S": S, "noise": noise_std,
                   "k1_abs": abs_err(out_k, out_p), **k1_errors(out_k, out_p, pts),
                   "k1_rows_mismatch": int((rows_k != rows_p).sum()),
                   "k1_rows_self_mismatch": int(
                       (rows_k.reshape(-1).long()
                        != _cell_geometry(out_k[:, :3], dims)[0]).sum()),
                   "k5_rgb_abs": abs_err(rgb_k, rgb_p), "k5_rgb_rel": rel_err(rgb_k, rgb_p),
                   "k5_w_abs": abs_err(w_k, w_p), "k5_w_rel": rel_err(w_k, w_p),
                   "finite": bool(torch.isfinite(out_k).all() and torch.isfinite(rgb_k).all()
                                  and torch.isfinite(w_k).all())}
            parity.append(row)
            print("parity " + json.dumps(row), flush=True)
            if not row["finite"]:
                return fail(f"non-finite kernel output {row}")
            if row["k1_rows_self_mismatch"]:
                return fail(f"K1 rows differ from the cell of its own output: {row}")
            if compute_dtype == "float32":
                if max(row["k1_abs"], row["k5_rgb_abs"], row["k5_w_abs"]) > 1e-4 \
                        or row["k1_rows_mismatch"]:
                    return fail(f"float32 parity gate (1e-4 abs, exact rows) missed: {row}")
            elif max(row["k1_scaled_warp"], row["k1_scaled_ambient"],
                     row["k5_rgb_rel"], row["k5_w_rel"]) > BF16_GATE:
                return fail(f"bf16 parity gate ({BF16_GATE} rel) missed: {row}")
    report["parity"] = parity

    # 3. main path ------------------------------------------------------------
    settings = RenderSettings.from_config(cfg, "validation")
    assert settings.use_pallas and settings.compute_dtype == "bfloat16"
    render = make_eval_renderer(spec, settings, H, W, near, far, device=dev)
    item = ds[0]
    args = (model, item["intrinsics"], item["pose"], item["driving"], ds.background())
    render(*args, generator=torch.Generator(device=dev).manual_seed(1))  # warm-up
    torch.cuda.synchronize()
    k1.deform_pair_forward.launches = 0
    k5.nerf_level_forward.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t_host = time.time()
    start.record()
    out = render(*args, generator=torch.Generator(device=dev).manual_seed(2))
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.time() - t_host) * 1e3
    frame_ms = start.elapsed_time(end)
    launches = {"deform_pair": k1.deform_pair_forward.launches,
                "nerf_level": k5.nerf_level_forward.launches}
    chunk = min(settings.chunksize, 32768)
    n_chunks = math.ceil(H * W / chunk)
    rgb, w = out["rgb_fine"], out["weights"]
    checks = {
        "launches": launches == {"deform_pair": 2 * n_chunks, "nerf_level": 2 * n_chunks},
        "shapes": tuple(rgb.shape) == (H, W, 15) and tuple(w.shape) == (H * W, 128)
                  and tuple(out["disp_fine"].shape) == (H, W),
        "finite": bool(torch.isfinite(rgb).all() and torch.isfinite(w).all()
                       and torch.isfinite(out["rgb_coarse"]).all()),
        "range": bool(rgb.min() >= -1e-6 and rgb.max() <= 1 + 1e-5),
    }
    # a 256-ray crop: kernel path (f32) vs the plain path, deterministic
    ro_c, rd_c, bg_c, _ = frame_rays(ds, 0, dev, n=256, offset=(H * W) // 2)
    crop = {}
    for use_kernels in (True, False):
        s = RenderSettings(num_coarse=64, num_fine=64, perturb=False,
                           use_pallas=use_kernels, compute_dtype="float32")
        crop[use_kernels] = render_rays(
            model, s, ro_c, rd_c, near, far,
            torch.as_tensor(item["driving"]).to(dev),
            torch.as_tensor(item["pose"]).to(dev), background_prior=bg_c)
    crop_err = abs_err(crop[True].rgb_fine, crop[False].rgb_fine)
    checks["crop_vs_plain_path"] = crop_err <= 1e-3
    rays_s = H * W / (frame_ms / 1e3)
    report["frame"] = {"H": H, "W": W, "samples": "64+64", "chunk": chunk,
                       "n_chunks": n_chunks, "ms": frame_ms, "host_ms": host_ms,
                       "rays_per_s": rays_s, "launches": launches,
                       "crop_max_abs_err_vs_plain_path": crop_err,
                       "acc_mean": float(out["acc_fine"].mean()), "checks": checks}
    print(f"frame {H}x{W}: {frame_ms:.1f} ms/frame (CUDA events), "
          f"{host_ms:.1f} ms/frame (host clock), "
          f"{rays_s:,.0f} rays/s, launches {launches} over {n_chunks} chunks, "
          f"crop kernel-vs-plain-path max abs err {crop_err:.2e}", flush=True)
    if not all(checks.values()):
        return fail(f"main-path checks failed: {checks}")

    # 4. kernel times at the main path's fine-chunk shapes --------------------
    R_t = min(chunk, H * W)
    S_t = 128
    ro_t, rd_t, bg_t, _ = frame_rays(ds, 0, dev, n=R_t)
    z_t, pts_t = level_inputs(ro_t, rd_t, near, far, S_t, gen, dev)
    table_bf = pack_corner_table(grid, dtype=torch.bfloat16)
    P = R_t * S_t
    reps = 3
    f_k1 = lambda: k1.deform_pair_forward(pts_t, pair, "bfloat16", S_t, dims)
    f_k1p = lambda: k1.deform_pair_plain(pts_t, pair, "bfloat16", S_t, dims)
    packed_t, rows_t = f_k1p()
    f_k5 = lambda: k5.nerf_level_forward(packed_t, rd_t, table_bf, rows_t, z_t,
                                         bg_t, None, lw, "bfloat16", dims)
    f_k5p = lambda: k5.nerf_level_plain(packed_t, rd_t, table_bf, rows_t, z_t,
                                        bg_t, None, lw, "bfloat16", dims)

    def library(fn):
        def run():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                return fn()
        return run

    # the coarse level's shapes (64 samples), for the frame's breakdown
    z_c, pts_c = level_inputs(ro_t, rd_t, near, far, 64, gen, dev)
    packed_c, rows_c = k1.deform_pair_plain(pts_c, pair, "bfloat16", 64, dims)
    f_k1c = lambda: k1.deform_pair_forward(pts_c, pair, "bfloat16", 64, dims)
    f_k5c = lambda: k5.nerf_level_forward(packed_c, rd_t, table_bf, rows_c, z_c,
                                          bg_t, None, lw, "bfloat16", dims)

    # parity at the fine-chunk shape the main path launches
    out_k1, rows_k1 = f_k1()
    rgb_k5, w_k5 = f_k5()
    rgb_p5, w_p5 = f_k5p()
    fine = {"k1_abs": abs_err(out_k1, packed_t), **k1_errors(out_k1, packed_t, pts_t),
            "k1_rows_self_mismatch": int(
                (rows_k1.reshape(-1).long()
                 != _cell_geometry(out_k1[:, :3], dims)[0]).sum()),
            "k5_rgb_abs": abs_err(rgb_k5, rgb_p5), "k5_rgb_rel": rel_err(rgb_k5, rgb_p5),
            "k5_w_abs": abs_err(w_k5, w_p5), "k5_w_rel": rel_err(w_k5, w_p5),
            "finite": bool(torch.isfinite(out_k1).all() and torch.isfinite(rgb_k5).all()
                           and torch.isfinite(w_k5).all())}
    report["parity_fine_chunk"] = fine
    print(f"parity at the fine chunk ({R_t} rays x {S_t}, bfloat16) "
          + json.dumps(fine), flush=True)
    if not fine["finite"] or fine["k1_rows_self_mismatch"] or max(
            fine["k1_scaled_warp"], fine["k1_scaled_ambient"],
            fine["k5_rgb_rel"], fine["k5_w_rel"]) > BF16_GATE:
        return fail(f"bf16 parity gate ({BF16_GATE} rel, rows of K1's own "
                    f"output) missed at the fine chunk: {fine}")
    err_k1 = fine["k1_abs"]
    err_k5 = max(fine["k5_rgb_abs"], fine["k5_w_abs"])
    del out_k1, rows_k1, rgb_k5, w_k5, rgb_p5, w_p5
    kernels = []
    for name, src, replaces, fk, fp, fc, macs, in_bytes, out_bytes, err in (
            ("deform_pair", "sahs_tpu_torch/csrc/deform_pair.cu",
             "sahs_tpu/ops/pallas/field_mlp.py:868", f_k1, f_k1p, f_k1c,
             k1_macs(pair) * P, P * 3 * 4, P * (5 + 1) * 4, err_k1),
            ("nerf_level", "sahs_tpu_torch/csrc/nerf_level.cu",
             "sahs_tpu/ops/pallas/field_mlp.py:2681", f_k5, f_k5p, f_k5c,
             k5_macs(lw) * P + lw.dir0_dir.numel() * R_t,
             P * (5 + 1) * 4 + R_t * (3 + S_t + 15) * 4 + table_bf.numel() * 2,
             R_t * (16 + S_t) * 4, err_k5)):
        ms = cuda_time(fk, reps)
        coarse_ms = cuda_time(fc, reps)
        plain_ms = cuda_time(fp, 1)
        library_ms = cuda_time(library(fp), 1)
        flops = 2 * macs
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "coarse_ms": coarse_ms,
            "shape": {"rays": R_t, "samples": S_t, "points": P,
                      "dtype": "bfloat16", "gflop": flops / 1e9},
            "tflops_achieved": flops / (ms / 1e3) / 1e12})
        print(f"{name}: {ms:.2f} ms at {P} points (bound {max(t_ops, t_bytes):.2f} ms, "
              f"plain {plain_ms:.2f} ms, library {library_ms:.2f} ms); "
              f"{coarse_ms:.2f} ms at the coarse level's {R_t * 64} points", flush=True)
    report["kernels"] = kernels
    # the frame's kernel time: each chunk runs both kernels at both levels
    kernel_ms = n_chunks * sum(k["ms"] + k["coarse_ms"] for k in kernels)
    report["frame"]["kernel_ms"] = kernel_ms
    print(f"frame breakdown: K1 + K5 {kernel_ms:.1f} ms of {frame_ms:.1f} ms "
          f"({n_chunks} chunks x 2 levels, times above)", flush=True)

    del packed_t, rows_t, z_t, pts_t, z_c, pts_c, packed_c, rows_c, out, crop
    torch.cuda.empty_cache()

    # 5. train-kernel parity ------------------------------------------------
    from sahs_tpu_torch.ops.kernels import grid_bwd as k4
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.ops.kernels.nerf_level import composite_plain
    from sahs_tpu_torch.ops.kernels.field_mlp import kernel_pe
    from sahs_tpu_torch.train import stage1
    from sahs_tpu_torch.train.fused import TrainDraws, _level_loss
    from sahs_tpu_torch.utils.compare import tree_errors
    # live sigma for the checks (at raw init most sigma_raw < 0 and the
    # gradients vanish), as the card tests set it
    pmodel = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
    with torch.no_grad():
        for lvl in (pmodel.coarse, pmodel.fine):
            lvl.fc_alpha.bias.fill_(0.5)
    train_parity, missed = [], []
    step_inp = None
    for compute_dtype, R_p, sup in (("float32", 256, 0.0), ("float32", 256, 0.5),
                                    ("bfloat16", 2048, 0.0)):
        inp = train_level_inputs(pmodel, ds, near, far, dev, R_p, compute_dtype,
                                 gen, sup)
        res, trees = train_kernel_parity(inp, compute_dtype)
        row = {"dtype": compute_dtype, "rays": R_p, "samples": "64+64",
               "bg_sup": sup, **res}
        train_parity.append(row)
        print("train parity " + json.dumps(row), flush=True)
        missed += [f"{m} ({compute_dtype}, {R_p} rays, bg_sup {sup})"
                   for m in train_gates_missed(res, compute_dtype)]
        if compute_dtype == "bfloat16":
            step_inp, step_res = inp, res
            faults = planted_faults(inp, trees)
            report["planted_faults"] = faults
            print("planted faults (bf16, main path's shapes; each must miss the "
                  "gates) " + json.dumps(faults), flush=True)
            missed += [f"the gates pass a planted fault: {k}"
                       for k, e in faults.items() if dw_ok(e, TRAIN_BF16_GATES)]
        del trees
    report["train_parity"] = train_parity

    # one whole float32 step (256 rays) through the kernels and on the
    # plain versions, same weights and draws; beside it, what moving the
    # camera one ulp does to the plain step, and the plain step on the CPU
    cfg32 = Config()
    cfg32.nerf.train.num_random_rays = 256
    cfg32.runtime.compute_dtype = "float32"
    ts32 = stage1.TrainSettings.from_config(cfg32)
    g32 = torch.Generator().manual_seed(3)
    draws = TrainDraws(*[t.to(dev) for t in (
        -torch.log(-torch.log(torch.rand(H * W, generator=g32).clamp_min(1e-20))),
        torch.rand((256, 64), generator=g32), torch.rand((256, 64), generator=g32),
        torch.randn((256, 64), generator=g32), torch.randn((256, 128), generator=g32))])
    batch = {k: torch.as_tensor(v).to(dev) for k, v in ds[0].items() if k != "fname"}
    batch["background"] = torch.as_tensor(ds.background()).to(dev)
    shifted = dict(batch, pose=batch["pose"].clone())
    shifted["pose"][:, 3] = torch.nextafter(shifted["pose"][:, 3],
                                            torch.tensor(math.inf, device=dev))

    def whole_step(on, b, plain):
        b = {k: v.to(on) for k, v in b.items()}
        st = stage1.init_train_state(spec, ts32, seed=0, device=on)
        with torch.no_grad():
            for lvl in (st.model.coarse, st.model.fine):
                lvl.fc_alpha.bias.fill_(0.5)
        step32 = stage1.make_train_step(spec, ts32, device=on)
        d = TrainDraws(*[t.to(on) for t in draws])
        with plain_versions() if plain else contextlib.nullcontext():
            st, m = step32(st, b, draws=d)
        return float(m["loss"]), {n: p.grad.detach().cpu()
                                  for n, p in st.model.named_parameters()}

    whole = {"kernels": whole_step(dev, batch, False),
             "plain": whole_step(dev, batch, True),
             "plain, camera one ulp over": whole_step(dev, shifted, True),
             "plain on the CPU": whole_step(torch.device("cpu"), batch, True)}
    ref = whole["plain"][1]
    step_check = {"loss_kernels": whole["kernels"][0], "loss_plain": whole["plain"][0],
                  "loss_rel": abs(whole["kernels"][0] - whole["plain"][0])
                  / abs(whole["plain"][0]),
                  "kernels_vs_plain": tree_errors(whole["kernels"][1], ref),
                  "plain_one_ulp_vs_plain": tree_errors(
                      whole["plain, camera one ulp over"][1], ref),
                  "plain_cpu_vs_plain_card": tree_errors(
                      whole["plain on the CPU"][1], ref)}
    report["train_step_f32_vs_plain"] = step_check
    print("train step f32 (256 rays), every gradient leaf against the plain "
          "step on the card " + json.dumps(step_check), flush=True)
    if (step_check["loss_rel"] > STEP_GATES["loss_rel"]
            or not dw_ok(step_check["kernels_vs_plain"], STEP_GATES)):
        missed.append(f"f32 train step, kernels vs plain versions: {step_check}")
    if missed:
        return fail(f"train-kernel gates missed: {missed}")
    del whole, ref
    torch.cuda.empty_cache()

    # 6. the main path: the flagship Stage-I train step --------------------
    ts = stage1.TrainSettings.from_config(cfg)
    assert (ts.render.use_pallas and ts.render.compute_dtype == "bfloat16"
            and ts.num_random_rays == 2048 and ts.render.num_coarse == 64
            and ts.render.num_fine == 64 and ts.dynamic_sampling)
    state = stage1.init_train_state(spec, ts, seed=0, device=dev)
    step = stage1.make_train_step(spec, ts, device=dev)
    gen_t = torch.Generator(device=dev).manual_seed(5)
    for _ in range(2):                                    # warm-up
        state, m = step(state, batch, generator=gen_t)
    torch.cuda.synchronize()
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    counters = {"deform_pair": k1.deform_pair_forward, "level_train": k2.nerf_level_train,
                "deform_pair_vjp": k1.deform_pair_vjp, "grid_dg": k4.grid_dg,
                "nerf_level": k5.nerf_level_forward}
    for f in counters.values():
        f.launches = 0
    n_steps = 10
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n_steps + 1)]
    losses = []
    t_host = time.time()
    events[0].record()
    for i in range(n_steps):
        state, m = step(state, batch, generator=gen_t)
        events[i + 1].record()
        losses.append(m["loss"])
    torch.cuda.synchronize()
    host_step_ms = (time.time() - t_host) * 1e3 / n_steps
    step_ms_each = [events[i].elapsed_time(events[i + 1]) for i in range(n_steps)]
    step_ms = sum(step_ms_each) / n_steps
    train_launches = {k: f.launches for k, f in counters.items()}
    per_step = {"deform_pair": 2, "level_train": 2, "deform_pair_vjp": 1,
                "grid_dg": 1, "nerf_level": 0}
    params_finite = all(bool(torch.isfinite(p).all())
                        for p in state.model.parameters())
    changed = sum(int(not torch.equal(before[n], p.detach()))
                  for n, p in state.model.named_parameters())
    sp = state.sample_prob
    tchecks = {
        "launches": train_launches == {k: v * n_steps for k, v in per_step.items()},
        "loss_finite": all(bool(torch.isfinite(l)) for l in losses),
        "params_finite": params_finite,
        "params_changed": changed == len(before),
        "sample_prob": bool(torch.isfinite(sp).all()) and abs(float(sp.sum()) - 1) < 1e-5,
    }
    rays_per_s = ts.num_random_rays / (step_ms / 1e3)
    report["train"] = {"rays": ts.num_random_rays, "samples": "64+64",
                       "dtype": "bfloat16", "steps": n_steps, "ms": step_ms,
                       "ms_each": step_ms_each, "host_ms": host_step_ms,
                       "rays_per_s": rays_per_s, "launches": train_launches,
                       "losses": [float(l) for l in losses],
                       "params_changed": changed, "params": len(before),
                       "sample_prob_sum": float(sp.sum()), "checks": tchecks}
    print(f"train step (flagship, 2048 rays, 64+64, bf16): {step_ms:.1f} ms/step "
          f"(CUDA events), {host_step_ms:.1f} ms/step (host clock), "
          f"{rays_per_s:,.0f} rays/s, launches over {n_steps} steps "
          f"{train_launches}, loss {float(losses[0]):.4f} -> {float(losses[-1]):.4f}",
          flush=True)
    if not all(tchecks.values()):
        return fail(f"train main-path checks failed: {tchecks}")

    # per-kernel times at the train step's shapes (2048 rays, bf16)
    inp = step_inp
    pair_s = inp["pair"]
    R_s = 2048
    lv_c, lv_f = inp["levels"]["coarse"], inp["levels"]["fine"]
    dims_s = inp["dims"]
    driving_s, pose_s = driving.detach(), pose_enc.detach()

    def k2_library(name, lv):
        nerf = getattr(pmodel, name)
        packed_l, rd_l, table_l, rows_l, z_l, bg_l, noise_l, tgt_l, lw_l, wts = lv["args"][:10]
        S_l = z_l.shape[1]
        x = kernel_pe(packed_l, wts.pts_groups).requires_grad_()
        dpe = kernel_pe(rd_l, wts.dir_groups).repeat_interleave(S_l, dim=0)
        _, fs, ok = _cell_geometry(packed_l, dims_s)
        from sahs_tpu_torch.ops.grid import interp_corners
        se = interp_corners(table_l[rows_l.reshape(-1).long()], fs, ok).requires_grad_()
        params = [x, se] + list(nerf.parameters())

        def run():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                raw = nerf(x, dpe, driving=driving_s, pose=pose_s,
                           spatial_embedding=se)
            rgb_l, _ = composite_plain(raw.float().reshape(R_s, S_l, 16), z_l,
                                       rd_l, bg_l, noise_l)
            return torch.autograd.grad(_level_loss(rgb_l, tgt_l, lw_l), params)
        return run

    def k3_library():
        pts_l, _, g_l, g2_l, _ = inp["k3"]
        pe = kernel_pe(pts_l, pair_s.pe_groups)
        gsum = g_l + g2_l
        params = list(pmodel.warp.parameters()) + list(pmodel.hyper.parameters())

        def run():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                o = torch.cat([pmodel.warp(pe, driving_s, pose_s),
                               pmodel.hyper(pe, driving_s, pose_s)], dim=-1)
            return torch.autograd.grad((o.float() * gsum).sum(), params)
        return run

    def k4_library():
        packed_l, _, gse_l, gse2_l, gshape = inp["k4"]
        g5 = pmodel.spatial_embeddings.detach().clone()[None].requires_grad_()
        coords = packed_l[:, :3].reshape(1, -1, 1, 1, 3)
        o = torch.nn.functional.grid_sample(g5, coords, mode="bilinear",
                                            padding_mode="zeros", align_corners=True)
        gout = (gse_l + gse2_l).t().reshape(o.shape)
        return lambda: torch.autograd.grad(o, g5, gout, retain_graph=True)

    P_c, P_f = R_s * 64, R_s * 128
    lw_f = lv_f["args"][9]
    blob_elems = lambda plan: plan.out_len
    k2_plan = k2.level_train_plan(lw_f, torch.bfloat16)
    k3_plan = k1.pair_train_plan(pair_s, torch.bfloat16)
    k2_bytes = lambda P_l, S_l: (P_l * 6 * 4 + R_s * (3 + 2 * S_l + 32) * 4
                                 + table_bf.numel() * 2 + R_s * (32 + S_l) * 4
                                 + P_l * (5 + 32) * 4 + blob_elems(k2_plan) * 4)
    reps = 5
    train_kernels = {}
    for name, fk, fp, fl, flops, nbytes, err, n_launch in (
            ("level_train", lambda: k2.nerf_level_train(*lv_f["args"]),
             lambda: k2.nerf_level_train_plain(*lv_f["args"]), k2_library("fine", lv_f),
             2 * level_train_macs(lw_f) * P_f, k2_bytes(P_f, 128),
             step_res["k2_fine"]["max_abs_err"], 1),
            ("level_train_coarse", lambda: k2.nerf_level_train(*lv_c["args"]),
             lambda: k2.nerf_level_train_plain(*lv_c["args"]), k2_library("coarse", lv_c),
             2 * level_train_macs(lv_c["args"][9]) * P_c, k2_bytes(P_c, 64),
             step_res["k2_coarse"]["max_abs_err"], 1),
            ("deform_pair_vjp", lambda: k1.deform_pair_vjp(*inp["k3"]),
             lambda: k1.deform_pair_vjp_plain(*inp["k3"]), k3_library(),
             2 * pair_vjp_macs(pair_s) * P_f, P_f * 13 * 4 + blob_elems(k3_plan) * 4,
             step_res["k3"]["max_abs_err"], 1),
            ("grid_dg", lambda: k4.grid_dg(*inp["k4"]),
             lambda: k4.grid_dg_plain(*inp["k4"]), k4_library(),
             2 * 8 * 32 * P_f, P_f * (5 + 1 + 64) * 4 + 32 ** 4 * 4,
             step_res["k4"]["max_abs_err"], 1),
            ("deform_pair_train_fine",
             lambda: k1.deform_pair_forward(lv_f["pts"], pair_s, "bfloat16", 128, dims_s),
             None, None, 2 * k1_macs(pair_s) * P_f, P_f * 9 * 4, None, 1),
            ("deform_pair_train_coarse",
             lambda: k1.deform_pair_forward(lv_c["pts"], pair_s, "bfloat16", 64, dims_s),
             None, None, 2 * k1_macs(pair_s) * P_c, P_c * 9 * 4, None, 1)):
        ms = cuda_time(fk, reps)
        plain = cuda_time(fp, 1) if fp is not None else None
        lib = cuda_time(fl, 1) if fl is not None else None
        b_ms, b_by = bound(flops, nbytes)
        train_kernels[name] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                               "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                               "tflops_achieved": flops / (ms / 1e3) / 1e12}
        print(f"{name}: {ms:.2f} ms at the step's shapes (bound {b_ms:.3f} ms by {b_by}"
              + (f", plain {plain:.2f} ms, library {lib:.2f} ms" if fp else "") + ")",
              flush=True)
    report["train_kernels"] = train_kernels
    tk = train_kernels
    kernel_step_ms = (tk["level_train"]["ms"] + tk["level_train_coarse"]["ms"]
                      + tk["deform_pair_vjp"]["ms"] + tk["grid_dg"]["ms"]
                      + tk["deform_pair_train_fine"]["ms"]
                      + tk["deform_pair_train_coarse"]["ms"])
    report["train"]["kernel_ms"] = kernel_step_ms
    print(f"train step breakdown: K2 {tk['level_train_coarse']['ms']:.1f} + "
          f"{tk['level_train']['ms']:.1f}, K1 {tk['deform_pair_train_coarse']['ms']:.1f} + "
          f"{tk['deform_pair_train_fine']['ms']:.1f}, K3 {tk['deform_pair_vjp']['ms']:.1f}, "
          f"K4 {tk['grid_dg']['ms']:.2f}: kernels {kernel_step_ms:.1f} of "
          f"{step_ms:.1f} ms/step", flush=True)
    for kk in kernels:
        if kk["name"] == "deform_pair":
            kk["launches_by_path"] = {"frame": kk["launches"],
                                      "train": train_launches["deform_pair"]}
            kk["launches"] += train_launches["deform_pair"]
    k2_line = dict(tk["level_train"])
    k2_line["coarse_ms"] = tk["level_train_coarse"]["ms"]
    for name, src, replaces, line in (
            ("level_train", "sahs_tpu_torch/csrc/level_train.cu",
             "sahs_tpu/ops/pallas/level_train.py:55", k2_line),
            ("deform_pair_vjp", "sahs_tpu_torch/csrc/deform_pair_vjp.cu",
             "sahs_tpu/ops/pallas/field_mlp.py:1098", tk["deform_pair_vjp"]),
            ("grid_dg", "sahs_tpu_torch/csrc/grid_bwd.cu",
             "sahs_tpu/ops/pallas/grid_bwd.py:211", tk["grid_dg"])):
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": train_launches[name],
                        **{k: line[k] for k in ("max_abs_err", "ms", "plain_ms",
                                                "bound_ms", "bound_by",
                                                "library_ms")},
                        "coarse_ms": line.get("coarse_ms")})

    if report_path is not None:
        os.makedirs(os.path.dirname(os.path.abspath(report_path)), exist_ok=True)
        with open(report_path, "w") as fp:
            json.dump(report, fp, indent=1)
    print(json.dumps({"kernels": [{k: v for k, v in kk.items()
                                   if k not in ("shape", "tflops_achieved", "coarse_ms",
                                                "launches_by_path")}
                                  for kk in kernels]}))
    print(report["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
