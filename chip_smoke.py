#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                      # build, parity, frame, timings
    python3 chip_smoke.py --report out/r.json  # and the full report as JSON

Phases, in order (any failure exits non-zero and prints no result):
  1. build every CUDA kernel of sahs_tpu_torch/csrc (one nvcc per source,
     in parallel) and print the build time and ptxas' register and spill
     report, each under its kernel's (mangled) name;
  2. kernel parity: K1 (deform pair) and K5 (NeRF level) against their
     plain PyTorch versions on the card, on rays of the synthetic frame at
     S = 64 and 128 samples, with a background prior and with sigma noise,
     in float32 (gate: max abs error <= 1e-4, corner rows exact) and in
     bfloat16, where both run on the tensor cores (K1
     deform_pair_tc_kernel; K5 field_tc_kernel and composite_fwd_kernel),
     against exact sums (tools/level_exact.exact_plain: in each output
     group, each against its own scale, at most EXACT_MULTIPLE times the
     plain version's distance: K5's composited rgb and seg channels and
     its weights, floor LEVEL_FLOOR; K1's warp offset, output xyz less the
     input point, and ambient coordinates, floor SKIP_FLOOR); in both
     types K1's rows must be, bit for bit, the cells of K1's own output
     coordinates; faults planted in what bf16 K1 and K5 read (rows 32-63
     of the warp trunk[1]'s weights left out of K1's blob, the hyper
     head's bias dropped; rows 16-31 of trunk[1]'s and, apart, of the rgb
     head's weights left out of K5's forward blob, the alpha bias
     dropped) must each miss those gates;
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
     both kernels are held once more against exact sums over the whole
     chunk, with phase 2's bf16 gates (the reference run EXACT_RAYS rays at
     a time), against their plain versions at 2e-2 (the bf16 gate of
     PARITY_TPU.json, as before the tensor cores), and K1's rows checked
     against its own output;
     then per-kernel times at that shape (CUDA events):
     the kernel, its plain version, and the same function as one chain of
     PyTorch calls under bf16 autocast (cuBLAS; a yardstick only), beside
     the least time the card could take (bound_ms); the kernels again at
     the coarse level's shapes, which with the fine times gives the
     frame's kernel time; and bf16 K5's device time by launch
     (torch.profiler: field_tc_kernel, composite_fwd_kernel), kept in its
     entry of the kernels line as "launch_ms";
  5. train-kernel parity: K2 (both levels), K3 and K4 against their plain
     versions on the train path's own inputs, float32 at 256 rays (with
     bg_sup 0 and 0.5) and bfloat16 at the main path's 2048 rays, with the
     gates of TRAIN_F32_GATES and TRAIN_BF16_GATES (every gradient leaf,
     each weight and each bias, against its own norm); faults planted in
     the kernels' bf16 results (a bias gradient dropped, one split-K
     chunk's points dropped, rows 16-31 of K3's warp trunk[1] weights
     left out, K4's addend left out) must each miss those gates; bf16 K3
     runs on the tensor cores (csrc/skip_tc.cuh, 64-point tiles) and its
     split-K fault cuts at that tile; one whole float32 step through the
     kernels against the same
     step on the plain versions (STEP_GATES), printed beside the plain
     step with the camera moved one ulp and the plain step on the CPU;
  6. the main path of training: the flagship Stage-I train step (2048
     rays, 64 + 64, bf16, Adam) through train/stage1.make_train_step, 2
     warm-up and 10 timed steps; the launch counters, set to 0 just before,
     must show K15 = 2, K1 = 2, K2 = 2, K3 = 1, K4 = 1, K5 = 0 a step;
     loss, params and sample_prob finite, every param changed, sample_prob
     summing to 1;
     ms/step on the device and the host clock, rays/s; then per-kernel
     times at the step's shapes beside the plain versions, the library
     yardsticks and the bounds, with the TFLOP/s reached and the share of
     the bound (as in phases 8 and 10). In bf16 K2, K3, K6, K8, K12 and
     K14 run their products and dW on the tensor cores (csrc/mma.cuh,
     csrc/skip_tc.cuh, 64-point tiles); the planted split-K faults drop
     the first chunk of that reduction (level_train.TP_BF16-point tiles);
     K4, K9 and K10 run one binned routine of csrc/grid_bwd.cu (no float
     atomics): in phases 5, 7 and 9 a second launch on the same inputs
     must give dG (and K10's dcoords) bit for bit, and phases 6, 8 and 10
     print each one's device time by launch (torch.profiler, "launch_ms"
     in its entry of the kernels line);
  7. fallback-kernel parity: K6 (both levels), K7, K8 and K9 against their
     plain versions on the autograd fallback's own inputs and cotangents,
     float32 at 256 rays (bg_sup 0 and 0.5) and bfloat16 at the main path's
     2048 rays, with phase 5's gates; the ablation config's corner rows
     from _cell_geometry on the card checked against the CPU's and against
     K9's in-kernel cells, and its K5 and K6 (15 PE frequencies, 4x256)
     against their plain versions in float32; K5 and K6 again on path 3's
     own inputs (both levels, the loss cotangents with g_w) in float32 at
     256 rays and bfloat16 at 2048, and K5 in bfloat16 at the ablation
     frame's 32,768-ray chunk (64 and 128 samples), with the same gates
     (bf16 K5 against exact sums as in phase 2, and phase 2's three
     faults planted in K5 on path 3's fine level must each miss);
     bf16 K7 runs on the tensor cores (level_train.cu:field_tc_kernel) and
     is also held against exact sums (tools/level_exact.exact_plain: in
     each output group at most EXACT_MULTIPLE times the plain version's
     distance); faults planted in the kernels' bf16
     results (K6's bias gradient dropped, K8's first split-K chunk
     dropped, one corner left out of K9, rows 16-31 of trunk[1]'s and,
     apart, of the rgb head's weights left out of K7's forward blob) must
     each miss them; whole float32
     steps at 256 rays: the fallback with fuse_composite on and off through
     the kernels against the same steps on the plain versions (STEP_GATES,
     launch counts checked), and the fused step against the fallback step
     (FUSED_VS_FALLBACK);
  8. the fallback's paths on the card, each with its launch counters set to
     0 just before and checked just after: (1) the flagship step with
     fused_grads off (K1 = K3 = K5 = K6 = K9 = 2 a step), (2) the same
     with fuse_composite off (K1 = K3 = K7 = K8 = K9 = 2) and its 512x512
     eval render timed on one 32,768-ray chunk (K1 = K7 = 2), (3)
     configs/expression/person_1_ablation.yml trained (K5 = K6 = K9 = 2,
     no K1 or K3) and a 512x512 frame rendered through make_eval_renderer
     (K5 only); 2 warm-up and 5 timed steps each; then K6-K9's times at
     the paths' shapes beside their plain versions, library yardsticks and
     bounds;
  9. per-point kernel parity: K10 (the grid sample's backward), K11 (the
     per-point field) and K12 (its backward) against their plain versions
     on the per-point branch's own inputs (the fine level of a 64 + 128
     step: 192 samples a ray, which the level kernels do not tile) and
     the cotangents its loss sends back, float32 at 256 rays and bfloat16
     at 2048, with phase 7's gates and K10_GATES; bf16 K11 runs on the
     tensor cores (field_tc_kernel), is held against exact sums as K7, and
     on 24 points fewer (a ragged last tile) must write nothing past its
     last point (a NaN guard, which must see a launch told the tile's end
     as P); faults planted in the
     kernels' bf16 results (K11 without a bias, rows 16-31 of trunk[1]'s
     and, apart, of the rgb head's weights left out of K11's forward
     blob, K12's bias gradient
     dropped, K12's first split-K chunk dropped, one corner left out of
     K10) must each miss them; whole float32 steps at 256 rays through the
     kernels against the same steps on the plain versions (STEP_GATES,
     launch counts checked): the per-point step (64 + 128) and the plain
     path's step (use_pallas off);
 10. the new paths on the card, launch counters set to 0 just before each
     and checked just after: (1) a 512x512 flagship frame at 64 + 128
     through make_eval_renderer (K1 = 2, K5 = 1, K11 = 1 a chunk), (2) the
     flagship step at 2048 rays, 64 + 128, bf16 (K1 = K3 = 2, K5 = K6 =
     K9 = K10 = K11 = K12 = 1 a step), (3) the use_pallas=False step at
     2048 rays, 64 + 64 (K10 = 2, nothing else); 2 warm-up and 5 timed
     steps each; then K11's time at the frame's fine chunk (32,768 rays x
     192, held against its plain version there too) and K12's and K10's at
     the step's fine level, beside their plain versions, the library
     yardsticks and the bounds;
 11. one-net parity: K13 (one deformation MLP: the warp net of a warp-only
     model, the hyper net of an ambient-only one) and K14 (its backward,
     the raw points' cotangent asked for) against their plain versions on
     those paths' own fine-level inputs and the cotangents their loss
     sends back, float32 at 256 rays (K13 within 1e-4; K14's points'
     cotangent off at no more than 4 points, where a ReLU flips, and with
     those points' cotangent set to zero, its dW under TRAIN_F32_GATES
     and the rest of the points' cotangent within K14_GX_F32) and
     bfloat16 at 2048 (2e-2 of scale; TRAIN_BF16_GATES; bf16 K13, on the
     tensor cores, also within EXACT_MULTIPLE of the plain version's
     distance to exact sums, floor SKIP_FLOOR); K15 bit for bit
     against the expression at both levels of the fused step; faults
     planted (K13 without its head bias and, in bf16, with rows 32-63 of
     trunk[1]'s weights left out of its blob, K14's bias gradient dropped,
     K14's first split-K chunk of 64-point tiles dropped, rows 16-31 of
     trunk[1]'s weights left out of bf16 K14, which runs on the tensor
     cores, one of K15's coordinates one ulp over) must each miss; whole
     float32 steps at 256 rays, kernels
     against plain versions (STEP_GATES, launch counts checked): the
     warp-only, ambient-only and split-conditioning models (phase 5 holds
     the fused step, K15 in it, so);
 12. the one-net paths on the card, launch counters set to 0 just before
     each and checked just after: 512x512 warp-only and ambient-only
     frames (K13 = K5 = 2 a chunk), their steps at 2048 rays, 64 + 64,
     bf16 (K13 = K14 = K5 = K6 = K9 = 2 a step), and the flagship fused
     step (K1 = K2 = K15 = 2, K3 = K4 = 1); then
     K13 at the frame's fine chunk (held against its plain version there),
     K14 at a step's fine level (warp and hyper net, with the TFLOP/s
     reached) and K15 at the fused step's, beside their plain versions,
     the library yardsticks and the bounds; K15 with three readings each
     beside torch.addcmul's: device time (torch.profiler, its "ms"),
     per-call time (CUDA events) and the host's time;
 13. grid-free parity: the flagship with models.coarse.use_spatial_embeddings
     off (view directions, no grid) on the kernel path: K1 without rows,
     K2, K5, K6, K7, K8, K11 and K12 with C = 0, each held against its plain
     version on the arguments its path gives it (recorded around the plain
     versions on one step of the fused path, fallback path 1, the reuse
     path and the per-point step at 64 + 128), float32 at 256 rays and
     bfloat16 at 2048, with the gates of phases 2, 5, 7 and 9 (bf16 K1,
     K5, K7 and K11 also against exact sums); a fault
     planted in each kernel's bf16 result must miss them (K1 with its hyper
     bias at 1; K5, K7, K11 without the alpha bias; K7, K11 with rows
     16-31 of trunk[1]'s and, apart, of the rgb head's weights left out;
     K2, K6, K12's bias
     gradient dropped; K8's first split-K chunk dropped); whole float32
     steps at 256 rays through the kernels against the same steps on the
     plain versions (STEP_GATES, launch counts checked) for the fused and
     the per-point step, and the fused step against the fallback step
     (FUSED_VS_FALLBACK);
 14. the grid-free paths on the card, launch counters set to 0 just before
     each and checked just after, K4 = K9 = K10 = 0: a 512x512 frame at
     64 + 64 (K1 = K5 = 2 a chunk), the fused step (2 warm-up + 10 timed;
     K1 = K2 = K15 = 2, K3 = 1), fallback path 1 (K1 = K3 = K5 = K6 = 2),
     the reuse path (K1 = K3 = K7 = K8 = 2) and the per-point step at
     64 + 128 (K1 = K3 = 2, K5 = K6 = K11 = K12 = 1), 2 warm-up and 3 timed
     steps each, each printed beside the flagship's reading of this run;
     then each grid-free kernel per call at 2048 rays beside its plain
     version;
 15. the tools' experiment kernels X1-X6 (X1 and X4-X6 on wgmma and TMA,
     csrc/wgmma.cuh): both tools' main()
     (sahs_tpu_torch/tools/exp_gather.py and exp_pair2.py: every case at
     262,144 rows), with the X counters set to 0 just before and read just
     after; every case's kernel against its plain version on the card
     (TOOL_GATES: X2 and X3 to float32 summation order, X1's row sums
     within 1e-3 L2-relative and 1e-2 of the largest, X4-X6 within 1e-3
     and 5e-2 absolute), a fault planted in each (one layer short, every
     index moved by one, the last layer's weights transposed) missing
     them, and every case's ms beside its bound, its plain version and a
     library call (a cuBLAS bf16 chain, torch.gather on the tiled view,
     indexing of the (N, L) table, tanh chains); X2 runs its TMA ring
     (csrc/exp_gather.cu:dg_kernel) and each case prints its share of the
     bound;
 16. the Stage-I trainer's entry point at the flagship Config() on
     synthetic 512x512 frames: cli.train_stage1.main with 4 steps a launch
     of train/stage1.make_multi_train_step to iteration 9 (a validation
     frame at 8, a checkpoint at 9), launch counters zeroed just before
     and checked just after (K1 = 34, K2 = K15 = 18, K3 = K4 = 9, K5 = 16);
     its metrics.jsonl keys; the checkpoint restored into a fresh state
     equal to the run's final state (every parameter and Adam moment, bit
     for bit) and a resumed run to iteration 10; 4 steps of the multi-step loop
     against 4 single train_step calls fed the same draws, bit for bit;
     ms a step through the multi-step loop (K = 8) and through single steps, in
     turns (CUDA events and the host clock);
 17. what a user runs after Stage-I training, on phase 16's checkpoint:
     cli.eval_stage1.main over a synthetic audio dataset's 3 val frames at
     512x512 (written by write_synthetic_dataset to build/phase17/) with
     every output switched on, launch counters zeroed just before and
     checked just after (K1 = K5 = 16 a frame), every file there, one
     frame's rgb file byte for byte make_eval_renderer's written the same
     way; Stage II through its CLIs (train_stage2 one epoch, its
     checkpoint restored bit for bit, a resume, eval_stage2 writing every
     refined frame), the trained generator's float32 forward on the card
     against the CPU's (GEN_CPU_GATE), metrics.two_folders with LPIPS from
     a random-weight .pth (card against CPU within LPIPS_CPU_GATE) and a
     finite metrics.txt, all under torch's default precision settings
     (cuDNN's TF32 allowed: the entry points set float32); it prints the
     eval CLI's s a frame and the render's device ms, the generator's ms
     per inference and per train step, and SSIM's and LPIPS's ms a frame.
Then it prints the `kernels` JSON line, the nvidia-smi name and power
limit, and as the last line {"ok": true, "device": {...}}. With --report
PATH, everything measured is also written to PATH as JSON.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, float32
# outside the tensor cores, and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def cuda_time(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up, CUDA events:
    the port's timer, ``utils.device.cuda_ms``."""
    from sahs_tpu_torch.utils.device import cuda_ms
    return cuda_ms(fn, reps)


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
# The fused step against the fallback step, both through the kernels,
# float32, every leaf. The two scatter a coarse point's gradient
# differently (one merged fine pass against a pass per level) but run the
# same forward, so they differ only in the order of their sums: measured
# 6.3e-7 on an H100, so 1e-4 (well inside ROADMAP's fused-vs-autograd
# ceiling of 5e-2) still catches a leaf that is 1 % off.
FUSED_VS_FALLBACK = {"l2_rel": 1e-4, "cosine": 0.9999}
# K10 (the grid sample's backward) against its plain version, dG and
# dcoords each L2-relative: both sides round the same values the same way
# and differ only in the order of their float32 sums (atomics).
K10_GATES = {"float32": 1e-5, "bfloat16": 2e-3}
T_START = time.time()


def kernel_counters() -> dict:
    """Every kernel wrapper's launch counter holder, by kernel."""
    from sahs_tpu_torch.ops.kernels import deform_pair as k1
    from sahs_tpu_torch.ops.kernels import grid_bwd as k4
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.ops.kernels import nerf_level as k5
    from sahs_tpu_torch.ops.kernels import nerf_mlp as k11
    from sahs_tpu_torch.ops.kernels import points as k15
    from sahs_tpu_torch.ops.kernels import skip_mlp as k13
    return {"K1": k1.deform_pair_forward, "K2": k2.nerf_level_train,
            "K3": k1.deform_pair_vjp, "K4": k4.grid_dg,
            "K5": k5.nerf_level_forward, "K6": k2.nerf_level_vjp,
            "K7": k5.nerf_rayd_forward, "K8": k2.nerf_rayd_vjp,
            "K9": k4.grid_dg_coords, "K10": k4.grid_bwd_fused,
            "K11": k11.nerf_mlp_forward_fused, "K12": k2.nerf_mlp_vjp,
            "K13": k13.skip_mlp_forward, "K14": k13.skip_mlp_vjp,
            "K15": k15.build_pts, **tool_counters()}


def tool_counters() -> dict:
    """The launch counter holders of the tools' experiment kernels."""
    from sahs_tpu_torch.tools import exp_gather as xg
    from sahs_tpu_torch.tools import exp_pair2 as xp
    return {"X1": xg.chain_rows, "X2": xg.dg_rows, "X3": xg.chunk_rows,
            "X4": xp.narrow_call, "X5": xp.paired_call, "X6": xp.reshape_call}


def fused_swaps():
    """(module, name, plain version) of each kernel of the fused path."""
    from sahs_tpu_torch.ops.kernels import deform_pair as k1
    from sahs_tpu_torch.ops.kernels import grid_bwd as k4
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.ops.kernels import points as k15
    from sahs_tpu_torch.train import fused
    return [(fused, "build_pts", k15.build_pts_plain),
            (fused, "deform_pair_forward", k1.deform_pair_plain),
            (fused, "deform_pair_vjp", k1.deform_pair_vjp_plain),
            (fused, "grid_dg", k4.grid_dg_plain),
            (k2, "nerf_level_train", k2.nerf_level_train_plain)]


def fallback_swaps():
    """(module, name, plain version) of each kernel of the autograd
    fallback (the differentiable pair, the one-net deformation op, the
    grid-coupled level ops, the per-point op and the grid sample's
    backward)."""
    from sahs_tpu_torch.ops.kernels import deform_pair as k1
    from sahs_tpu_torch.ops.kernels import field_grid
    from sahs_tpu_torch.ops.kernels import grid_bwd as k4
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.ops.kernels import nerf_level as k5
    from sahs_tpu_torch.ops.kernels import nerf_mlp as k11
    from sahs_tpu_torch.ops.kernels import skip_mlp as k13
    return [(k1, "deform_pair_forward", k1.deform_pair_plain),
            (k1, "deform_pair_vjp", k1.deform_pair_vjp_plain),
            (k13, "skip_mlp_forward", k13.skip_mlp_plain),
            (k13, "skip_mlp_vjp", k13.skip_mlp_vjp_plain),
            (field_grid, "nerf_level_forward", k5.nerf_level_plain),
            (field_grid, "nerf_level_vjp", k2.nerf_level_vjp_plain),
            (field_grid, "nerf_rayd_forward", k5.nerf_raw_plain),
            (field_grid, "nerf_rayd_vjp", k2.nerf_rayd_vjp_plain),
            (field_grid, "grid_dg_coords", k4.grid_dg_coords_plain),
            (field_grid, "nerf_mlp_forward_fused", k11.nerf_mlp_plain),
            (field_grid, "nerf_mlp_vjp", k2.nerf_mlp_vjp_plain),
            (k4, "grid_bwd_fused", k4.grid_bwd_fused_plain)]


@contextlib.contextmanager
def plain_versions(swaps):
    """A train path with the plain versions in place of its kernels
    (``swaps``: fused_swaps() or fallback_swaps()), whatever the device.
    Raises if a kernel launched inside (the swap did not take)."""
    held = list(kernel_counters().values())
    before = [f.launches for f in held]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    if [f.launches for f in held] != before:
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
                 "max_abs_err": abs_err(g_k, g_p),
                 "repeat_equal": bool(torch.equal(g_k, k4.grid_dg(*inp["k4"])))}
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
        if not r.get("repeat_equal", True):
            missed.append(name + " repeat")
        if name.startswith("k2"):
            out_ok = (max(r["rgb_abs"], r["w_abs"]) <= g["out_abs"] if f32
                      else max(r["rgb_rel"], r["w_rel"]) <= g["out_rel"])
            points_ok = all(
                r[q]["cosine"] >= g["cosine"]
                and (r[q]["n_over"] <= g["point_flips"] if f32
                     else r[q]["l2_rel"] <= g["point_l2_rel"])
                for q in ("gx", "gse", "gbg") if q in r)
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


def weight_slice_fault(weights, train_plan, layer: int):
    """A copy of ``weights`` (PairWeights or SkipWeights) whose bf16 train
    plan leaves out rows 16-31 of forward layer ``layer``'s weights: one
    16-row k-step of what the tensor-core products stage (bf16 K3, K14)."""
    import dataclasses
    import torch
    faulty = dataclasses.replace(weights, _blobs={})
    plan = train_plan(faulty, torch.bfloat16)
    w, b, meta = plan.fwd
    w1, k1, _, _, n = meta.reshape(-1, 7)[layer, :5].tolist()
    if k1 < 32:
        raise ValueError(f"layer {layer} has {k1} < 32 rows")
    w = w.clone()
    w[w1 + 16 * n:w1 + 32 * n] = 0
    faulty._blobs[("train", torch.bfloat16)] = dataclasses.replace(plan, fwd=(w, b, meta))
    return faulty


def planted_faults(inp, trees) -> dict:
    """What the dW gates see in the kernels' own results with a fault
    planted: one bias gradient dropped (K2 fine, K3); the points of one
    split-K chunk dropped (K2 fine, K3: the plain version's dW over those
    points taken off; 64-point tiles in bf16); rows 16-31 of the warp
    trunk[1]'s weights left out of K3's forward; the coarse-in-fine addend
    left out (K4). Every planted fault must miss the gates."""
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
    n = chunk_points(args[0].shape[0], k2.TP_BF16) // S
    cut = lambda t: None if t is None else t[:n]
    sub = (args[0][:n * S], args[1][:n], args[2], args[3][:n], args[4][:n],
           cut(args[5]), cut(args[6]), args[7][:n], args[8][:n]) + tuple(args[9:])
    g_c = k2.nerf_level_train_plain(*sub)[5]
    out[f"k2_fine chunk 0 ({n} rays)"] = tree_errors(_tree_sub(g_k, g_c), g_p)
    pts, pair, g, g2, cdt = inp["k3"]
    g_p3 = k1.deform_pair_vjp_plain(*inp["k3"])
    out["k3 bias warp.trunk[2]"] = tree_errors(
        _drop_bias(trees["k3"], ["warp", "trunk", 2]), g_p3)
    m = chunk_points(pts.shape[0], k2.TP_BF16)
    g_c = k1.deform_pair_vjp_plain(pts[:m], pair, g[:m], g2[:m], cdt)
    out[f"k3 chunk 0 ({m} points)"] = tree_errors(_tree_sub(trees["k3"], g_c), g_p3)
    faulty = weight_slice_fault(pair, k1.pair_train_plan, 1)
    out["k3 rows 16-31 of warp.trunk[1] left out"] = tree_errors(
        k1.deform_pair_vjp(pts, faulty, g, g2, cdt), g_p3)
    packed, rows, gse, gse2, shape = inp["k4"]
    out["k4 without the addend"] = tree_errors(
        k4.grid_dg(packed, rows, gse, None, shape),
        k4.grid_dg_plain(packed, rows, gse, gse2, shape))
    return out


def loss_cotangents(rgb, w, tgt, lw, bg, bg_sup):
    """The cotangents of the per-ray Stage-I loss (level_train.py:26-32)
    with respect to rgb (R, >=15) and the weights (R, S): what the
    fallback's loss sends back into a level (bg_sup: the background
    supervision's, on the last weight)."""
    import torch
    g_rgb = torch.cat([lw[:, 0:1] * 2.0 * (rgb[:, :3] - tgt[:, :3]),
                       lw[:, 1:2] * (-tgt[:, 3:15] / (rgb[:, 3:15] + 1e-10)),
                       torch.zeros_like(rgb[:, :1])], dim=-1)
    g_w = torch.zeros_like(w)
    if bg_sup > 0:
        g_w[:, -1] = bg_sup * torch.sum(torch.square(bg[:, :3] - tgt[:, :3]), -1)
    return g_rgb, g_w


def fallback_level_inputs(model, ds, near, far, dev, R, compute_dtype, gen,
                          bg_sup):
    """The inputs the autograd fallback gives K6 (both levels), K7 and K8
    (the fine level of the deformation-reuse path: coarse and importance
    points concatenated, 128 a ray) and K9 (the fine level's points, ray
    by ray, as the fallback hands them over), built with the plain versions
    from R random pixels of frame 0, with the cotangents the fallback's
    loss sends back."""
    import torch
    from sahs_tpu_torch.models import nerface
    from sahs_tpu_torch.ops.kernels import deform_pair as k1
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.ops.kernels import nerf_level as k5
    from sahs_tpu_torch.ops.kernels.field_grid import corner_table
    from sahs_tpu_torch.ops.rays import get_rays_at
    from sahs_tpu_torch.ops.rendering import volume_render_radiance_field
    from sahs_tpu_torch.ops.sampling import coarse_z_vals, sample_pdf
    from sahs_tpu_torch.train.fused import ray_loss_weights
    spec = model.spec
    item = ds[0]
    H, W = ds.H, ds.W
    idx = torch.randperm(H * W, generator=gen)[:R].to(dev)
    ro, rd = get_rays_at(idx, H, W, torch.as_tensor(item["intrinsics"]).to(dev),
                         torch.as_tensor(item["pose"]).to(dev))
    mask = torch.as_tensor(item["mask"]).to(dev).reshape(-1, 12)[idx]
    tgt = torch.cat([torch.as_tensor(item["image"]).to(dev).reshape(-1, 3)[idx],
                     mask], dim=-1)
    bg = torch.as_tensor(ds.background()).to(dev).reshape(-1, 15)[idx]
    lw = ray_loss_weights(mask, 0.02, 0.005)
    warp_g, pts_g, dir_g = nerface.build_pe_groups(spec)
    with torch.no_grad():
        driving = nerface.compute_driving(model, torch.as_tensor(item["driving"]).to(dev))
        pose_enc = nerface.encode_pose(torch.as_tensor(item["pose"]).to(dev))
    pair = k1.prepare_pair(model.warp, model.hyper, torch.cat([driving, pose_enc]),
                           warp_g)
    grid = model.spatial_embeddings.detach()
    dims = tuple(grid.shape[1:])
    table = corner_table(grid, compute_dtype)
    rnd = lambda *shape: torch.rand(shape, generator=gen).to(dev)
    nrm = lambda *shape: 0.1 * torch.randn(shape, generator=gen).to(dev)
    pts = lambda z: (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3)
    z_c = coarse_z_vals(torch.full((R,), near, device=dev),
                        torch.full((R,), far, device=dev), 64, perturb=True,
                        t_rand=rnd(R, 64))
    out = {"dims": dims, "R": R}
    levels, w_c = {}, None
    for name, sup in (("coarse", 0.0), ("fine", bg_sup)):
        lvl = k5.prepare_level(getattr(model, name), pose_enc, pts_g, dir_g)
        if name == "coarse":
            z = z_c
        else:
            z_new = sample_pdf(0.5 * (z_c[:, 1:] + z_c[:, :-1]), w_c[:, 1:-1], 64,
                               u=rnd(R, 64))
            z = torch.sort(torch.cat([z_c, z_new], -1), dim=-1, stable=True).values
        packed, rows = k1.deform_pair_plain(pts(z), pair, compute_dtype, z.shape[1],
                                            dims)
        noise = nrm(*z.shape)
        rgb, w = k5.nerf_level_plain(packed, rd, table, rows, z, bg, noise, lvl,
                                     compute_dtype, dims)
        w_c = w if name == "coarse" else w_c
        g_rgb, g_w = loss_cotangents(rgb, w, tgt, lw, bg, sup)
        args = (packed, rd, table, rows, z, bg, noise, g_rgb, g_w, lvl,
                compute_dtype, dims)
        levels[name] = {"args": args, "plain": k2.nerf_level_vjp_plain(*args),
                        "lvl": lvl, "noise": noise}
    out["k6"] = levels
    fine = levels["fine"]
    S = 128
    out["k9"] = (fine["args"][0], fine["plain"][1], tuple(grid.shape))
    # the reuse path's fine level: [coarse | importance] points, unsorted
    packed_c, rows_c = k1.deform_pair_plain(pts(z_c), pair, compute_dtype, 64, dims)
    packed_n, rows_n = k1.deform_pair_plain(pts(z_new), pair, compute_dtype, 64, dims)
    cat = lambda a, b: torch.cat([a.reshape(R, 64, -1), b.reshape(R, 64, -1)],
                                 1).reshape(R * S, -1)
    packed_f, rows_f = cat(packed_c, packed_n), cat(rows_c, rows_n)
    z_fine, perm = torch.sort(torch.cat([z_c, z_new], -1), dim=-1, stable=True)
    lvl_f = fine["lvl"]
    fwd = (packed_f, rd, table, rows_f, lvl_f, compute_dtype, dims)
    raw_p = k5.nerf_raw_plain(*fwd)
    raw = raw_p.detach().clone().requires_grad_()
    r3 = torch.take_along_dim(raw.reshape(R, S, 16), perm[..., None], dim=1)
    r3 = torch.cat([r3[:, :-1], torch.cat([bg, r3[:, -1:, -1]], -1)[:, None]], 1)
    rend = volume_render_radiance_field(r3, z_fine, rd, radiance_field_noise_std=1.0,
                                        background_prior=bg, noise=fine["noise"])
    g_rgb, g_w = loss_cotangents(rend.rgb.detach(), rend.weights.detach(), tgt,
                                 lw, bg, bg_sup)
    (g_raw,) = torch.autograd.grad([rend.rgb, rend.weights], raw,
                                   [g_rgb[:, :15], g_w])
    out["k7"], out["k7_plain"] = fwd, raw_p
    out["k8"] = fwd[:4] + (g_raw,) + fwd[4:]
    out["k8_plain"] = k2.nerf_rayd_vjp_plain(*out["k8"])
    out["k7_coarse"] = (packed_c, rd, table, rows_c, levels["coarse"]["lvl"],
                        compute_dtype, dims)
    out["k8_coarse"] = out["k7_coarse"][:4] + (
        g_raw.reshape(R, S, 16)[:, :64].reshape(-1, 16),) + out["k7_coarse"][4:]
    return out


def fallback_kernel_parity(inp):
    """K6 at both levels, K7, K8 and K9 against their plain versions on the
    same inputs. Returns the measured errors and the kernels' results."""
    import torch
    from sahs_tpu_torch.ops.kernels import grid_bwd as k4
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.ops.kernels import nerf_level as k5
    from sahs_tpu_torch.utils.compare import leaves, point_errors, tree_errors
    res, outs = {}, {}
    tol = TRAIN_F32_GATES["point_tol"]
    worst_abs = lambda a, b: max(abs_err(x, y) for (_, x), (_, y)
                                 in zip(leaves(a), leaves(b)))
    for name, lv in inp["k6"].items():
        gx_k, gse_k, gbg_k, g_k = k2.nerf_level_vjp(*lv["args"])
        gx_p, gse_p, gbg_p, g_p = lv["plain"]
        outs[f"k6_{name}"] = g_k
        e = tree_errors(g_k, g_p)
        res[f"k6_{name}"] = {
            "gx": point_errors(gx_k, gx_p, tol), "gse": point_errors(gse_k, gse_p, tol),
            "gbg": point_errors(gbg_k, gbg_p, tol), "dw_l2_rel": e["l2_rel"],
            "dw_cosine": e["cosine"], "dw_worst_leaf": e["worst_leaf"],
            "max_abs_err": worst_abs(g_k, g_p),
            "finite": bool(all(torch.isfinite(t).all() for t in (gx_k, gse_k, gbg_k)))}
    raw_k = k5.nerf_rayd_forward(*inp["k7"])
    raw_p = inp["k7_plain"]
    res["k7"] = {"raw_abs": abs_err(raw_k, raw_p), "raw_scaled": field_scaled(raw_k, raw_p),
                 "max_abs_err": abs_err(raw_k, raw_p),
                 "finite": bool(torch.isfinite(raw_k).all())}
    if inp["k7"][5] == "bfloat16":
        res["k7"]["exact"] = field_exact(k5.nerf_raw_plain, inp["k7"], raw_k, raw_p)
    gx_k, gse_k, g_k = k2.nerf_rayd_vjp(*inp["k8"])
    gx_p, gse_p, g_p = inp["k8_plain"]
    outs["k8"] = g_k
    e = tree_errors(g_k, g_p)
    res["k8"] = {"gx": point_errors(gx_k, gx_p, tol), "gse": point_errors(gse_k, gse_p, tol),
                 "dw_l2_rel": e["l2_rel"], "dw_cosine": e["cosine"],
                 "dw_worst_leaf": e["worst_leaf"], "max_abs_err": worst_abs(g_k, g_p),
                 "finite": bool(torch.isfinite(gx_k).all() and torch.isfinite(gse_k).all())}
    dg_k = k4.grid_dg_coords(*inp["k9"])
    dg_p = k4.grid_dg_coords_plain(*inp["k9"])
    outs["k9"] = dg_k
    e = tree_errors(dg_k, dg_p)
    res["k9"] = {"dw_l2_rel": e["l2_rel"], "dw_cosine": e["cosine"],
                 "max_abs_err": abs_err(dg_k, dg_p),
                 "repeat_equal": bool(torch.equal(dg_k, k4.grid_dg_coords(*inp["k9"])))}
    torch.cuda.synchronize()
    return res, outs


def fallback_gates_missed(res, compute_dtype) -> list:
    """The phase-7 gates (TRAIN_F32_GATES, TRAIN_BF16_GATES, as the train
    kernels') that ``res`` misses, by kernel."""
    missed = []
    f32 = compute_dtype == "float32"
    g = TRAIN_F32_GATES if f32 else TRAIN_BF16_GATES
    for name, r in res.items():
        if not r.get("repeat_equal", True):
            missed.append(name + " repeat")
        if name in ("k7", "k11"):
            ok = r["finite"] and (r["raw_abs"] <= g["out_abs"] if f32
                                  else r["raw_scaled"] <= g["out_rel"])
            mask = r.get("mask", {"guard_clean": True, "rows_scaled": 0.0})
            ok = (ok and r.get("exact", {}).get("ok", True) and mask["guard_clean"]
                  and mask["rows_scaled"] <= BF16_GATE)
            if not ok:
                missed.append(name)
            continue
        if name == "k10":
            gate = K10_GATES["float32" if f32 else "bfloat16"]
            if not all(r[q]["l2_rel"] <= gate and r[q]["cosine"] >= g["cosine"]
                       for q in ("dg", "dcoords")):
                missed.append(name)
            continue
        if name.startswith("k5"):
            # bf16 K5 (the tensor cores) by the exact-sum rule (level_exact)
            ok = r["finite"] and (max(r["rgb_abs"], r["w_abs"]) <= g["out_abs"] if f32
                                  else r["exact"]["ok"] and max(r["rgb_rel"], r["w_rel"])
                                  <= g["out_rel"])
            if not ok:
                missed.append(name)
            continue
        points = [q for q in ("gx", "gse", "gbg", "gextra") if q in r]
        points_ok = all(
            r[q]["cosine"] >= g["cosine"]
            and (r[q]["n_over"] <= g["point_flips"] if f32
                 else r[q]["l2_rel"] <= g["point_l2_rel"])
            for q in points)
        if not (r.get("finite", True) and points_ok):
            missed.append(name)
        if not dw_ok({"l2_rel": r["dw_l2_rel"], "cosine": r["dw_cosine"]}, g):
            missed.append(name + " dW")
    return missed


def dg_one_corner(coords, g, grid_shape, corner: int):
    """The plain dGrid of one corner (bits dz, dy, dx) of every point's
    cell: what K9 would leave out if it dropped that corner."""
    import torch
    from sahs_tpu_torch.ops.grid import _cell_geometry
    C, D, H, W = grid_shape
    _, (fx, fy, fz), ok = _cell_geometry(coords[:, :3].float(), (D, H, W))
    dz, dy, dx = (corner >> 2) & 1, (corner >> 1) & 1, corner & 1
    ix = [torch.floor((coords[:, a].float() + 1.0) * 0.5 * (n - 1)).long()
          for a, n in ((0, W), (1, H), (2, D))]
    x, y, z = ix[0] + dx, ix[1] + dy, ix[2] + dz
    w = ((fz if dz else 1.0 - fz) * (fy if dy else 1.0 - fy)
         * (fx if dx else 1.0 - fx) * ok.float())
    inside = (z >= 0) & (z < D) & (y >= 0) & (y < H) & (x >= 0) & (x < W)
    dg = torch.zeros((D * H * W, C), dtype=torch.float32, device=coords.device)
    dg.index_add_(0, ((z * H + y) * W + x)[inside], w[inside, None] * g.float()[inside])
    return dg.reshape(D, H, W, C).permute(3, 0, 1, 2)


def ablation_parity(dev, gen) -> dict:
    """configs/expression/person_1_ablation.yml (no deformation: corner
    rows from _cell_geometry in PyTorch, 15 PE frequencies, a 4x256 trunk)
    on the card, float32, 256 rays x 64 samples of random points, a quarter
    of them on cell faces: the rows on the card equal the rows on the CPU;
    K9, which forms each cell in the kernel, equals K4 fed those rows (the
    in-kernel cell is the row's cell); K5 and K6 against their plain
    versions."""
    import torch
    from sahs_tpu_torch.config import load_config
    from sahs_tpu_torch.models import nerface
    from sahs_tpu_torch.ops.grid import _cell_geometry, pack_corner_table
    from sahs_tpu_torch.ops.kernels import grid_bwd as k4
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.ops.kernels import nerf_level as k5
    from sahs_tpu_torch.utils.compare import point_errors, tree_errors
    cfg = load_config(os.path.join(REPO, "configs", "expression",
                                   "person_1_ablation.yml"))
    spec = nerface.ModelSpec.from_config(cfg)
    model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
    with torch.no_grad():
        model.coarse.fc_alpha.bias.fill_(0.5)
    R, S = 256, 64
    pts = torch.rand((R * S, 3), generator=gen) * 2.1 - 1.05
    faces = torch.randint(0, 32, (R * S // 4, 3), generator=gen).float() * 2.0 / 31.0 - 1.0
    pts[::4] = faces
    dirs = torch.randn((R, 3), generator=gen) * 0.1 + torch.tensor([0.0, 0.0, -1.0])
    z = torch.sort(torch.rand((R, S), generator=gen) * 0.6 + 0.2, dim=-1).values
    bg = torch.rand((R, 15), generator=gen)
    noise = torch.randn((R, S), generator=gen) * 0.1
    g = torch.randn((R * S, 32), generator=gen)
    pts, dirs, z, bg, noise, g = (t.to(dev) for t in (pts, dirs, z, bg, noise, g))
    grid = model.spatial_embeddings.detach()
    dims = tuple(grid.shape[1:])
    rows = _cell_geometry(pts, dims)[0]
    res = {"rows_card_vs_cpu": int((rows.cpu() != _cell_geometry(pts.cpu(), dims)[0]).sum())}
    res["k9_vs_k4_rows"] = tree_errors(k4.grid_dg_coords(pts, g, tuple(grid.shape)),
                                       k4.grid_dg(pts, rows, g, None, tuple(grid.shape)))
    _, pts_g, dir_g = nerface.build_pe_groups(spec)
    driving = torch.randn(76, generator=gen).to(dev) * 0.1
    lvl = k5.prepare_level(model.coarse, driving, pts_g, dir_g)
    table = pack_corner_table(grid)
    args = (pts, dirs, table, rows, z, bg, noise, lvl, "float32", dims)
    rgb_k, w_k = k5.nerf_level_forward(*args)
    rgb_p, w_p = k5.nerf_level_plain(*args)
    res["k5_abs"] = max(abs_err(rgb_k, rgb_p), abs_err(w_k, w_p))
    g_rgb = torch.cat([2.0 * (rgb_p[:, :3] - 0.5) / R, -0.02 / (rgb_p[:, 3:15] + 1e-10) / R,
                       torch.zeros_like(rgb_p[:, :1])], dim=-1)
    vargs = args[:7] + (g_rgb, torch.zeros_like(w_p)) + args[7:]
    gx_k, gse_k, _, dw_k = k2.nerf_level_vjp(*vargs)
    gx_p, gse_p, _, dw_p = k2.nerf_level_vjp_plain(*vargs)
    tol = TRAIN_F32_GATES["point_tol"]
    res.update(gx=point_errors(gx_k, gx_p, tol), gse=point_errors(gse_k, gse_p, tol),
               dw=tree_errors(dw_k, dw_p))
    torch.cuda.synchronize()
    return res


def ablation_level_inputs(dev, gen, R, compute_dtype, bg_sup):
    """Path 3's inputs to K5 and K6, formed as the fallback step forms them
    for configs/expression/person_1_ablation.yml: R random pixels of a
    512x512 synthetic expression frame, the points themselves (PW = 3) with
    corner rows from _cell_geometry, the coarse level (64) and the fine
    level (64 + 64, importance samples from the coarse weights), the loss
    cotangents (g_w from the background supervision on the fine level).
    Sigma is made live (fc_alpha's bias 0.5), as for the other checks."""
    import torch
    from sahs_tpu_torch.config import load_config
    from sahs_tpu_torch.data.synthetic import SyntheticFaceDataset
    from sahs_tpu_torch.models import nerface
    from sahs_tpu_torch.ops.grid import _cell_geometry
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.ops.kernels import nerf_level as k5
    from sahs_tpu_torch.ops.kernels.field_grid import corner_table
    from sahs_tpu_torch.ops.rays import get_rays_at
    from sahs_tpu_torch.ops.sampling import coarse_z_vals, sample_pdf
    from sahs_tpu_torch.train.fused import ray_loss_weights
    cfg = load_config(os.path.join(REPO, "configs", "expression",
                                   "person_1_ablation.yml"))
    spec = nerface.ModelSpec.from_config(cfg)
    assert not nerface.pair_kernel_ok(spec)
    model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
    with torch.no_grad():
        for lvl in (model.coarse, model.fine):
            lvl.fc_alpha.bias.fill_(0.5)
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    ds = SyntheticFaceDataset(kind="expression", num_frames=1, H=512, W=512,
                              near=near, far=far)
    item = ds[0]
    idx = torch.randperm(ds.H * ds.W, generator=gen)[:R].to(dev)
    ro, rd = get_rays_at(idx, ds.H, ds.W, torch.as_tensor(item["intrinsics"]).to(dev),
                         torch.as_tensor(item["pose"]).to(dev))
    mask = torch.as_tensor(item["mask"]).to(dev).reshape(-1, 12)[idx]
    tgt = torch.cat([torch.as_tensor(item["image"]).to(dev).reshape(-1, 3)[idx],
                     mask], dim=-1)
    bg = torch.as_tensor(ds.background()).to(dev).reshape(-1, 15)[idx]
    lw = ray_loss_weights(mask, 0.02, 0.005)
    _, pts_g, dir_g = nerface.build_pe_groups(spec)
    with torch.no_grad():
        driving = nerface.compute_driving(model, torch.as_tensor(item["driving"]).to(dev))
    grid = model.spatial_embeddings.detach()
    dims = tuple(grid.shape[1:])
    table = corner_table(grid, compute_dtype)
    rnd = lambda *shape: torch.rand(shape, generator=gen).to(dev)
    z_c = coarse_z_vals(torch.full((R,), near, device=dev),
                        torch.full((R,), far, device=dev), 64, perturb=True,
                        t_rand=rnd(R, 64))
    levels, w_c = {}, None
    for name, sup in (("coarse", 0.0), ("fine", bg_sup)):
        lvl = k5.prepare_level(getattr(model, name), driving, pts_g, dir_g)
        if name == "coarse":
            z = z_c
        else:
            z_new = sample_pdf(0.5 * (z_c[:, 1:] + z_c[:, :-1]), w_c[:, 1:-1], 64,
                               u=rnd(R, 64))
            z = torch.sort(torch.cat([z_c, z_new], -1), dim=-1, stable=True).values
        pts = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3)
        rows = _cell_geometry(pts, dims)[0].to(torch.int32).reshape(z.shape)
        noise = 0.1 * torch.randn(z.shape, generator=gen).to(dev)
        fwd = (pts, rd, table, rows, z, bg, noise, lvl, compute_dtype, dims)
        rgb, w = k5.nerf_level_plain(*fwd)
        w_c = w if name == "coarse" else w_c
        g_rgb, g_w = loss_cotangents(rgb, w, tgt, lw, bg, sup)
        args = fwd[:7] + (g_rgb, g_w) + fwd[7:]
        levels[name] = {"fwd": fwd, "plain_fwd": (rgb, w), "args": args,
                        "plain": k2.nerf_level_vjp_plain(*args)}
    return levels


def ablation_kernel_parity(levels) -> dict:
    """K5 and K6 at both levels of path 3 against their plain versions, in
    the schema of fallback_kernel_parity (gated by fallback_gates_missed)."""
    import torch
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.ops.kernels import nerf_level as k5
    from sahs_tpu_torch.utils.compare import point_errors, tree_errors
    tol = TRAIN_F32_GATES["point_tol"]
    res = {}
    for name, lv in levels.items():
        rgb_k, w_k = k5.nerf_level_forward(*lv["fwd"])
        rgb_p, w_p = lv["plain_fwd"]
        res[f"k5_{name}"] = {
            "rgb_abs": abs_err(rgb_k, rgb_p), "w_abs": abs_err(w_k, w_p),
            "rgb_rel": rel_err(rgb_k, rgb_p), "w_rel": rel_err(w_k, w_p),
            "finite": bool(torch.isfinite(rgb_k).all() and torch.isfinite(w_k).all())}
        if lv["fwd"][8] == "bfloat16":
            res[f"k5_{name}"]["exact"] = level_exact(lv["fwd"], rgb_k, w_k, rgb_p, w_p)
        gx_k, gse_k, gbg_k, g_k = k2.nerf_level_vjp(*lv["args"])
        gx_p, gse_p, gbg_p, g_p = lv["plain"]
        e = tree_errors(g_k, g_p)
        res[f"k6_{name}"] = {
            "gx": point_errors(gx_k, gx_p, tol), "gse": point_errors(gse_k, gse_p, tol),
            "gbg": point_errors(gbg_k, gbg_p, tol), "dw_l2_rel": e["l2_rel"],
            "dw_cosine": e["cosine"], "dw_worst_leaf": e["worst_leaf"],
            "finite": bool(all(torch.isfinite(t).all() for t in (gx_k, gse_k, gbg_k)))}
    torch.cuda.synchronize()
    return res


def ablation_frame_chunk_parity(dev, gen) -> dict:
    """K5 in bfloat16 at the ablation frame's chunk shapes (32,768 rays x
    64 and x 128 samples, no noise, the background prior) against its plain
    version (max |a - b| / (|b| + 1e-3) over rgb_map and the weights) and
    against exact sums (level_exact, on every ray)."""
    import torch
    from sahs_tpu_torch.config import load_config
    from sahs_tpu_torch.data.synthetic import SyntheticFaceDataset
    from sahs_tpu_torch.models import nerface
    from sahs_tpu_torch.ops.grid import _cell_geometry
    from sahs_tpu_torch.ops.kernels import nerf_level as k5
    from sahs_tpu_torch.ops.kernels.field_grid import corner_table
    cfg = load_config(os.path.join(REPO, "configs", "expression",
                                   "person_1_ablation.yml"))
    spec = nerface.ModelSpec.from_config(cfg)
    model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    ds = SyntheticFaceDataset(kind="expression", num_frames=1, H=512, W=512,
                              near=near, far=far)
    R = min(int(cfg.nerf.validation.chunksize), 32768)
    ro, rd, bg, item = frame_rays(ds, 0, dev, n=R, offset=(ds.H * ds.W - R) // 2)
    _, pts_g, dir_g = nerface.build_pe_groups(spec)
    with torch.no_grad():
        driving = nerface.compute_driving(model, torch.as_tensor(item["driving"]).to(dev))
    grid = model.spatial_embeddings.detach()
    dims = tuple(grid.shape[1:])
    table = corner_table(grid, "bfloat16")
    res = {}
    for name, S in (("coarse", 64), ("fine", 128)):
        lvl = k5.prepare_level(getattr(model, name), driving, pts_g, dir_g)
        z, pts = level_inputs(ro, rd, near, far, S, gen, dev)
        rows = _cell_geometry(pts, dims)[0].to(torch.int32).reshape(z.shape)
        args = (pts, rd, table, rows, z, bg, None, lvl, "bfloat16", dims)
        rgb_k, w_k = k5.nerf_level_forward(*args)
        rgb_p, w_p = k5.nerf_level_plain(*args)
        res[f"k5_{name} ({R} x {S})"] = {
            "rgb_abs": abs_err(rgb_k, rgb_p), "w_abs": abs_err(w_k, w_p),
            "rgb_rel": rel_err(rgb_k, rgb_p), "w_rel": rel_err(w_k, w_p),
            "exact": level_exact(args, rgb_k, w_k, rgb_p, w_p),
            "finite": bool(torch.isfinite(rgb_k).all() and torch.isfinite(w_k).all())}
        del rgb_k, w_k, rgb_p, w_p
    torch.cuda.synchronize()
    return res


def ablation_gates_missed(res) -> list:
    g = TRAIN_F32_GATES
    missed = []
    if res["rows_card_vs_cpu"]:
        missed.append("ablation rows on the card differ from the CPU's")
    if res["k9_vs_k4_rows"]["l2_rel"] > 1e-5:
        missed.append("ablation: K9's in-kernel cells differ from the rows'")
    if res["k5_abs"] > g["out_abs"]:
        missed.append("ablation K5")
    if not (all(res[q]["n_over"] <= g["point_flips"] and res[q]["cosine"] >= g["cosine"]
                for q in ("gx", "gse")) and dw_ok(res["dw"], g)):
        missed.append("ablation K6")
    return missed


def fallback_planted_faults(inp, outs) -> dict:
    """What the dW gates see in the kernels' own results with a fault
    planted: K6's bias gradient of a trunk layer dropped; the points of
    K8's first split-K chunk dropped (the plain dW over them taken off);
    one corner of every point left out of K9's dGrid; rows 16-31 of
    trunk[1]'s weights, and apart from that of the rgb head's, left out of
    the forward blob that the tensor-core K7 reads (field_slice_fault).
    Each must miss."""
    from sahs_tpu_torch.ops.kernels import grid_bwd as k4
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.ops.kernels import nerf_level as k5
    from sahs_tpu_torch.ops.kernels.field_mlp import dw_chunks
    from sahs_tpu_torch.utils.compare import tree_errors
    out = {}
    g_p = inp["k6"]["fine"]["plain"][3]
    out["k6_fine bias trunk[1]"] = tree_errors(_drop_bias(outs["k6_fine"], ["trunk", 1]), g_p)
    args = inp["k8"]
    P, S = args[0].shape[0], args[0].shape[0] // inp["R"]
    n_tiles = -(-P // k2.TP_BF16)
    n = -(-n_tiles // dw_chunks(n_tiles)) * k2.TP_BF16 // S
    sub = (args[0][:n * S], args[1][:n], args[2], args[3][:n * S], args[4][:n * S]) + args[5:]
    g_c = k2.nerf_rayd_vjp_plain(*sub)[2]
    out[f"k8 chunk 0 ({n} rays)"] = tree_errors(_tree_sub(outs["k8"], g_c),
                                                inp["k8_plain"][2])
    coords, g, shape = inp["k9"]
    out["k9 without corner 0"] = tree_errors(
        outs["k9"] - dg_one_corner(coords, g, shape, 0),
        k4.grid_dg_coords_plain(coords, g, shape))
    for layer, what in field_slice_layers(inp["k7"][4]):
        out[f"k7 rows 16-31 of {what} left out"] = field_slice_fault(
            k5.nerf_rayd_forward, k5.nerf_raw_plain, inp["k7"], 4, layer)
    return out


def pointwise_inputs(model, ds, near, far, dev, R, compute_dtype, gen):
    """The per-point branch's inputs at the fine level of a 64 + 128 step
    (192 samples a ray, which the level kernels do not tile), built with
    the plain versions from R random pixels of frame 0, as the fallback
    builds them: K1's packed points, the grid sample's corner rows and
    features (in the compute dtype), the extra input [dir | se], the folded
    fine level, the cotangent g (P, 16) that the loss sends back through
    the plain compositing (background prior, sigma noise), and K12's plain
    se cotangent for K10."""
    import torch
    from sahs_tpu_torch.models import nerface
    from sahs_tpu_torch.ops.grid import _cell_geometry, interp_corners
    from sahs_tpu_torch.ops.kernels import deform_pair as k1
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.ops.kernels import nerf_level as k5
    from sahs_tpu_torch.ops.kernels import nerf_mlp as k11
    from sahs_tpu_torch.ops.kernels.field_grid import corner_table
    from sahs_tpu_torch.ops.rays import get_rays_at
    from sahs_tpu_torch.ops.rendering import volume_render_radiance_field
    from sahs_tpu_torch.ops.sampling import coarse_z_vals, sample_pdf
    from sahs_tpu_torch.train.fused import ray_loss_weights
    item = ds[0]
    idx = torch.randperm(ds.H * ds.W, generator=gen)[:R].to(dev)
    ro, rd = get_rays_at(idx, ds.H, ds.W, torch.as_tensor(item["intrinsics"]).to(dev),
                         torch.as_tensor(item["pose"]).to(dev))
    mask = torch.as_tensor(item["mask"]).to(dev).reshape(-1, 12)[idx]
    tgt = torch.cat([torch.as_tensor(item["image"]).to(dev).reshape(-1, 3)[idx],
                     mask], dim=-1)
    bg = torch.as_tensor(ds.background()).to(dev).reshape(-1, 15)[idx]
    lw = ray_loss_weights(mask, 0.02, 0.005)
    warp_g, pts_g, dir_g = nerface.build_pe_groups(model.spec)
    with torch.no_grad():
        driving = nerface.compute_driving(model, torch.as_tensor(item["driving"]).to(dev))
        pose_enc = nerface.encode_pose(torch.as_tensor(item["pose"]).to(dev))
    pair = k1.prepare_pair(model.warp, model.hyper, torch.cat([driving, pose_enc]),
                           warp_g)
    grid = model.spatial_embeddings.detach()
    dims = tuple(grid.shape[1:])
    rnd = lambda *shape: torch.rand(shape, generator=gen).to(dev)
    z_c = coarse_z_vals(torch.full((R,), near, device=dev),
                        torch.full((R,), far, device=dev), 64, perturb=True,
                        t_rand=rnd(R, 64))
    z_new = sample_pdf(0.5 * (z_c[:, 1:] + z_c[:, :-1]), rnd(R, 62), 128,
                       u=rnd(R, 128))
    z = torch.sort(torch.cat([z_c, z_new], -1), dim=-1, stable=True).values
    S = z.shape[1]
    pts = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3)
    packed, _ = k1.deform_pair_plain(pts, pair, compute_dtype, S, dims)
    rows, fs, ok = _cell_geometry(packed, dims)
    vals = corner_table(grid, compute_dtype)[rows]
    extra = torch.cat([rd.repeat_interleave(S, dim=0), interp_corners(vals, fs, ok)],
                      dim=-1)
    lvl = k5.prepare_level(model.fine, pose_enc, pts_g, dir_g)
    raw_p = k11.nerf_mlp_plain(packed, extra, lvl, compute_dtype)
    raw = raw_p.clone().requires_grad_()
    r3 = raw.reshape(R, S, 16)
    r3 = torch.cat([r3[:, :-1], torch.cat([bg, r3[:, -1:, -1]], -1)[:, None]], 1)
    rend = volume_render_radiance_field(
        r3, z, rd, radiance_field_noise_std=1.0, background_prior=bg,
        noise=0.1 * torch.randn((R, S), generator=gen).to(dev))
    g_rgb, g_w = loss_cotangents(rend.rgb.detach(), rend.weights.detach(), tgt,
                                 lw, bg, 0.5)
    (g,) = torch.autograd.grad([rend.rgb, rend.weights], raw, [g_rgb[:, :15], g_w])
    k12 = (packed, extra, g, lvl, compute_dtype)
    k12_plain = k2.nerf_mlp_vjp_plain(*k12)
    return {"R": R, "S": S, "k11": (packed, extra, lvl, compute_dtype),
            "k11_plain": raw_p, "k12": k12, "k12_plain": k12_plain,
            "k10": ((grid.shape[0],) + dims, packed, k12_plain[1][:, 3:], vals,
                    compute_dtype)}


def pointwise_parity(inp):
    """K11, K12 and K10 against their plain versions on the per-point
    branch's inputs, in the schema of fallback_kernel_parity (gated by
    fallback_gates_missed). Returns the errors and the kernels' results."""
    import torch
    from sahs_tpu_torch.ops.kernels import grid_bwd as k4
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.ops.kernels import nerf_mlp as k11
    from sahs_tpu_torch.utils.compare import leaves, point_errors, tree_errors
    tol = TRAIN_F32_GATES["point_tol"]
    raw_k = k11.nerf_mlp_forward_fused(*inp["k11"])
    raw_p = inp["k11_plain"]
    gx_k, ge_k, g_k = k2.nerf_mlp_vjp(*inp["k12"])
    gx_p, ge_p, g_p = inp["k12_plain"]
    dg_k, dc_k = k4.grid_bwd_fused(*inp["k10"])
    dg_p, dc_p = k4.grid_bwd_fused_plain(*inp["k10"])
    dg_r, dc_r = k4.grid_bwd_fused(*inp["k10"])
    torch.cuda.synchronize()
    e = tree_errors(g_k, g_p)
    k11_res = {"raw_abs": abs_err(raw_k, raw_p), "raw_scaled": field_scaled(raw_k, raw_p),
               "max_abs_err": abs_err(raw_k, raw_p),
               "finite": bool(torch.isfinite(raw_k).all())}
    if inp["k11"][3] == "bfloat16":
        k11_res["exact"] = field_exact(k11.nerf_mlp_plain, inp["k11"], raw_k, raw_p)
        k11_res["mask"] = field_mask_check(*inp["k11"][:3], raw_p)
    res = {"k11": k11_res,
           "k12": {"gx": point_errors(gx_k, gx_p, tol),
                   "gextra": point_errors(ge_k, ge_p, tol),
                   "dw_l2_rel": e["l2_rel"], "dw_cosine": e["cosine"],
                   "dw_worst_leaf": e["worst_leaf"],
                   "max_abs_err": max(abs_err(x, y) for (_, x), (_, y)
                                      in zip(leaves(g_k), leaves(g_p))),
                   "finite": bool(torch.isfinite(gx_k).all() and torch.isfinite(ge_k).all())},
           "k10": {"dg": tree_errors(dg_k, dg_p), "dcoords": tree_errors(dc_k, dc_p),
                   "max_abs_err": max(abs_err(dg_k, dg_p), abs_err(dc_k, dc_p)),
                   "repeat_equal": bool(torch.equal(dg_k, dg_r) and torch.equal(dc_k, dc_r))}}
    return res, {"k11": raw_k, "k12": g_k, "k10": dg_k, "k11_mask": k11_res.get("mask")}


def pointwise_planted_faults(inp, outs) -> dict:
    """What the gates see with a fault planted in the kernels' own bf16
    results: K11 run with the alpha head's bias dropped (its raw field
    against the plain version's, field_scaled) and with rows 16-31 of
    trunk[1]'s weights, and apart from that of the rgb head's, left out of
    its forward blob (field_slice_fault); K11's last tile written past P
    (field_mask_check: the guard rows past P must not read clean); K12's
    bias gradient
    of a trunk layer dropped; the points of K12's first split-K chunk
    dropped (the plain dW over them taken off); one corner of every point
    left out of K10's dG. Each must miss."""
    import dataclasses
    import torch
    from sahs_tpu_torch.ops.kernels import grid_bwd as k4
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.ops.kernels import nerf_mlp as k11
    from sahs_tpu_torch.ops.kernels.field_mlp import dw_chunks
    from sahs_tpu_torch.utils.compare import tree_errors
    out = {}
    packed, extra, lvl, cdt = inp["k11"]
    no_bias = dataclasses.replace(lvl, alpha={"w": lvl.alpha["w"],
                                              "b": torch.zeros_like(lvl.alpha["b"])},
                                  _blobs={})
    out["k11 without the alpha bias"] = {"raw_scaled": field_scaled(
        k11.nerf_mlp_forward_fused(packed, extra, no_bias, cdt), inp["k11_plain"])}
    for layer, what in field_slice_layers(lvl):
        out[f"k11 rows 16-31 of {what} left out"] = field_slice_fault(
            k11.nerf_mlp_forward_fused, k11.nerf_mlp_plain, inp["k11"], 2, layer)
    mask = outs["k11_mask"]
    out[f"k11 last tile stored past P ({mask['points']} points)"] = {
        "guard_clean": mask["fault_guard_clean"]}
    g_p = inp["k12_plain"][2]
    out["k12 bias trunk[1]"] = tree_errors(_drop_bias(outs["k12"], ["trunk", 1]), g_p)
    P = packed.shape[0]
    n_tiles = -(-P // k2.TP_BF16)
    n = -(-n_tiles // dw_chunks(n_tiles)) * k2.TP_BF16
    g = inp["k12"][2]
    g_c = k2.nerf_mlp_vjp_plain(packed[:n], extra[:n], g[:n], lvl, cdt)[2]
    out[f"k12 chunk 0 ({n} points)"] = tree_errors(_tree_sub(outs["k12"], g_c), g_p)
    shape, coords, g_se, _, _ = inp["k10"]
    out["k10 without corner 0"] = tree_errors(
        outs["k10"] - dg_one_corner(coords, g_se, shape, 0),
        k4.grid_bwd_fused_plain(*inp["k10"])[0])
    return out


def fault_passes(e) -> bool:
    """True when a planted fault's reading passes the bf16 gates."""
    if "guard_clean" in e:
        return e["guard_clean"]
    if "raw_scaled" in e or "ok" in e:
        return e.get("raw_scaled", 0.0) <= BF16_GATE and e.get("ok", True)
    return dw_ok(e, TRAIN_BF16_GATES)


# The raw field's output groups [rgb3 | seg12 | sigma1]: K7's and K11's
# gates read each against its own scale, so that a large group (the rgb
# head) does not hide an error in a small one
FIELD_GROUPS = (("rgb", 0, 3), ("seg", 3, 15), ("sigma", 15, 16))

# bf16 K7 and K11 on the tensor cores: in each group a kernel's
# L2-relative distance to exact sums (tools/level_exact.exact_plain: the
# same bf16 operands, float64 sums) at most EXACT_MULTIPLE times the plain
# version's own, or EXACT_MULTIPLE x FIELD_FLOOR where the plain version is
# closer than that. The multiple is the bf16 backwards' rule
# (tests/test_torch_cuda.py:PLAIN_MULTIPLE); their floor of 1e-3 is not:
# the plain forwards sit 4.1e-5-5.0e-5 from exact sums over the whole
# field, so it would pass a kernel 100 times as far, and a kernel that
# leaves 16 rows of trunk[1] out moves the field by ~6 times the plain
# version's distance.
EXACT_MULTIPLE, FIELD_FLOOR = 4.0, 1e-5
# bf16 K13 on the tensor cores keeps the same multiple on its output (P,
# out), with a floor of its own below the plain forward's distance to
# exact sums (as tests/test_torch_cuda.py:SKIP_FLOOR)
SKIP_FLOOR = 1e-5


def field_scaled(a, b) -> float:
    """The worst group (FIELD_GROUPS) of raw (P, 16) ``a`` against ``b``:
    max |a - b| / max |b| within the group."""
    return max(scaled_err(a[:, i:j], b[:, i:j]) for _, i, j in FIELD_GROUPS)


def field_exact(fp, args, raw_k, raw_p) -> dict:
    """A bf16 raw field's L2-relative distances to exact sums, per group:
    the kernel's and the plain version's, and whether the kernel keeps the
    rule in every group."""
    from sahs_tpu_torch.tools.level_exact import exact_plain
    from sahs_tpu_torch.utils.compare import point_errors
    raw_x = exact_plain(fp, *args)
    d_k, d_p = ({g: point_errors(r[:, i:j], raw_x[:, i:j])["l2_rel"]
                 for g, i, j in FIELD_GROUPS} for r in (raw_k, raw_p))
    return {"kernel_vs_exact": d_k, "plain_vs_exact": d_p,
            "ok": all(d_k[g] <= EXACT_MULTIPLE * max(d_p[g], FIELD_FLOOR) for g in d_k)}


# bf16 K5 and K1 on the tensor cores keep the same multiple in each of
# their output groups, each against its own scale (as
# tests/test_torch_cuda.py's _level_exact and _pair_exact): K5's composited
# rgb and seg channels and its weights, with a floor below the plain
# version's distance to exact sums (LEVEL_FLOOR); K1's warp offset (output
# xyz less the input point) and ambient coordinates, with K13's floor (the
# same nets). The reference runs on every ray of a call, EXACT_RAYS rays at
# a time (rays, and K1's points, are independent of each other): a float64
# run of a frame chunk's 4.19 M points at once would hold tens of GB.
LEVEL_FLOOR = 1e-7
EXACT_RAYS = 2048


def _exact_rule(sq, floor) -> dict:
    """The L2-relative distances per group from the sums of squares ``sq``
    ({group: [|k - x|^2, |p - x|^2, |x|^2]}) and whether the kernel keeps
    the rule in every group."""
    d_k = {g: (v[0] / max(v[2], 1e-300)) ** 0.5 for g, v in sq.items()}
    d_p = {g: (v[1] / max(v[2], 1e-300)) ** 0.5 for g, v in sq.items()}
    return {"kernel_vs_exact": d_k, "plain_vs_exact": d_p,
            "ok": all(d_k[g] <= EXACT_MULTIPLE * max(d_p[g], floor) for g in d_k)}


def _add_squares(sq, groups, k, p, x):
    """Adds each group's |k - x|^2, |p - x|^2 and |x|^2 to ``sq``."""
    for g, f in groups.items():
        fx = f(x).double()
        v = sq.setdefault(g, [0.0, 0.0, 0.0])
        v[0] += float((f(k).double() - fx).pow(2).sum())
        v[1] += float((f(p).double() - fx).pow(2).sum())
        v[2] += float(fx.pow(2).sum())


def level_exact(args, rgb_k, w_k, rgb_p, w_p) -> dict:
    """bf16 K5's results (rgb_map, weights) on ``args`` and the plain
    version's, against exact sums on every ray: the L2-relative distances
    per group and whether the kernel keeps the rule in every group."""
    from sahs_tpu_torch.ops.kernels import nerf_level as k5
    from sahs_tpu_torch.tools.level_exact import exact_plain
    pts, dirs, table, rows, z, bg, noise = args[:7]
    R, S = z.shape
    groups = {"rgb": lambda o: o[0][:, :3], "seg": lambda o: o[0][:, 3:15],
              "weights": lambda o: o[1]}
    sq = {}
    for a in range(0, R, EXACT_RAYS):
        b = min(R, a + EXACT_RAYS)
        cut = lambda t: None if t is None else t[a:b]
        sub = (pts[a * S:b * S], dirs[a:b], table,
               None if rows is None else rows.reshape(-1)[a * S:b * S], z[a:b], cut(bg),
               cut(noise)) + tuple(args[7:])
        _add_squares(sq, groups, (rgb_k[a:b], w_k[a:b]), (rgb_p[a:b], w_p[a:b]),
                     exact_plain(k5.nerf_level_plain, *sub))
    return {"rays": R, **_exact_rule(sq, LEVEL_FLOOR)}


def pair_exact(args, out_k, out_p) -> dict:
    """bf16 K1's packed points on ``args`` (points, pair, dtype, samples,
    grid) and the plain version's, against exact sums on every point: the
    L2-relative distances of the warp offset and the ambient coordinates
    and whether the kernel keeps the rule in both."""
    from sahs_tpu_torch.ops.kernels import deform_pair as k1
    from sahs_tpu_torch.tools.level_exact import exact_plain
    pts, pair, dtype, S, dims = args
    P, n = pts.shape[0], EXACT_RAYS * S
    sq = {}
    for a in range(0, P, n):
        b = min(P, a + n)
        x = pts[a:b]
        groups = {"warp": lambda o: o[:, :3].double() - x.double(),
                  "ambient": lambda o: o[:, 3:]}
        _add_squares(sq, groups, out_k[a:b], out_p[a:b],
                     exact_plain(k1.deform_pair_plain, x, pair, dtype, S, dims)[0])
    return {"points": P, **_exact_rule(sq, SKIP_FLOOR)}


def blob_fault(weights, key, layer: int, rows=None):
    """A copy of folded weights whose blob ``weights._blobs[key]`` (built
    by ``weights.blob`` / ``nerf_level.point_blob`` first) leaves out the
    weight rows ``rows`` (a (start, stop) pair) of forward layer ``layer``,
    or drops its bias when ``rows`` is None."""
    import dataclasses
    import torch
    from sahs_tpu_torch.ops.kernels import nerf_level as k5
    faulty = dataclasses.replace(weights, _blobs={})
    w, b, meta = (k5.point_blob(faulty, torch.bfloat16) if key == ("point", torch.bfloat16)
                  else faulty.blob(key))
    w1, k, _, _, n, ob = meta.reshape(-1, 7)[layer, :6].tolist()
    if rows is None:
        if float(b[ob:ob + n].detach().abs().max()) == 0:
            raise ValueError(f"forward layer {layer} has no bias to drop")
        b = b.clone()
        b[ob:ob + n] = 0
    else:
        if k < rows[1]:
            raise ValueError(f"forward layer {layer} has {k} rows, fewer than {rows[1]}")
        w = w.clone()
        w[w1 + rows[0] * n:w1 + rows[1] * n] = 0
    faulty._blobs[key] = (w, b, meta)
    return faulty


def level_planted_faults(args) -> dict:
    """bf16 K5 on ``args`` with a fault planted in the forward blob that it
    reads (``nerf_level.point_blob``): rows 16-31 of trunk[1]'s and, apart,
    of the rgb head's weights left out, the alpha head's bias dropped. Each
    must miss level_exact's rule."""
    import torch
    from sahs_tpu_torch.ops.kernels import nerf_level as k5
    lvl, key = args[7], ("point", torch.bfloat16)
    L = len(lvl.trunk)
    rgb_p, w_p = k5.nerf_level_plain(*args)
    out = {}
    for name, faulty in (
            ("rows 16-31 of trunk[1] left out", blob_fault(lvl, key, 1, (16, 32))),
            ("rows 16-31 of the rgb head left out", blob_fault(lvl, key, L + 6, (16, 32))),
            ("the alpha bias dropped", blob_fault(lvl, key, L + 1))):
        rgb_f, w_f = k5.nerf_level_forward(*args[:7], faulty, *args[8:])
        out[f"k5 {name}"] = level_exact(args, rgb_f, w_f, rgb_p, w_p)
    return out


def pair_planted_faults(args) -> dict:
    """bf16 K1 on ``args`` with a fault planted in the blob that it reads
    (K3's too): rows 32-63 of the warp trunk[1]'s weights left out (one
    32-row slice of what the ring stages), the hyper head's bias dropped.
    Each must miss pair_exact's rule."""
    import torch
    from sahs_tpu_torch.ops.kernels import deform_pair as k1
    pts, pair = args[:2]
    out_p = k1.deform_pair_plain(*args)[0]
    head = len(pair.warp_trunk) + 1 + len(pair.hyper_trunk)
    out = {}
    for name, faulty in (
            ("rows 32-63 of the warp trunk[1] left out",
             blob_fault(pair, torch.bfloat16, 1, (32, 64))),
            ("the hyper head's bias dropped", blob_fault(pair, torch.bfloat16, head))):
        out[f"k1 {name}"] = pair_exact(args, k1.deform_pair_forward(
            pts, faulty, *args[2:])[0], out_p)
    return out


def field_slice_layers(lvl) -> list:
    """(layer index in the forward blob, name) of the layers whose rows
    16-31 field_slice_fault leaves out: trunk[1] and the rgb head."""
    return [(1, "trunk[1]"), (len(lvl.trunk) + 6, "the rgb head")]


def field_slice_fault(fk, fp, args, wi: int, layer: int) -> dict:
    """A bf16 raw field (K7: the level at ``args[wi]`` = 4, K11: 2) run with
    rows 16-31 of forward layer ``layer``'s weights left out of the blob
    that the tensor-core kernel reads (one 16-row K-slice of what the ring
    stages), against the plain version (field_scaled) and against exact
    sums (field_exact's rule)."""
    import torch
    faulty = blob_fault(args[wi], ("point", torch.bfloat16), layer, (16, 32))
    raw_f, raw_p = fk(*(args[:wi] + (faulty,) + args[wi + 1:])), fp(*args)
    return {"raw_scaled": field_scaled(raw_f, raw_p), **field_exact(fp, args, raw_f, raw_p)}


def field_mask_check(pts, extra, lvl, raw_p, cut: int = 24) -> dict:
    """bf16 K11 on P = len(pts) - ``cut`` points, not a multiple of the
    64-point tile, into the first P rows of a NaN buffer: the guard rows
    past P must stay NaN ("guard_clean") and the P rows agree with the
    plain version ``raw_p`` ("rows_scaled", field_scaled). The check's own
    check ("fault_guard_clean", which must be False) is the launch that a
    kernel without its store mask makes: the same kernel told the tile's
    end as P, so that it writes the last tile's rows past P. It shows that
    the guard sees such rows; it plants nothing in the kernel, tests the
    store mask alone, and does not test loads past P (the inputs are views
    of longer tensors)."""
    import torch
    from sahs_tpu_torch.ops.kernels import nerf_level as k5
    from sahs_tpu_torch.ops.kernels import nerf_mlp as k11
    P = pts.shape[0] - cut
    n_pad = -(-P // 64) * 64
    if P % 64 == 0 or n_pad > pts.shape[0]:
        raise ValueError(f"{P} points do not leave a ragged last tile")

    def run(n):
        buf = torch.full((n_pad + 64, 16), float("nan"), device=pts.device)
        ints = k11.point_kernel_args(pts[:n], extra[:n], lvl, "K11")[2]
        k5.nerf_field_tc("K11", pts[:n], lvl, n, 1, ints, extra=extra[:n], out=buf[:n])
        torch.cuda.synchronize()
        return buf
    buf = run(P)
    return {"points": P, "guard_clean": bool(torch.isnan(buf[P:]).all()),
            "rows_scaled": field_scaled(buf[:P], raw_p[:P]),
            "fault_guard_clean": bool(torch.isnan(run(n_pad)[P:]).all())}


def point_mlp_macs(lw) -> int:
    """Multiply-adds a point of K11: K5's, with the direction term per
    point."""
    return k5_macs(lw) + lw.dir0_dir.numel()


def grid_sample_library(model, coords, g):
    """The backward of torch.nn.functional.grid_sample (3-D, align_corners,
    zeros padding) with respect to the grid, at ``coords`` (P, >=3) with
    the cotangent ``g`` (P, C): the library yardstick of K4 and K9."""
    import torch
    g5 = model.spatial_embeddings.detach().clone()[None].requires_grad_()
    o = torch.nn.functional.grid_sample(g5, coords[:, :3].reshape(1, -1, 1, 1, 3),
                                        mode="bilinear", padding_mode="zeros",
                                        align_corners=True)
    gout = g.t().reshape(o.shape)
    return lambda: torch.autograd.grad(o, g5, gout, retain_graph=True)


def grid_launch_ms(fn, counter) -> dict:
    """The device time of one call of a grid backward (K4, K9, K10: one
    binned routine) by CUDA kernel, torch.profiler over 20 calls: where
    its phases spend the call. ``counter``: the wrapper ``fn`` calls."""
    from sahs_tpu_torch.utils.device import device_ms_by_kernel
    return device_ms_by_kernel(fn, launches=20, counter=counter)


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


def bound(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# Phases 11 and 12: the models whose deformation nets run one at a time
# (K13 forward, K14 backward, a net each) and K15, the fused step's positions
# ---------------------------------------------------------------------------

# model -> the flagship Config()'s model fields set for it
ONE_NET = {"warp_only": (("hyper", "use_ambient", False),),
           "ambient_only": (("warp", "use_warp", False),),
           "split": (("hyper", "include_driving", False),)}
# the flagship without the spatial-embedding grid (phases 13 and 14)
GRID_FREE = {"grid_free": (("coarse", "use_spatial_embeddings", False),)}
# K14's points' cotangent in float32 against its plain version, L2-relative
# over the points whose ReLUs did not flip (phase 11's K14 gate beside
# TRAIN_F32_GATES)
K14_GX_F32 = 1e-5
# phase 11's rays a step by compute dtype: float32 at 256, bfloat16 at the
# main path's 2048
SKIP_RAYS = {"float32": 256, "bfloat16": 2048}


def path_cfg(kind, rays=None, compute_dtype=None, num_fine=None, **runtime):
    """The flagship Config() with ``kind``'s model (ONE_NET, GRID_FREE;
    "flagship" keeps the pair and the grid), ``rays`` and ``num_fine``
    samples a step and ``runtime`` settings."""
    from sahs_tpu_torch.config import Config
    cfg = Config()
    for sub, field, value in {**ONE_NET, **GRID_FREE}.get(kind, ()):
        setattr(getattr(cfg.models, sub), field, value)
    if rays is not None:
        cfg.nerf.train.num_random_rays = rays
    if num_fine is not None:
        cfg.nerf.train.num_fine = num_fine
    if compute_dtype is not None:
        cfg.runtime.compute_dtype = compute_dtype
    for k, v in runtime.items():
        setattr(cfg.runtime, k, v)
    return cfg


def make_draws(R, n_pix, seed, dev, Sc=64, Sn=64):
    """A train step's draws for R rays of an n_pix frame, from ``seed``."""
    import torch
    from sahs_tpu_torch.train.fused import TrainDraws
    g = torch.Generator().manual_seed(seed)
    return TrainDraws(*[t.to(dev) for t in (
        -torch.log(-torch.log(torch.rand(n_pix, generator=g).clamp_min(1e-20))),
        torch.rand((R, Sc), generator=g), torch.rand((R, Sn), generator=g),
        torch.randn((R, Sc), generator=g), torch.randn((R, Sc + Sn), generator=g))])


def run_step(dev, batch, draws, cfg, swaps=None):
    """One train step of ``cfg`` (seeded weights, live sigma) on the card,
    its kernels swapped for ``swaps`` when given. Returns (loss, {name:
    grad}, {K: launches})."""
    import torch
    from sahs_tpu_torch.models import nerface
    from sahs_tpu_torch.train import stage1
    spec = nerface.ModelSpec.from_config(cfg)
    ts = stage1.TrainSettings.from_config(cfg)
    st = stage1.init_train_state(spec, ts, seed=0, device=dev)
    with torch.no_grad():
        for lvl in (st.model.coarse, st.model.fine):
            lvl.fc_alpha.bias.fill_(0.5)
    step = stage1.make_train_step(spec, ts, device=dev)
    held = kernel_counters()
    before = {k: f.launches for k, f in held.items()}
    with plain_versions(swaps) if swaps else contextlib.nullcontext():
        st, m = step(st, batch, draws=draws)
    return (float(m["loss"]), {n: p.grad.detach().cpu()
                               for n, p in st.model.named_parameters()},
            {k: f.launches - before[k] for k, f in held.items() if f.launches != before[k]})


def snapshot(x):
    """A copy of a kernel argument that outlives the step: tensors, and the
    folded weights (views of parameters the optimizer changes in place),
    cloned."""
    import dataclasses
    import torch
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, (list, tuple)):
        return type(x)(snapshot(v) for v in x)
    if isinstance(x, dict):
        return {k: snapshot(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: snapshot(getattr(x, f.name))
                                         for f in dataclasses.fields(x)
                                         if f.name != "_blobs"}, _blobs={})
    return x


def recorded(swaps, module, names):
    """``swaps`` with the entries of ``module`` named in ``names`` wrapped to
    keep a snapshot of the arguments of every call, in ``calls[name]``.
    Returns (swaps, calls)."""
    calls = {n: [] for n in names}

    def keep(name, f):
        def run(*a):
            calls[name].append(snapshot(a))
            return f(*a)
        return run
    return [(m, n, keep(n, f) if m is module and n in names else f)
            for m, n, f in swaps], calls


def skip_inputs(dev, batch, kind, R, compute_dtype, n_pix, seed):
    """K13's and K14's arguments at the fine level of one step of ``kind``
    (the largest of the step's calls: 128 samples a ray), as the fallback
    gives them on the plain versions: the raw points, the net's folded
    weights and the cotangent its loss sends back."""
    from sahs_tpu_torch.ops.kernels import skip_mlp as k13
    swaps, calls = recorded(fallback_swaps(), k13,
                            ("skip_mlp_forward", "skip_mlp_vjp"))
    run_step(dev, batch, make_draws(R, n_pix, seed, dev),
             path_cfg(kind, R, compute_dtype), swaps)
    fine = lambda args: max(args, key=lambda a: a[0].shape[0])
    return {"kind": kind, "dtype": compute_dtype,
            "k13": fine(calls["skip_mlp_forward"]),
            "k14": fine(calls["skip_mlp_vjp"])}


def skip_exact(pts, w, y_k, y_p) -> dict:
    """bf16 K13's output and its plain version's, L2-relative from exact
    sums (tools/level_exact.exact_plain), and whether the kernel keeps the
    rule (EXACT_MULTIPLE, SKIP_FLOOR)."""
    from sahs_tpu_torch.ops.kernels import skip_mlp as k13
    from sahs_tpu_torch.tools.level_exact import exact_plain
    from sahs_tpu_torch.utils.compare import point_errors
    y_x = exact_plain(k13.skip_mlp_plain, pts, w, "bfloat16")
    d_k, d_p = (point_errors(y, y_x)["l2_rel"] for y in (y_k, y_p))
    return {"kernel_vs_exact": d_k, "plain_vs_exact": d_p,
            "ok": d_k <= EXACT_MULTIPLE * max(d_p, SKIP_FLOOR)}


def skip_parity(inp):
    """K13 and K14 (dW, and the raw points' cotangent asked for) against
    their plain versions on ``inp``. Returns the errors and the kernels'
    dW tree."""
    import torch
    from sahs_tpu_torch.ops.kernels import skip_mlp as k13
    from sahs_tpu_torch.utils.compare import leaves, point_errors, tree_errors
    pts, w, cdt = inp["k13"]
    y_k, y_p = k13.skip_mlp_forward(pts, w, cdt), k13.skip_mlp_plain(pts, w, cdt)
    k13_exact = skip_exact(pts, w, y_k, y_p) if cdt == "bfloat16" else None
    pts, w, g, _, cdt = inp["k14"]
    gx_k, g_k = k13.skip_mlp_vjp(pts, w, g, True, cdt)
    gx_p, g_p = k13.skip_mlp_vjp_plain(pts, w, g, True, cdt)
    torch.cuda.synchronize()
    e = tree_errors(g_k, g_p)
    tol = TRAIN_F32_GATES["point_tol"]
    res = {"points": pts.shape[0], "net": w.out_act,
           "k13": {"abs": abs_err(y_k, y_p), "scaled": scaled_err(y_k, y_p),
                   "finite": bool(torch.isfinite(y_k).all()),
                   **({"exact": k13_exact} if k13_exact else {})},
           "k14": {"dw_l2_rel": e["l2_rel"], "dw_cosine": e["cosine"],
                   "dw_worst_leaf": e["worst_leaf"],
                   "gx": point_errors(gx_k, gx_p, tol),
                   "max_abs_err": max(abs_err(x, y) for (_, x), (_, y)
                                      in zip(leaves(g_k), leaves(g_p))),
                   "finite": bool(torch.isfinite(gx_k).all())}}
    if cdt == "float32":
        # a point whose pre-activation lies within rounding of a ReLU kink
        # takes the other derivative on one side, and the PE's frequencies
        # to 2^9 make its cotangent, and its share of a small bias's
        # gradient, large: with the cotangent of such points (their
        # cotangents' error over the point gate) set to zero on both sides,
        # the rest must agree to the float32 gates
        err = (gx_k - gx_p).double().norm(dim=1) / gx_p.double().norm(dim=1).max()
        keep = err <= tol
        g0 = g * keep[:, None]
        gx_k0, g_k0 = k13.skip_mlp_vjp(pts, w, g0, True, cdt)
        gx_p0, g_p0 = k13.skip_mlp_vjp_plain(pts, w, g0, True, cdt)
        e0 = tree_errors(g_k0, g_p0)
        res["k14"]["unflipped"] = {
            "dw_l2_rel": e0["l2_rel"], "dw_cosine": e0["cosine"],
            "dw_worst_leaf": e0["worst_leaf"],
            "gx": point_errors(gx_k0[keep], gx_p0[keep], tol)}
    return res, g_k


def skip_gates_missed(res, compute_dtype) -> list:
    """Phase 11's gates that ``res`` misses: K13 within 1e-4 absolute in
    float32 and 2e-2 of its output's scale in bf16, and there within
    EXACT_MULTIPLE of the plain version's distance to exact sums (floor
    SKIP_FLOOR). K14 in float32: at
    most TRAIN_F32_GATES' flips among the points' cotangents, and on the
    points that did not flip the cotangent within K14_GX_F32 and dW under
    TRAIN_F32_GATES; in bf16 the cotangent within the bf16 point gate and
    dW under TRAIN_BF16_GATES; each at the gates' cosine."""
    missed = []
    f32 = compute_dtype == "float32"
    g = TRAIN_F32_GATES if f32 else TRAIN_BF16_GATES
    r13, r14 = res["k13"], res["k14"]
    if not r13["finite"] or (r13["abs"] > g["out_abs"] if f32
                             else r13["scaled"] > g["out_rel"]):
        missed.append("k13")
    if not f32 and not r13["exact"]["ok"]:
        missed.append(f"k13 against exact sums {r13['exact']}")
    gx, dw = r14["gx"], r14
    if f32:
        gx_ok = gx["n_over"] <= g["point_flips"]
        gx, dw = r14["unflipped"]["gx"], r14["unflipped"]
        gx_ok = gx_ok and gx["l2_rel"] <= K14_GX_F32
    else:
        gx_ok = gx["l2_rel"] <= g["point_l2_rel"]
    if not (r14["finite"] and gx_ok and gx["cosine"] >= g["cosine"]):
        missed.append("k14 gx")
    if not dw_ok({"l2_rel": dw["dw_l2_rel"], "cosine": dw["dw_cosine"]}, g):
        missed.append("k14 dW")
    return missed


def skip_planted_faults(inputs, trees, k15_args) -> dict:
    """What the gates see with a fault planted in the kernels' own bf16
    results: K13 run without its head bias and with rows 32-63 of
    trunk[1]'s weights left out of its blob (warp and hyper nets; the plain
    gate and the exact-sum rule); K14's
    bias gradient of trunk[1] dropped; the points of K14's first split-K
    chunk dropped (64-point tiles; the plain dW over them taken off); rows
    16-31 of trunk[1]'s weights left out of K14's forward; one coordinate
    of K15's output moved one ulp. Each must miss."""
    import dataclasses
    import torch
    from sahs_tpu_torch.ops.kernels import points as k15
    from sahs_tpu_torch.ops.kernels import skip_mlp as k13
    from sahs_tpu_torch.ops.kernels.field_mlp import dw_chunks, tile_points
    from sahs_tpu_torch.utils.compare import tree_errors
    out = {}
    tp = tile_points(torch.bfloat16)
    for inp, g_k in zip(inputs, trees):
        pts, w, cdt = inp["k13"]
        no_bias = dataclasses.replace(w, out={"w": w.out["w"],
                                              "b": torch.zeros_like(w.out["b"])},
                                      _blobs={})
        y_p = k13.skip_mlp_plain(pts, w, cdt)
        for name, faulty in (("without the head bias", no_bias),
                             ("rows 32-63 of trunk[1] left out",
                              skip_forward_slice_fault(w))):
            y_f = k13.skip_mlp_forward(pts, faulty, cdt)
            out[f"k13 {inp['kind']} {name}"] = {"raw_scaled": scaled_err(y_f, y_p),
                                                **skip_exact(pts, w, y_f, y_p)}
        pts, w, g, _, cdt = inp["k14"]
        g_p = k13.skip_mlp_vjp_plain(pts, w, g, False, cdt)[1]
        out[f"k14 {inp['kind']} bias trunk[1]"] = tree_errors(
            _drop_bias(g_k, ["trunk", 1]), g_p)
        n_tiles = -(-pts.shape[0] // tp)
        m = -(-n_tiles // dw_chunks(n_tiles)) * tp
        g_c = k13.skip_mlp_vjp_plain(pts[:m], w, g[:m], False, cdt)[1]
        out[f"k14 {inp['kind']} chunk 0 ({m} points)"] = tree_errors(
            _tree_sub(g_k, g_c), g_p)
        faulty = weight_slice_fault(w, k13.skip_train_plan, 1)
        out[f"k14 {inp['kind']} rows 16-31 of trunk[1] left out"] = tree_errors(
            k13.skip_mlp_vjp(pts, faulty, g, False, cdt)[1], g_p)
    moved = k15.build_pts(*k15_args).clone()
    moved[0, 0] = torch.nextafter(moved[0, 0], torch.tensor(math.inf, device=moved.device))
    out["k15 one coordinate one ulp over"] = {
        "max_abs_err": abs_err(moved, k15.build_pts_plain(*k15_args))}
    return out


def skip_forward_slice_fault(w):
    """A copy of folded weights ``w`` whose bf16 blob (bf16 K13's) leaves
    out rows 32-63 of trunk[1]'s weights: one 32-row slice of what the
    tensor-core kernel's ring stages."""
    import dataclasses
    import torch
    faulty = dataclasses.replace(w, _blobs={})
    wb, b, meta = faulty.blob(torch.bfloat16)
    w1, k, _, _, n = meta.reshape(-1, 7)[1, :5].tolist()
    if k < 64:
        raise ValueError(f"trunk[1] has {k} rows, fewer than 64")
    wb = wb.clone()
    wb[w1 + 32 * n:w1 + 64 * n] = 0
    faulty._blobs[torch.bfloat16] = (wb, b, meta)
    return faulty


def skip_fault_passes(e) -> bool:
    """True when a planted fault's reading passes phase 11's bf16 gates
    (K15's: bit for bit)."""
    if "max_abs_err" in e:
        return e["max_abs_err"] == 0.0
    return fault_passes(e)


def fused_pts_args(dev, batch, R, compute_dtype, n_pix, seed):
    """The arguments K15 gets at both levels of one fused step (flagship),
    recorded around the kernel's wrapper."""
    from sahs_tpu_torch.train import fused
    held, calls = fused.build_pts, []
    fused.build_pts = lambda *a: calls.append(a) or held(*a)
    try:
        run_step(dev, batch, make_draws(R, n_pix, seed, dev),
                 path_cfg("flagship", R, compute_dtype))
    finally:
        fused.build_pts = held
    return calls


def phase11_skip_parity(dev, batch, n_pix, report) -> list:
    """Phase 11. Returns the gates missed and keeps, in ``report``, what it
    measured; the bf16 inputs stay in report["_skip_bf16"] for phase 12."""
    from sahs_tpu_torch.ops.kernels import points as k15
    from sahs_tpu_torch.utils.compare import tree_errors
    missed, rows, bf16 = [], [], []
    trees = []
    for compute_dtype, R in SKIP_RAYS.items():
        for kind in ("warp_only", "ambient_only"):
            inp = skip_inputs(dev, batch, kind, R, compute_dtype, n_pix, 21)
            res, g_k = skip_parity(inp)
            rows.append({"model": kind, "dtype": compute_dtype, "rays": R,
                         "samples": "64+64 (fine level, 128)", **res})
            print("one-net parity " + json.dumps(rows[-1]), flush=True)
            missed += [f"{m} ({kind}, {compute_dtype}, {R} rays)"
                       for m in skip_gates_missed(res, compute_dtype)]
            if compute_dtype == "bfloat16":
                bf16.append(inp)
                trees.append(g_k)
                inp["max_abs_err"] = {"k13": res["k13"]["abs"],
                                      "k14": res["k14"]["max_abs_err"]}
    report["skip_parity"] = rows
    # K15 at both levels of the fused step, bit for bit
    k15_rows = []
    for compute_dtype, R in SKIP_RAYS.items():
        for a in fused_pts_args(dev, batch, R, compute_dtype, n_pix, 22):
            err = abs_err(k15.build_pts(*a), k15.build_pts_plain(*a))
            k15_rows.append({"dtype": compute_dtype, "rays": R,
                             "samples": a[2].shape[1], "max_abs_err": err})
    report["k15_parity"] = k15_rows
    print("K15 parity (both levels of the fused step) " + json.dumps(k15_rows),
          flush=True)
    missed += [f"k15 {r}" for r in k15_rows if r["max_abs_err"] != 0.0]
    k15_args = a
    faults = skip_planted_faults(bf16, trees, k15_args)
    report["skip_planted_faults"] = faults
    print("one-net planted faults (bf16, the steps' shapes; each must miss the "
          "gates) " + json.dumps(faults), flush=True)
    missed += [f"the gates pass a planted fault: {k}"
               for k, e in faults.items() if skip_fault_passes(e)]
    # whole float32 steps (256 rays): each one-net model through the kernels
    # against the same step on the plain versions (the fused step, K15
    # included, is held so in phase 5)
    steps = {}
    R = SKIP_RAYS["float32"]
    draws = make_draws(R, n_pix, 3, dev)
    for kind in ONE_NET:
        cfg = path_cfg(kind, R, "float32")
        steps[kind] = (run_step(dev, batch, draws, cfg),
                       run_step(dev, batch, draws, cfg, fallback_swaps()))
    want = {"warp_only": {"K13": 2, "K14": 2, "K5": 2, "K6": 2, "K9": 2},
            "ambient_only": {"K13": 2, "K14": 2, "K5": 2, "K6": 2, "K9": 2},
            "split": {"K13": 4, "K14": 4, "K5": 2, "K6": 2, "K9": 2}}
    check = {}
    for name, (k_, p_) in steps.items():
        check[name] = {"launches": k_[2], "loss_rel": abs(k_[0] - p_[0]) / abs(p_[0]),
                       "kernels_vs_plain": tree_errors(k_[1], p_[1])}
        e = check[name]["kernels_vs_plain"]
        if check[name]["loss_rel"] > STEP_GATES["loss_rel"] or not dw_ok(e, STEP_GATES):
            missed.append(f"f32 {name} step: {check[name]}")
        if k_[2] != want[name]:
            missed.append(f"f32 {name} step launched {k_[2]}, not {want[name]}")
    report["skip_steps_f32"] = check
    print("one-net steps f32 (256 rays), every gradient leaf against the "
          "plain step on the card " + json.dumps(check), flush=True)
    report["_skip_bf16"] = (bf16, k15_args)
    return missed


def skip_macs(w) -> int:
    """Multiply-adds a point of K13 (the folded trunk, skip layer's pe rows
    included, and the head)."""
    return sum(p["w"].numel() for p in w.trunk) + w.out["w"].numel()


def skip_vjp_macs(w) -> int:
    """Multiply-adds a point of K14 without the points' cotangent: the
    forward, the backward chain (no product back to the PE) and dW."""
    hid = w.trunk[0]["w"].shape[1]
    return 3 * skip_macs(w) - w.trunk[0]["w"].numel() - w.trunk[w.skip]["w"][hid:].numel()


def phase12_skip_paths(dev, ds, near, far, time_path, time_frame, report,
                       kernels) -> str:
    """Phase 12. Times the one-net frames and steps and the fused step, K15
    on it (launch counters zeroed before each run and checked after it),
    then K13, K14 and K15 per call; appends their entries to ``kernels``
    and adds the paths' launches of the earlier kernels to theirs. Returns
    a failure message, or "" when every check passes."""
    import torch
    from sahs_tpu_torch.evaluation import make_eval_renderer
    from sahs_tpu_torch.models import nerface
    from sahs_tpu_torch.ops.kernels import points as k15
    from sahs_tpu_torch.ops.kernels import skip_mlp as k13
    from sahs_tpu_torch.ops.kernels.field_mlp import kernel_pe
    from sahs_tpu_torch.render.pipeline import RenderSettings
    from sahs_tpu_torch.tools.level_ab import k15_readings
    H, W = ds.H, ds.W
    item = ds[0]
    paths, frame_models = {}, {}
    for kind in ("warp_only", "ambient_only"):
        cfg = path_cfg(kind)
        spec = nerface.ModelSpec.from_config(cfg)
        s = RenderSettings.from_config(cfg, "validation")
        render = make_eval_renderer(spec, s, H, W, near, far, device=dev)
        model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
        frame_models[kind] = model
        n = math.ceil(H * W / min(s.chunksize, 32768))
        paths[f"{kind} frame"] = time_frame(
            lambda: render(model, item["intrinsics"], item["pose"], item["driving"],
                           ds.background()), {"K13": 2 * n, "K5": 2 * n})
        paths[f"{kind} step"] = time_path(cfg, ds, {"K13": 2, "K14": 2, "K5": 2,
                                                    "K6": 2, "K9": 2})
    paths["fused step"] = time_path(path_cfg("flagship"), ds,
                                    {"K1": 2, "K2": 2, "K3": 1, "K4": 1, "K15": 2})
    report["skip_paths"] = paths
    for name, r in paths.items():
        print(f"path {name}: {r['ms']:.1f} ms on the card (CUDA events), "
              f"{r['host_ms']:.1f} ms on the host clock, launches "
              f"{r.get('launches_per_step', r.get('launches'))}"
              + (" per step" if "launches_per_step" in r else ""), flush=True)
    bad = {n: r["checks"] for n, r in paths.items() if not all(r["checks"].values())}
    if bad:
        return f"one-net path checks failed: {bad}"

    # K13 in bf16 at the frame's fine chunk (32,768 rays x 128), held
    # against its plain version there, then timed beside it, the library
    # yardstick and the bound; K14 at a step's fine level (2048 x 128) from
    # phase 11's inputs; K15 at the fused step's fine level
    bf16, k15_args = report.pop("_skip_bf16")
    gen = torch.Generator().manual_seed(23)
    R_f = 32768
    ro_f, rd_f, _, _ = frame_rays(ds, 0, dev, n=R_f)
    _, pts_f = level_inputs(ro_f, rd_f, near, far, 128, gen, dev)
    P_f = pts_f.shape[0]
    warp_g = nerface.build_pe_groups(frame_models["warp_only"].spec)[0]
    with torch.no_grad():
        driving = nerface.compute_driving(frame_models["warp_only"],
                                          torch.as_tensor(item["driving"]).to(dev))
        pose_enc = nerface.encode_pose(torch.as_tensor(item["pose"]).to(dev))

    def module_library(net, pts, g=None):
        """The net's own forward on the plain PE under bf16 autocast, and
        with ``g`` autograd of it (a yardstick the port never calls)."""
        pe = kernel_pe(pts, warp_g)
        params = list(net.parameters())

        def run():
            with torch.set_grad_enabled(g is not None), \
                    torch.autocast("cuda", dtype=torch.bfloat16):
                o = net(pe, driving, pose_enc)
            return o if g is None else torch.autograd.grad((o.float() * g).sum(), params)
        return run

    rows = {}
    for kind, name in (("warp_only", "warp"), ("ambient_only", "hyper")):
        net = getattr(frame_models[kind], name)
        cond = (torch.cat([driving, pose_enc]) if net.spec.include_driving
                else pose_enc)
        w = k13.prepare_skip(net, cond, warp_g, "tanh" if name == "warp" else "linear")
        y_k = k13.skip_mlp_forward(pts_f, w, "bfloat16")
        y_p = k13.skip_mlp_plain(pts_f, w, "bfloat16")
        chunk_err, chunk_abs = scaled_err(y_k, y_p), abs_err(y_k, y_p)
        del y_k, y_p
        if chunk_err > BF16_GATE:
            return (f"K13 {name} at the frame's fine chunk: {chunk_err} of scale "
                    f"> {BF16_GATE}")
        out_dim = w.out["w"].shape[1]
        b_ms, b_by = bound(2 * skip_macs(w) * P_f, P_f * (3 + out_dim) * 4)
        ms = cuda_time(lambda: k13.skip_mlp_forward(pts_f, w, "bfloat16"), 3)
        rows[f"k13 {name}"] = {
            "ms": ms, "plain_ms": cuda_time(lambda: k13.skip_mlp_plain(pts_f, w, "bfloat16"), 1),
            "library_ms": cuda_time(module_library(net, pts_f), 1),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": chunk_abs,
            "scaled_err": chunk_err, "points": P_f,
            "tflops_achieved": 2 * skip_macs(w) * P_f / (ms / 1e3) / 1e12}
    del pts_f
    for inp in bf16:
        pts, w, g, _, cdt = inp["k14"]
        name = "warp" if w.out_act == "tanh" else "hyper"
        net = getattr(frame_models[inp["kind"]], name)
        P_s = pts.shape[0]
        plan = k13.skip_train_plan(w, torch.bfloat16)
        flops = 2 * skip_vjp_macs(w) * P_s
        b_ms, b_by = bound(flops, P_s * (3 + g.shape[1]) * 4 + plan.out_len * 4)
        ms = cuda_time(lambda: k13.skip_mlp_vjp(pts, w, g, False, cdt), 3)
        rows[f"k14 {name}"] = {
            "ms": ms, "plain_ms": cuda_time(
                lambda: k13.skip_mlp_vjp_plain(pts, w, g, False, cdt), 1),
            "library_ms": cuda_time(module_library(net, pts, g), 1),
            "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": inp["max_abs_err"]["k14"], "points": P_s,
            "tflops_achieved": flops / (ms / 1e3) / 1e12}
    ro, rd, z = k15_args
    P_z = z.numel()
    b_ms, b_by = bound(2 * 3 * P_z, (P_z + 6 * ro.shape[0] + 3 * P_z) * 4,
                       PEAK_F32_FLOPS)
    # device time (torch.profiler), per-call time (CUDA events) and the
    # host's time, each beside torch.addcmul's (the library yardstick: one
    # call; its rounding may differ, it is timed only); "ms" is the
    # device time
    t = k15_readings(k15, ro, rd, z)
    rows["k15"] = {"ms": t["kernel"]["device"], "plain_ms": t["plain"]["device"],
                   "library_ms": t["addcmul"]["device"],
                   "per_call_ms": t["kernel"]["per_call"],
                   "host_ms": t["kernel"]["host"],
                   "library_per_call_ms": t["addcmul"]["per_call"],
                   "library_host_ms": t["addcmul"]["host"],
                   "plain_per_call_ms": t["plain"]["per_call"],
                   "bound_ms": b_ms, "bound_by": b_by,
                   "max_abs_err": max(r["max_abs_err"] for r in report["k15_parity"]),
                   "points": P_z}
    report["skip_kernels"] = rows
    for name, r in rows.items():
        rate = (f"; {r['tflops_achieved']:.1f} TFLOP/s, "
                f"{100 * r['bound_ms'] / r['ms']:.2f} % of the bound"
                if "tflops_achieved" in r else "")
        if name == "k15":
            rate = (f"; per call {r['per_call_ms']:.4f} ms (addcmul "
                    f"{r['library_per_call_ms']:.4f}, plain {r['plain_per_call_ms']:.4f}), "
                    f"host {r['host_ms']:.4f} ms (addcmul {r['library_host_ms']:.4f}); "
                    "ms, plain and library: device time (torch.profiler)")
        print(f"{name}: {r['ms']:.4f} ms at {r['points']} points (bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms{rate})", flush=True)

    launches = {k: sum(int(r.get("launches_per_step", {}).get(k, 0) * r.get("steps", 0)
                           + r.get("launches", {}).get(k, 0)) for r in paths.values())
                for k in kernel_counters()}
    names = {"deform_pair": "K1", "level_train": "K2", "deform_pair_vjp": "K3",
             "grid_dg": "K4", "nerf_level": "K5", "nerf_level_vjp": "K6",
             "grid_dg_coords": "K9"}
    for kk in kernels:
        key = names.get(kk["name"])
        if key and launches[key]:
            kk.setdefault("launches_by_path", {"earlier paths": kk["launches"]})
            kk["launches_by_path"]["one-net paths and fused step"] = launches[key]
            kk["launches"] += launches[key]
    # K15 runs on the main train path too (phase 6)
    launches["K15"] += report["train"]["launches"]["build_pts"]
    for name, key, src, replaces, line in (
            ("skip_mlp_forward", "K13", "sahs_tpu_torch/csrc/skip_mlp.cu",
             "sahs_tpu/ops/pallas/field_mlp.py:345", rows["k13 warp"]),
            ("skip_mlp_vjp", "K14", "sahs_tpu_torch/csrc/skip_mlp.cu",
             "sahs_tpu/ops/pallas/field_mlp.py:516", rows["k14 warp"]),
            ("build_pts", "K15", "sahs_tpu_torch/csrc/build_pts.cu",
             "sahs_tpu/ops/pallas/field_mlp.py:814", rows["k15"])):
        if not launches[key]:
            return f"{key} {name} was not launched on its paths"
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[key],
                        **{k: line[k] for k in ("max_abs_err", "ms", "plain_ms",
                                                "bound_ms", "bound_by", "library_ms")},
                        "tflops_achieved": line.get("tflops_achieved"),
                        **{k: v for k, v in line.items()
                           if k.endswith(("per_call_ms", "host_ms"))}})
    return ""


# ---------------------------------------------------------------------------
# Phases 13 and 14: the grid-free model (view directions, no spatial-
# embedding grid) on the kernel path: K1 without rows, K2, K5-K8, K11 and
# K12 with C = 0; no K4, K9 or K10
# ---------------------------------------------------------------------------

# phase 13's rays a step by compute dtype, as phases 5, 7 and 9
GRID_FREE_RAYS = {"float32": 256, "bfloat16": 2048}
# path -> (runtime settings, fine samples, the kernels it records and
# (module name, wrapper names) of their lookups)
GRID_FREE_RECORD = {
    "fused": ({}, 64, (("fused", ("deform_pair_forward",)),
                       ("level_train", ("nerf_level_train",)))),
    "fallback": ({"fused_grads": False}, 64,
                 (("field_grid", ("nerf_level_forward", "nerf_level_vjp")),)),
    "reuse": ({"fused_grads": False, "fuse_composite": False}, 64,
              (("field_grid", ("nerf_rayd_forward", "nerf_rayd_vjp")),)),
    "per_point": ({}, 128, (("field_grid", ("nerf_mlp_forward_fused",
                                            "nerf_mlp_vjp")),)),
}
# path -> the launches of one grid-free step (K4 = K9 = K10 = 0)
GRID_FREE_LAUNCHES = {
    "fused": {"K1": 2, "K2": 2, "K3": 1, "K15": 2},
    "fallback": {"K1": 2, "K3": 2, "K5": 2, "K6": 2},
    "reuse": {"K1": 2, "K3": 2, "K7": 2, "K8": 2},
    "per_point": {"K1": 2, "K3": 2, "K5": 1, "K6": 1, "K11": 1, "K12": 1},
}


def grid_free_inputs(dev, batch, R, compute_dtype, n_pix, seed) -> dict:
    """The arguments the grid-free model's paths give K1, K2, K5-K8, K11 and
    K12 on one step each (their plain versions in the kernels' place),
    recorded around the wrappers: {kernel name: [args of each call]}."""
    from sahs_tpu_torch.ops.kernels import field_grid
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.train import fused
    modules = {"fused": fused, "level_train": k2, "field_grid": field_grid}
    out = {}
    for path, (runtime, Sn, record) in GRID_FREE_RECORD.items():
        swaps = fused_swaps() + fallback_swaps()
        held = []
        for mod, names in record:
            swaps, calls = recorded(swaps, modules[mod], names)
            held.append(calls)
        cfg = path_cfg("grid_free", R, compute_dtype, num_fine=Sn, **runtime)
        run_step(dev, batch, make_draws(R, n_pix, seed, dev, Sn=Sn), cfg, swaps)
        for calls in held:
            out.update(calls)
    return out


def _fine(calls):
    """The call of a kernel with the most points (the fine level)."""
    return max(calls, key=lambda a: a[0].shape[0])


def grid_free_parity(inp):
    """Each grid-free kernel against its plain version on the paths' own
    inputs (``grid_free_inputs``), in the schemas that train_gates_missed
    and fallback_gates_missed gate. Returns (errors, the kernels' dW trees)
    and raises nothing."""
    import torch
    from sahs_tpu_torch.ops.kernels import deform_pair as k1
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.ops.kernels import nerf_level as k5
    from sahs_tpu_torch.ops.kernels import nerf_mlp as k11
    from sahs_tpu_torch.utils.compare import leaves, point_errors, tree_errors
    tol = TRAIN_F32_GATES["point_tol"]
    worst_abs = lambda a, b: max(abs_err(x, y) for (_, x), (_, y)
                                 in zip(leaves(a), leaves(b)))
    fin = lambda *ts: bool(all(torch.isfinite(t).all() for t in ts if t is not None))

    def dw(g_k, g_p):
        e = tree_errors(g_k, g_p)
        return {"dw_l2_rel": e["l2_rel"], "dw_cosine": e["cosine"],
                "dw_worst_leaf": e["worst_leaf"], "max_abs_err": worst_abs(g_k, g_p)}

    res, trees = {}, {}
    for i, a in enumerate(sorted(inp["deform_pair_forward"], key=lambda a: a[0].shape[0])):
        (out_k, rows_k), (out_p, rows_p) = k1.deform_pair_forward(*a), k1.deform_pair_plain(*a)
        res[f"k1 {('coarse', 'fine')[i]}"] = {
            "abs": abs_err(out_k, out_p), **k1_errors(out_k, out_p, a[0]),
            "max_abs_err": abs_err(out_k, out_p),
            "no_rows": rows_k is None and rows_p is None, "finite": fin(out_k)}
        if a[2] == "bfloat16":
            res[f"k1 {('coarse', 'fine')[i]}"]["exact"] = pair_exact(a, out_k, out_p)
    a = _fine(inp["nerf_level_train"])
    rgb_k, w_k, gx_k, gse_k, gbg_k, g_k = k2.nerf_level_train(*a)
    rgb_p, w_p, gx_p, gse_p, gbg_p, g_p = k2.nerf_level_train_plain(*a)
    trees["k2"] = g_k
    res["k2 fine"] = {"rgb_abs": abs_err(rgb_k, rgb_p), "w_abs": abs_err(w_k, w_p),
                      "rgb_rel": rel_err(rgb_k, rgb_p), "w_rel": rel_err(w_k, w_p),
                      "gx": point_errors(gx_k, gx_p, tol), **dw(g_k, g_p),
                      "finite": fin(rgb_k, w_k, gx_k, gbg_k) and gse_k is None}
    if gbg_k is not None:
        res["k2 fine"]["gbg"] = point_errors(gbg_k, gbg_p, tol)
    res["k2 fine"]["max_abs_err"] = max(abs_err(rgb_k, rgb_p), abs_err(w_k, w_p))
    a = _fine(inp["nerf_level_forward"])
    rgb_k, w_k = k5.nerf_level_forward(*a)
    rgb_p, w_p = k5.nerf_level_plain(*a)
    res["k5 fine"] = {"rgb_abs": abs_err(rgb_k, rgb_p), "w_abs": abs_err(w_k, w_p),
                      "rgb_rel": rel_err(rgb_k, rgb_p), "w_rel": rel_err(w_k, w_p),
                      "max_abs_err": max(abs_err(rgb_k, rgb_p), abs_err(w_k, w_p)),
                      "finite": fin(rgb_k, w_k)}
    if a[8] == "bfloat16":
        res["k5 fine"]["exact"] = level_exact(a, rgb_k, w_k, rgb_p, w_p)
    a = _fine(inp["nerf_level_vjp"])
    gx_k, gse_k, gbg_k, g_k = k2.nerf_level_vjp(*a)
    gx_p, gse_p, gbg_p, g_p = k2.nerf_level_vjp_plain(*a)
    trees["k6"] = g_k
    res["k6 fine"] = {"gx": point_errors(gx_k, gx_p, tol), **dw(g_k, g_p),
                      "finite": fin(gx_k, gbg_k) and gse_k is None}
    if gbg_k is not None:
        res["k6 fine"]["gbg"] = point_errors(gbg_k, gbg_p, tol)
    for name, fk, fp in (("k7", k5.nerf_rayd_forward, k5.nerf_raw_plain),
                         ("k11", k11.nerf_mlp_forward_fused, k11.nerf_mlp_plain)):
        key = {"k7": "nerf_rayd_forward", "k11": "nerf_mlp_forward_fused"}[name]
        a = _fine(inp[key])
        raw_k, raw_p = fk(*a), fp(*a)
        res[name] = {"raw_abs": abs_err(raw_k, raw_p), "raw_scaled": field_scaled(raw_k, raw_p),
                     "max_abs_err": abs_err(raw_k, raw_p), "finite": fin(raw_k)}
        if "bfloat16" in [x for x in a if isinstance(x, str)]:
            res[name]["exact"] = field_exact(fp, a, raw_k, raw_p)
    a = _fine(inp["nerf_rayd_vjp"])
    gx_k, gse_k, g_k = k2.nerf_rayd_vjp(*a)
    gx_p, gse_p, g_p = k2.nerf_rayd_vjp_plain(*a)
    trees["k8"] = g_k
    res["k8"] = {"gx": point_errors(gx_k, gx_p, tol), **dw(g_k, g_p),
                 "finite": fin(gx_k) and gse_k is None}
    a = _fine(inp["nerf_mlp_vjp"])
    gx_k, ge_k, g_k = k2.nerf_mlp_vjp(*a)
    gx_p, ge_p, g_p = k2.nerf_mlp_vjp_plain(*a)
    trees["k12"] = g_k
    res["k12"] = {"gx": point_errors(gx_k, gx_p, tol),
                  "gextra": point_errors(ge_k, ge_p, tol), **dw(g_k, g_p),
                  "finite": fin(gx_k, ge_k) and tuple(ge_k.shape) == (gx_k.shape[0], 3)}
    torch.cuda.synchronize()
    return res, trees


def grid_free_gates_missed(res, compute_dtype) -> list:
    """Phases 5, 7 and 9's gates on the grid-free kernels: K1's packed
    points as phase 2 holds them (1e-4 absolute in float32, the exact-sum
    rule of pair_exact in bf16) and no rows; K2 as train_gates_missed, the
    rest as fallback_gates_missed."""
    f32 = compute_dtype == "float32"
    missed = []
    for name, r in res.items():
        if name.startswith("k1 "):
            ok = r["finite"] and r["no_rows"] and (
                r["abs"] <= 1e-4 if f32 else r["exact"]["ok"])
            if not ok:
                missed.append(name)
    missed += train_gates_missed({k: v for k, v in res.items() if k.startswith("k2 ")},
                                 compute_dtype)
    missed += fallback_gates_missed({k: v for k, v in res.items()
                                     if not k.startswith(("k1 ", "k2 "))}, compute_dtype)
    return missed


def grid_free_planted_faults(inp, trees) -> dict:
    """What the gates see with one fault planted in each grid-free kernel's
    own bf16 results: K1 with the hyper head's bias set to 1 and K5 without
    the alpha head's bias (the exact-sum rule of pair_exact and
    level_exact); K7 and K11 without the alpha head's bias (max |a - b| /
    max |b| per group), and K7 and K11 with rows 16-31 of trunk[1]'s weights, and apart
    from that of the rgb head's, left out of their forward blob
    (field_slice_fault); K2, K6 and K12's bias
    gradient of trunk[1] dropped; the points of K8's first split-K chunk
    dropped (the plain dW over them taken off). Each must miss."""
    import dataclasses
    import torch
    from sahs_tpu_torch.ops.kernels import deform_pair as k1
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.ops.kernels import nerf_level as k5
    from sahs_tpu_torch.ops.kernels import nerf_mlp as k11
    from sahs_tpu_torch.ops.kernels.field_mlp import dw_chunks
    from sahs_tpu_torch.utils.compare import tree_errors

    def no_alpha_bias(lvl):
        return dataclasses.replace(lvl, alpha={"w": lvl.alpha["w"],
                                               "b": torch.zeros_like(lvl.alpha["b"])},
                                   _blobs={})

    out = {}
    a = _fine(inp["deform_pair_forward"])
    pair = a[1]
    bad = dataclasses.replace(pair, hyper_out={"w": pair.hyper_out["w"],
                                               "b": torch.ones_like(pair.hyper_out["b"])},
                              _blobs={})
    out["k1 with the hyper head's bias set to 1"] = pair_exact(
        a, k1.deform_pair_forward(a[0], bad, *a[2:])[0], k1.deform_pair_plain(*a)[0])
    a = _fine(inp["nerf_level_forward"])
    rgb_k, w_k = k5.nerf_level_forward(*a[:7], no_alpha_bias(a[7]), *a[8:])
    rgb_p, w_p = k5.nerf_level_plain(*a)
    out["k5 without the alpha bias"] = level_exact(a, rgb_k, w_k, rgb_p, w_p)
    for name, key, fk, fp, wi in (
            ("k7", "nerf_rayd_forward", k5.nerf_rayd_forward, k5.nerf_raw_plain, 4),
            ("k11", "nerf_mlp_forward_fused", k11.nerf_mlp_forward_fused,
             k11.nerf_mlp_plain, 2)):
        a = _fine(inp[key])
        bad_args = a[:wi] + (no_alpha_bias(a[wi]),) + a[wi + 1:]
        out[f"{name} without the alpha bias"] = {"raw_scaled": field_scaled(
            fk(*bad_args), fp(*a))}
        for layer, what in field_slice_layers(a[wi]):
            out[f"{name} rows 16-31 of {what} left out"] = field_slice_fault(
                fk, fp, a, wi, layer)
    for name, key, plain, gi in (("k2", "nerf_level_train", k2.nerf_level_train_plain, 5),
                                 ("k6", "nerf_level_vjp", k2.nerf_level_vjp_plain, 3),
                                 ("k12", "nerf_mlp_vjp", k2.nerf_mlp_vjp_plain, 2)):
        g_p = plain(*_fine(inp[key]))[gi]
        out[f"{name} bias trunk[1]"] = tree_errors(_drop_bias(trees[name], ["trunk", 1]), g_p)
    args = _fine(inp["nerf_rayd_vjp"])
    R = args[1].shape[0]
    P, S = args[0].shape[0], args[0].shape[0] // R
    n_tiles = -(-P // k2.TP_BF16)
    n = -(-n_tiles // dw_chunks(n_tiles)) * k2.TP_BF16 // S
    sub = (args[0][:n * S], args[1][:n], None, None, args[4][:n * S]) + args[5:]
    g_c = k2.nerf_rayd_vjp_plain(*sub)[2]
    out[f"k8 chunk 0 ({n} rays)"] = tree_errors(
        _tree_sub(trees["k8"], g_c), k2.nerf_rayd_vjp_plain(*args)[2])
    return out


def phase13_grid_free_parity(dev, batch, n_pix, report) -> list:
    """Phase 13. Returns the gates missed and keeps, in ``report``, what it
    measured; the bf16 inputs stay in report["_grid_free_bf16"] for phase
    14's per-kernel times."""
    from sahs_tpu_torch.utils.compare import tree_errors
    missed, rows = [], []
    for compute_dtype, R in GRID_FREE_RAYS.items():
        inp = grid_free_inputs(dev, batch, R, compute_dtype, n_pix, 31)
        res, trees = grid_free_parity(inp)
        rows.append({"dtype": compute_dtype, "rays": R, **res})
        print("grid-free parity " + json.dumps(rows[-1]), flush=True)
        missed += [f"{m} (grid-free, {compute_dtype}, {R} rays)"
                   for m in grid_free_gates_missed(res, compute_dtype)]
        if compute_dtype == "bfloat16":
            faults = grid_free_planted_faults(inp, trees)
            report["grid_free_bf16"] = (inp, res)
    report["grid_free_parity"] = rows
    report["grid_free_planted_faults"] = faults
    print("grid-free planted faults (bf16, the paths' shapes; each must miss the "
          "gates) " + json.dumps(faults), flush=True)
    missed += [f"the gates pass a planted fault: {k}"
               for k, e in faults.items() if fault_passes(e)]
    # whole float32 steps (256 rays): the fused and the per-point step,
    # kernels against plain versions, and the fused step against the
    # fallback step
    R = GRID_FREE_RAYS["float32"]
    check = {}
    for path, Sn, fused_grads in (("fused", 64, True), ("per_point", 128, True),
                                  ("fallback", 64, False)):
        draws = make_draws(R, n_pix, 3, dev, Sn=Sn)
        cfg = path_cfg("grid_free", R, "float32", num_fine=Sn, fused_grads=fused_grads)
        k_ = run_step(dev, batch, draws, cfg)
        check[path] = {"launches": k_[2], "loss": k_[0], "grads": k_[1]}
        if path == "fallback":
            continue
        p_ = run_step(dev, batch, draws, cfg, fused_swaps() + fallback_swaps())
        check[path].update(loss_rel=abs(k_[0] - p_[0]) / abs(p_[0]),
                           kernels_vs_plain=tree_errors(k_[1], p_[1]))
        if (check[path]["loss_rel"] > STEP_GATES["loss_rel"]
                or not dw_ok(check[path]["kernels_vs_plain"], STEP_GATES)):
            missed.append(f"f32 grid-free {path} step: {check[path]}")
    for path in check:
        if check[path]["launches"] != GRID_FREE_LAUNCHES[path]:
            missed.append(f"f32 grid-free {path} step launched "
                          f"{check[path]['launches']}, not {GRID_FREE_LAUNCHES[path]}")
    f, b = check["fused"], check["fallback"]
    vs = {"loss_rel": abs(f["loss"] - b["loss"]) / abs(b["loss"]),
          **tree_errors(f["grads"], b["grads"])}
    if vs["loss_rel"] > STEP_GATES["loss_rel"] or not dw_ok(vs, FUSED_VS_FALLBACK):
        missed.append(f"grid-free fused step against the fallback step: {vs}")
    steps = {p: {k: v for k, v in c.items() if k != "grads"} for p, c in check.items()}
    steps["fused_vs_fallback"] = vs
    report["grid_free_steps_f32"] = steps
    print("grid-free steps f32 (256 rays), every gradient leaf against the plain "
          "step on the card, and the fused step against the fallback step "
          + json.dumps(steps), flush=True)
    return missed


def phase14_grid_free_paths(dev, ds, near, far, time_path, time_frame, report,
                            kernels) -> str:
    """Phase 14. Times the grid-free frame and its steps on every path
    (launch counters zeroed before each run and checked after it, K4, K9
    and K10 at zero), prints them beside the flagship's readings of this
    run, then the grid-free kernels per call; adds the paths' launches to
    the kernels' entries. Returns a failure message, or ""."""
    import torch
    from sahs_tpu_torch.evaluation import make_eval_renderer
    from sahs_tpu_torch.models import nerface
    from sahs_tpu_torch.ops.kernels import deform_pair as k1
    from sahs_tpu_torch.ops.kernels import level_train as k2
    from sahs_tpu_torch.ops.kernels import nerf_level as k5
    from sahs_tpu_torch.ops.kernels import nerf_mlp as k11
    from sahs_tpu_torch.render.pipeline import RenderSettings
    item = ds[0]
    cfg = path_cfg("grid_free")
    spec = nerface.ModelSpec.from_config(cfg)
    s = RenderSettings.from_config(cfg, "validation")
    render = make_eval_renderer(spec, s, ds.H, ds.W, near, far, device=dev)
    model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
    n = math.ceil(ds.H * ds.W / min(s.chunksize, 32768))
    paths = {"frame": time_frame(
        lambda: render(model, item["intrinsics"], item["pose"], item["driving"],
                       ds.background()), {"K1": 2 * n, "K5": 2 * n})}
    del model
    for path, steps in (("fused", 10), ("fallback", 3), ("reuse", 3),
                        ("per_point", 3)):
        runtime, Sn, _ = GRID_FREE_RECORD[path]
        paths[f"{path} step"] = time_path(path_cfg("grid_free", num_fine=Sn, **runtime),
                                          ds, GRID_FREE_LAUNCHES[path], n_steps=steps)
    report["grid_free_paths"] = paths
    # the flagship's readings of the same paths in this run (phases 3, 6, 8, 10)
    flagship = {"frame": report["frame"]["ms"], "fused step": report["train"]["ms"],
                "fallback step": report["fallback_paths"]["1 fallback step"]["ms"],
                "reuse step": report["fallback_paths"]["2 reuse step"]["ms"],
                "per_point step": report["pointwise_paths"]["2 per-point step"]["ms"]}
    report["grid_free_vs_flagship"] = {n_: {"grid_free_ms": paths[n_]["ms"],
                                           "flagship_ms": flagship[n_]} for n_ in paths}
    for name, r in paths.items():
        print(f"grid-free {name}: {r['ms']:.1f} ms on the card (CUDA events), "
              f"{r['host_ms']:.1f} ms on the host clock, launches "
              f"{r.get('launches_per_step', r.get('launches'))}"
              + (" per step" if "launches_per_step" in r else "")
              + f"; the flagship's in this run {flagship[name]:.1f} ms", flush=True)
    bad = {n_: r["checks"] for n_, r in paths.items() if not all(r["checks"].values())}
    if bad:
        return f"grid-free path checks failed: {bad}"

    # per-call times of the grid-free kernels on phase 13's bf16 inputs
    # (2048 rays, the fine level), beside their plain versions and bounds
    inp, res = report.pop("grid_free_bf16")
    rows = {}
    for name, key, fk, fp, err in (
            ("k1", "deform_pair_forward", k1.deform_pair_forward, k1.deform_pair_plain,
             res["k1 fine"]["max_abs_err"]),
            ("k2", "nerf_level_train", k2.nerf_level_train, k2.nerf_level_train_plain,
             res["k2 fine"]["max_abs_err"]),
            ("k5", "nerf_level_forward", k5.nerf_level_forward, k5.nerf_level_plain,
             res["k5 fine"]["max_abs_err"]),
            ("k6", "nerf_level_vjp", k2.nerf_level_vjp, k2.nerf_level_vjp_plain,
             res["k6 fine"]["max_abs_err"]),
            ("k7", "nerf_rayd_forward", k5.nerf_rayd_forward, k5.nerf_raw_plain,
             res["k7"]["max_abs_err"]),
            ("k8", "nerf_rayd_vjp", k2.nerf_rayd_vjp, k2.nerf_rayd_vjp_plain,
             res["k8"]["max_abs_err"]),
            ("k11", "nerf_mlp_forward_fused", k11.nerf_mlp_forward_fused,
             k11.nerf_mlp_plain, res["k11"]["max_abs_err"]),
            ("k12", "nerf_mlp_vjp", k2.nerf_mlp_vjp, k2.nerf_mlp_vjp_plain,
             res["k12"]["max_abs_err"])):
        a = _fine(inp[key])
        rows[name] = {"ms": cuda_time(lambda: fk(*a), 3),
                      "plain_ms": cuda_time(lambda: fp(*a), 1),
                      "points": a[0].shape[0], "max_abs_err": err}
    report["grid_free_kernels"] = rows
    for name, r in rows.items():
        print(f"grid-free {name}: {r['ms']:.2f} ms at {r['points']} points "
              f"(plain {r['plain_ms']:.2f} ms)", flush=True)
    launches = {k: sum(int(r.get("launches_per_step", {}).get(k, 0) * r.get("steps", 0)
                           + r.get("launches", {}).get(k, 0)) for r in paths.values())
                for k in kernel_counters()}
    if launches["K4"] or launches["K9"] or launches["K10"]:
        return f"a grid-free path launched K4, K9 or K10: {launches}"
    names = {"deform_pair": "K1", "level_train": "K2", "deform_pair_vjp": "K3",
             "nerf_level": "K5", "nerf_level_vjp": "K6", "nerf_rayd_forward": "K7",
             "nerf_rayd_vjp": "K8", "nerf_mlp_forward_fused": "K11",
             "nerf_mlp_vjp": "K12", "build_pts": "K15"}
    for kk in kernels:
        key = names.get(kk["name"])
        if key and launches[key]:
            kk.setdefault("launches_by_path", {"earlier paths": kk["launches"]})
            kk["launches_by_path"]["grid-free paths"] = launches[key]
            kk["launches"] += launches[key]
    return ""


# ---------------------------------------------------------------------------
# Phase 15: the tools' experiment kernels X1-X6
# ---------------------------------------------------------------------------

# X1's gates against its plain version: the row sums' L2-relative error and
# the worst row against the largest (bf16 rounds every layer's activation);
# X4-X6: L2-relative and the worst entry, absolute; X2 and X3 sum the same
# values in another order
TOOL_GATES = {"X1": (1e-3, 1e-2), "X2": (1e-6, None), "X3": (1e-6, None),
              "X4": (1e-3, 5e-2), "X5": (1e-3, 5e-2), "X6": (1e-3, 5e-2)}
TOOLS = {"X1": ("chain_rows", "sahs_tpu_torch/csrc/exp_gather.cu", "tools/exp_gather.py:52"),
         "X2": ("dg_rows", "sahs_tpu_torch/csrc/exp_gather.cu", "tools/exp_gather.py:78"),
         "X3": ("chunk_rows", "sahs_tpu_torch/csrc/exp_gather.cu", "tools/exp_gather.py:106"),
         "X4": ("narrow_call", "sahs_tpu_torch/csrc/exp_pair2.cu", "tools/exp_pair2.py:56"),
         "X5": ("paired_call", "sahs_tpu_torch/csrc/exp_pair2.cu", "tools/exp_pair2.py:79"),
         "X6": ("reshape_call", "sahs_tpu_torch/csrc/exp_pair2.cu", "tools/exp_pair2.py:102")}


def tool_errors(k, a, b) -> dict:
    """A tool kernel's output ``a`` against its plain version's ``b``."""
    l2 = float((a.double() - b.double()).norm() / b.double().norm())
    worst = scaled_err(a, b) if k == "X1" else abs_err(a, b)
    return {"l2_rel": l2, "worst": worst, "max_abs_err": abs_err(a, b)}


def tool_passes(k, e) -> bool:
    l2, worst = TOOL_GATES[k]
    return e["l2_rel"] <= l2 and (worst is None or e["worst"] <= worst)


def dg_read(idx, n_gathers: int, tile: int) -> int:
    """The entries of x (P, L) that X2's gathers read with these indices:
    each tile's column c reads rows (idx + 7 k) mod tile, k < n_gathers."""
    import torch
    P, L = idx.shape
    base = (torch.arange(P, device=idx.device) // tile * tile)[:, None]
    col = torch.arange(L, device=idx.device)[None, :]
    seen = torch.zeros(P * L, dtype=torch.bool, device=idx.device)
    i = idx.long()
    for _ in range(n_gathers):
        seen[((base + i) * L + col).reshape(-1)] = True
        i = (i + 7) % tile
    return int(seen.sum())


def tool_cases(dev):
    """Every case of the two tools at their sizes: (kernel, case name,
    kernel call, plain call, library call, faulty call, flops, the bytes it
    must move: each input entry it reads once, its output once)."""
    import torch
    from sahs_tpu_torch.tools import exp_gather as xg
    from sahs_tpu_torch.tools import exp_pair2 as xp
    gen = torch.Generator(device=dev).manual_seed(0)
    P, T = xg.P, xg.TILE
    for n_layers, H in xg.CHAIN_CASES:
        x, w = xg.chain_inputs(H, gen, dev)

        def lib(x=x, w=w, n=n_layers):
            h = x
            for _ in range(n):
                h = torch.relu(h @ w)          # cuBLAS bf16, float32 sums
            return h.float().sum(dim=-1, keepdim=True)
        yield ("X1", f"chain {n_layers}x{H}",
               lambda x=x, w=w, n=n_layers: xg.chain_rows(x, w, n),
               lambda x=x, w=w, n=n_layers: xg.chain_plain(x, w, n), lib,
               lambda x=x, w=w, n=n_layers: xg.chain_rows(x, w, n - 1),
               2 * P * H * H * n_layers, P * H * 2 + H * H * 2 + P * 4)
    for L, dt, ng in xg.DG_CASES:
        x, idx = xg.dg_inputs(L, dt, gen, dev)

        def lib(x=x, idx=idx, ng=ng):
            h = x.reshape(-1, T, L)
            i = idx.reshape(-1, T, L).long()
            acc = torch.zeros(h.shape, dtype=torch.float32, device=x.device)
            for _ in range(ng):
                acc += torch.gather(h, 1, i).float()
                i = (i + 7) % T
            return acc.sum(-1)
        yield ("X2", f"dg L={L} x{ng} {dt}",
               lambda x=x, idx=idx, ng=ng: xg.dg_rows(x, idx, ng),
               lambda x=x, idx=idx, ng=ng: xg.dg_plain(x, idx, ng), lib,
               lambda x=x, idx=idx, ng=ng: xg.dg_rows(x, (idx + 1) % T, ng),
               0, dg_read(idx, ng, T) * x.element_size() + P * L * 4 + P * 4)
    for N, L, dt in xg.CHUNK_CASES:
        tab, idx = xg.chunk_inputs(N, L, dt, gen, dev)
        flat = tab.reshape(N, L)
        yield ("X3", f"chunk N={N} L={L} {dt}",
               lambda tab=tab, idx=idx: xg.chunk_rows(tab, idx),
               lambda tab=tab, idx=idx: xg.chunk_plain(tab, idx),
               lambda flat=flat, idx=idx: torch.gather(flat, 0, idx.long()).float().sum(-1),
               lambda tab=tab, idx=idx, N=N: xg.chunk_rows(tab, (idx + 1) % N),
               0, P * L * 4 + N * L * tab.element_size() + P * 4)
    x, x2, ws, ws2 = xp.inputs(gen, dev)
    bad = lambda w: w[:-1] + [w[-1].t().contiguous()]

    def chain_lib(h, w):
        for wi in w:
            h = torch.tanh(h @ wi)
        return h
    for k, name, call, plain, lib, fault, flops, nbytes in (
            ("X4", "narrow", lambda: xp.narrow_call(x, ws), lambda: xp.narrow_plain(x, ws),
             lambda: chain_lib(x[:, :64], ws), lambda: xp.narrow_call(x, bad(ws)),
             2 * P * 64 * 64 * xp.L, P * 64 * 2 + P * 128 * 2),
            ("X5", "paired", lambda: xp.paired_call(x2, ws2),
             lambda: xp.paired_plain(x2, ws2), lambda: chain_lib(x2, ws2),
             lambda: xp.paired_call(x2, bad(ws2)),
             2 * (P // 2) * 128 * 128 * xp.L, (P // 2) * 128 * 2 * 2),
            ("X6", "reshape", lambda: xp.reshape_call(x, ws2, "reshape"),
             lambda: xp.reshape_plain(x, ws2, "reshape"),
             lambda: chain_lib(xp.pair_rows(x), ws2),
             lambda: xp.reshape_call(x, bad(ws2), "reshape"),
             2 * (P // 2) * 128 * 128 * xp.L, P * 64 * 2 + (P // 2) * 128 * 2),
            ("X6", "strided", lambda: xp.reshape_call(x, ws2, "strided"),
             lambda: xp.reshape_plain(x, ws2, "strided"),
             lambda: chain_lib(xp.pair_rows(x), ws2),
             lambda: xp.reshape_call(x, bad(ws2), "strided"),
             2 * (P // 2) * 128 * 128 * xp.L, P * 64 * 2 + (P // 2) * 128 * 2)):
        yield k, name, call, plain, lib, fault, flops, nbytes


def phase15_tools(dev, report, kernels) -> str:
    """Phase 15. Runs both tools' main() (every case, at their sizes) with
    the X counters zeroed just before and read just after; then holds each
    case's kernel against its plain version (TOOL_GATES), plants a fault
    in each (X1 one layer short, X2 and X3 with every index moved by one,
    X4-X6 with the last layer's weights transposed) and times the kernel,
    its plain version and a library call beside the bound. Appends X1-X6
    to ``kernels``. Returns a failure message, or ""."""
    import torch
    from sahs_tpu_torch.tools import exp_gather as xg
    from sahs_tpu_torch.tools import exp_pair2 as xp
    held = tool_counters()
    for f in held.values():
        f.launches = 0
    report["tools_main"] = {"exp_gather": xg.main(device=dev),
                            "exp_pair2": xp.main(device=dev)}
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in held.items()}
    report["tools_launches"] = launches
    print(f"tools' main() launches {launches}", flush=True)
    missing = [k for k, n in launches.items() if not n]
    if missing:
        return f"the tools' main() did not launch {missing}"
    rows, missed = [], []
    for k, name, call, plain, lib, fault, flops, nbytes in tool_cases(dev):
        out_k, out_p = call(), plain()
        e = tool_errors(k, out_k.float(), out_p.float())
        f = tool_errors(k, fault().float(), out_p.float())
        del out_k, out_p
        b_ms, b_by = bound(flops, nbytes)
        row = {"kernel": k, "case": name, **e, "fault": f,
               "ms": cuda_time(call, 10), "plain_ms": cuda_time(plain, 3),
               "library_ms": cuda_time(lib, 3), "bound_ms": b_ms, "bound_by": b_by}
        row["bound_share"] = b_ms / row["ms"]
        if flops:
            row["tflops_achieved"] = flops / (row["ms"] / 1e3) / 1e12
        rows.append(row)
        print("tool " + json.dumps(row), flush=True)
        if not tool_passes(k, e):
            missed.append(f"{k} {name}: {e}")
        if tool_passes(k, f):
            missed.append(f"the gates pass a planted fault: {k} {name} {f}")
    report["tools"] = rows
    if missed:
        return f"tool kernel gates missed: {missed}"
    for k, (fname, src, replaces) in TOOLS.items():
        first = next(r for r in rows if r["kernel"] == k)
        kernels.append({"name": fname, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[k],
                        "max_abs_err": max(r["max_abs_err"] for r in rows if r["kernel"] == k),
                        **{q: first[q] for q in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms")}})
    return ""


# ---------------------------------------------------------------------------
# Phase 16: the Stage-I trainer's entry point on the card
# ---------------------------------------------------------------------------

# the kernels of phase 16's runs, by their entry of the kernels line
TRAINER_KERNELS = {"K1": "sahs_tpu/ops/pallas/field_mlp.py:868",
                   "K2": "sahs_tpu/ops/pallas/level_train.py:55",
                   "K3": "sahs_tpu/ops/pallas/field_mlp.py:1098",
                   "K4": "sahs_tpu/ops/pallas/grid_bwd.py:211",
                   "K5": "sahs_tpu/ops/pallas/field_mlp.py:2681",
                   "K15": "sahs_tpu/ops/pallas/field_mlp.py:814"}
TRAIN_KEYS = {"train/loss", "train/psnr", "train/coarse_l2", "train/fine_l2",
              "train/coarse_ce", "train/fine_ce", "perf/rays_per_s"}


def _states_equal(a, b) -> list:
    """The parameters and Adam moments (by name) where two train states
    differ; [] when every one is equal bit for bit."""
    import torch
    diff = []
    named = lambda st: ([(n, p) for n, p in st.model.named_parameters()]
                        + [(n, getattr(st, n)) for n in ("background", "latent_codes")
                           if getattr(st, n) is not None])
    for (n, p), (_, q) in zip(named(a), named(b)):
        if not torch.equal(p, q):
            diff.append(f"{n}: max |d| {float((p - q).abs().max()):.3e}")
        sa, sb = a.optimizer.state.get(p, {}), b.optimizer.state.get(q, {})
        if sorted(sa) != sorted(sb):
            diff.append(f"{n}: Adam state keys {sorted(sa)} / {sorted(sb)}")
            continue
        for k in ("exp_avg", "exp_avg_sq", "step"):
            if k in sa and not torch.equal(sa[k], sb[k]):
                diff.append(f"{n}: {k}")
    return diff


def phase16_trainer(dev, report, kernels) -> str:
    """Phase 16. The Stage-I trainer's entry point at the flagship
    Config() (AudioFaceModel, 2048 rays, 64 + 64, bf16, the fused path) on
    synthetic 512x512 frames: ``cli.train_stage1.main`` with 4 steps a
    launch to iteration 9 (two launches of the multi-step loop and one
    single step, a validation frame at 8, a checkpoint at 9), the launch
    counters zeroed just before and read just after; the checkpoint
    restored into a fresh state must equal the run's final state (every
    parameter and Adam moment, bit for bit), and a resumed run goes on to
    iteration 10; then 4 steps through make_multi_train_step against 4
    single train_step calls fed the same draws (bit for bit), and ms a
    step through the multi-step loop (K = 8) and through single steps in turns.
    Returns a failure message, or ""."""
    import shutil

    import torch
    import yaml

    from sahs_tpu_torch.cli import train_stage1 as cli
    from sahs_tpu_torch.config import load_config
    from sahs_tpu_torch.data.synthetic import SyntheticFaceDataset
    from sahs_tpu_torch.models.nerface import ModelSpec
    from sahs_tpu_torch.train import stage1
    from sahs_tpu_torch.utils import checkpoint as ck

    out = os.path.join(REPO, "build", "phase16")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    logdir = os.path.join(out, "log")
    cfg_path = os.path.join(out, "cfg.yml")
    with open(cfg_path, "w") as fp:
        yaml.safe_dump({"experiment": {"id": "smoke", "logdir": logdir, "randomseed": 0,
                                       "print_every": 4, "validate_every": 8,
                                       "save_every": 1000000},
                        "runtime": {"validate_frames": 1}}, fp)
    args = ["--config", cfg_path, "--synthetic", "--synthetic-size", "512",
            "--steps-per-launch", "4", "--device", str(dev)]
    held = kernel_counters()
    for f in held.values():
        f.launches = 0
    t0 = time.time()
    state = cli.main(args + ["--max-iters", "9"])
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches = {k: f.launches for k, f in held.items() if f.launches}
    print(f"trainer CLI to iteration 9: {run_s:.1f} s, launches {launches}", flush=True)
    # 9 fused steps (K1, K2, K15 x2, K3, K4 x1) and one 512x512 frame of 8
    # chunks (K1, K5 x2)
    want = {"K1": 2 * 9 + 16, "K2": 18, "K3": 9, "K4": 9, "K5": 16, "K15": 18}
    if launches != want:
        return f"the trainer's launches {launches}, expected {want}"
    run_dir = os.path.join(logdir, "smoke")
    ckpt9 = os.path.join(run_dir, "checkpoint0000009.ckpt")
    with open(os.path.join(run_dir, "metrics.jsonl")) as fp:
        recs = [json.loads(line) for line in fp]
    train_recs = [r for r in recs if "train/loss" in r]
    if ([r["step"] for r in train_recs] != [4, 8, 9] or any(not TRAIN_KEYS <= set(r) for r in train_recs)
            or not any("val/psnr" in r for r in recs) or not os.path.exists(ckpt9)
            or state.step != 9):
        return f"the trainer's log or checkpoint is not as expected: {recs}"
    if not all(math.isfinite(r[k]) for r in train_recs for k in TRAIN_KEYS):
        return f"non-finite training metrics: {train_recs}"
    cfg = load_config(cfg_path)
    spec, ts = ModelSpec.from_config(cfg), stage1.TrainSettings.from_config(cfg)
    ds = SyntheticFaceDataset(kind="audio", num_frames=8, H=512, W=512,
                              near=cfg.dataset.near, far=cfg.dataset.far)
    bg = ds.background()
    fresh = stage1.init_train_state(spec, ts, seed=1, background=bg, device=dev)
    restored, _ = ck.restore_train_state(ckpt9, fresh)
    diff = _states_equal(restored, state)
    if diff or restored.step != 9 or not torch.equal(restored.sample_prob, state.sample_prob):
        return f"the restored checkpoint differs from the run's state: {diff[:8]}"
    resumed = cli.main(args + ["--max-iters", "10", "--load-checkpoint", ckpt9])
    torch.cuda.synchronize()
    if resumed.step != 10 or not os.path.exists(os.path.join(run_dir, "checkpoint0000010.ckpt")):
        return f"the resumed run ended at iteration {resumed.step}"
    del state, restored, resumed, fresh

    # the multi-step loop against single steps fed the same draws
    items = [ds[j] for j in (3, 1, 6, 0, 5, 2, 7, 4)]
    multi = stage1.make_multi_train_step(spec, ts, device=dev)
    step = stage1.make_train_step(spec, ts, device=dev)
    a = stage1.init_train_state(spec, ts, seed=0, background=bg, device=dev)
    b = stage1.init_train_state(spec, ts, seed=0, background=bg, device=dev)
    a, ma = multi(a, stage1.stack_batches(items[:4], bg, device=dev),
                  generator=torch.Generator(device=dev).manual_seed(3))
    gen = torch.Generator(device=dev).manual_seed(3)
    singles = [cli.device_batch(it, torch.from_numpy(bg).to(dev), dev) for it in items]
    for batch in singles[:4]:
        b, mb = step(b, batch, generator=gen)
    torch.cuda.synchronize()
    diff = _states_equal(a, b)
    if not torch.equal(ma["loss"][-1], mb["loss"]):
        diff.append(f"loss {float(ma['loss'][-1])} / {float(mb['loss'])}")
    report["trainer_multi_vs_single"] = {"steps": 4, "differ": diff}
    print(f"multi-step (K = 4) against 4 single steps, same draws: "
          f"{'bit for bit' if not diff else diff}", flush=True)
    if diff:
        return f"the multi-step loop's 4 steps differ from 4 single steps: {diff[:8]}"

    # ms a step, in turns: multi-step (K = 8), single steps, single steps, multi-step
    stacked = stage1.stack_batches(items, bg, device=dev)
    readings = {"multi": [], "single": []}
    for kind in ("multi", "single", "single", "multi"):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.time()
        ev[0].record()
        if kind == "multi":
            a, _ = multi(a, stacked, generator=gen)
        else:
            for batch in singles:
                a, _ = step(a, batch, generator=gen)
        ev[1].record()
        torch.cuda.synchronize()
        readings[kind].append({"device_ms": ev[0].elapsed_time(ev[1]) / len(items),
                               "host_ms": (time.time() - t0) * 1e3 / len(items)})
    report["trainer"] = {"cli_to_iter9_s": run_s, "launches": launches,
                         "ms_per_step": readings}
    print("ms a step in turns (multi-step K = 8 / single / single / multi-step): "
          + json.dumps(readings), flush=True)
    for kk in kernels:
        key = next((k for k, r in TRAINER_KERNELS.items() if r == kk["replaces"]), None)
        if key:
            kk.setdefault("launches_by_path", {"earlier paths": kk["launches"]})
            kk["launches_by_path"]["Stage-I trainer (phase 16)"] = launches[key]
            kk["launches"] += launches[key]
    return ""


# ---------------------------------------------------------------------------
# Phase 17: what a user runs after Stage-I training
# ---------------------------------------------------------------------------

# the kernels of phase 17's eval CLI, by their entry of the kernels line
PIPELINE_KERNELS = {"K1": "sahs_tpu/ops/pallas/field_mlp.py:868",
                    "K5": "sahs_tpu/ops/pallas/field_mlp.py:2681"}
PIPELINE_FRAMES = 3
# a generator forward at 512x512 on the card (``make_infer``, which sets
# full float32) against the same generator on the CPU: max abs error over
# the refined frame.
# 4x the reading of 1.07e-5 (NVIDIA H100 80GB HBM3, 700.00 W), under the
# 1e-4 ceiling the card tests keep
GEN_CPU_GATE = 4e-5
# LPIPS of one frame pair on the card against the CPU, relative
LPIPS_CPU_GATE = 1e-4


def phase17_pipeline(dev, report, kernels, size: int = 512) -> str:
    """Phase 17. The user's pipeline after Stage-I training, on phase 16's
    checkpoint at iteration 10 (the flagship Config(), 512x512): a
    synthetic audio dataset of PIPELINE_FRAMES train and val frames
    written to build/phase17/; ``cli.eval_stage1.main`` over the val
    frames with every output switched on (launch counters zeroed just
    before and read just after: K1 = K5 = 16 a frame), every file there,
    one frame's rgb file equal byte for byte to make_eval_renderer's frame
    written the same way; the train frames rendered through
    ``evaluate_dataset``; Stage II through its CLIs (``train_stage2`` one
    epoch, a resume from its checkpoint, which must restore the run's
    state bit for bit, ``eval_stage2``), the trained generator's float32
    forward on the card against the CPU's (GEN_CPU_GATE), its ms per
    inference and per train step; ``metrics.two_folders`` of the val
    frames against the refined ones with LPIPS from a random-weight .pth
    in lpips-package naming, LPIPS on the card against the CPU
    (LPIPS_CPU_GATE), SSIM and LPIPS ms a frame. ``size``: the frames'
    side (512; smaller only to rehearse the phase). Returns a failure
    message, or ""."""
    import shutil

    import numpy as np
    import torch
    import yaml

    from sahs_tpu_torch import lpips, metrics
    from sahs_tpu_torch.cli import eval_stage1, eval_stage2, train_stage1, train_stage2
    from sahs_tpu_torch.config import load_config
    from sahs_tpu_torch.data.audio import AudioDataset
    from sahs_tpu_torch.data.synthetic import write_synthetic_dataset
    from sahs_tpu_torch.data.texture import identity_photo, spade_output_dataset
    from sahs_tpu_torch.evaluation import cast_to_image, evaluate_dataset, make_eval_renderer
    from sahs_tpu_torch.models import spade
    from sahs_tpu_torch.models.nerface import ModelSpec, NeRFaceModel
    from sahs_tpu_torch.render.pipeline import RenderSettings
    from sahs_tpu_torch.train import stage2
    from sahs_tpu_torch.utils import checkpoint as ck
    from sahs_tpu_torch.utils.images import imread, imwrite
    from sahs_tpu_torch.utils.weights import params_from_jax

    ckpt10 = os.path.join(REPO, "build", "phase16", "log", "smoke", "checkpoint0000010.ckpt")
    if not os.path.exists(ckpt10):
        return f"phase 16's checkpoint {ckpt10} is missing"
    out = os.path.join(REPO, "build", "phase17")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    ds_dir = os.path.join(out, "dataset")
    write_synthetic_dataset(ds_dir, kind="audio", num_frames=PIPELINE_FRAMES, H=size, W=size)
    r_val, r_train = os.path.join(out, "renders_val"), os.path.join(out, "renders_train")
    refined, logdir = os.path.join(out, "refined"), os.path.join(out, "log")
    cfg_path = os.path.join(out, "cfg.yml")
    with open(cfg_path, "w") as fp:
        yaml.safe_dump({
            "experiment": {"id": "smoke", "logdir": logdir, "randomseed": 0},
            "dataset": {"type": "audio", "basedir": ds_dir},
            "texture_refine": {"texture_photo": os.path.join(ds_dir, "com_imgs", "0.jpg"),
                               "train_basedir": r_train, "val_basedir": r_val,
                               "test_basedir": r_val, "epochs": 1, "epochs_decay": 0,
                               "log_iters": 1, "scan_frames": 2}}, fp)
    cfg = load_config(cfg_path)
    res = {}

    # the eval CLI over the val frames, launch counters zeroed just before
    held = kernel_counters()
    for f in held.values():
        f.launches = 0
    t0 = time.time()
    times = eval_stage1.main(["--config", cfg_path, "--checkpoint", ckpt10, "--savedir", r_val,
                              "--deterministic", "--save-disparity-image",
                              "--save-error-image", "--save-mesh", "--device", str(dev)])
    torch.cuda.synchronize()
    res["eval_cli_s"] = time.time() - t0
    launches = {k: f.launches for k, f in held.items() if f.launches}
    res["eval_s_per_frame"] = times
    print(f"eval CLI: {len(times)} frames in {res['eval_cli_s']:.1f} s, s a frame "
          f"{[round(t, 4) for t in times]}, launches {launches}", flush=True)
    # two levels of chunks of 32,768 rays: 16 a 512x512 frame
    per_frame = 2 * math.ceil(size * size / 32768)
    want = {"K1": per_frame * PIPELINE_FRAMES, "K5": per_frame * PIPELINE_FRAMES}
    if launches != want:
        return f"the eval CLI's launches {launches}, expected {want}"
    val = train_stage1.build_dataset(cfg, "val")
    stems = [os.path.splitext(val[i]["fname"])[0] for i in range(len(val))]
    files = [os.path.join(r_val, s + ".jpg") for s in stems]
    for sub, ext in (("masks", ".png"), ("normals", ".png"), ("disparity", ".png"),
                     ("error", ".png"), ("mesh", ".obj")):
        files += [os.path.join(r_val, sub, s + ext) for s in stems]
    missing = [f for f in files if not os.path.exists(f)]
    if len(stems) != PIPELINE_FRAMES or missing:
        return f"the eval CLI's outputs are missing: {missing[:6]} ({len(stems)} frames)"

    # one frame against make_eval_renderer's, written the same way
    spec = ModelSpec.from_config(cfg)
    tree, extras = eval_stage1.load_any_checkpoint(ckpt10, spec)
    model = params_from_jax(NeRFaceModel.init(spec, device="cpu"), tree).to(dev)
    settings = dataclasses.replace(RenderSettings.from_config(cfg, "validation"),
                                   perturb=False, radiance_field_noise_std=0.0)
    render = make_eval_renderer(spec, settings, val.H, val.W, float(cfg.dataset.near),
                                float(cfg.dataset.far), device=dev)
    item = val[0]
    bg = extras["background"]
    call = lambda: render(model, item["intrinsics"], item["pose"], item["driving"], bg, None)
    with torch.no_grad():
        frame = call()
        ref_path = os.path.join(out, "renderer_frame.jpg")
        imwrite(ref_path, cast_to_image(frame["rgb_fine"][..., :3]))
        with open(ref_path, "rb") as fa, open(files[0], "rb") as fb:
            same = fa.read() == fb.read()
        res["render_device_ms"] = cuda_time(call, 3)
    print(f"eval CLI frame {os.path.basename(files[0])} against make_eval_renderer's: "
          f"{'byte for byte' if same else 'DIFFERENT'}; the render's device ms "
          f"{res['render_device_ms']:.1f}", flush=True)
    if not same:
        return "the eval CLI's frame differs from make_eval_renderer's"
    train = train_stage1.build_dataset(cfg, "train")
    evaluate_dataset(cfg, spec, model, train, r_train, background=bg, save_normals=False,
                     deterministic=True, device=dev)
    del model, frame

    # Stage II through its CLIs: one epoch, a resume, the refined frames
    s2dir = os.path.join(logdir, "smoke_stage2")
    ckpt_s2 = os.path.join(s2dir, "checkpoint_ep0000.ckpt")
    t0 = time.time()
    state = train_stage2.main(["--config", cfg_path, "--max-epochs", "1", "--device", str(dev)])
    torch.cuda.synchronize()
    res["stage2_epoch_s"] = time.time() - t0
    first = ck.stage2_sections(state)
    s = stage2.Stage2Settings.from_config(cfg, steps_per_epoch=PIPELINE_FRAMES)
    fresh = stage2.init_stage2_state(s, seed=5, device=dev)
    fresh, _ = ck.restore_stage2_state(ckpt_s2, fresh)
    diff = [k for k, a in first.items()
            for x, y in zip(_leaves(a), _leaves(ck.stage2_sections(fresh)[k]))
            if not np.array_equal(x, y)]
    resumed = train_stage2.main(["--config", cfg_path, "--max-epochs", "1", "--device",
                                 str(dev), "--load-checkpoint", ckpt_s2])
    torch.cuda.synchronize()
    print(f"Stage II: one epoch in {res['stage2_epoch_s']:.1f} s to step {state.step}, "
          f"restored {'bit for bit' if not diff else diff}, resumed to step {resumed.step}",
          flush=True)
    if diff or resumed.step != 2 * state.step or state.step == 0:
        return f"Stage II's checkpoint or resume failed: {diff}, steps {state.step} / {resumed.step}"
    written = eval_stage2.main(["--config", cfg_path, "--checkpoint", ckpt_s2, "--savedir",
                                refined, "--device", str(dev)])
    if len(written) != PIPELINE_FRAMES or not all(os.path.exists(w) for w in written):
        return f"eval_stage2 wrote {written}"
    if any(imread(w).shape != (size, size, 3) for w in written):
        return f"a refined frame is not {size}x{size}x3"

    # the trained generator on the card against the CPU, float32
    sections, _ = ck.restore_sections(ckpt_s2)
    gens = {d: spade.from_jax(spade.Generator(audio=True).to(d), sections["params"],
                              sections["bufs"]) for d in (dev, torch.device("cpu"))}
    src = identity_photo(cfg)[None]
    raw = spade_output_dataset("val", cfg)[0][None]
    aud = AudioDataset("val", cfg).get_all_auds()[0]
    infer = stage2.make_infer(s)
    t = lambda a, d: torch.as_tensor(np.asarray(a, np.float32), device=d)
    outs = {d: infer(g, t(src, d), t(raw, d), t(aud, d)).cpu() for d, g in gens.items()}
    gen_err = float((outs[dev] - outs[torch.device("cpu")]).abs().max())
    res["generator_cuda_vs_cpu_max_abs"] = gen_err
    res["generator_infer_ms"] = cuda_time(
        lambda: infer(gens[dev], t(src, dev), t(raw, dev), t(aud, dev)), 5)
    st = stage2.init_stage2_state(s, seed=0, device=dev)
    step = stage2.make_train_step(s)
    tgt = t(imread(os.path.join(ds_dir, "com_imgs", f"{PIPELINE_FRAMES}.jpg"))[None] / 255.0, dev)
    res["generator_train_step_ms"] = cuda_time(
        lambda: step(st, t(src, dev), t(raw, dev), tgt, t(aud, dev)), 5)
    f_inf, f_step = generator_flops(size)
    res["generator_flops"] = {"inference": f_inf, "train_step": f_step}
    print(f"generator {size}x{size}: card against CPU max |d| {gen_err:.3e} (gate {GEN_CPU_GATE}); "
          f"ms per inference {res['generator_infer_ms']:.2f} ({f_inf / 1e12:.3f} TFLOP, "
          f"{f_inf / res['generator_infer_ms'] / 1e9:.1f} TFLOP/s), per train step "
          f"{res['generator_train_step_ms']:.2f} ({f_step / 1e12:.3f} TFLOP, "
          f"{f_step / res['generator_train_step_ms'] / 1e9:.1f} TFLOP/s)", flush=True)
    if not gen_err <= GEN_CPU_GATE:
        return f"the generator on the card is {gen_err:.3e} from the CPU's"
    del gens, st

    # metrics: the val frames against the refined ones, LPIPS on the card
    gt_dir = os.path.join(out, "gt_val")
    os.makedirs(gt_dir)
    for w in written:
        shutil.copy(os.path.join(ds_dir, "com_imgs", os.path.basename(w)), gt_dir)
    params = lpips.random_params(0)
    pth = os.path.join(out, "lpips_random.pth")
    sd = {}
    for li, ci in enumerate([0, 3, 6, 8, 10]):
        sd[f"net.slice{[1, 1, 2, 3, 4][li]}.{ci}.weight"] = torch.from_numpy(params["convs"][li]["w"])
        sd[f"net.slice{[1, 1, 2, 3, 4][li]}.{ci}.bias"] = torch.from_numpy(params["convs"][li]["b"])
        sd[f"lin{li}.model.1.weight"] = torch.from_numpy(params["lins"][li][None, :, None, None])
    torch.save(sd, pth)
    old = os.environ.get("SAHS_LPIPS_WEIGHTS")
    os.environ["SAHS_LPIPS_WEIGHTS"] = pth
    try:
        summary = metrics.two_folders(gt_dir, refined, device=dev)
    finally:
        if old is None:
            del os.environ["SAHS_LPIPS_WEIGHTS"]
        else:
            os.environ["SAHS_LPIPS_WEIGHTS"] = old
    with open(os.path.join(refined, "metrics.txt")) as fp:
        means = [float(l.rsplit("\t", 1)[1]) for l in fp.read().splitlines()
                 if l.startswith(" mean")]
    a = imread(os.path.join(gt_dir, os.path.basename(written[0])))[..., :3] / 255
    b = imread(written[0])[..., :3] / 255
    nets = {d: lpips.LpipsNet(params, d) for d in (dev, torch.device("cpu"))}
    lp = {d: lpips.lpips_distance(n, a, b) for d, n in nets.items()}
    lp_err = abs(lp[dev] - lp[torch.device("cpu")]) / abs(lp[torch.device("cpu")])
    res.update(metrics=summary, lpips_cuda_vs_cpu_rel=lp_err,
               lpips_ms=cuda_time(lambda: lpips.lpips_distance(nets[dev], a, b), 5))
    t0 = time.perf_counter()
    for _ in range(3):
        metrics.ssim(a, b)
    res["ssim_ms"] = (time.perf_counter() - t0) * 1e3 / 3
    print(f"metrics: {summary}; LPIPS card against CPU {lp_err:.3e} relative "
          f"(gate {LPIPS_CPU_GATE}); ms a frame: SSIM {res['ssim_ms']:.1f} (host), LPIPS "
          f"{res['lpips_ms']:.2f}", flush=True)
    if len(means) != 4 or not all(math.isfinite(m) for m in means) or summary["LPIPS"] is None:
        return f"metrics.txt's means are not four finite numbers: {means}"
    if not lp_err <= LPIPS_CPU_GATE:
        return f"LPIPS on the card is {lp_err:.3e} from the CPU's"
    report["pipeline"] = res
    for kk in kernels:
        key = next((k for k, r in PIPELINE_KERNELS.items() if r == kk["replaces"]), None)
        if key:
            kk.setdefault("launches_by_path", {"earlier paths": kk["launches"]})
            kk["launches_by_path"]["serving CLI (phase 17)"] = launches[key]
            kk["launches"] += launches[key]
    return ""


def generator_flops(size: int) -> tuple:
    """(forward, train step) operations of the audio generator at
    size x size: torch.utils.flop_counter over a forward in eval mode, and
    over a train-mode forward, the MSE loss and its gradients, on meta
    tensors (nothing is computed)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from sahs_tpu_torch.models import spade
    g = spade.Generator(audio=True).to("meta")
    for m in g.modules():
        if isinstance(m, spade.SNConv):
            m.u = torch.empty(m.w.shape[0], device="meta")
    x = torch.empty(1, 3, size, size, device="meta")
    a = torch.empty(16, 29, device="meta")
    with FlopCounterMode(display=False) as fwd:
        g(x, x, a, train=False)
    with FlopCounterMode(display=False) as step:
        y = g(x, x, a, train=True).clamp(0.0, 1.0)
        torch.autograd.grad((y - x).square().mean(), list(g.parameters()), allow_unused=True)
    return fwd.get_total_flops(), step.get_total_flops()


def _leaves(tree) -> list:
    """A section tree's leaves in key order (dicts sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


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
        from sahs_tpu_torch.utils.device import card_line
    except ImportError as e:
        return fail(f"the sahs_tpu_torch package is not beside this script ({e})")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    report = {"device": torch.cuda.get_device_name(0),
              "nvidia_smi": card_line()}
    print(f"device: {report['device']} | {report['nvidia_smi']} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 1. build --------------------------------------------------------------
    t0 = time.time()
    _build.build_all()
    report["build_s"] = time.time() - t0
    print(f"kernel build: {report['build_s']:.1f} s", flush=True)
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
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
            k1_args = (pts, pair, compute_dtype, S, dims)
            k5_args = (out_p, rd, table, rows_p, z, bgr, noise, lw, compute_dtype, dims)
            if compute_dtype == "bfloat16":
                row["k1_exact"] = pair_exact(k1_args, out_k, out_p)
                row["k5_exact"] = level_exact(k5_args, rgb_k, w_k, rgb_p, w_p)
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
            elif not (row["k1_exact"]["ok"] and row["k5_exact"]["ok"]):
                return fail(f"bf16 parity gate ({EXACT_MULTIPLE} x the plain version's "
                            f"distance to exact sums) missed: {row}")
            elif noise is not None:
                faults = {**pair_planted_faults(k1_args), **level_planted_faults(k5_args)}
                report["k1_k5_planted_faults"] = faults
                print("K1 / K5 planted faults (bf16, 2048 rays x 64; each must miss the "
                      "exact-sum rule) " + json.dumps(faults), flush=True)
                passed = [k for k, e in faults.items() if fault_passes(e)]
                if passed:
                    return fail(f"the bf16 K1 / K5 gates pass a planted fault: {passed}")
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
            "k1_exact": pair_exact((pts_t, pair, "bfloat16", S_t, dims), out_k1, packed_t),
            "k5_exact": level_exact((packed_t, rd_t, table_bf, rows_t, z_t, bg_t, None, lw,
                                     "bfloat16", dims), rgb_k5, w_k5, rgb_p5, w_p5),
            "finite": bool(torch.isfinite(out_k1).all() and torch.isfinite(rgb_k5).all()
                           and torch.isfinite(w_k5).all())}
    report["parity_fine_chunk"] = fine
    print(f"parity at the fine chunk ({R_t} rays x {S_t}, bfloat16) "
          + json.dumps(fine), flush=True)
    if not (fine["finite"] and fine["k1_exact"]["ok"] and fine["k5_exact"]["ok"]) \
            or fine["k1_rows_self_mismatch"] or max(
                fine["k1_scaled_warp"], fine["k1_scaled_ambient"],
                fine["k5_rgb_rel"], fine["k5_w_rel"]) > BF16_GATE:
        return fail(f"bf16 parity gate ({EXACT_MULTIPLE} x the plain version's distance "
                    f"to exact sums, {BF16_GATE} rel of the plain version, rows of "
                    f"K1's own output) missed at the fine chunk: {fine}")
    err_k1 = fine["k1_abs"]
    err_k5 = max(fine["k5_rgb_abs"], fine["k5_w_abs"])
    del out_k1, rows_k1, rgb_k5, w_k5, rgb_p5, w_p5
    kernels = []
    for name, src, replaces, fk, fp, fc, macs, in_bytes, out_bytes, err in (
            ("deform_pair", "sahs_tpu_torch/csrc/deform_pair.cu",
             "sahs_tpu/ops/pallas/field_mlp.py:868", f_k1, f_k1p, f_k1c,
             k1_macs(pair) * P, P * 3 * 4, P * (5 + 1) * 4, err_k1),
            ("nerf_level", "sahs_tpu_torch/csrc/level_train.cu",
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
    # bf16 K5 is two launches a call: the raw field and the compositing
    from sahs_tpu_torch.utils.device import device_ms_by_kernel
    kernels[1]["launch_ms"] = device_ms_by_kernel(f_k5, launches=reps,
                                                     counter=k5.nerf_level_forward)
    print(f"nerf_level's launches at the fine chunk (device ms, torch.profiler): "
          f"{json.dumps(kernels[1]['launch_ms'])}", flush=True)
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
    from sahs_tpu_torch.ops.kernels import points as k15
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
    draws = make_draws(256, H * W, 3, dev)
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
        with plain_versions(fused_swaps()) if plain else contextlib.nullcontext():
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
                "nerf_level": k5.nerf_level_forward, "build_pts": k15.build_pts}
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
                "grid_dg": 1, "nerf_level": 0, "build_pts": 2}
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
        packed_l, _, gse_l, gse2_l, _ = inp["k4"]
        return grid_sample_library(pmodel, packed_l, gse_l + gse2_l)

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
              + (f", plain {plain:.2f} ms, library {lib:.2f} ms" if fp else "")
              + f"; {flops / (ms / 1e3) / 1e12:.1f} TFLOP/s, {100 * b_ms / ms:.2f} % "
              "of the bound)", flush=True)
    train_kernels["grid_dg"]["launch_ms"] = grid_launch_ms(lambda: k4.grid_dg(*inp["k4"]), k4.grid_dg)
    print(f"grid_dg's launches at the step's shapes (device ms, torch.profiler): "
          f"{json.dumps(train_kernels['grid_dg']['launch_ms'])}", flush=True)
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
                        "coarse_ms": line.get("coarse_ms"),
                        "tflops_achieved": line["tflops_achieved"],
                        **{k: line[k] for k in ("launch_ms",) if k in line}})

    del inp, step_inp, lv_c, lv_f
    torch.cuda.empty_cache()

    # 7. fallback-kernel parity ---------------------------------------------
    fb_parity, missed = [], []
    for compute_dtype, R_p, sup in (("float32", 256, 0.0), ("float32", 256, 0.5),
                                    ("bfloat16", 2048, 0.0)):
        finp = fallback_level_inputs(pmodel, ds, near, far, dev, R_p, compute_dtype,
                                     gen, sup)
        res, outs = fallback_kernel_parity(finp)
        row = {"dtype": compute_dtype, "rays": R_p, "samples": "64+64",
               "bg_sup": sup, **res}
        fb_parity.append(row)
        print("fallback parity " + json.dumps(row), flush=True)
        missed += [f"{m} ({compute_dtype}, {R_p} rays, bg_sup {sup})"
                   for m in fallback_gates_missed(res, compute_dtype)]
        if compute_dtype == "bfloat16":
            fb_inp, fb_res = finp, res
            faults = fallback_planted_faults(finp, outs)
            report["fallback_planted_faults"] = faults
            print("fallback planted faults (bf16, main path's shapes; each must miss "
                  "the gates) " + json.dumps(faults), flush=True)
            missed += [f"the gates pass a planted fault: {k}"
                       for k, e in faults.items() if fault_passes(e)]
        del outs
    report["fallback_parity"] = fb_parity
    abl = ablation_parity(dev, gen)
    report["ablation_parity"] = abl
    print("ablation config parity (f32, rows from _cell_geometry on the card) "
          + json.dumps(abl), flush=True)
    missed += ablation_gates_missed(abl)
    # path 3's own K5 / K6 inputs and loss cotangents (f32 at 256 rays, bf16
    # at the step's 2048), and K5 in bf16 at the ablation frame's chunk
    abl_path = []
    for compute_dtype, R_p in (("float32", 256), ("bfloat16", 2048)):
        abl_levels = ablation_level_inputs(dev, gen, R_p, compute_dtype, 0.5)
        res = ablation_kernel_parity(abl_levels)
        abl_path.append({"dtype": compute_dtype, "rays": R_p, "samples": "64+64",
                         "bg_sup": 0.5, **res})
        print("ablation path parity " + json.dumps(abl_path[-1]), flush=True)
        missed += [f"ablation {m} ({compute_dtype}, {R_p} rays)"
                   for m in fallback_gates_missed(res, compute_dtype)]
        if compute_dtype == "bfloat16":
            faults = level_planted_faults(abl_levels["fine"]["fwd"])
            report["ablation_planted_faults"] = faults
            print("ablation K5 planted faults (bf16, path 3's fine level; each must "
                  "miss the exact-sum rule) " + json.dumps(faults), flush=True)
            missed += [f"the gates pass a planted fault: ablation {k}"
                       for k, e in faults.items() if fault_passes(e)]
        del abl_levels
    res = ablation_frame_chunk_parity(dev, gen)
    abl_path.append({"dtype": "bfloat16", "frame chunk": True, **res})
    print("ablation frame-chunk parity " + json.dumps(res), flush=True)
    missed += [f"ablation {m} (bfloat16, frame chunk)"
               for m in fallback_gates_missed(res, "bfloat16")]
    report["ablation_path_parity"] = abl_path
    torch.cuda.empty_cache()

    # whole float32 steps (256 rays): the fallback on both of its paths
    # through the kernels against the same step on the plain versions, and
    # the fused step against the fallback step, both through the kernels
    def fb_step(swaps, d=None, num_fine=64, **runtime):
        return run_step(dev, batch, draws if d is None else d,
                        path_cfg("flagship", 256, "float32", num_fine=num_fine,
                                 **runtime), swaps)

    fb_steps = {"fallback": fb_step(None, fused_grads=False),
                "fallback, plain": fb_step(fallback_swaps(), fused_grads=False),
                "reuse": fb_step(None, fused_grads=False, fuse_composite=False),
                "reuse, plain": fb_step(fallback_swaps(), fused_grads=False,
                                        fuse_composite=False),
                "fused": fb_step(None)}
    fb_check = {}
    for name in ("fallback", "reuse"):
        k_, p_ = fb_steps[name], fb_steps[name + ", plain"]
        fb_check[name] = {"launches": k_[2], "loss_rel": abs(k_[0] - p_[0]) / abs(p_[0]),
                          "kernels_vs_plain": tree_errors(k_[1], p_[1])}
        if (fb_check[name]["loss_rel"] > STEP_GATES["loss_rel"]
                or not dw_ok(fb_check[name]["kernels_vs_plain"], STEP_GATES)):
            missed.append(f"f32 {name} step, kernels vs plain versions: {fb_check[name]}")
    fb_check["fused_vs_fallback"] = {
        "loss_rel": abs(fb_steps["fused"][0] - fb_steps["fallback"][0])
        / abs(fb_steps["fallback"][0]),
        "launches": fb_steps["fused"][2],
        "grads": tree_errors(fb_steps["fused"][1], fb_steps["fallback"][1])}
    if not dw_ok(fb_check["fused_vs_fallback"]["grads"], FUSED_VS_FALLBACK):
        missed.append(f"f32 fused step vs fallback step: {fb_check['fused_vs_fallback']}")
    want = {"fallback": {"K1": 2, "K3": 2, "K5": 2, "K6": 2, "K9": 2},
            "reuse": {"K1": 2, "K3": 2, "K7": 2, "K8": 2, "K9": 2}}
    for name, w in want.items():
        if fb_check[name]["launches"] != w:
            missed.append(f"f32 {name} step launched {fb_check[name]['launches']}, not {w}")
    report["fallback_steps_f32"] = fb_check
    print("fallback steps f32 (256 rays), every gradient leaf against the plain "
          "step on the card, and the fused step against the fallback step "
          + json.dumps(fb_check), flush=True)
    if missed:
        return fail(f"fallback-kernel gates missed: {missed}")
    del fb_steps
    torch.cuda.empty_cache()

    # 8. the fallback's paths on the card ------------------------------------
    from sahs_tpu_torch.config import load_config
    from sahs_tpu_torch.render.pipeline import render_rays_chunked

    def time_path(cfg_p, ds_p, expect, n_steps=5):
        spec_p = nerface.ModelSpec.from_config(cfg_p)
        ts_p = stage1.TrainSettings.from_config(cfg_p)
        st = stage1.init_train_state(spec_p, ts_p, seed=0, device=dev)
        step_p = stage1.make_train_step(spec_p, ts_p, device=dev)
        b = {k: torch.as_tensor(v).to(dev)
             for k, v in dict(ds_p[0], background=ds_p.background()).items()
             if k != "fname"}
        g_t = torch.Generator(device=dev).manual_seed(5)
        for _ in range(2):                                # warm-up
            st, _ = step_p(st, b, generator=g_t)
        torch.cuda.synchronize()
        held = kernel_counters()
        for f in held.values():
            f.launches = 0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        losses = []
        t_host = time.time()
        ev[0].record()
        for _ in range(n_steps):
            st, m = step_p(st, b, generator=g_t)
            losses.append(m["loss"])
        ev[1].record()
        torch.cuda.synchronize()
        per_step = {k: f.launches / n_steps for k, f in held.items()}
        ms = ev[0].elapsed_time(ev[1]) / n_steps
        ok = {"launches": per_step == {k: expect.get(k, 0) for k in held},
              "loss_finite": all(bool(torch.isfinite(l)) for l in losses),
              "params_finite": all(bool(torch.isfinite(p).all())
                                   for p in st.model.parameters())}
        return {"rays": ts_p.num_random_rays, "samples":
                f"{ts_p.render.num_coarse}+{ts_p.render.num_fine}",
                "dtype": (ts_p.render.compute_dtype if ts_p.render.use_pallas
                          else "float32 (plain path)"), "steps": n_steps, "ms": ms,
                "host_ms": (time.time() - t_host) * 1e3 / n_steps,
                "rays_per_s": ts_p.num_random_rays / (ms / 1e3),
                "launches_per_step": per_step, "loss": float(losses[-1]),
                "checks": ok}

    def time_frame(render_fn, expect):
        render_fn()                                      # warm-up
        torch.cuda.synchronize()
        held = kernel_counters()
        for f in held.values():
            f.launches = 0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t_host = time.time()
        ev[0].record()
        out = render_fn()
        ev[1].record()
        torch.cuda.synchronize()
        rgb = out["rgb_fine"] if isinstance(out, dict) else out.rgb_fine
        launches = {k: f.launches for k, f in held.items()}
        return {"ms": ev[0].elapsed_time(ev[1]), "host_ms": (time.time() - t_host) * 1e3,
                "launches": launches,
                "checks": {"launches": launches == {k: expect.get(k, 0) for k in held},
                           "finite": bool(torch.isfinite(rgb).all()),
                           "range": bool(rgb.min() >= -1e-6 and rgb.max() <= 1 + 1e-5)}}

    paths = {}
    cfg1 = Config()
    cfg1.runtime.fused_grads = False
    paths["1 fallback step"] = time_path(cfg1, ds, {"K1": 2, "K3": 2, "K5": 2, "K6": 2,
                                                    "K9": 2})
    cfg2 = Config()
    cfg2.runtime.fused_grads = False
    cfg2.runtime.fuse_composite = False
    paths["2 reuse step"] = time_path(cfg2, ds, {"K1": 2, "K3": 2, "K7": 2, "K8": 2,
                                                 "K9": 2})
    s2 = RenderSettings.from_config(cfg2, "validation")
    ro_r, rd_r, bg_r, _ = frame_rays(ds, 0, dev, n=32768)
    drv, pose = (torch.as_tensor(item[k]).to(dev) for k in ("driving", "pose"))
    paths["2 reuse frame chunk"] = time_frame(
        lambda: render_rays_chunked(model, s2, ro_r, rd_r, near, far, drv, pose,
                                    background_prior=bg_r, chunksize=32768),
        {"K1": 2, "K7": 2})
    cfg3 = load_config(os.path.join(REPO, "configs", "expression",
                                    "person_1_ablation.yml"))
    spec3 = nerface.ModelSpec.from_config(cfg3)
    near3, far3 = float(cfg3.dataset.near), float(cfg3.dataset.far)
    ds3 = SyntheticFaceDataset(kind="expression", num_frames=1, H=H, W=W,
                               near=near3, far=far3)
    paths["3 ablation step"] = time_path(cfg3, ds3, {"K5": 2, "K6": 2, "K9": 2})
    s3 = RenderSettings.from_config(cfg3, "validation")
    model3 = nerface.NeRFaceModel.init(spec3, seed=0, device=dev)
    render3 = make_eval_renderer(spec3, s3, H, W, near3, far3, device=dev)
    item3 = ds3[0]
    n3 = math.ceil(H * W / min(s3.chunksize, 32768))
    paths["3 ablation frame"] = time_frame(
        lambda: render3(model3, item3["intrinsics"], item3["pose"], item3["driving"],
                        ds3.background()), {"K5": 2 * n3})
    report["fallback_paths"] = paths
    for name, r in paths.items():
        print(f"path {name}: {r['ms']:.1f} ms on the card (CUDA events), "
              f"{r['host_ms']:.1f} ms on the host clock, launches "
              f"{r.get('launches_per_step', r.get('launches'))}"
              + (" per step" if "launches_per_step" in r else ""), flush=True)
    bad = {n: r["checks"] for n, r in paths.items() if not all(r["checks"].values())}
    if bad:
        return fail(f"fallback path checks failed: {bad}")

    # per-kernel times of K6-K9 at the paths' shapes (2048 rays, bf16)
    from sahs_tpu_torch.ops.grid import interp_corners
    R_s = fb_inp["R"]

    def fb_library(args, nerf_name, kind):
        """One chain of PyTorch calls for the same function under bf16
        autocast (a yardstick the port never calls): the plain forward
        (K7), and autograd of it from the same cotangents (K8; K6 through
        the plain compositing)."""
        packed_l, rd_l, table_l, rows_l = args[:4]
        wts = args[9] if kind == "k6" else args[-3]
        S_l = packed_l.shape[0] // R_s
        x = kernel_pe(packed_l, wts.pts_groups).requires_grad_()
        dpe = kernel_pe(rd_l, wts.dir_groups).repeat_interleave(S_l, dim=0)
        _, fs, ok = _cell_geometry(packed_l, fb_inp["dims"])
        se = interp_corners(table_l[rows_l.reshape(-1).long()], fs, ok).requires_grad_()
        nerf = getattr(pmodel, nerf_name)
        params = [x, se] + list(nerf.parameters())

        def run():
            with torch.set_grad_enabled(kind != "k7"), torch.autocast("cuda", dtype=torch.bfloat16):
                raw = nerf(x, dpe, driving=driving_s, pose=pose_s, spatial_embedding=se)
            if kind == "k7":
                return raw
            if kind == "k8":
                return torch.autograd.grad(raw.float(), params, args[4])
            z_l, bg_l, noise_l, g_rgb, g_w = args[4], args[5], args[6], args[7], args[8]
            rgb_l, w_l = composite_plain(raw.float().reshape(R_s, S_l, 16), z_l, rd_l,
                                         bg_l, noise_l)
            return torch.autograd.grad([rgb_l, w_l], params, [g_rgb, g_w])
        return run

    def fb_bytes(args, kind):
        packed_l, rd_l, table_l = args[:3]
        P_l, PW = packed_l.shape
        S_l = P_l // R_s
        b_in = P_l * (PW + 1) * 4 + R_s * 3 * 4 + table_l.numel() * table_l.element_size()
        if kind == "k7":
            return b_in + P_l * 16 * 4
        plan = k2.level_train_plan(args[9] if kind == "k6" else args[-3], torch.bfloat16)
        b_out = P_l * (PW + 32) * 4 + plan.out_len * 4
        if kind == "k8":
            return b_in + P_l * 16 * 4 + b_out
        return b_in + R_s * (3 * S_l + 15 + 16) * 4 + b_out + R_s * 15 * 4

    k6f, k6c = fb_inp["k6"]["fine"]["args"], fb_inp["k6"]["coarse"]["args"]
    lw6 = k6f[9]
    P_f, P_c = R_s * 128, R_s * 64
    macs7 = lambda P_l: k5_macs(lw6) * P_l + lw6.dir0_dir.numel() * R_s
    fb_kernels = {}
    for name, fk, fp, fl, fc, flops, nbytes, err in (
            ("nerf_level_vjp", lambda: k2.nerf_level_vjp(*k6f),
             lambda: k2.nerf_level_vjp_plain(*k6f), fb_library(k6f, "fine", "k6"),
             lambda: k2.nerf_level_vjp(*k6c), 2 * level_train_macs(lw6) * P_f,
             fb_bytes(k6f, "k6"), fb_res["k6_fine"]["max_abs_err"]),
            ("nerf_rayd_forward", lambda: k5.nerf_rayd_forward(*fb_inp["k7"]),
             lambda: k5.nerf_raw_plain(*fb_inp["k7"]), fb_library(fb_inp["k7"], "fine", "k7"),
             lambda: k5.nerf_rayd_forward(*fb_inp["k7_coarse"]), 2 * macs7(P_f),
             fb_bytes(fb_inp["k7"], "k7"), fb_res["k7"]["max_abs_err"]),
            ("nerf_rayd_vjp", lambda: k2.nerf_rayd_vjp(*fb_inp["k8"]),
             lambda: k2.nerf_rayd_vjp_plain(*fb_inp["k8"]),
             fb_library(fb_inp["k8"], "fine", "k8"),
             lambda: k2.nerf_rayd_vjp(*fb_inp["k8_coarse"]),
             2 * level_train_macs(lw6) * P_f, fb_bytes(fb_inp["k8"], "k8"),
             fb_res["k8"]["max_abs_err"]),
            ("grid_dg_coords", lambda: k4.grid_dg_coords(*fb_inp["k9"]),
             lambda: k4.grid_dg_coords_plain(*fb_inp["k9"]),
             grid_sample_library(pmodel, *fb_inp["k9"][:2]), None,
             2 * 8 * 32 * P_f, P_f * (3 + 32) * 4 + 32 ** 4 * 4,
             fb_res["k9"]["max_abs_err"])):
        ms = cuda_time(fk, 3)
        coarse = cuda_time(fc, 3) if fc is not None else None
        plain = cuda_time(fp, 1)
        lib = cuda_time(fl, 1)
        b_ms, b_by = bound(flops, nbytes)
        fb_kernels[name] = {"ms": ms, "coarse_ms": coarse, "plain_ms": plain,
                            "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by,
                            "max_abs_err": err,
                            "tflops_achieved": flops / (ms / 1e3) / 1e12}
        print(f"{name}: {ms:.2f} ms at the fine level's {P_f} points"
              + (f", {coarse:.2f} ms at the coarse level's {P_c}" if coarse else "")
              + f" (bound {b_ms:.3f} ms by {b_by}, plain {plain:.2f} ms, "
              f"library {lib:.2f} ms; {flops / (ms / 1e3) / 1e12:.1f} TFLOP/s, "
              f"{100 * b_ms / ms:.2f} % of the bound)", flush=True)
    fb_kernels["grid_dg_coords"]["launch_ms"] = grid_launch_ms(
        lambda: k4.grid_dg_coords(*fb_inp["k9"]), k4.grid_dg_coords)
    print(f"grid_dg_coords' launches at the fine level (device ms, torch.profiler): "
          f"{json.dumps(fb_kernels['grid_dg_coords']['launch_ms'])}", flush=True)
    report["fallback_kernels"] = fb_kernels
    path_launches = {k: sum(int(r.get("launches_per_step", {}).get(k, 0) * r.get("steps", 0)
                                + r.get("launches", {}).get(k, 0)) for r in paths.values())
                     for k in kernel_counters()}
    for kk in kernels:
        key = {"deform_pair": "K1", "nerf_level": "K5", "deform_pair_vjp": "K3"}.get(kk["name"])
        if key:
            kk.setdefault("launches_by_path", {"earlier paths": kk["launches"]})
            kk["launches_by_path"]["fallback paths"] = path_launches[key]
            kk["launches"] += path_launches[key]
    for name, key, src, replaces in (
            ("nerf_level_vjp", "K6", "sahs_tpu_torch/csrc/level_train.cu",
             "sahs_tpu/ops/pallas/field_mlp.py:2951"),
            ("nerf_rayd_forward", "K7", "sahs_tpu_torch/csrc/level_train.cu",
             "sahs_tpu/ops/pallas/field_mlp.py:1973"),
            ("nerf_rayd_vjp", "K8", "sahs_tpu_torch/csrc/level_train.cu",
             "sahs_tpu/ops/pallas/field_mlp.py:2059"),
            ("grid_dg_coords", "K9", "sahs_tpu_torch/csrc/grid_bwd.cu",
             "sahs_tpu/ops/pallas/grid_bwd.py:103")):
        line = fb_kernels[name]
        if not path_launches[key]:
            return fail(f"{key} {name} was not launched on its paths")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": path_launches[key],
                        **{k: line[k] for k in ("max_abs_err", "ms", "plain_ms",
                                                "bound_ms", "bound_by", "library_ms")},
                        "coarse_ms": line["coarse_ms"],
                        **{k: line[k] for k in ("launch_ms",) if k in line}})
    del fb_inp
    torch.cuda.empty_cache()

    # 9. per-point kernel parity ---------------------------------------------
    from sahs_tpu_torch.ops.kernels import nerf_mlp as k11
    pw_parity, missed = [], []
    for compute_dtype, R_p in (("float32", 256), ("bfloat16", 2048)):
        pinp = pointwise_inputs(pmodel, ds, near, far, dev, R_p, compute_dtype, gen)
        res, outs = pointwise_parity(pinp)
        row = {"dtype": compute_dtype, "rays": R_p, "samples": "64+128", **res}
        pw_parity.append(row)
        print("pointwise parity " + json.dumps(row), flush=True)
        missed += [f"{m} ({compute_dtype}, {R_p} rays)"
                   for m in fallback_gates_missed(res, compute_dtype)]
        if compute_dtype == "bfloat16":
            pw_inp, pw_res = pinp, res
            faults = pointwise_planted_faults(pinp, outs)
            report["pointwise_planted_faults"] = faults
            print("pointwise planted faults (bf16, the per-point step's shapes; each "
                  "must miss the gates) " + json.dumps(faults), flush=True)
            missed += [f"the gates pass a planted fault: {k}"
                       for k, e in faults.items() if fault_passes(e)]
        del outs
    report["pointwise_parity"] = pw_parity
    # whole float32 steps (256 rays) through the kernels against the same
    # steps on the plain versions: the per-point step (64 + 128: the coarse
    # level on K5/K6, the fine level per point) and the plain path's
    draws_pw = make_draws(256, H * W, 4, dev, Sn=128)
    pw_steps = {"pointwise": fb_step(None, d=draws_pw, num_fine=128),
                "pointwise, plain": fb_step(fallback_swaps(), d=draws_pw, num_fine=128),
                "plain path": fb_step(None, use_pallas=False),
                "plain path, plain": fb_step(fallback_swaps(), use_pallas=False)}
    pw_check = {}
    want = {"pointwise": {"K1": 2, "K3": 2, "K5": 1, "K6": 1, "K9": 1, "K10": 1,
                          "K11": 1, "K12": 1},
            "plain path": {"K10": 2}}
    for name, w in want.items():
        k_, p_ = pw_steps[name], pw_steps[name + ", plain"]
        pw_check[name] = {"launches": k_[2], "loss_rel": abs(k_[0] - p_[0]) / abs(p_[0]),
                          "kernels_vs_plain": tree_errors(k_[1], p_[1])}
        if (pw_check[name]["loss_rel"] > STEP_GATES["loss_rel"]
                or not dw_ok(pw_check[name]["kernels_vs_plain"], STEP_GATES)):
            missed.append(f"f32 {name} step, kernels vs plain versions: {pw_check[name]}")
        if k_[2] != w:
            missed.append(f"f32 {name} step launched {k_[2]}, not {w}")
    report["pointwise_steps_f32"] = pw_check
    print("per-point and plain-path steps f32 (256 rays), every gradient leaf "
          "against the plain step on the card " + json.dumps(pw_check), flush=True)
    if missed:
        return fail(f"per-point kernel gates missed: {missed}")
    del pw_steps
    torch.cuda.empty_cache()

    # 10. the per-point branch and the plain path on the card ----------------
    cfg_pf = Config()
    cfg_pf.nerf.validation.num_fine = 128
    s_pf = RenderSettings.from_config(cfg_pf, "validation")
    assert (s_pf.use_pallas and s_pf.compute_dtype == "bfloat16"
            and (s_pf.num_coarse, s_pf.num_fine) == (64, 128))
    render_pf = make_eval_renderer(spec, s_pf, H, W, near, far, device=dev)
    n_pf = math.ceil(H * W / min(s_pf.chunksize, 32768))
    pw_paths = {"1 per-point frame": time_frame(
        lambda: render_pf(*args), {"K1": 2 * n_pf, "K5": n_pf, "K11": n_pf})}
    cfg_ps = Config()
    cfg_ps.nerf.train.num_fine = 128
    pw_paths["2 per-point step"] = time_path(
        cfg_ps, ds, {"K1": 2, "K3": 2, "K5": 1, "K6": 1, "K9": 1, "K10": 1,
                     "K11": 1, "K12": 1})
    cfg_pl = Config()
    cfg_pl.runtime.use_pallas = False
    pw_paths["3 plain-path step"] = time_path(cfg_pl, ds, {"K10": 2})
    report["pointwise_paths"] = pw_paths
    for name, r in pw_paths.items():
        print(f"path {name}: {r['ms']:.1f} ms on the card (CUDA events), "
              f"{r['host_ms']:.1f} ms on the host clock, launches "
              f"{r.get('launches_per_step', r.get('launches'))}"
              + (" per step" if "launches_per_step" in r else ""), flush=True)
    bad = {n: r["checks"] for n, r in pw_paths.items() if not all(r["checks"].values())}
    if bad:
        return fail(f"per-point path checks failed: {bad}")

    # per-kernel times: K11 at the frame's fine chunk (32,768 rays x 192),
    # K12 and K10 at the per-point step's fine level (2048 rays x 192), bf16
    from sahs_tpu_torch.ops.grid import grid_sample_3d
    from sahs_tpu_torch.ops.sampling import coarse_z_vals, sample_pdf
    R_f = min(s_pf.chunksize, 32768)
    ro_f, rd_f, _, _ = frame_rays(ds, 0, dev, n=R_f)
    z_fc = coarse_z_vals(torch.full((R_f,), near, device=dev),
                         torch.full((R_f,), far, device=dev), 64, perturb=True,
                         t_rand=torch.rand((R_f, 64), generator=gen).to(dev))
    z_fn = sample_pdf(0.5 * (z_fc[:, 1:] + z_fc[:, :-1]),
                      torch.rand((R_f, 62), generator=gen).to(dev), 128,
                      u=torch.rand((R_f, 128), generator=gen).to(dev))
    z_f = torch.sort(torch.cat([z_fc, z_fn], -1), dim=-1).values
    S_f = z_f.shape[1]
    P_fr = R_f * S_f
    with torch.no_grad():
        packed_f, _ = k1.deform_pair_forward(
            (ro_f[:, None, :] + rd_f[:, None, :] * z_f[..., None]).reshape(-1, 3),
            pair, "bfloat16", S_f, dims)
        extra_f = torch.cat([rd_f.repeat_interleave(S_f, dim=0),
                             grid_sample_3d(grid, packed_f, "bfloat16")], dim=-1)
    del z_fc, z_fn
    lw_f = k5.prepare_level(model.fine, pose_enc, pts_g, dir_g)
    f_k11 = lambda: k11.nerf_mlp_forward_fused(packed_f, extra_f, lw_f, "bfloat16")
    f_k11p = lambda: k11.nerf_mlp_plain(packed_f, extra_f, lw_f, "bfloat16")
    out_k, out_p = f_k11(), f_k11p()
    err_frame, abs_frame = scaled_err(out_k, out_p), abs_err(out_k, out_p)
    del out_k, out_p
    report["k11_frame_chunk_scaled_err"] = err_frame
    print(f"K11 at the frame's fine chunk ({P_fr} points, bfloat16): max |a - b| / "
          f"max |b| {err_frame:.2e}, max abs {abs_frame:.2e}", flush=True)
    if err_frame > BF16_GATE:
        return fail(f"K11 at the frame's fine chunk: {err_frame} of scale > {BF16_GATE}")

    def point_library(nerf, x_raw, e_raw, wts, g=None):
        """The plain forward of the NeRF module under bf16 autocast, and with
        ``g`` autograd of it (a yardstick the port never calls)."""
        x = kernel_pe(x_raw, wts.pts_groups)
        dpe = kernel_pe(e_raw[:, :3], wts.dir_groups)
        se = e_raw[:, 3:]
        if g is not None:
            x, se = x.requires_grad_(), se.clone().requires_grad_()
        params = [x, se] + list(nerf.parameters())

        def run():
            with torch.set_grad_enabled(g is not None), \
                    torch.autocast("cuda", dtype=torch.bfloat16):
                raw = nerf(x, dpe, driving=driving_s, pose=pose_s, spatial_embedding=se)
            return raw if g is None else torch.autograd.grad(raw.float(), params, g)
        return run

    packed_s, extra_s, g_s, lw_s, _ = pw_inp["k12"]
    P_s = packed_s.shape[0]
    k12_plan = k2.level_train_plan(lw_s, torch.bfloat16)
    macs_p = point_mlp_macs(lw_s)
    pw_kernels = {}
    for name, fk, fp, fl, flops, nbytes, err, P_l in (
            ("nerf_mlp_forward_fused", f_k11, f_k11p,
             point_library(model.fine, packed_f, extra_f, lw_f),
             2 * macs_p * P_fr, P_fr * (5 + 35 + 16) * 4, abs_frame, P_fr),
            ("nerf_mlp_vjp", lambda: k2.nerf_mlp_vjp(*pw_inp["k12"]),
             lambda: k2.nerf_mlp_vjp_plain(*pw_inp["k12"]),
             point_library(pmodel.fine, packed_s, extra_s, lw_s, g_s),
             2 * 3 * macs_p * P_s,
             P_s * (5 + 35 + 16 + 5 + 35) * 4 + k12_plan.out_len * 4,
             pw_res["k12"]["max_abs_err"], P_s),
            ("grid_bwd_fused", lambda: k4.grid_bwd_fused(*pw_inp["k10"]),
             lambda: k4.grid_bwd_fused_plain(*pw_inp["k10"]),
             grid_sample_library(pmodel, packed_s, pw_inp["k10"][2]),
             2 * 2 * 8 * 32 * P_s, P_s * (3 * 4 + 32 * 4 + 8 * 32 * 2 + 3 * 4) + 32 ** 4 * 4,
             pw_res["k10"]["max_abs_err"], P_s)):
        ms = cuda_time(fk, 3)
        plain = cuda_time(fp, 1)
        lib = cuda_time(fl, 1)
        b_ms, b_by = bound(flops, nbytes)
        pw_kernels[name] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                            "points": P_l, "tflops_achieved": flops / (ms / 1e3) / 1e12}
        print(f"{name}: {ms:.2f} ms at {P_l} points (bound {b_ms:.3f} ms by {b_by}, "
              f"plain {plain:.2f} ms, library {lib:.2f} ms; "
              f"{flops / (ms / 1e3) / 1e12:.1f} TFLOP/s, {100 * b_ms / ms:.2f} % of "
              "the bound)", flush=True)
    pw_kernels["grid_bwd_fused"]["launch_ms"] = grid_launch_ms(
        lambda: k4.grid_bwd_fused(*pw_inp["k10"]), k4.grid_bwd_fused)
    print(f"grid_bwd_fused's launches at the per-point step's fine level (device ms, "
          f"torch.profiler): {json.dumps(pw_kernels['grid_bwd_fused']['launch_ms'])}",
          flush=True)
    report["pointwise_kernels"] = pw_kernels
    del packed_f, extra_f
    pw_launches = {k: sum(int(r.get("launches_per_step", {}).get(k, 0) * r.get("steps", 0)
                              + r.get("launches", {}).get(k, 0)) for r in pw_paths.values())
                   for k in kernel_counters()}
    names = {"deform_pair": "K1", "deform_pair_vjp": "K3", "nerf_level": "K5",
             "nerf_level_vjp": "K6", "grid_dg_coords": "K9"}
    for kk in kernels:
        key = names.get(kk["name"])
        if key and pw_launches[key]:
            kk.setdefault("launches_by_path", {"earlier paths": kk["launches"]})
            kk["launches_by_path"]["per-point and plain paths"] = pw_launches[key]
            kk["launches"] += pw_launches[key]
    for name, key, src, replaces in (
            ("grid_bwd_fused", "K10", "sahs_tpu_torch/csrc/grid_bwd.cu",
             "sahs_tpu/ops/pallas/grid_bwd.py:343"),
            ("nerf_mlp_forward_fused", "K11", "sahs_tpu_torch/csrc/level_train.cu",
             "sahs_tpu/ops/pallas/field_mlp.py:3204"),
            ("nerf_mlp_vjp", "K12", "sahs_tpu_torch/csrc/level_train.cu",
             "sahs_tpu/ops/pallas/field_mlp.py:1546")):
        line = pw_kernels[name]
        if not pw_launches[key]:
            return fail(f"{key} {name} was not launched on its paths")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": pw_launches[key],
                        **{k: line[k] for k in ("max_abs_err", "ms", "plain_ms",
                                                "bound_ms", "bound_by", "library_ms")},
                        **{k: line[k] for k in ("launch_ms",) if k in line}})
    del pw_inp
    torch.cuda.empty_cache()

    # 11. one-net and K15 parity -------------------------------------------
    missed = phase11_skip_parity(dev, batch, H * W, report)
    if missed:
        return fail(f"one-net and K15 gates missed: {missed}")
    torch.cuda.empty_cache()

    # 12. the one-net paths and the fused step on the card -----------------
    msg = phase12_skip_paths(dev, ds, near, far, time_path, time_frame, report,
                             kernels)
    if msg:
        return fail(msg)
    torch.cuda.empty_cache()

    # 13. grid-free parity ------------------------------------------------
    missed = phase13_grid_free_parity(dev, batch, H * W, report)
    if missed:
        return fail(f"grid-free gates missed: {missed}")
    torch.cuda.empty_cache()

    # 14. the grid-free paths on the card ----------------------------------
    msg = phase14_grid_free_paths(dev, ds, near, far, time_path, time_frame,
                                  report, kernels)
    if msg:
        return fail(msg)
    torch.cuda.empty_cache()

    # 15. the tools' experiment kernels X1-X6 -------------------------------
    msg = phase15_tools(dev, report, kernels)
    if msg:
        return fail(msg)
    torch.cuda.empty_cache()

    # 16. the Stage-I trainer's entry point --------------------------------
    msg = phase16_trainer(dev, report, kernels)
    if msg:
        return fail(msg)
    torch.cuda.empty_cache()

    # 17. what a user runs after Stage-I training, under torch's default
    # precision settings (cuDNN may use TF32), as a user's process has them:
    # Stage II's and LPIPS's entry points set full float32 themselves
    torch.backends.cudnn.allow_tf32 = True
    try:
        msg = phase17_pipeline(dev, report, kernels)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    if msg:
        return fail(msg)
    if len(kernels) != 21:
        return fail(f"the kernels line lists {len(kernels)} kernels, not 21")
    print(f"smoke run: {time.time() - T_START:.0f} s", flush=True)

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
