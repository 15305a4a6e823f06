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
     frame's kernel time.
Then it prints the `kernels` JSON line, the nvidia-smi name and power
limit, and as the last line {"ok": true, "device": {...}}. With --report
PATH, everything measured is also written to PATH as JSON.
"""
from __future__ import annotations

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

    if report_path is not None:
        os.makedirs(os.path.dirname(os.path.abspath(report_path)), exist_ok=True)
        with open(report_path, "w") as fp:
            json.dump(report, fp, indent=1)
    print(json.dumps({"kernels": [{k: v for k, v in kk.items()
                                   if k not in ("shape", "tflops_achieved", "coarse_ms")}
                                  for kk in kernels]}))
    print(report["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
