"""Closed-loop serving: one client renders full frames back to back through
the port's eval renderer (``evaluation.make_eval_renderer``), as a render
farm turns a driving track into video, and reads each frame's fine rgb |
seg back to the host as the eval CLI does.

Traffic keys: ``height``, ``width``; ``chunk`` (rays a chunk, passed to the
renderer, which fixes how its random draws fall); ``inputs`` (distinct
pose and driving inputs, cycled); ``warmup`` frames; ``check_frames``, the
frames a run judges, a reservoir sample of the window's drawn from the
seed; ``ref_block`` (rays a block of the reference); ``trace_from``,
``trace_frames``, ``trace_host_frames`` (the profiled slices of a
``--trace 1`` run, trace.Tracer).

A frame's time runs from the renderer's call to its rgb on the host; the
rate is rays of the frames completed over the window, which closes at the
end of the first frame to finish after ``--seconds``.
"""
from __future__ import annotations

import random
import time

import numpy as np
import torch

from port_bench import arith, inputs, kernels, trace as tr
from port_bench.reference import frames as ref_frames
from port_bench.reference.model import Field, full_float32
from port_bench.reference.precision import bf16_linear
from port_bench.weights import make_weights, sub_seed


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the closest ranks."""
    xs = sorted(values)
    k = (len(xs) - 1) * q / 100.0
    lo = int(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def frame_seed(seed: int, i: int) -> int:
    return sub_seed(seed, f"frame:{i}")


def rms(a: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean(a.double() ** 2)))


def make_inputs(ctx):
    """The run's weights and inputs: (weights, {intrinsics, poses, driving,
    background})."""
    t, dev = ctx.traffic, ctx.device
    near, far = float(ctx.cfg["dataset"]["near"]), float(ctx.cfg["dataset"]["far"])
    weights = make_weights(ctx.spec, ctx.seed, dev, near, far)
    data = {"intrinsics": inputs.intrinsics(t["width"], dev),
            "poses": inputs.poses(t["inputs"], 0.5 * (near + far), ctx.seed, dev),
            "driving": inputs.driving(t["inputs"], ctx.spec.audio, ctx.seed, dev),
            "background": inputs.background(t["height"], t["width"], ctx.seed, dev)}
    return weights, data


def build(ctx):
    """The port's model with the run's weights, its renderer, and the
    inputs: (model, render, inputs dict, weights)."""
    from sahs_tpu_torch.config import load_config
    from sahs_tpu_torch.evaluation import make_eval_renderer
    from sahs_tpu_torch.models.nerface import ModelSpec, NeRFaceModel
    from sahs_tpu_torch.render.pipeline import RenderSettings
    t, dev = ctx.traffic, ctx.device
    cfg = load_config(ctx.cfg)
    if dev.type == "cuda":
        kernels.build()
    weights, data = make_inputs(ctx)
    model = NeRFaceModel(ModelSpec.from_config(cfg)).to(dev)
    model.load_state_dict(weights, strict=True)
    model.eval()
    H, W = t["height"], t["width"]
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    render = make_eval_renderer(ModelSpec.from_config(cfg), RenderSettings.from_config(
        cfg, "validation"), H, W, near, far, chunksize=t["chunk"], device=dev)
    return model, render, data, weights


def run(ctx):
    t, dev = ctx.traffic, ctx.device
    model, render, data, weights = build(ctx)
    gen = torch.Generator(device=dev)
    n_in = t["inputs"]

    def frame(i):
        gen.manual_seed(frame_seed(ctx.seed, i))
        out = render(model, data["intrinsics"], data["poses"][i % n_in],
                     data["driving"][i % n_in], data["background"], gen)
        return out["rgb_fine"].detach().float().cpu().numpy()

    for i in range(t["warmup"]):
        frame(-1 - i)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - ctx.t_start

    pick = random.Random(sub_seed(ctx.seed, "check"))
    kept = []                     # reservoir of (index, frame)
    times = []
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    tracer = tr.Tracer(t["trace_from"], t["trace_frames"], t["trace_host_frames"], 1,
                       sync) if ctx.trace else None
    t0 = time.perf_counter()
    while True:
        i = len(times)
        if tracer:
            tracer.before(i)
        a = time.perf_counter()
        rgb = frame(i)
        b = time.perf_counter()
        times.append(b - a)
        if tracer:
            tracer.after(i)
        if len(kept) < t["check_frames"]:
            kept.append((i, rgb))
        else:
            j = pick.randrange(i + 1)
            if j < t["check_frames"]:
                kept[j] = (i, rgb)
        if b - t0 >= ctx.seconds and (tracer is None or tracer.done(i)):
            break
    window_s = b - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rays = t["height"] * t["width"]
    res = {"attempted": len(times), "failed": 0, "memory_peak_bytes": peak,
           "metrics": {"serve_rays_per_s": rays * len(times) / window_s,
                       "frame_ms_p90": 1e3 * percentile(times, 90), "setup_s": setup_s},
           "notes": [f"frames {len(times)} in {window_s:.3f} s; median "
                     f"{1e3 * percentile(times, 50):.3f} ms, p90 {1e3 * percentile(times, 90):.3f} "
                     f"ms, max {1e3 * max(times):.3f} ms; set-up {setup_s:.3f} s"]}
    if tracer:
        res["trace"] = tracer.out
        v = ctx.cfg["nerf"]["validation"]
        res["work"] = arith.frame_work(ctx.spec, rays, t["chunk"], v["num_coarse"],
                                       v["num_fine"])
    del model, render
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    res["checks"], dist = check(ctx, data, weights, kept)
    res["notes"].append("distances from the float32 reference (p: the program, b: the "
                        "reference with bf16 operands): " + ", ".join(
                            f"{k} {v!r}" for k, v in dist.items()))
    return res


def reference_frame(ctx, data, field, i):
    """Frame ``i`` of the window by the reference ``field``: (H * W, 15)."""
    t, cfg = ctx.traffic, ctx.cfg
    v = cfg["nerf"]["validation"]
    if v["radiance_field_noise_std"] != 0 or not v["perturb"]:
        raise ValueError("the frame reference draws as the renderer does with perturb on "
                         "and no sigma noise")
    return ref_frames.render_frame(
        field, t["height"], t["width"], data["intrinsics"], data["poses"][i % t["inputs"]],
        data["driving"][i % t["inputs"]], data["background"], float(cfg["dataset"]["near"]),
        float(cfg["dataset"]["far"]), v["num_coarse"], v["num_fine"], frame_seed(ctx.seed, i),
        t["chunk"], t["ref_block"])


def check(ctx, data, weights, kept):
    """The kept frames against the float32 reference, each distance in
    units of the distance at which the same reference with bf16 operands
    (the configuration's precision) lies from it on the same frames:
    rgb_rms_x and seg_rms_x for the root mean square over the pixels of
    the colour channels' and of the 12 class probabilities' differences,
    max_abs_x for the largest difference of any channel. A random field's
    frame is as sensitive to rounding as its density is steep, which
    differs from seed to seed by up to 10x; the unit takes that out.
    Returns (numbers, the distances themselves)."""
    ref32 = Field(ctx.spec, weights)
    ref16 = Field(ctx.spec, weights, bf16_linear)
    d = {k: [] for k in ("p_rgb", "p_seg", "b_rgb", "b_seg")}
    worst = {"p": 0.0, "b": 0.0}
    with full_float32():
        for i, got in kept:
            ref = reference_frame(ctx, data, ref32, i)
            for side, frame in (("p", torch.from_numpy(np.ascontiguousarray(got)).to(
                    ref.device).reshape(ref.shape)),
                                ("b", reference_frame(ctx, data, ref16, i))):
                diff = frame - ref
                d[side + "_rgb"].append(diff[:, :3].reshape(-1))
                d[side + "_seg"].append(diff[:, 3:].reshape(-1))
                worst[side] = max(worst[side], float(diff.abs().max()))
    dist = {k: rms(torch.cat(v)) for k, v in d.items()}
    dist.update(p_max=worst["p"], b_max=worst["b"])
    return {"rgb_rms_x": dist["p_rgb"] / dist["b_rgb"], "seg_rms_x": dist["p_seg"] / dist["b_seg"],
            "max_abs_x": dist["p_max"] / dist["b_max"]}, dist
