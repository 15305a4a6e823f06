"""Stage-I training: the port's multi-step driver
(``train/stage1.make_multi_train_step``) runs ``steps_per_call`` steps a
call, dispatched ahead, over ``frames`` seeded frames held on the device as
the trainer caches them; every random draw of a step (the ray pick's
Gumbel noise, the coarse jitter, the importance uniforms, the sigma noise)
is made by the benchmark from the seed and passed in as ``TrainDraws``.

Set-up builds the train state, drives it through its first steps by the
same call and feed (one step, then two), keeping the Adam moments after the
first and the parameters after the third for the comparison, warms the
call up once at its full size, then hands the same state to the window.
The rate is rays of the steps completed over the window, which closes with
a synchronisation after the last call that started within ``--seconds``.

Traffic keys: ``height``, ``width``, ``frames``, ``rays`` (a step's rays),
``steps_per_call``, ``ref_block`` (rays a block of the reference), and
``trace_from``, ``trace_calls``, ``trace_host_calls`` (the profiled slices
of a ``--trace 1`` run, trace.Tracer).
"""
from __future__ import annotations

import statistics
import time

import torch

from port_bench import arith, inputs, kernels, trace as tr
from port_bench.reference.model import full_float32
from port_bench.reference.precision import bf16_linear
from port_bench.reference.train import train_steps
from port_bench.weights import make_weights, sub_seed

FIRST = (1, 2)            # the steps of the first calls, compared with the reference
METRICS = ("loss", "coarse_l2", "fine_l2", "coarse_ce", "fine_ce")


DRAWS = ("gumbel", "t_rand", "u", "noise_coarse", "noise_fine")


def make_draws(gen, K, H, W, R, Sc, Sn, dev):
    """K steps' draws, each stacked along a leading K axis: the ray pick's
    standard Gumbel noise (H * W), the coarse jitter (R, Sc), the
    importance uniforms (R, Sn), the standard-normal sigma noise of each
    level (R, Sc) and (R, Sc + Sn); in TrainDraws' order."""
    u = torch.rand((K, H * W), generator=gen, device=dev)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))
    return (gumbel, torch.rand((K, R, Sc), generator=gen, device=dev),
            torch.rand((K, R, Sn), generator=gen, device=dev),
            torch.randn((K, R, Sc), generator=gen, device=dev),
            torch.randn((K, R, Sc + Sn), generator=gen, device=dev))


def make_inputs(ctx):
    """The run's weights, frames and draw generator: (weights, data,
    generator), data holding image, mask, pose, driving (a row a frame),
    intrinsics and background."""
    t, dev = ctx.traffic, ctx.device
    near, far = float(ctx.cfg["dataset"]["near"]), float(ctx.cfg["dataset"]["far"])
    weights = make_weights(ctx.spec, ctx.seed, dev, near, far)
    F, H, W = t["frames"], t["height"], t["width"]
    data = dict(inputs.train_frames(F, H, W, ctx.seed, dev),
                pose=inputs.poses(F, 0.5 * (near + far), ctx.seed, dev),
                driving=inputs.driving(F, ctx.spec.audio, ctx.seed, dev),
                intrinsics=inputs.intrinsics(W, dev),
                background=inputs.background(H, W, ctx.seed, dev))
    return weights, data, torch.Generator(device=dev).manual_seed(sub_seed(ctx.seed, "draws"))


def first_steps(ctx, data, gen):
    """The draws of the first calls (FIRST steps each), and each step's
    batch and draws as the reference takes them."""
    t = ctx.traffic
    Sc, Sn = ctx.cfg["nerf"]["train"]["num_coarse"], ctx.cfg["nerf"]["train"]["num_fine"]
    calls, batches, draws = [], [], []
    at = 0
    for n in FIRST:
        d = make_draws(gen, n, t["height"], t["width"], t["rays"], Sc, Sn, ctx.device)
        calls.append((at, n, d))
        for k in range(n):
            batches.append({key: data[key][at + k] for key in ("image", "mask", "pose",
                                                               "driving")})
            batches[-1].update(intrinsics=data["intrinsics"], background=data["background"])
            draws.append({name: x[k] for name, x in zip(DRAWS, d)})
        at += n
    return calls, batches, draws


def run(ctx):
    from sahs_tpu_torch.config import load_config
    from sahs_tpu_torch.models.nerface import ModelSpec, NeRFaceModel
    from sahs_tpu_torch.train import stage1
    from sahs_tpu_torch.train.fused import TrainDraws
    t, dev = ctx.traffic, ctx.device
    cfg = load_config(ctx.cfg)
    cfg.nerf.train.num_random_rays = R = t["rays"]
    if dev.type == "cuda":
        kernels.build()
    spec, ts = ModelSpec.from_config(cfg), stage1.TrainSettings.from_config(cfg)
    H, W, K, F = t["height"], t["width"], t["steps_per_call"], t["frames"]
    Sc, Sn = ts.render.num_coarse, ts.render.num_fine

    weights, data, gen = make_inputs(ctx)
    model = NeRFaceModel(spec).to(dev)
    model.load_state_dict(weights, strict=True)
    params = list(model.parameters())
    state = stage1.TrainState(model=model, background=None,
                              optimizer=stage1.make_optimizer(params, ts),
                              lr_fn=stage1.lr_schedule(ts), step=0,
                              sample_prob=torch.ones((12,), device=dev))
    intr, bg = data["intrinsics"], data["background"]

    def feed(a, b):
        """The stacked batches of frames a..b-1, as views."""
        return {"image": data["image"][a:b], "mask": data["mask"][a:b],
                "pose": data["pose"][a:b], "intrinsics": intr.expand(b - a, 4),
                "driving": data["driving"][a:b],
                "background": bg.expand((b - a,) + tuple(bg.shape))}

    multi = stage1.make_multi_train_step(spec, ts, device=dev)
    draw = lambda: TrainDraws(*make_draws(gen, K, H, W, R, Sc, Sn, dev))

    # the first steps, through the window's call and feed
    calls, batches, draws = first_steps(ctx, data, gen)
    metrics = []
    for at, n, d in calls:
        state, m = multi(state, feed(at, at + n), draws=TrainDraws(*d))
        metrics += [{k: m[k][j] for k in METRICS} for j in range(n)]
        if at == 0:
            grad1 = adam_gradient(state.optimizer, model)
    params3 = {k: p.detach().clone() for k, p in model.named_parameters()}
    # one call at full size before the window
    halves = [feed(0, K), feed(K, 2 * K)] if F >= 2 * K else [feed(0, K)]
    state, _ = multi(state, halves[0], draws=draw())
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - ctx.t_start

    n_calls = 0
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    tracer = tr.Tracer(t["trace_from"], t["trace_calls"], t["trace_host_calls"], K,
                       sync) if ctx.trace else None
    t0 = time.perf_counter()
    while True:
        if tracer:
            tracer.before(n_calls)
        state, _ = multi(state, halves[(n_calls + 1) % len(halves)], draws=draw())
        if tracer:
            tracer.after(n_calls)
        n_calls += 1
        if time.perf_counter() - t0 >= ctx.seconds and (
                tracer is None or tracer.done(n_calls - 1)):
            break
    if dev.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    steps = n_calls * K
    res = {"attempted": steps, "failed": 0, "memory_peak_bytes": peak,
           "metrics": {"train_rays_per_s": R * steps / window_s, "setup_s": setup_s},
           "notes": [f"steps {steps} in {window_s:.3f} s ({1e3 * window_s / steps:.3f} ms a "
                     f"step); set-up {setup_s:.3f} s"]}
    if tracer:
        res["trace"] = tracer.out
        res["work"] = {"step_flops": arith.step_flops(ctx.spec, R, Sc, Sn)}
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    del state, model, params, multi, halves
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    res["checks"], readings = check(ctx, weights, batches, draws, metrics, grad1, params3)
    res["notes"].append("worst leaves and leaves left out of the change: " + repr(readings))
    return res


def adam_gradient(optimizer, model):
    """Each parameter's first gradient as Adam got it, from its first
    moment after one step (zero where Adam holds no state for it)."""
    beta1 = optimizer.param_groups[0]["betas"][0]
    out = {}
    for k, p in model.named_parameters():
        st = optimizer.state.get(p, {})
        out[k] = (st["exp_avg"] / (1 - beta1)).clone() if "exp_avg" in st else torch.zeros_like(p)
    return out


def leaf_gaps(got, ref, keep=None):
    """{leaf: the gap between the two sides' norms of the leaf, against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger}, over the leaves in ``keep`` (all if None)."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items()}
    med = statistics.median(norms.values())
    return {k: abs(float(torch.linalg.vector_norm(got[k].double())) - norms[k]) / max(norms[k], med)
            for k in ref if keep is None or k in keep}


def check(ctx, weights, batches, draws, metrics, grad1, params3):
    """The first steps against the float32 reference. ``metrics``: each
    step's loss, coarse and fine MSE and cross-entropy as the program
    reported them.

    - out_x: the root mean square over those 15 numbers of their relative
      difference from the reference's, in units of the same of the reference
      with bf16 operands (the configuration's precision) on the same steps.
      The absolute differences swing 80x from seed to seed with the random
      field's conditioning, and the bf16 reference's with them.
    - step_gap, step_worst: the median and the worst leaf's gap between the
      norms of the parameters' change over the first steps, against the
      reference's norm of that leaf or of the median leaf, whichever is
      larger; leaves whose reference gradient is under a thousandth of the
      median leaf's move under Adam by rounding alone and are left out.
    - loss_gap (the worst step's relative loss difference), grad_gap and
      grad_worst (the median and the worst leaf's gap of the first
      gradient as Adam got it), grad_dx and step_dx (the median leaf's
      distance of the first gradient and of the change from the
      reference's, in units of the bf16 reference's distance) are read
      beside them.

    Returns (numbers, readings): the worst leaves' names and the leaves left
    out of the change."""
    with full_float32():
        ref = train_steps(ctx.spec, ctx.cfg, weights, batches, draws, ctx.traffic["rays"],
                          block=ctx.traffic["ref_block"])
        r16 = train_steps(ctx.spec, ctx.cfg, weights, batches, draws, ctx.traffic["rays"],
                          linear=bf16_linear, block=ctx.traffic["ref_block"])

    def rel(got):
        return torch.tensor([(g[k] - float(r[k])) / float(r[k])
                             for g, r in zip(got, ref["metrics"]) for k in METRICS],
                            dtype=torch.float64)
    d16 = rel([{k: float(v) for k, v in m.items()} for m in r16["metrics"]])
    d = rel(metrics)
    gnorm = {k: float(torch.linalg.vector_norm(v)) for k, v in ref["grad1"].items()}
    med = statistics.median(gnorm.values())
    keep = {k for k, v in gnorm.items() if v >= 1e-3 * med}
    grad = leaf_gaps(grad1, ref["grad1"])
    step = leaf_gaps({k: params3[k] - weights[k] for k in weights},
                     {k: ref["params"][k] - weights[k] for k in weights}, keep)
    worst = lambda g: max(g.items(), key=lambda kv: kv[1])
    readings = {"grad_worst_leaf": worst(grad)[0], "step_worst_leaf": worst(step)[0],
                "left_out_of_step": sorted(set(weights) - keep),
                "out_rms_program": float(d.pow(2).mean().sqrt()),
                "out_rms_bf16": float(d16.pow(2).mean().sqrt())}
    losses = [abs(m["loss"] - float(r["loss"])) / abs(float(r["loss"]))
              for m, r in zip(metrics, ref["metrics"])]

    def dx(got, ours, theirs):
        return statistics.median(
            float(torch.linalg.vector_norm(got[k] - ours[k]))
            / max(float(torch.linalg.vector_norm(theirs[k] - ours[k])), 1e-30) for k in ours)
    return {"out_x": readings["out_rms_program"] / readings["out_rms_bf16"],
            "step_gap": statistics.median(step.values()), "step_worst": worst(step)[1],
            "loss_gap": max(losses), "grad_gap": statistics.median(grad.values()),
            "grad_worst": worst(grad)[1], "grad_dx": dx(grad1, ref["grad1"], r16["grad1"]),
            "step_dx": dx(params3, ref["params"], r16["params"])}, readings
