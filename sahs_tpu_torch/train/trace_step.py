"""Where a flagship Stage-I train step spends its device time.

    python -m sahs_tpu_torch.train.trace_step [--steps 3] [--path fused]

Builds the flagship ``Config()`` train step (seeded weights, a synthetic
512x512 audio frame held on the device) on the CUDA device, runs 2 warm-up
steps, then traces ``--steps`` steps with ``torch.profiler`` and prints
every CUDA kernel's device ms and launches per step and its share of the
step (CUDA events), then the step's idle share: the part of the step in
which no kernel ran.
``--path`` picks the step: ``fused`` (the default, K1-K4), ``fallback``
(fused_grads off: the autograd fallback, K1, K5, K6, K9, K3), ``reuse``
(the fallback with fuse_composite off: K1, K7, K8, K9, K3), ``pointwise``
(64 + 128 samples, which the fine level's kernels do not tile: the coarse
level on K5/K6, the fine level on the per-point branch, K11, K12, K10, with
K1, K3 and K9), ``plain`` (use_pallas off: autograd of the plain modules,
K10 the only kernel of the port), ``warp_only`` (models.hyper.use_ambient
off: the fallback with the warp net alone on K13 and K14, then K5, K6, K9)
or ``ambient_only`` (models.warp.use_warp off: the hyper net alone on K13
and K14).
K2, K3, K6 and K8 show as the launches of their one call each (K2 and K6
in bfloat16, the tensor-core kernels of csrc/mma.cuh: fwd_tc_kernel,
composite_kernel, bwd_tc_kernel, level_dw_kernel, dw_reduce, and in
float32 fwd_kernel, composite_kernel, bwd_kernel, dw_kernel, dw_reduce;
K8 the same without composite_kernel; K3: pair_vjp_tc_kernel,
level_dw_kernel, dw_reduce in bfloat16, pair_vjp_kernel, dw_kernel,
dw_reduce in float32; K12 as K8); K5 in bfloat16 as its two launches,
field_tc_kernel (its raw field) and composite_fwd_kernel (its
compositing), in float32 as nerf_level_kernel; K1 as deform_pair_tc_kernel
(bfloat16) or deform_pair_kernel (float32); K7 and K11 in bfloat16 as
field_tc_kernel (the tensor-core forward of csrc/level_train.cu), in
float32 as nerf_level_kernel and nerf_mlp_kernel;
K4, K9 and K10 as the launches of their one routine (dg_cells_kernel,
dg_hist_kernel, dg_tile_offsets_kernel, dg_scatter_kernel, dg_cell_sums_kernel,
dg_cell_offsets_kernel, dg_chunk_kernel, dg_voxel_kernel, and K10's
dg_dcoords_kernel); K13 as skip_fwd_tc_kernel (bfloat16) or
skip_mlp_kernel (float32); K14 as skip_vjp_tc_kernel, level_dw_kernel, dw_reduce (bfloat16) or
skip_vjp_kernel, dw_kernel, dw_reduce (float32). Each line names the
port's kernels whose launch it is (``OWNERS``).
"""
from __future__ import annotations

import argparse
import re
import sys
from typing import Dict, List


def short_name(kernel: str) -> str:
    """A demangled kernel name without its argument list, return type and
    anonymous namespace, at most 60 characters."""
    name = kernel[5:] if kernel.startswith("void ") else kernel
    name = name.replace("(anonymous namespace)::", "")
    name = re.split(r"\(", name, maxsplit=1)[0]
    return name[:60]


# CUDA kernel -> the port's kernels (K1-K15) whose launch it is
OWNERS = {
    "deform_pair_tc_kernel": "K1", "deform_pair_kernel": "K1",
    "field_tc_kernel": "K5 raw field, K7, K11",
    "composite_fwd_kernel": "K5 compositing",
    "nerf_level_kernel": "K5, K7 (float32)", "nerf_mlp_kernel": "K11 (float32)",
    "fwd_tc_kernel": "K2, K6, K8, K12 forward", "fwd_kernel": "K2, K6, K8, K12 forward",
    "composite_kernel": "K2, K6 compositing and its backward",
    "bwd_tc_kernel": "K2, K6, K8, K12 backward", "bwd_kernel": "K2, K6, K8, K12 backward",
    "level_dw_kernel": "dW of K2, K3, K6, K8, K12, K14", "dw_kernel": "dW (float32)",
    "dw_reduce": "dW's split-K sum",
    "pair_vjp_tc_kernel": "K3", "pair_vjp_kernel": "K3",
    "skip_fwd_tc_kernel": "K13", "skip_mlp_kernel": "K13",
    "skip_vjp_tc_kernel": "K14", "skip_vjp_kernel": "K14",
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


# path -> (runtime settings, train settings, model settings) over the
# flagship Config()
PATHS = {"fused": ({}, {}, {}), "fallback": ({"fused_grads": False}, {}, {}),
         "reuse": ({"fused_grads": False, "fuse_composite": False}, {}, {}),
         "pointwise": ({}, {"num_fine": 128}, {}),
         "plain": ({"use_pallas": False}, {}, {}),
         "warp_only": ({}, {}, {("hyper", "use_ambient"): False}),
         "ambient_only": ({}, {}, {("warp", "use_warp"): False})}


def build_step(path: str, dev):
    """The flagship train step of ``path`` (PATHS) on ``dev``, seeded:
    (step, state, batch, generator), the synthetic 512x512 frame on the
    device as a trainer's cached frames are."""
    import torch

    from ..config import Config
    from ..data.synthetic import SyntheticFaceDataset
    from ..models.nerface import ModelSpec
    from . import stage1

    cfg = Config()
    runtime, train, models = PATHS[path]
    for k, v in runtime.items():
        setattr(cfg.runtime, k, v)
    for k, v in train.items():
        setattr(cfg.nerf.train, k, v)
    for (sub, k), v in models.items():
        setattr(getattr(cfg.models, sub), k, v)
    spec = ModelSpec.from_config(cfg)
    ts = stage1.TrainSettings.from_config(cfg)
    ds = SyntheticFaceDataset(kind="audio", num_frames=1, H=512, W=512,
                              near=cfg.dataset.near, far=cfg.dataset.far)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in
             dict(ds[0], background=ds.background()).items() if k != "fname"}
    state = stage1.init_train_state(spec, ts, seed=0, device=dev)
    step = stage1.make_train_step(spec, ts, device=dev)
    return step, state, batch, torch.Generator(device=dev).manual_seed(0)


def trace_train_step(steps: int = 3, path: str = "fused") -> Dict:
    """Trace ``steps`` flagship train steps of ``path`` (PATHS). Returns
    {"step_ms", "kernels":
    [{"name", "launches_per_step", "ms_per_step", "share"}], "kernel_ms",
    "idle_share"}, kernels in decreasing time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..utils.device import cuda_ms

    step, state, batch, gen = build_step(path, torch.device("cuda"))
    for _ in range(2):
        state, _ = step(state, batch, generator=gen)
    held = [state]

    def one_step():
        held[0], _ = step(held[0], batch, generator=gen)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step_ms = cuda_ms(one_step, steps, warmup=0)
    totals: Dict[str, List[float]] = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = totals.setdefault(short_name(e.key), [0.0, 0.0])
        t[0] += e.count / steps
        t[1] += e.self_device_time_total / 1e3 / steps
    kernels = [{"name": n, "owner": owner(n), "launches_per_step": c,
                "ms_per_step": ms, "share": ms / step_ms}
               for n, (c, ms) in sorted(totals.items(), key=lambda kv: -kv[1][1])]
    kernel_ms = sum(k["ms_per_step"] for k in kernels)
    return {"step_ms": step_ms, "kernels": kernels, "kernel_ms": kernel_ms,
            "idle_share": max(0.0, 1.0 - kernel_ms / step_ms)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--path", choices=sorted(PATHS), default="fused")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    res = trace_train_step(args.steps, args.path)
    print(f"{args.path} step {res['step_ms']:.2f} ms (CUDA events), kernels "
          f"{res['kernel_ms']:.2f} ms, idle share {res['idle_share']:.3f}")
    for k in res["kernels"]:
        print(f"{k['ms_per_step']:10.3f} ms {k['launches_per_step']:6.1f} x "
              f"{100 * k['share']:6.2f} %  {k['name']}"
              + (f"  [{k['owner']}]" if k["owner"] else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
