"""Where a flagship Stage-I train step spends its device time.

    python -m sahs_tpu_torch.train.trace_step [--steps 3]

Builds the flagship ``Config()`` train step (seeded weights, a synthetic
512x512 audio frame held on the device) on the CUDA device, runs 2 warm-up
steps, then traces ``--steps`` steps with ``torch.profiler`` and prints
every CUDA kernel's device ms and launches per step and its share of the
step (CUDA events), then the step's idle share: the part of the step in
which no kernel ran.
K2 and K3 show as the launches of their one call each (K2: fwd_kernel,
composite_kernel, bwd_kernel, dw_kernel, dw_reduce; K3: pair_vjp_kernel,
dw_kernel, dw_reduce).
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


def trace_train_step(steps: int = 3) -> Dict:
    """Trace ``steps`` flagship train steps. Returns {"step_ms", "kernels":
    [{"name", "launches_per_step", "ms_per_step", "share"}], "kernel_ms",
    "idle_share"}, kernels in decreasing time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..config import Config
    from ..data.synthetic import SyntheticFaceDataset
    from ..models.nerface import ModelSpec
    from . import stage1

    cfg = Config()
    spec = ModelSpec.from_config(cfg)
    ts = stage1.TrainSettings.from_config(cfg)
    dev = torch.device("cuda")
    ds = SyntheticFaceDataset(kind="audio", num_frames=1, H=512, W=512,
                              near=cfg.dataset.near, far=cfg.dataset.far)
    # the frame stays on the device, as a trainer's cached frames do
    batch = {k: torch.as_tensor(v).to(dev) for k, v in
             dict(ds[0], background=ds.background()).items() if k != "fname"}
    state = stage1.init_train_state(spec, ts, seed=0, device=dev)
    step = stage1.make_train_step(spec, ts, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):
        state, _ = step(state, batch, generator=gen)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(steps):
            state, _ = step(state, batch, generator=gen)
        end.record()
        torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / steps
    totals: Dict[str, List[float]] = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = totals.setdefault(short_name(e.key), [0.0, 0.0])
        t[0] += e.count / steps
        t[1] += e.self_device_time_total / 1e3 / steps
    kernels = [{"name": n, "launches_per_step": c, "ms_per_step": ms,
                "share": ms / step_ms}
               for n, (c, ms) in sorted(totals.items(), key=lambda kv: -kv[1][1])]
    kernel_ms = sum(k["ms_per_step"] for k in kernels)
    return {"step_ms": step_ms, "kernels": kernels, "kernel_ms": kernel_ms,
            "idle_share": max(0.0, 1.0 - kernel_ms / step_ms)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    res = trace_train_step(args.steps)
    print(f"step {res['step_ms']:.2f} ms (CUDA events), kernels "
          f"{res['kernel_ms']:.2f} ms, idle share {res['idle_share']:.3f}")
    for k in res["kernels"]:
        print(f"{k['ms_per_step']:10.3f} ms {k['launches_per_step']:6.1f} x "
              f"{100 * k['share']:6.2f} %  {k['name']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
