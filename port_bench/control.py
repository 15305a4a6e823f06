"""The control of a cell's comparison: the plain reference with its
products in float8 (reference/precision.py) in the program's place, judged
by the same numbers as a run, on the same inputs. Its readings are the
upper ends the limits in ``port_bench/limits/`` are set below.

    python3 port_bench/control.py --workload <name> --seeds <n> [<n> ...]

Frame cells: frames 0 and 1 of each seed by the control against the float32
reference. Train cells: the first steps of each seed by the control and by
the reference with a planted fault (half of each batch), each against the
float32 reference. One JSON line a seed; runs on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import types

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def readings(workload: str, seed: int, device: str = "cuda", config_over=None,
             traffic_over=None, frames=(0, 1), candidates: bool = False) -> dict:
    """The control's numbers for ``workload`` on ``seed``."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from port_bench import run, shapes
    from port_bench.reference.model import Field, full_float32
    from port_bench.reference.precision import fp8_linear
    from port_bench.reference.train import train_steps
    c = run.cell(workload, candidates)
    cfg = run.merge(c["config"]["config"], config_over)
    traffic = run.merge(c["traffic"], traffic_over)
    ctx = types.SimpleNamespace(workload=workload, cfg=cfg, spec=shapes.spec_of(cfg),
                                traffic=traffic, seed=seed, device=torch.device(device))
    driver = run.load_module(os.path.join(BENCH, "drivers", traffic["driver"] + ".py"),
                             "port_bench_driver_" + traffic["driver"])
    if traffic["driver"] == "frames":
        weights, data = driver.make_inputs(ctx)
        field = Field(ctx.spec, weights, fp8_linear)
        with full_float32():
            kept = [(i, driver.reference_frame(ctx, data, field, i).cpu().numpy())
                    for i in frames]
        return driver.check(ctx, data, weights, kept)[0]
    weights, data, gen = driver.make_inputs(ctx)
    _, batches, draws = driver.first_steps(ctx, data, gen)
    out = {}
    for name, kw in (("control", {"linear": fp8_linear}), ("half_batch", {"half_batch": True})):
        with full_float32():
            ctl = train_steps(ctx.spec, cfg, weights, batches, draws, traffic["rays"],
                              block=traffic["ref_block"], **kw)
        out[name], _ = driver.check(ctx, weights, batches, draws,
                                    [{k: float(v) for k, v in m.items()}
                                     for m in ctl["metrics"]], ctl["grad1"], ctl["params"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--candidates", action="store_true",
                    help="also look the workload up in port_bench/candidates.json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": readings(args.workload, seed,
                                              candidates=args.candidates)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
