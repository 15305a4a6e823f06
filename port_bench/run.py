"""The port's benchmark: one run of one cell.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. The cell (an entry of BENCHMARK.json's ``workloads``) names a
configuration, ``port_bench/configs/<config>.json``, and a traffic mix,
``port_bench/traffic/<traffic>.json``, whose ``driver`` names the loop in
``port_bench/drivers/<driver>.py``; its limits for ``correct`` are in
``port_bench/limits/<workload>.json``. With ``--trace 1`` each per-layer
metric that BENCHMARK.json gives the cell is read by
``port_bench/layer_metrics/<metric>.py`` from a profiled slice of the
window. The run sets up, runs the traffic for ``--seconds``, judges what
the timed path produced against the plain reference, and prints one JSON
line last on standard output, the numbers it compared beside their limits
last on standard error. It exits non-zero, with no result, when the cards
are missing or when JAX or the JAX package is loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from typing import Dict, Optional  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "sahs_tpu")


def load_module(path: str, name: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as fp:
        return json.load(fp)


def merge(base: dict, over: Optional[dict]) -> dict:
    """``base`` with ``over``'s keys set, nested dicts merged."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def benchmark(candidates: bool = False) -> Dict:
    """BENCHMARK.json; with ``candidates``, its cells and metrics extended by
    ``port_bench/candidates.json``'s: cells the CPU tests drive whose
    comparison on the card is not yet admitted."""
    bench = read_json(ROOT, "BENCHMARK.json")
    if candidates:
        extra = read_json(BENCH, "candidates.json")
        for key in ("workloads", "end_to_end", "per_layer"):
            bench[key] = bench[key] + extra[key]
    return bench


def cell(workload: str, candidates: bool = False) -> Dict:
    """The cell's entry of BENCHMARK.json (or of the candidates), its
    configuration, traffic, limits and metrics."""
    bench = benchmark(candidates)
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    moved = {m["name"] for m in bench["end_to_end"]
             if workload in m.get("workloads", [workload])}
    layers = [m for m in bench["per_layer"]
              if workload in m.get("workloads", [workload] if m["moves"] in moved else [])]
    return {"entry": entry, "config": read_json(BENCH, "configs", entry["config"] + ".json"),
            "traffic": read_json(BENCH, "traffic", entry["traffic"] + ".json"),
            "limits": read_json(BENCH, "limits", workload + ".json")["limits"],
            "per_layer": layers,
            "end_to_end": [m for m in bench["end_to_end"] if m["name"] in moved]}


def forbidden_modules():
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             config_over: Optional[dict] = None, traffic_over: Optional[dict] = None,
             t_start: float = T_START, candidates: bool = False) -> Dict:
    """One run of ``workload``: {"result": the line's object, "checks":
    [(name, value, limit)]}. ``device``, the overrides and ``candidates``
    let a test drive a run at a small size on the CPU; the command line
    never sets them."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from port_bench import shapes
    c = cell(workload, candidates)
    cfg = merge(c["config"]["config"], config_over)
    traffic = merge(c["traffic"], traffic_over)
    dev = torch.device(device)
    ctx = types.SimpleNamespace(
        workload=workload, cfg=cfg, spec=shapes.spec_of(cfg), traffic=traffic, seed=seed,
        seconds=seconds, trace=trace, device=dev, t_start=t_start, limits=c["limits"])
    driver = load_module(os.path.join(BENCH, "drivers", traffic["driver"] + ".py"),
                         "port_bench_driver_" + traffic["driver"])
    out = driver.run(ctx)
    missing = set(c["limits"]) - set(out["checks"])
    if missing:
        raise KeyError(f"the limits name numbers the driver does not read: {sorted(missing)}")
    checks = [(name, float(value), float(c["limits"][name]))
              for name, value in out["checks"].items() if name in c["limits"]]
    others = {k: v for k, v in out["checks"].items() if k not in c["limits"]}
    if others:
        out.setdefault("notes", []).append("read, not compared: " + ", ".join(
            f"{k} {v!r}" for k, v in others.items()))
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                   "count": int(c["entry"]["chips"]),
                   "memory_peak_bytes": int(out["memory_peak_bytes"])}
    metrics = {}
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": device_info}
    if trace:
        summary = out["trace"]
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        for m in c["per_layer"]:
            reader = load_module(os.path.join(BENCH, "layer_metrics", m["name"] + ".py"),
                                 "port_bench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(summary, out["work"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    else:
        for m in c["end_to_end"]:
            metrics[m["name"]] = {"value": out["metrics"][m["name"]], "unit": m["unit"]}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return {"result": result, "checks": checks, "notes": out.get("notes", [])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    chips = int(cell(args.workload)["entry"]["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # one process, one CPU thread for PyTorch's own host ops: the train
    # steps are paced by the host's dispatch, which then shares the cores
    # with no worker thread of this process
    torch.set_num_threads(1)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print("loaded in this process: " + ", ".join(bad), file=sys.stderr)
        return 3
    for note in out["notes"]:
        print(note, file=sys.stderr)
    for name, value, limit in out["checks"]:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
