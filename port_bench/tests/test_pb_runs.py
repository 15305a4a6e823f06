"""Runs of each cell on the CPU at a small size through the port's plain
path: the last line's keys, the reference's agreement with that path, and
a run without a card."""
import json
import os
import subprocess
import sys

import pytest

from conftest import PLAIN, ROOT, tiny, workloads
from port_bench import run

WORKLOADS = workloads()
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def cpu_run(workload, trace, seconds=0.5, seed=2**33 + 11):
    return run.run_cell(workload, seed, seconds, trace, device="cpu", config_over=PLAIN,
                        traffic_over=tiny(workload), candidates=True)


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [False, True])
def test_last_line_has_the_contracts_keys(workload, trace):
    res = cpu_run(workload, trace)["result"]
    line = json.loads(json.dumps(res))
    assert KEYS <= set(line) <= KEYS | {"breakdown", "checks"}
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    c = run.cell(workload, candidates=True)
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["metrics"]) <= {m["name"] for m in c["per_layer"]}
    else:
        assert set(line["metrics"]) == {m["name"] for m in c["end_to_end"]}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["checks"]) == set(c["limits"])
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_agrees_with_the_plain_path(workload):
    # both in float32 on the same weights, inputs and draws: every number
    # is rounding, far under its limit
    out = cpu_run(workload, False)
    assert out["result"]["correct"]
    for name, value, limit in out["checks"]:
        assert value < 1e-3 * limit, (name, value)


def test_a_run_without_a_card_fails_with_no_result():
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", WORKLOADS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "port_bench"), tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", WORKLOADS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
