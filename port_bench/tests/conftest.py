"""The benchmark's tests run from the repository's root (pytest.ini):
``python -m pytest port_bench/tests``. They drive the harness on the CPU at
a small size; the ``cuda`` ones need the card and skip without it."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# A cell at a size the CPU holds: the published widths, a few rays, the
# port's plain path (its kernels run on the card only).
TINY = {"frames": {"height": 8, "width": 8, "chunk": 32, "inputs": 4, "warmup": 1,
                   "check_frames": 2, "ref_block": 32, "trace_from": 1, "trace_frames": 1,
                   "trace_host_frames": 1},
        "train": {"height": 8, "width": 8, "frames": 4, "rays": 32, "steps_per_call": 2,
                  "ref_block": 32, "trace_from": 1, "trace_calls": 1, "trace_host_calls": 1}}
PLAIN = {"runtime": {"use_pallas": False}}


def tiny(workload):
    from port_bench import run
    return TINY[run.cell(workload, candidates=True)["traffic"]["driver"]]


def workloads(candidates=True):
    """The cells of BENCHMARK.json, and with ``candidates`` those of
    port_bench/candidates.json."""
    from port_bench import run
    return [w["name"] for w in run.benchmark(candidates)["workloads"]]
