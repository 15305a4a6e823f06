"""On the card: one short run of each cell through the command, with its
last line the contract's and ``correct`` true. Skips without a card:
``python -m pytest port_bench/tests -m cuda`` on a machine with one."""
import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

WORKLOADS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))[
    "workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_short_run_on_the_card(card, workload):
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", workload,
                           "--seed", str(2**32 + 3), "--seconds", "2", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line
