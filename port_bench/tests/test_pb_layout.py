"""BENCHMARK.json against the contract's shape, and every cell's files found
by name."""
import json
import os
import re

import pytest

from conftest import ROOT
from port_bench import run

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
ALL = [w["name"] for w in run.benchmark(candidates=True)["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + WORKLOADS + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for m in metrics:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(WORKLOADS)


def test_candidates_share_the_schema():
    cand = json.load(open(os.path.join(ROOT, "port_bench", "candidates.json")))
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for key in ("workloads", "end_to_end", "per_layer"):
        assert not {x["name"] for x in cand[key]} & (names | set(WORKLOADS))
    for w in cand["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}


@pytest.mark.parametrize("workload", ALL)
def test_cell_files_found_by_name(workload):
    c = run.cell(workload, candidates=True)
    entry = c["entry"]
    assert entry["chips"] == 1
    cfg = next(x for x in BENCH["configs"] if x["name"] == entry["config"])
    assert cfg["file"] == f"port_bench/configs/{entry['config']}.json"
    assert c["config"]["source"] == cfg["source"] and c["config"]["reduced"] == cfg["reduced"]
    driver = c["traffic"]["driver"]
    assert os.path.exists(os.path.join(ROOT, "port_bench", "drivers", driver + ".py"))
    assert c["limits"] and all(v > 0 for v in c["limits"].values())
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and c["per_layer"]
    for m in c["per_layer"]:
        reader = run.load_module(os.path.join(ROOT, "port_bench", "layer_metrics",
                                              m["name"] + ".py"), "reader")
        assert callable(reader.read)


def test_reader_finds_nothing_without_a_trace():
    empty = {"kernels": {}, "busy_s": 0.0, "window_s": 1.0, "items": 1}
    for m in run.benchmark(candidates=True)["per_layer"]:
        reader = run.load_module(os.path.join(ROOT, "port_bench", "layer_metrics",
                                              m["name"] + ".py"), "reader")
        assert reader.read(empty, {}) is None
