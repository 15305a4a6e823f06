"""The readers of the program's own phases (``serve.cond_ms``,
``setup.program_s``): what they compute from the program's aggregates, and
nothing without a traced slice or from a program that has no such phases
(the parent of the change that added them)."""
import os

import pytest

from conftest import ROOT
from port_bench import run
from sahs_tpu_torch.utils import profiling

TRACED = {"kernels": {}, "busy_s": 0.5, "window_s": 0.6, "items": 3}


def reader(name):
    return run.load_module(os.path.join(ROOT, "port_bench", "layer_metrics", name + ".py"),
                           "reader_" + name.replace(".", "_"))


def phases(**aggs):
    return {"phases": {k.replace("_", "."): dict(zip(("count", "total_s", "first_s", "max_s"), v))
                       for k, v in aggs.items()}, "counters": {}}


def test_cond_ms_is_the_frames_after_the_first(monkeypatch):
    # 11 frames: the conditioning 90 ms first then 2 ms each; the folds one
    # entry a frame, 40 ms the first frame's then 2 ms each
    snap = phases(serve_cond=(11, 0.090 + 10 * 0.002, 0.090, 0.090),
                  serve_fold=(11, 0.040 + 10 * 0.002, 0.040, 0.040))
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    assert reader("serve.cond_ms").read(TRACED, {}) == pytest.approx(4.0)


def test_cond_ms_refuses_folds_not_counted_a_frame(monkeypatch):
    # a fold entry a build (4 a frame) instead of one a frame: the first
    # frame's builds cannot be told from the others
    snap = phases(serve_cond=(11, 0.110, 0.090, 0.090),
                  serve_fold=(44, 0.060, 0.030, 0.030))
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    assert reader("serve.cond_ms").read(TRACED, {}) is None


def test_program_setup_is_its_phases_and_the_first_frame(monkeypatch):
    snap = phases(setup_kernels=(1, 0.02, 0.02, 0.02), setup_model=(1, 3.5, 3.5, 3.5),
                  serve_frame=(100, 37.0, 0.41, 0.41), serve_cond=(100, 0.2, 0.09, 0.09))
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    assert reader("setup.program_s").read(TRACED, {}) == pytest.approx(0.02 + 3.5 + 0.41)


@pytest.mark.parametrize("name", ["serve.cond_ms", "setup.program_s"])
def test_nothing_from_a_program_without_its_phases(name, monkeypatch):
    monkeypatch.setattr(profiling, "snapshot", lambda: phases())
    assert reader(name).read(TRACED, {}) is None
    monkeypatch.delattr(profiling, "snapshot")          # a program without the API
    assert reader(name).read(TRACED, {}) is None
    assert reader(name).read(dict(TRACED, busy_s=0.0), {}) is None
