"""The program's spans and counters (utils/profiling.py) on the CPU:

  (a) ``span`` is a ``record_function`` range, nested and named, while
      torch.profiler records, and nothing otherwise; ``phase`` aggregates
      count, total, first and longest seconds; ``count``, ``snapshot`` and
      ``reset``;
  (b) the spans where the program puts them: a frame (``serve.*``), a
      ``FoldedCache``'s builds and hits, the kernels' build and load, a
      C entry point's ``launch.<symbol>``, a Stage-I step (``train.*`` and
      the fused step's ``fused.*``); every span name in the package is a
      fixed string of one of ``LAYERS``;
  (c) ``span_table`` on hand-made event lists: a launch is owned by the
      innermost program span (host ops ignored), what lies outside every
      span goes to OUTSIDE, the rows account for the slice's device time,
      and each value is an item's; the reports that print the counters
      (the eval CLI, ``train/trace_step.py``);
  (d) on the card (``-m cuda``): a frame's K1 and K5 launches and a fused
      step's ``level_dw_kernel`` under K2's and K3's launch spans.

The file imports no JAX: its card test compares nothing with the JAX
package.
"""
import json
import math
import os
import re
import sys
import threading
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from sahs_tpu_torch.config import Config
from sahs_tpu_torch.data.synthetic import SyntheticFaceDataset
from sahs_tpu_torch.models import nerface
from sahs_tpu_torch.ops.kernels import _build
from sahs_tpu_torch.render import pipeline
from sahs_tpu_torch.train import stage1
from sahs_tpu_torch.utils import profiling

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "sahs_tpu_torch")


@pytest.fixture(autouse=True)
def fresh_counters():
    profiling.reset()
    yield
    profiling.reset()


def program_spans(prof):
    """[(start, end, name)] of the program spans in a profiler's events."""
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == DeviceType.CPU and e.is_user_annotation
                  and e.name.split(".", 1)[0] in profiling.LAYERS)


def inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


# ---------------------------------------------------------------------------
# (a) the API
# ---------------------------------------------------------------------------

def test_span_nests_named_ranges_under_the_profiler_and_is_nothing_without():
    off = profiling.span("serve.frame")
    assert off is profiling.span("serve.chunk")      # one shared object, no allocation
    with off:
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("serve.frame"):
            with profiling.span("serve.chunk"):
                torch.ones(4).sum()
    spans = program_spans(prof)
    assert [n for _, _, n in spans] == ["serve.frame", "serve.chunk"]
    assert inside(spans[1], spans[0])
    parent = {e.name: e.cpu_parent for e in prof.events()}
    assert parent["serve.chunk"].name == "serve.frame"
    assert profiling.snapshot() == {"phases": {}, "counters": {}}


def test_phase_aggregates_and_counters(monkeypatch):
    clock = iter([0.0, 2.0, 10.0, 10.5, 20.0, 23.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    for _ in range(3):
        with profiling.phase("train.step"):
            pass
    profiling.count("serve.chunks")
    profiling.count("serve.chunks", 7)
    snap = profiling.snapshot()
    assert snap["phases"] == {"train.step": {"count": 3, "total_s": 5.5, "first_s": 2.0,
                                             "max_s": 3.0}}
    assert snap["counters"] == {"serve.chunks": 8}
    profiling.reset()
    assert profiling.snapshot() == {"phases": {}, "counters": {}}


def test_add_is_a_phase_of_that_length(monkeypatch):
    clock = iter([0.0, 2.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    with profiling.phase("serve.fold"):
        pass
    profiling.add("serve.fold", 0.5)
    profiling.add("serve.fold", 4.0)
    assert profiling.snapshot()["phases"] == {"serve.fold": {
        "count": 3, "total_s": 6.5, "first_s": 2.0, "max_s": 4.0}}


def test_phase_is_a_span_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.phase("setup.model"):
            torch.ones(2).sum()
    assert [n for _, _, n in program_spans(prof)] == ["setup.model"]
    assert profiling.snapshot()["phases"]["setup.model"]["count"] == 1


def test_counters_lose_no_update_across_threads():
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                profiling.count("fold.reused")
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert profiling.snapshot()["counters"]["fold.reused"] == 8 * 2000


# ---------------------------------------------------------------------------
# (b) where the program puts them
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flagship():
    spec = nerface.ModelSpec.from_config(Config())
    model = nerface.NeRFaceModel.init(spec, seed=0, device="cpu")
    ds = SyntheticFaceDataset(kind="audio", num_frames=1, H=8, W=8)
    return spec, model, ds


def test_frame_spans_nest_as_the_pipeline_runs(flagship):
    """An 8x8 frame in chunks of 24 rays: serve.frame holds serve.cond and
    ceil(64 / 24) serve.chunk ranges, each holding serve.z,
    serve.importance, serve.merge and serve.reduce, then serve.gather; the
    folds run inside the first chunk."""
    _, model, ds = flagship
    item = ds[0]
    settings = pipeline.RenderSettings(num_coarse=8, num_fine=8, perturb=True,
                                       use_pallas=True, compute_dtype="float32")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipeline.render_image(model, settings, 8, 8, torch.as_tensor(item["intrinsics"]),
                              torch.as_tensor(item["pose"]), 0.2, 0.8,
                              torch.as_tensor(item["driving"]),
                              generator=torch.Generator().manual_seed(0),
                              background=torch.as_tensor(ds.background()), chunksize=24)
    spans = program_spans(prof)
    frame = [s for s in spans if s[2] == "serve.frame"]
    chunks = [s for s in spans if s[2] == "serve.chunk"]
    assert len(frame) == 1 and len(chunks) == math.ceil(64 / 24)
    for name in ("serve.cond", "serve.gather", *(s[2] for s in spans)):
        assert all(inside(s, frame[0]) for s in spans if s[2] == name)
    for name in ("serve.z", "serve.importance", "serve.merge", "serve.reduce"):
        own = [s for s in spans if s[2] == name]
        assert own and all(any(inside(s, c) for c in chunks) for s in own)
    assert {s[2] for s in spans if any(inside(s, c) for c in chunks[:1])} >= {"serve.fold"}
    assert not [s for s in spans if s[2] == "serve.fold" and inside(s, chunks[1])]
    snap = profiling.snapshot()
    assert snap["counters"]["serve.chunks"] == len(chunks)
    assert snap["counters"]["fold.built"] == 4             # the pair, two levels, the table
    assert snap["phases"]["serve.frame"]["count"] == 1
    assert snap["phases"]["serve.fold"]["count"] == 1      # one entry a frame
    assert len([s for s in spans if s[2] == "serve.fold"]) == 4


def test_fold_aggregate_is_one_entry_a_frame(flagship, monkeypatch):
    """Two 8x8 frames: serve.cond and serve.fold count one call a frame,
    serve.fold's first entry holds all of the first frame's builds."""
    _, model, ds = flagship
    item = ds[0]
    settings = pipeline.RenderSettings(num_coarse=8, num_fine=8, perturb=True,
                                       use_pallas=True, compute_dtype="float32")
    seen = []
    get = nerface.FoldedCache.get

    def timed(cache, key, sources, build):
        before = cache.seconds
        out = get(cache, key, sources, build)
        seen.append(cache.seconds - before)
        return out
    monkeypatch.setattr(nerface.FoldedCache, "get", timed)
    for _ in range(2):
        pipeline.render_image(model, settings, 8, 8, torch.as_tensor(item["intrinsics"]),
                              torch.as_tensor(item["pose"]), 0.2, 0.8,
                              torch.as_tensor(item["driving"]),
                              generator=torch.Generator().manual_seed(0),
                              background=torch.as_tensor(ds.background()))
    snap = profiling.snapshot()
    fold, cond = snap["phases"]["serve.fold"], snap["phases"]["serve.cond"]
    assert fold["count"] == cond["count"] == 2
    assert snap["counters"]["fold.built"] == 8
    first = sum(seen[:len(seen) // 2])
    assert fold["first_s"] == pytest.approx(first)
    assert fold["total_s"] == pytest.approx(sum(seen))


def test_folded_cache_builds_once_per_key_and_counts_hits():
    cache = nerface.FoldedCache()
    p = torch.nn.Parameter(torch.ones(3))
    built = []
    for key in ("pair", "coarse", "pair", "pair", "coarse"):
        cache.get(key, [p], lambda key=key: built.append(key) or key)
    assert built == ["pair", "coarse"]
    with torch.no_grad():
        p.add_(1.0)                     # an optimizer step: the next get rebuilds
    cache.get("pair", [p], lambda: built.append("pair again"))
    snap = profiling.snapshot()
    assert snap["counters"] == {"fold.built": 3, "fold.reused": 3}
    assert snap["phases"] == {}                 # the frame adds the cache's seconds
    assert cache.seconds > 0


def test_kernel_build_counts_built_against_loaded(monkeypatch, tmp_path):
    """With an nvcc that only writes its output, a cold build_all counts
    one build a library and a warm one none; a library loaded twice counts
    one load."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(_build, "_LIBS", {})
    loaded = []
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: loaded.append(path) or object())
    _build.build_all()
    _build.build_all()
    _build.load("nerf_level")
    _build.load("nerf_level")
    snap = profiling.snapshot()
    assert snap["counters"] == {"kernels.built": len(_build.KERNELS), "kernels.loaded": 1}
    assert snap["phases"]["setup.kernels"]["count"] == 2
    assert len(loaded) == 1 and loaded[0].startswith(str(tmp_path / "kernels"))


def test_entry_point_call_runs_in_its_launch_span(monkeypatch):
    seen = []

    def c_function(*args):
        with record_function("inside the C call"):
            seen.append(args)
        return 0

    lib = SimpleNamespace(sahs_fake_forward=c_function)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "_FUNCS", {})
    fn = _build.function("fake", "sahs_fake_forward", "pi")
    assert fn(None, 3) == 0                   # no profiler: a plain call
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert fn(None, 4) == 0
    assert seen == [(None, 3), (None, 4)]
    inner = next(e for e in prof.events() if e.name == "inside the C call")
    assert inner.cpu_parent.name == "launch.sahs_fake_forward"
    assert [n for _, _, n in program_spans(prof)] == ["launch.sahs_fake_forward"]


def test_stage1_step_spans_in_order():
    """A Stage-I step of the flagship on the CPU (the fused path on the
    kernels' plain versions): train.step holds train.pick, train.draws,
    train.forward, train.losses, train.backward, train.reduce, train.adam
    and train.sample_prob in that order, and the fused step's fused.z,
    fused.sort, fused.scatter and fused.unfold lie inside train.forward."""
    cfg = Config()
    cfg.nerf.train.num_random_rays = 48
    cfg.nerf.train.num_coarse = 8
    cfg.nerf.train.num_fine = 8
    cfg.runtime.use_pallas = True
    cfg.runtime.compute_dtype = "float32"
    spec = nerface.ModelSpec.from_config(cfg)
    ts = stage1.TrainSettings.from_config(cfg)
    ds = SyntheticFaceDataset(kind="audio", num_frames=1, H=8, W=8)
    batch = dict(ds[0], background=ds.background())
    state = stage1.init_train_state(spec, ts, seed=0, device="cpu")
    step = stage1.make_train_step(spec, ts, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch, generator=torch.Generator().manual_seed(0))
    spans = program_spans(prof)
    top = [s for s in spans if s[2] == "train.step"]
    parts = [s for s in spans if s[2].startswith("train.") and s[2] != "train.step"]
    assert len(top) == 1 and all(inside(s, top[0]) for s in parts)
    assert [s[2] for s in parts] == ["train.pick", "train.draws", "train.forward",
                                     "train.losses", "train.backward", "train.reduce",
                                     "train.adam", "train.sample_prob"]
    forward = next(s for s in parts if s[2] == "train.forward")
    fused = [s for s in spans if s[2].startswith("fused.")]
    assert {s[2] for s in fused} == {"fused.z", "fused.sort", "fused.scatter", "fused.unfold"}
    assert all(inside(s, forward) for s in fused)
    assert profiling.snapshot()["phases"]["train.step"]["count"] == 1


SPAN_CALL = re.compile(r"profiling\.(?:span|phase)\(([^)]*)\)")


def test_every_span_name_is_a_fixed_string_of_a_layer():
    """Every span and phase the package opens is named by a string literal
    of one of LAYERS (``launch.`` + the symbol in _build), and no module
    but utils/profiling.py enters record_function itself."""
    names = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fp:
                src = fp.read()
            if not path.endswith(os.path.join("utils", "profiling.py")):
                assert "record_function" not in src, path
            for arg in SPAN_CALL.findall(src):
                names.append((path, arg))
    literals = [a for _, a in names if re.fullmatch(r'"[a-z0-9_.]+"', a)]
    assert len(literals) >= 20
    for path, arg in names:
        if path.endswith("_build.py") and arg == "span_name":
            continue                  # "launch." + symbol
        assert re.fullmatch(r'"[a-z0-9_.]+"', arg), (path, arg)
        assert arg.strip('"').split(".", 1)[0] in profiling.LAYERS, (path, arg)


# ---------------------------------------------------------------------------
# (c) span_table on hand-made events (times in ms, as the profiler's us)
# ---------------------------------------------------------------------------

def ev(name, a, b, device=False, id=0, span=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a * 1e3, end=b * 1e3),
                           device_type=DeviceType.CUDA if device else DeviceType.CPU,
                           id=id, is_user_annotation=span)


def slice_events():
    """A frame [0, 100] holding a chunk [10, 50], which holds a launch
    span [20, 22]; a host op inside the frame [55, 70]; the caller's
    read-back [100, 120] outside. Kernels: id 1 launched in the launch span
    [25, 45], id 2 in the chunk [45, 48], id 3 under the host op [70, 80],
    id 4 outside [112, 115], id 5 with no launch in the slice [116, 117]."""
    return [
        ev("serve.frame", 0, 100, span=True), ev("serve.chunk", 10, 50, span=True),
        ev("launch.sahs_k", 20, 22, span=True), ev("aten::copy_", 55, 70),
        ev("aten::item", 100, 120), ev("ProfilerStep#1", -50, 200, span=True),
        ev("cudaLaunchKernel", 20.5, 21, id=1), ev("cudaLaunchKernel", 30, 31, id=2),
        ev("cudaMemcpyAsync", 62, 63, id=3), ev("cudaLaunchKernel", 110, 111, id=4),
        ev("k_one", 25, 45, device=True, id=1), ev("k_two", 45, 48, device=True, id=2),
        ev("Memcpy DtoH", 70, 80, device=True, id=3), ev("k_four", 112, 115, device=True, id=4),
        ev("k_five", 116, 117, device=True, id=5),
        ev("a device annotation", 0, 200, device=True, span=True)]


def approx(d):
    return {k: pytest.approx(v) for k, v in d.items()}


def test_span_table_launch_owned_by_innermost_span():
    t = profiling.span_table(slice_events())
    assert t["launch.sahs_k"]["device_ms"] == pytest.approx(20.0)
    assert t["serve.chunk"]["device_ms"] == pytest.approx(3.0)
    assert t["serve.frame"]["device_ms"] == pytest.approx(10.0)   # under a host op
    assert t[profiling.UNSEEN]["device_ms"] == pytest.approx(1.0)
    owners = profiling.launches_by_span(slice_events())
    assert owners[("launch.sahs_k", "k_one")] == [1.0, pytest.approx(20.0)]


def test_span_table_outside_the_program():
    t = profiling.span_table(slice_events())
    assert t[profiling.OUTSIDE] == approx({"count": 0.0, "host_ms": 0.0, "self_ms": 0.0,
                                           "device_ms": 3.0})
    assert "aten::copy_" not in t and "ProfilerStep#1" not in t


@pytest.mark.parametrize("items", [1, 2, 5])
def test_span_table_per_item_and_self_time(items):
    t = profiling.span_table(slice_events(), items)
    assert t["serve.frame"] == approx({"count": 1 / items, "host_ms": 100 / items,
                                       "self_ms": 60 / items, "device_ms": 10 / items})
    assert t["serve.chunk"]["self_ms"] == pytest.approx(38 / items)
    assert t["launch.sahs_k"]["self_ms"] == pytest.approx(2 / items)


def test_span_table_accounts_for_the_slice():
    """The rows' device ms sum to the device's busy time (one stream: no
    overlap), and each launch is counted once by launches_by_span."""
    t = profiling.span_table(slice_events())
    busy = 20 + 3 + 10 + 3 + 1
    assert sum(r["device_ms"] for r in t.values()) == pytest.approx(busy)
    owners = profiling.launches_by_span(slice_events())
    assert sum(c for c, _ in owners.values()) == 5
    assert sum(ms for _, ms in owners.values()) == pytest.approx(busy)


def test_eval_cli_prints_the_counters(tmp_path, capsys):
    """The eval CLI's last line is the process's phases and counters: a
    frame's folds built and reused, its chunks, its frames."""
    from sahs_tpu_torch.cli import eval_stage1
    from sahs_tpu_torch.config import load_config
    from sahs_tpu_torch.utils.checkpoint import save_checkpoint
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(f"""
experiment:
  id: counters
  logdir: {tmp_path}/log
dataset:
  type: audio
  basedir: {tmp_path}/nonexistent
  near: 0.2
  far: 2.0
nerf:
  validation:
    num_coarse: 4
    num_fine: 4
    chunksize: 2048
runtime:
  use_pallas: True
  compute_dtype: float32
""")
    cfg = load_config(str(cfg_path))
    spec = nerface.ModelSpec.from_config(cfg)
    state = stage1.init_train_state(spec, stage1.TrainSettings.from_config(cfg), seed=0,
                                    device="cpu")
    ckpt = str(tmp_path / "model.ckpt")
    save_checkpoint(ckpt, state)
    eval_stage1.main(["--config", str(cfg_path), "--checkpoint", ckpt, "--savedir",
                      str(tmp_path / "out"), "--synthetic", "--limit", "1", "--no-normals",
                      "--device", "cpu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("[PROGRAM] ")
    snap = json.loads(last[len("[PROGRAM] "):])
    frames = snap["phases"]["serve.frame"]["count"]
    assert frames >= 1
    assert snap["counters"]["fold.built"] == 4 * frames
    assert snap["counters"]["fold.reused"] > 0
    assert snap["counters"]["serve.chunks"] == frames * math.ceil(64 * 64 / 2048)


def test_trace_step_prints_the_program_line(monkeypatch, capsys):
    from sahs_tpu_torch.train import trace_step
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    profiling.count("kernels.built", 0)
    profiling.count("kernels.loaded", 2)
    profiling.add("train.step", 0.25)
    res = {"variant": "default", "step_ms": 50.0, "kernel_ms": 30.0, "idle_share": 0.4,
           "kernels": [{"name": "level_dw_kernel", "owner": "launch.sahs_level_train",
                        "launches_per_step": 2.0, "ms_per_step": 2.5, "share": 0.05}],
           "spans": {"train.step": {"count": 1.0, "host_ms": 48.0, "self_ms": 1.0,
                                    "device_ms": 0.0}},
           "program": profiling.snapshot()}
    monkeypatch.setattr(trace_step, "trace_train_step", lambda *a: res)
    assert trace_step.main([]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "[launch.sahs_level_train]" in out[1]
    assert out[-2].endswith("train.step")
    assert json.loads(out[-1][len("program phases and counters "):]) == {
        "phases": {"train.step": {"count": 1, "total_s": 0.25, "first_s": 0.25,
                                  "max_s": 0.25}},
        "counters": {"kernels.built": 0, "kernels.loaded": 2}}


# ---------------------------------------------------------------------------
# (d) on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_card_launch_spans_own_their_kernels():
    """A 64x64 frame of the flagship in bf16: K1's deform_pair_wg_kernel
    under K1's entry point's span, K5's field_tc_kernel and
    composite_fwd_kernel under K5's; the table accounts for the frame's
    device time within 1 %. A fused step: level_dw_kernel under K2's
    ``launch.sahs_level_train`` and under K3's ``launch.sahs_deform_pair_vjp``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sahs_tpu_torch.evaluation import make_eval_renderer
    from sahs_tpu_torch.train.trace_step import build_step, short_name
    dev = torch.device("cuda")
    spec = nerface.ModelSpec.from_config(Config())
    model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
    ds = SyntheticFaceDataset(kind="audio", num_frames=1, H=64, W=64)
    item = ds[0]
    settings = pipeline.RenderSettings(num_coarse=64, num_fine=64, perturb=True,
                                       use_pallas=True, compute_dtype="bfloat16")
    render = make_eval_renderer(spec, settings, 64, 64, 0.2, 0.8, device=dev)

    def frame():
        render(model, item["intrinsics"], item["pose"], item["driving"], ds.background(),
               torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
    frame()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        frame()
    events = prof.events()
    owners = {}
    for (span, kernel), _ in profiling.launches_by_span(events).items():
        owners.setdefault(short_name(kernel).split("<")[0], set()).add(span)
    assert owners["deform_pair_wg_kernel"] <= {"launch.sahs_deform_pair_forward",
                                               "launch.sahs_deform_pair_forward_rays"}
    assert owners["field_tc_kernel"] == owners["composite_fwd_kernel"] == {
        "launch.sahs_nerf_level_tc"}
    table = profiling.span_table(events)
    dev_ops = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    total = sum(e.time_range.end - e.time_range.start for e in dev_ops) / 1e3
    assert sum(r["device_ms"] for r in table.values()) == pytest.approx(total, rel=0.01)
    assert table.get(profiling.UNSEEN, {"device_ms": 0.0})["device_ms"] <= 0.01 * total

    step, state, batch, gen = build_step("fused", dev)
    for _ in range(2):
        state, _ = step(state, batch, generator=gen)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch, generator=gen)
        torch.cuda.synchronize()
    dw = {span for (span, kernel) in profiling.launches_by_span(prof.events())
          if short_name(kernel).split("<")[0].split("::")[-1] == "level_dw_kernel"}
    assert {"launch.sahs_level_train", "launch.sahs_deform_pair_vjp"} <= dw
