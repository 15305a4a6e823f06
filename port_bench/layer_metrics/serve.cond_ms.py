"""The host's milliseconds a frame of the per-frame conditioning: the
program's phase ``serve.cond`` (make_render_fns: AudioNet or the
expression code, the pose encoding), one call a frame, and its aggregate
``serve.fold`` (the FoldedCache's builds of the folded weights and the
grid's corner table, which run lazily inside the frame's first chunk),
one entry a frame holding all of that frame's builds; both from the
program's phase aggregates (``sahs_tpu_torch.utils.profiling.snapshot``).

The frames averaged are every frame the process rendered but its first,
whose conditioning and builds (the first calls of each op) are left out
whole: the second warm-up frame, and the window's frames, 7 of which
(frames 2-8 of the window) run under a profiler and 3 (frames 6-8) with
the host traced too, which slows their host side. Nothing without a
traced slice, or from a program that has no such phases."""


def read(summary, work):
    if summary.get("busy_s", 0.0) <= 0:
        return None
    try:
        from sahs_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    phases = snapshot()["phases"]
    cond, fold = phases.get("serve.cond"), phases.get("serve.fold")
    if cond is None or cond["count"] < 2:
        return None
    if fold is not None and fold["count"] != cond["count"]:
        return None               # the folds are not one entry a frame
    s = sum(p["total_s"] - p["first_s"] for p in (cond, fold) if p)
    return 1e3 * s / (cond["count"] - 1)
