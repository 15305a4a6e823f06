"""Profiling hooks (counterpart of ``sahs_tpu/utils/profiling.py``):

  - ``trace(logdir)``: a context manager that records everything inside
    with ``torch.profiler`` (CPU, and CUDA where there is a card) and
    writes one Chrome trace file into ``logdir``;
  - ``start_profiler_server(port)``: the counterpart of
    ``jax.profiler.start_server``, a capture on demand from outside the
    process: a TCP listener on localhost that, for each request, records a
    ``trace`` window of the requested length into the requested directory
    (``capture`` is its client; the standard library only);
  - the program's spans and counters, at its layer boundaries:
    ``span(name)`` marks a range on the profiler's clock (a
    ``record_function`` range while torch.profiler records, nothing
    otherwise), so every Chrome trace of ``trace`` and of the profiler
    server carries them; ``phase(name)``, for coarse ranges (a set-up
    phase, a frame, a train step), is a span that also adds its host
    duration to an aggregate by name; ``count(name, n)`` adds to a
    counter; ``snapshot()`` and ``reset()`` read and clear both, which
    stay in memory at a constant size however long the process runs
    (``add(name, seconds)`` adds a duration measured elsewhere, as a
    phase of that length would);
  - ``span_table(events)`` and ``launches_by_span(events)``: a traced
    slice's host time by program span and its device operations by the
    program span that launched them.

Every span name starts with one of ``LAYERS`` and a dot, and is a fixed
string: no per-call value is part of a name.
"""
from __future__ import annotations

import contextlib
import heapq
import json
import os
import socket
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from torch.autograd import profiler as _autograd_profiler

# the first part of every program span's name: the serving path, set-up,
# the Stage-I train step, the fused step inside it, and the kernels' C
# entry points (``launch.<symbol>``, ops/kernels/_build.function)
LAYERS = ("serve", "setup", "train", "fused", "launch")
OUTSIDE = "(outside the program)"
UNSEEN = "(launch not seen)"


class _NoSpan:
    """What ``span`` returns while no profiler records: enters and leaves
    without doing anything (one shared instance)."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str):
    """A context manager marking ``name``'s range: while torch.profiler
    records, a ``record_function`` range (its start, end and parent are
    the profiler's own events, on the device trace's clock); otherwise
    nothing beyond this one flag check, with no allocation and no clock
    reading."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _autograd_profiler.record_function(name)


_LOCK = threading.Lock()
_PHASES: Dict[str, List[float]] = {}    # name -> [count, total, first, max] (s)
_COUNTERS: Dict[str, int] = {}


class _Phase:
    __slots__ = ("name", "_span", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._span = span(self.name)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        add(self.name, dt)
        return False


def phase(name: str) -> _Phase:
    """``span(name)`` that also adds its host duration (``perf_counter``)
    to ``name``'s aggregate: calls, total, first and longest seconds. For
    coarse ranges only: a set-up phase, a frame, a train step."""
    return _Phase(name)


def add(name: str, seconds: float) -> None:
    """Adds one call of ``seconds`` to ``name``'s aggregate, as a phase of
    that length would."""
    with _LOCK:
        agg = _PHASES.get(name)
        if agg is None:
            _PHASES[name] = [1, seconds, seconds, seconds]
        else:
            agg[0] += 1
            agg[1] += seconds
            agg[3] = max(agg[3], seconds)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name``."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def snapshot() -> Dict[str, Dict]:
    """{"phases": {name: {"count", "total_s", "first_s", "max_s"}},
    "counters": {name: n}}, as they stand."""
    with _LOCK:
        return {"phases": {k: {"count": int(c), "total_s": t, "first_s": f, "max_s": m}
                           for k, (c, t, f, m) in _PHASES.items()},
                "counters": dict(_COUNTERS)}


def reset() -> None:
    """Clears every phase aggregate and counter."""
    with _LOCK:
        _PHASES.clear()
        _COUNTERS.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Records the body with torch.profiler (CPU activities, and CUDA ones
    when a card is there, synchronised before the window closes) and
    writes the trace to ``logdir/trace-<pid>-<ms>.json``. Yields the
    profiler; its ``trace_path`` holds the file's path afterwards."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    path = os.path.join(logdir, f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path


class ProfilerServer:
    """A localhost listener that takes one request a connection, a line of
    JSON {"logdir": path, "duration_ms": n}, records a ``trace`` window of
    n ms into that directory while the process goes on, and answers with a
    line of JSON {"trace": path} (or {"error": message}). One window at a
    time; ``close`` stops it."""

    def __init__(self, port: int):
        self._sock = socket.create_server(("127.0.0.1", port))
        self.port = self._sock.getsockname()[1]
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name=f"profiler-server-{self.port}")
        self._thread.start()

    def _serve(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:       # closed
                return
            with conn:
                try:
                    req = json.loads(conn.makefile("r").readline())
                    with self._lock, trace(str(req["logdir"])) as prof:
                        time.sleep(float(req.get("duration_ms", 1000)) / 1e3)
                    reply = {"trace": prof.trace_path}
                except Exception as e:   # reported to the client, the server goes on
                    reply = {"error": f"{type(e).__name__}: {e}"}
                conn.sendall((json.dumps(reply) + "\n").encode())

    def close(self) -> None:
        self._sock.close()
        self._thread.join(timeout=5)


def start_profiler_server(port: int = 9999) -> ProfilerServer:
    """Starts a ``ProfilerServer`` on localhost:``port`` (0: a free port,
    read back from ``.port``)."""
    return ProfilerServer(port)


def capture(port: int, logdir: str, duration_ms: int = 1000,
            timeout_s: Optional[float] = None) -> str:
    """Asks the profiler server on localhost:``port`` for a window of
    ``duration_ms`` into ``logdir``; returns the trace file's path."""
    timeout_s = timeout_s if timeout_s is not None else duration_ms / 1e3 + 60.0
    with socket.create_connection(("127.0.0.1", port), timeout=timeout_s) as s:
        s.sendall((json.dumps({"logdir": logdir, "duration_ms": duration_ms})
                   + "\n").encode())
        reply = json.loads(s.makefile("r").readline())
    if "error" in reply:
        raise RuntimeError(f"profiler server: {reply['error']}")
    return reply["trace"]


def _is_program_span(e) -> bool:
    return (getattr(e, "is_user_annotation", False)
            and e.name.split(".", 1)[0] in LAYERS and "." in e.name)


def _innermost(times: Iterable[float], spans: List[Tuple[float, float, str]]
               ) -> List[Optional[str]]:
    """For each time (in increasing order), the innermost program span
    running at it: the latest-started one that has not ended (spans nest),
    or None."""
    spans = sorted(spans)
    heap: List[Tuple[float, float, str]] = []
    out, i = [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            heapq.heappush(heap, (-spans[i][0], spans[i][1], spans[i][2]))
            i += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def _parse(events):
    """(device operations [(start, end, name, owner)], program spans
    [(start, end, name)]), in milliseconds. A device operation's owner is
    the innermost program span at its launch, the runtime call
    (``cuda*``/``cu*``) that shares its correlation id; OUTSIDE where no
    span runs there, and UNSEEN where the slice holds no such call."""
    from torch.autograd import DeviceType
    dev, spans, launch_at = [], [], {}
    for e in events:
        a, b = e.time_range.start / 1e3, e.time_range.end / 1e3
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append((a, b, e.name, e.id))
        elif e.device_type == DeviceType.CPU:
            if e.name.startswith("cu"):
                launch_at[e.id] = a
            elif _is_program_span(e):
                spans.append((a, b, e.name))
    seen = sorted((launch_at[d[3]], k) for k, d in enumerate(dev) if d[3] in launch_at)
    owner = [UNSEEN] * len(dev)
    for (_, k), name in zip(seen, _innermost([t for t, _ in seen], spans)):
        owner[k] = name or OUTSIDE
    return [(a, b, n, o) for (a, b, n, _), o in zip(dev, owner)], spans


def span_table(events, items: int = 1) -> Dict[str, Dict[str, float]]:
    """From a torch.profiler slice recorded on the host and the device
    (``prof.events()``) over ``items`` frames or steps: for each program
    span name, and for OUTSIDE (the caller's code around the program),
    {"count": ranges, "host_ms": their host time, "self_ms": that less
    their child spans' time, "device_ms": device operations launched
    while the span was the innermost program span}, each an item. Host
    ops (``aten::``, autograd Functions) take no part: what they launch
    belongs to the program span around them. The rows' device_ms sum to
    the device operations' time."""
    ops, spans = _parse(events)
    table: Dict[str, Dict[str, float]] = {}

    def row(name):
        return table.setdefault(name, {"count": 0.0, "host_ms": 0.0, "self_ms": 0.0,
                                       "device_ms": 0.0})

    stack: List[List] = []       # the open spans: [end, name, children's ms, ms]

    def close(entry):
        row(entry[1])["self_ms"] += entry[3] - entry[2]

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            close(stack.pop())
        if stack:
            stack[-1][2] += b - a
        r = row(name)
        r["count"] += 1
        r["host_ms"] += b - a
        stack.append([b, name, 0.0, b - a])
    while stack:
        close(stack.pop())
    for a, b, _, owner in ops:
        row(owner)["device_ms"] += b - a
    return {name: {k: v / items for k, v in r.items()} for name, r in table.items()}


def launches_by_span(events, items: int = 1) -> Dict[Tuple[str, str], List[float]]:
    """{(owner, device operation's name): [launches, device ms]} an item,
    the owner as ``span_table`` assigns it (the innermost program span at
    the launch)."""
    out: Dict[Tuple[str, str], List[float]] = {}
    for a, b, name, owner in _parse(events)[0]:
        t = out.setdefault((owner, name), [0.0, 0.0])
        t[0] += 1.0 / items
        t[1] += (b - a) / items
    return out
