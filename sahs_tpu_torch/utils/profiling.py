"""Profiling hooks (counterpart of ``sahs_tpu/utils/profiling.py``):

  - ``trace(logdir)``: a context manager that records everything inside
    with ``torch.profiler`` (CPU, and CUDA where there is a card) and
    writes one Chrome trace file into ``logdir``;
  - ``start_profiler_server(port)``: the counterpart of
    ``jax.profiler.start_server``, a capture on demand from outside the
    process: a TCP listener on localhost that, for each request, records a
    ``trace`` window of the requested length into the requested directory
    (``capture`` is its client; the standard library only);
  - ``Throughput``: the rolling rays/s or steps/s counter of the trainers.
"""
from __future__ import annotations

import contextlib
import json
import os
import socket
import threading
import time
from collections import deque
from typing import Optional


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


class Throughput:
    """Rolling-window throughput counter."""

    def __init__(self, window: int = 50):
        self._times = deque(maxlen=window)
        self._units = deque(maxlen=window)

    def tick(self, units: float) -> None:
        self._times.append(time.time())
        self._units.append(units)

    def per_second(self) -> Optional[float]:
        if len(self._times) < 2:
            return None
        dt = self._times[-1] - self._times[0]
        if dt <= 0:
            return None
        return sum(list(self._units)[1:]) / dt
