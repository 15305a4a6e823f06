"""Reading torch.profiler slices of the window: device time by kernel,
the seconds in which the device ran anything, and the idle gaps named by
what the host was doing.

A slice covers whole frames or train calls between two synchronisations,
so its length on the host's clock is the traced window. A CUDA event's
times share the CPU events' clock in the profiler's events.
"""
from __future__ import annotations

import heapq
import time
from typing import Dict, List, Tuple

from .arith import short_name

TOP = 10


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _name_gaps(gaps: List[Tuple[float, float]], cpu: List[Tuple[float, float, str]]
               ) -> List[str]:
    """For each gap (in increasing order), the innermost host op running at
    its midpoint: the latest-started op that has not ended."""
    ops = sorted(cpu)
    heap: List[Tuple[float, float, str]] = []
    names, i = [], 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while i < len(ops) and ops[i][0] <= mid:
            heapq.heappush(heap, (-ops[i][0], ops[i][1], ops[i][2]))
            i += 1
        while heap and heap[0][1] <= mid:
            heapq.heappop(heap)
        names.append(heap[0][2] if heap else "(no host op)")
    return names


def _events(events):
    """(device intervals with names, host op intervals with names), in
    seconds; the device's user annotations (ranges, not operations) left
    out."""
    from torch.autograd import DeviceType
    dev: List[Tuple[float, float, str]] = []
    cpu: List[Tuple[float, float, str]] = []
    for e in events:
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append((a, b, short_name(e.name)))
        elif e.device_type == DeviceType.CPU and not e.name.startswith(("cuda", "ProfilerStep")):
            cpu.append((a, b, e.name))
    return dev, cpu


def device_summary(events, window_s: float, items: int) -> Dict:
    """From a slice traced on the device alone: {"kernels": {name: device
    seconds an item}, "busy_s": seconds in which any device operation
    (kernels, copies, fills) ran, "window_s", "items", "device_ops": the
    top ones [name, seconds an item]}."""
    dev, _ = _events(events)
    kernels: Dict[str, float] = {}
    for a, b, n in dev:
        kernels[n] = kernels.get(n, 0.0) + (b - a) / items
    busy_s = sum(b - a for a, b in _union([(a, b) for a, b, _ in dev]))
    return {"kernels": kernels, "busy_s": busy_s, "window_s": window_s, "items": items,
            "device_ops": _top(kernels)}


def idle_gaps(events, items: int) -> List:
    """From a slice traced on the host and the device: the host ops that
    were running while the device was idle, [name, idle seconds an item],
    the top ones. Each gap is named by the innermost op at its midpoint."""
    dev, cpu = _events(events)
    busy = _union([(a, b) for a, b, _ in dev])
    if not busy:
        return []
    span = [x for a, b, _ in cpu for x in (a, b)]
    edges = [min(span + [busy[0][0]])] + [x for ab in busy for x in ab] + [
        max(span + [busy[-1][1]])]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    idle: Dict[str, float] = {}
    for (a, b), name in zip(gaps, _name_gaps(gaps, cpu)):
        idle[name] = idle.get(name, 0.0) + (b - a) / items
    return _top(idle)


def _top(d: Dict[str, float]) -> List:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


class Tracer:
    """Two profiled slices of a window of items (frames or calls): from
    item ``first``, ``n_device`` items traced on the device alone (the
    per-layer metrics: the host's own ops are not recorded, so the host
    runs near its untraced pace), then ``n_host`` items traced on the host
    and the device (the idle gaps' names). Each slice is led by one item
    under a profiler that is on but keeps nothing (its start-up costs the
    first launches), and its recorded items lie between two
    synchronisations."""

    def __init__(self, first: int, n_device: int, n_host: int, items_per: int, sync):
        self.slices = [(first, n_device, False), (first + n_device + 1, n_host, True)]
        self.items_per, self.sync = items_per, sync
        self.prof = None
        self.out: Dict = {}

    def before(self, i: int) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule
        for start, n, cpu in self.slices:
            if i == start:
                acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
                if cpu or not acts:
                    acts.append(ProfilerActivity.CPU)
                self.sync()
                self.prof = profile(activities=acts,
                                    schedule=schedule(wait=0, warmup=1, active=n, repeat=1))
                self.prof.start()

    def after(self, i: int) -> None:
        for start, n, cpu in self.slices:
            if start <= i <= start + n:
                self.sync()
                if i == start:
                    self.t0 = time.perf_counter()
                window = time.perf_counter() - self.t0
                self.prof.step()
                if i == start + n:
                    self.prof.stop()
                    events = self.prof.events()
                    self.prof = None
                    if cpu:
                        self.out["idle_gaps"] = idle_gaps(events, n * self.items_per)
                    else:
                        self.out.update(device_summary(events, window, n * self.items_per))

    def done(self, i: int) -> bool:
        start, n, _ = self.slices[-1]
        return i >= start + n
