"""Device selection for the port's entry points, and the timers and card
query that its scripts share."""
from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Callable, Dict, Optional, Union

import torch

from . import profiling

# profiler windows that ``device_ms_by_kernel`` runs before it gives up
_PROFILER_WINDOWS = 3


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """Entry points run on ``cuda`` unless the caller names a device. With
    no device given and no CUDA present this raises: the port never falls
    back to the CPU without being asked to."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def cuda_ms(fn: Callable[[], object], launches: int, runs: int = 1,
            warmup: int = 1) -> float:
    """Milliseconds per call of ``fn()`` on the card: ``warmup`` calls, then
    the minimum over ``runs`` runs of ``launches`` calls between two CUDA
    events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(runs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(launches):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        best = min(best, ev[0].elapsed_time(ev[1]) / launches)
    return best


def device_ms(fn: Callable[[], object], launches: int = 200,
              warmup: int = 3) -> float:
    """Milliseconds of device time per call of ``fn()``: the self time of
    every CUDA kernel that ``torch.profiler`` records over ``launches``
    calls, summed and divided by ``launches``, after ``warmup`` calls; the
    host's time between launches does not count. Raises when the profiler
    records no device time."""
    return sum(device_ms_by_kernel(fn, launches, warmup).values())


def device_ms_by_kernel(fn: Callable[[], object], launches: int = 200,
                        warmup: int = 3, counter=None) -> Dict[str, float]:
    """``device_ms`` by CUDA kernel: {kernel name (its demangled name up to
    the argument list or template arguments, without the anonymous
    namespace): milliseconds of device time per call of ``fn()``}.

    ``counter``: the kernel wrapper (its ``launches`` count) that ``fn``
    drives. A profiler window now and then records no CUDA event at all
    (seen on the card once, at 20 calls of a 0.13 ms call, after other
    windows of the same run had recorded; cause unknown). Such a window is
    run again, up to ``_PROFILER_WINDOWS`` in all, only when ``counter``
    moved in it: the kernel launched and the profiler missed it. Without a
    counter, or when it did not move, an empty window raises. Each window
    counts ``profiler.windows`` (``profiler_windows``)."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(_PROFILER_WINDOWS):
        before = None if counter is None else counter.launches
        profiling.count("profiler.windows")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        out: Dict[str, float] = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                name = e.key[5:] if e.key.startswith("void ") else e.key
                name = re.split(r"[(<]", name.replace("(anonymous namespace)::", ""), 1)[0]
                out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / launches
        if out:
            return out
        if before is None or counter.launches == before:
            raise RuntimeError("torch.profiler recorded no device time, and no kernel "
                               "launch is known to have been missed")
    raise RuntimeError(f"torch.profiler recorded no device time in {_PROFILER_WINDOWS} "
                       "windows of launches")


def profiler_windows() -> int:
    """The profiler windows ``device_ms_by_kernel`` has opened in this
    process: a report prints it beside each reading, so that a reading
    that took more than one window shows."""
    return profiling.snapshot()["counters"].get("profiler.windows", 0)


@contextlib.contextmanager
def full_float32():
    """cuDNN's convolutions and cuBLAS's products in full float32 (no TF32)
    inside the block, whatever the process has set; its settings come back
    after. Stage II's and LPIPS's entry points run under it: the JAX
    package computes them in float32, and torch's default lets cuDNN use
    TF32."""
    cudnn = torch.backends.cudnn.allow_tf32
    matmul = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(matmul)


def host_ms(fn: Callable[[], object], launches: int, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn()`` on the host's clock: ``launches``
    calls back to back, synchronised at the end only (the host's time to
    issue them where the device keeps up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / launches


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them; raises if it fails."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]
