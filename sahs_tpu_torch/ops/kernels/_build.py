"""Builds the CUDA kernels of ``sahs_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` is compiled on its own by nvcc into
``build/kernels/<name>-<hash>.so`` (a shared library with a plain C
interface) and loaded with ctypes; every pointer and the stream cross as
``c_void_p``. The hash covers the sources and flags, so an edited kernel is
rebuilt and an unchanged one is reused. ``build_all`` starts one nvcc per
source, all at once, in the phase ``setup.kernels``; each nvcc run counts
``kernels.built`` and each library loaded ``kernels.loaded``
(utils/profiling). ``function`` is the one route to the C entry points:
each call it returns runs in the span ``launch.<symbol>``, around the
ctypes call alone.

Fast-math flags stay off: the kernels' positional encoding needs the
accurate float32 sine at angles up to 2^9 |x|.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Callable, Dict, List, Optional, Tuple

from ...utils import profiling

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
KERNELS = ("deform_pair", "nerf_level", "level_train", "deform_pair_vjp",
           "grid_bwd", "nerf_mlp", "skip_mlp", "build_pts", "exp_gather",
           "exp_pair2")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[Tuple[str, str], Callable[..., int]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _sources(name: str) -> List[str]:
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return [os.path.join(CSRC, name + ".cu")] + [os.path.join(CSRC, h)
                                                  for h in headers]


def _target(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        with open(path, "rb") as fp:
            h.update(fp.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start nvcc for one kernel unless its library is already built."""
    target = _target(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = target + f".{os.getpid()}.tmp"
    log = open(os.path.join(BUILD_DIR, name + ".log"), "w")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    profiling.count("kernels.built")
    proc.sahs_name, proc.sahs_tmp, proc.sahs_target, proc.sahs_log = (
        name, tmp, target, log)
    return proc


def _finish(proc: subprocess.Popen) -> None:
    rc = proc.wait()
    proc.sahs_log.close()
    if rc != 0:
        with open(proc.sahs_log.name) as fp:
            raise RuntimeError(f"nvcc failed for {proc.sahs_name} "
                               f"(exit {rc}):\n{fp.read()}")
    os.replace(proc.sahs_tmp, proc.sahs_target)


def build_all() -> None:
    """Build every kernel library, one nvcc per source, in parallel."""
    with profiling.phase("setup.kernels"):
        procs = [p for p in (_start(n) for n in KERNELS) if p is not None]
        try:
            for p in procs:
                _finish(p)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and spill report) of the last build."""
    path = os.path.join(BUILD_DIR, name + ".log")
    if not os.path.exists(path):
        return ""
    with open(path) as fp:
        return fp.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        proc = _start(name)
        if proc is not None:
            _finish(proc)
        lib = ctypes.CDLL(_target(name))
        profiling.count("kernels.loaded")
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes: str) -> Callable[..., int]:
    """C function ``symbol`` of kernel library ``name``, resolved and typed
    once and then kept. ``argtypes`` spells the signature, one letter per
    argument: p pointer (and stream), i int, l long long, f float. The
    result is the launch's cudaError_t. Each call runs in the span
    ``launch.<symbol>``, which holds the ctypes call alone: the kernels it
    launches are owned by that span in a trace. The typed C function is
    the callable's ``fn``."""
    call = _FUNCS.get((name, symbol))
    if call is None:
        fn = getattr(load(name), symbol)
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int,
                 "l": ctypes.c_longlong, "f": ctypes.c_float}
        fn.argtypes = [kinds[c] for c in argtypes]
        fn.restype = ctypes.c_int
        call = _FUNCS[(name, symbol)] = _launch_span(fn, "launch." + symbol)
    return call


def _launch_span(fn, span_name: str) -> Callable[..., int]:
    def call(*args):
        with profiling.span(span_name):
            return fn(*args)
    call.fn = fn
    return call


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_ptr(device) -> int:
    """The raw handle of ``device``'s current CUDA stream, asked for on
    every call (a caller may change it), without building a Stream."""
    import torch
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)
