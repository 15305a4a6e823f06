"""The host C++ codec of the data path (``codec.cpp``): the parse-map
palette match and its inverses, bound with ctypes.

``g++ -O3 -shared -fPIC`` builds ``codec.cpp`` at first use into
``build/native/codec-<hash>.so`` beside the package (the hash covers the
source and the flags; no ``-march=native``, since the build directory may
move between machines), written under a temporary name and renamed, so
that processes building at once do not read a half-written library. A
build or load that fails raises: there is no fallback to the numpy
version, which stays as the plain version that the tests hold the codec
against (``data/common.palette_labels``). The library the JAX package
carries is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "codec.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "native")
FLAGS = ["-O3", "-shared", "-fPIC"]

_LIB: Optional[ctypes.CDLL] = None


def library_path() -> str:
    """Where the build of the current source and flags lives."""
    with open(SOURCE, "rb") as fp:
        digest = hashlib.sha256(fp.read() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"codec-{digest}.so")


def build() -> str:
    """Build the library unless it exists; returns its path. Raises
    RuntimeError with the compiler's output when g++ fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run(["g++", *FLAGS, SOURCE, "-o", tmp],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE}:\n{r.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def lib() -> ctypes.CDLL:
    """The loaded codec, built at first use."""
    global _LIB
    if _LIB is None:
        so = ctypes.CDLL(build())
        for name in ("palette_to_labels", "labels_to_onehot", "labels_to_colors_bgr"):
            fn = getattr(so, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
            fn.restype = None
        _LIB = so
    return _LIB


def palette_to_labels(bgr: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 BGR-read parse map -> (H, W) uint8 labels."""
    bgr = np.ascontiguousarray(bgr, dtype=np.uint8)
    h, w = bgr.shape[:2]
    out = np.empty((h * w,), np.uint8)
    lib().palette_to_labels(bgr.ctypes.data, h * w, out.ctypes.data)
    return out.reshape(h, w)


def labels_to_onehot(labels: np.ndarray) -> np.ndarray:
    """(...) uint8 labels -> (..., 12) float32 one-hot."""
    labels = np.ascontiguousarray(labels, dtype=np.uint8)
    out = np.empty(labels.shape + (12,), np.float32)
    lib().labels_to_onehot(labels.ctypes.data, labels.size, out.ctypes.data)
    return out


def labels_to_colors_bgr(labels: np.ndarray) -> np.ndarray:
    """(...) uint8 labels -> (..., 3) uint8 colours, the palette reversed
    per pixel (label2color's order)."""
    labels = np.ascontiguousarray(labels, dtype=np.uint8)
    out = np.empty(labels.shape + (3,), np.uint8)
    lib().labels_to_colors_bgr(labels.ctypes.data, labels.size, out.ctypes.data)
    return out
