"""The port's CUDA kernel libraries, built on a checkout's first run into
``build/kernels`` (``_build.BUILD_DIR``) and found there by every later run.

nvcc writes its intermediate files under ``TMPDIR``. The build points it at
``build/nvcc_tmp`` inside the checkout, a fixed directory that it makes
itself, so that the build does not depend on the directory a run is given
as ``TMPDIR`` being there and writable.
"""
from __future__ import annotations

import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NVCC_TMP = os.path.join(ROOT, "build", "nvcc_tmp")


def build() -> None:
    """Build the kernel libraries that are not built yet; ``TMPDIR`` is
    restored after."""
    from sahs_tpu_torch.ops.kernels import _build
    os.makedirs(NVCC_TMP, exist_ok=True)
    saved = os.environ.get("TMPDIR")
    os.environ["TMPDIR"] = NVCC_TMP
    try:
        _build.build_all()
    finally:
        if saved is None:
            os.environ.pop("TMPDIR", None)
        else:
            os.environ["TMPDIR"] = saved
