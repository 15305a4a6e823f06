"""PyTorch + CUDA port of the SAHS deformable-NeRF framework.

Mirrors the layout of the JAX package ``sahs_tpu`` (``ops/``, ``models/``,
``render/``, ``evaluation.py``) so each module's counterpart is easy to
find. The TPU's Pallas kernels become hand-written CUDA C++ kernels for
Hopper under ``csrc/``, built with nvcc at first use
(``ops/kernels/_build.py``). This package imports torch, numpy and yaml
only; it never imports jax or ``sahs_tpu``.
"""

__version__ = "0.1.0"
