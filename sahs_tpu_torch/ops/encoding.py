"""Positional encoding (counterpart of ``sahs_tpu/ops/encoding.py``).

Layout parity with the reference (nerf-pytorch/nerf/nerf_helpers.py:305-359):
output = [x?, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...] with each
block spanning all input channels.
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch


def frequency_bands(num_encoding_functions: int,
                    log_sampling: bool = True) -> np.ndarray:
    """Static host-side frequency table (nerf_helpers.py:324-339)."""
    if num_encoding_functions <= 0:
        return np.zeros((0,), dtype=np.float32)
    if log_sampling:
        return (2.0 ** np.linspace(0.0, num_encoding_functions - 1,
                                   num_encoding_functions)).astype(np.float32)
    return np.linspace(2.0 ** 0.0, 2.0 ** (num_encoding_functions - 1),
                       num_encoding_functions).astype(np.float32)


def positional_encoding(x: torch.Tensor, num_encoding_functions: int = 6,
                        include_input: bool = True,
                        log_sampling: bool = True) -> torch.Tensor:
    if num_encoding_functions == 0:
        return x if include_input else x[..., :0]
    freqs = torch.as_tensor(
        frequency_bands(num_encoding_functions, log_sampling),
        dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]                  # (..., F, D)
    sc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)
    sc = sc.reshape(x.shape[:-1] + (2 * num_encoding_functions * x.shape[-1],))
    if include_input:
        return torch.cat([x, sc], dim=-1)
    return sc


def encoded_dim(input_dim: int, num_encoding_functions: int,
                include_input: bool = True) -> int:
    return (input_dim if include_input else 0) + 2 * input_dim * num_encoding_functions


def get_embedding_function(num_encoding_functions: int = 6,
                           include_input: bool = True,
                           log_sampling: bool = True
                           ) -> Callable[[torch.Tensor], torch.Tensor]:
    return functools.partial(
        positional_encoding,
        num_encoding_functions=num_encoding_functions,
        include_input=include_input,
        log_sampling=log_sampling,
    )
