"""Grid-coupled NeRF level: the corner table (counterpart of
``sahs_tpu/ops/pallas/field_grid.py``, forward only).

The JAX op ``nerf_render_level_grid`` spans an XLA row gather of the corner
table and the Pallas level kernel (field_grid.py:195-212). Here K5
(``nerf_level.nerf_level_forward``) gathers the rows itself, so the op is
``corner_table`` once per frame, next to the folded weights, and then one
K5 launch per level and chunk.
"""
from __future__ import annotations

import torch

from ..grid import pack_corner_table
from .field_mlp import torch_dtype


def corner_table(grid: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """(C, D, H, W) grid -> ((D+1)(H+1)(W+1), 8C) corner table in the
    compute dtype: bf16 when compute_dtype is bfloat16, as the JAX op
    casts it."""
    with torch.no_grad():
        return pack_corner_table(grid, dtype=torch_dtype(compute_dtype))


def gather_corners_from_rows(grid: torch.Tensor, rows: torch.Tensor,
                             compute_dtype: str) -> torch.Tensor:
    """(C, D, H, W) grid + table rows (any shape) -> (P, 8C) corner rows, in
    bf16 when compute_dtype is bfloat16 (field_grid.py:67-77)."""
    return corner_table(grid, compute_dtype)[rows.reshape(-1).long()]
