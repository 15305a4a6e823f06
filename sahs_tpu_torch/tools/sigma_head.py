"""How well sigma's head gradient is conditioned without a background, on
the card: K2 (the level train kernel) against its plain version and both
against a float64 run of the plain version, for the coarse level of the
grid-free flagship model at the card tests' seeded init (sigma's bias 0.5,
the rgb head x100), the same level with colours that vary along a ray
(biases zeroed but sigma's, the first direction layer's feat block x30,
the rgb head x300; ``tests/test_torch_cuda.py:grid_free_varied``), and the
grid model's level at the seeded init. Without a background every ray's
weights add up to 1, so sigma's gradient is a difference of a ray's
colours. For the seeded grid-free level it also separates the forward from
the backward: the raw colour logits of K7 against the plain version's, the
cotangent of sigma that the plain compositing gives on each, and K8 given
the plain compositing's cotangents against the plain backward.

    python -m sahs_tpu_torch.tools.sigma_head

prints one JSON line per case.
"""
from __future__ import annotations

import json
import sys
from typing import List, Optional

import numpy as np
import torch

from ..ops.grid import _cell_geometry, pack_corner_table
from ..ops.kernels import field_mlp
from ..ops.kernels import level_train as k2
from ..ops.kernels import nerf_level as k5
from ..utils.compare import tree_errors
from ..utils.device import card_line, resolve_device
from .level_exact import coarse_level, exact_sums

GRID = (32, 32, 32)
R, S = 96, 128


def draw(seed: int, dtype: torch.dtype, dev):
    """pts, dirs, z, noise, tgt, lw of R rays x S samples, no background."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=dev)
    pts = t(np.concatenate([rng.uniform(-1.05, 1.05, (R * S, 3)),
                            rng.uniform(-1, 1, (R * S, 2))], 1))
    dirs = t(rng.randn(R, 3) * 0.1 + [0, 0, -1])
    z = t(np.sort(rng.uniform(0.48, 1.08, (R, S)), axis=-1))
    noise = t(rng.randn(R, S) * 0.5)
    tgt = t(np.concatenate([rng.rand(R, 3), np.eye(12)[rng.randint(0, 12, R)]], 1))
    lw = t(np.stack([np.full(R, 1.0 / R), np.full(R, 0.02 / R)], 1))
    return pts, dirs, z, noise, tgt, lw


def head_error(a, b) -> float:
    """||a - b|| / ||b|| of fc_alpha's weight gradient."""
    x, y = a["fc_alpha"]["w"].double(), b["fc_alpha"]["w"].double()
    return float((x - y).norm() / y.norm())


def grid_args(model, pts, grid: bool, dtype):
    if not grid:
        return None, None
    rows, _, _ = _cell_geometry(pts, GRID)
    return pack_corner_table(model.spatial_embeddings.detach(), dtype=dtype), rows


def case(kind: str, grid: bool, seed: int, compute_dtype: str, dev) -> dict:
    with exact_sums(round_operands=False):
        lvl, model = coarse_level(kind, grid, torch.float64, dev)
        pts, dirs, z, noise, tgt, lw = draw(seed, torch.float64, dev)
        table, rows = grid_args(model, pts, grid, torch.float64)
        ref = k2.nerf_level_train_plain(pts, dirs, table, rows, z, None, noise,
                                        tgt, lw, lvl, "float32", GRID)[5]
    lvl, model = coarse_level(kind, grid, torch.float32, dev)
    pts, dirs, z, noise, tgt, lw = draw(seed, torch.float32, dev)
    table, rows = grid_args(model, pts, grid, field_mlp.torch_dtype(compute_dtype))
    args = (pts, dirs, table, rows, z, None, noise, tgt, lw, lvl, compute_dtype, GRID)
    g_k = k2.nerf_level_train(*args)[5]
    g_p = k2.nerf_level_train_plain(*args)[5]
    worst = tree_errors(g_k, g_p)
    raw = k5.nerf_raw_plain(pts, dirs, table, rows, lvl, compute_dtype, GRID)
    logits = raw[:, :3].reshape(R, S, 3)
    row = {"level": kind, "grid": grid, "draw": seed, "dtype": compute_dtype,
           "k2_vs_plain": worst["l2_rel"], "worst_leaf": worst["worst_leaf"],
           "head_k2_vs_plain": head_error(g_k, g_p),
           "head_k2_vs_float64": head_error(g_k, ref),
           "head_plain_vs_float64": head_error(g_p, ref),
           "head_norm_float64": float(ref["fc_alpha"]["w"].norm()),
           "logit_mean_abs": float(logits.abs().mean()),
           "logit_spread_along_ray": float(logits.std(dim=1).mean())}
    if kind == "seeded" and not grid:
        raw_k = k5.nerf_rayd_forward(pts, dirs, table, rows, lvl, compute_dtype, GRID)
        comp = lambda r: k2.composite_train_plain(r.reshape(R, S, 16), z, dirs, None,
                                                  noise, tgt, lw, 0.0)[2].reshape(-1, 16)
        g_raw_p, g_raw_k = comp(raw), comp(raw_k)
        ds_p, ds_k = g_raw_p[:, 15].double(), g_raw_k[:, 15].double()
        g8 = k2.nerf_rayd_vjp(pts, dirs, table, rows, g_raw_p, lvl, compute_dtype, GRID)[2]
        g8p = k2.nerf_rayd_vjp_plain(pts, dirs, table, rows, g_raw_p, lvl,
                                     compute_dtype, GRID)[2]
        row.update(logit_k7_vs_plain_max=float((raw_k[:, :3] - raw[:, :3]).abs().max()),
                   dsigma_k7_vs_plain=float((ds_k - ds_p).norm() / ds_p.norm()),
                   head_k8_vs_plain_same_cotangents=head_error(g8, g8p))
    return row


def main(argv: Optional[List[str]] = None, device=None) -> List[dict]:
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"card: {torch.cuda.get_device_name(dev)} | {card_line()}", flush=True)
    rows = []
    for kind, grid in (("seeded", False), ("varied", False), ("seeded", True)):
        for seed in (1, 2):
            for compute_dtype in ("float32", "bfloat16"):
                rows.append(case(kind, grid, seed, compute_dtype, dev))
                print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
