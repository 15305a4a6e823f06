"""The accumulation forms of the bf16 forward tile (csrc/level_train.cu,
``fw::product``'s PROMOTE), side by side on the card:

    python -m sahs_tpu_torch.tools.field_forms

Candidates: 0 (the sum carried in the tensor core over a layer's whole K),
4 and 2 (that many k16 steps, 64 or 32 k, summed there before each float32
add, round to nearest), 1 (each k16 step apart, what the path's tiles
run). For each, one JSON line with the raw field (K7 through
``nerf_level.nerf_field_tc(..., promote=)``) on the card tests' seeded
coarse level (``level_exact.coarse_level("seeded", ...)``) with the grid
and without it, at 96 rays x 128 samples (the card tests' size, two draws)
and at a step's 2048 x 128, and K11's per-point field at 2048 x 192: for
each output group (rgb, seg, sigma) the L2-relative distance of the kernel
and of the plain version from exact sums (``level_exact.exact_plain``), the
worst ratio of the two, and whether the card tests' rule holds (at most 4x
the plain version's distance, floor 1e-5). Then each candidate's time per
call at a frame's fine chunk (32,768 rays x 128 = 4,194,304 points: K5's
first launch) and at the per-point frame's fine chunk (6,291,456 points:
K11), CUDA events, the minimum of 3 runs of 3 calls; with ``--quick`` the
96-ray draws and the frame chunk alone. The last line names the form the
kernels run (``FIELD_PROMOTE``).
"""
from __future__ import annotations

import json
import sys
from typing import List, Optional

import numpy as np
import torch

from ..ops.grid import _cell_geometry, pack_corner_table
from ..ops.kernels import nerf_level as k5
from ..ops.kernels import nerf_mlp as k11
from ..utils.compare import point_errors
from ..utils.device import card_line, cuda_ms
from .level_exact import GRID, coarse_level, exact_plain

CANDIDATES = (0, 4, 2, 1)
GROUPS = (("rgb", 0, 3), ("seg", 3, 15), ("sigma", 15, 16))
MULTIPLE, FLOOR = 4.0, 1e-5      # tests/test_torch_cuda.py: PLAIN_MULTIPLE, FIELD_FLOOR


def _rays(level, table, R: int, S: int, seed: int, dev):
    """(K7's arguments as nerf_field_tc takes them, the plain version's)."""
    rng = np.random.RandomState(seed)
    g = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
    P = R * S
    pts = g(np.concatenate([rng.uniform(-1.05, 1.05, (P, 3)), rng.uniform(-1, 1, (P, 2))], 1))
    dirs = g(rng.randn(R, 3) * 0.1 + [0, 0, -1])
    grid = table is not None
    rows = _cell_geometry(pts, GRID)[0] if grid else None
    ints = k5.level_kernel_args(pts, dirs, table, rows, level, "bfloat16",
                                GRID if grid else None, "K7")[4]
    kw = dict(dirs=dirs, table=table, rows=None if rows is None else rows.to(torch.int32))
    plain = (k5.nerf_raw_plain, (pts, dirs, table, rows, level, "bfloat16",
                                 GRID if grid else None))
    return (pts, R, S, ints, kw), plain


def _points(level, P: int, seed: int, dev):
    rng = np.random.RandomState(seed)
    g = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
    pts = g(np.concatenate([rng.uniform(-1.05, 1.05, (P, 3)), rng.uniform(-1, 1, (P, 2))], 1))
    C = level.dir0_se.shape[0]
    extra = g(np.concatenate([rng.randn(P, 3) * 0.1 + [0, 0, -1], rng.randn(P, C) * 0.3], 1))
    ints = k11.point_kernel_args(pts, extra, level, "K11")[2]
    return (pts, P, 1, ints, dict(extra=extra)), (k11.nerf_mlp_plain,
                                                   (pts, extra, level, "bfloat16"))


def _rule(raw_k, raw_p, raw_x) -> dict:
    out = {}
    for name, i, j in GROUPS:
        d_k = point_errors(raw_k[:, i:j], raw_x[:, i:j])["l2_rel"]
        d_p = point_errors(raw_p[:, i:j], raw_x[:, i:j])["l2_rel"]
        out[name] = {"kernel": d_k, "plain": d_p, "ratio": d_k / max(d_p, FLOOR)}
    out["worst_ratio"] = max(v["ratio"] for v in out.values())
    out["holds"] = out["worst_ratio"] <= MULTIPLE
    return out


def _cases(dev, quick: bool):
    """[(name, level, kernel args, plain)] of the distance readings."""
    out = []
    for grid in (True, False):
        level, model = coarse_level("seeded", grid, torch.float32, dev)
        table = (pack_corner_table(model.spatial_embeddings.detach(), dtype=torch.bfloat16)
                 if grid else None)
        tag = "grid" if grid else "grid_free"
        sizes = [(96, 128, 1), (96, 128, 2)] + ([] if quick else [(2048, 128, 3)])
        for R, S, seed in sizes:
            out.append((f"K7 {tag} {R}x{S} draw {seed}", level,
                        *_rays(level, table, R, S, seed, dev)))
        if grid and not quick:
            out.append(("K11 2048x192", level, *_points(level, 2048 * 192, 4, dev)))
    return out


def main(argv: Optional[List[str]] = None) -> List[dict]:
    argv = sys.argv[1:] if argv is None else argv
    quick = "--quick" in argv
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {torch.cuda.get_device_name(dev)} | {card_line()}", flush=True)
    rows = []
    cases = _cases(dev, quick)
    refs = []
    for name, level, kargs, (plain, pargs) in cases:
        refs.append((plain(*pargs), exact_plain(plain, *pargs)))
    for promote in CANDIDATES:
        row = {"promote": promote, "distances": {}}
        for (name, level, (pts, R, S, ints, kw), _), (raw_p, raw_x) in zip(cases, refs):
            raw_k = k5.nerf_field_tc("field", pts, level, R, S, ints, promote=promote, **kw)
            torch.cuda.synchronize()
            row["distances"][name] = _rule(raw_k, raw_p, raw_x)
        row["holds"] = all(v["holds"] for v in row["distances"].values())
        rows.append(row)
    level, model = coarse_level("seeded", True, torch.float32, dev)
    table = pack_corner_table(model.spatial_embeddings.detach(), dtype=torch.bfloat16)
    shapes = [("K5 fine chunk field", _rays(level, table, 32768, 128, 5, dev)[0])]
    if not quick:
        shapes.append(("K11 frame chunk", _points(level, 32768 * 192, 6, dev)[0]))
    for name, (pts, R, S, ints, kw) in shapes:
        for row in rows:
            row.setdefault("ms", {})[name] = cuda_ms(
                lambda: k5.nerf_field_tc("field", pts, level, R, S, ints,
                                         promote=row["promote"], **kw), 3, runs=3)
        del pts, kw
        torch.cuda.empty_cache()
    for row in rows:
        print(json.dumps(row), flush=True)
    print(json.dumps({"field_promote": k5.field_promote()}), flush=True)
    return rows


if __name__ == "__main__":
    main()
