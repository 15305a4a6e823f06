"""Where the bf16 level backward's per-point cotangents are off: K6
(``nerf_level_vjp``) and its plain version against exact sums at the card
tests' size, on the card:

    python -m sahs_tpu_torch.tools.point_spread

For each case, draw and per-point output (gx, gse, g_bg) one JSON line:
the L2-relative distance to exact sums (``tools/level_exact.exact_plain``:
the same bf16 operands, float64 sums) of the kernel and of the plain
version, the share of the squared distance that the worst 10 points and
the worst 1 % of the points carry, the distance without that 1 %, how
many of the kernel's worst 10 points are among the plain version's, and
what the kink-point gate of the card tests sees (``utils/compare``): the
share of kink points, the points each side excuses (kink points off by
more than ``KINK_TOL``) against the cap (``KINK_SHARE``), the distance
over the rest, and how close to its kink the nearest pre-activation of
each of the kernel's worst 10 points lies (``kink_distance``). For dW
(``dw``) it prints the worst leaf's L2-relative distance to exact sums of
the kernel and of the plain version (the card tests' 4x rule reads it) and
where that distance comes from: K6's dW is a sum over rays, so each of
the kink rays (a ray that holds a ``kink_points`` point), the rays that
hold a point the kernel's gx gate excuses and those that hold one the
plain version's would excuse is run on its own, with the other rays
apart; for each part the kernel's and the plain version's distance from
exact sums in that leaf, over the whole leaf's norm, the share of the
squared distance that the part carries, and the rule read over the rays
without an excused point alone; and (``own_side``, on the card) the same
rule and gx with each side held against the reference that takes its own
branch at the kink points where its gx is off
(``level_exact.exact_plain_at_branches``). In the grid-free case
``k2_dw`` splits K2's dW (``nerf_level_train``, on the test's next draw
of a target) the same way, over the kink rays and the rays holding a
kink point where K2's gx is off by more than ``KINK_TOL``. The cases are
two card tests of ``tests/test_torch_cuda.py`` (96 rays, with a
background): ``test_nerf_level_vjp_kernel_matches_plain`` at 64 samples
on the flagship's seeded coarse level, and
``test_grid_free_level_kernels_match_plain`` at 16 samples with sigma
noise on the grid-free one, each level conditioned as the tests' fixtures
condition it; the draws are each test's own (its ``rng`` fixture: a crc32
of its node id) and four others.
"""
from __future__ import annotations

import json
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import nerface
from ..ops.grid import _cell_geometry, pack_corner_table
from ..ops.kernels import level_train as k2
from ..ops.kernels import nerf_level as k5
from ..utils import compare
from ..utils.device import card_line, resolve_device
from ..utils.compare import leaves, point_errors, tree_errors
from .level_exact import (GRID, coarse_level, exact_acts, exact_plain,
                          exact_plain_at_branches, kernel_branches, plain_branches)

# case -> (the card test's node id, grid, samples, sigma noise, the seed of
# its level's conditioning)
CASES = {
    "grid S=64": ("tests/test_torch_cuda.py::test_nerf_level_vjp_kernel_matches_plain"
                  "[64-True-False-bfloat16]", True, 64, False, 0),
    "grid-free S=16": ("tests/test_torch_cuda.py::test_grid_free_level_kernels_match_plain"
                       "[16-True-True-bfloat16]", False, 16, True, 1),
}
R = 96


def spread(a: torch.Tensor, x: torch.Tensor) -> Dict[str, object]:
    """How ``a`` (P, C) is off ``x``: its L2-relative distance, the share
    of the squared distance in its worst 10 points and worst 1 %, the
    distance without that 1 %, and the worst 10 points."""
    e = (a.double() - x.double()).norm(dim=1) ** 2
    xn = x.double().norm(dim=1) ** 2
    order = e.argsort(descending=True)
    k = max(1, e.numel() // 100)
    total = float(e.sum())
    keep = order[k:]
    return {"l2_rel": (total / float(xn.sum())) ** 0.5,
            "top10_share": float(e[order[:10]].sum()) / total,
            "top1pct_share": float(e[order[:k]].sum()) / total,
            "l2_rel_without_top1pct": float((e[keep].sum() / xn[keep].sum()).sqrt()),
            "worst10": order[:10].tolist()}


def kink_distance(acts: dict) -> torch.Tensor:
    """(P,) the distance to 0 of each point's nearest leaky-ReLU
    pre-activation, over its unit's RMS over the points (``acts`` as
    ``compare.kink_points`` reads them: a point is a kink point where this
    is at most ``compare.KINK_EPS``)."""
    d = None
    for y in list(acts["trunk"]) + list(acts["dacts"]) + list(acts["sacts"]):
        v = torch.where(y >= 0, y, y / 0.01).double()
        r = (v.abs() / v.pow(2).mean(dim=0, keepdim=True).sqrt()).amin(dim=1)
        d = r if d is None else torch.minimum(d, r)
    return d


def excusal(a: torch.Tensor, x: torch.Tensor, kinks: torch.Tensor) -> dict:
    """The card tests' kink gate on ``a`` against exact sums ``x``: the
    kink points off by more than ``KINK_TOL`` (excused), the most it may
    excuse (``kink_cap``) and the L2-relative distance over the rest."""
    off = compare.excused_points(a, x, kinks)
    keep = ~off
    d = (a.double()[keep] - x.double()[keep]).norm() / x.double()[keep].norm()
    return {"excused": int(off.sum()), "cap": compare.kink_cap(off.numel()),
            "l2_rel_without_excused": float(d)}


def ray_subset(vargs: tuple, keep: torch.Tensor, S: int) -> tuple:
    """K6's (or K2's) arguments ``vargs`` on the rays ``keep`` (R,) bool
    alone: K2's target and loss weights stand where K6's cotangents do."""
    pts, dirs, table, rows, z, bg, noise, g_rgb, g_w = vargs[:9]
    pk = keep.repeat_interleave(S)
    sel = lambda t, m: None if t is None else t[m]
    rows = None if rows is None else rows.reshape(-1)
    return (pts[pk], dirs[keep], table, sel(rows, pk), z[keep], sel(bg, keep),
            sel(noise, keep), g_rgb[keep], g_w[keep]) + tuple(vargs[9:])


def dw_split(vargs: tuple, S: int, masks: Dict[str, torch.Tensor],
             g_k: dict, g_p: dict, g_x: dict, kernel=k2.nerf_level_vjp,
             plain=k2.nerf_level_vjp_plain) -> dict:
    """Where the dW distance from exact sums of K6 (or of K2: ``kernel``
    and ``plain`` given) comes from. ``g_k``, ``g_p``, ``g_x`` are the
    kernel's, the plain version's and the exact-sum dW over every ray; for
    each ray mask the same three are run on the rays in the mask and on
    the others, and the worst leaf's distances read."""
    e_k, e_p = tree_errors(g_k, g_x), tree_errors(g_p, g_x)
    leaf = e_k["worst_leaf"]
    pick = lambda t: dict(leaves(t))[leaf].double()
    xn = float(pick(g_x).norm())
    res = {"worst_leaf": leaf, "kernel": e_k["l2_rel"], "plain": e_p["l2_rel"],
           "ratio": e_k["l2_rel"] / max(e_p["l2_rel"], 1e-3)}
    for name, m in masks.items():
        row = {"rays": int(m.sum())}
        sq = {"kernel": {}, "plain": {}}
        for part, keep in (("with", m), ("without", ~m)):
            if not bool(keep.any()):
                row[part] = None
                sq["kernel"][part] = sq["plain"][part] = 0.0
                continue
            sub = ray_subset(vargs, keep, S)
            sk, sp = kernel(*sub)[-1], plain(*sub)[-1]
            sx = exact_plain(plain, *sub)[-1]
            dk = float((pick(sk) - pick(sx)).norm())
            dp = float((pick(sp) - pick(sx)).norm())
            sq["kernel"][part], sq["plain"][part] = dk ** 2, dp ** 2
            rk, rp = tree_errors(sk, sx)["l2_rel"], tree_errors(sp, sx)["l2_rel"]
            row[part] = {"kernel": dk / xn, "plain": dp / xn,
                         "rule_kernel": rk, "rule_plain": rp,
                         "rule_ratio": rk / max(rp, 1e-3)}
        for who in ("kernel", "plain"):
            tot = sq[who]["with"] + sq[who]["without"]
            row[f"{who}_share_with"] = sq[who]["with"] / tot if tot > 0 else 0.0
        res[name] = row
    return res


def level_of(grid: bool, cond_seed: int, dev):
    """The card tests' seeded coarse level (``coarse_level("seeded")``)
    conditioned on ``RandomState(cond_seed).randn(112) * 0.5``, as their
    fixtures draw it, and its corner table (None without the grid)."""
    _, model = coarse_level("seeded", grid, torch.float32, dev)
    cond = np.random.RandomState(cond_seed).randn(76 + 36).astype(np.float32) * 0.5
    _, pts_g, dir_g = nerface.build_pe_groups(model.spec)
    level = k5.prepare_level(model.coarse, torch.tensor(cond[76:], device=dev),
                             pts_g, dir_g)
    table = (pack_corner_table(model.spatial_embeddings.detach(), dtype=torch.bfloat16)
             if grid else None)
    return level, table


def case(level, table, grid: bool, S: int, with_noise: bool, seed: int, dev) -> dict:
    """One draw, as the card tests make it (their ``_level_case`` or
    ``_grid_free_case`` and ``_loss_cotangents``)."""
    rng = np.random.RandomState(seed)
    g = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
    P = R * S
    pts = g(np.concatenate([rng.uniform(-1.05, 1.05, (P, 3)), rng.uniform(-1, 1, (P, 2))], 1))
    dirs = g(rng.randn(R, 3) * 0.1 + [0, 0, -1])
    z = g(np.sort(rng.uniform(0.48, 1.08, (R, S)), axis=-1))
    bg = g(rng.rand(R, 15))
    noise = g(rng.randn(R, S) * 0.5) if with_noise else None
    rows = _cell_geometry(pts, GRID)[0] if grid else None
    dims = GRID if grid else None
    args = (pts, dirs, table, rows, z, bg, noise)
    rgb, w = k5.nerf_level_plain(*args, level, "bfloat16", dims)
    tgt = g(np.concatenate([rng.rand(R, 3), np.eye(12)[rng.randint(0, 12, R)]], 1))
    g_rgb = torch.cat([2.0 * (rgb[:, :3] - tgt[:, :3]) / R,
                       -0.02 * tgt[:, 3:15] / (rgb[:, 3:15] + 1e-10) / R,
                       torch.zeros_like(rgb[:, :1])], dim=-1)
    g_w = torch.zeros_like(w)
    g_w[:, -1] = g(rng.rand(R)) * 1e-3
    vargs = args + (g_rgb, g_w, level, "bfloat16", dims)
    out_k = k2.nerf_level_vjp(*vargs)
    out_p = k2.nerf_level_vjp_plain(*vargs)
    out_x = exact_plain(k2.nerf_level_vjp_plain, *vargs)
    acts = exact_acts(k5.nerf_raw_plain, pts, dirs, table, rows, level, "bfloat16", dims)
    kinks, near = compare.kink_points(acts), kink_distance(acts)
    res = {"kink_share": float(kinks.double().mean())}
    by_ray = lambda m: m.reshape(R, S).any(dim=1)
    off_k = compare.excused_points(out_k[0], out_x[0], kinks)
    off_p = compare.excused_points(out_p[0], out_x[0], kinks)
    res["dw"] = dw_split(vargs, S, {"kink_rays": by_ray(kinks),
                                    "kernel_excused_rays": by_ray(off_k),
                                    "plain_excused_rays": by_ray(off_p)},
                         out_k[3], out_p[3], out_x[3])
    if dev.type == "cuda":
        # each side against the reference on its own branch at the kink
        # points where its gx is off (level_exact.exact_plain_at_branches)
        plain = k2.nerf_level_vjp_plain
        x_k = exact_plain_at_branches(plain, vargs, off_k, kernel_branches(vargs))
        x_p = exact_plain_at_branches(plain, vargs, off_p, plain_branches(vargs))
        e_k, e_p = tree_errors(out_k[3], x_k[3]), tree_errors(out_p[3], x_p[3])
        res["dw"]["own_side"] = {
            "kernel_points": int(off_k.sum()), "plain_points": int(off_p.sum()),
            "kernel": e_k["l2_rel"], "plain": e_p["l2_rel"], "worst_leaf": e_k["worst_leaf"],
            "ratio": e_k["l2_rel"] / max(e_p["l2_rel"], 1e-3),
            "gx_kernel": point_errors(out_k[0], x_k[0])["l2_rel"],
            "gx_plain": point_errors(out_p[0], x_p[0])["l2_rel"],
            "gx_kernel_excused": int(compare.excused_points(out_k[0], x_k[0], kinks).sum())}
    if not grid:
        # the grid-free test also holds K2 on a target drawn after the
        # cotangents' (its gx has no kink gate): where its dW distance sits
        tgt = g(np.concatenate([rng.rand(R, 3), np.eye(12)[rng.randint(0, 12, R)]], 1))
        lw = g(np.stack([np.full(R, 1.0 / R), np.full(R, 0.02 / R)], 1))
        targs = args + (tgt, lw, level, "bfloat16", dims, 0.5)
        t_k = k2.nerf_level_train(*targs)
        t_p = k2.nerf_level_train_plain(*targs)
        t_x = exact_plain(k2.nerf_level_train_plain, *targs)
        off2 = compare.excused_points(t_k[2], t_x[2], kinks)
        res["k2_dw"] = dw_split(targs, S, {"kink_rays": by_ray(kinks),
                                           "kernel_off_kink_rays": by_ray(off2)},
                                t_k[-1], t_p[-1], t_x[-1], k2.nerf_level_train,
                                k2.nerf_level_train_plain)
        res["k2_dw"]["gx_kernel_off_kink_points"] = int(off2.sum())
    for i, name in enumerate(("gx", "gse", "g_bg")):
        if out_x[i] is None:
            continue
        sk, sp = spread(out_k[i], out_x[i]), spread(out_p[i], out_x[i])
        worst = sk.pop("worst10")
        shared = len(set(worst) & set(sp.pop("worst10")))
        res[name] = {"kernel": sk, "plain": sp, "worst10_shared": shared,
                     "ratio": sk["l2_rel"] / max(sp["l2_rel"], 1e-3)}
        if out_x[i].shape[0] == kinks.shape[0]:     # per point, not per ray
            res[name]["kernel"].update(excusal(out_k[i], out_x[i], kinks))
            res[name]["plain"].update(excusal(out_p[i], out_x[i], kinks))
            res[name]["kernel"]["worst10_kink_distance"] = [
                float(near[j]) for j in worst]
    return res


def main(argv: Optional[List[str]] = None, device=None, draws: int = 4) -> List[dict]:
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"card: {torch.cuda.get_device_name(dev)} | {card_line()}", flush=True)
    rows = []
    for name, (node, grid, S, with_noise, cond_seed) in CASES.items():
        level, table = level_of(grid, cond_seed, dev)
        seeds = [("test", zlib.crc32(node.encode()))] + [
            (f"other {i}", 100 + i) for i in range(draws)]
        for draw, seed in seeds:
            row = {"case": name, "draw": draw,
                   **case(level, table, grid, S, with_noise, seed, dev)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
