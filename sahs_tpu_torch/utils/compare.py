"""Error measures of a kernel's results against its plain version's:
gradient trees leaf by leaf, and per-point cotangents.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import torch


def leaves(tree, path: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf of nested dicts (in key order) and lists."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def tree_errors(a, b) -> Dict[str, float]:
    """Worst leaf of ``a`` against the reference ``b``, every leaf (each
    weight and each bias on its own) against its own norm: the largest
    ||a - b|| / ||b||, its leaf, and the smallest cosine (1 for a leaf that
    is zero on both sides; a leaf zero in ``b`` alone counts as infinitely
    wrong)."""
    worst_rel, worst_cos, worst = 0.0, 1.0, ""
    la, lb = list(leaves(a)), list(leaves(b))
    if [p for p, _ in la] != [p for p, _ in lb]:
        raise ValueError("the two trees differ in structure")
    for (path, x), (_, y) in zip(la, lb):
        x, y = x.double().reshape(-1), y.double().reshape(-1)
        nx, ny, nd = float(x.norm()), float(y.norm()), float((x - y).norm())
        rel = nd / ny if ny > 0 else (0.0 if nd == 0 else float("inf"))
        cos = float(x @ y) / (nx * ny) if nx > 0 and ny > 0 else (
            1.0 if nx == ny else 0.0)
        if rel > worst_rel:
            worst_rel, worst = rel, path
        worst_cos = min(worst_cos, cos)
    return {"l2_rel": worst_rel, "cosine": worst_cos, "worst_leaf": worst}


def point_errors(a: torch.Tensor, b: torch.Tensor, tol: float = 1e-4
                 ) -> Dict[str, float]:
    """Per-point cotangents (P, k) of ``a`` against the reference ``b``:
    e_p = ||a_p - b_p|| / max_p ||b_p||, reported as its 99.9th percentile,
    its maximum and the number of points above ``tol``, with the overall
    L2-relative error and cosine. Two float32 implementations of a network
    with piecewise-linear activations disagree at the few points where a
    pre-activation lies within rounding of 0 (the derivative flips there):
    the count of such points, not the maximum, measures the kernel."""
    a, b = a.double().reshape(a.shape[0], -1), b.double().reshape(b.shape[0], -1)
    scale = float(b.norm(dim=1).max())
    e = (a - b).norm(dim=1) / max(scale, 1e-300)
    nb, na = float(b.norm()), float(a.norm())
    return {"l2_rel": float((a - b).norm()) / max(nb, 1e-300),
            "cosine": float((a * b).sum()) / max(na * nb, 1e-300),
            "p999": float(torch.quantile(e.float(), 0.999)),
            "max": float(e.max()), "n_over": int((e > tol).sum()),
            "points": int(e.numel())}


# A leaky-ReLU pre-activation counts as at its kink when it lies within one
# bf16 rounding step (2^-8) of 0, relative to its unit's RMS over the
# points. The points whose cotangents carry a bf16 run's distance from
# exact sums hold a pre-activation 1e-6-4e-3 of that RMS from 0
# (tools/point_spread.py, on the card): far past float32 rounding, since a
# value rounded to bf16 one way in one run and the other way in the other
# moves the next layers' pre-activations. At the flagship's widths (3,072
# leaky units a point) nearly every point holds one that close, so a
# gate's cap on the excused points, not this test, keeps a fault from
# hiding among them.
KINK_EPS = 2.0 ** -8
# A kink point is excused from a point gate when its error exceeds this
# share of the largest point's norm: below it the point is not off by more
# than bf16 rounding moves the others (tools/point_spread.py).
KINK_TOL = 1e-3
# At most this share of the points may be excused; a gate with more kink
# points off fails. At the card tests' 96 rays the tensor-core K6 is off by
# more than KINK_TOL at 0.07-0.6 % of the points, the plain version at up to
# 1 % (tools/point_spread.py, on the card).
KINK_SHARE = 0.01
# How many more kink points than the plain version's own count on the same
# draw a gate excuses: 4x the largest excess read over the card suite's
# bf16 K6 and K2 cases (one point, four times; on the card).
KINK_SLACK = 4


def kink_points(acts: dict, eps: float = KINK_EPS) -> torch.Tensor:
    """(P,) bool: the points at which one of the leaky-ReLU
    pre-activations of a reference run lies within ``eps`` of 0, relative
    to its unit's RMS over the points. ``acts`` is what the NeRF level's
    plain forward fills (``nerf_level.nerf_raw_plain`` or
    ``nerf_mlp.nerf_mlp_plain``): the trunk's ("trunk"), the direction
    branch's ("dacts") and the seg branch's ("sacts") outputs; a leaky
    output y < 0 gives the pre-activation y / 0.01."""
    kink = None
    for y in list(acts["trunk"]) + list(acts["dacts"]) + list(acts["sacts"]):
        v = torch.where(y >= 0, y, y / 0.01).double()
        rms = v.pow(2).mean(dim=0, keepdim=True).sqrt()
        k = (v.abs() <= eps * rms).any(dim=1)
        kink = k if kink is None else kink | k
    return kink


def excused_points(a: torch.Tensor, b: torch.Tensor, kinks: torch.Tensor,
                   tol: float = KINK_TOL) -> torch.Tensor:
    """(P,) bool: the kink points (``kink_points``) at which the per-point
    cotangent ``a`` is off the reference ``b`` by more than ``tol`` of the
    largest point's norm (``point_errors``' e_p), all of them."""
    a, b = a.double().reshape(a.shape[0], -1), b.double().reshape(b.shape[0], -1)
    e = (a - b).norm(dim=1) / max(float(b.norm(dim=1).max()), 1e-300)
    return kinks.to(e.device) & (e > tol)


def kink_cap(points: int, reference_off: Optional[int] = None) -> int:
    """The most kink points a gate over ``points`` points excuses:
    KINK_SHARE of them and, given ``reference_off`` (the reference's own
    count on the draw: the kink points at which the plain version is off
    the same exact sums by more than KINK_TOL), no more than that count
    and KINK_SLACK. A kernel may flip at about as many kinks as the plain
    version does; the share alone let 32 faulty points through beside the
    13 natural ones at 6,144 points, where the plain version flips at
    29-35 (ROADMAP Queue 3, on the card)."""
    cap = int(KINK_SHARE * points)
    return cap if reference_off is None else min(cap, int(reference_off) + KINK_SLACK)
