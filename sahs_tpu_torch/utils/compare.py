"""Error measures of a kernel's results against its plain version's:
gradient trees leaf by leaf, and per-point cotangents.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

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
