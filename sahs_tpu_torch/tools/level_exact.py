"""How far the bf16 level backward (K2) and its plain version each are from
the function they both compute, on the card:

    python -m sahs_tpu_torch.tools.level_exact

The reference is the plain version with exact sums (``exact_plain``): its
products' operands rounded to bf16 as always, every product and sum in
float64. For each case it prints one JSON line with, for the composited
colours and weights, gx, gse, the worst dW leaf, the worst leaf but the
sigma head (fc_alpha) and the sigma head alone, the L2-relative distance
of the kernel to the plain version (``kernel_vs_plain``), of the kernel
to exact sums (``kernel_vs_exact``), of the plain version to exact sums
(``plain_vs_exact``) and, at 96 rays, of the plain version run on the
host's CPU to exact sums (``plain_cpu_vs_exact``: another BLAS, so its
float32 sums in another order; where it reads as the card's plain version
does, that distance comes from float32 arithmetic both runs share). Levels
(``coarse_level``): "seeded", the card tests' flagship level (sigma's
bias 0.5, the rgb head x100), with the grid and grid-free; "init", the
flagship level as initialised; "varied", colours that vary along a ray,
with the grid and grid-free. 96 rays x 16, 64 and 128 samples (the card
tests' size) and 2047 x 127 (a step's); with and without a background
(the varied levels without); two draws each.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
from typing import List, Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from ..config import Config
from ..models import nerface
from ..ops.grid import _cell_geometry, pack_corner_table
from ..ops.kernels import field_mlp
from ..ops.kernels import level_train as k2
from ..ops.kernels import nerf_level as k5
from ..ops.kernels import skip_mlp as k13
from ..utils.compare import point_errors, tree_errors
from ..utils.device import card_line, resolve_device

GRID = (32, 32, 32)

_PRODUCTS = {torch.matmul, torch.mm, torch.bmm, torch.addmm, torch.einsum,
             torch.Tensor.matmul, torch.Tensor.mm, torch.Tensor.__matmul__,
             torch.Tensor.__rmatmul__, torch.nn.functional.linear}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


class _Float64Products(TorchFunctionMode):
    """Raises on a product whose floating operands are not all float64: a
    plain version that rounds its operands past ``field_mlp.round_to``
    would otherwise sum them in float32 inside ``exact_sums``."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            for t in _tensors(list(args) + list(kwargs.values())):
                if t.is_floating_point() and t.dtype != torch.float64:
                    raise RuntimeError(f"{func.__name__} on {t.dtype} inside exact_sums")
        return func(*args, **kwargs)


@contextlib.contextmanager
def exact_sums(round_operands: bool = True):
    """The plain versions with every product and sum in float64, their
    products' operands rounded to the compute dtype first (as always) or,
    with ``round_operands`` False, not rounded at all (a float64 run). The
    PE backward takes float32 (its cosines are the kernels'), in the level
    backward's and in K14's plain version, and so does the cell geometry of
    the corner sample (the kernels' cells and fractions, also on a cell's
    face). A product on other operands than float64 raises."""
    round_to, pe_backward = field_mlp.round_to, field_mlp.pe_backward
    cell_geometry = k5._cell_geometry

    def exact_round_to(x, dtype):
        keep = dtype == torch.float32 or not round_operands
        return (x if keep else x.to(dtype)).double()

    def exact_pe_backward(p, g, groups):
        return pe_backward(p.float(), g.float(), groups).double()

    field_mlp.round_to = exact_round_to
    k2.pe_backward = k13.pe_backward = exact_pe_backward
    k5._cell_geometry = lambda coords, dims: cell_geometry(coords.float(), dims)
    try:
        with _Float64Products():
            yield
    finally:
        field_mlp.round_to = round_to
        k2.pe_backward = k13.pe_backward = pe_backward
        k5._cell_geometry = cell_geometry


def _map(x, fn):
    """``fn`` on every tensor of ``x`` (folded weights: LevelWeights,
    PairWeights, SkipWeights; dicts, lists)."""
    if dataclasses.is_dataclass(x) and hasattr(x, "_blobs"):
        return dataclasses.replace(x, _blobs={}, **{
            f.name: _map(getattr(x, f.name), fn) for f in dataclasses.fields(x)
            if f.name != "_blobs"})
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _map(v, fn) for k, v in x.items()}
    if type(x) in (list, tuple):
        return type(x)(_map(v, fn) for v in x)
    return x


def _f64(x):
    return _map(x, lambda t: t.double() if t.is_floating_point() else t)


def exact_plain(plain, *args):
    """``plain`` (the plain version of a backward kernel: K2, K6, K8, K12,
    K3 or K14, or of a forward: K5 ``nerf_level_plain``, whose compositing
    then runs in float64 too, K7 ``nerf_raw_plain``, K11
    ``nerf_mlp_plain``, K1 ``deform_pair_plain``, K13 ``skip_mlp_plain``)
    on ``args`` with exact sums; its float tensors and weights in float64,
    results in float64 (K1's rows are the cells of its float64 output, so
    a kernel's rows are held against its own output instead)."""
    with exact_sums():
        return plain(*[_f64(a) for a in args])


def exact_acts(plain, *args) -> dict:
    """The activations of a NeRF level's plain forward with exact sums
    (``exact_plain``'s): ``plain`` is ``nerf_level.nerf_raw_plain`` or
    ``nerf_mlp.nerf_mlp_plain``, ``args`` its arguments but ``acts``.
    Returns the ``acts`` dict it fills (``utils/compare.kink_points``
    reads the trunk's and the branches' outputs)."""
    acts = {}
    with exact_sums():
        plain(*[_f64(a) for a in args], acts)
    return acts


def kernel_branches(args: tuple) -> List[torch.Tensor]:
    """The leaky-ReLU branches bf16 K6 takes on its ``args``
    (``level_train._vjp_branches``)."""
    return k2._vjp_branches(*args)


def plain_branches(args: tuple) -> List[torch.Tensor]:
    """The leaky-ReLU branches the level's plain forward takes in its own
    float32 run on K6's ``args``, laid out as ``kernel_branches``'."""
    acts = {}
    k5.nerf_raw_plain(*args[:4], *args[9:12], acts)
    return [y > 0 for y in list(acts["trunk"]) + list(acts["dacts"]) + list(acts["sacts"])]


@contextlib.contextmanager
def branches_at(points: torch.Tensor, branches: List[torch.Tensor]):
    """Inside, the NeRF level's plain version takes, at ``points`` (P,)
    bool alone, the leaky-ReLU branch that ``branches`` (``kernel_branches``)
    gives each unit of each leaky layer: forward, y = x or 0.01 x as the
    branch says, and backward, that branch's slope. Everywhere else it is
    unchanged. Yields the count of leaky layers it ran (a list of one int),
    which must equal ``len(branches)``."""
    leaky, dact = k5.leaky, field_mlp.dact
    calls, slopes = [0], {}

    def branch_leaky(x):
        pos = branches[calls[0]].to(x.device)
        calls[0] += 1
        at = points.to(x.device)[:, None]
        y = torch.where(at, torch.where(pos, x, 0.01 * x), leaky(x))
        slope = torch.where(at, torch.where(pos, 1.0, 0.01), torch.where(y > 0, 1.0, 0.01))
        slopes[id(y)] = (y, slope.to(y.dtype))
        return y

    def branch_dact(name, y):
        hit = slopes.get(id(y))
        if name == "leaky" and hit is not None and hit[0] is y:
            return hit[1]
        return dact(name, y)

    k5.leaky = branch_leaky
    k2.dact = field_mlp.dact = branch_dact
    try:
        yield calls
    finally:
        k5.leaky = leaky
        k2.dact = field_mlp.dact = dact


def exact_plain_at_branches(plain, args: tuple, points: torch.Tensor,
                            branches: List[torch.Tensor]):
    """``exact_plain(plain, *args)`` with the level's leaky ReLUs on the
    branches ``branches`` at ``points`` alone (``branches_at``): the
    exact-sum reference of bf16 K6's plain version that takes one side's own branch (``kernel_branches``,
    ``plain_branches``) at the kink points where that side's gx is off, so
    that both compute the same function there."""
    with branches_at(points, branches) as calls:
        out = exact_plain(plain, *args)
    if calls[0] != len(branches):
        raise RuntimeError(f"the plain version ran {calls[0]} leaky layers, "
                           f"the branches are for {len(branches)}")
    return out


def coarse_level(kind: str, grid: bool, dtype: torch.dtype, dev):
    """(folded coarse level, model) of the flagship model, seed 0, in
    ``dtype``, conditioned as the card tests' fixture is: ``kind`` "init"
    (as initialised), "seeded" (sigma's bias 0.5, the rgb head x100: the
    card tests' flagship level) or "varied" (biases zeroed but sigma's,
    the first direction layer's feat block x30, the rgb head x300: colours
    that vary along a ray, so that without a background sigma's gradient,
    a difference of a ray's colours, is not rounding alone)."""
    cfg = Config()
    cfg.models.coarse.use_spatial_embeddings = grid
    spec = nerface.ModelSpec.from_config(cfg)
    model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
    with torch.no_grad():
        c = model.coarse
        if kind == "varied":
            for name, p in c.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
            c.dir[0].weight[:, :c.fc_feat.weight.shape[0]].mul_(30.0)
        if kind != "init":
            c.fc_alpha.bias.fill_(0.5)
            c.fc_rgb.weight.mul_(300.0 if kind == "varied" else 100.0)
    model = model.to(dtype)
    cond = np.random.RandomState(0).randn(76 + 36).astype(np.float32) * 0.5
    _, pts_g, dir_g = nerface.build_pe_groups(spec)
    return (k5.prepare_level(model.coarse, torch.tensor(cond[76:], device=dev,
                                                        dtype=dtype), pts_g, dir_g),
            model)


def _distances(a, b) -> dict:
    out = {}
    for i, name in ((0, "rgb"), (1, "weights"), (2, "gx"), (3, "gse")):
        if a[i] is not None:
            out[name] = point_errors(a[i], b[i])["l2_rel"]
    worst = tree_errors(a[5], b[5])
    out["dw"] = worst["l2_rel"]
    out["dw_leaf"] = worst["worst_leaf"]
    out["dw_without_sigma_head"] = tree_errors(
        {k: v for k, v in a[5].items() if k != "fc_alpha"},
        {k: v for k, v in b[5].items() if k != "fc_alpha"})["l2_rel"]
    out["sigma_head"] = tree_errors(a[5]["fc_alpha"], b[5]["fc_alpha"])["l2_rel"]
    return out


def case(level, table, grid: bool, R: int, S: int, with_bg: bool, seed: int,
         dev) -> dict:
    rng = np.random.RandomState(seed)
    g = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
    P = R * S
    pts = g(np.concatenate([rng.uniform(-1.05, 1.05, (P, 3)), rng.uniform(-1, 1, (P, 2))], 1))
    dirs = g(rng.randn(R, 3) * 0.1 + [0, 0, -1])
    z = g(np.sort(rng.uniform(0.48, 1.08, (R, S)), axis=-1))
    bg = g(rng.rand(R, 15)) if with_bg else None
    noise = g(rng.randn(R, S) * 0.5)
    tgt = g(np.concatenate([rng.rand(R, 3), np.eye(12)[rng.randint(0, 12, R)]], 1))
    lw = g(np.stack([np.full(R, 1.0 / R), np.full(R, 0.02 / R)], 1))
    rows = _cell_geometry(pts, GRID)[0] if grid else None
    args = (pts, dirs, table, rows, z, bg, noise, tgt, lw, level, "bfloat16",
            GRID if grid else None, 0.5 if with_bg else 0.0)
    out_k = k2.nerf_level_train(*args)
    out_p = k2.nerf_level_train_plain(*args)
    out_x = exact_plain(k2.nerf_level_train_plain, *args)
    row = {"kernel_vs_plain": _distances(out_k, out_p),
           "kernel_vs_exact": _distances(out_k, out_x),
           "plain_vs_exact": _distances(out_p, out_x)}
    if R <= 96 and dev.type == "cuda":
        out_c = k2.nerf_level_train_plain(*_map(args, lambda t: t.cpu()))
        row["plain_cpu_vs_exact"] = _distances(out_c, _map(out_x, lambda t: t.cpu()))
    return row


def main(argv: Optional[List[str]] = None, device=None) -> List[dict]:
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"card: {torch.cuda.get_device_name(dev)} | {card_line()}", flush=True)
    rows = []
    for kind, grid, backgrounds in (("seeded", True, (True, False)),
                                    ("seeded", False, (True, False)),
                                    ("init", True, (True, False)),
                                    ("varied", True, (False,)),
                                    ("varied", False, (False,))):
        level, model = coarse_level(kind, grid, torch.float32, dev)
        table = (pack_corner_table(model.spatial_embeddings.detach(), dtype=torch.bfloat16)
                 if grid else None)
        for R, S in ((96, 16), (96, 64), (96, 128), (2047, 127)):
            for with_bg in backgrounds:
                for seed in (1, 2):
                    row = {"level": kind, "grid": grid, "rays": R, "samples": S,
                           "background": with_bg, "draw": seed,
                           **case(level, table, grid, R, S, with_bg, seed, dev)}
                    rows.append(row)
                    print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
