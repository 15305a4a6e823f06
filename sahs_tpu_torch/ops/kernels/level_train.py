"""K2, K6 and K8: one NeRF level's backward, three uses of one CUDA kernel
set (``csrc/level_train.cu``; its source note gives the bound on the H100
and the design).

K2 replaces ``sahs_tpu/ops/pallas/level_train.py:nerf_level_train`` (:55,
``pallas_call`` at :306) in its ``corner_interp`` form: the forward, the
loss cotangents and the full backward in one call. The Stage-I loss is
per-ray analytic, so its cotangents are formed where the composited
outputs are (level_train.py:26-32):
  g_rgb[r, 0:3]  = w_l2(r) * 2 * (rgb[r] - target[r])
  g_rgb[r, 3:15] = w_ce(r) * (-mask[r, c] / (seg[r, c] + 1e-10))
  g_w[r, S-1]    = bg_sup * ||bg[r, :3] - target[r]||^2
  g_bg[r, 0:3]  += bg_sup * w_last(r) * 2 * (bg[r] - target[r])
and run back through the compositing (field_mlp.py:2580-2623), the heads,
the trunk, the positional encoding and the trilinear sample
(field_mlp.py:2788-2901, with the corner dCoords of :1824).

K6 replaces ``field_mlp.py:nerf_level_vjp`` (:2951, ``pallas_call`` at
:3091): the backward of K5 from given cotangents g_rgb (R, 16) and g_w
(R, S) of its outputs, the autograd fallback's level backward. K8 replaces
``field_mlp.py:nerf_rayd_vjp`` (:2059, ``pallas_call`` at :2269): the
backward of K7 from the cotangent of the raw field (P, 16), no compositing.
K12 replaces ``field_mlp.py:nerf_mlp_vjp`` (:1546, ``pallas_call`` at
:1686): the backward of K11 (``nerf_mlp.py``), K8's launches on per-point
inputs, returning the cotangent of the extra input [dir | se] in place of
gse and the corner dCoords.

A model without the spatial-embedding grid takes K2, K6 and K8 in their
grid-free form (``table`` and ``rows`` None, the folded level's
``dir0_se`` of zero rows): no gse (None in its place) and no trilinear
dCoords, gx coming through the PE backward alone; K12's gextra is then the
direction part alone (P, 3).

K2, K6 and K8 also take a per-point spatial embedding ``se`` (P, C) in
place of the table and rows (JAX's non-``corner_interp`` form,
field_mlp.py:2130-2142, level_train.py:62, :157, :207): the kernels read
each point's row rounded to the compute dtype, gse comes back per point
(P, C) float32 and gx carries no trilinear dCoords. K12 also takes the
pre-encoded inputs of K11 (``nerf_mlp.py``; field_mlp.py:1546 with
``pe_spec`` / ``extra_pe_spec`` None): gx and gextra are then the
cotangents of the encodings, with no PE backward.

In bfloat16 the kernels run their layer products and dW on the tensor
cores over 64-point tiles (``wgmma``: the forward and backward tiles
stream their weights as stages, ``nerf_level.wgmma_blob`` and
``backward_stages``; the gz stash is bf16 and dW runs over ``dw_items``),
in float32 on the CUDA cores over 32-point tiles (``tile_points``; the
stash follows the tile).

K2 also takes the pair= form (level_train.py:58-78, body :232-246; the JAX
fused step under ``SAHS_PAIR_FOLD``): ``pair=(PairWeights, ro (R, 3))``.
One call then runs K2's launches, with gx (P, 3 + ambient) written to a
float32 scratch, and then K3's rays= call (``deform_pair_vjp``'s, not
counted) on the same points, rebuilt from the rays (ro, the level's
directions, z) as K15 builds them, with that gx as the cotangent: its
results are K2's and then K3's rays= form's on K2's gx, bit for bit. The
pair's gradient tree comes back in gx's place. The plain version runs
``deform_pair_vjp_plain`` on the rays' points with K2's gx.

``nerf_level_train``, ``nerf_level_vjp``, ``nerf_rayd_vjp`` and
``nerf_mlp_vjp`` launch the kernel for CUDA tensors and count the call in
``<wrapper>.launches``; for CPU tensors they run the ``*_plain`` version. ``level_train_apply`` folds
the conditioning, runs K2 and unfolds the trunk's gradients
(level_train.py:358-405).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from . import _build
from .field_mlp import (DW_ROWS, TP_BF16, WG_KB, BlobBuilder,  # noqa: F401
                        TrainPlan, build_train_plan, dact, dw_items,
                        dw_items_on, level_dw_chunks, mm, mm_t, pe_backward,
                        plan_buffers, stage_blob, stash_buffers, tile_points,
                        torch_dtype, trunk_backward, trunk_params,
                        unfold_cond_grads, wgmma_chunks)
from ..grid import corner_dcoords
from .nerf_level import (LevelWeights, _grid_args, check_device,
                         level_kernel_args, nerf_raw_plain, point_blob,
                         point_layers, prepare_level, wgmma_blob, widths_ok)
from .nerf_mlp import ENC_EXTRA, ENC_PTS, nerf_mlp_plain, point_kernel_args
from .deform_pair import _check_kernel_shapes, _vjp_launch, deform_pair_vjp_plain


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _composite_stash(raw: torch.Tensor, z: torch.Tensor, dirs: torch.Tensor,
                     bg: Optional[torch.Tensor], noise: Optional[torch.Tensor]):
    """Compositing (as nerf_level.composite_plain), float32, keeping what
    its backward needs. raw (R, S, 16) rgb3 | seg12 | sigma1."""
    R, S, _ = raw.shape
    f32 = torch.float32
    dz = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=-1)
    rdn = torch.sqrt(torch.sum(dirs[:, :3].to(f32) ** 2, dim=-1, keepdim=True))
    dists = dz * rdn
    sig = raw[..., 15]
    if noise is not None:
        sig = sig + noise
    is_last = torch.zeros((1, S), dtype=f32, device=raw.device)
    is_last[0, -1] = 1.0
    sigma = torch.relu(sig) + 1e-6 * is_last
    t_term = torch.exp(-sigma * dists)
    alpha = 1.0 - t_term
    logterm = torch.log(t_term + 1e-10)
    zcol = torch.zeros_like(logterm[:, :1])
    T = torch.exp(torch.cat([zcol, torch.cumsum(logterm, dim=-1)[:, :-1]], dim=-1))
    w = alpha * T
    rgb_sig = torch.sigmoid(raw[..., :3])
    zero = torch.zeros_like(raw[..., :1])
    if bg is not None:
        seg_act = torch.softmax(raw[..., 3:15], dim=-1)
        ch = torch.cat([rgb_sig, seg_act, zero], dim=-1)
        last = torch.cat([bg.to(f32), zero[:, 0]], dim=-1)
        ch = torch.cat([ch[:, :-1], last[:, None]], dim=1)
    else:
        seg_act = torch.sigmoid(raw[..., 3:15])
        ch = torch.cat([rgb_sig, seg_act, zero], dim=-1)
    return {"rgb_map": torch.sum(w[..., None] * ch, dim=1), "w": w, "T": T,
            "alpha": alpha, "t_term": t_term, "dists": dists, "sig": sig,
            "ch": ch, "rgb_sig": rgb_sig, "seg_act": seg_act,
            "is_last": is_last, "has_bg": bg is not None}


def _composite_bwd(st: dict, g_rgb: torch.Tensor, g_w: torch.Tensor):
    """The compositing backward (field_mlp.py:2580-2623) from the
    cotangents of rgb_map (R, 16) and the weights (R, S). Returns (graw
    (R, S, 16), g_bg (R, 15) | None): the last sample's channel cotangent,
    and with a background no rgb/seg gradient into that raw sample."""
    w, T, alpha, t_term = st["w"], st["T"], st["alpha"], st["t_term"]
    ch, rgb_sig, seg_act = st["ch"], st["rgb_sig"], st["seg_act"]
    g_ch = w[..., None] * g_rgb[:, None, :]
    g_bg = g_ch[:, -1, :15].clone() if st["has_bg"] else None
    g_w_tot = g_w + torch.sum(ch * g_rgb[:, None, :], dim=-1)
    g_cum = T * (g_w_tot * alpha)
    # the transpose of the exclusive scan: the sum over later samples
    rev = torch.flip(torch.cumsum(torch.flip(g_cum, [-1]), dim=-1), [-1])
    g_log = torch.cat([rev[:, 1:], torch.zeros_like(rev[:, :1])], dim=-1)
    g_alpha = g_w_tot * T - g_log / (t_term + 1e-10)
    g_sig = g_alpha * t_term * st["dists"] * (st["sig"] > 0).to(torch.float32)
    not_last = (1.0 - st["is_last"])[..., None] if st["has_bg"] else 1.0
    grgb3 = g_ch[..., :3] * rgb_sig * (1.0 - rgb_sig) * not_last
    gs = g_ch[..., 3:15]
    if st["has_bg"]:
        gseg = seg_act * (gs - torch.sum(gs * seg_act, dim=-1, keepdim=True)) * not_last
    else:
        gseg = gs * seg_act * (1.0 - seg_act)
    return torch.cat([grgb3, gseg, g_sig[..., None]], dim=-1), g_bg


def composite_vjp_plain(raw: torch.Tensor, z: torch.Tensor, dirs: torch.Tensor,
                        bg: Optional[torch.Tensor], noise: Optional[torch.Tensor],
                        g_rgb: torch.Tensor, g_w: torch.Tensor):
    """Compositing and its backward from given cotangents, float32.
    Returns (rgb_map (R, 16), weights (R, S), graw (R, S, 16), g_bg (R, 15)
    | None)."""
    st = _composite_stash(raw, z, dirs, bg, noise)
    graw, g_bg = _composite_bwd(st, g_rgb.to(torch.float32),
                                g_w.to(torch.float32))
    return st["rgb_map"], st["w"], graw, g_bg


def composite_train_plain(raw: torch.Tensor, z: torch.Tensor,
                          dirs: torch.Tensor, bg: Optional[torch.Tensor],
                          noise: Optional[torch.Tensor], tgt: torch.Tensor,
                          lw: torch.Tensor, bg_sup: float):
    """Compositing, the loss cotangents and the compositing backward,
    float32. Returns (rgb_map (R, 16), weights (R, S), graw (R, S, 16) the
    cotangent of raw, g_bg (R, 15) | None)."""
    st = _composite_stash(raw, z, dirs, bg, noise)
    rgb_map, w = st["rgb_map"], st["w"]
    g_rgb = torch.cat([lw[:, 0:1] * 2.0 * (rgb_map[:, :3] - tgt[:, :3]),
                       lw[:, 1:2] * (-tgt[:, 3:15] / (rgb_map[:, 3:15] + 1e-10)),
                       torch.zeros_like(rgb_map[:, :1])], dim=-1)
    g_w = torch.zeros_like(w)
    sup = bg_sup > 0.0 and bg is not None
    if sup:
        g_w[:, -1] = bg_sup * torch.sum(torch.square(bg[:, :3] - tgt[:, :3]), dim=-1)
    graw, g_bg = _composite_bwd(st, g_rgb, g_w)
    if sup:
        g_bg[:, :3] += bg_sup * w[:, -1:] * 2.0 * (bg[:, :3] - tgt[:, :3])
    return rgb_map, w, graw, g_bg


def _lin_grad(a, gz, dtype):
    return {"w": mm_t(a, gz, dtype), "b": torch.sum(gz, dim=0)}


def level_backward_plain(weights: LevelWeights, acts: dict, pts: torch.Tensor,
                        graw: torch.Tensor, dtype: torch.dtype, grid_dims):
    """The level's backward from the cotangent of raw (P, 16), given the
    forward's ``acts`` (``nerf_raw_plain``): the heads, branches and trunk,
    the PE and the trilinear dCoords. Returns (gx (P, 3 + ambient), gse
    (P, C), grads), grads the folded level's {"trunk": [{"w", "b"}],
    "fc_feat", "fc_alpha", "dir": [...], "fc_rgb", "seg": [...], "fc_seg"}
    with dir[0]'s rows [feat | pe(dir) | se], the JAX package's layout.
    For K12 (``acts`` of ``nerf_mlp_plain``, ``grid_dims`` None) there is
    no trilinear sample in the pass: gx is the PE backward alone, and the
    second result is gextra (P, 3 + C), the cotangent of [dir | se] (of
    the encodings when the level has no PE groups: gx (P, kx) and gextra
    (P, n_dir + C)). Without corner rows in ``acts`` gx is the PE backward
    alone, and gse is None in the grid-free form (C = 0) and (P, C) for a
    given per-point se."""
    W = weights
    feat, se, h = acts["feat"], acts["se"], acts["h"]
    dacts, sacts = acts["dacts"], acts["sacts"]
    grgb, gseg, galpha = graw[:, :3], graw[:, 3:15], graw[:, 15:16]
    # seg branch
    grads = {"fc_seg": _lin_grad(sacts[-1], gseg, dtype)}
    ga = mm(gseg, W.seg_out["w"].t(), dtype)
    seg_g = [None] * len(W.seg)
    for k in range(len(W.seg) - 1, -1, -1):
        gz = ga * dact("leaky", sacts[k])
        seg_g[k] = _lin_grad(feat if k == 0 else sacts[k - 1], gz, dtype)
        ga = mm(gz, W.seg[k]["w"].t(), dtype)
    gfeat = ga
    # direction branch
    grads["fc_rgb"] = _lin_grad(dacts[-1], grgb, dtype)
    ga = mm(grgb, W.rgb["w"].t(), dtype)
    dir_g = [None] * len(dacts)
    for k in range(len(dacts) - 1, 0, -1):
        gz = ga * dact("leaky", dacts[k])
        dir_g[k] = _lin_grad(dacts[k - 1], gz, dtype)
        ga = mm(gz, W.dir_rest[k - 1]["w"].t(), dtype)
    gzd0 = ga * dact("leaky", dacts[0])
    dir_g[0] = {"w": torch.cat([mm_t(feat, gzd0, dtype),
                                mm_t(acts["dir_pe"], gzd0, dtype),
                                mm_t(se, gzd0, dtype)], dim=0),
                "b": torch.sum(gzd0, dim=0)}
    gse = mm(gzd0, W.dir0_se.t(), dtype)
    gfeat = gfeat + mm(gzd0, W.dir0_feat.t(), dtype)
    # alpha head, feat layer, trunk
    grads["fc_alpha"] = _lin_grad(feat, galpha, dtype)
    gfeat = gfeat + mm(galpha, W.alpha["w"].t(), dtype)
    grads["fc_feat"] = _lin_grad(h, gfeat, dtype)
    gh = mm(gfeat, W.feat["w"].t(), dtype)
    gx_pe, trunk_g = trunk_backward(W.trunk, acts["x"], acts["trunk"], gh,
                                    W.skip, "leaky", dtype, need_gx=True)
    gx = (gx_pe if W.pts_groups is None
          else pe_backward(pts, gx_pe, W.pts_groups))
    grads.update(trunk=trunk_g, dir=dir_g, seg=seg_g)
    if "dirs" in acts:
        gdir = mm(gzd0, W.dir0_dir.t(), dtype)
        if W.dir_groups is not None:
            gdir = pe_backward(acts["dirs"], gdir, W.dir_groups)
        return gx, torch.cat([gdir, gse], dim=-1), grads
    if acts["cf"] is None:
        return gx, gse if gse.shape[1] else None, grads
    gx[:, :3] += corner_dcoords(gse, acts["fs"], acts["ok"], acts["cf"], grid_dims)
    return gx, gse, grads


def nerf_level_train_plain(pts: torch.Tensor, dirs: torch.Tensor,
                           table: torch.Tensor, rows: torch.Tensor,
                           z: torch.Tensor, bg: Optional[torch.Tensor],
                           noise: Optional[torch.Tensor], tgt: torch.Tensor,
                           lw: torch.Tensor, weights: LevelWeights,
                           compute_dtype: str, grid_dims, bg_sup: float = 0.0,
                           se: Optional[torch.Tensor] = None, pair=None):
    """K2's plain version. Arguments as ``nerf_level.nerf_level_plain``
    plus tgt (R, 15) [target rgb | seg mask], lw (R, 2) per-ray loss
    weights and bg_sup. Returns (rgb_map (R, 16), weights (R, S), gx
    (P, 3 + ambient), gse (P, C) | None, g_bg (R, 15) | None, grads), grads as
    ``level_backward_plain``'s. With ``pair`` (PairWeights, ro (R, 3)) the
    pair's gradient tree of gx at the rays' points (o + d z, d = dirs)
    comes back in gx's place."""
    R, S = z.shape
    acts = {}
    raw = nerf_raw_plain(pts, dirs, table, rows, weights, compute_dtype,
                         grid_dims, acts, se)
    with torch.no_grad():
        rgb_map, w_out, graw, g_bg = composite_train_plain(
            raw.reshape(R, S, 16), z, dirs, bg, noise, tgt, lw, bg_sup)
        gx, gse, grads = level_backward_plain(
            weights, acts, pts, graw.reshape(R * S, 16),
            torch_dtype(compute_dtype), grid_dims)
    if pair is not None:
        gx = deform_pair_vjp_plain(None, pair[0], gx, None, compute_dtype,
                                   rays=(pair[1], dirs[:, :3], z))
    return rgb_map, w_out, gx, gse, g_bg, grads


def nerf_level_vjp_plain(pts: torch.Tensor, dirs: torch.Tensor,
                         table: torch.Tensor, rows: torch.Tensor,
                         z: torch.Tensor, bg: Optional[torch.Tensor],
                         noise: Optional[torch.Tensor], g_rgb: torch.Tensor,
                         g_w: torch.Tensor, weights: LevelWeights,
                         compute_dtype: str, grid_dims,
                         se: Optional[torch.Tensor] = None):
    """K6's plain version: K5's arguments plus the cotangents g_rgb (R, 16)
    and g_w (R, S) of its outputs. Returns (gx (P, 3 + ambient), gse (P, C) | None,
    g_bg (R, 15) | None, grads), grads as ``level_backward_plain``'s."""
    R, S = z.shape
    acts = {}
    raw = nerf_raw_plain(pts, dirs, table, rows, weights, compute_dtype,
                         grid_dims, acts, se)
    with torch.no_grad():
        _, _, graw, g_bg = composite_vjp_plain(raw.reshape(R, S, 16), z, dirs,
                                               bg, noise, g_rgb, g_w)
        gx, gse, grads = level_backward_plain(
            weights, acts, pts, graw.reshape(R * S, 16),
            torch_dtype(compute_dtype), grid_dims)
    return gx, gse, g_bg, grads


def _f32_or_wider(g: torch.Tensor) -> torch.Tensor:
    """A cotangent in float32, or kept in float64 (``tools/level_exact``'s
    exact sums)."""
    return g.to(torch.promote_types(g.dtype, torch.float32))


def nerf_rayd_vjp_plain(pts: torch.Tensor, dirs: torch.Tensor,
                        table: torch.Tensor, rows: torch.Tensor,
                        g: torch.Tensor, weights: LevelWeights,
                        compute_dtype: str, grid_dims,
                        se: Optional[torch.Tensor] = None):
    """K8's plain version: K7's arguments plus the cotangent g (P, 16) of
    its raw output. Returns (gx (P, 3 + ambient), gse (P, C) | None, grads)."""
    acts = {}
    nerf_raw_plain(pts, dirs, table, rows, weights, compute_dtype, grid_dims,
                   acts, se)
    with torch.no_grad():
        return level_backward_plain(weights, acts, pts, _f32_or_wider(g),
                                    torch_dtype(compute_dtype), grid_dims)


def nerf_mlp_vjp_plain(pts: torch.Tensor, extra: torch.Tensor, g: torch.Tensor,
                       weights: LevelWeights, compute_dtype: str):
    """K12's plain version: K11's arguments (``nerf_mlp.nerf_mlp_plain``)
    plus the cotangent g (P, 16) of its raw output. Returns (gx (P, 3 +
    ambient), gextra (P, 3 + C), grads), grads as
    ``level_backward_plain``'s (field_mlp.py:1546-1749)."""
    acts = {}
    nerf_mlp_plain(pts, extra, weights, compute_dtype, acts)
    with torch.no_grad():
        return level_backward_plain(weights, acts, pts, _f32_or_wider(g),
                                    torch_dtype(compute_dtype), None)


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------

def level_train_plan(weights: LevelWeights, dtype: torch.dtype) -> TrainPlan:
    """K2's plan. Forward layers: trunk, feat, alpha, dir0 (inputs feat and
    [pe(dir) | se]), dir1-3, rgb, seg0-3, seg head. Activation slots: [pe,
    h_0 .. h_{L-1}, feat, [pe(dir) | se], d0-d3, s0-s3]. Transposed layers,
    in the order the backward runs them: rgb, dir3-dir1, dir0's
    [pe(dir) | se] block, seg head, seg3-seg1, gfeat (seg0 on gz_s0, [dir0's
    feat block ; alpha] on [gz_d0 ; gz_alpha]), feat, trunk L-1 .. 1 by
    their hidden rows, and the PE layer (trunk 0 on gz_0, the skip layer's
    input rows on gz_skip)."""
    key = ("train", dtype)
    W = weights
    if key not in W._blobs:
        L, hid = len(W.trunk), W.trunk[0]["w"].shape[1]
        fwd, bwd = point_layers(W), BlobBuilder()
        d0_in2 = torch.cat([W.dir0_dir, W.dir0_se], dim=0)
        zeros = lambda n: torch.zeros(n, device=W.dir0_b.device)
        t = lambda w: bwd.layer(w.t(), zeros(w.shape[0]), "linear")
        t(W.rgb["w"])
        for p in reversed(W.dir_rest):
            t(p["w"])
        t(d0_in2)
        t(W.seg_out["w"])
        for p in reversed(W.seg[1:]):
            t(p["w"])
        bwd.layer(W.seg[0]["w"].t(), zeros(hid), "linear",
                  w2=torch.cat([W.dir0_feat.t(), W.alpha["w"].t()], dim=0))
        t(W.feat["w"])
        for i in range(L - 1, 0, -1):
            t(W.trunk[i]["w"][:hid])
        skip_ok = 0 < W.skip < L
        bwd.layer(W.trunk[0]["w"].t(), zeros(W.trunk[0]["w"].shape[0]), "linear",
                  w2=W.trunk[W.skip]["w"][hid:].t() if skip_ok else None)

        B = W.dir0_b.shape[0]
        kx = W.trunk[0]["w"].shape[0]
        act_rows = ([kx] + [hid] * L + [hid, d0_in2.shape[0]]
                    + [B] * (len(W.dir_rest) + 1) + [B] * len(W.seg))
        feat_slot, din_slot, d_slot = L + 1, L + 2, L + 3
        s_slot = d_slot + len(W.dir_rest) + 1
        inputs = [(0 if i == 0 else i, 0 if (i == W.skip and i > 0) else -1)
                  for i in range(L)]
        inputs += [(L, -1), (feat_slot, -1), (feat_slot, din_slot)]
        inputs += [(d_slot + k, -1) for k in range(len(W.dir_rest))]
        inputs += [(d_slot + len(W.dir_rest), -1), (feat_slot, -1)]
        inputs += [(s_slot + k, -1) for k in range(len(W.seg) - 1)]
        inputs += [(s_slot + len(W.seg) - 1, -1)]
        W._blobs[key] = build_train_plan(fwd, bwd, act_rows, inputs,
                                         tile_points(dtype), dtype,
                                         fwd_t=point_blob(W, dtype))
    return W._blobs[key]


def _grads_tree(weights: LevelWeights, layers):
    """The kernel's per-layer grads (forward blob order) as the plain
    version's tree."""
    L = len(weights.trunk)
    nd, ns = len(weights.dir_rest), len(weights.seg)
    it = iter(layers)
    tree = {"trunk": [next(it) for _ in range(L)]}
    tree["fc_feat"] = next(it)
    tree["fc_alpha"] = next(it)
    tree["dir"] = [next(it) for _ in range(nd + 1)]
    tree["fc_rgb"] = next(it)
    tree["seg"] = [next(it) for _ in range(ns)]
    tree["fc_seg"] = next(it)
    return tree


_MODES = {"loss": 0, "vjp": 1, "raw": 2, "pts": 3}
_SIGNATURE = ("p" * 11 + "pp" + "pi" + "i" + "ppp" + "ppp" + "p" * 5 + "pp"
              + "pp" + "p" + "l" + "i" * 15 + "i" * 6 + "f" + "pppp" + "pl"
              + "plppi" + "p")


def backward_order(descs_t, n_trunk: int, skip: int):
    """The transposed layers' products in the order the bf16 backward tile
    runs them (csrc/level_train.cu, ``bw::prod_of``), each ([(w offset, k)
    of each input], n) from the plan's transposed layers ``descs_t``:
    rgb^T, dir3^T .. dir1^T, dir0's [pe(dir) | se] block, the seg head^T,
    seg3^T .. seg1^T, gfeat (seg0^T on gz_s0 and dir0's feat block^T on
    gz_d0: the last row of that input, the alpha head's, is the epilogue's
    rank-1 term and has no stage), feat^T, the trunk L-1 .. 1 with the PE
    layer's second input (the skip layer's input rows) before
    trunk[skip]^T, and the PE layer's first (trunk[0]^T)."""
    d, L = descs_t, n_trunk
    out = [([(d[i][0], d[i][1])], d[i][4]) for i in range(9)]
    out.append(([(d[9][0], d[9][1]), (d[9][2], d[9][3] - 1)], d[9][4]))
    out.append(([(d[10][0], d[10][1])], d[10][4]))
    pe = d[10 + L]
    for i in range(L - 1, 0, -1):
        if i == skip and pe[2] >= 0:
            out.append(([(pe[2], pe[3])], pe[4]))
        t = d[11 + L - 1 - i]
        out.append(([(t[0], t[1])], t[4]))
    out.append(([(pe[0], pe[1])], pe[4]))
    return out


def backward_stage_order(descs_t, n_trunk: int, skip: int) -> List[tuple]:
    """``field_mlp.stage_order``'s tuples for ``backward_order``: per
    product, each output chunk (at most 128 columns), input and 64-k
    block."""
    out = []
    for q, (inputs, n) in enumerate(backward_order(descs_t, n_trunk, skip)):
        for c0, rows in wgmma_chunks(n, False):
            for off, k in inputs:
                out += [(q, off, k, n, c0, rows, kb) for kb in range(-(-k // WG_KB))]
    return out


def backward_stages(weights: LevelWeights, plan: TrainPlan) -> torch.Tensor:
    """The weight stages of the bf16 backward tile (``bwd_tc_kernel``) from
    the plan's transposed blob (a copy that a test may have altered), in
    ``backward_stage_order``; built on the blob's device and kept while the
    blob is the same tensor, unchanged."""
    L = len(weights.trunk)
    return stage_blob(weights._blobs, plan.bwd[0], plan.descs_t, (),
                      order=lambda: backward_stage_order(plan.descs_t, L, weights.skip),
                      name="wgmma_bwd")


def _forward_stages(weights: LevelWeights, plan: TrainPlan, dtype: torch.dtype):
    """(pointer, bytes) of the weight stages that launch 1's tile reads in
    bf16 (``nerf_level.wgmma_blob`` of the plan's forward blob); (None, 0) in
    float32, whose tile reads the forward blob itself."""
    if dtype != torch.bfloat16:
        return None, 0
    wg = wgmma_blob(weights, plan.fwd[0])
    return wg.data_ptr(), 2 * wg.numel()


def _call_buffers(weights: LevelWeights, plan: TrainPlan, n_tiles: int,
                  dtype: torch.dtype, dev):
    """(acts, gzs, bsum, chunks, part, out, the backward's arguments: its
    stages, their bytes, bsum, the dW's items and their count) of one call:
    in bf16 the wgmma backward's, else the float32 stash and the plan's work
    list (bsum None). The caller holds every tensor until the launches are
    queued: a buffer freed before them would be handed to the next
    allocation while the kernels write it."""
    p = _build.ptr
    if dtype != torch.bfloat16:
        acts, gzs, chunks, part, out = plan_buffers(plan, n_tiles, dtype, dev)
        return acts, gzs, None, chunks, part, out, (None, 0, None, None, 0)
    acts, gzs, bsum, chunks, part, out = stash_buffers(plan, n_tiles, dev)
    stages = backward_stages(weights, plan)
    items = dw_items_on(plan, dev)
    return (acts, gzs, bsum, chunks, part, out,
            (p(stages), 2 * stages.numel(), p(bsum), p(items), items.numel() // 4))


def _launch(mode: str, what: str, pts, dirs, table, rows, weights,
            compute_dtype: str, grid_dims, z=None, bg=None, noise=None,
            tgt=None, lw=None, g_rgb=None, g_w=None, graw=None,
            bg_sup: float = 0.0, se=None, pair=None):
    """One call of the level-backward kernel set (csrc/level_train.cu) in
    ``mode``: "loss" (K2), "vjp" (K6) or "raw" (K8), the spatial embedding
    from the corner table and rows, from a per-point ``se`` (P, C), or
    none. Returns (rgb_map, weights, gx, gse, g_bg (R, 16), grads, acts);
    rgb_map, weights and g_bg are None in "raw" mode, gse in the grid-free
    form; acts is the activation stash (``_stash_branches`` reads it).
    With ``pair`` (K2's pair= form, "loss" mode: PairWeights, ro (R, 3))
    the pair's gradient tree comes back in gx's place."""
    check_device(what, pts.device)
    R, S, PW, C, ints = level_kernel_args(pts, dirs, table, rows, weights,
                                          compute_dtype, grid_dims, what, se)
    hidden, branch = ints[1], ints[2]
    P = R * S
    shapes = {"z": (z, (R, S)), "bg": (bg, (R, 15)), "noise": (noise, (R, S)),
              "tgt": (tgt, (R, 15)), "lw": (lw, (R, 2)),
              "g_rgb": (g_rgb, (R, 16)), "g_w": (g_w, (R, S)),
              "graw": (graw, (P, 16))}
    bad = [f"{k} {tuple(t.shape)} (want {want})" for k, (t, want)
           in shapes.items() if t is not None and tuple(t.shape) != want]
    dtype = torch_dtype(compute_dtype)
    if (bad or len(weights.dir_rest) != 3 or len(weights.seg) != 4
            or not widths_ok(hidden, branch, dtype)):
        raise ValueError(f"{what} shapes not supported: {bad}, "
                         f"{len(weights.dir_rest)} dir and {len(weights.seg)} "
                         f"seg layers, hidden {hidden}, branch {branch}")
    plan = level_train_plan(weights, dtype)
    check_device(what, pts.device, rows, table, dirs, se, z, bg, noise, tgt, lw,
                 g_rgb, g_w, graw, plan.fwd[0])
    if pair is not None:
        pw, ro = pair
        _check_kernel_shapes(None, pw, what, dtype)
        ho = pw.hyper_out["w"].shape[1]
        if mode != "loss" or PW != 3 + ho or tuple(ro.shape) != (R, 3):
            raise ValueError(f"{what}'s pair= form takes the loss mode, packed points "
                             f"3 + {ho} wide and ro ({R}, 3), got {mode}, {PW}, "
                             f"{tuple(ro.shape)}")
        check_device(what, pts.device, ro)
    f32 = torch.float32
    dev = pts.device
    c = lambda t: None if t is None else t.to(f32).contiguous()
    pts, dirs, se, z, bg, noise, tgt, lw, g_rgb, g_w, graw = map(
        c, (pts, dirs, se, z, bg, noise, tgt, lw, g_rgb, g_w, graw))
    rows, table = _grid_args(rows, table)
    n_tiles = -(-P // tile_points(dtype))
    e = lambda *shape, dt=f32: torch.empty(shape, dtype=dt, device=dev)
    composite = mode != "raw"
    rgb_map, w_out, g_bg = (e(R, 16), e(R, S), e(R, 16)) if composite else (None,) * 3
    gx, gse = e(P, PW), (e(P, C) if C else None)
    raw = e(P, 16) if composite else None
    if composite:
        graw = e(P, 16)
    acts, gzs, bsum, chunks, part, out, bwd = _call_buffers(weights, plan, n_tiles, dtype,
                                                            dev)
    p = _build.ptr
    n_trunk, _, _, _, amb, nf_xyz, nf_amb, nf_dir, gD, gH, gW = ints
    blobs = (*[p(t) for t in plan.fwd], *[p(t) for t in plan.bwd])
    wg = _forward_stages(weights, plan, dtype)
    sizes = (R, S, PW, n_trunk, weights.skip, hidden, branch, C,
             amb, nf_xyz, nf_amb, nf_dir, gD, gH, gW,
             int(dtype == torch.bfloat16), plan.n_act, plan.act_stride,
             plan.gz_stride, plan.work.numel() // 3, chunks, plan.out_len,
             float(bg_sup if bg is not None else 0.0), p(plan.prods),
             p(plan.work), p(part), p(out))
    fn = _build.function("level_train", "sahs_level_train", _SIGNATURE)
    rc = fn(p(pts), p(rows), p(table), p(dirs), p(z), p(bg),
            p(noise), p(tgt), p(lw), p(g_rgb), p(g_w), None, None, p(se), 0,
            _MODES[mode], *blobs, p(rgb_map), p(w_out), p(gx), p(gse), p(g_bg),
            p(raw), p(graw), p(acts), p(gzs), p(plan.slots), *sizes, *wg, *bwd,
            _build.stream_ptr(dev))
    _build.check(rc, what)
    if pair is not None:
        # K3's rays= call on this gx (P * PW * 4 bytes, a scratch here)
        gx = _vjp_launch(None, pw, gx, None, compute_dtype,
                         rays=(ro.to(f32), dirs, z))
    return (rgb_map, w_out, gx, gse, g_bg,
            _grads_tree(weights, plan.unpack(out)), acts)


def _stash_branches(acts: torch.Tensor, weights: LevelWeights,
                    P: int) -> List[torch.Tensor]:
    """The leaky-ReLU branches of a level kernel's launch, read from its
    stash of activations ``acts`` (slots [pe, h_0 .. h_{L-1}, feat,
    [pe(dir) | se], d0-d3, s0-s3], tile-blocked as ``level_train_plan``'s
    ``slots`` lay them out): for each leaky layer in the order the plain
    forward runs them (the trunk's, then the direction branch's, then the
    seg branch's), (P, units) bool, True where the kernel's output, and so
    its pre-activation, is positive."""
    plan = level_train_plan(weights, acts.dtype)
    tp = tile_points(acts.dtype)
    tiles = acts.numel() // plan.act_stride
    blocks = acts.reshape(tiles, plan.act_stride)
    offs = plan.slots[:plan.n_act].tolist() + [plan.act_stride]
    L = len(weights.trunk)
    out = []
    for i in list(range(1, L + 1)) + list(range(L + 3, plan.n_act)):
        units = (offs[i + 1] - offs[i]) // tp
        a = blocks[:, offs[i]:offs[i + 1]].reshape(tiles, units, tp)
        out.append(a.transpose(1, 2).reshape(tiles * tp, units)[:P] > 0)
    return out


def _vjp_branches(pts, dirs, table, rows, z, bg, noise, g_rgb, g_w,
                  weights: LevelWeights, compute_dtype: str,
                  grid_dims) -> List[torch.Tensor]:
    """The leaky-ReLU branches K6 takes on these arguments
    (``_stash_branches``), from a launch of its own, not counted, which
    gives what the caller's launch gave bit for bit."""
    *_, acts = _launch("vjp", "nerf_level_vjp", pts, dirs, table, rows, weights,
                       compute_dtype, grid_dims, z=z, bg=bg, noise=noise,
                       g_rgb=g_rgb, g_w=g_w)
    return _stash_branches(acts, weights, pts.shape[0])


def _train_branches(pts, dirs, table, rows, z, bg, noise, tgt, lw,
                    weights: LevelWeights, compute_dtype: str, grid_dims,
                    bg_sup: float = 0.0) -> List[torch.Tensor]:
    """The leaky-ReLU branches K2 takes on these arguments
    (``_stash_branches``), from a launch of its own, not counted, which
    gives what the caller's launch gave bit for bit."""
    *_, acts = _launch("loss", "nerf_level_train", pts, dirs, table, rows,
                       weights, compute_dtype, grid_dims, z=z, bg=bg,
                       noise=noise, tgt=tgt, lw=lw, bg_sup=bg_sup)
    return _stash_branches(acts, weights, pts.shape[0])


def _rayd_branches(pts, dirs, table, rows, g, weights: LevelWeights,
                   compute_dtype: str, grid_dims,
                   se: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """The leaky-ReLU branches K8 takes on these arguments
    (``_stash_branches``), from a launch of its own, not counted, which
    gives what the caller's launch gave bit for bit."""
    *_, acts = _launch("raw", "nerf_rayd_vjp", pts, dirs, table, rows, weights,
                       compute_dtype, grid_dims, graw=g, se=se)
    return _stash_branches(acts, weights, pts.shape[0])


def nerf_level_train(pts: torch.Tensor, dirs: torch.Tensor,
                     table: torch.Tensor, rows: torch.Tensor, z: torch.Tensor,
                     bg: Optional[torch.Tensor], noise: Optional[torch.Tensor],
                     tgt: torch.Tensor, lw: torch.Tensor,
                     weights: LevelWeights, compute_dtype: str = "bfloat16",
                     grid_dims=(32, 32, 32), bg_sup: float = 0.0,
                     se: Optional[torch.Tensor] = None, pair=None):
    """K2 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Same arguments and results as ``nerf_level_train_plain``;
    with ``pair`` the kernel's pair= form. One call is one count, whatever
    the number of launches inside."""
    if pts.device.type == "cpu":
        return nerf_level_train_plain(pts, dirs, table, rows, z, bg, noise, tgt,
                                      lw, weights, compute_dtype, grid_dims,
                                      bg_sup, se, pair)
    if tgt is None or lw is None:
        raise ValueError("K2 needs the target and the loss weights")
    rgb_map, w_out, gx, gse, g_bg, grads, _ = _launch(
        "loss", "nerf_level_train", pts, dirs, table, rows, weights,
        compute_dtype, grid_dims, z=z, bg=bg, noise=noise, tgt=tgt, lw=lw,
        bg_sup=bg_sup, se=se, pair=pair)
    nerf_level_train.launches += 1
    return (rgb_map, w_out, gx, gse, g_bg[:, :15] if bg is not None else None,
            grads)


nerf_level_train.launches = 0


def nerf_level_vjp(pts: torch.Tensor, dirs: torch.Tensor, table: torch.Tensor,
                   rows: torch.Tensor, z: torch.Tensor,
                   bg: Optional[torch.Tensor], noise: Optional[torch.Tensor],
                   g_rgb: torch.Tensor, g_w: torch.Tensor,
                   weights: LevelWeights, compute_dtype: str = "bfloat16",
                   grid_dims=(32, 32, 32), se: Optional[torch.Tensor] = None):
    """K6 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Same arguments and results as ``nerf_level_vjp_plain``."""
    if pts.device.type == "cpu":
        return nerf_level_vjp_plain(pts, dirs, table, rows, z, bg, noise, g_rgb,
                                    g_w, weights, compute_dtype, grid_dims, se)
    if g_rgb is None or g_w is None:
        raise ValueError("K6 needs both cotangents, g_rgb and g_w")
    _, _, gx, gse, g_bg, grads, _ = _launch(
        "vjp", "nerf_level_vjp", pts, dirs, table, rows, weights,
        compute_dtype, grid_dims, z=z, bg=bg, noise=noise, g_rgb=g_rgb,
        g_w=g_w, se=se)
    nerf_level_vjp.launches += 1
    return gx, gse, g_bg[:, :15] if bg is not None else None, grads


nerf_level_vjp.launches = 0


def nerf_rayd_vjp(pts: torch.Tensor, dirs: torch.Tensor, table: torch.Tensor,
                  rows: torch.Tensor, g: torch.Tensor, weights: LevelWeights,
                  compute_dtype: str = "bfloat16", grid_dims=(32, 32, 32),
                  se: Optional[torch.Tensor] = None):
    """K8 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Same arguments and results as ``nerf_rayd_vjp_plain``."""
    if pts.device.type == "cpu":
        return nerf_rayd_vjp_plain(pts, dirs, table, rows, g, weights,
                                   compute_dtype, grid_dims, se)
    if g is None:
        raise ValueError("K8 needs the cotangent of the raw field")
    _, _, gx, gse, _, grads, _ = _launch(
        "raw", "nerf_rayd_vjp", pts, dirs, table, rows, weights,
        compute_dtype, grid_dims, graw=g, se=se)
    nerf_rayd_vjp.launches += 1
    return gx, gse, grads


nerf_rayd_vjp.launches = 0


def nerf_mlp_vjp(pts: torch.Tensor, extra: torch.Tensor, g: torch.Tensor,
                 weights: LevelWeights, compute_dtype: str = "bfloat16"):
    """K12 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Same arguments and results as ``nerf_mlp_vjp_plain``."""
    if pts.device.type == "cpu":
        return nerf_mlp_vjp_plain(pts, extra, g, weights, compute_dtype)
    check_device("K12", pts.device)
    P, PW, ints, enc = point_kernel_args(pts, extra, weights, "K12")
    n_trunk, hidden, branch, C, amb, nf_xyz, nf_amb, nf_dir = ints
    dtype = torch_dtype(compute_dtype)
    if (tuple(g.shape) != (P, 16) or len(weights.dir_rest) != 3
            or len(weights.seg) != 4 or not widths_ok(hidden, branch, dtype)):
        raise ValueError(f"K12 shapes not supported: g {tuple(g.shape)} for "
                         f"{P} points, {len(weights.dir_rest)} dir and "
                         f"{len(weights.seg)} seg layers, hidden {hidden}, "
                         f"branch {branch}")
    plan = level_train_plan(weights, dtype)
    check_device("K12", pts.device, extra, g, plan.fwd[0])
    f32 = torch.float32
    dev = pts.device
    # pre-encoded inputs go in the compute dtype, as JAX casts them
    pts = pts.to(dtype if enc & ENC_PTS else f32).contiguous()
    extra = extra.to(dtype if enc & ENC_EXTRA else f32).contiguous()
    g = g.to(f32).contiguous()
    gx = torch.empty((P, PW), dtype=f32, device=dev)
    gextra = torch.empty(tuple(extra.shape), dtype=f32, device=dev)
    n_tiles = -(-P // tile_points(dtype))
    acts, gzs, bsum, chunks, part, out, bwd = _call_buffers(weights, plan, n_tiles,
                                                            dtype, dev)
    p = _build.ptr
    fn = _build.function("level_train", "sahs_level_train", _SIGNATURE)
    # no rays: P points of one sample each, no table, rows or directions
    rc = fn(p(pts), None, None, None, None, None, None, None, None, None, None,
            p(extra), p(gextra), None, enc, _MODES["pts"],
            *[p(t) for t in plan.fwd], *[p(t) for t in plan.bwd], None, None,
            p(gx), None, None, None, p(g), p(acts), p(gzs), p(plan.slots),
            P, 1, PW, n_trunk, weights.skip, hidden, branch, C, amb, nf_xyz,
            nf_amb, nf_dir, 0, 0, 0, int(dtype == torch.bfloat16), plan.n_act,
            plan.act_stride, plan.gz_stride, plan.work.numel() // 3, chunks,
            plan.out_len, 0.0, p(plan.prods), p(plan.work), p(part), p(out),
            *_forward_stages(weights, plan, dtype), *bwd, _build.stream_ptr(dev))
    _build.check(rc, "nerf_mlp_vjp")
    nerf_mlp_vjp.launches += 1
    return gx, gextra, _grads_tree(weights, plan.unpack(out))


nerf_mlp_vjp.launches = 0


def level_train_apply(nerf, cond: torch.Tensor, pts, dirs, table, rows, z, bg,
                      noise, tgt, lw, pts_groups, dir_groups,
                      compute_dtype: str, grid_dims, bg_sup: float = 0.0,
                      se: Optional[torch.Tensor] = None, pair=None):
    """Fold ``cond`` into the ``NeRFMLP`` module ``nerf``, run K2, unfold
    the trunk's gradients (level_train.py:358-405). The spatial embedding
    comes from the corner ``table`` and ``rows``, or from a per-point
    ``se`` (P, C) (table, rows and grid_dims None; gse then (P, C)), or
    none. Returns (rgb_map, weights, gx, gse, g_bg, grads with the raw
    trunk's shapes, dcond); with ``pair`` (PairWeights, ro (R, 3): K2's
    pair= form) the pair's folded gradient tree in gx's place."""
    lvl = prepare_level(nerf, cond, pts_groups, dir_groups)
    args = (pts, dirs, table, rows, z, bg, noise, tgt, lw, lvl, compute_dtype,
            grid_dims, bg_sup, se)
    # without the pair, K2 takes the arguments it always took
    rgb_map, w, gx, gse, g_bg, grads = (nerf_level_train(*args) if pair is None
                                        else nerf_level_train(*args, pair=pair))
    spec = nerf.spec
    raw = [{"w": p["w"].detach(), "b": p["b"].detach()}
           for p in trunk_params(nerf.trunk)]
    grads["trunk"], dcond = unfold_cond_grads(
        raw, grads["trunk"], cond, spec.skip_connect_every, spec.hidden_size,
        spec.pe_xyz_dim + spec.ambient_pe_dim)
    return rgb_map, w, gx, gse, g_bg, grads, dcond
