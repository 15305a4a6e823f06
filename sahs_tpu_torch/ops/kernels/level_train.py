"""K2: one NeRF level for training, forward, in-kernel loss cotangents and
the full backward in one call.

Replaces ``sahs_tpu/ops/pallas/level_train.py:nerf_level_train`` (:55,
``pallas_call`` at :306) in its ``corner_interp`` form. The CUDA kernel is
``csrc/level_train.cu``; its source note gives the bound on the H100 and
the design.

The Stage-I loss is per-ray analytic, so its cotangents are formed where
the composited outputs are (level_train.py:26-32):
  g_rgb[r, 0:3]  = w_l2(r) * 2 * (rgb[r] - target[r])
  g_rgb[r, 3:15] = w_ce(r) * (-mask[r, c] / (seg[r, c] + 1e-10))
  g_w[r, S-1]    = bg_sup * ||bg[r, :3] - target[r]||^2
  g_bg[r, 0:3]  += bg_sup * w_last(r) * 2 * (bg[r] - target[r])
and run back through the compositing (field_mlp.py:2580-2623), the heads,
the trunk, the positional encoding and the trilinear sample
(field_mlp.py:2788-2901, with the corner dCoords of :1824).

``nerf_level_train`` launches the kernel for CUDA tensors and counts the
call in ``nerf_level_train.launches``; for CPU tensors it runs
``nerf_level_train_plain``. ``level_train_apply`` folds the conditioning,
runs it and unfolds the trunk's gradients (level_train.py:358-405).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ..grid import _cell_geometry, interp_corners
from .field_mlp import (BlobBuilder, TrainPlan, build_train_plan, dact,
                        dw_chunks, kernel_pe, mm, mm_t, pe_columns,
                        torch_dtype, trunk_backward, trunk_forward,
                        trunk_params, unfold_cond_grads)
from .nerf_level import LevelWeights, _pe_freqs, leaky, prepare_level

TP = 32   # points per tile of K2's per-point kernels and of its stash


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def composite_train_plain(raw: torch.Tensor, z: torch.Tensor,
                          dirs: torch.Tensor, bg: Optional[torch.Tensor],
                          noise: Optional[torch.Tensor], tgt: torch.Tensor,
                          lw: torch.Tensor, bg_sup: float):
    """Compositing (as nerf_level.composite_plain), the loss cotangents and
    the compositing backward, float32. raw (R, S, 16) rgb3 | seg12 | sigma1.
    Returns (rgb_map (R, 16), weights (R, S), graw (R, S, 16) the cotangent
    of raw, g_bg (R, 15) | None)."""
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
    rgb_map = torch.sum(w[..., None] * ch, dim=1)

    g_rgb = torch.cat([lw[:, 0:1] * 2.0 * (rgb_map[:, :3] - tgt[:, :3]),
                       lw[:, 1:2] * (-tgt[:, 3:15] / (rgb_map[:, 3:15] + 1e-10)),
                       torch.zeros_like(rgb_map[:, :1])], dim=-1)
    g_w = torch.zeros_like(w)
    sup = bg_sup > 0.0 and bg is not None
    if sup:
        g_w[:, -1] = bg_sup * torch.sum(torch.square(bg[:, :3] - tgt[:, :3]), dim=-1)
    g_ch = w[..., None] * g_rgb[:, None, :]
    g_bg = None
    if bg is not None:
        g_bg = g_ch[:, -1, :15].clone()
        if sup:
            g_bg[:, :3] += bg_sup * w[:, -1:] * 2.0 * (bg[:, :3] - tgt[:, :3])
    g_w_tot = g_w + torch.sum(ch * g_rgb[:, None, :], dim=-1)
    g_cum = T * (g_w_tot * alpha)
    # the transpose of the exclusive scan: the sum over later samples
    rev = torch.flip(torch.cumsum(torch.flip(g_cum, [-1]), dim=-1), [-1])
    g_log = torch.cat([rev[:, 1:], zcol], dim=-1)
    g_alpha = g_w_tot * T - g_log / (t_term + 1e-10)
    g_sig = g_alpha * t_term * dists * (sig > 0).to(f32)
    not_last = (1.0 - is_last)[..., None] if bg is not None else 1.0
    grgb3 = g_ch[..., :3] * rgb_sig * (1.0 - rgb_sig) * not_last
    gs = g_ch[..., 3:15]
    if bg is not None:
        gseg = seg_act * (gs - torch.sum(gs * seg_act, dim=-1, keepdim=True)) * not_last
    else:
        gseg = gs * seg_act * (1.0 - seg_act)
    graw = torch.cat([grgb3, gseg, g_sig[..., None]], dim=-1)
    return rgb_map, w, graw, g_bg


def pe_backward(x: torch.Tensor, g_pe: torch.Tensor, groups) -> torch.Tensor:
    """Cotangent of the raw coordinates from that of ``kernel_pe``'s output:
    g * cos(x f + phase) * f per sine slot, g per input slot."""
    src, freq, phase, is_input = pe_columns(groups)
    dev = x.device
    src_t = torch.as_tensor(src, device=dev)
    xs = x[:, src_t].to(torch.float32)
    fr = torch.as_tensor(freq, device=dev)
    t = xs * fr + torch.as_tensor(phase, device=dev)
    dt = torch.where(torch.as_tensor(is_input, device=dev), g_pe,
                     g_pe * torch.cos(t) * fr)
    return torch.zeros((x.shape[0], x.shape[1]), dtype=torch.float32,
                       device=dev).index_add_(1, src_t, dt)


def corner_dcoords(gse: torch.Tensor, fs, ok: torch.Tensor, cf: torch.Tensor,
                   dims) -> torch.Tensor:
    """Warped-coordinate cotangent of the trilinear sample (field_mlp.py:
    1824-1843): each axis' weight replaced by +-1. gse (P, C) -> (P, 3)."""
    C = gse.shape[1]
    fx, fy, fz = fs
    okf = ok.to(torch.float32)
    dfx = dfy = dfz = 0.0
    for s in range(8):
        dz_, dy_, dx_ = (s >> 2) & 1, (s >> 1) & 1, s & 1
        gv = torch.sum(gse * cf[:, s * C:(s + 1) * C], dim=-1)
        wz = fz if dz_ else 1.0 - fz
        wy = fy if dy_ else 1.0 - fy
        wx = fx if dx_ else 1.0 - fx
        dfx = dfx + (1.0 if dx_ else -1.0) * wz * wy * gv
        dfy = dfy + (1.0 if dy_ else -1.0) * wz * wx * gv
        dfz = dfz + (1.0 if dz_ else -1.0) * wy * wx * gv
    D_, H_, W_ = dims
    return torch.stack([dfx * okf * (0.5 * (W_ - 1)), dfy * okf * (0.5 * (H_ - 1)),
                        dfz * okf * (0.5 * (D_ - 1))], dim=-1)


def _lin_grad(a, gz, dtype):
    return {"w": mm_t(a, gz, dtype), "b": torch.sum(gz, dim=0)}


def nerf_level_train_plain(pts: torch.Tensor, dirs: torch.Tensor,
                           table: torch.Tensor, rows: torch.Tensor,
                           z: torch.Tensor, bg: Optional[torch.Tensor],
                           noise: Optional[torch.Tensor], tgt: torch.Tensor,
                           lw: torch.Tensor, weights: LevelWeights,
                           compute_dtype: str, grid_dims, bg_sup: float = 0.0):
    """Arguments as ``nerf_level.nerf_level_plain`` plus tgt (R, 15)
    [target rgb | seg mask], lw (R, 2) per-ray loss weights and bg_sup.
    Returns (rgb_map (R, 16), weights (R, S), gx (P, 3 + ambient), gse
    (P, C), g_bg (R, 15) | None, grads), grads the folded level's
    {"trunk": [{"w", "b"}], "fc_feat", "fc_alpha", "dir": [...],
    "fc_rgb", "seg": [...], "fc_seg"} with dir[0]'s rows [feat | pe(dir) |
    se], the JAX package's layout."""
    dtype = torch_dtype(compute_dtype)
    R, S = z.shape
    W = weights
    f32 = torch.float32
    with torch.no_grad():
        x = kernel_pe(pts, W.pts_groups)
        _, fs, ok = _cell_geometry(pts, grid_dims)
        cf = table[rows.reshape(-1).long()].to(f32)
        se = interp_corners(cf, fs, ok)
        tacts = []
        h = trunk_forward(W.trunk, x, W.skip, leaky, dtype, acts=tacts)
        feat = mm(h, W.feat["w"], dtype) + W.feat["b"]
        alpha = mm(feat, W.alpha["w"], dtype) + W.alpha["b"]
        dir_pe = kernel_pe(dirs, W.dir_groups).repeat_interleave(S, dim=0)
        dir_head = mm(kernel_pe(dirs, W.dir_groups), W.dir0_dir, dtype)
        d = leaky(mm(feat, W.dir0_feat, dtype) + mm(se, W.dir0_se, dtype)
                  + (dir_head + W.dir0_b).repeat_interleave(S, dim=0))
        dacts = [d]
        for p in W.dir_rest:
            d = leaky(mm(d, p["w"], dtype) + p["b"])
            dacts.append(d)
        rgb = mm(d, W.rgb["w"], dtype) + W.rgb["b"]
        s = feat
        sacts = []
        for p in W.seg:
            s = leaky(mm(s, p["w"], dtype) + p["b"])
            sacts.append(s)
        seg = mm(s, W.seg_out["w"], dtype) + W.seg_out["b"]
        raw = torch.cat([rgb, seg, alpha], dim=-1).reshape(R, S, 16)
        rgb_map, w_out, graw, g_bg = composite_train_plain(
            raw, z, dirs, bg, noise, tgt, lw, bg_sup)

        graw = graw.reshape(R * S, 16)
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
                                    mm_t(dir_pe, gzd0, dtype),
                                    mm_t(se, gzd0, dtype)], dim=0),
                    "b": torch.sum(gzd0, dim=0)}
        gse = mm(gzd0, W.dir0_se.t(), dtype)
        gfeat = gfeat + mm(gzd0, W.dir0_feat.t(), dtype)
        # alpha head, feat layer, trunk
        grads["fc_alpha"] = _lin_grad(feat, galpha, dtype)
        gfeat = gfeat + mm(galpha, W.alpha["w"].t(), dtype)
        grads["fc_feat"] = _lin_grad(h, gfeat, dtype)
        gh = mm(gfeat, W.feat["w"].t(), dtype)
        gx_pe, trunk_g = trunk_backward(W.trunk, x, tacts, gh, W.skip, "leaky",
                                        dtype, need_gx=True)
        gx = pe_backward(pts, gx_pe, W.pts_groups)
        gx[:, :3] += corner_dcoords(gse, fs, ok, cf, grid_dims)
        grads.update(trunk=trunk_g, dir=dir_g, seg=seg_g)
    return rgb_map, w_out, gx, gse, g_bg, grads


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
        fwd, bwd = BlobBuilder(), BlobBuilder()
        for i, p in enumerate(W.trunk):
            if i == W.skip and i > 0:
                fwd.layer(p["w"][:hid], p["b"], "leaky", w2=p["w"][hid:])
            else:
                fwd.layer(p["w"], p["b"], "leaky")
        d0_in2 = torch.cat([W.dir0_dir, W.dir0_se], dim=0)
        fwd.layer(W.feat["w"], W.feat["b"], "linear")
        fwd.layer(W.alpha["w"], W.alpha["b"], "linear")
        fwd.layer(W.dir0_feat, W.dir0_b, "leaky", w2=d0_in2)
        for p in W.dir_rest:
            fwd.layer(p["w"], p["b"], "leaky")
        fwd.layer(W.rgb["w"], W.rgb["b"], "linear")
        for p in W.seg:
            fwd.layer(p["w"], p["b"], "leaky")
        fwd.layer(W.seg_out["w"], W.seg_out["b"], "linear")

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
        W._blobs[key] = build_train_plan(fwd, bwd, act_rows, inputs, TP, dtype)
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


def nerf_level_train(pts: torch.Tensor, dirs: torch.Tensor,
                     table: torch.Tensor, rows: torch.Tensor, z: torch.Tensor,
                     bg: Optional[torch.Tensor], noise: Optional[torch.Tensor],
                     tgt: torch.Tensor, lw: torch.Tensor,
                     weights: LevelWeights, compute_dtype: str = "bfloat16",
                     grid_dims=(32, 32, 32), bg_sup: float = 0.0):
    """K2 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Same arguments and results as ``nerf_level_train_plain``.
    One call is one count, whatever the number of launches inside."""
    if pts.device.type == "cpu":
        return nerf_level_train_plain(pts, dirs, table, rows, z, bg, noise, tgt,
                                      lw, weights, compute_dtype, grid_dims,
                                      bg_sup)
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}")
    dtype = torch_dtype(compute_dtype)
    R, S = z.shape
    P, PW = pts.shape
    C = table.shape[1] // 8
    nf_xyz, nf_amb = (_pe_freqs(weights.pts_groups, 2, "point") if PW > 3
                      else _pe_freqs(weights.pts_groups, 1, "point") + [0])
    (nf_dir,) = _pe_freqs(weights.dir_groups, 1, "direction")
    hidden = weights.trunk[0]["w"].shape[1]
    branch = weights.dir0_b.shape[0]
    gD, gH, gW = grid_dims
    if (P != R * S or PW > 8 or nf_dir > 4 or table.dtype != dtype
            or weights.dir0_se.shape[0] != C or len(weights.dir_rest) != 3
            or len(weights.seg) != 4 or branch % 8 or hidden % 8
            or table.shape[0] != (gD + 1) * (gH + 1) * (gW + 1)
            or rows.numel() != P or tuple(dirs.shape) != (R, 3)
            or tuple(tgt.shape) != (R, 15) or tuple(lw.shape) != (R, 2)
            or (bg is not None and tuple(bg.shape) != (R, 15))
            or (noise is not None and tuple(noise.shape) != (R, S))):
        raise ValueError(
            f"K2 shapes not supported: pts {tuple(pts.shape)}, z {tuple(z.shape)}, "
            f"rows {tuple(rows.shape)}, dirs {tuple(dirs.shape)}, tgt "
            f"{tuple(tgt.shape)}, lw {tuple(lw.shape)}, table "
            f"{tuple(table.shape)} {table.dtype} for grid {tuple(grid_dims)}")
    plan = level_train_plan(weights, dtype)
    tensors = [pts, rows, table, dirs, z, bg, noise, tgt, lw, plan.fwd[0]]
    if any(t is not None and t.device != pts.device for t in tensors):
        raise ValueError("K2 inputs and weights must all be on " + str(pts.device))
    f32 = torch.float32
    dev = pts.device
    c = lambda t: None if t is None else t.to(f32).contiguous()
    pts, dirs, z, bg, noise, tgt, lw = map(c, (pts, dirs, z, bg, noise, tgt, lw))
    rows = rows.reshape(-1).to(torch.int32).contiguous()
    n_tiles = -(-P // TP)
    e = lambda *shape, dt=f32: torch.empty(shape, dtype=dt, device=dev)
    rgb_map, w_out, g_bg = e(R, 16), e(R, S), e(R, 16)
    gx, gse = e(P, PW), e(P, C)
    raw, graw = e(P, 16), e(P, 16)
    acts = e(n_tiles * plan.act_stride, dt=dtype)
    gzs = e(n_tiles * plan.gz_stride)
    chunks = dw_chunks(n_tiles)
    part = torch.zeros(chunks * plan.out_len, dtype=f32, device=dev)
    out = e(plan.out_len)
    p = _build.ptr
    fn = _build.function("level_train", "sahs_level_train",
                         "p" * 9 + "ppp" + "ppp" + "p" * 5 + "pp" + "pp"
                         + "p" + "l" + "i" * 15 + "i" * 6 + "f" + "pppp" + "p")
    rc = fn(p(pts), p(rows), p(table.contiguous()), p(dirs), p(z), p(bg),
            p(noise), p(tgt), p(lw), *[p(t) for t in plan.fwd],
            *[p(t) for t in plan.bwd], p(rgb_map), p(w_out), p(gx), p(gse),
            p(g_bg), p(raw), p(graw), p(acts), p(gzs), p(plan.slots),
            R, S, PW, len(weights.trunk), weights.skip, hidden, branch, C,
            PW - 3, nf_xyz, nf_amb, nf_dir, gD, gH, gW,
            int(dtype == torch.bfloat16), plan.n_act, plan.act_stride,
            plan.gz_stride, plan.work.numel() // 3, chunks, plan.out_len,
            float(bg_sup if bg is not None else 0.0), p(plan.prods),
            p(plan.work), p(part), p(out), _build.stream_ptr(dev))
    _build.check(rc, "nerf_level_train")
    nerf_level_train.launches += 1
    return (rgb_map, w_out, gx, gse, g_bg[:, :15] if bg is not None else None,
            _grads_tree(weights, plan.unpack(out)))


nerf_level_train.launches = 0


def level_train_apply(nerf, cond: torch.Tensor, pts, dirs, table, rows, z, bg,
                      noise, tgt, lw, pts_groups, dir_groups,
                      compute_dtype: str, grid_dims, bg_sup: float = 0.0):
    """Fold ``cond`` into the ``NeRFMLP`` module ``nerf``, run K2, unfold
    the trunk's gradients (level_train.py:358-405). Returns (rgb_map,
    weights, gx, gse, g_bg, grads with the raw trunk's shapes, dcond)."""
    lvl = prepare_level(nerf, cond, pts_groups, dir_groups)
    rgb_map, w, gx, gse, g_bg, grads = nerf_level_train(
        pts, dirs, table, rows, z, bg, noise, tgt, lw, lvl, compute_dtype,
        grid_dims, bg_sup)
    spec = nerf.spec
    raw = [{"w": p["w"].detach(), "b": p["b"].detach()}
           for p in trunk_params(nerf.trunk)]
    grads["trunk"], dcond = unfold_cond_grads(
        raw, grads["trunk"], cond, spec.skip_connect_every, spec.hidden_size,
        spec.pe_xyz_dim + spec.ambient_pe_dim)
    return rgb_map, w, gx, gse, g_bg, grads, dcond
