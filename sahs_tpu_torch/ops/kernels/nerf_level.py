"""K5: one NeRF level (MLP + trilinear spatial embedding + compositing),
forward.

Replaces ``sahs_tpu/ops/pallas/field_mlp.py:nerf_level_forward`` (:2681,
``pallas_call`` at :2761) in its ``corner_interp`` form. The CUDA kernel is
``csrc/nerf_level.cu``; its source note gives the bound on the H100
(operations: ~1.47 MFLOP per point) and the design. Unlike the TPU kernel
it gathers the 8 corner rows itself, by row index, from the corner table
in L2: a pre-gathered (P, 256) array at a fine chunk would be 2.1 GB.

``nerf_level_forward`` launches the kernel for tensors on a CUDA device and
counts the launch in ``nerf_level_forward.launches``; for tensors on the
CPU it runs ``nerf_level_plain``, the same function in plain tensor math.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from . import _build
from ..grid import _cell_geometry, interp_corners
from .field_mlp import (BlobBuilder, PEGroup, fold_trunk, kernel_pe, mm,
                        linear_params, torch_dtype, trunk_forward,
                        trunk_params)


@dataclasses.dataclass
class LevelWeights:
    """A ``NeRFMLP`` with the per-frame conditioning folded into the trunk's
    input and skip biases. The first direction-branch layer is split into
    its [feat | pe(dir) | se] row blocks (field_mlp.py:1846-1888)."""
    trunk: List[dict]
    skip: int
    feat: dict
    alpha: dict
    dir0_feat: torch.Tensor
    dir0_dir: torch.Tensor
    dir0_se: torch.Tensor
    dir0_b: torch.Tensor
    dir_rest: List[dict]
    rgb: dict
    seg: List[dict]
    seg_out: dict
    pts_groups: Tuple[PEGroup, ...]
    dir_groups: Tuple[PEGroup, ...]
    _blobs: dict = dataclasses.field(default_factory=dict)

    def blob(self, dtype: torch.dtype):
        """(weight blob, bias blob, layer descriptors), in the layer order
        csrc/nerf_level.cu reads: trunk, feat, alpha, dir0, dir0's pe(dir)
        block, dir1-3, rgb, seg0-3, seg head."""
        if dtype not in self._blobs:
            bb = BlobBuilder()
            for i, p in enumerate(self.trunk):
                if i == self.skip and i > 0:
                    hid = self.trunk[i - 1]["w"].shape[1]
                    bb.layer(p["w"][:hid], p["b"], "leaky", w2=p["w"][hid:])
                else:
                    bb.layer(p["w"], p["b"], "leaky")
            bb.layer(self.feat["w"], self.feat["b"], "linear")
            bb.layer(self.alpha["w"], self.alpha["b"], "linear")
            bb.layer(self.dir0_feat, self.dir0_b, "leaky", w2=self.dir0_se)
            bb.layer(self.dir0_dir, torch.zeros_like(self.dir0_b), "linear")
            for p in self.dir_rest:
                bb.layer(p["w"], p["b"], "leaky")
            bb.layer(self.rgb["w"], self.rgb["b"], "linear")
            for p in self.seg:
                bb.layer(p["w"], p["b"], "leaky")
            bb.layer(self.seg_out["w"], self.seg_out["b"], "linear")
            self._blobs[dtype] = bb.build(dtype)
        return self._blobs[dtype]


def prepare_level(nerf, cond: torch.Tensor, pts_groups: Sequence[PEGroup],
                  dir_groups: Sequence[PEGroup]) -> LevelWeights:
    """Fold ``cond`` into a ``NeRFMLP``'s trunk (field_grid.py:113-118)."""
    spec = nerf.spec
    pe_dim = spec.pe_xyz_dim + spec.ambient_pe_dim
    hid = spec.hidden_size
    dr = spec.pe_dir_dim
    with torch.no_grad():
        trunk = fold_trunk(trunk_params(nerf.trunk), cond, pe_dim, hid,
                           spec.skip_connect_every)
        d0 = linear_params(nerf.dir[0])
        return LevelWeights(
            trunk=trunk, skip=spec.skip_connect_every,
            feat=linear_params(nerf.fc_feat), alpha=linear_params(nerf.fc_alpha),
            dir0_feat=d0["w"][:hid], dir0_dir=d0["w"][hid:hid + dr],
            dir0_se=d0["w"][hid + dr:], dir0_b=d0["b"],
            dir_rest=[linear_params(l) for l in nerf.dir[1:]],
            rgb=linear_params(nerf.fc_rgb),
            seg=[linear_params(l) for l in nerf.seg],
            seg_out=linear_params(nerf.fc_seg),
            pts_groups=tuple(pts_groups), dir_groups=tuple(dir_groups))


def leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.01 * x)


def composite_plain(raw: torch.Tensor, z: torch.Tensor, dirs: torch.Tensor,
                    bg: Optional[torch.Tensor], noise: Optional[torch.Tensor]):
    """In-kernel compositing semantics (field_mlp.py:2498-2577) in float32:
    raw (R, S, 16) = rgb3 | seg12 | sigma1 -> (rgb_map (R, 16), weights (R, S))."""
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
    # the transmittance stays explicit: 1 - alpha + 1e-10 is NaN at alpha = 1
    t_term = torch.exp(-sigma * dists)
    alpha = 1.0 - t_term
    logterm = torch.log(t_term + 1e-10)
    excl = torch.cat([torch.zeros_like(logterm[:, :1]),
                      torch.cumsum(logterm, dim=-1)[:, :-1]], dim=-1)
    w = alpha * torch.exp(excl)
    rgb_sig = torch.sigmoid(raw[..., :3])
    zero = torch.zeros_like(raw[..., :1])
    if bg is not None:
        ch = torch.cat([rgb_sig, torch.softmax(raw[..., 3:15], dim=-1), zero], dim=-1)
        last = torch.cat([bg.to(f32), zero[:, 0]], dim=-1)
        ch = torch.cat([ch[:, :-1], last[:, None]], dim=1)
    else:
        ch = torch.cat([rgb_sig, torch.sigmoid(raw[..., 3:15]), zero], dim=-1)
    rgb_map = torch.sum(w[..., None] * ch, dim=1)
    return rgb_map, w


def nerf_level_plain(pts: torch.Tensor, dirs: torch.Tensor,
                     table: torch.Tensor, rows: torch.Tensor, z: torch.Tensor,
                     bg: Optional[torch.Tensor], noise: Optional[torch.Tensor],
                     weights: LevelWeights, compute_dtype: str, grid_dims):
    """pts (P, 3 + ambient) packed [warped | ambient], P = R*S ray-major;
    dirs (R, 3) raw; table the corner table; rows (P,) its row per point;
    z (R, S); bg (R, 15) | None; noise (R, S) | None (already scaled).
    Returns (rgb_map (R, 16), weights (R, S))."""
    dtype = torch_dtype(compute_dtype)
    R, S = z.shape
    W = weights
    with torch.no_grad():
        x = kernel_pe(pts, W.pts_groups)
        _, fs, ok = _cell_geometry(pts, grid_dims)
        se = interp_corners(table[rows.reshape(-1).long()], fs, ok)
        h = trunk_forward(W.trunk, x, W.skip, leaky, dtype)
        feat = mm(h, W.feat["w"], dtype) + W.feat["b"]
        alpha = mm(feat, W.alpha["w"], dtype) + W.alpha["b"]
        dir_head = mm(kernel_pe(dirs, W.dir_groups), W.dir0_dir, dtype)
        d = leaky(mm(feat, W.dir0_feat, dtype) + mm(se, W.dir0_se, dtype)
                  + (dir_head + W.dir0_b).repeat_interleave(S, dim=0))
        for p in W.dir_rest:
            d = leaky(mm(d, p["w"], dtype) + p["b"])
        rgb = mm(d, W.rgb["w"], dtype) + W.rgb["b"]
        s = feat
        for p in W.seg:
            s = leaky(mm(s, p["w"], dtype) + p["b"])
        seg = mm(s, W.seg_out["w"], dtype) + W.seg_out["b"]
        raw = torch.cat([rgb, seg, alpha], dim=-1).reshape(R, S, 16)
        return composite_plain(raw, z, dirs, bg, noise)


def _pe_freqs(groups, want: int, what: str) -> List[int]:
    if len(groups) != want or any(not g[3] or not g[4] for g in groups):
        raise ValueError(f"the K5 kernel takes {want} {what} PE group(s) with "
                         f"include_input and log sampling, got {groups}")
    return [g[2] for g in groups]


def nerf_level_forward(pts: torch.Tensor, dirs: torch.Tensor,
                       table: torch.Tensor, rows: torch.Tensor,
                       z: torch.Tensor, bg: Optional[torch.Tensor],
                       noise: Optional[torch.Tensor], weights: LevelWeights,
                       compute_dtype: str = "bfloat16", grid_dims=(32, 32, 32)):
    """K5 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Same arguments and results as ``nerf_level_plain``."""
    if pts.device.type == "cpu":
        return nerf_level_plain(pts, dirs, table, rows, z, bg, noise, weights,
                                compute_dtype, grid_dims)
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
    if (P != R * S or PW > 8 or nf_dir > 4 or 2 * branch > hidden
            or table.dtype != dtype or weights.dir0_se.shape[0] != C
            or table.shape[0] != (gD + 1) * (gH + 1) * (gW + 1)
            or rows.numel() != P or tuple(dirs.shape) != (R, 3)
            or (bg is not None and tuple(bg.shape) != (R, 15))
            or (noise is not None and tuple(noise.shape) != (R, S))):
        raise ValueError(
            f"K5 shapes not supported: pts {tuple(pts.shape)}, z {tuple(z.shape)}, "
            f"rows {tuple(rows.shape)}, dirs {tuple(dirs.shape)}, table "
            f"{tuple(table.shape)} {table.dtype} for grid {tuple(grid_dims)}, "
            f"dir freqs {nf_dir}, hidden {hidden}, branch {branch}")
    wblob, bblob, meta = weights.blob(dtype)
    tensors = [pts, rows, table, dirs, z, bg, noise, wblob]
    if any(t is not None and t.device != pts.device for t in tensors):
        raise ValueError("K5 inputs and weights must all be on " + str(pts.device))
    f32 = torch.float32
    pts = pts.to(f32).contiguous()
    rows = rows.reshape(-1).to(torch.int32).contiguous()
    dirs = dirs.to(f32).contiguous()
    z = z.to(f32).contiguous()
    bg = bg.to(f32).contiguous() if bg is not None else None
    noise = noise.to(f32).contiguous() if noise is not None else None
    rgb_map = torch.empty((R, 16), dtype=f32, device=pts.device)
    w_out = torch.empty((R, S), dtype=f32, device=pts.device)
    fn = _build.function("nerf_level", "sahs_nerf_level_forward",
                         "p" * 12 + "l" + "i" * 14 + "p")
    p = _build.ptr
    rc = fn(p(pts), p(rows), p(table.contiguous()), p(dirs), p(z), p(bg),
            p(noise), p(wblob), p(bblob), p(meta), p(rgb_map), p(w_out),
            R, S, PW, len(weights.trunk), hidden, branch, C, PW - 3, nf_xyz,
            nf_amb, nf_dir, gD, gH, gW, int(dtype == torch.bfloat16),
            _build.stream_ptr(pts.device))
    _build.check(rc, "nerf_level_forward")
    nerf_level_forward.launches += 1
    return rgb_map, w_out


nerf_level_forward.launches = 0
