"""K5: one NeRF level (MLP + trilinear spatial embedding + compositing),
forward; and K7, the same field without the compositing.

K5 replaces ``sahs_tpu/ops/pallas/field_mlp.py:nerf_level_forward`` (:2681,
``pallas_call`` at :2761) in its ``corner_interp`` form. The CUDA kernel is
``csrc/nerf_level.cu``; its source note gives the bound on the H100
(operations: ~1.47 MFLOP per point) and the design. Unlike the TPU kernel
it gathers the 8 corner rows itself, by row index, from the corner table
in L2: a pre-gathered (P, 256) array at a fine chunk would be 2.1 GB.

K7 replaces ``field_mlp.py:nerf_rayd_forward`` (:1973, ``pallas_call`` at
:2040) in its ``corner_interp`` form: the raw field (P, 16) of the
deformation-reuse path, which composites outside the kernel. It is the same
CUDA kernel, told to write each point's raw output and stop.

A model without the spatial-embedding grid takes both in their grid-free
form (JAX: ``field_mlp.py:nerf_render_level`` :3187 and
``nerf_mlp_apply_rayd`` :2399, ``se=None``): no corner table and no rows
(``table`` and ``rows`` None), the folded level's ``dir0_se`` of zero
rows, so the direction branch's first layer reads [feat | pe(dir)].

Both also take JAX's third source of the se columns, a per-point spatial
embedding ``se`` (P, C) given in place of the corner table and rows (the
non-``corner_interp`` form, field_mlp.py:1997-2032): JAX rounds it to the
compute dtype before its kernel and the kernel reads it as it is, so the
kernels here read each point's row and round it to the compute dtype.

In bfloat16 both run on the tensor cores, reading the same weight blob as
their backwards K6 and K8 (``point_blob``): K7 as ``nerf_field_tc`` (the
forward tile of the level backward, ``csrc/level_train.cu:field_tc_kernel``,
on 64-point tiles), K5 as ``_nerf_level_tc`` (that raw field into a float32
scratch, then ``composite_fwd_kernel``, the forward half of K2's and K6's
compositing, per ray: two launches, one count). A bf16 level those kernels
do not take raises. In float32 both run the SIMT kernel of
``nerf_level.cu``.

``nerf_level_forward`` and ``nerf_rayd_forward`` launch a kernel for
tensors on a CUDA device and count the launch in ``<wrapper>.launches``;
for tensors on the CPU they run ``nerf_level_plain`` / ``nerf_raw_plain``,
the same functions in plain tensor math.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from . import _build
from ..grid import _cell_geometry, interp_corners
from .field_mlp import (BlobBuilder, PEGroup, fold_trunk, kernel_pe, mm,
                        linear_grads, linear_params, stage_blob, stage_order,
                        torch_dtype, trunk_forward, trunk_params)


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
    pts_groups: Optional[Tuple[PEGroup, ...]]
    dir_groups: Optional[Tuple[PEGroup, ...]]
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


def point_layers(W: LevelWeights) -> BlobBuilder:
    """The layers of a per-point NeRF pass, in the order csrc/nerf_mlp.cu
    (K11) and the per-tile kernels of csrc/level_train.cu read them: trunk,
    feat, alpha, dir0 (inputs feat and [pe(dir) | se]), dir1-3, rgb,
    seg0-3, seg head."""
    fwd = BlobBuilder()
    hid = W.trunk[0]["w"].shape[1]
    for i, p in enumerate(W.trunk):
        if i == W.skip and i > 0:
            fwd.layer(p["w"][:hid], p["b"], "leaky", w2=p["w"][hid:])
        else:
            fwd.layer(p["w"], p["b"], "leaky")
    fwd.layer(W.feat["w"], W.feat["b"], "linear")
    fwd.layer(W.alpha["w"], W.alpha["b"], "linear")
    fwd.layer(W.dir0_feat, W.dir0_b, "leaky",
              w2=torch.cat([W.dir0_dir, W.dir0_se], dim=0))
    for p in W.dir_rest:
        fwd.layer(p["w"], p["b"], "leaky")
    fwd.layer(W.rgb["w"], W.rgb["b"], "linear")
    for p in W.seg:
        fwd.layer(p["w"], p["b"], "leaky")
    fwd.layer(W.seg_out["w"], W.seg_out["b"], "linear")
    return fwd


def point_blob(weights: LevelWeights, dtype: torch.dtype):
    """The (weight blob, bias blob, layer descriptors) of ``point_layers``,
    built once per folded level and dtype: read by K11, by bf16 K7 and, as
    the forward blob of their train plan, by K2, K6, K8 and K12."""
    key = ("point", dtype)
    if key not in weights._blobs:
        bb = point_layers(weights)
        weights._blobs[key] = bb.build(dtype)
        weights._blobs["point_descs"] = bb.descs
    return weights._blobs[key]


def wgmma_heads(n_trunk: int) -> Tuple[int, int, int]:
    """The layers of ``point_layers`` that are heads (alpha, rgb, the seg
    logits): the tile runs each as one product of its padded width."""
    return n_trunk + 1, n_trunk + 6, n_trunk + 11


def wgmma_stages(descs, n_trunk: int):
    """``field_mlp.stage_order`` of a level's forward blob: the stages of
    the field's forward tile in the order it reads them."""
    return stage_order(descs, wgmma_heads(n_trunk))


def field_promote() -> int:
    """The accumulation form of the bf16 forward tile (csrc/level_train.cu
    FIELD_PROMOTE): k16 steps summed in the tensor core before each float32
    add, 0 for a layer's whole K."""
    return _build.function("level_train", "sahs_field_promote", "")()


def wgmma_blob(weights: LevelWeights, w: torch.Tensor) -> torch.Tensor:
    """The weight stages of the bf16 forward tile (``field_tc_kernel`` and
    ``fwd_tc_kernel`` of csrc/level_train.cu) from ``w``, the bf16 weight
    blob of ``point_blob`` or of a train plan's forward blob (a copy that a
    test may have altered): each stage is one 64-k block of one output chunk
    of a layer, rows of 128 bytes in the 128-byte swizzle, K-major (the
    transposed weights), zero past K and past the layer's outputs; stages in
    the order the tile runs its products. Built on w's device, kept while
    ``w`` is the same tensor, unchanged."""
    descs = weights._blobs.get("point_descs") or point_layers(weights).descs
    heads = wgmma_heads(len(weights.trunk))
    if [descs[q][4] for q in heads] != [8, 8, 16]:
        raise ValueError("the forward tile takes heads of 1, 3 and 12 outputs "
                         f"(padded 8, 8, 16), got {[d[4] for d in descs]}")
    return stage_blob(weights._blobs, w, descs, heads)


def prepare_level(nerf, cond: torch.Tensor,
                  pts_groups: Optional[Sequence[PEGroup]],
                  dir_groups: Optional[Sequence[PEGroup]]) -> LevelWeights:
    """Fold ``cond`` into a ``NeRFMLP``'s trunk (field_grid.py:113-118).
    PE groups None: the per-point field (K11/K12) takes that input as an
    encoding already (field_mlp.py:nerf_mlp_apply_fused without pe specs)."""
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
            pts_groups=None if pts_groups is None else tuple(pts_groups),
            dir_groups=None if dir_groups is None else tuple(dir_groups))


def level_param_grads(out: dict, nerf, g) -> None:
    """A level's gradient tree (the JAX layout, raw trunk) -> ``out[param]``
    for the ``NeRFMLP`` module ``nerf``."""
    for lin, gl in zip(nerf.trunk.layers, g["trunk"]):
        linear_grads(out, lin, gl)
    for name in ("fc_feat", "fc_alpha", "fc_rgb", "fc_seg"):
        linear_grads(out, getattr(nerf, name), g[name])
    for lin, gl in zip(nerf.dir, g["dir"]):
        linear_grads(out, lin, gl)
    for lin, gl in zip(nerf.seg, g["seg"]):
        linear_grads(out, lin, gl)


def leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.01 * x)


def composite_plain(raw: torch.Tensor, z: torch.Tensor, dirs: torch.Tensor,
                    bg: Optional[torch.Tensor], noise: Optional[torch.Tensor]):
    """In-kernel compositing semantics (field_mlp.py:2498-2577) in float32,
    or in float64 for a float64 ``raw`` (``tools/level_exact``'s exact
    sums): raw (R, S, 16) = rgb3 | seg12 | sigma1 -> (rgb_map (R, 16),
    weights (R, S))."""
    R, S, _ = raw.shape
    f32 = torch.promote_types(raw.dtype, torch.float32)
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


def nerf_raw_plain(pts: torch.Tensor, dirs: torch.Tensor,
                   table: torch.Tensor, rows: torch.Tensor,
                   weights: LevelWeights, compute_dtype: str, grid_dims,
                   acts: Optional[dict] = None,
                   se: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7's plain version. pts (P, 3 + ambient) packed [warped | ambient],
    P = R*S ray-major; dirs (R, 3) raw; table the corner table; rows (P,)
    its row per point (both None for the grid-free form, whose ``se`` has
    no columns, and for a given per-point ``se`` (P, C)). Returns raw
    (P, 16) [rgb3 | seg12 | sigma1].
    ``acts``, when given, receives what a backward needs: the PE ``x``, the
    cell geometry ``fs``/``ok``, the corner rows ``cf`` (with a grid),
    ``se``, the trunk activations, ``h``, ``feat``, the per-point
    ``dir_pe`` and the branch activations ``dacts``/``sacts``."""
    dtype = torch_dtype(compute_dtype)
    S = pts.shape[0] // dirs.shape[0]
    W = weights
    with torch.no_grad():
        x = kernel_pe(pts, W.pts_groups)
        fs = ok = cf = None
        if se is not None:
            se = se.to(torch.promote_types(se.dtype, torch.float32))
        else:
            se = pts.new_zeros((pts.shape[0], 0), dtype=torch.float32)
        if table is not None:
            _, fs, ok = _cell_geometry(pts, grid_dims)
            cf = table[rows.reshape(-1).long()].to(torch.float32)
            se = interp_corners(cf, fs, ok)
        dpe = kernel_pe(dirs, W.dir_groups)
        dir_head = mm(dpe, W.dir0_dir, dtype)
        raw = field_plain(
            W, x, lambda feat: (mm(feat, W.dir0_feat, dtype) + mm(se, W.dir0_se, dtype)
                                + (dir_head + W.dir0_b).repeat_interleave(S, dim=0)),
            dtype, acts)
        if acts is not None:
            acts.update(fs=fs, ok=ok, cf=cf, se=se,
                        dir_pe=dpe.repeat_interleave(S, dim=0))
        return raw


def field_plain(W: LevelWeights, x: torch.Tensor, dir0, dtype: torch.dtype,
                acts: Optional[dict] = None) -> torch.Tensor:
    """The NeRF MLP from the point PE ``x``: the trunk, feat and alpha, the
    direction branch whose first layer's pre-activation is ``dir0(feat)``,
    and the seg branch. Returns raw (P, 16) [rgb3 | seg12 | sigma1];
    ``acts``, when given, receives ``x``, the trunk activations, ``h``,
    ``feat`` and the branch activations ``dacts``/``sacts``."""
    tacts = [] if acts is not None else None
    h = trunk_forward(W.trunk, x, W.skip, leaky, dtype, acts=tacts)
    feat = mm(h, W.feat["w"], dtype) + W.feat["b"]
    alpha = mm(feat, W.alpha["w"], dtype) + W.alpha["b"]
    d = leaky(dir0(feat))
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
    if acts is not None:
        acts.update(x=x, trunk=tacts, h=h, feat=feat, dacts=dacts, sacts=sacts)
    return torch.cat([rgb, seg, alpha], dim=-1)


def nerf_level_plain(pts: torch.Tensor, dirs: torch.Tensor,
                     table: torch.Tensor, rows: torch.Tensor, z: torch.Tensor,
                     bg: Optional[torch.Tensor], noise: Optional[torch.Tensor],
                     weights: LevelWeights, compute_dtype: str, grid_dims,
                     se: Optional[torch.Tensor] = None):
    """K5's plain version: ``nerf_raw_plain``'s arguments plus z (R, S),
    bg (R, 15) | None and noise (R, S) | None (already scaled).
    Returns (rgb_map (R, 16), weights (R, S))."""
    R, S = z.shape
    raw = nerf_raw_plain(pts, dirs, table, rows, weights, compute_dtype,
                         grid_dims, se=se)
    with torch.no_grad():
        return composite_plain(raw.reshape(R, S, 16), z, dirs, bg, noise)


def _pe_freqs(groups, want: int, what: str) -> List[int]:
    if len(groups) != want or any(not g[3] or not g[4] for g in groups):
        raise ValueError(f"the K5 kernel takes {want} {what} PE group(s) with "
                         f"include_input and log sampling, got {groups}")
    return [g[2] for g in groups]


def level_kernel_args(pts: torch.Tensor, dirs: torch.Tensor,
                      table: torch.Tensor, rows: torch.Tensor,
                      weights: LevelWeights, compute_dtype: str, grid_dims,
                      what: str, se: Optional[torch.Tensor] = None):
    """The shape checks and integer arguments shared by the NeRF-level
    kernels (K5-K8): (R, S, PW, C, [n_trunk, hidden, branch, C, amb,
    nf_xyz, nf_amb, nf_dir, gD, gH, gW]). The grid-free form (``table``
    and ``rows`` None) has C = 0 and no grid dimensions; the form on a
    per-point ``se`` (P, C) has no table, rows or grid dimensions."""
    R = dirs.shape[0]
    P, PW = pts.shape
    nf_xyz, nf_amb = (_pe_freqs(weights.pts_groups, 2, "point") if PW > 3
                      else _pe_freqs(weights.pts_groups, 1, "point") + [0])
    (nf_dir,) = _pe_freqs(weights.dir_groups, 1, "direction")
    hidden = weights.trunk[0]["w"].shape[1]
    branch = weights.dir0_b.shape[0]
    if se is not None:
        C, (gD, gH, gW) = se.shape[-1], (0, 0, 0)
        grid_ok = table is None and rows is None and tuple(se.shape) == (P, C)
    elif table is None:
        C, (gD, gH, gW) = 0, (0, 0, 0)
        grid_ok = rows is None
    else:
        C, (gD, gH, gW) = table.shape[1] // 8, grid_dims
        grid_ok = (rows is not None and rows.numel() == P
                   and table.dtype == torch_dtype(compute_dtype)
                   and table.shape[0] == (gD + 1) * (gH + 1) * (gW + 1))
    if (R == 0 or P % R or PW > 8 or nf_dir > 4 or 2 * branch > hidden
            or not grid_ok or weights.dir0_se.shape[0] != C
            or tuple(dirs.shape) != (R, 3)):
        shape = lambda t: None if t is None else tuple(t.shape)
        raise ValueError(
            f"{what} shapes not supported: pts {tuple(pts.shape)}, rows "
            f"{shape(rows)}, dirs {tuple(dirs.shape)}, table {shape(table)}, "
            f"se {shape(se)} "
            f"for grid {grid_dims} and {weights.dir0_se.shape[0]} embedding "
            f"channels, dir freqs {nf_dir}, hidden {hidden}, branch {branch}")
    ints = [len(weights.trunk), hidden, branch, C, PW - 3, nf_xyz, nf_amb,
            nf_dir, gD, gH, gW]
    return R, P // R, PW, C, ints


def _grid_args(rows: Optional[torch.Tensor], table: Optional[torch.Tensor]):
    """The rows as contiguous int32 and the table contiguous, None (the
    grid-free form) passed through."""
    if table is None:
        return None, None
    return rows.reshape(-1).to(torch.int32).contiguous(), table.contiguous()


def widths_ok(hidden: int, branch: int, dtype: torch.dtype) -> bool:
    """The widths the per-tile kernels of csrc/level_train.cu take:
    multiples of 8 (float32) or of 16 (the tensor-core tiles' K step, bf16),
    at most 256 in bf16."""
    if dtype == torch.bfloat16:
        return hidden % 16 == 0 and branch % 16 == 0 and max(hidden, branch) <= 256
    return hidden % 8 == 0 and branch % 8 == 0


def check_device(what: str, dev, *tensors) -> None:
    """A kernel's tensors (None skipped) must all lie on the CUDA device
    ``dev``."""
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if any(t is not None and t.device != dev for t in tensors):
        raise ValueError(f"{what} inputs and weights must all be on {dev}")


def nerf_level_forward(pts: torch.Tensor, dirs: torch.Tensor,
                       table: torch.Tensor, rows: torch.Tensor,
                       z: torch.Tensor, bg: Optional[torch.Tensor],
                       noise: Optional[torch.Tensor], weights: LevelWeights,
                       compute_dtype: str = "bfloat16", grid_dims=(32, 32, 32),
                       se: Optional[torch.Tensor] = None):
    """K5 wrapper: a CUDA kernel for CUDA tensors (bf16: ``_nerf_level_tc``
    on the tensor cores; float32: the SIMT kernel), the plain version for
    CPU tensors. Same arguments and results as ``nerf_level_plain``. One
    call is one count, whatever the number of launches inside."""
    if pts.device.type == "cpu":
        return nerf_level_plain(pts, dirs, table, rows, z, bg, noise, weights,
                                compute_dtype, grid_dims, se)
    check_device("K5", pts.device)
    R, S, PW, C, ints = level_kernel_args(pts, dirs, table, rows, weights,
                                          compute_dtype, grid_dims, "K5", se)
    if (tuple(z.shape) != (R, S) or (bg is not None and tuple(bg.shape) != (R, 15))
            or (noise is not None and tuple(noise.shape) != (R, S))):
        raise ValueError(f"K5: z {tuple(z.shape)}, bg, noise must be ({R}, {S}), "
                         f"(R, 15), (R, S)")
    dtype = torch_dtype(compute_dtype)
    rows, table = _grid_args(rows, table)
    if dtype == torch.bfloat16:
        raw = torch.empty((R * S, 16), dtype=torch.float32, device=pts.device)
        out = _nerf_level_tc(pts, dirs, table, rows, z, bg, noise, weights, R, S, ints,
                             raw, se)
        nerf_level_forward.launches += 1
        return out
    wblob, bblob, meta = weights.blob(dtype)
    check_device("K5", pts.device, rows, table, dirs, se, z, bg, noise, wblob)
    f32 = torch.float32
    c = lambda t: None if t is None else t.to(f32).contiguous()
    pts, dirs, se, z, bg, noise = map(c, (pts, dirs, se, z, bg, noise))
    rgb_map = torch.empty((R, 16), dtype=f32, device=pts.device)
    w_out = torch.empty((R, S), dtype=f32, device=pts.device)
    fn = _build.function("nerf_level", "sahs_nerf_level_forward",
                         "p" * 13 + "l" + "i" * 13 + "p")
    p = _build.ptr
    rc = fn(p(pts), p(rows), p(table), p(dirs), p(se), p(z), p(bg),
            p(noise), p(wblob), p(bblob), p(meta), p(rgb_map), p(w_out),
            R, S, PW, *ints, _build.stream_ptr(pts.device))
    _build.check(rc, "nerf_level_forward")
    nerf_level_forward.launches += 1
    return rgb_map, w_out


nerf_level_forward.launches = 0


def _tc_blob(what: str, weights: LevelWeights, hidden: int, branch: int,
             dev, *tensors):
    """The bf16 forward blob of ``point_blob`` for the tensor-core field,
    after the checks of the widths and layers it takes and of the devices
    of ``tensors`` (None skipped)."""
    if (len(weights.dir_rest) != 3 or len(weights.seg) != 4
            or not widths_ok(hidden, branch, torch.bfloat16)):
        raise ValueError(f"{what} shapes not supported in bfloat16: "
                         f"{len(weights.dir_rest)} dir and {len(weights.seg)} seg "
                         f"layers, hidden {hidden}, branch {branch}")
    blob = point_blob(weights, torch.bfloat16)
    check_device(what, dev, *tensors, blob[0])
    return blob


def _nerf_level_tc(pts: torch.Tensor, dirs: torch.Tensor,
                   table: Optional[torch.Tensor], rows: Optional[torch.Tensor],
                   z: torch.Tensor, bg: Optional[torch.Tensor],
                   noise: Optional[torch.Tensor], weights: LevelWeights, R: int,
                   S: int, ints: Sequence[int], raw: torch.Tensor,
                   se: Optional[torch.Tensor] = None):
    """bf16 K5 on the tensor cores, one call of two launches
    (``csrc/level_train.cu:sahs_nerf_level_tc``): ``field_tc_kernel``'s raw
    field of the rays (K7's) into ``raw``, a contiguous float32 (R*S, 16)
    scratch, then ``composite_fwd_kernel``, the compositing per ray.
    ``rows`` int32 and ``table`` contiguous (``_grid_args``), or both None
    for C = 0 or for a per-point ``se`` (R*S, C); ``ints`` as
    ``level_kernel_args`` gives them. Returns (rgb_map (R, 16), weights
    (R, S))."""
    n_trunk, hidden, branch = ints[:3]
    wblob, bblob, meta = _tc_blob("K5", weights, hidden, branch, pts.device, dirs,
                                  table, rows, se, z, bg, noise, raw)
    wg = wgmma_blob(weights, wblob)
    f32 = torch.float32
    c = lambda t: None if t is None else t.to(f32).contiguous()
    pts, dirs, se, z, bg, noise = map(c, (pts, dirs, se, z, bg, noise))
    dev = pts.device
    rgb_map = torch.empty((R, 16), dtype=f32, device=dev)
    w_out = torch.empty((R, S), dtype=f32, device=dev)
    fn = _build.function("level_train", "sahs_nerf_level_tc",
                         "p" * 14 + "l" + "i" * 14 + "pl" + "p")
    p = _build.ptr
    rc = fn(p(pts), p(rows), p(table), p(dirs), p(se), p(z), p(bg), p(noise), p(wblob),
            p(bblob), p(meta), p(raw), p(rgb_map), p(w_out), R, S, pts.shape[1],
            n_trunk, weights.skip, *ints[1:11], p(wg), 2 * wg.numel(),
            _build.stream_ptr(dev))
    _build.check(rc, "nerf_level_forward")
    return rgb_map, w_out


def nerf_field_tc(what: str, pts: torch.Tensor, weights: LevelWeights,
                  R: int, S: int, ints: Sequence[int],
                  dirs: Optional[torch.Tensor] = None,
                  table: Optional[torch.Tensor] = None,
                  rows: Optional[torch.Tensor] = None,
                  extra: Optional[torch.Tensor] = None,
                  out: Optional[torch.Tensor] = None,
                  se: Optional[torch.Tensor] = None, enc: int = 0,
                  promote: int = -1) -> torch.Tensor:
    """One launch of the bf16 raw field on the tensor cores
    (``csrc/level_train.cu:field_tc_kernel``): K7 from ray inputs (``dirs``
    (R, 3), the corner ``table`` and ``rows``, or a per-point ``se``
    (R*S, C), or none of them for C = 0), or K11 from per-point ``extra``
    (P, 3 + C) with S = 1. ``enc`` (K11's pre-encoded form, bits of
    ``nerf_mlp.ENC_PTS`` / ``ENC_EXTRA``): ``pts`` is the point encoding,
    ``extra`` the [pe(dir) | se] encoding, each read in bf16. ``ints`` are
    [n_trunk, hidden, branch, C, amb, nf_xyz, nf_amb, nf_dir(, gD, gH,
    gW)] as ``level_kernel_args`` / ``point_kernel_args`` give them.
    Returns raw (R*S, 16) float32, written into ``out`` when given (a
    contiguous float32 (R*S, 16) tensor, e.g. a view of a larger buffer).
    ``promote`` picks the kernel's accumulation form: -1 the one the port
    runs (``FIELD_PROMOTE``), or a candidate the measurements compare (0: the
    sum carried in the tensor core over the whole K; 1, 2, 4: that many k16
    steps summed there before each float32 add)."""
    n_trunk, hidden, branch, C, amb, nf_xyz, nf_amb, nf_dir = ints[:8]
    gD, gH, gW = list(ints[8:11]) or [0, 0, 0]
    P = R * S
    if out is not None and (tuple(out.shape) != (P, 16) or out.dtype != torch.float32
                            or not out.is_contiguous()):
        raise ValueError(f"{what}: out must be a contiguous float32 ({P}, 16) tensor")
    wblob, bblob, meta = _tc_blob(what, weights, hidden, branch, pts.device, dirs,
                                  table, rows, extra, se, out)
    f32, bf16 = torch.float32, torch.bfloat16
    c = lambda t, dt=f32: None if t is None else t.to(dt).contiguous()
    pts, extra = c(pts, bf16 if enc & 1 else f32), c(extra, bf16 if enc & 2 else f32)
    dirs, se = c(dirs), c(se)
    raw = torch.empty((P, 16), dtype=f32, device=pts.device) if out is None else out
    wg = wgmma_blob(weights, wblob)
    fn = _build.function("level_train", "sahs_nerf_field_tc",
                         "p" * 10 + "l" + "i" * 15 + "pli" + "p")
    p = _build.ptr
    rc = fn(p(pts), p(rows), p(table), p(dirs), p(extra), p(se), p(wblob), p(bblob),
            p(meta), p(raw), R, S, pts.shape[1], n_trunk, weights.skip, hidden, branch,
            C, amb, nf_xyz, nf_amb, nf_dir, gD, gH, gW, enc, p(wg), 2 * wg.numel(),
            promote, _build.stream_ptr(pts.device))
    _build.check(rc, what)
    return raw


def nerf_rayd_forward(pts: torch.Tensor, dirs: torch.Tensor,
                      table: torch.Tensor, rows: torch.Tensor,
                      weights: LevelWeights, compute_dtype: str = "bfloat16",
                      grid_dims=(32, 32, 32),
                      se: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7 wrapper: a CUDA kernel for CUDA tensors (bf16: ``nerf_field_tc``
    on the tensor cores; float32: the SIMT kernel), the plain version for
    CPU tensors. Same arguments and result as ``nerf_raw_plain``."""
    if pts.device.type == "cpu":
        return nerf_raw_plain(pts, dirs, table, rows, weights, compute_dtype,
                              grid_dims, se=se)
    check_device("K7", pts.device)
    R, S, PW, C, ints = level_kernel_args(pts, dirs, table, rows, weights,
                                          compute_dtype, grid_dims, "K7", se)
    dtype = torch_dtype(compute_dtype)
    if dtype == torch.bfloat16:
        rows, table = _grid_args(rows, table)
        raw = nerf_field_tc("K7", pts, weights, R, S, ints, dirs=dirs,
                            table=table, rows=rows, se=se)
        nerf_rayd_forward.launches += 1
        return raw
    wblob, bblob, meta = weights.blob(dtype)
    check_device("K7", pts.device, rows, table, dirs, se, wblob)
    f32 = torch.float32
    pts = pts.to(f32).contiguous()
    dirs = dirs.to(f32).contiguous()
    se = None if se is None else se.to(f32).contiguous()
    rows, table = _grid_args(rows, table)
    raw = torch.empty((R * S, 16), dtype=f32, device=pts.device)
    fn = _build.function("nerf_level", "sahs_nerf_rayd_forward",
                         "p" * 9 + "l" + "i" * 13 + "p")
    p = _build.ptr
    rc = fn(p(pts), p(rows), p(table), p(dirs), p(se), p(wblob),
            p(bblob), p(meta), p(raw), R, S, PW, *ints,
            _build.stream_ptr(pts.device))
    _build.check(rc, "nerf_rayd_forward")
    nerf_rayd_forward.launches += 1
    return raw


nerf_rayd_forward.launches = 0
