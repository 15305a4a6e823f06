"""Top-level deformable-NeRF model (counterpart of
``sahs_tpu/models/nerface.py``).

    x_obs --PE--> WarpField  --> dx          (reference models.py:301-306)
    x_obs --PE--> HyperSheet --> ambient w   (models.py:308-316)
    canonical hyper point = (x_obs + dx, w)  (models.py:318-329)
    spatial_embedding = trilerp(grid, x + dx) (models.py:346-365)
    raw = NeRFMLP(PE(x + dx) + PE(w) [+ driving][+ pose], PE(dir), se)

Driving is the 76-d expression vector (NeRFace) or AudioNet(window)
(AudioFace, models.py:507-528).
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn as nn

from ..config import Config
from ..ops.encoding import encoded_dim, get_embedding_function
from ..ops.grid import grid_sample_3d
from ..ops.rays import pose_to_euler_trans
from ..utils import profiling
from ..utils.device import resolve_device
from . import fields
from .fields import (AudioNet, HyperSheet, HyperSpec, NeRFMLP, NeRFSpec,
                     WarpField, WarpSpec)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static description of the full model (declared again here because
    the JAX package's module imports jax)."""
    kind: str                       # "NeRFaceModel" | "AudioFaceModel"
    use_warp: bool
    use_ambient: bool
    use_spatial_embeddings: bool
    use_viewdirs: bool
    warp: Optional[WarpSpec]
    hyper: Optional[HyperSpec]
    coarse: NeRFSpec
    fine: Optional[NeRFSpec]
    num_encoding_fn_xyz: int
    include_input_xyz: bool
    log_sampling_xyz: bool
    num_encoding_fn_dir: int
    include_input_dir: bool
    log_sampling_dir: bool
    num_encoding_fn_ambient: int
    include_input_ambient: bool
    log_sampling_ambient: bool
    warp_num_encoding_fn_xyz: int

    @classmethod
    def from_config(cls, cfg: Config) -> "ModelSpec":
        m = cfg.models
        warp = WarpSpec.from_config(m.warp) if m.warp.use_warp else None
        hyper = HyperSpec.from_config(m.hyper) if m.hyper.use_ambient else None
        lcd = getattr(m.mask, "latent_code_dim", 0)
        coarse = NeRFSpec.from_config(m.coarse, m.hyper, latent_code_dim=lcd)
        # The reference builds the fine MLP with the coarse width/depth and
        # pose/spatial flags (models.py:278-296).
        fine = None
        if m.fine is not None:
            fine_cfg = copy.deepcopy(m.fine)
            fine_cfg.num_layers = m.coarse.num_layers
            fine_cfg.hidden_size = m.coarse.hidden_size
            fine_cfg.use_pose = m.coarse.use_pose
            fine_cfg.include_pose = m.coarse.include_pose
            fine_cfg.use_spatial_embeddings = m.coarse.use_spatial_embeddings
            fine = NeRFSpec.from_config(fine_cfg, m.hyper, latent_code_dim=lcd)
        return cls(
            kind=m.mask.type, use_warp=m.warp.use_warp,
            use_ambient=m.hyper.use_ambient,
            use_spatial_embeddings=m.coarse.use_spatial_embeddings,
            use_viewdirs=m.coarse.use_viewdirs, warp=warp, hyper=hyper,
            coarse=coarse, fine=fine,
            num_encoding_fn_xyz=m.coarse.num_encoding_fn_xyz,
            include_input_xyz=m.coarse.include_input_xyz,
            log_sampling_xyz=m.coarse.log_sampling_xyz,
            num_encoding_fn_dir=m.coarse.num_encoding_fn_dir,
            include_input_dir=m.coarse.include_input_dir,
            log_sampling_dir=m.coarse.log_sampling_dir,
            num_encoding_fn_ambient=m.hyper.num_encoding_fn_ambient,
            include_input_ambient=m.hyper.include_input_ambient,
            log_sampling_ambient=m.hyper.log_sampling_ambient,
            warp_num_encoding_fn_xyz=m.warp.num_encoding_fn_xyz,
        )

    @property
    def is_audio(self) -> bool:
        return self.kind in ("AudioFaceModel", "AudioMaskGenerator")


class NeRFaceModel(nn.Module):
    """All parameters of the model, named as the JAX parameter tree:
    ``warp``, ``hyper``, ``coarse``, ``fine``, ``spatial_embeddings`` and
    ``audnet`` (init_model_params, nerface.py:110-124)."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        with profiling.phase("setup.model"):
            self.spec = spec
            self.warp = WarpField(spec.warp) if spec.use_warp else None
            self.hyper = HyperSheet(spec.hyper) if spec.use_ambient else None
            self.coarse = NeRFMLP(spec.coarse)
            self.fine = NeRFMLP(spec.fine) if spec.fine is not None else None
            self.spatial_embeddings = (
                nn.Parameter(torch.empty(fields.SPATIAL_EMBEDDING_DIM,
                                         fields.SPATIAL_GRID_RES,
                                         fields.SPATIAL_GRID_RES,
                                         fields.SPATIAL_GRID_RES))
                if spec.use_spatial_embeddings else None)
            self.audnet = AudioNet() if spec.is_audio else None

    @classmethod
    def init(cls, spec: ModelSpec, seed: int = 0,
             device=None) -> "NeRFaceModel":
        """Seeded random weights on ``device`` (CUDA unless the caller names
        another; with no device given and no CUDA present this raises).
        They are drawn on the CPU from one ``torch.Generator``, so every
        device gets the same values."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        model = cls(spec)
        fields.init_uniform_(model, gen)
        if model.spatial_embeddings is not None:
            with torch.no_grad():
                model.spatial_embeddings.copy_(fields.spatial_grid(gen))
        return model.to(dev)


# ---------------------------------------------------------------------------
# Application
# ---------------------------------------------------------------------------

def encode_pose(pose: torch.Tensor) -> torch.Tensor:
    """(3,4) c2w pose -> (36,) PE of the 6-dof euler + trans
    (reference models.py:371-372, 519-520)."""
    pe = get_embedding_function(3, include_input=False, log_sampling=True)
    return pe(pose_to_euler_trans(pose[None]))[0]


def compute_driving(model: NeRFaceModel, driving_or_audio: torch.Tensor
                    ) -> torch.Tensor:
    """AudioFace: AudioNet on the (16, 29) window; NeRFace: identity."""
    if model.spec.is_audio:
        return model.audnet(driving_or_audio)
    return driving_or_audio


def map_points(model: NeRFaceModel, points: torch.Tensor,
               driving: torch.Tensor, pose_enc: torch.Tensor) -> torch.Tensor:
    """(P, 3) observation points -> (P, 3 [+ ambient]) canonical hyper
    points (reference models.py:301-329)."""
    spec = model.spec
    pe_x = get_embedding_function(spec.warp_num_encoding_fn_xyz,
                                  include_input=True, log_sampling=True)(points)
    spatial = points
    if spec.use_warp:
        spatial = points + model.warp(pe_x, driving, pose_enc)
    if spec.use_ambient:
        return torch.cat([spatial, model.hyper(pe_x, driving, pose_enc)], dim=-1)
    return spatial


def query_template(model: NeRFaceModel, level: str, mapped: torch.Tensor,
                   viewdirs: Optional[torch.Tensor], driving: torch.Tensor,
                   pose_enc: torch.Tensor, latent_code: Optional[torch.Tensor],
                   spatial_embedding: Optional[torch.Tensor]) -> torch.Tensor:
    """Canonical-field query (reference models.py:331-344)."""
    spec = model.spec
    net: NeRFMLP = getattr(model, level)
    points_embed = get_embedding_function(
        spec.num_encoding_fn_xyz, spec.include_input_xyz,
        spec.log_sampling_xyz)(mapped[..., :3])
    if mapped.shape[-1] > 3:
        pe_amb = get_embedding_function(spec.num_encoding_fn_ambient,
                                        spec.include_input_ambient,
                                        spec.log_sampling_ambient)
        points_embed = torch.cat([points_embed, pe_amb(mapped[..., 3:])], dim=-1)
    dirs_embed = None
    if spec.use_viewdirs:
        dirs_embed = get_embedding_function(
            spec.num_encoding_fn_dir, spec.include_input_dir,
            spec.log_sampling_dir)(viewdirs)
    return net(points_embed, dirs_embed, driving=driving,
               pose=pose_enc if net.spec.use_pose else None,
               latent_code=latent_code, spatial_embedding=spatial_embedding)


def pair_kernel_ok(spec: ModelSpec) -> bool:
    """One kernel for both deformation MLPs when they take the same
    conditioning: always true for the reference nets."""
    return (spec.use_warp and spec.use_ambient
            and spec.warp.include_driving == spec.hyper.include_driving)


def build_pe_groups(spec: ModelSpec):
    """In-kernel PE groups (src_col, dim, num_freq, include_input,
    log_sampling): (warp_pe, pts_pe, dir_pe), as nerface.py:209-244."""
    warp_pe = ((0, 3, spec.warp_num_encoding_fn_xyz, True, True),)
    pts_pe = [(0, 3, spec.num_encoding_fn_xyz, spec.include_input_xyz,
               spec.log_sampling_xyz)]
    if spec.use_ambient:
        pts_pe.append((3, spec.hyper.ambient_coord_dim,
                       spec.num_encoding_fn_ambient,
                       spec.include_input_ambient, spec.log_sampling_ambient))
    dir_pe = ((0, 3, spec.num_encoding_fn_dir, spec.include_input_dir,
               spec.log_sampling_dir),)
    return warp_pe, tuple(pts_pe), dir_pe


class RenderFns(NamedTuple):
    """Field evaluators built by make_render_fns.

    field_fn(level, pts_flat (P,3), dirs_ray (R,3), samples) -> (P,16): the
    raw field (the plain path's, or on the kernel path front_fn then
    nerf_fn);
    level_fn(level, pts_flat, dirs_ray, samples, z (R,S), bg (R,15)|None,
    noise (R,S)|None) -> (rgb_map (R,16), weights (R,S)): the deformation
    front half, then K5 (K6 in the backward), the kernel path's level with
    compositing (None on the plain path);
    front_fn(pts_flat, samples) -> (pts_raw (P, 3 [+ ambient]), rows
    (P // samples, samples) | None without a grid): the level-independent
    front half, which the pipeline reuses at the fine level (None on the
    plain path);
    nerf_fn(level, (pts_raw, rows), dirs_ray, samples) -> (P, 16): the NeRF
    back half on a front half, K7 (K8 in the backward), or for a sample
    count the level kernels do not take the per-point branch: the grid
    sample, then K11 (K12 and K10 in the backward) (None on the plain
    path);
    folded: the FoldedCache the evaluators fold their weights into (None
    on the plain path)."""
    field_fn: Optional[Callable]
    level_fn: Optional[Callable]
    front_fn: Optional[Callable] = None
    nerf_fn: Optional[Callable] = None
    folded: Optional["FoldedCache"] = None


# The sample counts the level kernels (K5-K8) take on the JAX package's
# path: those whose rays tile its 1024-point tiles (nerface.py:194-198).
# Other counts take the per-point branch (K11, K12, K10), as in JAX, though
# the CUDA level kernels would take any count.
LEVEL_TILE = 1024


def level_kernel_compatible(samples: int) -> bool:
    """True when the level kernels take this sample count."""
    return bool(samples) and LEVEL_TILE % samples == 0


class FoldedCache:
    """Per-frame folded weights and tables, each rebuilt once one of its
    source parameters has changed in place: an optimizer step bumps a
    parameter's version counter, so a cached blob never outlives it. A
    build runs in the span ``serve.fold``, counts ``fold.built`` and adds
    its host seconds to ``seconds``; a hit counts ``fold.reused``."""

    def __init__(self):
        self._items = {}
        self.seconds = 0.0

    def get(self, key, sources, build):
        version = tuple(p._version for p in sources)
        hit = self._items.get(key)
        if hit is None or hit[0] != version:
            profiling.count("fold.built")
            t0 = time.perf_counter()
            with torch.no_grad(), profiling.span("serve.fold"):
                hit = self._items[key] = (version, build())
            self.seconds += time.perf_counter() - t0
        else:
            profiling.count("fold.reused")
        return hit[1]


def make_render_fns(model: NeRFaceModel, driving_or_audio: torch.Tensor,
                    pose: torch.Tensor, latent_code=None,
                    use_pallas: bool = False,
                    compute_dtype: str = "bfloat16") -> RenderFns:
    """Build the per-frame field evaluators (nerface.py:269-487). Under
    autograd (the train step's fallback) every evaluator is
    differentiable with respect to the model's parameters, the driving
    input (through AudioNet) and the latent code.

    use_pallas=False: the plain path, the reference math in tensor ops; its
    grid sample's backward is K10 in float32.
    use_pallas=True: the kernel path. Per-frame conditioning ([latent |
    driving | pose] as the level takes them) is folded into biases and the
    grid packed into its corner table, once per frame and again after any
    in-place change of their parameters. The front half is the deformation
    pair (K1, K3 in the backward), emitting corner-table rows; or, for a
    model whose two nets cannot share K1 (warp-only, ambient-only, or
    conditioned apart), each net on its own (K13, K14 in the backward),
    x + dx added in PyTorch, the rows from ``_cell_geometry`` of the warped
    points; or, for a model without deformation, the points themselves
    with their rows. The back half is K5 (K6) with compositing, or K7 (K8)
    for the raw field; dGrid is K9. A sample count the level kernels do not
    take runs the per-point branch instead: the grid sample (K10 in the
    backward), then K11 (K12). A model without the grid takes the same
    kernels in their grid-free form (nerface.py:413-485): no corner table,
    no rows, no dGrid, and the per-point branch's extra input is the
    direction alone. A model without view directions takes the plain path,
    as the JAX package does (nerface.py:299-314)."""
    from ..ops.grid import _cell_geometry
    from ..ops.kernels.deform_pair import (PairOp, deform_pair_apply_fused,
                                           prepare_pair)
    from ..ops.kernels.field_grid import (GridLevelOp, PointOp, corner_table,
                                          nerf_mlp_apply_fused,
                                          nerf_mlp_apply_rayd_grid,
                                          nerf_render_level_grid)
    from ..ops.kernels.nerf_level import prepare_level
    from ..ops.kernels.skip_mlp import (SkipOp, deform_mlp_apply_fused,
                                        prepare_skip)

    spec = model.spec
    driving = compute_driving(model, driving_or_audio)
    pose_enc = encode_pose(pose)

    if not (use_pallas and spec.use_viewdirs):
        def field_fn(level, pts_flat, dirs_ray, samples):
            dirs_flat = None
            if dirs_ray is not None:
                dirs_flat = dirs_ray[:, None, :].expand(
                    dirs_ray.shape[0], samples, dirs_ray.shape[-1]
                ).reshape(-1, dirs_ray.shape[-1])
            mapped = map_points(model, pts_flat, driving, pose_enc)
            se = None
            if spec.use_spatial_embeddings:
                se = grid_sample_3d(model.spatial_embeddings, mapped[..., :3])
            return query_template(model, level, mapped, dirs_flat, driving,
                                  pose_enc, latent_code, se)
        return RenderFns(field_fn, None)

    warp_pe, pts_pe, dir_pe = build_pe_groups(spec)
    grid = model.spatial_embeddings            # None: the grid-free forms
    dims = None if grid is None else tuple(grid.shape[1:])
    folded = FoldedCache()
    pair_ok = pair_kernel_ok(spec)

    def deform_cond(sub):
        return torch.cat([driving, pose_enc]) if sub.include_driving else pose_enc

    def deform_net(name, act, pts_flat):
        # one net on its own, its own conditioning and head activation
        # (nerface.py:333-338, 380-398)
        net = getattr(model, name)
        params = list(net.parameters())
        cond = deform_cond(net.spec)
        weights = folded.get(name, params,
                             lambda: prepare_skip(net, cond, warp_pe, act))
        return deform_mlp_apply_fused(
            SkipOp(net, params, weights, pts_flat, compute_dtype), cond)

    def front_half(pts_flat, samples):
        if pair_ok:
            nets = (model.warp, model.hyper)
            params = [p for n in nets for p in n.parameters()]
            cond = deform_cond(spec.warp)
            pair = folded.get("pair", params,
                              lambda: prepare_pair(*nets, cond, warp_pe))
            return deform_pair_apply_fused(
                PairOp(*nets, params, pair, pts_flat, samples, dims,
                       compute_dtype), cond)
        warped = pts_flat
        if spec.use_warp:
            warped = pts_flat + deform_net("warp", "tanh", pts_flat)
        rows = None
        if grid is not None:
            rows = _cell_geometry(warped.detach(), dims)[0]
            rows = rows.to(torch.int32).reshape(-1, samples)
        pts_raw = warped
        if spec.use_ambient:
            amb = deform_net("hyper", "linear", pts_flat)
            pts_raw = torch.cat([warped, amb], dim=-1)
        return pts_raw, rows

    def nerf_cond(level):
        nspec: NeRFSpec = getattr(spec, level)
        parts = []
        if latent_code is not None and nspec.latent_code_dim > 0:
            parts.append(latent_code)
        if nspec.include_driving:
            parts.append(driving)
        if nspec.use_pose:
            parts.append(pose_enc)
        return torch.cat(parts) if parts else pose_enc[:0]

    def level_weights(level):
        nerf = getattr(model, level)
        params = list(nerf.parameters())
        cond = nerf_cond(level)
        weights = folded.get(level, params,
                             lambda: prepare_level(nerf, cond, pts_pe, dir_pe))
        return nerf, params, weights, cond

    def grid_op(level, rows, dirs_ray, samples, z=None, noise=None):
        nerf, params, weights, cond = level_weights(level)
        table = None
        if grid is not None:
            table = folded.get("table", [grid],
                               lambda: corner_table(grid, compute_dtype))
        return GridLevelOp(nerf, params, weights, table, rows, dirs_ray,
                           samples, compute_dtype,
                           None if grid is None else tuple(grid.shape), z,
                           noise), cond

    def nerf_fn(level, fh, dirs_ray, samples):
        pts_raw, rows = fh
        if level_kernel_compatible(samples):
            op, cond = grid_op(level, rows, dirs_ray, samples)
            return nerf_mlp_apply_rayd_grid(op, grid, pts_raw, cond)
        # the per-point branch (nerface.py:442-460): the grid sample (K10 in
        # its backward), then K11 on [dir | se] per point (K12 backward);
        # without a grid the extra input is the direction alone
        nerf, params, weights, cond = level_weights(level)
        extra = dirs_ray[:, None, :].expand(
            dirs_ray.shape[0], samples, 3).reshape(-1, 3)
        if grid is not None:
            extra = torch.cat([extra, grid_sample_3d(grid, pts_raw, compute_dtype)],
                              dim=-1)
        return nerf_mlp_apply_fused(PointOp(nerf, params, weights, compute_dtype),
                                    pts_raw, extra, cond)

    def level_fn(level, pts_flat, dirs_ray, samples, z, bg, noise):
        pts_raw, rows = front_half(pts_flat, samples)
        op, cond = grid_op(level, rows, dirs_ray, samples, z, noise)
        return nerf_render_level_grid(op, grid, pts_raw, bg, cond)

    def field_fn(level, pts_flat, dirs_ray, samples):
        return nerf_fn(level, front_half(pts_flat, samples), dirs_ray, samples)

    return RenderFns(field_fn, level_fn, front_half, nerf_fn, folded)


def make_field_fn(model: NeRFaceModel, driving_or_audio: torch.Tensor,
                  pose: torch.Tensor, latent_code=None, use_pallas: bool = False,
                  compute_dtype: str = "bfloat16"):
    """``make_render_fns``' field_fn alone (nerface.py:490-497):
    field_fn(level, pts_flat (P, 3), dirs_ray (R, 3), samples) -> (P, 16),
    on the kernel path with ``use_pallas``."""
    return make_render_fns(model, driving_or_audio, pose, latent_code=latent_code,
                           use_pallas=use_pallas, compute_dtype=compute_dtype)[0]


def apply_field(model: NeRFaceModel, level: str, points: torch.Tensor,
                viewdirs: Optional[torch.Tensor], driving_or_audio: torch.Tensor,
                pose: torch.Tensor,
                latent_code: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-point field in plain tensor math, the kernel path's oracle
    (nerface.py:500-517): (P, 3) points and (P, 3) raw view directions ->
    (P, 16) raw field. ``pose`` is the (3, 4) camera pose, encoded once a
    call: map_points, then the grid sample at the warped points, then the
    level's query."""
    driving = compute_driving(model, driving_or_audio)
    pose_enc = encode_pose(pose)
    mapped = map_points(model, points, driving, pose_enc)
    se = None
    if model.spec.use_spatial_embeddings:
        se = grid_sample_3d(model.spatial_embeddings, mapped[..., :3])
    return query_template(model, level, mapped, viewdirs, driving, pose_enc,
                          latent_code, se)
