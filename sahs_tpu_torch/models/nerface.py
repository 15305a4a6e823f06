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
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn as nn

from ..config import Config
from ..ops.encoding import encoded_dim, get_embedding_function
from ..ops.grid import grid_sample_3d
from ..ops.rays import pose_to_euler_trans
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
    plain path's raw field (None on the kernel path);
    level_fn(level, pts_flat, dirs_ray, samples, z (R,S), bg (R,15)|None,
    noise (R,S)|None) -> (rgb_map (R,16), weights (R,S)): K1 -> K5, the
    kernel path (None on the plain path)."""
    field_fn: Optional[Callable]
    level_fn: Optional[Callable]


def kernel_path_ok(spec: ModelSpec, latent_code=None) -> bool:
    """The configurations the ported kernels cover: the deformation pair
    (K1) and the grid-coupled fused level (K5). Others need kernels that
    are still to be ported (ROADMAP Queue 2)."""
    return (spec.use_viewdirs and pair_kernel_ok(spec)
            and spec.use_spatial_embeddings and latent_code is None)


def make_render_fns(model: NeRFaceModel, driving_or_audio: torch.Tensor,
                    pose: torch.Tensor, latent_code=None,
                    use_pallas: bool = False,
                    compute_dtype: str = "bfloat16") -> RenderFns:
    """Build the per-frame field evaluators (nerface.py:269-487).

    use_pallas=False: the plain path, the reference math in tensor ops.
    use_pallas=True: the kernel path. Per-frame conditioning is folded
    into biases and the grid packed into its corner table once per frame;
    each level runs K1 (warp + hyper, emitting corner-table rows) and then
    K5 (corner gather + NeRF MLP + spatial embedding + compositing). A configuration outside ``kernel_path_ok`` raises rather
    than fall back."""
    from ..ops.kernels.deform_pair import deform_pair_forward, prepare_pair
    from ..ops.kernels.field_grid import corner_table
    from ..ops.kernels.nerf_level import nerf_level_forward, prepare_level

    spec = model.spec
    with torch.no_grad():
        driving = compute_driving(model, driving_or_audio)
        pose_enc = encode_pose(pose)

    if not use_pallas:
        def field_fn(level, pts_flat, dirs_ray, samples):
            dirs_flat = None
            if dirs_ray is not None:
                dirs_flat = dirs_ray[:, None, :].expand(
                    dirs_ray.shape[0], samples, dirs_ray.shape[-1]
                ).reshape(-1, dirs_ray.shape[-1])
            with torch.no_grad():
                mapped = map_points(model, pts_flat, driving, pose_enc)
                se = None
                if spec.use_spatial_embeddings:
                    se = grid_sample_3d(model.spatial_embeddings, mapped[..., :3])
                return query_template(model, level, mapped, dirs_flat, driving,
                                      pose_enc, latent_code, se)
        return RenderFns(field_fn, None)

    if not kernel_path_ok(spec, latent_code):
        raise NotImplementedError(
            "the kernel path covers the deformation pair + grid-coupled "
            "level configuration only; this model needs kernels still to "
            "be ported (see ROADMAP Queue 2)")
    warp_pe, pts_pe, dir_pe = build_pe_groups(spec)
    cond = torch.cat([driving, pose_enc]) if spec.warp.include_driving else pose_enc
    pair = prepare_pair(model.warp, model.hyper, cond, warp_pe)
    levels = {}
    grid = model.spatial_embeddings.detach()
    dims = tuple(grid.shape[1:])
    table = corner_table(grid, compute_dtype)

    def nerf_cond(level):
        nspec: NeRFSpec = getattr(spec, level)
        parts = []
        if nspec.include_driving:
            parts.append(driving)
        if nspec.use_pose:
            parts.append(pose_enc)
        return torch.cat(parts) if parts else pose_enc[:0]

    def level_fn(level, pts_flat, dirs_ray, samples, z, bg, noise):
        if level not in levels:
            levels[level] = prepare_level(getattr(model, level),
                                          nerf_cond(level), pts_pe, dir_pe)
        packed, rows = deform_pair_forward(pts_flat, pair, compute_dtype,
                                           samples, dims)
        return nerf_level_forward(packed, dirs_ray, table, rows, z, bg, noise,
                                  levels[level], compute_dtype, dims)

    return RenderFns(None, level_fn)
