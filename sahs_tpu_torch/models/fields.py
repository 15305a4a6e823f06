"""Field networks as ``nn.Module``s (counterpart of ``sahs_tpu/models/fields.py``).

Architectural parity targets in the reference:
  - NeRFMLP        nerf-pytorch/nerf/modules.py:168-295
  - WarpFieldMLP   nerf-pytorch/nerf/modules.py:323-398
  - HyperSheetMLP  nerf-pytorch/nerf/modules.py:401-462
  - AudioNet       nerf-pytorch/nerf/modules.py:43-73

Module and parameter names follow the JAX parameter tree (``trunk``,
``out``, ``fc_feat``, ``dir``, ...), so ``utils/weights.params_from_jax``
maps one onto the other by name. ``nn.Linear.weight`` is (out, in), the
transpose of the JAX layout. Layers are created without drawing random
numbers; ``init_uniform_`` then draws every value from an explicit
``torch.Generator`` with the JAX package's scheme (U(-1/sqrt(fan_in),
1/sqrt(fan_in)) for weights and biases).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn

from ..config import HyperConfig, NeRFMLPConfig, WarpConfig
from ..ops.encoding import encoded_dim

DRIVING_DIM = 76
POSE_PE_DIM = 36  # 6-dof pose, 3 freqs, no input passthrough (models.py:203-207)
SEG_CLASSES = 12
SPATIAL_EMBEDDING_DIM = 32
SPATIAL_GRID_RES = 32


def linear(fan_in: int, fan_out: int) -> nn.Linear:
    """An ``nn.Linear`` with uninitialised storage (no random draw)."""
    return torch.nn.utils.skip_init(nn.Linear, fan_in, fan_out)


def init_uniform_(module: nn.Module, generator: torch.Generator) -> None:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every Linear/Conv1d weight and
    bias, drawn in module order from ``generator``."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            with torch.no_grad():
                for p in (m.weight, m.bias):
                    p.copy_(torch.rand(p.shape, generator=generator,
                                       dtype=p.dtype) * (2 * bound) - bound)


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


class SkipTrunk(nn.Module):
    """Layer ``skip_every`` re-concatenates the trunk input
    (reference modules.py:268-273 / :382-387)."""

    def __init__(self, input_dim: int, hidden: int, num_layers: int,
                 skip_every: int):
        super().__init__()
        self.skip_every = skip_every
        self.layers = nn.ModuleList(
            [linear(input_dim, hidden)]
            + [linear(input_dim + hidden if i == skip_every else hidden, hidden)
               for i in range(1, num_layers)])

    def forward(self, x0: torch.Tensor, act) -> torch.Tensor:
        x = x0
        for i, lin in enumerate(self.layers):
            if i == self.skip_every:
                x = lin(torch.cat([x, x0], dim=-1))
            else:
                x = lin(x)
            x = act(x)
        return x


# ---------------------------------------------------------------------------
# Static specs (same fields as the JAX package's)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WarpSpec:
    num_layers: int
    hidden_size: int
    skip_connect_every: int
    pe_xyz_dim: int
    include_driving: bool
    include_pose_input: bool

    @property
    def input_dim(self) -> int:
        # the PE'd pose is concatenated unconditionally (modules.py:345-358)
        d = self.pe_xyz_dim + POSE_PE_DIM + (6 if self.include_pose_input else 0)
        if self.include_driving:
            d += DRIVING_DIM
        return d

    @classmethod
    def from_config(cls, cfg: WarpConfig) -> "WarpSpec":
        return cls(num_layers=cfg.num_layers, hidden_size=cfg.hidden_size,
                   skip_connect_every=cfg.skip_connect_every,
                   pe_xyz_dim=encoded_dim(3, cfg.num_encoding_fn_xyz,
                                          cfg.include_input_xyz),
                   include_driving=cfg.include_driving,
                   include_pose_input=False)


@dataclasses.dataclass(frozen=True)
class HyperSpec:
    num_layers: int
    hidden_size: int
    skip_connect_every: int
    pe_xyz_dim: int
    include_driving: bool
    ambient_coord_dim: int

    @property
    def input_dim(self) -> int:
        d = self.pe_xyz_dim + POSE_PE_DIM
        if self.include_driving:
            d += DRIVING_DIM
        return d

    @classmethod
    def from_config(cls, cfg: HyperConfig) -> "HyperSpec":
        return cls(num_layers=cfg.num_layers, hidden_size=cfg.hidden_size,
                   skip_connect_every=cfg.skip_connect_every,
                   pe_xyz_dim=encoded_dim(3, cfg.num_encoding_fn_xyz,
                                          cfg.include_input_xyz),
                   include_driving=cfg.include_driving,
                   ambient_coord_dim=cfg.ambient_coord_dim)


@dataclasses.dataclass(frozen=True)
class NeRFSpec:
    num_layers: int
    hidden_size: int
    skip_connect_every: int
    pe_xyz_dim: int
    pe_dir_dim: int
    ambient_pe_dim: int       # 0 when use_ambient is False
    use_viewdirs: bool
    use_pose: bool
    include_pose_input: bool
    use_spatial_embeddings: bool
    include_driving: bool
    latent_code_dim: int

    @property
    def trunk_input_dim(self) -> int:
        d = self.pe_xyz_dim + self.ambient_pe_dim
        if self.use_pose:
            d += POSE_PE_DIM + (6 if self.include_pose_input else 0)
        d += self.latent_code_dim
        if self.include_driving:
            d += DRIVING_DIM
        return d

    @property
    def dir_input_dim(self) -> int:
        d = self.hidden_size
        if self.use_viewdirs:
            d += self.pe_dir_dim
            if self.use_spatial_embeddings:
                d += SPATIAL_EMBEDDING_DIM
        return d

    @classmethod
    def from_config(cls, cfg: NeRFMLPConfig, hyper: HyperConfig,
                    latent_code_dim: int = 0) -> "NeRFSpec":
        ambient_pe = 0
        if hyper.use_ambient:
            ambient_pe = encoded_dim(hyper.ambient_coord_dim,
                                     hyper.num_encoding_fn_ambient,
                                     hyper.include_input_ambient)
        return cls(
            num_layers=cfg.num_layers,
            hidden_size=cfg.hidden_size,
            # Reference quirk: NeRFMLP never receives skip_connect_every
            # (models.py:258-297), so its constructor default 3 wins over
            # the config (modules.py:176). Warp/hyper do receive it.
            skip_connect_every=3,
            pe_xyz_dim=encoded_dim(3, cfg.num_encoding_fn_xyz, cfg.include_input_xyz),
            pe_dir_dim=encoded_dim(3, cfg.num_encoding_fn_dir, cfg.include_input_dir),
            ambient_pe_dim=ambient_pe,
            use_viewdirs=cfg.use_viewdirs,
            use_pose=cfg.use_pose,
            include_pose_input=cfg.include_pose,
            use_spatial_embeddings=cfg.use_spatial_embeddings,
            include_driving=cfg.include_driving,
            latent_code_dim=latent_code_dim,
        )


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class WarpField(nn.Module):
    """6x128 ReLU trunk (skip at the config's layer), tanh head of 3."""

    def __init__(self, spec: WarpSpec):
        super().__init__()
        self.spec = spec
        self.trunk = SkipTrunk(spec.input_dim, spec.hidden_size,
                               spec.num_layers, spec.skip_connect_every)
        self.out = linear(spec.hidden_size, 3)

    def forward(self, pe_xyz, driving, pose):
        """pe_xyz (P, pe_dim); driving (76,); pose (36,) -> tanh dx (P, 3)."""
        x0 = torch.cat(_conditioned(pe_xyz, driving if self.spec.include_driving
                                    else None, pose), dim=-1)
        return torch.tanh(self.out(self.trunk(x0, torch.relu)))


class HyperSheet(nn.Module):
    """6x64 ReLU trunk (skip at the config's layer), linear ambient head."""

    def __init__(self, spec: HyperSpec):
        super().__init__()
        self.spec = spec
        self.trunk = SkipTrunk(spec.input_dim, spec.hidden_size,
                               spec.num_layers, spec.skip_connect_every)
        self.out = linear(spec.hidden_size, spec.ambient_coord_dim)

    def forward(self, pe_xyz, driving, pose):
        x0 = torch.cat(_conditioned(pe_xyz, driving if self.spec.include_driving
                                    else None, pose), dim=-1)
        return self.out(self.trunk(x0, torch.relu))


def _conditioned(x, driving, pose):
    n = x.shape[:-1]
    parts = [x]
    if driving is not None:
        parts.append(driving.expand(n + (driving.shape[-1],)))
    if pose is not None:
        parts.append(pose.expand(n + (pose.shape[-1],)))
    return parts


class NeRFMLP(nn.Module):
    """8x256 leaky trunk with the skip at layer 3, feat/alpha heads, a
    4x128 direction branch to rgb and a 4x128 seg branch to 12 logits.
    Output (P, 16) = rgb3 | seg12 | sigma1."""

    def __init__(self, spec: NeRFSpec):
        super().__init__()
        self.spec = spec
        H = spec.hidden_size
        B = H // 2
        self.trunk = SkipTrunk(spec.trunk_input_dim, H, spec.num_layers,
                               spec.skip_connect_every)
        self.fc_feat = linear(H, H)
        self.fc_alpha = linear(H, 1)
        self.dir = nn.ModuleList([linear(spec.dir_input_dim, B)]
                                 + [linear(B, B) for _ in range(3)])
        self.fc_rgb = linear(B, 3)
        self.seg = nn.ModuleList([linear(H, B)] + [linear(B, B) for _ in range(3)])
        self.fc_seg = linear(B, SEG_CLASSES)

    def forward(self, points_embed, dirs_embed, driving=None, pose=None,
                latent_code=None, spatial_embedding=None):
        """Input concat order [points_embed, latent?, driving?, pose?]
        (fields.py:284-324 of the JAX package)."""
        spec = self.spec
        act = lambda v: leaky_relu(v, 0.01)
        parts = [points_embed]
        n = points_embed.shape[:-1]
        if spec.latent_code_dim > 0 and latent_code is not None:
            parts.append(latent_code.expand(n + (spec.latent_code_dim,)))
        if spec.include_driving:
            parts.append(driving.expand(n + (DRIVING_DIM,)))
        if spec.use_pose:
            parts.append(pose.expand(n + (pose.shape[-1],)))
        x0 = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
        h = self.trunk(x0, act)
        feat = self.fc_feat(h)                     # no activation (modules.py:274)
        alpha = self.fc_alpha(feat)
        if spec.use_viewdirs:
            din = [feat, dirs_embed]
            if spec.use_spatial_embeddings and spatial_embedding is not None:
                din.append(spatial_embedding)
            x = torch.cat(din, dim=-1)
        else:
            x = feat
        for lin in self.dir:
            x = act(lin(x))
        rgb = self.fc_rgb(x)
        x = feat
        for lin in self.seg:
            x = act(lin(x))
        seg = self.fc_seg(x)
        return torch.cat([rgb, seg, alpha], dim=-1)


AUDIO_CONV_CHANNELS = [(29, 32), (32, 32), (32, 64), (64, 64)]


class AudioNet(nn.Module):
    """DeepSpeech window (16, 29) -> 76-d driving vector
    (reference modules.py:43-73): four stride-2 convs, kernel 3, pad 1,
    leaky 0.02, then two linear layers."""

    def __init__(self, dim_aud: int = DRIVING_DIM, win_size: int = 16):
        super().__init__()
        self.win_size = win_size
        self.convs = nn.ModuleList(
            [torch.nn.utils.skip_init(nn.Conv1d, cin, cout, 3, stride=2,
                                      padding=1)
             for cin, cout in AUDIO_CONV_CHANNELS])
        self.fc1 = linear(64, 64)
        self.fc2 = linear(64, dim_aud)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """audio (16, 29) time-major, or (B, 16, 29) -> (76,) or (B, 76)."""
        x = audio if audio.dim() == 3 else audio[None]
        half = self.win_size // 2
        x = x[:, 8 - half:8 + half, :].transpose(1, 2)     # NCW
        act = lambda v: leaky_relu(v, 0.02)
        for conv in self.convs:
            x = act(conv(x))
        x = x[:, :, 0]                                     # 16->8->4->2->1
        x = act(self.fc1(x))
        x = self.fc2(x)
        return x[0] if audio.dim() == 2 else x


def spatial_grid(generator: torch.Generator) -> torch.Tensor:
    """Learnable (C, D, H, W) feature grid, randn * 0.01 (models.py:201)."""
    return torch.randn((SPATIAL_EMBEDDING_DIM, SPATIAL_GRID_RES,
                        SPATIAL_GRID_RES, SPATIAL_GRID_RES),
                       generator=generator) * 0.01

