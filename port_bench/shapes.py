"""The model's widths and parameter layout, worked out from a configuration
file's ``config`` dict alone.

The architecture is SAHS's deformable NeRF (the reference repository's
nerf-pytorch/nerf/models.py and modules.py): a warp MLP and a hyper-sheet
MLP over the positional encoding of each sample point, conditioned on the
driving vector and the encoded head pose; a NeRF MLP per level over the
encoded canonical point, a 32-channel 32^3 feature grid sampled at the
warped point, the encoded view direction, with an rgb head and a 12-class
segmentation head; AudioNet turning a DeepSpeech window into the driving
vector. The parameter names and shapes are those of the port's
``nn.Module`` tree (``Linear.weight`` is (out, in)), so that weights made
here load into the port and the plain reference reads the same tensors.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

DRIVING_DIM = 76
POSE_PE_DIM = 36          # 6-dof pose, 3 frequencies, no input passthrough
SEG_CLASSES = 12
GRID_CHANNELS = 32
GRID_RES = 32
# The NeRF MLP never receives its config's skip_connect_every in the
# reference (models.py builds NeRFMLP without it), so its default 3 holds.
NERF_SKIP = 3
AUDIO_CONVS = ((29, 32), (32, 32), (32, 64), (64, 64))
AUDIO_WINDOW = (16, 29)


def pe_dim(d: int, num_freqs: int, include_input: bool) -> int:
    return (d if include_input else 0) + 2 * d * num_freqs


@dataclasses.dataclass(frozen=True)
class Net:
    """A skip MLP: ``layers`` (fan_in, fan_out) with the input
    re-concatenated before layer ``skip``; ``cond`` the width of the
    conditioning part of the input (folded into biases by the port's
    kernels), ``enc`` the encoded-point part."""
    layers: Tuple[Tuple[int, int], ...]
    skip: int
    enc: int
    cond: int
    head: int


@dataclasses.dataclass(frozen=True)
class NeRF:
    trunk: Net
    hidden: int
    dir_pe: int
    grid: bool

    @property
    def branch(self) -> int:
        return self.hidden // 2


@dataclasses.dataclass(frozen=True)
class Spec:
    audio: bool
    warp: Optional[Net]
    hyper: Optional[Net]
    coarse: NeRF
    fine: NeRF
    xyz_freqs: int            # the deformation nets' encoding of x
    nerf_xyz_freqs: int
    nerf_include_xyz: bool
    ambient_dim: int          # 0 without the hyper sheet
    ambient_freqs: int
    ambient_include: bool
    dir_freqs: int
    dir_include: bool
    nerf_pose: bool
    nerf_driving: bool
    deform_driving: bool


def _net(enc: int, cond: int, hidden: int, num_layers: int, skip: int,
         head: int) -> Net:
    din = enc + cond
    layers = [(din, hidden)] + [(din + hidden if i == skip else hidden, hidden)
                                for i in range(1, num_layers)]
    return Net(tuple(layers), skip, enc, cond, head)


def spec_of(cfg: dict) -> Spec:
    m = cfg["models"]
    warp_c, hyper_c, coarse_c = m["warp"], m["hyper"], m["coarse"]
    xyz_f = warp_c["num_encoding_fn_xyz"]
    enc_x = pe_dim(3, xyz_f, True)
    deform_cond = lambda c: POSE_PE_DIM + (DRIVING_DIM if c["include_driving"] else 0)
    warp = hyper = None
    if warp_c["use_warp"]:
        warp = _net(enc_x, deform_cond(warp_c), warp_c["hidden_size"],
                    warp_c["num_layers"], warp_c["skip_connect_every"], 3)
    amb = 0
    if hyper_c["use_ambient"]:
        amb = hyper_c["ambient_coord_dim"]
        hyper = _net(pe_dim(3, hyper_c["num_encoding_fn_xyz"], hyper_c["include_input_xyz"]),
                     deform_cond(hyper_c), hyper_c["hidden_size"],
                     hyper_c["num_layers"], hyper_c["skip_connect_every"], amb)
    amb_pe = pe_dim(amb, hyper_c["num_encoding_fn_ambient"],
                    hyper_c["include_input_ambient"]) if amb else 0

    def nerf(level_c: dict) -> NeRF:
        # the fine MLP takes the coarse one's width, depth, pose and grid
        # flags (models.py:278-296)
        hidden, layers = coarse_c["hidden_size"], coarse_c["num_layers"]
        enc = pe_dim(3, level_c["num_encoding_fn_xyz"], level_c["include_input_xyz"]) + amb_pe
        cond = ((POSE_PE_DIM + (6 if coarse_c["include_pose"] else 0)) if coarse_c["use_pose"]
                else 0) + m["mask"]["latent_code_dim"] + (
                    DRIVING_DIM if level_c["include_driving"] else 0)
        dir_pe = pe_dim(3, coarse_c["num_encoding_fn_dir"], coarse_c["include_input_dir"])
        return NeRF(_net(enc, cond, hidden, layers, NERF_SKIP, 1), hidden, dir_pe,
                    bool(coarse_c["use_spatial_embeddings"]))

    if not coarse_c["use_viewdirs"]:
        raise ValueError("the benchmark's reference covers models with view directions")
    return Spec(audio=m["mask"]["type"] in ("AudioFaceModel", "AudioMaskGenerator"),
                warp=warp, hyper=hyper, coarse=nerf(coarse_c), fine=nerf(m["fine"]),
                xyz_freqs=xyz_f, nerf_xyz_freqs=coarse_c["num_encoding_fn_xyz"],
                nerf_include_xyz=coarse_c["include_input_xyz"], ambient_dim=amb,
                ambient_freqs=hyper_c["num_encoding_fn_ambient"],
                ambient_include=hyper_c["include_input_ambient"],
                dir_freqs=coarse_c["num_encoding_fn_dir"],
                dir_include=coarse_c["include_input_dir"],
                nerf_pose=bool(coarse_c["use_pose"]),
                nerf_driving=bool(coarse_c["include_driving"]),
                deform_driving=bool(warp_c["include_driving"]))


def layout(spec: Spec) -> List[Tuple[str, Tuple[int, ...], int]]:
    """Every parameter as (name, shape, fan_in): the port's state_dict
    names. fan_in 0 marks the feature grid (drawn N(0, 0.01^2))."""
    out: List[Tuple[str, Tuple[int, ...], int]] = []

    def lin(name, fi, fo):
        out.append((name + ".weight", (fo, fi), fi))
        out.append((name + ".bias", (fo,), fi))

    for name, net in (("warp", spec.warp), ("hyper", spec.hyper)):
        if net is None:
            continue
        for i, (fi, fo) in enumerate(net.layers):
            lin(f"{name}.trunk.layers.{i}", fi, fo)
        lin(f"{name}.out", net.layers[-1][1], net.head)
    for level in ("coarse", "fine"):
        nf: NeRF = getattr(spec, level)
        for i, (fi, fo) in enumerate(nf.trunk.layers):
            lin(f"{level}.trunk.layers.{i}", fi, fo)
        H, B = nf.hidden, nf.branch
        lin(f"{level}.fc_feat", H, H)
        lin(f"{level}.fc_alpha", H, 1)
        dir_in = H + nf.dir_pe + (GRID_CHANNELS if nf.grid else 0)
        lin(f"{level}.dir.0", dir_in, B)
        for i in range(1, 4):
            lin(f"{level}.dir.{i}", B, B)
        lin(f"{level}.fc_rgb", B, 3)
        lin(f"{level}.seg.0", H, B)
        for i in range(1, 4):
            lin(f"{level}.seg.{i}", B, B)
        lin(f"{level}.fc_seg", B, SEG_CLASSES)
    if spec.coarse.grid:
        out.append(("spatial_embeddings", (GRID_CHANNELS, GRID_RES, GRID_RES, GRID_RES), 0))
    if spec.audio:
        for i, (ci, co) in enumerate(AUDIO_CONVS):
            out.append((f"audnet.convs.{i}.weight", (co, ci, 3), ci * 3))
            out.append((f"audnet.convs.{i}.bias", (co,), ci * 3))
        lin("audnet.fc1", 64, 64)
        lin("audnet.fc2", 64, DRIVING_DIM)
    return out
