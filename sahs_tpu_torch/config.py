"""Typed configuration schema, shared by the JAX package and this port.

A copy of ``sahs_tpu/config.py`` (the port never imports the JAX package):
the dataclasses, their defaults and ``load_config`` are kept identical so a
YAML file means the same thing to both. In the port, ``runtime.use_pallas``
selects the hand-written CUDA kernel path and ``runtime.compute_dtype`` the
kernels' matmul operand type.

Replaces the reference's YACS-style ``CfgNode`` (reference:
nerf-pytorch/nerf/cfgnode.py) with a tree of frozen-by-convention
dataclasses plus a YAML loader that accepts the reference's shipped config
files verbatim (reference: nerf-pytorch/config/audio/person_2_auto.yml,
config/expression/person_2.yml).

The handful of flags the reference hardcodes inside ``main`` (reference:
nerf-pytorch/train_stage_rays_auto.py:123-137) are lifted into a
``RuntimeConfig`` section so every behaviour is config-driven.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import yaml


@dataclass
class ExperimentConfig:
    id: str = "default"
    logdir: str = "./log"
    randomseed: int = 42
    train_iters: int = 500000
    validate_every: int = 1000
    save_every: int = 5000
    print_every: int = 100


@dataclass
class DatasetConfig:
    type: str = "audio"  # "audio" | "expression"
    basedir: str = "."
    half_res: bool = False
    testskip: int = 1
    no_ndc: bool = True
    near: float = 0.2
    far: float = 0.8
    debug: bool = False  # 1/32-size images, mirrors reference loaders' debug mode
    cachedir: Optional[str] = None


@dataclass
class MaskHeadConfig:
    type: str = "AudioFaceModel"  # top-level model class name
    use_mask: bool = True
    module: Optional[str] = None
    # Accepted for YAML compatibility (person_2 expression config sets it)
    # but a deliberate NO-OP: the flag is dead in the reference too — no
    # reference .py ever reads it (grep over nerf-pytorch). Do not "wire"
    # this; there is nothing to wire.
    use_losschoose: bool = False
    use_warp_not_in_head: bool = False
    # Per-frame latent code width fed to the NeRF MLP trunk. The reference
    # hardcodes 0 for the shipped models (models.py:275,294); >0 enables the
    # NerFACE-style learnable per-frame codes.
    latent_code_dim: int = 0


@dataclass
class WarpConfig:
    type: str = "WarpFieldMLP"
    use_warp: bool = True
    num_layers: int = 6
    hidden_size: int = 128
    skip_connect_every: int = 4
    num_encoding_fn_xyz: int = 10
    include_input_xyz: bool = True
    log_sampling_xyz: bool = True
    include_driving: bool = True


@dataclass
class HyperConfig:
    slice_method: str = "bendy_sheet"
    type: str = "HyperSheetMLP"
    use_ambient: bool = True
    include_input_ambient: bool = True
    num_encoding_fn_ambient: int = 4
    log_sampling_ambient: bool = True
    ambient_coord_dim: int = 2
    num_layers: int = 6
    hidden_size: int = 64
    skip_connect_every: int = 4
    num_encoding_fn_xyz: int = 10
    include_input_xyz: bool = True
    log_sampling_xyz: bool = True
    include_driving: bool = True


@dataclass
class NeRFMLPConfig:
    type: str = "NeRFMLP"
    num_layers: int = 8
    hidden_size: int = 256
    skip_connect_every: int = 4
    include_input_xyz: bool = True
    log_sampling_xyz: bool = True
    num_encoding_fn_xyz: int = 10
    use_viewdirs: bool = True
    include_input_dir: bool = True
    num_encoding_fn_dir: int = 4
    log_sampling_dir: bool = True
    include_driving: bool = False
    use_spatial_embeddings: bool = True
    use_pose: bool = True
    include_pose: bool = False


@dataclass
class ModelsConfig:
    type: Optional[str] = None
    mask: MaskHeadConfig = field(default_factory=MaskHeadConfig)
    warp: WarpConfig = field(default_factory=WarpConfig)
    hyper: HyperConfig = field(default_factory=HyperConfig)
    coarse: NeRFMLPConfig = field(default_factory=NeRFMLPConfig)
    fine: Optional[NeRFMLPConfig] = field(default_factory=NeRFMLPConfig)


@dataclass
class OptimizerConfig:
    type: str = "Adam"
    lr: float = 5.0e-4


@dataclass
class SchedulerConfig:
    lr_decay: int = 250  # in units of 1000 iterations
    lr_decay_factor: float = 0.1


@dataclass
class NerfModeConfig:
    num_random_rays: int = 2048
    chunksize: int = 131072
    perturb: bool = True
    num_coarse: int = 64
    num_fine: int = 64
    white_background: bool = False
    radiance_field_noise_std: float = 0.0
    lindisp: bool = False


@dataclass
class NerfConfig:
    use_viewdirs: bool = True
    encode_position_fn: str = "positional_encoding"
    encode_direction_fn: str = "positional_encoding"
    # Train noise_std default matches the shipped configs (0.1): without the
    # sigma noise, a fresh init can have ALL relu'd densities at exactly zero
    # and the gradient vanishes (cold-start property of the reference arch).
    train: NerfModeConfig = field(default_factory=lambda: NerfModeConfig(
        radiance_field_noise_std=0.1))
    validation: NerfModeConfig = field(default_factory=NerfModeConfig)


@dataclass
class TextureRefineConfig:
    batch_size: int = 32
    lr_G: float = 1.0e-4
    beta1: float = 0.0
    beta2: float = 0.999
    log_iters: int = 20
    texture_photo: str = ""
    train_basedir: str = ""
    test_basedir: str = ""
    val_basedir: str = ""
    train_num: int = 0
    test_num: int = 0
    val_num: int = 0
    epochs: int = 30
    epochs_decay: int = 30
    # --- optional loss terms (the reference DEFINES Discriminator + VGG,
    # _init_spade.py:375-451, but ships an MSE-only loop; these gates wire
    # them in. Defaults keep exact reference behaviour: MSE only.) ---
    use_perceptual: bool = False
    perceptual_weight: float = 10.0
    vgg_weights: str = ""          # optional torchvision vgg19 state_dict path
    use_gan: bool = False
    gan_weight: float = 1.0
    gan_feat_weight: float = 0.0   # >0 adds pix2pixHD feature matching
    lr_D: float = 1.0e-4
    # frames fused per device program in the training loop (lax.scan)
    scan_frames: int = 8


@dataclass
class RuntimeConfig:
    """Behaviour flags that are hardcoded Python variables in the reference
    trainer (reference: nerf-pytorch/train_stage_rays_auto.py:123-137)."""

    train_background: bool = False
    supervised_train_background: bool = False
    blur_background: bool = False
    train_latent_codes: bool = False
    disable_driving: bool = False
    disable_latent_codes: bool = True
    fixed_background: bool = True
    regularize_latent_codes: bool = False
    train_spatial_embeddings: bool = True
    regularize_spatial_embedding: bool = False
    dynamic_sampling: bool = True
    # Loss weights (inline constants in the reference,
    # train_stage_rays_auto.py:268-270,458,465,490-492)
    mouth_class_weight: float = 2.0
    ce_weight: float = 0.02
    mouth_loss_weight: float = 0.005
    latent_reg_weight: float = 0.0005
    spatial_reg_weight: float = 0.0005
    background_loss_weight: float = 0.001
    # Execution knobs. The names and defaults are the JAX package's, so a
    # YAML selects the same path in both packages.
    # use_pallas: the kernel path (the hand-written CUDA kernels of
    # ops/kernels); off, the plain path: the reference math in tensor ops.
    use_pallas: bool = True
    # with use_pallas: volume-composite inside the NeRF level kernel (K5,
    # per-ray outputs). Off, the level kernel emits the raw field (K7) and
    # the fine level reuses the coarse points' deformation front half.
    # Sample counts the level kernels do not take run the per-point branch
    # (K11) either way.
    fuse_composite: bool = True
    # The kernels' matmul operand type: "bfloat16" (products summed in
    # float32) or "float32" for parity and debug runs.
    compute_dtype: str = "bfloat16"  # "float32" | "bfloat16"
    # The fused Stage-I gradient path (train/fused.py): the loss cotangents
    # formed in the level kernel (K2), the deformation pair's backward and
    # dGrid run once over the coarse-and-fine union points. A configuration
    # outside stage1_fused_eligible, or this knob off, trains through
    # autograd over render_rays.
    fused_grads: bool = True
    donate_state: bool = True
    # Eval-time pose override: render every frame from the FIRST frame's
    # camera pose (the reference's hardcoded `frontalize` flag,
    # eval_stage_rays.py:376,415-416).
    frontalize: bool = False
    # frames per in-training validation pass; 0 = the FULL val set (the
    # reference validates over the whole set, train_stage_rays_auto.py:577)
    validate_frames: int = 0
    # frames whose images (rgb/seg/disp) go to the logger each validation
    validate_image_frames: int = 1


@dataclass
class Config:
    experiment: ExperimentConfig = field(default_factory=ExperimentConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    models: ModelsConfig = field(default_factory=ModelsConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    nerf: NerfConfig = field(default_factory=NerfConfig)
    texture_refine: TextureRefineConfig = field(default_factory=TextureRefineConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    def dump(self) -> str:
        return yaml.safe_dump(to_dict(self), default_flow_style=False)


# ---------------------------------------------------------------------------
# Merging / loading
# ---------------------------------------------------------------------------

def _merge_into_dataclass(obj: Any, data: Dict[str, Any], path: str = "") -> Any:
    """Recursively merge a plain dict (from YAML) into a dataclass instance."""
    if data is None:
        return obj
    fields = {f.name: f for f in dataclasses.fields(obj)}
    for key, value in data.items():
        if key not in fields:
            # Tolerate unknown keys, like the reference's CfgNode merge.
            continue
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _merge_into_dataclass(current, value, path + key + ".")
        elif current is None and isinstance(value, dict):
            # Optional sub-config (e.g. models.fine) being switched on.
            f = fields[key]
            sub_type = _OPTIONAL_SUBTYPES.get(key)
            if sub_type is not None:
                sub = sub_type()
                _merge_into_dataclass(sub, value, path + key + ".")
                setattr(obj, key, sub)
            else:
                setattr(obj, key, value)
        else:
            setattr(obj, key, value)
    return obj


_OPTIONAL_SUBTYPES = {"fine": NeRFMLPConfig}


def to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return obj


def load_config(path_or_dict: Any) -> Config:
    """Build a Config from a YAML file path or an already-parsed dict.

    Accepts the reference's shipped YAMLs unchanged; the ``fine`` model
    section is present in all shipped configs, so a config *without* one must
    explicitly set ``models: {fine: null}`` to disable the fine network.
    """
    if isinstance(path_or_dict, dict):
        data = path_or_dict
    else:
        with open(path_or_dict, "r") as fp:
            data = yaml.safe_load(fp)
    cfg = Config()
    has_fine = "fine" in data.get("models", {"fine": True})
    _merge_into_dataclass(cfg, data)
    if not has_fine or (data.get("models", {}).get("fine", True) is None):
        cfg.models.fine = None
    return cfg


def reference_audio_config() -> Config:
    """In-code equivalent of reference config/audio/person_2_auto.yml."""
    cfg = Config()
    cfg.dataset.near = 0.483771014213562
    cfg.dataset.far = 1.083771014213562
    cfg.dataset.testskip = 36
    cfg.nerf.train.radiance_field_noise_std = 0.1
    cfg.nerf.validation.radiance_field_noise_std = 0.0
    return cfg


def reference_expression_config() -> Config:
    """In-code equivalent of reference config/expression/person_2.yml."""
    cfg = Config()
    cfg.dataset.type = "expression"
    cfg.dataset.near = 0.2
    cfg.dataset.far = 0.8
    cfg.models.mask.type = "NeRFaceModel"
    cfg.models.mask.use_losschoose = True
    cfg.models.warp.num_encoding_fn_xyz = 15
    cfg.models.hyper.num_encoding_fn_xyz = 15
    cfg.models.hyper.num_encoding_fn_ambient = 15
    cfg.models.hyper.include_input_ambient = False
    cfg.models.hyper.ambient_coord_dim = 1
    for m in (cfg.models.coarse, cfg.models.fine):
        m.num_layers = 4
        m.skip_connect_every = 3
        m.num_encoding_fn_xyz = 15
        m.include_driving = True
        m.use_spatial_embeddings = True
        m.use_pose = False
    cfg.nerf.train.radiance_field_noise_std = 0.1
    cfg.nerf.validation.radiance_field_noise_std = 0.0
    return cfg
