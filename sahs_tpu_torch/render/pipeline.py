"""Hierarchical coarse/fine rendering (counterpart of
``sahs_tpu/render/pipeline.py``).

Reference quirks preserved (nerf-pytorch/nerf/train_utils.py):
  - the field sees the RAW (unnormalised) ray directions (:15, :267);
  - the last coarse/fine sample's 15 channels are the background prior
    (:135-136, :184-185);
  - fine z = sort(cat(coarse z, sample_pdf(mid, weights[1:-1]))), the
    importance samples detached (:157-166);
  - the returned weights are the fine level's (:193, :205).

Random draws (coarse jitter, importance uniforms, sigma noise) come from an
explicit ``torch.Generator``; tests can inject them instead.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..config import Config, NerfModeConfig
from ..models import nerface
from ..models.nerface import NeRFaceModel
from ..ops.rendering import RenderOutputs, volume_render_radiance_field
from ..ops.sampling import coarse_z_vals, merge_z_vals, sample_pdf


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Per-mode settings. ``use_pallas`` selects the kernel path (K1 + K5);
    ``compute_dtype`` is the kernels' matmul operand type."""
    num_coarse: int = 64
    num_fine: int = 64
    perturb: bool = True
    lindisp: bool = False
    radiance_field_noise_std: float = 0.0
    white_background: bool = False
    chunksize: int = 131072
    use_pallas: bool = False
    compute_dtype: str = "bfloat16"
    use_ndc: bool = False
    fuse_composite: bool = True

    @classmethod
    def from_mode_config(cls, mc: NerfModeConfig, use_pallas: bool = False,
                         compute_dtype: str = "bfloat16",
                         use_ndc: bool = False,
                         fuse_composite: bool = True) -> "RenderSettings":
        return cls(num_coarse=mc.num_coarse, num_fine=mc.num_fine,
                   perturb=bool(mc.perturb), lindisp=bool(mc.lindisp),
                   radiance_field_noise_std=float(mc.radiance_field_noise_std),
                   white_background=bool(mc.white_background),
                   chunksize=int(mc.chunksize), use_pallas=bool(use_pallas),
                   compute_dtype=compute_dtype, use_ndc=bool(use_ndc),
                   fuse_composite=bool(fuse_composite))

    @classmethod
    def from_config(cls, cfg: Config, mode: str) -> "RenderSettings":
        return cls.from_mode_config(
            getattr(cfg.nerf, mode), use_pallas=cfg.runtime.use_pallas,
            compute_dtype=cfg.runtime.compute_dtype,
            use_ndc=not cfg.dataset.no_ndc,
            fuse_composite=getattr(cfg.runtime, "fuse_composite", True))


class RayRenderResult(NamedTuple):
    rgb_coarse: torch.Tensor           # (R, C) rgb(3) [+ seg(12)]
    disp_coarse: torch.Tensor
    acc_coarse: torch.Tensor
    rgb_fine: Optional[torch.Tensor]
    disp_fine: Optional[torch.Tensor]
    acc_fine: Optional[torch.Tensor]
    weights: Optional[torch.Tensor]    # fine weights (R, Nc+Nf)
    depth_fine: Optional[torch.Tensor]


class Draws(NamedTuple):
    """Injectable random draws of one render_rays call (None = draw from
    the generator): coarse jitter (R, Nc) in [0,1), importance uniforms
    (R, Nf) in [0,1), standard-normal sigma noise per level (R, S)."""
    t_rand: Optional[torch.Tensor] = None
    u: Optional[torch.Tensor] = None
    noise_coarse: Optional[torch.Tensor] = None
    noise_fine: Optional[torch.Tensor] = None


def render_rays(model: NeRFaceModel, settings: RenderSettings,
                ray_origins: torch.Tensor, ray_directions: torch.Tensor,
                near: float, far: float, driving_or_audio: torch.Tensor,
                pose: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                background_prior: Optional[torch.Tensor] = None,
                latent_code: Optional[torch.Tensor] = None,
                fns: Optional[nerface.RenderFns] = None,
                draws: Draws = Draws()) -> RayRenderResult:
    """Render one batch of rays (R, 3) on their device. ``fns`` reuses
    per-frame evaluators across chunks (render_rays_chunked builds them
    once per frame)."""
    num_rays = ray_origins.shape[0]
    dtype = ray_origins.dtype
    dev = ray_origins.device
    if fns is None:
        fns = nerface.make_render_fns(
            model, driving_or_audio, pose, latent_code=latent_code,
            use_pallas=settings.use_pallas,
            compute_dtype=settings.compute_dtype)
    level_fn = fns.level_fn
    if level_fn is not None and not settings.fuse_composite:
        raise NotImplementedError(
            "fuse_composite=False on the kernel path needs the raw-field "
            "kernel (K7), which is still to be ported")

    nearv = torch.full((num_rays,), near, dtype=dtype, device=dev)
    farv = torch.full((num_rays,), far, dtype=dtype, device=dev)

    def noise_for(shape, injected):
        if settings.radiance_field_noise_std <= 0:
            return None
        if injected is None:
            injected = torch.randn(shape, generator=generator, dtype=dtype,
                                   device=dev)
        return injected * settings.radiance_field_noise_std

    def run_level(level, z_vals, injected_noise):
        S = z_vals.shape[-1]
        pts = ray_origins[:, None, :] + ray_directions[:, None, :] * z_vals[..., None]
        pts_flat = pts.reshape(-1, 3)
        noise = noise_for(z_vals.shape, injected_noise)
        if level_fn is not None:
            # K1 -> K5: MLP and compositing in the kernel, per-ray outputs;
            # disp/acc/depth are the same (R, S) reductions as the oracle's
            rgb_map, weights = level_fn(level, pts_flat, ray_directions, S,
                                        z_vals, background_prior, noise)
            rgb = rgb_map[:, :15]
            depth = torch.sum(weights * z_vals, dim=-1)
            acc = torch.sum(weights, dim=-1)
            disp = 1.0 / torch.clamp(depth / acc, min=1e-10)
            if settings.white_background:
                rgb = rgb + (1.0 - acc[..., None])
            return RenderOutputs(rgb, disp, acc, weights, depth)
        raw = fns.field_fn(level, pts_flat, ray_directions, S)
        raw = raw.reshape(num_rays, S, raw.shape[-1])
        if background_prior is not None:
            raw = torch.cat([raw[:, :-1],
                             torch.cat([background_prior, raw[:, -1:, -1]],
                                       dim=-1)[:, None]], dim=1)
        return volume_render_radiance_field(
            raw, z_vals, ray_directions,
            radiance_field_noise_std=(1.0 if noise is not None else 0.0),
            white_background=settings.white_background,
            background_prior=background_prior, noise=noise)

    with torch.no_grad():
        z_coarse = coarse_z_vals(nearv, farv, settings.num_coarse,
                                 lindisp=settings.lindisp,
                                 perturb=settings.perturb,
                                 generator=generator, t_rand=draws.t_rand)
        coarse = run_level("coarse", z_coarse, draws.noise_coarse)
        if settings.num_fine <= 0 or model.fine is None:
            return RayRenderResult(coarse.rgb, coarse.disp, coarse.acc,
                                   None, None, None, coarse.weights, None)
        z_mid = 0.5 * (z_coarse[..., 1:] + z_coarse[..., :-1])
        z_samples = sample_pdf(z_mid, coarse.weights[..., 1:-1],
                               settings.num_fine, det=(not settings.perturb),
                               generator=generator, u=draws.u)
        z_fine = merge_z_vals(z_coarse, z_samples)
        fine = run_level("fine", z_fine, draws.noise_fine)
    return RayRenderResult(coarse.rgb, coarse.disp, coarse.acc,
                           fine.rgb, fine.disp, fine.acc,
                           fine.weights, fine.depth)


def render_rays_chunked(model: NeRFaceModel, settings: RenderSettings,
                        ray_origins: torch.Tensor, ray_directions: torch.Tensor,
                        near: float, far: float,
                        driving_or_audio: torch.Tensor, pose: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        background_prior: Optional[torch.Tensor] = None,
                        latent_code: Optional[torch.Tensor] = None,
                        chunksize: Optional[int] = None) -> RayRenderResult:
    """Full-bundle rendering as a Python loop over ray chunks (the JAX
    package's lax.map; the reference's get_minibatches loop,
    train_utils.py:274-295). The per-frame evaluators are built once."""
    chunksize = chunksize or settings.chunksize
    R = ray_origins.shape[0]
    fns = nerface.make_render_fns(
        model, driving_or_audio, pose, latent_code=latent_code,
        use_pallas=settings.use_pallas, compute_dtype=settings.compute_dtype)
    outs = []
    for start in range(0, R, chunksize):
        sl = slice(start, min(start + chunksize, R))
        bg = background_prior[sl] if background_prior is not None else None
        outs.append(render_rays(model, settings, ray_origins[sl],
                                ray_directions[sl], near, far,
                                driving_or_audio, pose, generator=generator,
                                background_prior=bg, latent_code=latent_code,
                                fns=fns))
    return RayRenderResult(*[
        None if parts[0] is None else torch.cat(parts, dim=0)
        for parts in zip(*outs)])


def render_image(model: NeRFaceModel, settings: RenderSettings, H: int, W: int,
                 intrinsics: torch.Tensor, pose: torch.Tensor, near: float,
                 far: float, driving_or_audio: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 background: Optional[torch.Tensor] = None,
                 latent_code: Optional[torch.Tensor] = None,
                 chunksize: Optional[int] = None) -> Dict[str, Any]:
    """Full-image render (the reference's mode='validation' path,
    train_utils.py:303-319). background: (H, W, 15) or None."""
    from ..ops.rays import get_ray_bundle, ndc_rays
    ro, rd = get_ray_bundle(H, W, intrinsics, pose)
    if settings.use_ndc:
        ro, rd = ndc_rays(H, W, intrinsics, 1.0, ro, rd)
    bg = background.reshape(-1, background.shape[-1]) if background is not None else None
    res = render_rays_chunked(model, settings, ro.reshape(-1, 3),
                              rd.reshape(-1, 3), near, far, driving_or_audio,
                              pose, generator=generator, background_prior=bg,
                              latent_code=latent_code, chunksize=chunksize)

    def img(x):
        if x is None:
            return None
        return x.reshape((H, W, -1)) if x.dim() == 2 else x.reshape((H, W))

    return {
        "rgb_coarse": img(res.rgb_coarse),
        "disp_coarse": img(res.disp_coarse),
        "acc_coarse": img(res.acc_coarse),
        "rgb_fine": img(res.rgb_fine),
        "disp_fine": img(res.disp_fine),
        "acc_fine": img(res.acc_fine),
        "weights": res.weights,
        "depth_fine": img(res.depth_fine),
    }
