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

``render_rays(differentiable=True)`` is the train step's autograd fallback:
the fields and the compositing carry gradients into the model, the driving
input, the latent code and the background prior, while z and the
importance samples stay detached (the JAX package's stop_gradient).

Spans (utils/profiling): a frame runs in the phase ``serve.frame``, its
conditioning (``make_render_fns``) in the phase ``serve.cond``, each chunk
in ``serve.chunk`` (counted by ``serve.chunks``) and the final
concatenation in ``serve.gather``; the frame's folds (``serve.fold``
spans, lazily inside its first chunk) add their host seconds to the
aggregate ``serve.fold`` once a frame; inside a chunk, ``serve.z``,
``serve.importance``, ``serve.merge`` (the sort and the merge of the fine
z) and ``serve.reduce`` (depth, acc and disp after K5) mark the pipeline's
own ops between the kernels' ``launch.*`` spans.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..config import Config, NerfModeConfig
from ..models import nerface
from ..models.nerface import NeRFaceModel
from ..ops.rendering import RenderOutputs, volume_render_radiance_field
from ..ops.sampling import coarse_z_vals, merge_z_vals, sample_pdf
from ..utils import profiling


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Per-mode settings. ``use_pallas`` selects the kernel path;
    ``compute_dtype`` is the kernels' matmul operand type;
    ``fuse_composite`` composites in the level kernel (K5), else the raw
    field (K7) is composited in plain tensor math."""
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


class _PermuteSamples(torch.autograd.Function):
    """x (R, S, C) reordered along the sample axis by perm (R, S); the
    backward gathers with the inverse permutation (pipeline.py:87-107)."""

    @staticmethod
    def forward(ctx, x, perm):
        ctx.save_for_backward(torch.argsort(perm, dim=-1))
        return torch.take_along_dim(x, perm[..., None], dim=1)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return torch.take_along_dim(g, inv[..., None], dim=1), None


def permute_samples(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    return _PermuteSamples.apply(x, perm)


def render_rays(model: NeRFaceModel, settings: RenderSettings,
                ray_origins: torch.Tensor, ray_directions: torch.Tensor,
                near: float, far: float, driving_or_audio: torch.Tensor,
                pose: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                background_prior: Optional[torch.Tensor] = None,
                latent_code: Optional[torch.Tensor] = None,
                fns: Optional[nerface.RenderFns] = None,
                draws: Draws = Draws(),
                differentiable: bool = False) -> RayRenderResult:
    """Render one batch of rays (R, 3) on their device. ``fns`` reuses
    per-frame evaluators across chunks (render_rays_chunked builds them
    once per frame). ``differentiable`` keeps the autograd graph (training);
    otherwise no gradient is recorded.

    With ``settings.fuse_composite`` off on the kernel path, the fine level
    reuses the coarse points' front half (pipeline.py:213-267): the front
    half runs on the coarse and on the importance points, the fine raw
    field on their concatenation, and the raw samples are put in ascending
    z (a stable sort, as jnp.argsort) for the plain compositing."""
    grad_ctx = contextlib.nullcontext() if differentiable else torch.no_grad()
    with grad_ctx:
        return _render_rays(model, settings, ray_origins, ray_directions, near,
                            far, driving_or_audio, pose, generator,
                            background_prior, latent_code, fns, draws)


def _render_rays(model, settings, ray_origins, ray_directions, near, far,
                 driving_or_audio, pose, generator, background_prior,
                 latent_code, fns, draws) -> RayRenderResult:
    num_rays = ray_origins.shape[0]
    dtype = ray_origins.dtype
    dev = ray_origins.device
    if fns is None:
        fns = nerface.make_render_fns(
            model, driving_or_audio, pose, latent_code=latent_code,
            use_pallas=settings.use_pallas,
            compute_dtype=settings.compute_dtype)
    level_fn = fns.level_fn if settings.fuse_composite else None
    reuse = (fns.front_fn is not None and level_fn is None
             and settings.num_fine > 0 and model.fine is not None)

    nearv = torch.full((num_rays,), near, dtype=dtype, device=dev)
    farv = torch.full((num_rays,), far, dtype=dtype, device=dev)

    def noise_for(shape, injected):
        if settings.radiance_field_noise_std <= 0:
            return None
        if injected is None:
            injected = torch.randn(shape, generator=generator, dtype=dtype,
                                   device=dev)
        return injected * settings.radiance_field_noise_std

    def points(z_vals):
        # one float32 expression for every level and every sample set
        return (ray_origins[:, None, :]
                + ray_directions[:, None, :] * z_vals[..., None]).reshape(-1, 3)

    def run_level(level, z_vals, injected_noise, raw=None):
        S = z_vals.shape[-1]
        noise = noise_for(z_vals.shape, injected_noise)
        if (raw is None and level_fn is not None
                and nerface.level_kernel_compatible(S)):
            # front half -> K5: MLP and compositing in the kernel, per-ray
            # outputs; disp/acc/depth are the same (R, S) reductions as the
            # oracle's
            rgb_map, weights = level_fn(level, points(z_vals), ray_directions,
                                        S, z_vals, background_prior, noise)
            with profiling.span("serve.reduce"):
                rgb = rgb_map[:, :15]
                depth = torch.sum(weights * z_vals, dim=-1)
                acc = torch.sum(weights, dim=-1)
                disp = 1.0 / torch.clamp(depth / acc, min=1e-10)
                if settings.white_background:
                    rgb = rgb + (1.0 - acc[..., None])
            return RenderOutputs(rgb, disp, acc, weights, depth)
        if raw is None:
            raw = fns.field_fn(level, points(z_vals), ray_directions, S)
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

    with torch.no_grad(), profiling.span("serve.z"):
        z_coarse = coarse_z_vals(nearv, farv, settings.num_coarse,
                                 lindisp=settings.lindisp,
                                 perturb=settings.perturb,
                                 generator=generator, t_rand=draws.t_rand)
    Sc = z_coarse.shape[-1]
    fh_coarse = None
    if reuse:
        fh_coarse = fns.front_fn(points(z_coarse), Sc)
        raw_c = fns.nerf_fn("coarse", fh_coarse, ray_directions, Sc)
        coarse = run_level("coarse", z_coarse, draws.noise_coarse,
                           raw=raw_c.reshape(num_rays, Sc, -1))
    else:
        coarse = run_level("coarse", z_coarse, draws.noise_coarse)
    if settings.num_fine <= 0 or model.fine is None:
        return RayRenderResult(coarse.rgb, coarse.disp, coarse.acc,
                               None, None, None, coarse.weights, None)
    with torch.no_grad(), profiling.span("serve.importance"):
        z_mid = 0.5 * (z_coarse[..., 1:] + z_coarse[..., :-1])
        z_samples = sample_pdf(z_mid, coarse.weights[..., 1:-1].detach(),
                               settings.num_fine, det=(not settings.perturb),
                               generator=generator, u=draws.u)
    if reuse:
        Sn = z_samples.shape[-1]
        S = Sc + Sn
        fh_new = fns.front_fn(points(z_samples), Sn)
        fh_fine = tuple(
            None if c is None else   # no rows without a grid
            torch.cat([c.reshape(num_rays, Sc, -1), n.reshape(num_rays, Sn, -1)],
                      dim=1).reshape(num_rays * S, -1)
            for c, n in zip(fh_coarse, fh_new))
        raw_f = fns.nerf_fn("fine", fh_fine, ray_directions, S)
        with profiling.span("serve.merge"):
            z_fine, perm = torch.sort(torch.cat([z_coarse, z_samples], dim=-1),
                                      dim=-1, stable=True)
            raw_sorted = permute_samples(raw_f.reshape(num_rays, S, -1), perm)
        fine = run_level("fine", z_fine, draws.noise_fine, raw=raw_sorted)
    else:
        with profiling.span("serve.merge"):
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
                        chunksize: Optional[int] = None,
                        ray_group=None) -> RayRenderResult:
    """Full-bundle rendering as a Python loop over ray chunks (the JAX
    package's lax.map; the reference's get_minibatches loop,
    train_utils.py:274-295). The per-frame evaluators are built once.

    ``ray_group`` (parallel/mesh.RayGroup; the JAX package's
    ``ray_constraint``, pipeline.py:278-305): each rank renders its
    contiguous block of every chunk and the per-ray outputs are gathered,
    so every rank returns the whole frame. Every rank draws the chunk's
    random draws at its full width from the same generator state, as the
    single render draws them, and keeps its block; a chunk whose rays do
    not divide by the world size is padded with copies of its last ray,
    which are dropped after the gather."""
    chunksize = chunksize or settings.chunksize
    R = ray_origins.shape[0]
    outs = []
    with torch.no_grad():
        with profiling.phase("serve.cond"):
            fns = nerface.make_render_fns(
                model, driving_or_audio, pose, latent_code=latent_code,
                use_pallas=settings.use_pallas,
                compute_dtype=settings.compute_dtype)
        for start in range(0, R, chunksize):
            sl = slice(start, min(start + chunksize, R))
            bg = background_prior[sl] if background_prior is not None else None
            profiling.count("serve.chunks")
            with profiling.span("serve.chunk"):
                if ray_group is None:
                    outs.append(render_rays(model, settings, ray_origins[sl],
                                            ray_directions[sl], near, far,
                                            driving_or_audio, pose,
                                            generator=generator,
                                            background_prior=bg,
                                            latent_code=latent_code, fns=fns))
                else:
                    outs.append(_render_chunk_sharded(
                        model, settings, ray_origins[sl], ray_directions[sl], near,
                        far, driving_or_audio, pose, generator, bg, latent_code,
                        fns, ray_group))
        if fns.folded is not None:
            profiling.add("serve.fold", fns.folded.seconds)
    with profiling.span("serve.gather"):
        return RayRenderResult(*[
            None if parts[0] is None else torch.cat(parts, dim=0)
            for parts in zip(*outs)])


def full_draws(settings: RenderSettings, n: int, fine: bool, generator, device,
               given: Draws = Draws()) -> Draws:
    """The draws of one render_rays call over n rays (``fine``: it reaches
    a fine level), those not ``given`` taken from ``generator`` in the
    order and at the shapes render_rays takes them (coarse jitter, coarse
    sigma noise, importance uniforms, fine sigma noise), so that a block
    of the rays' rows of them is what the whole call would draw."""
    f32 = torch.float32
    Sc, Sn = settings.num_coarse, settings.num_fine
    noisy = settings.radiance_field_noise_std > 0

    def draw(have, make, shape, wanted):
        if have is not None or not wanted:
            return have
        return make(shape, generator=generator, dtype=f32, device=device)

    t_rand = draw(given.t_rand, torch.rand, (n, Sc), settings.perturb)
    nc = draw(given.noise_coarse, torch.randn, (n, Sc), noisy)
    fine = fine and Sn > 0
    u = draw(given.u, torch.rand, (n, Sn), fine and settings.perturb)
    nf = draw(given.noise_fine, torch.randn, (n, Sc + Sn), fine and noisy)
    return Draws(t_rand, u, nc, nf)


def _render_chunk_sharded(model, settings, ro, rd, near, far, driving, pose,
                          generator, bg, latent_code, fns, ray_group):
    n = ro.shape[0]
    fine = settings.num_fine > 0 and model.fine is not None
    draws = full_draws(settings, n, fine, generator, ro.device)
    padded = -(-n // ray_group.world) * ray_group.world

    def cut(x):
        if x is None:
            return None
        if padded > n:
            x = torch.cat([x, x[-1:].expand((padded - n,) + tuple(x.shape[1:]))])
        return x[ray_group.block(padded)]

    res = render_rays(model, settings, cut(ro), cut(rd), near, far, driving,
                      pose, generator=None, background_prior=cut(bg),
                      latent_code=latent_code, fns=fns,
                      draws=Draws(*(cut(d) for d in draws)))
    # one gather of every per-ray output, packed along the channels
    fields = [None if x is None else x.reshape(x.shape[0], -1).to(torch.float32)
              for x in res]
    widths = [0 if x is None else x.shape[1] for x in fields]
    flat = ray_group.all_gather_rows(torch.cat([x for x in fields if x is not None],
                                               dim=1))[:n]
    parts = iter(flat.split([w for w in widths if w], dim=1))
    out = []
    for x in res:
        if x is None:
            out.append(None)
            continue
        y = next(parts)
        out.append(y.reshape((n,) + tuple(x.shape[1:])).to(x.dtype))
    return RayRenderResult(*out)


def render_image(model: NeRFaceModel, settings: RenderSettings, H: int, W: int,
                 intrinsics: torch.Tensor, pose: torch.Tensor, near: float,
                 far: float, driving_or_audio: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 background: Optional[torch.Tensor] = None,
                 latent_code: Optional[torch.Tensor] = None,
                 chunksize: Optional[int] = None,
                 ray_group=None) -> Dict[str, Any]:
    """Full-image render (the reference's mode='validation' path,
    train_utils.py:303-319). background: (H, W, 15) or None. ``ray_group``:
    each rank renders its block of every chunk (render_rays_chunked)."""
    from ..ops.rays import get_ray_bundle, ndc_rays
    with profiling.phase("serve.frame"):
        ro, rd = get_ray_bundle(H, W, intrinsics, pose)
        if settings.use_ndc:
            ro, rd = ndc_rays(H, W, intrinsics, 1.0, ro, rd)
        bg = (background.reshape(-1, background.shape[-1])
              if background is not None else None)
        res = render_rays_chunked(model, settings, ro.reshape(-1, 3),
                                  rd.reshape(-1, 3), near, far, driving_or_audio,
                                  pose, generator=generator, background_prior=bg,
                                  latent_code=latent_code, chunksize=chunksize,
                                  ray_group=ray_group)

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
