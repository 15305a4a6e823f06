"""Stage-II SPADE texture-refinement training (counterpart of
``sahs_tpu/train/stage2.py``; reference
nerf-pytorch/train_get_texture_photo_audio.py:47-253 and the 3DMM variant
train_get_texture_photo.py): the Generator (audio or not) trained against
the ground-truth frames with Adam(betas=(beta1, beta2)) and a linear
learning-rate decay after ``epochs`` epochs. The shipped reference loop is
MSE only; the Discriminator and VGG it defines but never wires
(_init_spade.py:375-451) come in behind texture_refine.use_gan /
use_perceptual: hinge GAN, optional pix2pixHD feature matching, and the
SPADE-weighted VGG L1.

Images are (N, H, W, 3) tensors, as in the JAX package; the networks run
NCHW. Adam is torch's, stepped as optax's ``adam`` (``adam_step``): eps
1e-8 outside the square root, bias corrections at the incremented count,
the learning rate at the count before the update, and a missing gradient
a zero one. ``make_scan_step`` is a loop of K steps (the JAX package scans
them in one program), its metrics stacked on the device. ``train_step``
and ``infer`` run their convolutions in full float32 (``full_float32``),
as the JAX package does, whatever TF32 setting the process has.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config
from ..models import spade, vgg
from ..utils.device import full_float32, resolve_device


@dataclasses.dataclass(frozen=True)
class Stage2Settings:
    lr_G: float
    beta1: float
    beta2: float
    epochs: int
    epochs_decay: int
    steps_per_epoch: int
    audio: bool
    use_perceptual: bool = False
    perceptual_weight: float = 10.0
    use_gan: bool = False
    gan_weight: float = 1.0
    gan_feat_weight: float = 0.0
    lr_D: float = 1.0e-4
    scan_frames: int = 8

    @classmethod
    def from_config(cls, cfg: Config, steps_per_epoch: int) -> "Stage2Settings":
        tr = cfg.texture_refine
        return cls(lr_G=float(tr.lr_G), beta1=float(tr.beta1),
                   beta2=float(tr.beta2), epochs=int(tr.epochs),
                   epochs_decay=int(tr.epochs_decay),
                   steps_per_epoch=steps_per_epoch,
                   audio=cfg.dataset.type.lower() == "audio",
                   use_perceptual=bool(tr.use_perceptual),
                   perceptual_weight=float(tr.perceptual_weight),
                   use_gan=bool(tr.use_gan),
                   gan_weight=float(tr.gan_weight),
                   gan_feat_weight=float(tr.gan_feat_weight),
                   lr_D=float(tr.lr_D),
                   scan_frames=int(tr.scan_frames))


def _schedule(s: Stage2Settings, lr0: float) -> Callable[[int], np.float32]:
    """Linear decay to zero over the last ``epochs_decay`` epochs
    (reference train_get_texture_photo_audio.py:160-167), in float32 as
    the JAX package computes it."""
    total = (s.epochs + s.epochs_decay) * s.steps_per_epoch
    decay_start = s.epochs * s.steps_per_epoch

    def schedule(step: int) -> np.float32:
        frac = np.clip(np.float32(step - decay_start)
                       / np.float32(max(total - decay_start, 1)),
                       np.float32(0.0), np.float32(1.0))
        return np.float32(lr0) * (np.float32(1.0) - frac)

    return schedule


def make_adam(params, s: Stage2Settings) -> torch.optim.Adam:
    """torch's Adam with optax's ``adam(b1=beta1, b2=beta2)`` settings (eps
    1e-8 outside the square root in both); ``adam_step`` gives it the
    schedule's rate."""
    return torch.optim.Adam(params, lr=0.0, betas=(s.beta1, s.beta2), eps=1e-8)


def adam_count(opt: torch.optim.Adam) -> int:
    """Updates ``opt`` has made (optax's count)."""
    steps = [int(st["step"]) for st in opt.state.values() if "step" in st]
    return max(steps) if steps else 0


def adam_step(opt: torch.optim.Adam, schedule, grads) -> None:
    """One update of optax.adam(learning_rate=schedule): the rate is the
    schedule's at the count before the update, and a None gradient is a
    zero one (optax updates the moments of a parameter that had no
    gradient, and its count with the others')."""
    params = opt.param_groups[0]["params"]
    opt.param_groups[0]["lr"] = float(schedule(adam_count(opt)))
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    opt.step()
    opt.zero_grad(set_to_none=True)


@dataclasses.dataclass
class Stage2State:
    step: int
    generator: spade.Generator
    opt: torch.optim.Adam
    # the adversarial branch (None when use_gan is off)
    discriminator: Optional[spade.Discriminator] = None
    d_opt: Optional[torch.optim.Adam] = None


def init_stage2_state(s: Stage2Settings, seed: int = 0, device=None) -> Stage2State:
    """A fresh state on ``device`` (CUDA unless the caller names another;
    with no device given and no CUDA present this raises)."""
    dev = resolve_device(device)
    gen = spade.Generator.init(audio=s.audio, seed=seed, device=dev)
    state = Stage2State(0, gen, make_adam(gen.parameters(), s))
    if s.use_gan:
        # D(condition = the raw render (3 ch), image (3 ch)): style_size 3
        d = spade.Discriminator.init(style_size=3, seed=seed + 1, device=dev)
        state.discriminator, state.d_opt = d, make_adam(d.parameters(), s)
    return state


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def g_losses(s: Stage2Settings, state: Stage2State, i_src, i_raw, target, audio,
             vgg_net=None):
    """The generator's loss in train mode (its batch norms' and spectral
    norms' buffers are updated) -> (loss, fake (N, 3, H, W) clipped, aux)."""
    fake = state.generator(_nchw(i_src), _nchw(i_raw), audio, train=True)
    fake = torch.clamp(fake, 0.0, 1.0)
    tgt = _nchw(target)
    mse = torch.mean(torch.square(fake - tgt))
    loss = mse
    aux = {"mse": mse}
    if s.use_perceptual and vgg_net is not None:
        p_loss = vgg.perceptual_loss(vgg_net, fake, tgt)
        loss = loss + s.perceptual_weight * p_loss
        aux["perceptual"] = p_loss
    if s.use_gan:
        d = state.discriminator
        feats_f = d(_nchw(i_raw), fake, train=False)
        # hinge generator loss on the final logits map
        g_adv = -torch.mean(feats_f[-1])
        loss = loss + s.gan_weight * g_adv
        aux["g_adv"] = g_adv
        if s.gan_feat_weight > 0:
            with torch.no_grad():
                feats_r = d(_nchw(i_raw), tgt, train=False)
            fm = torch.zeros((), device=fake.device)
            for a, b in zip(feats_f[:-1], feats_r[:-1]):
                fm = fm + torch.mean(torch.abs(a - b))
            fm = fm / max(len(feats_f) - 1, 1)
            loss = loss + s.gan_feat_weight * fm
            aux["gan_feat"] = fm
    return loss, fake, aux


def d_loss(state: Stage2State, i_raw, target, fake_sg):
    """The discriminator's hinge loss in train mode: the real pass, then
    the fake one on the spectral norms' updated u."""
    d = state.discriminator
    feats_r = d(_nchw(i_raw), _nchw(target), train=True)
    feats_f = d(_nchw(i_raw), fake_sg, train=True)
    return (torch.mean(F.relu(1.0 - feats_r[-1]))
            + torch.mean(F.relu(1.0 + feats_f[-1])))


def _grads(loss, module):
    return torch.autograd.grad(loss, list(module.parameters()), allow_unused=True)


@full_float32()
def train_step(state: Stage2State, i_src, i_raw, target, audio, s: Stage2Settings,
               vgg_net=None) -> Tuple[Stage2State, Dict[str, torch.Tensor]]:
    """One step in place: i_src / i_raw / target (1, H, W, 3) on the
    state's device; audio (16, 29) or None. Returns (state, metrics)."""
    loss, fake, aux = g_losses(s, state, i_src, i_raw, target, audio, vgg_net)
    adam_step(state.opt, _schedule(s, s.lr_G), _grads(loss, state.generator))
    if s.use_gan:
        dl = d_loss(state, i_raw, target, fake.detach())
        adam_step(state.d_opt, _schedule(s, s.lr_D), _grads(dl, state.discriminator))
        aux["d_loss"] = dl
    state.step += 1
    metrics = {"loss": loss, "psnr": -10.0 * torch.log10(torch.clamp(aux["mse"], min=1e-10)),
               **aux}
    return state, {k: v.detach() for k, v in metrics.items()}


def make_train_step(s: Stage2Settings, vgg_net=None):
    def step(state, i_src, i_raw, target, audio=None):
        return train_step(state, i_src, i_raw, target, audio if s.audio else None, s,
                          vgg_net)
    return step


def make_scan_step(s: Stage2Settings, vgg_net=None):
    """K frames a call: stacked (K, 1, H, W, 3) raws and targets (and
    (K, 16, 29) audio) through K train steps in order; returns the state
    and the per-frame metrics stacked on the device."""
    def scan(state, i_src, raws, targets, auds=None):
        ms: Dict[str, List[torch.Tensor]] = {}
        for k in range(raws.shape[0]):
            aud = auds[k] if (s.audio and auds is not None) else None
            state, m = train_step(state, i_src, raws[k], targets[k], aud, s, vgg_net)
            for name, v in m.items():
                ms.setdefault(name, []).append(v)
        return state, {k: torch.stack(v) for k, v in ms.items()}
    return scan


def make_infer(s: Stage2Settings):
    """infer(generator, i_src, i_raw[, audio]) -> the refined (N, H, W, 3),
    clipped to [0, 1]; eval mode (running statistics, stored u and v)."""
    @torch.no_grad()
    @full_float32()
    def infer(generator, i_src, i_raw, audio=None):
        fake = generator(_nchw(i_src), _nchw(i_raw), audio if s.audio else None,
                         train=False)
        return torch.clamp(fake, 0.0, 1.0).permute(0, 2, 3, 1)
    return infer


def load_vgg_params(path: str, seed: int = 0, allow_random: bool = False,
                    device=None) -> vgg.VGG19Features:
    """The VGG weights of the perceptual loss, from a local file only: a
    torchvision vgg19 state_dict (.pth) or an .npz of the same keys, on
    ``device`` (the card unless the caller names one; without CUDA and
    without a device this raises, as every entry point does).

    An empty path raises unless ``allow_random``: a "perceptual" loss
    through random VGG features is noise with a learning rate, so it is an
    explicit opt-in (tests, architecture checks), never a silent fallback
    (the reference always uses pretrained VGG, _init_spade.py:415-451)."""
    device = resolve_device(device)
    if not path:
        if not allow_random:
            raise ValueError(
                "use_perceptual=True needs pretrained VGG weights: set "
                "texture_refine.vgg_weights to a vgg19 .pth/.npz (or pass "
                "allow_random=True for architecture-only runs)")
        print("WARNING: perceptual loss with RANDOM-init VGG (allow_random)")
        return vgg.vgg19_features_init(seed, device)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return vgg.import_torch_vgg_features(dict(z), device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return vgg.import_torch_vgg_features(sd, device)
