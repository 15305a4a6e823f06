"""Stage-II SPADE texture-refinement networks as NCHW ``nn.Module``s
(counterpart of ``sahs_tpu/models/spade.py``; reference
nerf-pytorch/nerf/_init_spade.py):
  - ResBlock / IdEncoder                   (:7-37, :185-203)
  - SPADELayer (instance norm, modulated by convs of a nearest-resized
    feature map)                           (:114-139)
  - SPADEBlock (2x spade -> lrelu -> SN-conv, a spade shortcut, optional
    down- or upsampling)                   (:235-280)
  - RefineNetwork (6 SPADE blocks 64-64-128-256-256-128-64, a 3-ch head)
                                           (:284-312)
  - Generator / Generator_audio            (:315-325, :359-373)
  - Discriminator (PatchGAN; every intermediate feature) (:375-412)

Parameters and buffers carry the JAX tree's leaf names (a conv's ``w`` and
``b``, batch norm's ``gamma``/``beta`` and ``mean``/``var``, spectral
norm's ``u`` and optional ``v``), so ``to_jax`` / ``from_jax`` map a
module onto the JAX package's (params, bufs) pytrees by name. Layouts
differ: a conv's ``w`` is torch's (O, I, kh, kw) here and HWIO there; a
conv transpose's is torch's (I, O, kh, kw) here and its
``transpose(2, 3, 1, 0)`` there; spectral norm's ``v`` is flattened as
(I, kh, kw) here and (kh, kw, I) there. Every forward takes ``train``
explicitly, as the JAX functions do: in train mode batch norm uses the
batch's statistics and updates its running ones (momentum 0.1, unbiased
variance), and spectral norm takes one power-iteration step and stores
the new ``u`` (and ``v`` where the module has one). The convolutions run
in ``F.conv2d`` (cuDNN on the card), as JAX runs them in ``lax.conv``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import resolve_device
from .fields import AudioNet, init_uniform_, leaky_relu

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1
_IN_EPS = 1e-5
_SN_EPS = 1e-12


# ---------------------------------------------------------------------------
# Primitives (functional, NCHW)
# ---------------------------------------------------------------------------

def conv2d(x, w, b, stride: int = 1, padding: int = 1):
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def conv2d_transpose(x, w, b, stride: int = 2, padding: int = 1,
                     output_padding: int = 1):
    """torch ConvTranspose2d(k=3, stride=2, padding=1, output_padding=1) on
    a (I, O, kh, kw) weight: H_out = (H-1)*s - 2p + k + output_padding = 2H."""
    return F.conv_transpose2d(x, w, b, stride=stride, padding=padding,
                              output_padding=output_padding)


def avg_pool2(x):
    return F.avg_pool2d(x, 2, 2)


def upsample_nearest2(x):
    n, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2).reshape(n, c, 2 * h, 2 * w)


def nearest_index(size: int, out: int, device=None) -> torch.Tensor:
    """The integer rule src = i * size // out (JAX's ``resize_nearest``).
    ``F.interpolate``'s float scale can pick another row at non-divisor
    ratios, so the index is built explicitly."""
    return torch.arange(out, device=device) * size // out


def resize_nearest(x, oh: int, ow: int):
    _, _, h, w = x.shape
    x = x.index_select(2, nearest_index(h, oh, x.device))
    return x.index_select(3, nearest_index(w, ow, x.device))


def instance_norm(x):
    return F.instance_norm(x, eps=_IN_EPS)


def lrelu(x, slope: float = 0.2):
    return leaky_relu(x, slope)


def _normalize(v):
    return v / (torch.linalg.vector_norm(v) + _SN_EPS)


def spectral_norm(w, u, v, train: bool):
    """torch.nn.utils.spectral_norm's weight with JAX's semantics (spade.py
    :124-153): W is w viewed as (O, fan_in). train: one power-iteration
    step, v = norm(W^T u), u' = norm(W v), sigma = u' . (W v), with the
    gradient taken THROUGH v and u' (only the stored u is a constant);
    eval: sigma = v . (W^T u) with the stored u, and the stored v where
    there is one, else v = norm(W^T u). Returns (w / sigma, u', v'); in
    eval u' = u and v' = v."""
    wm = w.reshape(w.shape[0], -1)
    if train:
        v_new = _normalize(wm.t() @ u)
        u_used = _normalize(wm @ v_new)
        sigma = torch.dot(v_new, wm.t() @ u_used)
        return w / sigma, u_used.detach(), v_new.detach()
    v_used = v if v is not None else _normalize(wm.t() @ u)
    sigma = torch.dot(v_used, wm.t() @ u)
    return w / sigma, u, v


# ---------------------------------------------------------------------------
# Layers with the JAX tree's leaf names
# ---------------------------------------------------------------------------

class Conv(nn.Module):
    """A conv's weight ``w`` (O, I, k, k) and bias ``b``."""

    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.w = nn.Parameter(torch.empty(cout, cin, k, k))
        self.b = nn.Parameter(torch.empty(cout))

    def forward(self, x, stride: int = 1, padding: int = 1):
        return conv2d(x, self.w, self.b, stride, padding)


class ConvT(nn.Module):
    """A 3x3 stride-2 conv transpose: ``w`` in torch's (I, O, k, k)."""

    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.w = nn.Parameter(torch.empty(cin, cout, k, k))
        self.b = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return conv2d_transpose(x, self.w, self.b)


class SNConv(Conv):
    """A spectral-normalised conv: ``u`` (O,) always; ``v`` (I*k*k,) only
    where a checkpoint brought one (reference torch checkpoints do; JAX's
    init stores only ``u``)."""

    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__(cin, cout, k)
        self.register_buffer("u", torch.empty(cout))
        self.register_buffer("v", None)

    def forward(self, x, train: bool, stride: int = 1, padding: int = 1):
        w, u, v = spectral_norm(self.w, self.u, self.v, train)
        if train:
            # replaced, not written in place: the old u is saved for backward
            self.u = u
            if self.v is not None:
                self.v = v
        return conv2d(x, w, self.b, stride, padding)


class BatchNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x, train: bool):
        return F.batch_norm(x, self.mean, self.var, self.gamma, self.beta,
                            training=train, momentum=_BN_MOMENTUM, eps=_BN_EPS)


# ---------------------------------------------------------------------------
# ResBlock / IdEncoder (reference _init_spade.py:7-37,185-203)
# ---------------------------------------------------------------------------

class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, downsample: bool = False):
        super().__init__()
        self.downsample = downsample
        self.initial = Conv(cin, cout)
        self.bn1 = BatchNorm(cout)
        if downsample:
            self.down_id = Conv(cin, cout)
            self.down_res = Conv(cout, cout)
        else:
            self.residual = Conv(cout, cout)
            self.bn2 = BatchNorm(cout)

    def forward(self, x, train: bool):
        out = F.relu(self.bn1(self.initial(x), train))
        if self.downsample:
            return self.down_res(out, stride=2) + self.down_id(x, stride=2)
        out = F.relu(self.bn2(self.residual(out), train))
        return out + x


class IdEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = Conv(3, 64)
        self.l2 = ResBlock(64, 64)
        self.l3 = ResBlock(64, 128, downsample=True)
        self.l4 = ResBlock(128, 256, downsample=True)

    def forward(self, x, train: bool):
        x = avg_pool2(self.stem(x))
        x1 = self.l2(x, train)
        x2 = self.l3(x1, train)
        return x1, x2, self.l4(x2, train)


# ---------------------------------------------------------------------------
# SPADE layers / blocks (reference _init_spade.py:114-139,235-280)
# ---------------------------------------------------------------------------

class AudioMap:
    """Generator_audio's third feature map without its bulk. The reference
    repeats the (1, 64) audio features into a (1, 256, 64, 64*64) map
    (_init_spade.py:369-371): [0, c, h, w] = feat[w % 64], 268 MB a frame
    in float32. The SPADE layers only ever read it nearest-resized, so
    ``at`` builds the resized form from the index rule."""

    C, H, W = 256, 64, 4096

    def __init__(self, feat: torch.Tensor):
        self.feat = feat                    # (1, 64)

    def at(self, oh: int, ow: int) -> torch.Tensor:
        cols = nearest_index(self.W, ow, self.feat.device) % self.feat.shape[1]
        row = self.feat[0].index_select(0, cols)
        return row.view(1, 1, 1, ow).expand(1, self.C, oh, ow)


def _fid_at(fid, oh: int, ow: int):
    if isinstance(fid, AudioMap):
        return fid.at(oh, ow)
    return resize_nearest(fid, oh, ow)


class SPADELayer(nn.Module):
    def __init__(self, norm_nc: int, label_nc: int):
        super().__init__()
        self.shared = Conv(label_nc, 128)
        self.gamma = Conv(128, norm_nc)
        self.beta = Conv(128, norm_nc)

    def forward(self, x, fid):
        normalized = instance_norm(x)
        actv = F.relu(self.shared(_fid_at(fid, x.shape[2], x.shape[3])))
        return normalized * (1 + self.gamma(actv)) + self.beta(actv)


class SPADEBlock(nn.Module):
    def __init__(self, cin: int, cout: int, fid_c: int, downsample: bool = False,
                 upsample: bool = False):
        super().__init__()
        self.downsample, self.upsample = downsample, upsample
        self.spade1 = SPADELayer(cin, fid_c)
        self.conv1 = SNConv(cin, cout)
        self.spade2 = SPADELayer(cout, fid_c)
        self.conv2 = SNConv(cout, cout)
        self.spade_s = SPADELayer(cin, fid_c)
        self.conv_s = SNConv(cin, cout)
        if downsample:
            self.down_id = Conv(cin, cin)
        if upsample:
            self.up_id = ConvT(cin, cin)

    def forward(self, x, fid, train: bool):
        identity = x
        x1 = self.conv1(lrelu(self.spade1(x, fid)), train)
        if self.downsample:
            x1 = avg_pool2(x1)
            identity = self.down_id(identity, stride=2)
        if self.upsample:
            x1 = upsample_nearest2(x1)
            identity = self.up_id(identity)
        x2 = self.conv2(lrelu(self.spade2(x1, fid)), train)
        xs = self.conv_s(lrelu(self.spade_s(identity, fid)), train)
        return xs + x2


# ---------------------------------------------------------------------------
# RefineNetwork / Generators (reference _init_spade.py:284-373)
# ---------------------------------------------------------------------------

REFINE_LAYERS = [
    # (cin, cout, fid_idx, down, up)
    (64, 64, 0, True, False),
    (64, 128, 1, True, False),
    (128, 256, 2, False, False),
    (256, 256, 2, False, True),
    (256, 128, 1, False, True),
    (128, 64, 0, False, True),
]


class RefineNetwork(nn.Module):
    def __init__(self, fid_channels=(64, 128, 256)):
        super().__init__()
        self.stem = Conv(3, 64)
        self.blocks = nn.ModuleList(
            [SPADEBlock(cin, cout, fid_channels[fidx], down, up)
             for cin, cout, fidx, down, up in REFINE_LAYERS])
        self.head = Conv(64, 3)

    def forward(self, x, fids, train: bool):
        x = avg_pool2(self.stem(x))
        for block, (_, _, fidx, _, _) in zip(self.blocks, REFINE_LAYERS):
            x = block(x, fids[fidx], train)
        return self.head(x)


def audionet_conv_features(audnet: AudioNet, audio: torch.Tensor) -> torch.Tensor:
    """Generator_audio's AudioNet returns its 64-d conv features (its fc
    head is commented out, _init_spade.py:352-357): (16, 29) -> (1, 64)."""
    x = audio[None].transpose(1, 2)                 # (1, 29, 16), NCW
    for conv in audnet.convs:
        x = leaky_relu(conv(x), 0.02)
    return x[:, :, 0]


class Generator(nn.Module):
    """Generator (identity photo + Stage-I render), or Generator_audio
    with ``audio``: its third feature map is the AudioNet features'
    (``AudioMap``). ``audnet`` keeps its fc layers, unused, as the
    reference's and the JAX package's trees do."""

    def __init__(self, audio: bool = False):
        super().__init__()
        self.idenc = IdEncoder()
        self.refine = RefineNetwork()
        self.audnet = AudioNet() if audio else None

    @classmethod
    def init(cls, audio: bool = False, seed: int = 0, device=None) -> "Generator":
        """Seeded random weights (the JAX package's scheme: torch's conv
        default U(-1/sqrt(fan_in), 1/sqrt(fan_in)), unit spectral-norm u),
        drawn on the CPU from one generator, then moved to ``device``."""
        return _init(cls(audio), seed, device)

    def forward(self, i_src, i_raw, audio=None, train: bool = False):
        """i_src (identity photo), i_raw (Stage-I render): (N, 3, H, W);
        audio (16, 29) or None -> (N, 3, H, W)."""
        fids = self.idenc(i_src, train)
        if audio is not None and self.audnet is not None:
            fids = (fids[0], fids[1], AudioMap(audionet_conv_features(self.audnet, audio)))
        return self.refine(i_raw, fids, train)


# ---------------------------------------------------------------------------
# PatchGAN discriminator (reference _init_spade.py:375-412)
# ---------------------------------------------------------------------------

class Discriminator(nn.Module):
    def __init__(self, style_size: int):
        super().__init__()
        chans = [(style_size + 3, 64), (64, 128), (128, 256), (256, 512)]
        self.convs = nn.ModuleList([SNConv(cin, cout, 4) for cin, cout in chans])
        self.final = SNConv(512, 1, 4)

    @classmethod
    def init(cls, style_size: int, seed: int = 0, device=None) -> "Discriminator":
        return _init(cls(style_size), seed, device)

    def forward(self, x, a, train: bool = False) -> List[torch.Tensor]:
        """The intermediate features (the reference returns y[1:]); x, a
        (N, C, H, W) concatenated on channels."""
        y = torch.cat([x, a], dim=1)
        feats = []
        for i, conv in enumerate(self.convs):
            y = conv(y, train, stride=2, padding=1)
            if i > 0:
                y = instance_norm(y)
            y = lrelu(y)
            feats.append(y)
        y2 = lrelu(instance_norm(y))
        feats.append(y2)
        feats.append(self.final(y2, train, stride=1, padding=0))
        return feats


def _init(module: nn.Module, seed: int, device) -> nn.Module:
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Conv, ConvT)):
                bound = 1.0 / math.sqrt(m.w[0].numel() if isinstance(m, Conv)
                                        else m.w.shape[0] * m.w[0, 0].numel())
                for p in (m.w, m.b):
                    p.copy_(torch.rand(p.shape, generator=gen) * (2 * bound) - bound)
            if isinstance(m, SNConv):
                m.u.copy_(_normalize(torch.randn(m.u.shape, generator=gen)))
            if isinstance(m, AudioNet):
                init_uniform_(m, gen)
    return module.to(dev)


# ---------------------------------------------------------------------------
# The JAX package's (params, bufs) pytrees
# ---------------------------------------------------------------------------

def _conv_to_jax(t: torch.Tensor) -> np.ndarray:
    # (O, I, kh, kw) -> HWIO; a conv transpose's (I, O, kh, kw) -> the
    # same permutation, (kh, kw, O, I) (JAX's conv_transpose kernel)
    return t.permute(2, 3, 1, 0).numpy()


def _conv_from_jax(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (3, 2, 0, 1))))


def _leaves(root: nn.Module):
    """(section, path, module, attribute, to_jax, from_jax) for every leaf
    of the JAX package's (params, bufs) trees of ``root``; to_jax / from_jax
    convert a CPU tensor / numpy array between the two layouts."""
    same = (lambda t: t.numpy(), lambda a: torch.from_numpy(np.array(a, np.float32)))
    conv = (_conv_to_jax, _conv_from_jax)
    out = []
    for name, m in root.named_modules():
        path = tuple(name.split(".")) if name else ()
        if isinstance(m, (Conv, ConvT)):
            out += [("params", path + ("w",), m, "w") + conv,
                    ("params", path + ("b",), m, "b") + same]
            if isinstance(m, SNConv):
                out.append(("bufs", path + ("u",), m, "u") + same)
                if m.v is not None:
                    ikk = (m.w.shape[1],) + tuple(m.w.shape[2:])
                    # torch flattens v as (I, kh, kw), JAX as (kh, kw, I)
                    out.append(("bufs", path + ("v",), m, "v",
                                lambda t, s=ikk: t.reshape(s).permute(1, 2, 0).reshape(-1).numpy(),
                                lambda a, s=ikk: torch.from_numpy(np.ascontiguousarray(
                                    np.asarray(a, np.float32).reshape(s[1], s[2], s[0])
                                    .transpose(2, 0, 1).reshape(-1)))))
        elif isinstance(m, BatchNorm):
            out += [("params", path + (k,), m, k) + same for k in ("gamma", "beta")]
            out += [("bufs", path + (k,), m, k) + same for k in ("mean", "var")]
        elif isinstance(m, nn.Conv1d):
            # (O, I, k) <-> JAX's (k, I, O)
            out += [("params", path + ("w",), m, "weight", lambda t: t.permute(2, 1, 0).numpy(),
                     lambda a: torch.from_numpy(np.ascontiguousarray(np.transpose(a, (2, 1, 0))))),
                    ("params", path + ("b",), m, "bias") + same]
        elif isinstance(m, nn.Linear):
            out += [("params", path + ("w",), m, "weight", lambda t: t.t().numpy(),
                     lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a).T))),
                    ("params", path + ("b",), m, "bias") + same]
    return out


def _tree(flat: Dict[Tuple[str, ...], np.ndarray]):
    """Nested dicts from path tuples; a dict whose keys are all digits
    becomes a list (``utils/checkpoint.unflatten_params``'s rule)."""
    from ..utils.checkpoint import unflatten_params
    return unflatten_params({"t|" + "/".join(p): v for p, v in flat.items()}, prefix="t")


def _lookup(tree, path):
    for p in path:
        tree = tree[int(p)] if isinstance(tree, (list, tuple)) else tree[p]
    return tree


def to_jax(module: nn.Module, section: str = "params", get=None):
    """The JAX package's ``section`` tree ("params" or "bufs") of
    ``module``, numpy leaves in its layouts. ``get`` maps each parameter
    to the tensor taken (default: itself; e.g. its gradient or an Adam
    moment)."""
    flat = {}
    for sec, path, m, attr, fwd, _ in _leaves(module):
        if sec == section:
            t = getattr(m, attr)
            if get is not None:
                t = get(t)
            flat[path] = fwd(t.detach().cpu())
    return _tree(flat)


def param_map(module: nn.Module, tree) -> Dict[torch.Tensor, torch.Tensor]:
    """Each parameter of ``module`` -> its leaf of ``tree`` (a JAX-layout
    params tree, e.g. an Adam moment's; numpy or CPU tensor leaves) in the
    parameter's own layout, device and type."""
    out = {}
    for sec, path, m, attr, _, back in _leaves(module):
        if sec == "params":
            out[getattr(m, attr)] = _converted(tree, path, m, attr, back)
    return out


def _converted(tree, path, m, attr, back) -> torch.Tensor:
    leaf = _lookup(tree, path)
    if torch.is_tensor(leaf):
        leaf = leaf.float().numpy()
    t = getattr(m, attr)
    val = back(leaf).to(device=t.device, dtype=t.dtype)
    if tuple(val.shape) != tuple(t.shape):
        raise ValueError(f"{'/'.join(path)}: shape {tuple(val.shape)}, "
                         f"the module's {tuple(t.shape)}")
    return val


def from_jax(module: nn.Module, params, bufs=None) -> nn.Module:
    """Load the JAX package's (params, bufs) trees (numpy or CPU tensor
    leaves) into ``module`` in place. A spectral-norm module takes the
    ``v`` of ``bufs`` where there is one and drops its own otherwise."""
    if bufs is not None:
        for m_path, m in module.named_modules():
            if isinstance(m, SNConv):
                has_v = "v" in _lookup(bufs, tuple(m_path.split(".")) if m_path else ())
                m.v = torch.zeros(m.w[0].numel(), device=m.w.device) if has_v else None
    trees = {"params": params, "bufs": bufs}
    with torch.no_grad():
        for sec, path, m, attr, _, back in _leaves(module):
            if trees[sec] is not None:
                getattr(m, attr).copy_(_converted(trees[sec], path, m, attr, back))
    return module
