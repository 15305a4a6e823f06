"""The plain reference of SAHS's deformable NeRF: the field and the
hierarchical renderer in float32 PyTorch tensor operations, read from a
weight dict in the port's layout (shapes.py), with no kernel, cache or
folding.

It follows the reference repository (nerf-pytorch/nerf/models.py,
modules.py, train_utils.py, volume_rendering_utils.py, nerf_helpers.py)
with its quirks: the field sees the raw ray directions; the NeRF MLP's skip
is at layer 3 whatever the config says; the last sample of each level
carries the background prior's 15 channels in place of its colour; sigma
gets 1e-6 at the last sample; sample_pdf floors the weights at 1e-5 and
maps a CDF step under 1e-5 to 1.

``linear`` is the one place where a product is taken, so the control
(``precision.py``) swaps it for one with operands in a lower precision.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..shapes import Spec


@contextlib.contextmanager
def full_float32():
    """cuBLAS and cuDNN in full float32 (no TF32) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def plain_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.addmm(b, x, w.t())


def leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def pe(x: torch.Tensor, num_freqs: int, include_input: bool) -> torch.Tensor:
    """[x?, sin(f0 x), cos(f0 x), sin(f1 x), ...], f_k = 2^k."""
    parts = [x] if include_input else []
    for k in range(num_freqs):
        parts += [torch.sin(x * float(2.0 ** k)), torch.cos(x * float(2.0 ** k))]
    return torch.cat(parts, dim=-1) if parts else x[..., :0]


def encode_pose(pose: torch.Tensor) -> torch.Tensor:
    """(3, 4) camera-to-world -> (36,): PE(3) of [euler(3), translation(3)]
    with the reference's axis choices (models.py:482-504)."""
    R = pose[:3, :3]
    e = torch.stack([torch.atan2(R[2, 2], R[1, 2]), torch.asin(-R[0, 2]),
                     torch.atan2(R[0, 0], -R[0, 1])])
    return pe(torch.cat([e, pose[:3, 3]]), 3, False)


class Field:
    """The model's forward from raw weights. ``linear`` takes (x, w, b)."""

    def __init__(self, spec: Spec, weights: Dict[str, torch.Tensor],
                 linear: Callable = plain_linear):
        self.spec = spec
        self.w = weights
        self.linear = linear

    def lin(self, x, name):
        return self.linear(x, self.w[name + ".weight"], self.w[name + ".bias"])

    def driving(self, driving_or_audio: torch.Tensor) -> torch.Tensor:
        """AudioNet on the (16, 29) window (modules.py:43-73), or the code."""
        if not self.spec.audio:
            return driving_or_audio
        x = driving_or_audio[None].transpose(1, 2)
        for i in range(4):
            x = leaky(F.conv1d(x, self.w[f"audnet.convs.{i}.weight"],
                               self.w[f"audnet.convs.{i}.bias"], stride=2, padding=1), 0.02)
        x = leaky(self.lin(x[:, :, 0], "audnet.fc1"), 0.02)
        return self.lin(x, "audnet.fc2")[0]

    def trunk(self, name, net, x0, act):
        x = x0
        for i in range(len(net.layers)):
            if i == net.skip:
                x = torch.cat([x, x0], dim=-1)
            x = act(self.lin(x, f"{name}.trunk.layers.{i}"))
        return x

    def mapped(self, pts, driving, pose_enc):
        """(P, 3) points -> (P, 3 [+ ambient]) canonical hyper points."""
        s = self.spec
        if s.warp is None and s.hyper is None:
            return pts
        enc = pe(pts, s.xyz_freqs, True)
        cond = torch.cat(([driving] if s.deform_driving else []) + [pose_enc])
        x0 = torch.cat([enc, cond.expand(enc.shape[0], -1)], dim=-1)
        out = pts
        if s.warp is not None:
            h = self.trunk("warp", s.warp, x0, torch.relu)
            out = pts + torch.tanh(self.lin(h, "warp.out"))
        if s.hyper is not None:
            h = self.trunk("hyper", s.hyper, x0, torch.relu)
            out = torch.cat([out, self.lin(h, "hyper.out")], dim=-1)
        return out

    def raw(self, level, pts, dirs, driving, pose_enc):
        """(P, 3) points, (P, 3) raw directions -> (P, 16) rgb | seg | sigma."""
        s = self.spec
        nf = getattr(s, level)
        m = self.mapped(pts, driving, pose_enc)
        enc = pe(m[:, :3], s.nerf_xyz_freqs, s.nerf_include_xyz)
        if s.ambient_dim:
            enc = torch.cat([enc, pe(m[:, 3:], s.ambient_freqs, s.ambient_include)], dim=-1)
        cond = ([driving] if s.nerf_driving else []) + ([pose_enc] if s.nerf_pose else [])
        x0 = enc if not cond else torch.cat(
            [enc, torch.cat(cond).expand(enc.shape[0], -1)], dim=-1)
        act = lambda v: leaky(v, 0.01)
        h = self.trunk(level, nf.trunk, x0, act)
        feat = self.lin(h, f"{level}.fc_feat")
        alpha = self.lin(feat, f"{level}.fc_alpha")
        din = [feat, pe(dirs, s.dir_freqs, s.dir_include)]
        if nf.grid:
            g = self.w["spatial_embeddings"]
            se = F.grid_sample(g[None], m[:, :3].reshape(1, -1, 1, 1, 3), mode="bilinear",
                               padding_mode="zeros", align_corners=True)
            din.append(se.reshape(g.shape[0], -1).t())
        x = torch.cat(din, dim=-1)
        for i in range(4):
            x = act(self.lin(x, f"{level}.dir.{i}"))
        rgb = self.lin(x, f"{level}.fc_rgb")
        x = feat
        for i in range(4):
            x = act(self.lin(x, f"{level}.seg.{i}"))
        return torch.cat([rgb, self.lin(x, f"{level}.fc_seg"), alpha], dim=-1)


def composite(raw, z, rd, bg, noise):
    """volume_rendering_utils.py:7-78 with a background prior: raw (R, S,
    16) -> (rgb (R, 15), weights (R, S))."""
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rd, dim=-1)[:, None]
    col = torch.cat([torch.sigmoid(raw[:, :-1, :3]), torch.softmax(raw[:, :-1, 3:15], dim=-1)],
                    dim=-1)
    col = torch.cat([col, bg[:, None, :]], dim=1)
    sig = raw[..., 15] if noise is None else raw[..., 15] + noise
    sig = torch.relu(sig)
    sig = torch.cat([sig[:, :-1], sig[:, -1:] + 1e-6], dim=1)
    alpha = 1.0 - torch.exp(-sig * dists)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    weights = alpha * trans
    return torch.sum(weights[..., None] * col, dim=1), weights


def coarse_z(near, far, R, S, t_rand):
    t = torch.linspace(0.0, 1.0, S, device=t_rand.device)
    z = (near * (1.0 - t) + far * t).expand(R, S)
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], dim=-1)
    lower = torch.cat([z[:, :1], mids], dim=-1)
    return lower + (upper - lower) * t_rand


def sample_pdf(bins, weights, u):
    """Inverse-CDF importance samples (nerf_helpers.py:454-497)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, dim=-1)], dim=-1)
    B = cdf.shape[-1]
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=B - 1)
    c0, c1 = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    b0, b1 = torch.gather(bins, 1, below), torch.gather(bins, 1, above)
    denom = c1 - c0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return b0 + (u - c0) / denom * (b1 - b0)


def render_rays(field: Field, ro, rd, near, far, driving, pose_enc, bg, t_rand, u,
                noise_c: Optional[torch.Tensor] = None,
                noise_f: Optional[torch.Tensor] = None):
    """Both levels of a batch of rays: (rgb_coarse (R, 15), rgb_fine (R,
    15), fine weights (R, Sc + Sf)). ``noise_*``: sigma noise already
    scaled by its standard deviation, or None."""
    R, Sc = t_rand.shape

    def level(name, z, noise):
        S = z.shape[1]
        pts = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3)
        dirs = rd[:, None, :].expand(R, S, 3).reshape(-1, 3)
        raw = field.raw(name, pts, dirs, driving, pose_enc).reshape(R, S, -1)
        return composite(raw, z, rd, bg, noise)

    zc = coarse_z(near, far, R, Sc, t_rand)
    rgb_c, w_c = level("coarse", zc, noise_c)
    zs = sample_pdf(0.5 * (zc[:, 1:] + zc[:, :-1]), w_c[:, 1:-1].detach(), u).detach()
    zf = torch.sort(torch.cat([zc, zs], dim=-1), dim=-1, stable=True).values
    rgb_f, w_f = level("fine", zf, noise_f)
    return rgb_c, rgb_f, w_f


def ray_bundle(H, W, intr, pose, idx=None):
    """Rays (N, 3) at the flat pixel indices ``idx`` (all pixels if None),
    row-major; directions not normalised (nerf_helpers.py:178-233)."""
    dev = pose.device
    if idx is None:
        idx = torch.arange(H * W, device=dev)
    ii = (idx % W).to(torch.float32)
    jj = torch.div(idx, W, rounding_mode="floor").to(torch.float32)
    d = torch.stack([(ii - W * intr[2]) / intr[0], -(jj - H * intr[3]) / intr[1],
                     -torch.ones_like(ii)], dim=-1)
    rd = torch.sum(d[:, None, :] * pose[:3, :3], dim=-1)
    return pose[:3, 3].expand(rd.shape), rd
