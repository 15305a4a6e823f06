"""The port's CUDA kernels on the card: K1 (deform pair) and K5 (NeRF level)
against their plain versions, and the kernel path of render_rays against
the plain path. Marked ``cuda``; without a CUDA device they skip. This file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances: float32 within 1e-4 absolute (the kernels sum in another order
than cuBLAS) and corner rows exact; bfloat16 within 2e-2 relative, the bf16
gate of PARITY_TPU.json (the two sides round the same operands to bf16 but
sum them in another order, so a value rounds differently now and then).
"""
import numpy as np
import pytest
import torch

from sahs_tpu_torch.config import Config
from sahs_tpu_torch.models import nerface
from sahs_tpu_torch.ops.grid import _cell_geometry, pack_corner_table
from sahs_tpu_torch.ops.kernels import deform_pair as k1
from sahs_tpu_torch.ops.kernels import nerf_level as k5
from sahs_tpu_torch.render.pipeline import RenderSettings, render_rays

GRID = (32, 32, 32)


@pytest.fixture(scope="module")
def card():
    """The flagship model with seeded weights on the card, its per-frame
    folded weights, and a numpy random state for the inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    spec = nerface.ModelSpec.from_config(Config())
    model = nerface.NeRFaceModel.init(spec, seed=0, device=dev)
    with torch.no_grad():
        model.coarse.fc_alpha.bias.fill_(0.5)   # sigma active
    rng = np.random.RandomState(0)
    cond = torch.tensor(rng.randn(76 + 36).astype(np.float32) * 0.5, device=dev)
    warp_g, pts_g, dir_g = nerface.build_pe_groups(spec)
    pair = k1.prepare_pair(model.warp, model.hyper, cond, warp_g)
    level = k5.prepare_level(model.coarse, cond[76:], pts_g, dir_g)
    yield dev, model, pair, level, rng
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32


def _gpu(dev, a):
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def _rel(a, b):
    """max |a - b| / (|b| + 1e-3), the metric of PARITY_TPU.json."""
    return float(((a.double() - b.double()).abs() / (b.double().abs() + 1e-3)).max())


def _scaled(a, b):
    """max |a - b| / max |b|, for outputs that pass through zero."""
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [16, 128])
def test_deform_pair_kernel_matches_plain(card, compute_dtype, S):
    dev, _, pair, _, rng = card
    P = 300 * S                   # not a multiple of the 64-point tile
    pts = _gpu(dev, rng.uniform(-0.6, 0.6, (P, 3)))
    before = k1.deform_pair_forward.launches
    out_k, rows_k = k1.deform_pair_forward(pts, pair, compute_dtype, S, GRID)
    out_p, rows_p = k1.deform_pair_plain(pts, pair, compute_dtype, S, GRID)
    torch.cuda.synchronize()
    assert k1.deform_pair_forward.launches == before + 1
    assert out_k.shape == (P, 5) and rows_k.shape == (P // S, S)
    assert torch.isfinite(out_k).all()
    # the rows are _cell_geometry's of the kernel's own output, bit for bit
    rows_self, _, _ = _cell_geometry(out_k[:, :3], GRID)
    assert torch.equal(rows_k.reshape(-1).long(), rows_self)
    if compute_dtype == "float32":
        assert float((out_k - out_p).abs().max()) <= 1e-4
        assert torch.equal(rows_k, rows_p)
    else:
        assert _scaled(out_k, out_p) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,with_bg,with_noise", [
    (16, True, True), (16, False, False), (128, True, False), (64, False, True)])
def test_nerf_level_kernel_matches_plain(card, compute_dtype, S, with_bg,
                                         with_noise):
    dev, model, _, level, rng = card
    R = 96
    pts = _gpu(dev, np.concatenate([rng.uniform(-1.05, 1.05, (R * S, 3)),
                                    rng.uniform(-1, 1, (R * S, 2))], 1))
    dirs = _gpu(dev, rng.randn(R, 3) * 0.1 + [0, 0, -1])
    z = _gpu(dev, np.sort(rng.uniform(0.48, 1.08, (R, S)), axis=-1))
    bg = _gpu(dev, rng.rand(R, 15)) if with_bg else None
    noise = _gpu(dev, rng.randn(R, S) * 0.5) if with_noise else None
    dtype = torch.float32 if compute_dtype == "float32" else torch.bfloat16
    table = pack_corner_table(model.spatial_embeddings.detach(), dtype=dtype)
    rows, _, _ = _cell_geometry(pts, GRID)
    args = (pts, dirs, table, rows, z, bg, noise, level, compute_dtype, GRID)
    before = k5.nerf_level_forward.launches
    rgb_k, w_k = k5.nerf_level_forward(*args)
    rgb_p, w_p = k5.nerf_level_plain(*args)
    torch.cuda.synchronize()
    assert k5.nerf_level_forward.launches == before + 1
    assert rgb_k.shape == (R, 16) and w_k.shape == (R, S)
    assert torch.isfinite(rgb_k).all() and torch.isfinite(w_k).all()
    assert float(w_p.sum()) > 0.1 * R
    if compute_dtype == "float32":
        assert float((rgb_k - rgb_p).abs().max()) <= 1e-4
        assert float((w_k - w_p).abs().max()) <= 1e-4
    else:
        assert _rel(rgb_k, rgb_p) <= 2e-2
        assert _rel(w_k, w_p) <= 2e-2


@pytest.mark.cuda
def test_wrapper_refuses_weights_on_another_device(card):
    dev, _, pair, _, _ = card
    cpu_pair = k1.prepare_pair(*_cpu_nets(), torch.zeros(76 + 36),
                               pair.pe_groups)
    with pytest.raises(ValueError, match="weights are on"):
        k1.deform_pair_forward(torch.zeros((64, 3), device=dev), cpu_pair,
                               "float32", 64, GRID)


def _cpu_nets():
    spec = nerface.ModelSpec.from_config(Config())
    m = nerface.NeRFaceModel.init(spec, seed=0, device="cpu")
    return m.warp, m.hyper


@pytest.mark.cuda
def test_render_rays_kernel_path_matches_plain_path(card):
    """render_rays on the card, 64 + 64 samples, float32, deterministic:
    K1 + K5 against the plain path, which runs no kernel."""
    dev, model, _, _, rng = card
    R = 256
    ro = torch.zeros((R, 3), device=dev)
    rd = _gpu(dev, rng.randn(R, 3) * 0.05 + [0, 0, -1])
    audio = _gpu(dev, rng.randn(16, 29))
    pose = _gpu(dev, np.concatenate([np.linalg.qr(rng.randn(3, 3))[0],
                                     [[0.0], [0.0], [0.6]]], 1))
    bg = _gpu(dev, rng.rand(R, 15))
    out = {}
    launches = {}
    for use_kernels in (True, False):
        s = RenderSettings(num_coarse=64, num_fine=64, perturb=False,
                           use_pallas=use_kernels, compute_dtype="float32")
        before = (k1.deform_pair_forward.launches,
                  k5.nerf_level_forward.launches)
        out[use_kernels] = render_rays(model, s, ro, rd, 0.48, 1.08, audio,
                                       pose, background_prior=bg)
        launches[use_kernels] = (k1.deform_pair_forward.launches - before[0],
                                 k5.nerf_level_forward.launches - before[1])
    assert launches == {True: (2, 2), False: (0, 0)}
    k, p = out[True], out[False]
    assert torch.isfinite(k.rgb_fine).all()
    assert float((k.rgb_fine - p.rgb_fine).abs().max()) <= 1e-4
    assert float((k.weights - p.weights).abs().max()) <= 1e-4
    torch.testing.assert_close(k.disp_fine, p.disp_fine, rtol=1e-3, atol=0)
