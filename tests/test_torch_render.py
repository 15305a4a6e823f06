"""The PyTorch port's render slice against the JAX package.

Whole-slice parity: the port's render_rays (plain path and kernel path, the
kernels' plain versions on the CPU) against JAX render_rays with
use_pallas=True (Pallas in interpret mode), flagship widths, deterministic
or with the JAX draws injected. Plus the port's import and device rules.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sahs_tpu.config import Config
from sahs_tpu.models.nerface import ModelSpec
from sahs_tpu.render import pipeline as jpipe

from sahs_tpu_torch.config import Config as TConfig
from sahs_tpu_torch.models.nerface import ModelSpec as TModelSpec
from sahs_tpu_torch.models.nerface import NeRFaceModel
from sahs_tpu_torch.render import pipeline as tpipe
from sahs_tpu_torch.utils.weights import params_to_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def flagship():
    """Flagship Config() at full widths: the port's seeded weights, handed
    to JAX as its parameter tree."""
    spec = ModelSpec.from_config(Config())
    model = NeRFaceModel.init(TModelSpec.from_config(TConfig()), seed=0,
                              device="cpu")
    params = jax.tree.map(jnp.asarray, params_to_jax(model))
    rng = np.random.RandomState(0)
    R = 16
    rd = (rng.randn(R, 3) * 0.05 + np.array([0, 0, -1.0])).astype(np.float32)
    Rm = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
    inputs = dict(
        ro=np.zeros((R, 3), np.float32), rd=rd,
        audio=rng.randn(16, 29).astype(np.float32),
        pose=np.concatenate([Rm, np.array([[0], [0], [0.6]], np.float32)], 1),
        bg=rng.rand(R, 15).astype(np.float32))
    return spec, params, model, inputs


def _jax_render(spec, params, settings, x, key=None):
    return jpipe.render_rays(
        params, spec, settings, jnp.asarray(x["ro"]), jnp.asarray(x["rd"]),
        0.48, 1.08, jnp.asarray(x["audio"]), jnp.asarray(x["pose"]),
        key=key, background_prior=jnp.asarray(x["bg"]))


def _port_render(model, settings, x, draws=tpipe.Draws()):
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    return tpipe.render_rays(model, settings, t["ro"], t["rd"], 0.48, 1.08,
                             t["audio"], t["pose"], background_prior=t["bg"],
                             draws=draws)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_render_rays_matches_jax_pallas(flagship, use_kernels):
    """Port render_rays (kernel path: K1 + K5 plain versions; or the plain
    path) vs JAX render_rays on its Pallas path, f32, deterministic, bg
    prior, R=16, 8+8 samples."""
    spec, params, model, x = flagship
    base = dict(num_coarse=8, num_fine=8, perturb=False,
                radiance_field_noise_std=0.0)
    out_j = _jax_render(spec, params, jpipe.RenderSettings(
        **base, use_pallas=True, compute_dtype="float32"), x)
    out_t = _port_render(model, tpipe.RenderSettings(
        **base, use_pallas=use_kernels, compute_dtype="float32"), x)
    np.testing.assert_allclose(out_t.rgb_fine.numpy(),
                               np.asarray(out_j.rgb_fine), atol=1e-4)
    np.testing.assert_allclose(out_t.disp_fine.numpy(),
                               np.asarray(out_j.disp_fine), rtol=1e-3)
    np.testing.assert_allclose(out_t.rgb_coarse.numpy(),
                               np.asarray(out_j.rgb_coarse), atol=1e-4)
    np.testing.assert_allclose(out_t.weights.numpy(),
                               np.asarray(out_j.weights), atol=1e-4)


def test_render_rays_injected_draws_match_jax(flagship):
    """perturb=True and sigma noise: the JAX draws of render_rays'
    key split (pipeline.py:146) are handed to the port."""
    spec, params, model, x = flagship
    base = dict(num_coarse=8, num_fine=8, perturb=True,
                radiance_field_noise_std=0.5)
    key = jax.random.PRNGKey(3)
    out_j = _jax_render(spec, params, jpipe.RenderSettings(
        **base, use_pallas=True, compute_dtype="float32"), x, key=key)
    k = jax.random.split(key, 4)
    R = x["ro"].shape[0]
    draws = tpipe.Draws(
        t_rand=torch.tensor(np.asarray(jax.random.uniform(k[0], (R, 8)))),
        u=torch.tensor(np.asarray(jax.random.uniform(k[2], (R, 8)))),
        noise_coarse=torch.tensor(np.asarray(
            jax.random.normal(k[1], (R, 8)))),
        noise_fine=torch.tensor(np.asarray(
            jax.random.normal(k[3], (R, 16)))))
    out_t = _port_render(model, tpipe.RenderSettings(
        **base, use_pallas=True, compute_dtype="float32"), x, draws)
    np.testing.assert_allclose(out_t.rgb_fine.numpy(),
                               np.asarray(out_j.rgb_fine), atol=1e-4)
    np.testing.assert_allclose(out_t.disp_fine.numpy(),
                               np.asarray(out_j.disp_fine), rtol=1e-3)


def test_render_image_8x8_matches_jax(flagship):
    """Port render_image (chunked) vs JAX render_image on an 8x8 frame of
    the synthetic dataset, kernel path, f32, deterministic."""
    from sahs_tpu.data.synthetic import SyntheticFaceDataset
    spec, params, model, _ = flagship
    ds = SyntheticFaceDataset(kind="audio", num_frames=1, H=8, W=8)
    item = ds[0]
    base = dict(num_coarse=8, num_fine=8, perturb=False,
                radiance_field_noise_std=0.0, chunksize=24)
    out_j = jpipe.render_image(
        params, spec, jpipe.RenderSettings(**base, use_pallas=True,
                                           compute_dtype="float32"),
        8, 8, jnp.asarray(item["intrinsics"]), jnp.asarray(item["pose"]),
        0.2, 0.8, jnp.asarray(item["driving"]),
        background=jnp.asarray(ds.background()))
    out_t = tpipe.render_image(
        model, tpipe.RenderSettings(**base, use_pallas=True,
                                    compute_dtype="float32"),
        8, 8, torch.as_tensor(item["intrinsics"]),
        torch.as_tensor(item["pose"]), 0.2, 0.8,
        torch.as_tensor(item["driving"]),
        background=torch.as_tensor(ds.background()))
    assert out_t["rgb_fine"].shape == (8, 8, 15)
    assert torch.isfinite(out_t["rgb_fine"]).all()
    np.testing.assert_allclose(out_t["rgb_fine"].numpy(),
                               np.asarray(out_j["rgb_fine"]), atol=1e-4)
    np.testing.assert_allclose(out_t["disp_fine"].numpy(),
                               np.asarray(out_j["disp_fine"]), rtol=1e-3)


def test_eval_renderer_on_cpu_when_asked():
    """make_eval_renderer(device='cpu') renders a finite 4x4 frame."""
    from sahs_tpu_torch.data.synthetic import SyntheticFaceDataset
    from sahs_tpu_torch.evaluation import cast_to_image, make_eval_renderer
    cfg = TConfig()
    spec = TModelSpec.from_config(cfg)
    model = NeRFaceModel.init(spec, seed=1, device="cpu")
    ds = SyntheticFaceDataset(kind="audio", num_frames=1, H=4, W=4)
    settings = tpipe.RenderSettings(num_coarse=8, num_fine=8, perturb=True,
                                    use_pallas=True, compute_dtype="bfloat16")
    render = make_eval_renderer(spec, settings, 4, 4, 0.2, 0.8, device="cpu")
    item = ds[0]
    out = render(model, item["intrinsics"], item["pose"], item["driving"],
                 ds.background(), torch.Generator().manual_seed(0))
    assert out["rgb_fine"].shape == (4, 4, 15)
    assert out["weights"].shape == (16, 16)
    assert torch.isfinite(out["rgb_fine"]).all()
    assert cast_to_image(out["rgb_fine"][..., :3]).dtype == np.uint8


def test_entry_point_without_device_raises_when_cuda_absent(monkeypatch):
    """With no device given and no CUDA, the entry point raises instead of
    falling back to the CPU."""
    from sahs_tpu_torch.evaluation import make_eval_renderer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = TModelSpec.from_config(TConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_eval_renderer(spec, tpipe.RenderSettings(), 4, 4, 0.2, 0.8)


def test_model_init_without_device_raises_when_cuda_absent(monkeypatch):
    """NeRFaceModel.init puts the model on CUDA unless asked for another
    device: with no CUDA it raises, and with device='cpu' it builds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = TModelSpec.from_config(TConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NeRFaceModel.init(spec, seed=0)
    model = NeRFaceModel.init(spec, seed=0, device="cpu")
    assert model.spatial_embeddings.device.type == "cpu"


def test_port_imports_no_jax():
    """Importing every module of the port leaves no jax and no sahs_tpu
    module in sys.modules."""
    code = (
        "import pkgutil, importlib, sys, sahs_tpu_torch\n"
        "for m in pkgutil.walk_packages(sahs_tpu_torch.__path__, 'sahs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'sahs_tpu' or n.startswith('sahs_tpu.'))\n"
        "print(len([n for n in sys.modules if n.startswith('sahs_tpu_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) > 15
