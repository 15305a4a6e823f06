"""The PyTorch port's ops against the JAX package, at float32.

Inputs come from a numpy seed and go through both functions; random draws
are made by JAX and handed to the port.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sahs_tpu.ops import encoding as jenc
from sahs_tpu.ops import grid as jgrid
from sahs_tpu.ops import rays as jrays
from sahs_tpu.ops import rendering as jrend
from sahs_tpu.ops import sampling as jsamp

from sahs_tpu_torch.ops import encoding as tenc
from sahs_tpu_torch.ops import grid as tgrid
from sahs_tpu_torch.ops import rays as trays
from sahs_tpu_torch.ops import rendering as trend
from sahs_tpu_torch.ops import sampling as tsamp

torch.set_num_threads(2)

ATOL = 1e-6


def _close(t, j, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("nf,inc,log", [(10, True, True), (4, True, True),
                                        (3, False, True), (4, True, False)])
def test_positional_encoding(nf, inc, log):
    x = np.random.RandomState(0).uniform(-1.2, 1.2, (50, 3)).astype(np.float32)
    out_j = jenc.positional_encoding(jnp.asarray(x), nf, inc, log)
    out_t = tenc.positional_encoding(torch.as_tensor(x), nf, inc, log)
    assert out_t.shape[-1] == tenc.encoded_dim(3, nf, inc)
    # |x * 2^9| reaches ~600: sin/cos of the two libraries agree to a few ulp
    # of the angle
    _close(out_t, out_j, atol=2e-5 if nf == 10 else ATOL)


def test_ray_bundle_and_pose():
    rng = np.random.RandomState(1)
    Rm = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
    c2w = np.concatenate([Rm, rng.randn(3, 1).astype(np.float32)], 1)
    intr = np.array([40.0, 41.0, 0.5, 0.45], np.float32)
    oj, dj = jrays.get_ray_bundle(6, 5, jnp.asarray(intr), jnp.asarray(c2w))
    ot, dt = trays.get_ray_bundle(6, 5, torch.as_tensor(intr), torch.as_tensor(c2w))
    _close(ot, oj)
    _close(dt, dj)
    poses = np.stack([c2w, c2w * 0.9]).astype(np.float32)
    _close(trays.pose_to_euler_trans(torch.as_tensor(poses)),
           jrays.pose_to_euler_trans(jnp.asarray(poses)), atol=1e-5)
    no_j, nd_j = jrays.ndc_rays(6, 5, (40.0, 41.0), 1.0, oj, dj)
    no_t, nd_t = trays.ndc_rays(6, 5, (40.0, 41.0), 1.0, ot, dt)
    _close(no_t, no_j, atol=1e-5, rtol=1e-5)
    _close(nd_t, nd_j, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("lindisp,perturb", [(False, False), (False, True),
                                             (True, True)])
def test_coarse_z_vals(lindisp, perturb):
    R, N = 7, 16
    near = np.full((R,), 0.48, np.float32)
    far = np.full((R,), 1.08, np.float32)
    key = jax.random.PRNGKey(2)
    zj = jsamp.coarse_z_vals(jnp.asarray(near), jnp.asarray(far), N,
                             lindisp=lindisp, perturb=perturb, key=key)
    t_rand = torch.tensor(np.asarray(jax.random.uniform(key, (R, N))))
    zt = tsamp.coarse_z_vals(torch.as_tensor(near), torch.as_tensor(far), N,
                             lindisp=lindisp, perturb=perturb, t_rand=t_rand)
    _close(zt, zj)


@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf_and_merge(det):
    rng = np.random.RandomState(3)
    R, B, N = 9, 16, 12
    z = np.sort(rng.uniform(0.4, 1.1, (R, B + 1)).astype(np.float32), axis=-1)
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    w = rng.rand(R, B - 1).astype(np.float32)
    w[0] = 0.0                  # an all-zero row: the 1e-5 floor and clamp
    w[1, 3] = 50.0              # a spike: most samples in one bin
    key = jax.random.PRNGKey(4)
    sj = jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), N, det=det, key=key)
    u = None if det else torch.tensor(np.asarray(jax.random.uniform(key, (R, N))))
    st = tsamp.sample_pdf(torch.as_tensor(bins), torch.as_tensor(w), N, det=det,
                          u=u)
    _close(st, sj, atol=2e-6)
    mj = jsamp.merge_z_vals(jnp.asarray(z[:, :8]), sj)
    mt = tsamp.merge_z_vals(torch.as_tensor(z[:, :8]), st)
    _close(mt, mj, atol=2e-6)


@pytest.mark.parametrize("with_bg,noise_std", [(True, 0.0), (False, 0.0),
                                               (True, 0.3)])
def test_volume_render(with_bg, noise_std):
    rng = np.random.RandomState(5)
    R, S = 6, 10
    raw = rng.randn(R, S, 16).astype(np.float32)
    raw[0, :, -1] = 200.0        # saturated alpha = 1: no NaN
    z = np.sort(rng.uniform(0.4, 1.1, (R, S)).astype(np.float32), axis=-1)
    d = rng.randn(R, 3).astype(np.float32)
    bg = rng.rand(R, 15).astype(np.float32) if with_bg else None
    key = jax.random.PRNGKey(6)
    oj = jrend.volume_render_radiance_field(
        jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d),
        radiance_field_noise_std=noise_std,
        background_prior=None if bg is None else jnp.asarray(bg), noise_key=key)
    noise = torch.tensor(np.asarray(jax.random.normal(key, (R, S))))
    ot = trend.volume_render_radiance_field(
        torch.as_tensor(raw), torch.as_tensor(z), torch.as_tensor(d),
        radiance_field_noise_std=noise_std,
        background_prior=None if bg is None else torch.as_tensor(bg),
        noise=noise)
    for a, b in zip(ot, oj):
        assert torch.isfinite(a).all()
        _close(a, b, atol=1e-5, rtol=1e-5)


def test_pack_corner_table():
    g = np.random.RandomState(7).randn(4, 3, 5, 6).astype(np.float32)
    tj = jgrid.pack_corner_table(jnp.asarray(g))
    tt = tgrid.pack_corner_table(torch.as_tensor(g))
    assert tt.shape == (4 * 6 * 7, 32)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    tb = tgrid.pack_corner_table(torch.as_tensor(g), dtype=torch.bfloat16)
    tjb = jgrid.pack_corner_table(jnp.asarray(g), gather_dtype=jnp.bfloat16)
    np.testing.assert_array_equal(tb.float().numpy(),
                                  np.asarray(tjb.astype(jnp.float32)))


def _boundary_coords(rng, n, dims):
    """Random coords plus exact cell boundaries, the grid edges and beyond."""
    c = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    D, H, W = dims
    for a, m in enumerate((W, H, D)):
        knots = (np.arange(-1, m + 1) / (0.5 * (m - 1)) - 1.0).astype(np.float32)
        c[:len(knots), a] = knots
        c[len(knots):2 * len(knots), a] = np.nextafter(knots, np.float32(-2))
    return c


def test_cell_geometry_rows_exact():
    dims = (32, 32, 32)
    c = _boundary_coords(np.random.RandomState(8), 400, dims)
    rj, fj, okj = jgrid._cell_geometry(jnp.asarray(c), dims)
    rt, ft, okt = tgrid._cell_geometry(torch.as_tensor(c), dims)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    for a, b in zip(ft, fj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_grid_sample_3d(compute_dtype):
    rng = np.random.RandomState(9)
    g = rng.randn(8, 5, 6, 7).astype(np.float32)
    c = _boundary_coords(rng, 300, (5, 6, 7))
    oj = jgrid.grid_sample_3d(jnp.asarray(g), jnp.asarray(c), compute_dtype)
    ot = tgrid.grid_sample_3d(torch.as_tensor(g), torch.as_tensor(c), compute_dtype)
    _close(ot, oj, atol=1e-6 if compute_dtype == "float32" else 1e-5)
    # and against torch's own grid_sample (the reference's op)
    ref = torch.nn.functional.grid_sample(
        torch.as_tensor(g)[None], torch.as_tensor(c)[None, :, None, None, :],
        mode="bilinear", padding_mode="zeros", align_corners=True)
    if compute_dtype == "float32":
        _close(ot, ref[0, :, :, 0, 0].t(), atol=1e-5)
