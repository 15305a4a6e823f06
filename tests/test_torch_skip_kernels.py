"""The plain versions of K13 (one deformation MLP), K14 (its backward) and
K15 (the sample positions) against the JAX package (float32 and bfloat16,
Pallas in interpret mode, the exact-f32 PE angle):

  (a) K13's plain version vs field_mlp.deform_mlp_apply_fused with the
      in-kernel PE (pe_spec given) on 300 raw 3-wide points, the form
      tests/test_pallas.py:259 runs: the warp field (6x128, tanh, 3) and
      the hyper sheet (6x64, linear, 2);
  (b) K14's plain version, and the autograd Function built on K13/K14,
      vs jax.vjp of the same: every dW and db leaf, d(cond) and the
      cotangent of the raw points;
  (c) K15's plain version vs the XLA expression o8 + d8 * z, op by op and
      under jit, and vs field_mlp.build_pts;
  (d) what the kernel wrappers refuse before they launch.

Tolerances: K13 in float32 within 1e-5 absolute (test_pallas.py:42's), in
bfloat16 within 2e-2 of the output's scale (the two sides round the same
operands but sum in another order). K14's leaves each against its own norm:
float32 within 1e-4; bfloat16 within 5e-2 at a cosine of 0.999 (a
pre-activation that rounds to the other side of a ReLU kink moves a
bf16 leaf by ~1 %). The cotangent is that of a loss of the outputs.
K15's positions are bit-equal to the XLA expression run op by op, which
rounds the product and the sum one at a time as PyTorch's eager ops do;
under jit XLA on the CPU contracts it into one fused multiply-add, and
JAX's build_pts in interpret mode also rounds o + d z once, so those two
are held within one rounding of the product and one of the sum.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sahs_tpu.config import Config
from sahs_tpu.models.nerface import ModelSpec, init_model_params
from sahs_tpu.ops.encoding import encoded_dim
from sahs_tpu.ops.pallas import field_mlp as jfm

from sahs_tpu_torch.config import Config as TConfig
from sahs_tpu_torch.models import nerface as tn
from sahs_tpu_torch.ops.kernels import points as k15
from sahs_tpu_torch.ops.kernels import skip_mlp as k13
from sahs_tpu_torch.utils.weights import params_from_jax

torch.set_num_threads(2)

P = 300
# net -> (JAX deform_mlp_apply_fused arguments, output dim, head)
NETS = {"warp": (6, 128, 4, 3, "tanh"), "hyper": (6, 64, 4, 2, "linear")}
PE_SPEC = jfm.PESpec(groups=((0, 3, 10, True, True),), in_width=8,
                     out_width=jfm._rup(encoded_dim(3, 10, True)))


def _n(x):
    return np.asarray(x.detach().cpu()) if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def nets():
    """JAX's seeded flagship weights loaded into the port's model, raw
    points, the conditioning [driving | pose] and loss cotangents."""
    spec = ModelSpec.from_config(Config())
    params = jax.tree.map(np.asarray, init_model_params(jax.random.PRNGKey(0), spec))
    model = tn.NeRFaceModel.init(tn.ModelSpec.from_config(TConfig()), seed=1,
                                 device="cpu")
    params_from_jax(model, params)
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.6, 0.6, (P, 3)).astype(np.float32)
    cond = np.concatenate([rng.randn(76) * 0.1, rng.randn(36)]).astype(np.float32)
    cot = {n: rng.randn(P, d[3]).astype(np.float32) for n, d in NETS.items()}
    return params, model, pts, cond, cot


def _jax_apply(params, name, compute_dtype, pts, cond):
    L, hid, skip, out, act = NETS[name]
    return jfm.deform_mlp_apply_fused(params[name], L, hid, skip, pts, cond, out,
                                      out_act=act, compute_dtype=compute_dtype,
                                      pe_spec=PE_SPEC)


def _weights(model, name, cond):
    warp_pe = tn.build_pe_groups(model.spec)[0]
    return k13.prepare_skip(getattr(model, name), torch.tensor(cond), warp_pe,
                            NETS[name][4])


@pytest.mark.parametrize("name", sorted(NETS))
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_skip_mlp_plain_matches_jax(nets, monkeypatch, name, compute_dtype):
    """(a) K13's plain version vs deform_mlp_apply_fused (raw points, the
    PE in the kernel), conditioning folded."""
    params, model, pts, cond, _ = nets
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    out_j = np.asarray(_jax_apply(params, name, compute_dtype, jnp.asarray(pts),
                                  jnp.asarray(cond)))
    out_t = _n(k13.skip_mlp_plain(torch.tensor(pts), _weights(model, name, cond),
                                  compute_dtype))
    assert out_t.shape == (P, NETS[name][3])
    if compute_dtype == "float32":
        np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    else:
        assert np.abs(out_t - out_j).max() <= 2e-2 * np.abs(out_j).max()


def _leaf_close(path, x, y, compute_dtype):
    x, y = np.asarray(x, np.float64).ravel(), np.asarray(y, np.float64).ravel()
    ny = np.linalg.norm(y)
    assert ny > 0, path
    rel = np.linalg.norm(x - y) / ny
    cos = float(x @ y) / (np.linalg.norm(x) * ny)
    if compute_dtype == "float32":
        assert rel <= 1e-4, (path, rel)
    else:
        assert rel <= 5e-2 and cos >= 0.999, (path, rel, cos)


def _jax_vjp(params, name, compute_dtype, pts, cond, cot):
    _, vjp = jax.vjp(lambda p, x, c: _jax_apply({name: p}, name, compute_dtype, x, c),
                     params[name], jnp.asarray(pts), jnp.asarray(cond))
    return vjp(jnp.asarray(cot))


def _net_grads(net):
    """A module's .grad fields in the JAX tree layout."""
    lin = lambda l: {"w": _n(l.weight.grad).T, "b": _n(l.bias.grad)}
    return {"trunk": [lin(l) for l in net.trunk.layers], "out": lin(net.out)}


def _assert_tree(a, b, compute_dtype):
    for i, (x, y) in enumerate(zip(a["trunk"], b["trunk"])):
        for k in ("w", "b"):
            _leaf_close(f"trunk[{i}].{k}", x[k], y[k], compute_dtype)
    for k in ("w", "b"):
        _leaf_close(f"out.{k}", a["out"][k], b["out"][k], compute_dtype)


@pytest.mark.parametrize("name", sorted(NETS))
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_skip_mlp_vjp_plain_matches_jax(nets, monkeypatch, name, compute_dtype):
    """(b) K14's plain version vs jax.vjp of deform_mlp_apply_fused: the
    folded gradients unfolded (skip_param_grads) leaf by leaf, d(cond),
    and the cotangent of the raw points."""
    params, model, pts, cond, cot = nets
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    g_p, gx_j, gc_j = _jax_vjp(params, name, compute_dtype, pts, cond, cot[name])
    net = getattr(model, name)
    gx, folded = k13.skip_mlp_vjp_plain(torch.tensor(pts), _weights(model, name, cond),
                                        torch.tensor(cot[name]), True, compute_dtype)
    by_param, dcond = k13.skip_param_grads(net, folded, torch.tensor(cond))
    lin = lambda l: {"w": _n(by_param[l.weight]).T, "b": _n(by_param[l.bias])}
    _assert_tree({"trunk": [lin(l) for l in net.trunk.layers], "out": lin(net.out)},
                 jax.tree.map(np.asarray, g_p), compute_dtype)
    _leaf_close("dcond", _n(dcond), gc_j, compute_dtype)
    _leaf_close("gx", _n(gx), gx_j, compute_dtype)
    assert k13.skip_mlp_vjp_plain(torch.tensor(pts), _weights(model, name, cond),
                                  torch.tensor(cot[name]), False, compute_dtype)[0] is None


@pytest.mark.parametrize("name", sorted(NETS))
def test_deform_mlp_function_matches_jax(nets, monkeypatch, name):
    """(b) The autograd Function (forward K13, backward K14, their plain
    versions on the CPU) vs JAX's custom VJP, float32: the output, every
    parameter's gradient, d(cond) and, when the points ask for it, their
    cotangent; points that ask for none get none."""
    params, model, pts, cond, cot = nets
    monkeypatch.setattr(jfm, "_PE_SPLIT_DOT", False)
    g_p, gx_j, gc_j = _jax_vjp(params, name, "float32", pts, cond, cot[name])
    net = getattr(model, name)
    for wants_gx in (True, False):
        net.zero_grad(set_to_none=True)
        x = torch.tensor(pts).requires_grad_(wants_gx)
        c = torch.tensor(cond).requires_grad_()
        op = k13.SkipOp(net, list(net.parameters()), _weights(model, name, cond), x,
                        "float32")
        y = k13.deform_mlp_apply_fused(op, c)
        np.testing.assert_allclose(
            _n(y), np.asarray(_jax_apply(params, name, "float32", jnp.asarray(pts),
                                         jnp.asarray(cond))), atol=1e-5)
        torch.sum(y * torch.tensor(cot[name])).backward()
        _assert_tree(_net_grads(net), jax.tree.map(np.asarray, g_p), "float32")
        _leaf_close("dcond", _n(c.grad), gc_j, "float32")
        if wants_gx:
            _leaf_close("gx", _n(x.grad), gx_j, "float32")
        else:
            assert x.grad is None


@pytest.mark.parametrize("R,S", [(37, 64), (50, 128)])
def test_build_pts_plain_matches_jax(R, S):
    """(c) K15's plain version: bit-equal to the XLA expression o8 + d8 * z
    run op by op (the product rounded, then the sum), and one rounding
    away from the same expression under jit (where XLA on the CPU
    contracts it into one fused multiply-add) and from JAX's build_pts
    kernel (interpret mode, one rounding too), at every coordinate."""
    rng = np.random.RandomState(R)
    ro = rng.randn(R, 3).astype(np.float32) * 0.3
    rd = (rng.randn(R, 3) * 0.1 + [0, 0, -1]).astype(np.float32)
    z = np.sort(rng.uniform(0.2, 0.8, (R, S)).astype(np.float32), axis=-1)
    o8 = jnp.pad(jnp.asarray(ro), ((0, 0), (0, 5)))
    d8 = jnp.pad(jnp.asarray(rd), ((0, 0), (0, 5)))

    def expr(o, d, zz):
        return (o[:, None, :] + d[:, None, :] * zz[..., None]).reshape(-1, 8)

    op_by_op = np.asarray(expr(o8, d8, jnp.asarray(z)))[:, :3]
    fused = np.asarray(jax.jit(expr)(o8, d8, jnp.asarray(z)))[:, :3]
    kern = np.asarray(jfm.build_pts(o8, d8, jnp.asarray(z), S))[:, :3]
    ours = _n(k15.build_pts(torch.tensor(ro), torch.tensor(rd), torch.tensor(z)))
    assert ours.shape == (R * S, 3)
    np.testing.assert_array_equal(ours, op_by_op)
    # one rounding apart: the product's and the sum's (where o + d z nearly
    # cancels, the product's ulp is many of the result's)
    prod = (rd[:, None, :] * z[..., None]).reshape(-1, 3)
    tol = np.spacing(np.abs(prod)) + np.spacing(np.abs(ours))
    for other in (fused, kern):
        assert np.all(np.abs(ours - other) <= tol)
        assert not np.array_equal(ours, other)


def _meta(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("case", ["precomputed_pe", "wide_trunk", "wide_head",
                                  "points_width", "k15_device", "bf16_trunk_step"])
def test_wrappers_refuse_what_the_kernels_do_not_take(nets, case):
    """(d) Before any launch, on a tensor that is not on the CPU: K13 and
    K14 refuse a precomputed-PE input whose width is not the encoding's
    (and take one that is, up to the device check), trunks wider than 128,
    heads of more than 8 outputs and points other than (P, 3), and K13 in
    bfloat16 trunk widths that are not multiples of its forward tile's
    step (a multiple of 8 that float32 takes, and K14's backward tile in
    either type); K15 refuses a device other than CUDA."""
    _, model, _, cond, _ = nets
    w = _weights(model, "warp", cond)
    pts = _meta(64, 3)
    if case == "bf16_trunk_step":
        w.trunk[1] = {"w": torch.zeros(128, 40), "b": torch.zeros(40)}
        with pytest.raises(ValueError, match=f"multiples of {k13.TC_K_STEP}"):
            k13.skip_mlp_forward(pts, w, "bfloat16")
        # the others take the width: they get past the check to the device
        for fn, args, dtype in ((k13.skip_mlp_forward, (), "float32"),
                                (k13.skip_mlp_vjp, (_meta(64, 3), True), "float32"),
                                (k13.skip_mlp_vjp, (_meta(64, 3), True), "bfloat16")):
            with pytest.raises(ValueError, match="unsupported device meta"):
                fn(pts, w, *args, dtype)
        return
    if case == "precomputed_pe":
        w = k13.prepare_skip(model.warp, torch.tensor(cond), None, "tanh")
        with pytest.raises(ValueError, match="unsupported device meta"):
            k13.skip_mlp_forward(_meta(64, 63), w, "float32")
        pts, match = _meta(64, 3), r"pre-encoded input must be \(P, 63\)"
    elif case == "wide_trunk":
        w.trunk[1] = {"w": torch.zeros(128, 256), "b": torch.zeros(256)}
        match = "at most 128 wide"
    elif case == "wide_head":
        w.out = {"w": torch.zeros(128, 9), "b": torch.zeros(9)}
        match = "at most 8 outputs"
    elif case == "points_width":
        pts, match = _meta(64, 8), r"\(P, 3\) float32"
    else:
        with pytest.raises(ValueError, match="unsupported device"):
            k15.build_pts(_meta(4, 3), _meta(4, 3), _meta(4, 8))
        return
    with pytest.raises(ValueError, match=match):
        k13.skip_mlp_forward(pts, w, "float32")
    with pytest.raises(ValueError, match=match):
        k13.skip_mlp_vjp(pts, w, _meta(64, 3), True, "float32")
