"""The port's Stage-II networks (``sahs_tpu_torch/models/spade.py``) against
the JAX package's (``sahs_tpu/models/spade.py``) on the CPU, on the same
weights (JAX's init, carried across by ``spade.from_jax``) and seeded
numpy inputs: every primitive (a conv transpose with cin != cout among
them, ``resize_nearest`` from the audio map's 64 x 4096 to non-divisor
sizes), spectral norm with and without a stored ``v`` and its train-mode
gradient against ``jax.grad``, the generators and the discriminator in
both modes (float32 within 1e-4 relative of the output's scale), the
tree mapping both ways, and a reference-layout Generator state dict
through both packages' importers. Generators at 32 x 32, the
discriminator at 64 x 64 (its last conv needs 4 x 4).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sahs_tpu.models import spade as js
from sahs_tpu.utils import checkpoint as jck

from sahs_tpu_torch.models import spade as ts
from sahs_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)

RTOL = 1e-4


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"max |d| / scale = {err:.3e} > {rtol}"


def _trees_close(got, want, rtol=RTOL):
    gl, gd = jax.tree_util.tree_flatten(got)
    wl, wd = jax.tree_util.tree_flatten(_np_tree(want))
    assert gd == wd
    for a, b in zip(gl, wl):
        _close(a, b, rtol)


@pytest.mark.parametrize("cin,cout,stride", [(5, 7, 1), (4, 6, 2)])
def test_conv2d_matches_jax(cin, cout, stride):
    rng = np.random.RandomState(cin)
    p = {"w": rng.randn(3, 3, cin, cout).astype(np.float32),
         "b": rng.randn(cout).astype(np.float32)}
    x = rng.randn(2, 9, 11, cin).astype(np.float32)
    want = js.conv2d(jax.tree.map(jnp.asarray, p), jnp.asarray(x), stride=stride)
    conv = ts.from_jax(ts.Conv(cin, cout), p)
    _close(_nhwc(conv(_nchw(x), stride=stride)), want, 1e-5)


@pytest.mark.parametrize("cin,cout", [(4, 4), (4, 6), (6, 3)])
def test_conv_transpose_matches_jax(cin, cout):
    """up_id is square in the generator, where a swapped I/O axis would
    raise nothing: cin != cout holds the layout."""
    rng = np.random.RandomState(cin * 10 + cout)
    # JAX's kernel for conv_transpose(transpose_kernel=True): (k, k, O, I)
    p = {"w": rng.randn(3, 3, cout, cin).astype(np.float32),
         "b": rng.randn(cout).astype(np.float32)}
    x = rng.randn(1, 6, 5, cin).astype(np.float32)
    want = js.conv2d_transpose(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    conv = ts.from_jax(ts.ConvT(cin, cout), p)
    got = _nhwc(conv(_nchw(x)))
    assert got.shape == (1, 12, 10, cout)
    _close(got, want, 1e-5)
    # and torch's own module on the reference layout
    ref = torch.nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1, output_padding=1)
    with torch.no_grad():
        ref.weight.copy_(conv.w)
        ref.bias.copy_(conv.b)
    _close(_nhwc(ref(_nchw(x))), want, 1e-5)


def test_pooling_norms_and_upsample_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 6, 5).astype(np.float32)
    _close(_nhwc(ts.instance_norm(_nchw(x))), js.instance_norm(jnp.asarray(x)), 1e-5)
    _close(_nhwc(ts.avg_pool2(_nchw(x))), js.avg_pool2(jnp.asarray(x)), 1e-6)
    np.testing.assert_array_equal(_nhwc(ts.upsample_nearest2(_nchw(x))),
                                  np.asarray(js.upsample_nearest2(jnp.asarray(x))))
    for v in (0.0, -1.0, 2.5):
        np.testing.assert_array_equal(ts.lrelu(torch.tensor([v])).numpy(),
                                      np.asarray(js.lrelu(jnp.asarray([v]))))


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_jax(train):
    rng = np.random.RandomState(6)
    c = 5
    p = {"gamma": rng.rand(c).astype(np.float32) + 0.5,
         "beta": rng.randn(c).astype(np.float32)}
    buf = {"mean": rng.randn(c).astype(np.float32) * 0.1,
           "var": rng.rand(c).astype(np.float32) + 0.5}
    x = rng.randn(2, 6, 6, c).astype(np.float32)
    want, new_buf = js.batch_norm(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, buf),
                                  jnp.asarray(x), train=train)
    bn = ts.from_jax(ts.BatchNorm(c), p, buf)
    _close(_nhwc(bn(_nchw(x), train)), want, 1e-5)
    _trees_close(ts.to_jax(bn, "bufs"), new_buf, 1e-6)


@pytest.mark.parametrize("oh,ow", [(5, 7), (33, 1000), (128, 3000), (20, 4095), (64, 4096)])
def test_resize_nearest_matches_jax_from_the_audio_maps_size(oh, ow):
    rng = np.random.RandomState(oh)
    x = rng.randn(1, 64, 4096, 3).astype(np.float32)
    np.testing.assert_array_equal(_nhwc(ts.resize_nearest(_nchw(x), oh, ow)),
                                  np.asarray(js.resize_nearest(jnp.asarray(x), oh, ow)))


@pytest.mark.parametrize("oh,ow", [(8, 8), (16, 16), (64, 64), (20, 30)])
def test_audio_map_equals_the_resized_broadcast(oh, ow):
    """AudioMap.at builds the resized (1, 256, oh, ow) form of the
    reference's (1, 256, 64, 4096) audio map from the index rule: equal to
    JAX's resize of the whole broadcast map."""
    feat = np.random.RandomState(ow).randn(1, 64).astype(np.float32)

    @jax.jit
    def jax_map(f):
        tile = jnp.broadcast_to(f[0][None, None, :], (64, 64, 64)).reshape(1, 64, 4096, 1)
        return js.resize_nearest(jnp.broadcast_to(tile, (1, 64, 4096, 256)), oh, ow)

    got = ts.AudioMap(torch.from_numpy(feat)).at(oh, ow)
    assert got.shape == (1, 256, oh, ow)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(jax_map(jnp.asarray(feat))))


def _sn_case(seed, cin=6, cout=5, k=3, with_v=False):
    rng = np.random.RandomState(seed)
    p = {"w": rng.randn(k, k, cin, cout).astype(np.float32),
         "b": rng.randn(cout).astype(np.float32)}
    u = rng.randn(cout).astype(np.float32)
    buf = {"u": u / np.linalg.norm(u)}
    if with_v:
        v = rng.randn(k * k * cin).astype(np.float32)
        buf["v"] = v / np.linalg.norm(v)
    return p, buf


@pytest.mark.parametrize("train,with_v", [(True, False), (True, True), (False, False),
                                          (False, True)])
def test_spectral_norm_matches_jax(train, with_v):
    p, buf = _sn_case(1, with_v=with_v)
    c, new_buf = js.spectral_norm(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, buf),
                                  train)
    conv = ts.from_jax(ts.SNConv(6, 5), p, buf)
    assert (conv.v is not None) == with_v
    w, u, v = ts.spectral_norm(conv.w, conv.u, conv.v, train)
    _close(ts._conv_to_jax(w.detach()), c["w"], 1e-6)
    x = np.random.RandomState(2).randn(1, 7, 7, 6).astype(np.float32)
    want = js.conv2d(c, jnp.asarray(x))
    _close(_nhwc(conv(_nchw(x), train)), want, 1e-5)
    # the buffers after the call: u (and v where there is one), JAX's layout
    _trees_close(ts.to_jax(conv, "bufs"), new_buf, 1e-6)


def test_spectral_norm_train_gradient_matches_jax_grad():
    """In train mode the gradient runs through the power iteration's v and
    u' (torch's own spectral_norm treats them as constants)."""
    p, buf = _sn_case(3)
    R = np.random.RandomState(4).randn(*p["w"].shape).astype(np.float32)

    def jloss(w):
        c, _ = js.spectral_norm({"w": w, "b": jnp.asarray(p["b"])},
                                jax.tree.map(jnp.asarray, buf), True)
        return jnp.sum(c["w"] * R)

    want = jax.grad(jloss)(jnp.asarray(p["w"]))
    conv = ts.from_jax(ts.SNConv(6, 5), p, buf)
    w, _, _ = ts.spectral_norm(conv.w, conv.u, conv.v, True)
    (w * torch.from_numpy(R).permute(3, 2, 0, 1)).sum().backward()
    _close(ts._conv_to_jax(conv.w.grad), want, 1e-5)
    # a constant-v gradient (torch's built-in semantics) is another one
    wm = conv.w.detach().reshape(5, -1)
    v = ts._normalize(wm.t() @ conv.u)
    u1 = ts._normalize(wm @ v)
    wc = conv.w.detach().clone().requires_grad_(True)
    (wc / torch.dot(u1, wc.reshape(5, -1) @ v) * torch.from_numpy(R).permute(3, 2, 0, 1)
     ).sum().backward()
    assert float((wc.grad - conv.w.grad).abs().max()) > 1e-3 * float(conv.w.grad.abs().max())


def test_audionet_conv_features_match_jax():
    from sahs_tpu.models.fields import audio_net_init
    from sahs_tpu_torch.models.fields import AudioNet
    p = _np_tree(audio_net_init(jax.random.PRNGKey(2)))
    net = ts.from_jax(AudioNet(), p)
    a = np.random.RandomState(5).randn(16, 29).astype(np.float32)
    want = js._audionet_conv_features(jax.tree.map(jnp.asarray, p), jnp.asarray(a))
    got = ts.audionet_conv_features(net, torch.from_numpy(a))
    _close(got.detach().numpy(), want, 1e-5)


def _generator(audio, seed=0):
    p, b = js.generator_init(jax.random.PRNGKey(seed), audio=audio)
    return p, b, ts.from_jax(ts.Generator(audio=audio), _np_tree(p), _np_tree(b))


def _gen_inputs(seed, hw=32, audio=False):
    rng = np.random.RandomState(seed)
    src = rng.rand(1, hw, hw, 3).astype(np.float32)
    raw = rng.rand(1, hw, hw, 3).astype(np.float32)
    aud = rng.randn(16, 29).astype(np.float32) if audio else None
    return src, raw, aud


@pytest.mark.parametrize("audio", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_generator_matches_jax(audio, train):
    p, b, gen = _generator(audio)
    src, raw, aud = _gen_inputs(1, audio=audio)
    f = jax.jit(lambda p, b, s, r, a: js.generator_apply(p, b, s, r, a, train=train))
    want, new_b = f(p, b, jnp.asarray(src), jnp.asarray(raw),
                    None if aud is None else jnp.asarray(aud))
    got = gen(_nchw(src), _nchw(raw), None if aud is None else torch.from_numpy(aud),
              train=train)
    _close(_nhwc(got), want)
    _trees_close(ts.to_jax(gen, "bufs"), new_b, 1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_discriminator_matches_jax(train):
    p, b = js.discriminator_init(jax.random.PRNGKey(3), style_size=3)
    d = ts.from_jax(ts.Discriminator(3), _np_tree(p), _np_tree(b))
    rng = np.random.RandomState(7)
    x, a = (rng.rand(1, 64, 64, 3).astype(np.float32) for _ in range(2))
    want, new_b = jax.jit(lambda p, b, x, a: js.discriminator_apply(p, b, x, a, train=train))(
        p, b, jnp.asarray(x), jnp.asarray(a))
    got = d(_nchw(x), _nchw(a), train=train)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _close(_nhwc(g), w)
    _trees_close(ts.to_jax(d, "bufs"), new_b, 1e-5)


@pytest.mark.parametrize("audio", [False, True])
def test_tree_mapping_round_trips(audio):
    p, b, gen = _generator(audio, seed=4)
    for section, tree in (("params", p), ("bufs", b)):
        got, want = ts.to_jax(gen, section), _np_tree(tree)
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for x, y in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        bad = _np_tree(p)
        bad["refine"]["head"]["w"] = bad["refine"]["head"]["w"][:, :, :, :2]
        ts.from_jax(ts.Generator(audio=audio), bad, _np_tree(b))


def _reference_state_dict(params, bufs, audio):
    """The reference module tree's state dict (_init_spade.py) from the
    JAX trees, with a weight_v for every spectral-norm conv (the inverse of
    the importers' mapping, for the test)."""
    sd = {}
    rng = np.random.RandomState(11)

    def conv(prefix, c):
        sd[prefix + ".weight"] = torch.from_numpy(np.asarray(c["w"]).transpose(3, 2, 0, 1).copy())
        sd[prefix + ".bias"] = torch.from_numpy(np.asarray(c["b"]).copy())

    def bn(prefix, q, r):
        sd[prefix + ".weight"] = torch.from_numpy(np.asarray(q["gamma"]).copy())
        sd[prefix + ".bias"] = torch.from_numpy(np.asarray(q["beta"]).copy())
        sd[prefix + ".running_mean"] = torch.from_numpy(rng.randn(*np.shape(r["mean"])).astype(np.float32) * 0.1)
        sd[prefix + ".running_var"] = torch.from_numpy(rng.rand(*np.shape(r["var"])).astype(np.float32) + 0.5)

    def sn(prefix, c, r):
        w = np.asarray(c["w"]).transpose(3, 2, 0, 1).copy()
        sd[prefix + ".weight_orig"] = torch.from_numpy(w)
        sd[prefix + ".bias"] = torch.from_numpy(np.asarray(c["b"]).copy())
        sd[prefix + ".weight_u"] = torch.from_numpy(np.asarray(r["u"]).copy())
        v = rng.randn(w[0].size).astype(np.float32)
        sd[prefix + ".weight_v"] = torch.from_numpy(v / np.linalg.norm(v))

    ip, ib = params["idenc"], bufs["idenc"]
    conv("idencoder.layer1.0", ip["stem"])
    for name, layer in (("l2", "layer2"), ("l3", "layer3"), ("l4", "layer4")):
        q, r, pre = ip[name], ib[name], f"idencoder.{layer}"
        conv(pre + ".initial.0", q["initial"])
        bn(pre + ".initial.1", q["bn1"], r["bn1"])
        if "down_id" in q:
            conv(pre + ".downsample_layer", q["down_id"])
            conv(pre + ".residual_downsample", q["down_res"])
        else:
            conv(pre + ".residual.0", q["residual"])
            bn(pre + ".residual.1", q["bn2"], r["bn2"])
    rp, rb = params["refine"], bufs["refine"]
    conv("refine_network.layer1.0", rp["stem"])
    for i, (q, r) in enumerate(zip(rp["blocks"], rb["blocks"])):
        pre = f"refine_network.layer{i + 2}"
        for s in ("spade1", "spade2", "spade_s"):
            conv(f"{pre}.{s}.mlp_shared.0", q[s]["shared"])
            conv(f"{pre}.{s}.conv_gamma", q[s]["gamma"])
            conv(f"{pre}.{s}.conv_beta", q[s]["beta"])
        for c in ("conv1", "conv2", "conv_s"):
            sn(f"{pre}.{c}", q[c], r[c])
        if "down_id" in q:
            conv(pre + ".residual_downsample", q["down_id"])
        if "up_id" in q:
            # (k, k, O, I) -> torch ConvTranspose2d's (I, O, k, k)
            conv(pre + ".residual_upsample", q["up_id"])
    conv("refine_network.layer8", rp["head"])
    if audio:
        a = params["audnet"]
        for slot, c in zip((0, 2, 4, 6), a["convs"]):
            sd[f"AudioNet.encoder_conv.{slot}.weight"] = torch.from_numpy(
                np.asarray(c["w"]).transpose(2, 1, 0).copy())
            sd[f"AudioNet.encoder_conv.{slot}.bias"] = torch.from_numpy(np.asarray(c["b"]).copy())
        for slot, key in ((0, "fc1"), (2, "fc2")):
            sd[f"AudioNet.encoder_fc1.{slot}.weight"] = torch.from_numpy(np.asarray(a[key]["w"]).T.copy())
            sd[f"AudioNet.encoder_fc1.{slot}.bias"] = torch.from_numpy(np.asarray(a[key]["b"]).copy())
    return sd


@pytest.mark.parametrize("audio", [False, True])
def test_reference_generator_state_dict_through_both_importers(tmp_path, audio):
    p, b = js.generator_init(jax.random.PRNGKey(5), audio=audio)
    sd = _reference_state_dict(_np_tree(p), _np_tree(b), audio)
    jp, jb = jck.import_torch_generator_state_dict(sd, audio)
    tp, tb = tck.import_torch_generator_state_dict(sd, audio)
    for x, y in zip(jax.tree_util.tree_leaves(_np_tree((jp, jb))),
                    jax.tree_util.tree_leaves((tp, tb))):
        np.testing.assert_array_equal(x, y)
    path = str(tmp_path / "gen.ckpt")
    torch.save({"model_state_dict": sd, "iter": 7}, path)
    imported = tck.import_torch_generator_checkpoint(path, audio)
    assert imported["iter"] == 7
    gen = ts.from_jax(ts.Generator(audio=audio), imported["params"], imported["bufs"])
    assert all(m.v is not None for m in gen.modules() if isinstance(m, ts.SNConv))
    src, raw, aud = _gen_inputs(2, audio=audio)
    want, _ = jax.jit(lambda p, b, s, r, a: js.generator_apply(p, b, s, r, a, train=False))(
        jp, jb, jnp.asarray(src), jnp.asarray(raw), None if aud is None else jnp.asarray(aud))
    got = gen(_nchw(src), _nchw(raw), None if aud is None else torch.from_numpy(aud))
    _close(_nhwc(got), want)
