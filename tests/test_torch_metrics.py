"""The port's image metrics (``sahs_tpu_torch/metrics.py``) and LPIPS
(``sahs_tpu_torch/lpips.py``) against the JAX package's on the CPU: PSNR,
SSIM and L1 equal to 1e-12 (the same numpy float64 code), ``two_folders``
writing JAX's ``metrics.txt`` text and L2 images (the offline ``n/a``
line without weights; with LPIPS weights its values within JAX's own
2e-4 relative and the rest of the text equal), ``lpips_distance`` within
2e-4 relative of JAX's, and the weight importer on both key layouts
(lpips-package and torchvision, the latter flagged by the uniform-lin
label in ``metrics.txt``). Nothing is downloaded: the weights are random
(``random_params``) and written to a local ``.pth``.
"""
import os
import shutil

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from sahs_tpu import lpips as jlp
from sahs_tpu import metrics as jm

from sahs_tpu_torch import lpips as tlp
from sahs_tpu_torch import metrics as tm

torch.set_num_threads(2)

LPIPS_RTOL = 2e-4


@pytest.mark.parametrize("shape", [(16, 20, 3), (9, 12), (7, 7, 3)])
def test_psnr_ssim_l1_equal_jax(shape):
    rng = np.random.RandomState(len(shape) + shape[0])
    a = rng.rand(*shape)
    b = np.clip(a + rng.randn(*shape) * 0.05, 0, 1)
    for f in ("psnr", "ssim", "l1"):
        got, want = getattr(tm, f)(a, b), getattr(jm, f)(a, b)
        assert abs(got - want) <= 1e-12 * max(1.0, abs(want)), f
    assert tm.psnr(a, a) == float("inf")


def _lpips_pth(tmp_path, params, layout):
    sd = {}
    for li, ci in enumerate([0, 3, 6, 8, 10]):
        pre = f"net.slice{[1, 1, 2, 3, 4][li]}.{ci}" if layout == "lpips" else f"features.{ci}"
        sd[pre + ".weight"] = torch.from_numpy(params["convs"][li]["w"])
        sd[pre + ".bias"] = torch.from_numpy(params["convs"][li]["b"])
        if layout == "lpips":
            sd[f"lin{li}.model.1.weight"] = torch.from_numpy(params["lins"][li][None, :, None, None])
    path = str(tmp_path / f"{layout}.pth")
    torch.save(sd, path)
    return path


def test_lpips_distance_matches_jax():
    params = tlp.random_params(0)
    rng = np.random.RandomState(1)
    x = rng.rand(64, 64, 3).astype(np.float32)
    y = np.clip(x + rng.randn(64, 64, 3).astype(np.float32) * 0.05, 0, 1)
    net = tlp.LpipsNet(params, "cpu")
    got, want = tlp.lpips_distance(net, x, y), jlp.lpips_distance(jlp.random_params(0), x, y)
    assert got > 0
    assert abs(got - want) <= LPIPS_RTOL * want
    assert abs(tlp.lpips_distance(net, x, x)) <= 1e-9


def test_lpips_distance_runs_in_full_float32(monkeypatch):
    """lpips_distance turns TF32 off for its convolutions and gives the
    process's settings back after."""
    seen = []
    features = tlp.alex_features

    def spy(net, x):
        seen.append((torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()))
        return features(net, x)

    monkeypatch.setattr(tlp, "alex_features", spy)
    saved = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        x = np.random.RandomState(3).rand(32, 32, 3).astype(np.float32)
        tlp.lpips_distance(tlp.LpipsNet(tlp.random_params(0), "cpu"), x, 1.0 - x)
        after = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    assert seen == [(False, "highest")] * 2
    assert after == (True, "high")


@pytest.mark.parametrize("layout", ["lpips", "torchvision"])
def test_lpips_importer_reads_both_layouts(tmp_path, layout):
    params = tlp.random_params(2)
    path = _lpips_pth(tmp_path, params, layout)
    got, want = tlp.load_lpips_params(path), jlp.load_lpips_params(path)
    assert got["uniform_lins"] == want["uniform_lins"] == (layout == "torchvision")
    for li in range(5):
        np.testing.assert_array_equal(got["convs"][li]["w"], want["convs"][li]["w"])
        np.testing.assert_array_equal(got["convs"][li]["b"], want["convs"][li]["b"])
        np.testing.assert_array_equal(got["lins"][li], want["lins"][li])
    if layout == "lpips":
        for li in range(5):
            np.testing.assert_array_equal(got["lins"][li], params["lins"][li])
    assert tlp.load_lpips_params(str(tmp_path / "missing.pth")) is None
    assert tlp.load_lpips_params("") is None


def _folders(tmp_path):
    rng = np.random.RandomState(3)
    gt, gen = str(tmp_path / "gt"), str(tmp_path / "gen")
    os.makedirs(gt)
    os.makedirs(gen)
    for i in range(3):
        a = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
        b = np.clip(a.astype(int) + rng.randint(-20, 21, a.shape), 0, 255).astype(np.uint8)
        imageio.imwrite(os.path.join(gt, f"{i}.jpg"), a)
        imageio.imwrite(os.path.join(gen, f"f_{i:04d}.png"), b)
    return gt, gen


def _both(tmp_path, monkeypatch, weights=None):
    """two_folders of both packages on copies of one generated folder ->
    (the port's text, JAX's text with its folder renamed, summaries)."""
    if weights is None:
        monkeypatch.delenv("SAHS_LPIPS_WEIGHTS", raising=False)
    else:
        monkeypatch.setenv("SAHS_LPIPS_WEIGHTS", weights)
    monkeypatch.setattr(jm, "_lpips_vendored", None)
    gt, gen = _folders(tmp_path)
    jgen = gen + "_jax"
    shutil.copytree(gen, jgen)
    ts = tm.two_folders(gt, gen, device="cpu")
    js = jm.two_folders(gt, jgen)
    text = open(os.path.join(gen, "metrics.txt")).read()
    jtext = open(os.path.join(jgen, "metrics.txt")).read().replace(jgen, gen)
    for f in sorted(os.listdir(os.path.join(gen, "L2"))):
        np.testing.assert_array_equal(imageio.imread(os.path.join(gen, "L2", f)),
                                      imageio.imread(os.path.join(jgen, "L2", f)))
    return text, jtext, ts, js


def test_two_folders_writes_jax_text_offline(tmp_path, monkeypatch):
    text, jtext, ts, js = _both(tmp_path, monkeypatch)
    assert text == jtext
    assert "n/a (offline" in text and ts["LPIPS"] is None
    for k in ("L1", "PSNR", "SSIM"):
        assert ts[k] == js[k]


@pytest.mark.parametrize("layout", ["lpips", "torchvision"])
def test_two_folders_with_lpips_weights(tmp_path, monkeypatch, layout):
    """With SAHS_LPIPS_WEIGHTS: every LPIPS value within LPIPS_RTOL of
    JAX's, the rest of the text equal; a torchvision file's numbers carry
    the uniform-lin label."""
    path = _lpips_pth(tmp_path, tlp.random_params(4), layout)
    text, jtext, ts, js = _both(tmp_path, monkeypatch, path)
    lines, jlines = text.splitlines(), jtext.splitlines()
    assert len(lines) == len(jlines)
    for a, b in zip(lines, jlines):
        if "LPIPS" in a:
            head, val = a.rsplit("\t", 1)
            jhead, jval = b.rsplit("\t", 1)
            assert head == jhead
            assert abs(float(val) - float(jval)) <= LPIPS_RTOL * float(jval) + 1e-6
        else:
            assert a == b
    assert abs(ts["LPIPS"] - js["LPIPS"]) <= LPIPS_RTOL * js["LPIPS"]
    assert ("LPIPS(uniform-lin, NOT parity)" in text) == (layout == "torchvision")


def test_metrics_cli_runs_on_cuda_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gt, gen = _folders(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.main(["--gt_path", gt, "--images_path", gen])
    summary = tm.main(["--gt_path", gt, "--images_path", gen, "--device", "cpu"])
    assert np.isfinite(summary["PSNR"])
