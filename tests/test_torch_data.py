"""The port's data layer (``sahs_tpu_torch/data``) against the JAX package's:
the disk loaders on datasets that JAX's ``write_synthetic_dataset`` writes
(audio and expression layouts), JAX's loaders on the port's writer's
output, and the ``common.py`` helpers, as ``tests/test_data.py`` covers
them. Everything is host-side numpy and OpenCV, so every comparison is
exact (equal arrays, equal files), but the blur and the area resize, which
both packages hand to the same OpenCV call.
"""
import filecmp
import os
import sys

import numpy as np
import pytest

from sahs_tpu.config import Config, reference_expression_config
from sahs_tpu.data import AudioDataset, NerfaceDataset, write_synthetic_dataset
from sahs_tpu.data import common as jcommon
from sahs_tpu.utils import seg as jseg

from sahs_tpu_torch.config import Config as TConfig
from sahs_tpu_torch.config import reference_expression_config as t_expression_config
from sahs_tpu_torch.data import common as tcommon
from sahs_tpu_torch.data import synthetic as tsynthetic
from sahs_tpu_torch.data.audio import AudioDataset as TAudioDataset
from sahs_tpu_torch.data.nerface import NerfaceDataset as TNerfaceDataset
from sahs_tpu_torch.utils import seg as tseg

KINDS = ("audio", "expression")


def _cfgs(kind, basedir):
    cfg = Config() if kind == "audio" else reference_expression_config()
    tcfg = TConfig() if kind == "audio" else t_expression_config()
    for c in (cfg, tcfg):
        c.dataset.basedir = basedir
        c.dataset.type = kind
    return cfg, tcfg


def _datasets(kind, basedir, mode="train"):
    cfg, tcfg = _cfgs(kind, basedir)
    if kind == "audio":
        return AudioDataset(mode, cfg), TAudioDataset(mode, tcfg)
    return NerfaceDataset(mode, cfg), TNerfaceDataset(mode, tcfg)


def _assert_same(jds, tds):
    assert (len(tds), tds.H, tds.W) == (len(jds), jds.H, jds.W)
    np.testing.assert_array_equal(tds.intrinsics, jds.intrinsics)
    for i in range(len(jds)):
        a, b = jds[i], tds[i]
        assert sorted(a) == sorted(b)
        for k in a:
            if k == "fname":
                assert a[k] == b[k]
            else:
                assert np.asarray(b[k]).dtype == np.asarray(a[k]).dtype, k
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_array_equal(tds.background(), jds.background())


@pytest.mark.parametrize("kind", KINDS)
def test_port_loaders_read_the_jax_writer_output_as_jax(tmp_path, kind):
    basedir = str(tmp_path / kind)
    write_synthetic_dataset(basedir, kind=kind, num_frames=3, H=32, W=32)
    for mode in ("train", "val"):
        jds, tds = _datasets(kind, basedir, mode)
        assert len(tds) == 3
        _assert_same(jds, tds)
    item = tds[0]
    np.testing.assert_allclose(item["mask"].sum(-1), 1.0)
    assert item["mask"][:, :, 1:].sum() > 0
    assert item["driving"].shape == ((16, 29) if kind == "audio" else (76,))
    np.testing.assert_allclose(tds.background()[..., 3], 1.0)


@pytest.mark.parametrize("kind", KINDS)
def test_port_writer_writes_the_jax_files(tmp_path, kind):
    """The port's writer writes JAX's writer's files byte for byte, and
    JAX's loaders read them as the port's loaders do."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    write_synthetic_dataset(jdir, kind=kind, num_frames=2, H=24, W=24, seed=3)
    tsynthetic.write_synthetic_dataset(tdir, kind=kind, num_frames=2, H=24, W=24, seed=3)
    jfiles = sorted(os.path.relpath(os.path.join(r, f), jdir)
                    for r, _, fs in os.walk(jdir) for f in fs)
    tfiles = sorted(os.path.relpath(os.path.join(r, f), tdir)
                    for r, _, fs in os.walk(tdir) for f in fs)
    assert tfiles == jfiles and jfiles
    for f in jfiles:
        assert filecmp.cmp(os.path.join(jdir, f), os.path.join(tdir, f), shallow=False), f
    _assert_same(_datasets(kind, tdir)[0], _datasets(kind, tdir)[1])


def test_synthetic_dataset_matches_jax():
    from sahs_tpu.data import SyntheticFaceDataset
    for kind in KINDS:
        jds = SyntheticFaceDataset(kind, num_frames=2, H=16, W=20, seed=4)
        tds = tsynthetic.SyntheticFaceDataset(kind, num_frames=2, H=16, W=20, seed=4)
        _assert_same(jds, tds)


def test_common_helpers_match_jax(tmp_path):
    import cv2
    rng = np.random.RandomState(0)
    # RGBA onto white, a file without alpha, grey
    rgba = rng.randint(0, 255, (8, 8, 4)).astype(np.uint8)
    rgb = rng.randint(0, 255, (8, 8, 3)).astype(np.uint8)
    grey = rng.randint(0, 255, (8, 8)).astype(np.uint8)
    for name, img in (("a.png", rgba), ("b.png", rgb), ("c.png", grey)):
        p = str(tmp_path / name)
        cv2.imwrite(p, img)
        np.testing.assert_array_equal(tcommon.imread_rgb(p), jcommon.imread_rgb(p))
        np.testing.assert_array_equal(tcommon.imread_rgb_white(p),
                                      jcommon.imread_rgb_white(p))
    a = 128 / 255.0
    rgba[...] = 0
    rgba[..., 2], rgba[..., 3] = 200, 128
    cv2.imwrite(str(tmp_path / "d.png"), rgba)
    white = tcommon.imread_rgb_white(str(tmp_path / "d.png"))
    np.testing.assert_allclose(white[..., 0].astype(float), round(200 * a + (1 - a) * 255),
                               atol=1)
    with pytest.raises(FileNotFoundError):
        tcommon.imread_rgb(str(tmp_path / "missing.png"))
    # area resize and the parse map (BGR on disk against the RGB palette;
    # an unknown colour is background), at its size and resized
    img = rng.rand(20, 20, 3).astype(np.float32)
    np.testing.assert_array_equal(tcommon.resize_area(img, 10, 12),
                                  jcommon.resize_area(img, 10, 12))
    assert tcommon.resize_area(img, 20, 20) is img
    labels = rng.randint(0, 12, (16, 16))
    colours = tseg.PALETTE[labels].astype(np.uint8)
    colours[0, 0] = (17, 17, 17)
    p = str(tmp_path / "mask.png")
    cv2.imwrite(p, colours)
    for h, w in ((16, 16), (8, 8)):
        got = tcommon.read_parse_map(p, h, w)
        np.testing.assert_array_equal(got, jcommon.read_parse_map(p, h, w))
    got = tcommon.read_parse_map(p, 16, 16)
    assert got[0, 0] == 0 and got.dtype == np.uint8
    bgr = cv2.imread(p, cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(
        tcommon.palette_labels(bgr),
        np.where(jseg.color2label(bgr).any(-1), jseg.color2label(bgr).argmax(-1), 0))
    np.testing.assert_array_equal(tcommon.labels_to_onehot(labels),
                                  jcommon.labels_to_onehot(labels))
    soft = rng.rand(6, 6, 12)
    np.testing.assert_array_equal(tseg.label2color(soft), jseg.label2color(soft))
    # the background inits
    frames = rng.rand(3, 16, 16, 3).astype(np.float32)
    for blur in (False, True):
        np.testing.assert_array_equal(tcommon.average_background(frames, blur),
                                      jcommon.average_background(frames, blur))
    np.testing.assert_array_equal(tcommon.gaussian_blur(frames[0]),
                                  jcommon.gaussian_blur(frames[0]))
    assert tcommon.load_background(str(tmp_path), "audio", 8, 8) is None
    cv2.imwrite(str(tmp_path / "bc.jpg"), rgb)
    np.testing.assert_array_equal(tcommon.load_background(str(tmp_path), "audio", 4, 4),
                                  jcommon.load_background(str(tmp_path), "audio", 4, 4))
    # the decode-once cache
    cache_t, cache_j = tcommon.FrameCache(1, 8, 8, True), jcommon.FrameCache(1, 8, 8, True)
    for c in (cache_t, cache_j):
        c.ensure(0, str(tmp_path / "b.png"), p, 8, 8, white_background=True)
    assert cache_t.loaded[0]
    for k, v in cache_j.frame(0).items():
        np.testing.assert_array_equal(cache_t.frame(0)[k], v)


def test_disk_loaders_name_opencv_when_it_is_missing(tmp_path, monkeypatch):
    """Without OpenCV a disk loader raises an ImportError that names it;
    the in-memory fixture needs none."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        tcommon.imread_rgb(str(tmp_path / "x.png"))
    with pytest.raises(ImportError, match="cv2"):
        tsynthetic.write_synthetic_dataset(str(tmp_path / "ds"))
    ds = tsynthetic.SyntheticFaceDataset("audio", num_frames=1, H=8, W=8)
    assert ds[0]["mask"].shape == (8, 8, 12)
