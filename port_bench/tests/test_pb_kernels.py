"""The kernels' build gives nvcc a temporary directory inside the checkout,
whatever TMPDIR the run was given, and restores TMPDIR after."""
import os

import pytest

from conftest import ROOT  # noqa: F401  (puts the repository on sys.path)
from port_bench import kernels
from sahs_tpu_torch.ops.kernels import _build


@pytest.mark.parametrize("given", ["missing", "unset"])
def test_build_runs_nvcc_with_a_temporary_directory_of_its_own(given, monkeypatch, tmp_path):
    seen = []

    def build_all():
        tmp = os.environ.get("TMPDIR")
        seen.append((tmp, os.path.isdir(tmp or "")))

    monkeypatch.setattr(_build, "build_all", build_all)
    monkeypatch.setattr(kernels, "NVCC_TMP", str(tmp_path / "build" / "nvcc_tmp"))
    if given == "missing":
        monkeypatch.setenv("TMPDIR", str(tmp_path / "not_there"))
    else:
        monkeypatch.delenv("TMPDIR", raising=False)
    kernels.build()
    assert seen == [(kernels.NVCC_TMP, True)]
    if given == "missing":
        assert os.environ["TMPDIR"] == str(tmp_path / "not_there")
    else:
        assert "TMPDIR" not in os.environ


def test_build_restores_tmpdir_when_the_build_fails(monkeypatch, tmp_path):
    def build_all():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(_build, "build_all", build_all)
    monkeypatch.setattr(kernels, "NVCC_TMP", str(tmp_path / "nvcc_tmp"))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    with pytest.raises(RuntimeError):
        kernels.build()
    assert os.environ["TMPDIR"] == str(tmp_path)


def test_the_temporary_directory_lies_in_the_checkout_under_build():
    assert kernels.NVCC_TMP == os.path.join(ROOT, "build", "nvcc_tmp")
    assert os.path.dirname(kernels.NVCC_TMP) == os.path.dirname(_build.BUILD_DIR)
