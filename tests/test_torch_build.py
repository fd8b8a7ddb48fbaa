"""The kernel build's cache key: a library is rebuilt when its source or
any header it may include changes (``_build.library_path``).  CPU only:
nothing is compiled, only the library names are compared."""
import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the CUDA sources that the build reads instead of the
    package's own."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_the_sources_include_only_headers_of_csrc():
    """Every header a source includes lies in csrc/, so hashing csrc/*.cuh
    covers them all."""
    headers = {p.name for p in _build.CSRC.glob("*.cuh")}
    for name in _build.SOURCES:
        text = (_build.CSRC / f"{name}.cu").read_text()
        for line in text.splitlines():
            if line.startswith('#include "'):
                assert line.split('"')[1] in headers, (name, line)


@pytest.mark.parametrize("header", ["common.cuh", "hopper_mma.cuh"])
@pytest.mark.parametrize("name", ["flash_attention", "ring_gather"])
def test_editing_a_header_changes_the_library(csrc, header, name):
    before = _build.library_path(name)
    path = csrc / header
    path.write_text(path.read_text() + "\n// edited\n")
    after = _build.library_path(name)
    assert after != before
    assert after.parent == before.parent == _build.BUILD_DIR


def test_a_new_header_changes_the_library(csrc):
    before = _build.library_path("flash_attention")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path("flash_attention") != before


def test_editing_a_source_changes_only_its_library(csrc):
    flash = _build.library_path("flash_attention")
    ring = _build.library_path("ring_gather")
    path = csrc / "flash_attention.cu"
    path.write_text(path.read_text() + "\n// edited\n")
    assert _build.library_path("flash_attention") != flash
    assert _build.library_path("ring_gather") == ring


def test_a_copy_hashes_as_the_original(tmp_path, monkeypatch):
    """Same names and bytes, same library: the key holds no path."""
    want = _build.library_path("flash_attention")
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    assert _build.library_path("flash_attention") == want
