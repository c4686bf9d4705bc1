"""The kernel build's staleness rule (``repro_torch.kernels._build``): a
library is rebuilt when its source or any shared header ``csrc/*.cuh`` is
newer than it. Runs on the CPU; nothing is compiled."""
import os

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    for name in ("a.cu", "b.cu", "shared.cuh"):
        (csrc / name).write_text("// source\n")
        os.utime(csrc / name, (1_000, 1_000))
    return csrc, build


def _lib(build, name, mtime):
    path = build / f"lib{name}.so"
    path.write_bytes(b"")
    os.utime(path, (mtime, mtime))


def test_missing_library_is_stale(tree):
    assert _build._stale("a")


def test_library_newer_than_source_and_headers_is_fresh(tree):
    _lib(tree[1], "a", 2_000)
    assert not _build._stale("a")


@pytest.mark.parametrize("touched", ["a.cu", "shared.cuh"])
def test_newer_source_or_header_makes_the_library_stale(tree, touched):
    csrc, build = tree
    _lib(build, "a", 2_000)
    os.utime(csrc / touched, (3_000, 3_000))
    assert _build._stale("a")


def test_another_kernels_source_does_not_make_a_library_stale(tree):
    csrc, build = tree
    _lib(build, "a", 2_000)
    os.utime(csrc / "b.cu", (3_000, 3_000))
    assert not _build._stale("a")
    assert _build.sources() == ["a", "b"]
