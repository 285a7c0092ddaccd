"""The port's kernel build cache (detectron_tpu_torch/ops/cuda/build.py): a
library's name carries a hash of everything its build reads, so an edited
source or header builds a new library instead of reusing a stale one. Runs
on the CPU: it only names libraries, it builds none."""

import shutil

import pytest

from detectron_tpu_torch.ops.cuda import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that build reads instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


def test_every_source_is_in_csrc():
    assert sorted(build.SOURCES) == sorted(
        p.name for p in build.CSRC.glob("*.cu"))
    assert (build.CSRC / "window_reach.cuh").exists()


@pytest.mark.parametrize("edited", ["window_reach.cuh", "new_header.cuh"])
def test_library_path_follows_the_headers(csrc, edited):
    """Editing a header, or adding one, renames every source's library;
    building reads nothing else of csrc/ than its .cu and .cuh files."""
    before = {s: build.library_path(s) for s in build.SOURCES}
    assert all(p.parent == build.BUILD_DIR for p in before.values())
    (csrc / "notes.txt").write_text("not read by the build")
    assert {s: build.library_path(s) for s in build.SOURCES} == before
    with open(csrc / edited, "a") as f:
        f.write("\n// edited\n")
    after = {s: build.library_path(s) for s in build.SOURCES}
    for s in build.SOURCES:
        assert after[s] != before[s]
        assert after[s].name.startswith(s[:-len(".cu")] + "-")


def test_library_path_follows_its_source_and_flags(csrc, monkeypatch):
    before = {s: build.library_path(s) for s in build.SOURCES}
    with open(csrc / "roi_window_accum.cu", "a") as f:
        f.write("\n// edited\n")
    after = {s: build.library_path(s) for s in build.SOURCES}
    assert after["roi_window_accum.cu"] != before["roi_window_accum.cu"]
    assert all(after[s] == before[s] for s in build.SOURCES
               if s != "roi_window_accum.cu")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert all(build.library_path(s) != after[s] for s in build.SOURCES)
