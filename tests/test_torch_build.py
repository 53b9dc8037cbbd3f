"""The port's kernel libraries are named after everything they are built
from: a library's path changes when its source, a shared header
(``csrc/*.cuh``) or an nvcc flag changes, and not when an unrelated file
does. Runs on the CPU: naming a library needs no nvcc."""

import shutil

import pytest

from ray_tpu_torch import _build

NAMES = ("flash_attention", "flash_attention_bwd", "paged_attention")


@pytest.fixture
def csrc(tmp_path):
    return shutil.copytree(_build.CSRC, tmp_path / "csrc")


def _paths(csrc, flags=_build.NVCC_FLAGS):
    return {n: _build.library_path(n, csrc, flags) for n in NAMES}


def test_a_copy_of_the_sources_names_the_same_libraries(csrc):
    assert _paths(csrc) == {n: _build.library_path(n) for n in NAMES}
    assert all(p.parent == _build.BUILD_DIR for p in _paths(csrc).values())


@pytest.mark.parametrize("header", ["hopper.cuh", "new_primitives.cuh"])
def test_editing_or_adding_a_shared_header_renames_every_library(csrc, header):
    before = _paths(csrc)
    path = csrc / header
    text = path.read_text() if path.exists() else ""
    path.write_text(text + "\n// edited\n")
    after = _paths(csrc)
    assert all(after[n] != before[n] for n in NAMES)


@pytest.mark.parametrize(
    "flags",
    [_build.NVCC_FLAGS + ("-DEXTRA",), tuple(f for f in _build.NVCC_FLAGS if f != "-O3")],
    ids=["added", "removed"],
)
def test_changing_an_nvcc_flag_renames_every_library(csrc, flags):
    before = _paths(csrc)
    after = _paths(csrc, flags)
    assert all(after[n] != before[n] for n in NAMES)


@pytest.mark.parametrize("edited", NAMES)
def test_editing_a_source_renames_only_its_own_library(csrc, edited):
    before = _paths(csrc)
    src = csrc / f"{edited}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = _paths(csrc)
    for n in NAMES:
        assert (after[n] != before[n]) == (n == edited), n


def test_an_unrelated_file_leaves_every_library_name(csrc):
    before = _paths(csrc)
    (csrc / "NOTES.txt").write_text("not a source\n")
    (csrc / "scratch.h").write_text("// a plain header no source includes\n")
    assert _paths(csrc) == before
