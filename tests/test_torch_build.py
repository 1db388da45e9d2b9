"""`polyaxon_tpu_torch/ops/_build.py` keys a built library by its source,
every header under csrc/ that the source includes, and the flags. These
tests need no nvcc: they point the module at a temporary csrc/."""

import pytest

from polyaxon_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    root = tmp_path / "csrc"
    root.mkdir()
    monkeypatch.setattr(_build, "CSRC", root)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return root


def test_library_path_follows_included_headers(csrc):
    (csrc / "kern.cu").write_text('#include <cuda_runtime.h>\n#include "tiles.cuh"\n')
    (csrc / "tiles.cuh").write_text('#pragma once\n#include "detail/ptx.cuh"\n')
    (csrc / "detail").mkdir()
    (csrc / "detail" / "ptx.cuh").write_text("// v1\n")
    (csrc / "unused.cuh").write_text("// not included\n")
    assert [p.name for p in _build.sources("kern")] == ["ptx.cuh", "kern.cu", "tiles.cuh"]

    first = _build.library_path("kern")
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libkern-")
    assert _build.library_path("kern") == first  # stable
    (csrc / "unused.cuh").write_text("// edited, still not included\n")
    assert _build.library_path("kern") == first
    (csrc / "detail" / "ptx.cuh").write_text("// v2\n")  # an included header
    second = _build.library_path("kern")
    assert second != first
    (csrc / "kern.cu").write_text('#include "tiles.cuh"\n')  # the source itself
    assert _build.library_path("kern") not in (first, second)


def test_cutlass_include_only_where_a_source_uses_it(csrc):
    (csrc / "plain.cu").write_text('#include "plain.cuh"\n')
    (csrc / "plain.cuh").write_text("#include <cuda_bf16.h>\n")
    (csrc / "cute.cu").write_text('#include "atoms.cuh"\n')
    (csrc / "atoms.cuh").write_text("#include <cute/arch/mma_sm90_gmma.hpp>\n")
    assert _build.nvcc_flags("plain") == _build.NVCC_FLAGS
    flags = _build.nvcc_flags("cute")
    assert flags[: len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
    assert flags[len(_build.NVCC_FLAGS):] == ("-I", _build.CUTLASS_INCLUDE)


def test_the_port_sources_include_their_header():
    names = [p.name for p in _build.sources("flash_bwd")]
    assert names == ["flash_bwd.cu", "hopper_wgmma.cuh"]
    assert _build.nvcc_flags("flash_bwd") == _build.NVCC_FLAGS
    assert [p.name for p in _build.sources("flash_fwd")] == ["flash_fwd.cu", "hopper_wgmma.cuh"]
    assert _build.nvcc_flags("flash_fwd") == _build.NVCC_FLAGS
