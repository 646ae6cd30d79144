"""The port's kernel build cache key (``ray_tpu_torch/ops/_build.py``).

A library is keyed by its ``.cu``, every ``csrc`` header that source
includes (recursively), the nvcc flags and the compiler: an edited header
must rebuild.  The key is computed from files alone, so these tests run
where there is no nvcc.
"""

import pytest

from ray_tpu_torch.ops import _build

NVCC = "/usr/local/cuda/bin/nvcc"


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\n'
                                   '  # include "b.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// included by nothing\n")
    monkeypatch.setattr(_build, "_CSRC", str(tmp_path))
    return tmp_path


def test_sources_follow_quoted_includes_once(csrc):
    assert _build._sources_of("k") == ["k.cu", "a.cuh", "b.cuh"]


@pytest.mark.parametrize("edited", ["k.cu", "a.cuh", "b.cuh"])
def test_an_edit_to_the_source_or_a_header_it_includes_rebuilds(csrc, edited):
    key = _build._target("k", NVCC)
    old = (csrc / edited).read_text()
    (csrc / edited).write_text(old + "// edited\n")
    assert _build._target("k", NVCC) != key
    (csrc / edited).write_text(old)
    assert _build._target("k", NVCC) == key


def test_an_unrelated_header_flags_and_compiler(csrc, monkeypatch):
    key = _build._target("k", NVCC)
    (csrc / "other.cuh").write_text("// edited\n")
    assert _build._target("k", NVCC) == key
    assert _build._target("k", "/usr/local/cuda-12.4/bin/nvcc") != key
    monkeypatch.setattr(_build, "_FLAGS", _build._FLAGS + ["-lineinfo"])
    assert _build._target("k", NVCC) != key


# the csrc headers each library on hopper.cuh includes, in include order
_HEADERS = {"flash_attention": ["flash_common.cuh", "hopper.cuh"],
            "flash_attention_d256": ["flash_common.cuh", "hopper.cuh"],
            "grouped_matmul": ["hopper.cuh"],
            "paged_attention": ["hopper.cuh"]}


@pytest.mark.parametrize("name", list(_HEADERS))
def test_the_flash_library_is_keyed_by_its_hopper_header(name):
    # every library built on hopper.cuh (the flash kernels through
    # flash_common.cuh, the grouped-matmul and paged-attention kernels)
    # rebuilds when it changes
    assert _build._sources_of(name) == [name + ".cu", *_HEADERS[name]]
