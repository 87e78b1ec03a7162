"""The name of a built kernel library changes with its source and with every
shared header under csrc/, so an edited header is never served by a stale
library. No nvcc is needed: only the name is computed."""

import pytest

from cvsd_tpu_torch.utils import cuda_build


@pytest.mark.parametrize("edited", ["kern.cu", "common.cuh"])
def test_library_path_follows_source_and_headers(tmp_path, monkeypatch, edited):
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    (tmp_path / "kern.cu").write_text('#include "common.cuh"\n__global__ void k() {}\n')
    (tmp_path / "common.cuh").write_text("#pragma once\nconstexpr int kWords = 8;\n")
    before = cuda_build.library_path("kern")
    assert cuda_build.library_path("kern") == before
    assert before.name.startswith("kern-") and before.suffix == ".so"
    (tmp_path / edited).write_text((tmp_path / edited).read_text() + "// edited\n")
    assert cuda_build.library_path("kern") != before
