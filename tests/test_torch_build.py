"""The kernels' build and binding on the CPU: nothing is compiled.

A library's name hashes its source, every shared header (``csrc/*.cuh``)
and the flags, so an edited header rebuilds every library; the ctypes
signatures agree with the C entries of the sources.
"""

import ctypes
import re

import pytest

from routeformer_torch.ops import cuda_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "kernel.cu").write_text('#include "frag.cuh"\nint f() { return 0; }\n')
    (tmp_path / "frag.cuh").write_text("#pragma once\n")
    return tmp_path


@pytest.mark.parametrize("edit", ["header", "source", "new header", "none"])
def test_library_name_follows_source_and_headers(csrc, edit):
    before = cuda_build._target("kernel")
    assert before.parent == csrc / "build" and before.name.startswith("libkernel_")
    if edit == "header":
        (csrc / "frag.cuh").write_text("#pragma once\n// edited\n")
    elif edit == "source":
        (csrc / "kernel.cu").write_text('#include "frag.cuh"\nint f() { return 1; }\n')
    elif edit == "new header":
        (csrc / "other.cuh").write_text("#pragma once\n")
    after = cuda_build._target("kernel")
    assert (after == before) == (edit == "none")


def test_library_name_follows_flags(csrc, monkeypatch):
    before = cuda_build._target("kernel")
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", [*cuda_build.NVCC_FLAGS, "-lineinfo"])
    assert cuda_build._target("kernel") != before


_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _c_entries(source: str) -> dict:
    """``{name: [ctypes type, ...]}`` of the ``extern "C"`` functions."""
    entries = {}
    for name, params in re.findall(r'extern "C"\s+[\w ]+?\s+(\w+)\(([^)]*)\)', source):
        types = []
        for param in params.split(","):
            decl = " ".join(param.split()[:-1]).replace("const ", "")
            types.append(ctypes.c_void_p if "*" in param else _C_TYPES[decl])
        entries[name] = types
    return entries


@pytest.mark.parametrize("name", sorted(cuda_build.SIGNATURES))
def test_signatures_match_the_c_entries(name):
    entries = _c_entries((cuda_build.CSRC / f"{name}.cu").read_text())
    assert entries.keys() == cuda_build.SIGNATURES[name].keys()
    for fn, argtypes in cuda_build.SIGNATURES[name].items():
        assert entries[fn] == argtypes, fn


@pytest.mark.parametrize("name", ["swin_block", "perceive_stack"])
def test_gemm_core_header_is_hashed_into_k1_and_k3(tmp_path, monkeypatch, name):
    """K1 and K3 include the Hopper GEMM core (``gemm_sm90.cuh``): an edit of
    it renames (so rebuilds) both libraries."""
    real = cuda_build.CSRC
    assert '#include "gemm_sm90.cuh"' in (real / f"{name}.cu").read_text()
    for f in real.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    before = cuda_build._target(name)
    assert cuda_build._target(name) == before
    (tmp_path / "gemm_sm90.cuh").write_text((real / "gemm_sm90.cuh").read_text() + "\n")
    assert cuda_build._target(name) != before
