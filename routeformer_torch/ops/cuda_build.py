"""Build and bind the port's CUDA kernels (``routeformer_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, all sources in parallel, at first use, into
``build/kernels/`` at the repository root (listed in ``.gitignore``). The
library name carries a hash of the source and of the shared headers
(``csrc/*.cuh``), so an edited source or header is rebuilt.
The libraries are loaded with ctypes; pointers and the stream travel as
``c_void_p``. Nothing here runs when a module is imported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of the entries in each source (each returns an int CUDA
# error code).
SIGNATURES = {
    "perceive_stack": {
        "rf_perceive_stack_fwd": [_P, _P, _P, _P, _P, _P, _P, _LL, _P, _P, _P, _F,
                                  *[_I] * 9, _P, _LL, _P],
        "rf_perceive_layer_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F,
                                  *[_I] * 8, _I, _P, _LL, _P],
        "rf_perceive_gemm": [_P, _LL, _LL, _P, _LL, _LL, _P, _I, _I, _I, _P, _P, _I, _P, _F,
                             _P, _I, _P, _I, _P, _P, _I, _P],
    },
    "window_attention": {
        "rf_window_attention": [_P, _P, _P, _I, _LL, _LL, _LL, _P, _I, _P, _P,
                                _LL, _LL, _LL, _I, _I, _I, _I, _I, _P],
    },
    "dense_attention": {
        "rf_dense_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, *[_LL] * 12,
                               _F, _I, _P],
    },
    "swin_block": {
        "rf_gemm_bias_act": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "rf_swin_block_tail": [_P, _I, *[_P] * 12, _I, _P, _I, _I, _F, _I, _P],
    },
}

_lock = threading.Lock()
_libs = None
build_info = {"seconds": None, "ptxas": {}}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    """The library of ``<name>.cu``, named by a hash of the source, every
    shared header (``*.cuh``) and the flags: an edited header rebuilds every
    library."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every missing library (in parallel) and return ``{name: path}``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in SIGNATURES}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    start = time.perf_counter()
    procs = {}
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        build_info["ptxas"][name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
        else:
            os.replace(tmp, targets[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    build_info["seconds"] = time.perf_counter() - start
    return targets


def libraries() -> dict:
    """Build (once) and load the kernel libraries: ``{name: ctypes.CDLL}``."""
    global _libs
    with _lock:
        if _libs is None:
            libs = {}
            for name, path in build().items():
                lib = ctypes.CDLL(str(path))
                for fn, argtypes in SIGNATURES[name].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                libs[name] = lib
            _libs = libs
    return _libs


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
