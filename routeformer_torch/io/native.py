"""Build and load the port's host libraries (``routeformer_torch/csrc/
gpmf.cpp``, the GPMF walker, and ``csrc/audio.cpp``, the AAC decoder over
the system ffmpeg libraries).

Each source is compiled by ``g++`` (``-O3 -std=c++17 -shared -fPIC`` and
its libraries) at first use into ``build/host/`` at the repository root
(listed in ``.gitignore``); the library name carries a hash of the source
and the flags, so an edited source is rebuilt. A build or load that fails
raises an ``ImportError`` naming the library and the compiler's or the
loader's words: no caller falls back quietly. Nothing here runs when a
module is imported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
# source -> the libraries it links (the audio decoder: ffmpeg's)
LINKS = {"gpmf": [], "audio": ["-lavformat", "-lavcodec", "-lavutil"]}

_lock = threading.Lock()
_libs = {}


def target(name: str) -> Path:
    """The library of ``csrc/<name>.cpp``, named by a hash of the source
    and its flags."""
    h = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(FLAGS + LINKS[name]).encode())
    return BUILD_DIR / f"librf{name}_{h.hexdigest()[:16]}.so"


def _build(name: str, path: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise ImportError(f"lib{name}: g++ not found, so csrc/{name}.cpp cannot be built")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *FLAGS, str(CSRC / f"{name}.cpp"), "-o", str(tmp),
                           *LINKS[name]], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        libs = ", ".join(f"lib{flag[2:]}" for flag in LINKS[name])
        needs = f" (it needs {libs} and their headers)" if libs else ""
        raise ImportError(f"lib{name}: g++ could not build csrc/{name}.cpp{needs}:\n"
                          f"{proc.stderr.strip()[-2000:]}")
    os.replace(tmp, path)


def library(name: str) -> ctypes.CDLL:
    """Build (once) and load the library of ``csrc/<name>.cpp``."""
    path = target(name)
    with _lock:
        lib = _libs.get(path)
        if lib is None:
            if not path.exists():
                _build(name, path)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise ImportError(f"lib{name}: {path} does not load: {e}") from e
            _libs[path] = lib
    return lib
