"""Build and load the port's CUDA kernels.

The sources under `rssync_tpu_torch/csrc/` are compiled with nvcc for
Hopper (`sm_90a`) into a shared library with a plain C interface, at
first use, into `rssync_tpu_torch/build/` (listed in .gitignore). The
library name carries a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded. It is bound
with ctypes: every pointer and the stream are passed as c_void_p.

Nothing here runs at import: the CPU-only test environment imports
every module and has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("score_quartile.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the CUDA kernels cannot be built"
    )


def _library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librssync_kernels_{h.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # compile to a private name, then rename: concurrent builds never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, target)
    build_seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The kernels' shared library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.score_quartile_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.score_quartile_launch.restype = ctypes.c_int
        lib.score_quartile_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.score_quartile_smem_bytes.restype = ctypes.c_size_t
        lib.score_quartile_error_string.argtypes = [ctypes.c_int]
        lib.score_quartile_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib
