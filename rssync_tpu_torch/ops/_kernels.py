"""Build and load the port's CUDA kernels.

The sources under `rssync_tpu_torch/csrc/` are compiled with nvcc for
Hopper (`sm_90a`), one nvcc process per source, all started together,
and linked into one shared library with a plain C interface, at first
use, into `rssync_tpu_torch/build/` (listed in .gitignore). The
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
SOURCES = (
    "score_quartile.cu", "gather_strips.cu", "convert_u8.cu", "copy_block.cu",
    "extract_patches.cu", "lift_rays.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
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


def _headers(csrc: Path) -> bytes:
    """The headers the sources of `csrc` share, names and contents."""
    return b"".join(p.name.encode() + p.read_bytes() for p in sorted(csrc.glob("*.cuh")))


def _library_path() -> Path:
    h = hashlib.sha256(_headers(CSRC))
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librssync_kernels_{h.hexdigest()[:16]}.so"


def _nvcc_all(cmds: list[list[str]]) -> None:
    """Run the nvcc commands at once; raise with every failure's output."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for cmd in cmds
    ]
    errors = []
    for cmd, p in procs:
        _, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{err}")
    if errors:
        raise RuntimeError("\n".join(errors))


def _build(target: Path) -> None:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    # compile into a private directory, then rename the library into
    # place: concurrent builds never load a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, Path(s).stem + ".o") for s in SOURCES]
        _nvcc_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)]
                   for s, o in zip(SOURCES, objs)])
        lib = os.path.join(tmp, "lib.so")
        _nvcc_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, target)
    build_seconds = time.perf_counter() - t0


def build_single(src: Path) -> ctypes.CDLL:
    """One CUDA source (an earlier checkout's kernel) built alone with the
    port's nvcc flags, cached by its content and its directory's headers
    in `BUILD_DIR`/singles/, and loaded unbound: the caller sets the
    argument types."""
    out_dir = BUILD_DIR / "singles"
    out_dir.mkdir(parents=True, exist_ok=True)
    h = hashlib.sha256(src.read_bytes() + _headers(src.parent) + " ".join(NVCC_FLAGS).encode())
    lib_path = out_dir / f"lib{src.stem}_{h.hexdigest()[:16]}.so"
    if not lib_path.exists():
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            lib = os.path.join(tmp, "lib.so")
            _nvcc_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", lib, str(src)]])
            os.replace(lib, lib_path)
    return ctypes.CDLL(str(lib_path))


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
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.score_quartile_launch.restype = ctypes.c_int
        lib.score_quartile_i16_launch.argtypes = lib.score_quartile_launch.argtypes
        lib.score_quartile_i16_launch.restype = ctypes.c_int
        lib.score_quartile_kernel_attrs.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.score_quartile_kernel_attrs.restype = ctypes.c_int
        lib.score_quartile_error_string.argtypes = [ctypes.c_int]
        lib.score_quartile_error_string.restype = ctypes.c_char_p
        lib.gather_strips_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.gather_strips_launch.restype = ctypes.c_int
        lib.gather_strips_error_string.argtypes = [ctypes.c_int]
        lib.gather_strips_error_string.restype = ctypes.c_char_p
        lib.convert_u8_bf16_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.convert_u8_bf16_launch.restype = ctypes.c_int
        lib.copy_block_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.copy_block_launch.restype = ctypes.c_int
        lib.extract_patches_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.extract_patches_launch.restype = ctypes.c_int
        lib.extract_patches_kernel_attrs.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.extract_patches_kernel_attrs.restype = ctypes.c_int
        lib.lift_rays_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_void_p,
        ]
        lib.lift_rays_launch.restype = ctypes.c_int
        for fn in (lib.convert_u8_bf16_error_string, lib.copy_block_error_string,
                   lib.extract_patches_error_string, lib.lift_rays_error_string):
            fn.argtypes = [ctypes.c_int]
            fn.restype = ctypes.c_char_p
        _lib = lib
        return lib
