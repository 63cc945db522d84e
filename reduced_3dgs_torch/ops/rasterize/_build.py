"""Build and load the hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` holds one or more kernels, each with a plain
C launcher. It is compiled by nvcc for sm_90a into a shared library under
``reduced_3dgs_torch/_build/`` (git-ignored) at first use, and loaded with
ctypes. The library's file name carries a hash of its source and flags, so
an edited source is rebuilt. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_p = ctypes.c_void_p
_i = ctypes.c_int
# C signature of each kernel's launcher, by symbol; every launcher returns a
# cudaError_t.
ARGTYPES = {
    # composite_fwd(e, K, range_start, range_end, num_tiles, tiles_x,
    #               color4, final_t, latch, stream)
    "composite_fwd": (_p, _i, _p, _p, _i, _i, _p, _p, _p, _p),
    # composite_fwd_stats(e, K, range_start, range_end, num_tiles, tiles_x,
    #                     color4, final_t, latch, stats, stream)
    "composite_fwd_stats": (_p, _i, _p, _p, _i, _i, _p, _p, _p, _p, _p),
    # composite_bwd(e, K, range_start, range_end, num_tiles, tiles_x,
    #               final_t, latch, g_color4, g_t, grads, stream)
    "composite_bwd": (_p, _i, _p, _p, _i, _i, _p, _p, _p, _p, _p, _p),
}
# The source (csrc/<name>.cu, and the library built from it) of each symbol.
SOURCE_OF = {"composite_fwd": "composite_fwd", "composite_fwd_stats": "composite_fwd",
             "composite_bwd": "composite_bwd"}
SOURCES = tuple(sorted(set(SOURCE_OF.values())))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def _library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build_libraries(names) -> None:
    """Compile every library of ``names`` that is not built yet, one nvcc
    process per source, all started together. Raises RuntimeError with
    nvcc's output for the first build that fails."""
    jobs = []
    for name in names:
        out = _library_path(name)
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def set_argtypes(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Set the argtypes of every launcher that source ``name`` defines."""
    for symbol, source in SOURCE_OF.items():
        if source == name:
            fn = getattr(lib, symbol)
            fn.argtypes = ARGTYPES[symbol]
            fn.restype = ctypes.c_int
    return lib


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The kernel library built from ``csrc/<name>.cu``, compiled first if
    it is not built yet, with its launchers' argtypes set. Raises
    RuntimeError with nvcc's output if the build fails."""
    build_libraries([name])
    return set_argtypes(ctypes.CDLL(_library_path(name)), name)
