"""ctypes bindings of the native PLY reader/writer and COLMAP points parser
(counterpart of reduced_3dgs_tpu/models/native_io.py).

The C++ source is the port's own copy, ``models/csrc/ply_io.cpp``. It is
compiled with g++ at first use into the build directory of the CUDA kernels
(``ops/rasterize/_build.BUILD_DIR``, git-ignored), under a name that hashes
the source and the flags. Each function returns None (False for the writer)
when the library cannot be built or loaded, or when the file is one the
native reader does not take (ascii, list properties, a body shorter than
its header says); the callers in ``models/ply.py`` and ``dataset/colmap.py``
then run their numpy code, which is the behavioural definition: the native
writer's bytes equal it. The choice is not silent: ``active()`` says
whether the library is loaded, ``build_error()`` why it is not, and
``last_path(op)`` which path the last ``read_ply``, ``write_ply`` or
``read_colmap_points`` call took ("native" or "numpy").
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np

from ..ops.rasterize import _build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "ply_io.cpp")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_DTYPES = ["i1", "u1", "i2", "u2", "i4", "u4", "f4", "f8"]

_lock = threading.Lock()
_lib = None
_error: Optional[str] = None
_last = {}


def library_path() -> str:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(_build.BUILD_DIR, f"libply_io_{digest.hexdigest()[:16]}.so")


def _build_library(out: str) -> None:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)


def get_lib():
    """The native library, built first if needed, or None when it cannot be
    built or loaded (``build_error()`` then says why). Tried once."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            path = library_path()
            if not os.path.exists(path):
                _build_library(path)
            lib = ctypes.CDLL(path)
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            _error = str(exc)
            return None
        lib.r3dgs_ply_open.restype = ctypes.c_void_p
        lib.r3dgs_ply_open.argtypes = [ctypes.c_char_p]
        lib.r3dgs_ply_num_elements.argtypes = [ctypes.c_void_p]
        lib.r3dgs_ply_element_name.restype = ctypes.c_char_p
        lib.r3dgs_ply_element_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.r3dgs_ply_element_count.restype = ctypes.c_uint64
        lib.r3dgs_ply_element_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.r3dgs_ply_num_properties.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.r3dgs_ply_property_name.restype = ctypes.c_char_p
        lib.r3dgs_ply_property_name.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.r3dgs_ply_property_dtype.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.r3dgs_ply_element_rows.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p]
        lib.r3dgs_ply_close.argtypes = [ctypes.c_void_p]
        lib.r3dgs_ply_write.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                        ctypes.POINTER(ctypes.c_char_p),
                                        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
        lib.r3dgs_colmap_points.restype = ctypes.c_int64
        lib.r3dgs_colmap_points.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
        return _lib


def active() -> bool:
    """Whether the native library is built and loaded (building it now if
    it has not been tried)."""
    return get_lib() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built or loaded, or None."""
    get_lib()
    return _error


def last_path(op: str) -> Optional[str]:
    """"native" or "numpy": the path the last ``op`` call took."""
    return _last.get(op)


def _took(op: str, native: bool) -> bool:
    """Record the path of ``op``: the caller runs the numpy code when the
    native one returns nothing."""
    _last[op] = "native" if native else "numpy"
    return native


def read_ply_native(path: str) -> Optional["OrderedDict[str, np.ndarray]"]:
    lib = get_lib()
    h = None if lib is None else lib.r3dgs_ply_open(os.fsencode(path))
    if not _took("read_ply", bool(h)):
        return None
    try:
        out = OrderedDict()
        for i in range(lib.r3dgs_ply_num_elements(h)):
            name = lib.r3dgs_ply_element_name(h, i).decode()
            count = lib.r3dgs_ply_element_count(h, i)
            fields = [(lib.r3dgs_ply_property_name(h, i, j).decode(),
                       "<" + _DTYPES[lib.r3dgs_ply_property_dtype(h, i, j)])
                      for j in range(lib.r3dgs_ply_num_properties(h, i))]
            buf = np.empty(count, dtype=np.dtype(fields))
            lib.r3dgs_ply_element_rows(h, i, buf.ctypes.data_as(ctypes.c_char_p))
            out[name] = buf
        return out
    finally:
        lib.r3dgs_ply_close(h)


def write_ply_native(path: str, header: bytes, blobs) -> bool:
    """Write ``header`` then each of ``blobs`` (``ply.encode_ply`` makes
    both); False when the library is not there or the write fails."""
    lib = get_lib()
    if lib is None:
        return _took("write_ply", False)
    n = len(blobs)
    bufs = (ctypes.c_char_p * n)(*blobs)
    sizes = (ctypes.c_uint64 * n)(*[len(b) for b in blobs])
    return _took("write_ply", lib.r3dgs_ply_write(os.fsencode(path), header, bufs, sizes,
                                                  n) == 0)


def read_colmap_points_native(path: str):
    """(xyz [n,3] float64, rgb [n,3] uint8) of a points3D.bin, or None."""
    lib = get_lib()
    n = -1 if lib is None else lib.r3dgs_colmap_points(os.fsencode(path), None, None)
    if not _took("read_colmap_points", n >= 0):
        return None
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    got = lib.r3dgs_colmap_points(os.fsencode(path), xyz.ctypes.data_as(ctypes.c_void_p),
                                  rgb.ctypes.data_as(ctypes.c_void_p))
    if not _took("read_colmap_points", got == n):
        return None
    return xyz, rgb
