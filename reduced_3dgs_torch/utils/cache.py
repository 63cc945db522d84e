"""The kernels' build cache (counterpart of reduced_3dgs_tpu/utils/cache.py,
which sets JAX's persistent compile cache).

The port compiles its CUDA kernels and its native PLY library at first use
into ``ops/rasterize/_build.BUILD_DIR``, by default the git-ignored
``reduced_3dgs_torch/_build/``; each library's file name hashes its sources
and flags, so a directory that persists across runs makes every build a
one-time cost. ``enable_compile_cache`` points that directory elsewhere.
"""
from __future__ import annotations

import os

from ..ops.rasterize import _build

DEFAULT_BUILD_DIR = _build.BUILD_DIR


def enable_compile_cache(path: str = None) -> str:
    """Build into ``path``, else ``$R3DGS_COMPILE_CACHE``; with neither,
    the directory stays as it is (``DEFAULT_BUILD_DIR`` unless moved
    before), so calling it again changes nothing. Returns the directory
    used before, so a caller can restore it. Libraries already loaded stay
    loaded."""
    previous = _build.BUILD_DIR
    path = path or os.environ.get("R3DGS_COMPILE_CACHE")
    if path:
        _build.BUILD_DIR = os.path.abspath(os.path.expanduser(path))
    return previous
