"""Build and load the hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` holds one or more kernels, each with a plain
C launcher, and may include the headers ``csrc/*.cuh``. It is compiled by
nvcc for sm_90a into a shared library under ``reduced_3dgs_torch/_build/``
(git-ignored) at first use, and loaded with ctypes. The library's file name
carries a hash of its source, the headers and the flags, so an edited source
or header is rebuilt. nvcc's output, with ptxas's report of each
kernel's registers, shared memory and spills (``-Xptxas -v``), is kept beside
the library and read by ``resource_usage``. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import re
import shutil
import subprocess

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC_DIR)

_p = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
# C signature of each kernel's launcher, by symbol; every launcher returns a
# cudaError_t. tile_order is int32 [num_tiles] scratch that the launcher
# fills (the order in which blocks take tiles) before it launches the kernel.
# tile_row_offset is the image's tile row of the first row of a band of tile
# rows (0 for the whole image).
ARGTYPES = {
    # composite_fwd(e, K, range_start, range_end, tile_order, num_tiles,
    #               tiles_x, tile_row_offset, color4, final_t, latch, stream)
    "composite_fwd": (_p, _i, _p, _p, _p, _i, _i, _i, _p, _p, _p, _p),
    # composite_fwd_stats(e, K, range_start, range_end, tile_order, num_tiles,
    #                     tiles_x, tile_row_offset, color4, final_t, latch, stats,
    #                     stream)
    "composite_fwd_stats": (_p, _i, _p, _p, _p, _i, _i, _i, _p, _p, _p, _p, _p),
    # composite_bwd(e, K, range_start, range_end, tile_order, num_tiles,
    #               tiles_x, tile_row_offset, final_t, latch, g_color4, g_t, ids,
    #               n_out, grads, stream)
    "composite_bwd": (_p, _i, _p, _p, _p, _i, _i, _i, _p, _p, _p, _p, _p, _i, _p, _p),
    # preprocess_fwd(n, degree, sh_stride, aligned, means, opac, scales, rots, shs,
    #                colors, offset, view, proj, campos, c_stride, H, W, tiles_x, tiles_y,
    #                fx, fy, lim_x, lim_y, modifier, fields, radii, rect_min, rect_max,
    #                tiles, stream)
    "preprocess_fwd": (_i, _i, _i, _i, *(_p,) * 10, *(_i,) * 5, *(_f,) * 5, *(_p,) * 6),
    # preprocess_bwd(n, degree, sh_stride, aligned, means, opac, scales, rots, shs,
    #                view, proj, campos, c_stride, H, W, tiles_x, tiles_y, fx, fy, lim_x,
    #                lim_y, modifier, g_fields, g_stride, d_means, d_opac, d_scales,
    #                d_rots, d_shs, d_offset, d_colors, cam_partial, cam_out, stream)
    "preprocess_bwd": (_i, _i, _i, _i, *(_p,) * 8, *(_i,) * 5, *(_f,) * 5, _p,
                       ctypes.c_longlong, *(_p,) * 10),
    # binning_scratch_bytes(n, k, bits, count_bytes*, sort_bytes*): host only
    "binning_scratch_bytes": (_i, _i, _i, ctypes.POINTER(ctypes.c_longlong),
                              ctypes.POINTER(ctypes.c_longlong)),
    # binning_count(n, rect_min, rect_max, tiles_touched, depth_bits, tiles_y,
    #               tile_row_offset, counts, offsets, keys, ids, scratch, scratch_bytes,
    #               stream)
    "binning_count": (_i, *(_p,) * 4, _i, _i, *(_p,) * 5, ctypes.c_longlong, _p),
    # binning_sort(n, K, num_tiles, tiles_x, tiles_y, tile_row_offset, bits, tail_scratch,
    #              rect_min, rect_max, counts, offsets, keys, keys_alt, ids, ids_alt, kept,
    #              ends, tiles_a, tiles_b, gid_a, gid_b, scratch, scratch_bytes, s_tile,
    #              s_gidx, valid, overflow, range_start, range_end, stream)
    "binning_sort": (*(_i,) * 8, *(_p,) * 15, ctypes.c_longlong, *(_p,) * 7),
    # adam_fused(n, sizes, arrays, lr_at, lrs, count, b1, c1, b2, c2, eps, stream):
    # sizes, arrays (p, g, m, v of each tensor), lr_at and lrs are host arrays
    "adam_fused": (_i, *(_p,) * 5, *(_f,) * 5, _p),
}
# The source (csrc/<name>.cu, and the library built from it) of each symbol.
SOURCE_OF = {"composite_fwd": "composite_fwd", "composite_fwd_stats": "composite_fwd",
             "composite_bwd": "composite_bwd", "preprocess_fwd": "preprocess",
             "preprocess_bwd": "preprocess", "binning_scratch_bytes": "binning",
             "binning_count": "binning", "binning_sort": "binning", "adam_fused": "adam"}
SOURCES = tuple(sorted(set(SOURCE_OF.values())))
# Tensors one launch of the Adam kernel takes (csrc/adam.cu's kMaxTensors).
ADAM_MAX_TENSORS = 8
# nvcc flags of one source beside NVCC_FLAGS. The preprocess rounds every
# product and sum on its own, as the plain version does (no contraction into
# fused multiply-adds), so that the near cull and the integer rectangles
# follow the plain version's bits. The Adam kernel's tensor limit is
# defined here alone.
SOURCE_FLAGS = {"preprocess": ("-fmad=false",),
                "adam": (f"-DADAM_MAX_TENSORS={ADAM_MAX_TENSORS}",)}


def nvcc_flags(name: str) -> tuple:
    """The nvcc flags of source ``name``."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def _library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(nvcc_flags(name)).encode())
    for path in [os.path.join(CSRC_DIR, f"{name}.cu")] + sorted(
            glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def _log_path(library: str) -> str:
    return library[:-len(".so")] + ".nvcc.txt"


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
        proc = subprocess.Popen([_nvcc(), *nvcc_flags(name), "-o", tmp, src],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
        else:
            with open(_log_path(out), "w") as f:
                f.write(log)
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
    """The kernel library built from ``csrc/<name>.cu``, with its launchers'
    argtypes set. When it is not built yet, every source not built yet is
    compiled first, all at once: a run that needs one library soon needs
    the others, and parallel builds cost the longest one alone. Raises
    RuntimeError with nvcc's output if a build fails."""
    build_libraries(SOURCES)
    return set_argtypes(ctypes.CDLL(_library_path(name)), name)


def _kernel_name(mangled: str) -> str:
    """The kernel's identifier in a mangled name, with its bool and int
    template arguments: ``composite_fwd_kernel<false>``,
    ``preprocess_bwd_kernel<-1, true>``. Reads the length-prefixed names of
    ``_Z<name>`` or ``_ZN<name><name>...`` in order."""
    pos = 3 if mangled.startswith("_ZN") else 2
    while m := re.match(r"\d+", mangled[pos:]):
        start = pos + m.end()
        pos = start + int(m.group())
        ident = mangled[start:pos]
        if ident.endswith("_kernel"):
            args = re.match(r"I((?:L[bi]n?\d+E)+)E", mangled[pos:])
            if not args:
                return ident
            values = []
            for kind, neg, digits in re.findall(r"L([bi])(n?)(\d+)E", args.group(1)):
                values.append(("false", "true")[int(digits)] if kind == "b"
                              else f"{'-' if neg else ''}{digits}")
            return f"{ident}<{', '.join(values)}>"
    return mangled


def parse_ptxas(log: str) -> dict:
    """{kernel: {"registers", "smem_bytes", "spill_stores", "spill_loads",
    "stack_bytes"}} from nvcc's ``-Xptxas -v`` output."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            usage[name] = dict(registers=None, smem_bytes=0, spill_stores=0, spill_loads=0,
                               stack_bytes=0)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            usage[name].update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            usage[name]["smem_bytes"] = int(m.group(1)) if m else 0
    return usage


def resource_usage(name: str) -> dict:
    """Registers, shared memory and spills of each kernel of
    ``csrc/<name>.cu`` as ptxas reported them when it was built (built
    first if it is not)."""
    build_libraries([name])
    with open(_log_path(_library_path(name))) as f:
        return parse_ptxas(f.read())
