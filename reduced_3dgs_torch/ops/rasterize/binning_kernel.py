"""Binning and sort as CUDA kernels (``csrc/binning.cu``). It replaces no
TPU kernel: the JAX package bins in XLA
(reduced_3dgs_tpu/ops/rasterize/tiled.py:174-370); in eager PyTorch the
same code, ``tiled.bin_and_sort_plain``, is some 35 passes over the [K]
entry buffer and one sort of int64 keys over all 64 bits, and took more of
a step than any compositor, so the port writes it by hand.

``bin_and_sort(rect_min, rect_max, tiles_touched, depths, tiles_x, tiles_y,
tile_row_offset=0, key_buffer_size=None)`` returns what
``tiled.bin_and_sort`` does, with every key, dtype and value of the plain
version's dict, bit for bit. The plain version sorts the entries by
(tile, depth bits) stably from Gaussian order; no Gaussian has two entries
in one tile, so the kernels sort the N Gaussians by depth once (stably, so
ties keep index order), emit the entries in that order and sort them stably
on the tile id alone, over the bits the viewport's tile count needs. The
entries a static buffer keeps are the first K in Gaussian order, as in the
plain version; the tail keeps its positions through the tile sort (its tile
is the largest key), so its scratch ids are the plain version's too.

Two launchers, each a wrapper that counts its launches (``launches``):
``bin_count`` (the counts, their scan in Gaussian order, the total) and
``bin_sort`` (the depth sort, the emission, the tile sort, the outputs and
tile ranges). Without ``key_buffer_size`` the total is read between them,
the one host sync; with it nothing syncs, and the pair is captured in a
CUDA graph. Every buffer, CUB's scratch included, comes from
``torch.empty`` on the current stream. CUDA tensors only: ``tiled`` sends
CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ...utils import profiling
from .composite import TAIL_SCRATCH
from .launches import counted, launch

# Every work buffer starts on this many bytes (CUB's loads are vectorised).
_ALIGN = 256


def _check(rect_min, rect_max, tiles_touched, depths):
    """Device, dtype and shape of the inputs; raises ValueError on what the
    kernels do not take."""
    n = rect_min.shape[0] if rect_min.dim() == 2 else -1
    for name, t, dtype, shape in (("rect_min", rect_min, torch.int32, (n, 2)),
                                  ("rect_max", rect_max, torch.int32, (n, 2)),
                                  ("tiles_touched", tiles_touched, torch.int32, (n,)),
                                  ("depths", depths, torch.float32, (n,))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {list(shape)}, got {t.dtype} "
                             f"{list(t.shape)}")
        if t.device != rect_min.device:
            raise ValueError(f"{name} is on {t.device}, rect_min on {rect_min.device}")
    if rect_min.device.type != "cuda":
        raise ValueError(f"binning runs on cuda tensors, not {rect_min.device}")


def tile_bits(num_tiles: int) -> int:
    """Key bits of the tile sort: enough for the sentinel tile ``num_tiles``."""
    return max(int(num_tiles).bit_length(), 1)


@functools.lru_cache(maxsize=32)
def _scratch_bytes(device_index: int, n: int, k: int, bits: int):
    """(bin_count's, bin_sort's) CUB scratch bytes."""
    from ._build import load_library
    count, sort = ctypes.c_longlong(), ctypes.c_longlong()
    with torch.cuda.device(device_index):
        err = load_library("binning").binning_scratch_bytes(n, k, bits, ctypes.byref(count),
                                                            ctypes.byref(sort))
    if err != 0:
        raise RuntimeError(f"binning scratch query failed: CUDA error {err}")
    return count.value, sort.value


def _workspace(device, sizes):
    """One uint8 buffer holding consecutive parts of ``sizes`` bytes, each
    on ``_ALIGN`` bytes: (the buffer, each part's address)."""
    starts, total = [], 0
    for size in sizes:
        starts.append(total)
        total += -(-size // _ALIGN) * _ALIGN
    ws = torch.empty(max(total, _ALIGN), dtype=torch.uint8, device=device)
    base = ws.data_ptr()
    return ws, [base + s for s in starts]


class Counts(NamedTuple):
    """``bin_count``'s result: the inputs as launched, ``offsets`` [n + 1]
    int64 (``offsets[n]`` the total) and the work buffer ``bin_sort`` goes
    on with (its parts' addresses in ``parts``: counts, keys, ids, keys_alt,
    ids_alt, kept, ends)."""
    rect_min: torch.Tensor
    rect_max: torch.Tensor
    offsets: torch.Tensor
    work: torch.Tensor
    parts: list


@counted
def bin_count(rect_min, rect_max, tiles_touched, depths, tiles_y: int,
              tile_row_offset: int = 0) -> Counts:
    """Step 1: each Gaussian's entries in the ``tiles_y`` tile rows from
    ``tile_row_offset``, their scan in Gaussian order and the depth sort's
    input. CUDA tensors only; adds one to ``bin_count.launches``."""
    _check(rect_min, rect_max, tiles_touched, depths)
    device = rect_min.device
    n = rect_min.shape[0]
    rect_min, rect_max, tiles_touched = (t.contiguous() for t in (rect_min, rect_max,
                                                                  tiles_touched))
    depth_bits = depths.detach().contiguous()
    count_bytes, _ = _scratch_bytes(device.index, n, 0, 1)
    offsets = torch.empty(n + 1, dtype=torch.int64, device=device)
    work, parts = _workspace(device, [8 * n] + [4 * n] * 6 + [count_bytes])
    counts, keys, ids, scratch = parts[0], parts[1], parts[2], parts[7]
    launch(bin_count, "binning_count", device, n, rect_min, rect_max, tiles_touched, depth_bits,
           tiles_y, tile_row_offset, counts, offsets, keys, ids, scratch, count_bytes)
    return Counts(rect_min, rect_max, offsets, work, parts[:7])


@counted
def bin_sort(counted_: Counts, K: int, tiles_x: int, tiles_y: int, tile_row_offset: int = 0,
             static: bool = False) -> dict:
    """Steps 2-5 after ``bin_count``: the K sorted entries and the tile
    ranges, as ``tiled.bin_and_sort`` returns them but for
    ``num_rendered``. With ``static`` K is a static buffer's size (the
    ``valid`` flags, ``overflow`` and the tail); else it must be the total.
    Adds one to ``bin_sort.launches``."""
    if not 0 <= K < 2 ** 31:
        raise ValueError(f"the key buffer takes 0 to 2**31 - 1 entries, not {K}")
    rect_min, rect_max, offsets = counted_.rect_min, counted_.rect_max, counted_.offsets
    device = rect_min.device
    n = rect_min.shape[0]
    num_tiles = tiles_x * tiles_y
    bits = tile_bits(num_tiles)
    _, sort_bytes = _scratch_bytes(device.index, n, K, bits)
    work, (tiles_a, tiles_b, gid_a, gid_b, scratch) = _workspace(
        device, [4 * K] * 4 + [sort_bytes])
    s_tile = torch.empty(K, dtype=torch.int64, device=device)
    s_gidx = torch.empty(K, dtype=torch.int64, device=device)
    range_start = torch.empty(num_tiles, dtype=torch.int32, device=device)
    range_end = torch.empty(num_tiles, dtype=torch.int32, device=device)
    valid = torch.empty(K, dtype=torch.bool, device=device) if static else None
    overflow = torch.empty((), dtype=torch.bool, device=device) if static else None
    counts, keys, ids, keys_alt, ids_alt, kept, ends = counted_.parts
    launch(bin_sort, "binning_sort", device, n, K, num_tiles, tiles_x, tiles_y, tile_row_offset,
           bits, TAIL_SCRATCH, rect_min, rect_max, counts, offsets, keys, keys_alt, ids,
           ids_alt, kept, ends, tiles_a, tiles_b, gid_a, gid_b, scratch, sort_bytes, s_tile,
           s_gidx, valid, overflow, range_start, range_end)
    out = dict(s_tile=s_tile, s_gidx=s_gidx, range_start=range_start, range_end=range_end)
    if static:
        out.update(valid=valid, overflow=overflow)
    return out


def bin_and_sort(rect_min, rect_max, tiles_touched, depths, tiles_x: int, tiles_y: int,
                 tile_row_offset: int = 0, key_buffer_size: Optional[int] = None) -> dict:
    """``tiled.bin_and_sort`` on the card (see the module docstring)."""
    c = bin_count(rect_min, rect_max, tiles_touched, depths, tiles_y, tile_row_offset)
    n = rect_min.shape[0]
    if key_buffer_size is None:
        with profiling.sync("entry_count"):
            total = int(c.offsets[n])                # the one host sync
        out = bin_sort(c, total, tiles_x, tiles_y, tile_row_offset)
    else:
        total = c.offsets[n]
        out = bin_sort(c, int(key_buffer_size), tiles_x, tiles_y, tile_row_offset,
                       static=True)
    out["num_rendered"] = total
    return out
