"""Tiled renderer: binning, one sort, per-tile compositing (counterpart of
reduced_3dgs_tpu/ops/rasterize/tiled.py:29-96, 138-159, 174-370, 441-495
and 582-618).

The pipeline is the CUDA rasterizer's:

  1. ``preprocess`` gives each Gaussian a tile rectangle;
  2. ``bin_and_sort`` emits one entry per (Gaussian, tile) pair in Gaussian
     order and sorts them once by the int64 key (tile << 32 | depth bits),
     stably;
  3. ``CompositeSorted`` gathers the entries' fields and composites each
     tile front to back (the CUDA kernel ``composite_fwd`` on the card); its
     backward replays each tile back to front (``composite_bwd``). A render
     with statistics gathers the fields and runs ``composite_fwd_stats``
     instead, without autograd;
  4. ``_assemble_outputs`` stitches the tiles into the image.

Two binnings. Without a key buffer, ``bin_and_sort`` reads the total entry
count with one host sync and emits exactly that many entries (the render
CLI, the viewer and the sweeps over views of mixed sizes render so). With
``key_buffer_size`` K it
emits into a [K] buffer without any host sync, as the JAX package does:
entries past the total take the sentinel tile ``num_tiles`` (they sort to
the tail and lie in no tile's range) and scratch Gaussian ids from N
(``composite.TAIL_SCRATCH``); when
the total exceeds K, the entries past K in emission order are dropped, and
``overflow`` says so. The training step and the event sweeps render so,
which lets them be captured as CUDA graphs (``trainer/step_graph.py``); the
trainer sizes K with ``default_key_buffer_size`` and regrows or shrinks it
from the overflow flags and entry counts it reads every 64 steps, and a
sweep doubles it after a pass that overflowed.

The viewport (the multi-device trainer's pixel band, JAX tiled.py:387-414):
with ``tile_rows`` given, only the band of ``tile_rows`` tile rows from the
image's tile row ``tile_row_offset`` is rendered. The projection is the
full image's; each rect's rows are clipped to the band, and tile ids are
local to it. A tile's entries, and their order, are the same as in the full
render, and the compositors place each pixel where the full render does, so
a band is its crop of the full image. The band's images are its
``tile_rows * 16`` rows, cropped at the right edge only (the last band may
reach below the image).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ... import config
from ...utils import profiling
from . import common
from .common import RenderSettings
from .composite import (TAIL_SCRATCH, CompositeSorted, composite_fwd_stats,
                        gather_entries, pack_fields, sum_per_gaussian)


def max_key_buffer(n: int, tiles_x: int, tiles_y: int) -> int:
    """The most entries n Gaussians can emit: each in every tile (JAX
    tiled.py:39-55 without its segment-alignment padding)."""
    return max(n, 1) * tiles_x * tiles_y


def default_key_buffer_size(n: int, tiles_x: int, tiles_y: int) -> int:
    """The starting key buffer for n Gaussians: 6 n, at least 2048 and at
    most ``max_key_buffer`` (JAX tiled.py:58-68 without its alignment
    term)."""
    return int(min(max(6 * n, 2048), max(n, 1) * tiles_x * tiles_y))


def bucket_capacity(n: int, granularity: int = 256, headroom: float = 1.3) -> int:
    """The JAX engine's capacity for n Gaussians (JAX functional.py:23-33):
    1.3 n rounded up to the next sqrt(2)-spaced tier of multiples of 256."""
    target = max(int(n * headroom), granularity)
    cap = granularity
    while cap < target:
        cap = -(-int(cap * 1.4142135) // granularity) * granularity
    return cap


def fill_ids_from_offsets(offsets: torch.Tensor, counts: torch.Tensor, K: int) -> torch.Tensor:
    """ids[pos] = i for pos in [offsets[i], offsets[i] + counts[i]), [K]
    int64 (JAX tiled.py:71-84): each Gaussian with entries marks its first
    entry's position, and every position carries the id of the last mark at
    or before it. Positions at or past the total carry the last such id (0
    when there is none); runs that start at or past K are dropped.

    JAX scatters the ids and takes a running maximum; here the running
    count of the marks indexes the table of the marked Gaussians' ids, the
    same result from scans that are fast on the card (``torch.cummax`` is a
    slow generic scan there; PERF.md §6)."""
    n = offsets.shape[0]
    has = counts > 0
    ids = torch.arange(n, device=offsets.device)
    run = torch.cumsum(has.to(torch.int64), 0) - 1          # ordinal among the marks
    table = torch.zeros(n + 1, dtype=torch.int64, device=offsets.device)
    table.scatter_(0, torch.where(has, run, n), ids)
    marks = torch.zeros(K + 1, dtype=torch.int64, device=offsets.device)
    marks.scatter_(0, torch.where(has & (offsets < K), offsets, K), 1)
    return table[torch.clamp(torch.cumsum(marks[:K], 0) - 1, min=0)]


def bin_and_sort(rect_min: torch.Tensor, rect_max: torch.Tensor,
                 tiles_touched: torch.Tensor, depths: torch.Tensor,
                 tiles_x: int, tiles_y: int, tile_row_offset: int = 0,
                 key_buffer_size: Optional[int] = None) -> dict:
    """Emit and sort the (tile, Gaussian) entries of the ``tiles_y`` tile
    rows from the image's tile row ``tile_row_offset`` (the whole image by
    default): each rect's rows are clipped to the band (JAX tiled.py:198-212)
    and tile ids count from the band's first row.

    Returns a dict with ``s_gidx`` [K] int64 Gaussian index and ``s_tile``
    [K] int64 tile id of each sorted entry, ``range_start``/``range_end``
    [T] int32 bounds of each tile's run in the sorted order, and
    ``num_rendered``, the number of entries the rects ask for.

    Without ``key_buffer_size`` K is that number, read with one host sync,
    ``num_rendered`` is a Python int, and the ranges partition [0, K). With
    it (the static buffer of the module docstring), K is ``key_buffer_size``
    and nothing syncs: ``num_rendered`` is a 0-d int64 tensor, ``overflow``
    a 0-d bool tensor (num_rendered > K), and ``valid`` [K] bool marks the
    sorted entries that lie in a tile; the others form the tail, with
    ``s_tile`` = T and scratch Gaussian ids ``s_gidx`` = N + (position mod
    ``TAIL_SCRATCH``), which ``gather_entries`` and ``sum_per_gaussian``
    read as zeros and drop.

    Entries are ordered by tile, then view depth. Depth > 0.2 for every
    emitted entry (near cull), so its float32 bit pattern is a monotone
    non-negative int32 and fits the key's low 32 bits. Ties break by
    emission order: Gaussian index, then the entry's tile ordinal."""
    device = rect_min.device
    n = rect_min.shape[0]
    num_tiles = tiles_x * tiles_y
    rect_w = (rect_max[:, 0] - rect_min[:, 0]).to(torch.int64)
    band_min_y = torch.clamp(rect_min[:, 1] - tile_row_offset, 0, tiles_y).to(torch.int64)
    band_max_y = torch.clamp(rect_max[:, 1] - tile_row_offset, 0, tiles_y).to(torch.int64)
    band_h = torch.clamp(band_max_y - band_min_y, min=0)
    counts = torch.where(tiles_touched > 0, rect_w * band_h, torch.zeros_like(rect_w))
    offsets = torch.cumsum(counts, 0) - counts
    if key_buffer_size is None:
        with profiling.sync("entry_count"):
            total = int(counts.sum())                # the one host sync
        K = total
        gidx = torch.repeat_interleave(torch.arange(n, device=device), counts,
                                       output_size=total)
        valid = None
    else:
        K = int(key_buffer_size)
        total = counts.sum()
        gidx = fill_ids_from_offsets(offsets, counts, K)
        valid = torch.arange(K, device=device) < total
    ordinal = torch.arange(K, device=device) - offsets[gidx]
    w_e = torch.clamp(rect_w, min=1)[gidx]
    tx = rect_min[gidx, 0].to(torch.int64) + ordinal % w_e
    ty = band_min_y[gidx] + ordinal // w_e
    tile = ty * tiles_x + tx
    depth_bits = depths.detach().contiguous().view(torch.int32)[gidx].to(torch.int64)
    if valid is not None:
        tile = torch.where(valid, tile, num_tiles)
        depth_bits = torch.where(valid, depth_bits, 0)
    s_key, perm = torch.sort((tile << 32) | depth_bits, stable=True)
    s_tile = s_key >> 32
    s_gidx = gidx[perm]
    # Tile ranges by binary search in the sorted tile ids. (bincount would
    # synchronise with the host on CUDA to size its output.)
    tiles = torch.arange(num_tiles, device=device)
    out = dict(
        s_tile=s_tile,
        range_start=torch.searchsorted(s_tile, tiles).to(torch.int32),
        range_end=torch.searchsorted(s_tile, tiles, right=True).to(torch.int32),
        num_rendered=total,
    )
    if valid is None:
        out["s_gidx"] = s_gidx
    else:
        s_valid = s_tile < num_tiles
        scratch = n + torch.arange(K, device=device) % TAIL_SCRATCH
        out.update(s_gidx=torch.where(s_valid, s_gidx, scratch), valid=s_valid,
                   overflow=total > K)
    return out


def render_tiled(means3d, opacities_raw, scales, rotations, shs,
                 settings: RenderSettings, mean2d_offset_ndc=None,
                 with_stats: bool = False, colors_precomp=None,
                 tile_row_offset: int = 0, tile_rows=None,
                 key_buffer_size: Optional[int] = None) -> dict:
    """Render an image through the tiled pipeline; differentiable in every
    float input unless ``with_stats``. ``mean2d_offset_ndc`` and
    ``colors_precomp`` (the colours to use in place of ``shs``'s, which may
    then be None) go to ``preprocess``. With ``tile_rows``, only that band of
    tile rows from ``tile_row_offset`` is rendered (the viewport above):
    the images are then [tile_rows * 16, W], the statistics cover the
    band's pixels, and "radii" is the full image's. ``key_buffer_size``
    bins into the static buffer of ``bin_and_sort``.

    Returns {"render" [3,H,W], "radii" [N] int32, "final_T" [H,W],
    "depth" [H,W], "num_rendered"}: an int, or with ``key_buffer_size`` a
    0-d tensor, and then also "overflow" (a 0-d bool tensor, as JAX's
    ``render_tiled`` returns it). With ``with_stats`` the render runs
    without autograd (the JAX package's stop_gradient) through the
    statistics compositor, whose per-entry sums are summed per Gaussian with
    one ``index_add_``, and the dict also holds, per Gaussian [N]:
    "gaussians_count" and "touched_pixels" (int32, the pixels it contributes
    to), "opacity_important_score" (count x opacity),
    "T_alpha_important_score" (sum of alpha T) and "transmittance_sum"
    (sum of the incoming T)."""
    tiles_x, tiles_y, H, W = viewport(settings, tile_row_offset, tile_rows)
    with (torch.no_grad() if with_stats else contextlib.nullcontext()), \
            profiling.span("render"):
        with profiling.span("preprocess"):
            pre = common.preprocess(means3d, opacities_raw, scales, rotations, shs, settings,
                                    mean2d_offset_ndc=mean2d_offset_ndc,
                                    colors_precomp=colors_precomp)
        with profiling.span("bin_and_sort"):
            ent = bin_and_sort(pre.rect_min, pre.rect_max, pre.tiles_touched, pre.depths,
                               tiles_x, tiles_y, tile_row_offset, key_buffer_size)
        with profiling.span("composite"):
            if not with_stats:
                color4, final_t = CompositeSorted.apply(
                    pack_fields(pre), ent["s_gidx"], ent["range_start"], ent["range_end"],
                    tiles_x, tile_row_offset)
                return _assemble_outputs(color4, final_t, pre, settings, tiles_x, tiles_y,
                                         H, W, ent["num_rendered"], ent.get("overflow"))
            e = gather_entries(pack_fields(pre), ent["s_gidx"])
            color4, final_t, _, stats = composite_fwd_stats(e, ent["range_start"],
                                                            ent["range_end"], tiles_x,
                                                            tile_row_offset)
            per_gaussian = sum_per_gaussian(stats, ent["s_gidx"], means3d.shape[0])
            out = _assemble_outputs(color4, final_t, pre, settings, tiles_x, tiles_y, H, W,
                                    ent["num_rendered"], ent.get("overflow"))
        count = per_gaussian[0].to(torch.int32)
        out.update(gaussians_count=count, touched_pixels=count,
                   opacity_important_score=per_gaussian[1],
                   T_alpha_important_score=per_gaussian[2],
                   transmittance_sum=per_gaussian[3])
        return out


def viewport(settings: RenderSettings, tile_row_offset: int = 0, tile_rows=None):
    """(tiles_x, tiles_y, H, W) of the rendered area: the whole image when
    ``tile_rows`` is None, else the band of ``tile_rows`` tile rows from
    ``tile_row_offset``, ``tile_rows * 16`` rows high."""
    tiles_x, full_tiles_y = common.tile_grid(settings)
    if tile_rows is None:
        if tile_row_offset != 0:
            raise ValueError("tile_row_offset needs tile_rows")
        return tiles_x, full_tiles_y, settings.image_height, settings.image_width
    if tile_rows < 1 or tile_row_offset < 0:
        raise ValueError(f"a band of {tile_rows} tile rows from row {tile_row_offset}")
    return tiles_x, int(tile_rows), int(tile_rows) * config.BLOCK_Y, settings.image_width


def _assemble_outputs(color4, final_t, pre, settings, tiles_x, tiles_y, H, W,
                      num_rendered, overflow=None) -> dict:
    """Stitch [T,256,*] tile outputs into [H,W] images (H may be the
    padded height of a band); add the background. The output carries
    ``num_rendered``, and ``overflow`` when given (a static buffer's)."""
    padded_h = tiles_y * config.BLOCK_Y
    padded_w = tiles_x * config.BLOCK_X

    def stitch(tile_vals):
        extra = tile_vals.shape[2:]
        x = tile_vals.reshape(tiles_y, tiles_x, config.BLOCK_Y, config.BLOCK_X, *extra)
        x = torch.movedim(x, 2, 1).reshape(padded_h, padded_w, *extra)
        return x[:H, :W]

    T_full = stitch(final_t[:, :, 0])
    color_full = stitch(color4[:, :, :3])
    depth_full = stitch(color4[:, :, 3])
    image = color_full + T_full[..., None] * settings.bg[None, None, :]
    out = {
        "render": image.permute(2, 0, 1),
        "radii": pre.radii,
        "final_T": T_full,
        "depth": depth_full,
        "num_rendered": num_rendered,
    }
    if overflow is not None:
        out["overflow"] = overflow
    return out
