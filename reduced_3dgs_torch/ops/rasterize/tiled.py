"""Tiled renderer: binning, one sort, per-tile compositing (counterpart of
reduced_3dgs_tpu/ops/rasterize/tiled.py:138-159, 174-370, 441-495 and
582-618).

The pipeline is the CUDA rasterizer's:

  1. ``preprocess`` gives each Gaussian a tile rectangle;
  2. ``bin_and_sort`` reads the total entry count with one host sync, emits
     one entry per (Gaussian, tile) pair in Gaussian order, and sorts them
     once by the int64 key (tile << 32 | depth bits), stably;
  3. ``CompositeSorted`` gathers the entries' fields and composites each
     tile front to back (the CUDA kernel ``composite_fwd`` on the card); its
     backward replays each tile back to front (``composite_bwd``). A render
     with statistics gathers the fields and runs ``composite_fwd_stats``
     instead, without autograd;
  4. ``_assemble_outputs`` stitches the tiles into the image.

The JAX package instead sizes a static key buffer and regrows it on
overflow; the port needs neither.
"""
from __future__ import annotations

import contextlib

import torch

from ... import config
from . import common
from .common import RenderSettings
from .composite import CompositeSorted, composite_fwd_stats, pack_fields


def bin_and_sort(rect_min: torch.Tensor, rect_max: torch.Tensor,
                 tiles_touched: torch.Tensor, depths: torch.Tensor,
                 tiles_x: int, tiles_y: int) -> dict:
    """Emit and sort the (tile, Gaussian) entries.

    Returns a dict with ``s_gidx`` [K] int64 Gaussian index and ``s_tile``
    [K] int64 tile id of each sorted entry, ``range_start``/``range_end``
    [T] int32 bounds of each tile's run in the sorted order, and
    ``num_rendered`` (= K, a Python int).

    Entries are ordered by tile, then view depth. Depth > 0.2 for every
    emitted entry (near cull), so its float32 bit pattern is a monotone
    non-negative int32 and fits the key's low 32 bits. Ties break by
    emission order: Gaussian index, then the entry's tile ordinal."""
    device = rect_min.device
    num_tiles = tiles_x * tiles_y
    rect_w = (rect_max[:, 0] - rect_min[:, 0]).to(torch.int64)
    band_h = torch.clamp(rect_max[:, 1] - rect_min[:, 1], min=0).to(torch.int64)
    counts = torch.where(tiles_touched > 0, rect_w * band_h, torch.zeros_like(rect_w))
    total = int(counts.sum())                        # the one host sync
    gidx = torch.repeat_interleave(torch.arange(counts.numel(), device=device),
                                   counts, output_size=total)
    offsets = torch.cumsum(counts, 0) - counts
    ordinal = torch.arange(total, device=device) - offsets[gidx]
    w_e = rect_w[gidx]
    tx = rect_min[gidx, 0].to(torch.int64) + ordinal % w_e
    ty = rect_min[gidx, 1].to(torch.int64) + ordinal // w_e
    tile = ty * tiles_x + tx
    depth_bits = depths.detach().contiguous().view(torch.int32)[gidx].to(torch.int64)
    s_key, perm = torch.sort((tile << 32) | depth_bits, stable=True)
    s_tile = s_key >> 32
    # Tile ranges by binary search in the sorted tile ids. (bincount would
    # synchronise with the host on CUDA to size its output.)
    tiles = torch.arange(num_tiles, device=device)
    return dict(
        s_gidx=gidx[perm],
        s_tile=s_tile,
        range_start=torch.searchsorted(s_tile, tiles).to(torch.int32),
        range_end=torch.searchsorted(s_tile, tiles, right=True).to(torch.int32),
        num_rendered=total,
    )


def render_tiled(means3d, opacities_raw, scales, rotations, shs,
                 settings: RenderSettings, mean2d_offset_ndc=None,
                 with_stats: bool = False, colors_precomp=None) -> dict:
    """Render an image through the tiled pipeline; differentiable in every
    float input unless ``with_stats``. ``mean2d_offset_ndc`` and
    ``colors_precomp`` (the colours to use in place of ``shs``'s, which may
    then be None) go to ``preprocess``.

    Returns {"render" [3,H,W], "radii" [N] int32, "final_T" [H,W],
    "depth" [H,W], "num_rendered" int}. With ``with_stats`` the render runs
    without autograd (the JAX package's stop_gradient) through the
    statistics compositor, whose per-entry sums are summed per Gaussian with
    one ``index_add_``, and the dict also holds, per Gaussian [N]:
    "gaussians_count" and "touched_pixels" (int32, the pixels it contributes
    to), "opacity_important_score" (count x opacity),
    "T_alpha_important_score" (sum of alpha T) and "transmittance_sum"
    (sum of the incoming T)."""
    H, W = settings.image_height, settings.image_width
    tiles_x, tiles_y = common.tile_grid(settings)
    with torch.no_grad() if with_stats else contextlib.nullcontext():
        pre = common.preprocess(means3d, opacities_raw, scales, rotations, shs, settings,
                                mean2d_offset_ndc=mean2d_offset_ndc,
                                colors_precomp=colors_precomp)
        ent = bin_and_sort(pre.rect_min, pre.rect_max, pre.tiles_touched, pre.depths,
                           tiles_x, tiles_y)
        if not with_stats:
            color4, final_t = CompositeSorted.apply(
                pack_fields(pre), ent["s_gidx"], ent["range_start"], ent["range_end"], tiles_x)
            return _assemble_outputs(color4, final_t, pre, settings, tiles_x, tiles_y,
                                     H, W, ent["num_rendered"])
        e = pack_fields(pre).index_select(1, ent["s_gidx"]).contiguous()
        color4, final_t, _, stats = composite_fwd_stats(e, ent["range_start"],
                                                        ent["range_end"], tiles_x)
        per_gaussian = torch.zeros((stats.shape[0], means3d.shape[0]), dtype=stats.dtype,
                                   device=stats.device).index_add_(1, ent["s_gidx"], stats)
        out = _assemble_outputs(color4, final_t, pre, settings, tiles_x, tiles_y, H, W,
                                ent["num_rendered"])
        count = per_gaussian[0].to(torch.int32)
        out.update(gaussians_count=count, touched_pixels=count,
                   opacity_important_score=per_gaussian[1],
                   T_alpha_important_score=per_gaussian[2],
                   transmittance_sum=per_gaussian[3])
        return out


def _assemble_outputs(color4, final_t, pre, settings, tiles_x, tiles_y, H, W,
                      num_rendered) -> dict:
    """Stitch [T,256,*] tile outputs into [H,W] images; add the background."""
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
    return {
        "render": image.permute(2, 0, 1),
        "radii": pre.radii,
        "final_T": T_full,
        "depth": depth_full,
        "num_rendered": num_rendered,
    }
