"""Dense renderer, the oracle of the tests (counterpart of
reduced_3dgs_tpu/ops/rasterize/reference.py:27-128 and common.py:197-300).

Every visible Gaussian is composited against every pixel of its tile
rectangle in global depth order (ties by Gaussian index), with no binning
and no sort of entries. It checks the tiled path independently of the
sort. O(N * H * W): for small scenes only.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ... import config
from . import common
from .common import RenderSettings

# Gaussians composited per step: bounds the [H*W, chunk] temporaries.
_CHUNK = 32


class CompositeCarry(NamedTuple):
    """Per-pixel compositing state carried across chunks."""
    T: torch.Tensor          # [P] transmittance
    done: torch.Tensor       # [P] bool, early-termination latch
    color: torch.Tensor      # [P,3]
    depth: torch.Tensor      # [P]


def _exclusive_cumprod(x: torch.Tensor, dim: int) -> torch.Tensor:
    p = torch.cumprod(x, dim=dim)
    return torch.cat([torch.ones_like(p.narrow(dim, 0, 1)),
                      p.narrow(dim, 0, x.shape[dim] - 1)], dim=dim)


def composite_chunk(carry: CompositeCarry, pix_xy, means2d, conic, opacity,
                    rgb, depths, pixel_valid) -> CompositeCarry:
    """Composite one depth-ordered chunk of C Gaussians over P pixels.

    Order-parallel form of the sequential loop: the incoming transmittance
    is an exclusive cumulative product, and since it never increases, the
    first entry with T_in (1 - alpha) < 1e-4 is the same as in the loop;
    it and everything after it are dropped."""
    d = means2d[None, :, :] - pix_xy[:, None, :]                  # [P,C,2]
    dx, dy = d[..., 0], d[..., 1]
    A, B, Cc = conic[..., 0], conic[..., 1], conic[..., 2]
    power = -0.5 * (A[None] * dx * dx + Cc[None] * dy * dy) - B[None] * dx * dy
    alpha = torch.clamp(opacity[None, :] * torch.exp(power), max=config.ALPHA_MAX)
    gate = (power <= 0.0) & (alpha >= config.ALPHA_EPS) & pixel_valid
    abar = torch.where(gate, alpha, torch.zeros_like(alpha))

    T_in = carry.T[:, None] * _exclusive_cumprod(1.0 - abar, dim=1)
    trigger = gate & (T_in * (1.0 - abar) < config.T_EPS)
    dead = carry.done[:, None] | (torch.cumsum(trigger.to(torch.int32), dim=1) > 0)
    contrib = gate & ~dead

    w = torch.where(contrib, abar * T_in, torch.zeros_like(abar))
    color = carry.color + w @ rgb
    depth = carry.depth + w @ depths
    T_new = carry.T * torch.prod(torch.where(contrib, 1.0 - abar, torch.ones_like(abar)), dim=1)
    done_new = carry.done | torch.any(trigger, dim=1)
    return CompositeCarry(T=T_new, done=done_new, color=color, depth=depth)


def render_reference(means3d, opacities_raw, scales, rotations, shs,
                     settings: RenderSettings):
    """Render an image; returns {"render" [3,H,W], "radii" [N],
    "final_T" [H,W], "depth" [H,W]} like the tiled renderer."""
    H, W = settings.image_height, settings.image_width
    device = means3d.device
    pre = common.preprocess(means3d, opacities_raw, scales, rotations, shs, settings)

    visible = pre.tiles_touched > 0
    sort_depth = torch.where(visible, pre.depths, torch.full_like(pre.depths, float("inf")))
    _, order = torch.sort(sort_depth, stable=True)
    order = order[visible[order]]

    pix = common.pixel_centers(H, W, device=device)
    block = torch.tensor([config.BLOCK_X, config.BLOCK_Y], dtype=pix.dtype, device=device)
    pix_tile = torch.div(pix, block, rounding_mode="floor").to(torch.int32)

    P = H * W
    carry = CompositeCarry(
        T=torch.ones(P, device=device), done=torch.zeros(P, dtype=torch.bool, device=device),
        color=torch.zeros(P, 3, device=device), depth=torch.zeros(P, device=device))
    for c0 in range(0, order.numel(), _CHUNK):
        g = order[c0:c0 + _CHUNK]
        inside = torch.all((pix_tile[:, None, :] >= pre.rect_min[g][None])
                           & (pix_tile[:, None, :] < pre.rect_max[g][None]), dim=-1)
        carry = composite_chunk(carry, pix, pre.means2d[g], pre.conic[g],
                                pre.opacity[g], pre.rgb[g], pre.depths[g], inside)

    image = carry.color + carry.T[:, None] * settings.bg[None, :]
    return {
        "render": image.T.reshape(3, H, W),
        "radii": pre.radii,
        "final_T": carry.T.reshape(H, W),
        "depth": carry.depth.reshape(H, W),
    }
