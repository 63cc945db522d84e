"""2DGS (surfel) tiled renderer (counterpart of
reduced_3dgs_tpu/ops/rasterize/twodgs.py:56-368).

Each splat is a flat ellipse: centre p and tangent axes t_u, t_v, the first
two columns of its rotation scaled by (s_u, s_v); the third scale is unused.
A splat-local point s = (u, v, 1) maps to the homogeneous pixel M @ s, and
the ray through pixel (px, py) meets the splat's plane at

    k = px m_w - m_px,  l = py m_w - m_py,  s_h = k x l,
    (u, v) = (s_h.x / s_h.z, s_h.y / s_h.z),

with the weight G = exp(-(u^2 + v^2) / 2). A screen-space low-pass
G_2d = exp(-|pixel - centre|^2 / (2 * 0.5)) bounds the footprint from below:
alpha uses max(G, G_2d), and the depth is the intersection's view depth
where G wins and the centre's where G_2d does. Compositing follows the 3DGS
compositor: front to back, alpha clamped at 0.99, skipped below 1/255 and
at the near plane, the first entry with T (1 - alpha) < 1e-4 latching the
pixel. Besides colour, final T and depth, the render gives the
camera-space normal map and the depth distortion sum_i 2 w_i (z_i A_i -
D_i), A and D the in-front sums of w and w z.

There is no Pallas kernel behind the JAX function: it is a pixel-chunked
segmented scan in plain XLA under ``jax.checkpoint``. Its counterpart here
is plain PyTorch, run on the device of its inputs (the card for CUDA
tensors), with each chunk of pixels under
``torch.utils.checkpoint.checkpoint``. Entries come from the 3DGS
renderer's ``bin_and_sort``. The running sums over the entry buffer (log
transmittance, A and D) run in float64 and are rebased at each tile's first
entry: a float32 sum over the whole buffer would lose the tile-local values
at full-image entry counts. The band viewport (``tile_row_offset``,
``tile_rows``) is the 3DGS renderer's (``tiled.viewport``): the multi-device
trainer renders one band of tile rows per rank. The JAX function's ``alive``
mask is not ported: every row is alive.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ... import config
from .. import projection as proj
from .. import sh as sh_ops
from . import common
from .common import RenderSettings
from .tiled import bin_and_sort, viewport

# Screen-space low-pass variance in px^2 (the 2DGS paper's 0.5-px filter).
FILTER_VAR_2D = 0.5
# Splat-local cutoff of the radii and of the outer binning rectangle.
CUTOFF = 3.0
# Pixels of a tile per chunk, as in the JAX function: the chunk's [64, K]
# temporaries are what one checkpointed body holds.
PIXEL_CHUNK = 64


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _tile_bounds(lo: torch.Tensor, hi: torch.Tensor, grid: torch.Tensor):
    """[lo / 16] truncated and floor(hi / 16) + 1, clipped to the grid in
    float before the integer conversion (the JAX function converts, then
    clips; the two agree for every finite input)."""
    rmin = torch.trunc(lo / config.BLOCK_X)
    rmax = torch.floor(hi / config.BLOCK_X) + 1
    return (torch.minimum(torch.clamp(rmin, min=0), grid).to(torch.int32),
            torch.minimum(torch.clamp(rmax, min=0), grid).to(torch.int32))


def preprocess_2dgs(means3d, opacities_raw, scales, rotations, shs,
                    settings: RenderSettings,
                    mean2d_offset_ndc: Optional[torch.Tensor] = None) -> dict:
    """Per-splat transforms and binning rectangles.

    Returns a dict of per-Gaussian tensors: "M" [N,3,3] rows (m_px, m_py,
    m_w) mapping (u, v, 1) to the homogeneous pixel, "md" [N,3] the view-depth
    row, "center2d" [N,2], "normal_view" [N,3] (flipped toward the camera),
    "depths" [N], "opacity" [N] (sigmoid), "rgb" [N,3], "radii" [N] int32,
    "rect_min"/"rect_max" [N,2] int32 and "tiles_touched" [N] int32.
    ``mean2d_offset_ndc`` [N,2] shifts the splat in NDC (m_x += o_x m_w,
    m_y += o_y m_w); its gradient is the screen-space densification signal,
    as in the 3DGS ``preprocess``."""
    H, W = settings.image_height, settings.image_width
    tiles_x, tiles_y = common.tile_grid(settings)
    n = means3d.shape[0]

    R = proj.quat_to_rotmat(rotations)                       # [N,3,3]
    su = scales[:, 0] * settings.scale_modifier
    sv = scales[:, 1] * settings.scale_modifier
    tu = R[..., :, 0] * su[:, None]                          # [N,3]
    tv = R[..., :, 1] * sv[:, None]

    # B [N,4,3]: the world homogeneous point of s = (u, v, 1) is B @ s;
    # columns (t_u, t_v, p), and the last row (0, 0, 1) gives the 1.
    B = torch.cat([torch.stack([tu, tv, means3d], dim=-1),
                   torch.tensor([[0.0, 0.0, 1.0]], dtype=means3d.dtype,
                                device=means3d.device).expand(n, 1, 3)], dim=-2)
    P = settings.projmatrix                                  # [4,4] row-vector
    M4 = 0
    for r in range(4):
        M4 = M4 + P[r][None, :, None] * B[:, r][:, None, :]  # [N,4,3] rows x, y, z, w
    m_x, m_y, m_w = M4[:, 0], M4[:, 1], M4[:, 3]
    if mean2d_offset_ndc is not None:
        m_x = m_x + mean2d_offset_ndc[:, 0:1] * m_w
        m_y = m_y + mean2d_offset_ndc[:, 1:2] * m_w
    # pixel = ((ndc + 1) * size - 1) / 2  (proj.ndc2pix)
    m_px = 0.5 * (W * m_x + (W - 1) * m_w)
    m_py = 0.5 * (H * m_y + (H - 1) * m_w)
    M = torch.stack([m_px, m_py, m_w], dim=1)                # [N,3,3]

    V = settings.viewmatrix
    md = 0
    for r in range(4):
        md = md + B[:, r] * V[r, 2]                          # [N,3]

    depths = proj.world_to_view(means3d, V)[:, 2]
    visible = depths > config.NEAR_CULL_Z

    cw = m_w[:, 2]
    safe_cw = torch.where(torch.abs(cw) < 1e-6, torch.full_like(cw, 1e-6), cw)
    center2d = torch.stack([m_px[:, 2], m_py[:, 2]], dim=-1) / safe_cw[:, None]

    opacity = torch.sigmoid(opacities_raw.reshape(-1))

    def corner_aabb(cut):
        """Pixel box of the corners p +- cut (t_u | t_v), padded by the
        low-pass radius at the same cutoff."""
        c = cut[:, None, None]
        corners = means3d[:, None, :] + c * torch.stack([tu + tv, tu - tv, -tu + tv, -tu - tv], 1)
        ch = proj.transform_points(corners, P)               # [N,4,4]
        cw4 = torch.clamp(ch[..., 3], min=1e-4)
        cx = proj.ndc2pix(ch[..., 0] / cw4, W)
        cy = proj.ndc2pix(ch[..., 1] / cw4, H)
        lp_rad = torch.ceil(cut * FILTER_VAR_2D ** 0.5)
        lo_x = torch.minimum(torch.amin(cx, 1), center2d[:, 0] - lp_rad)
        hi_x = torch.maximum(torch.amax(cx, 1), center2d[:, 0] + lp_rad)
        lo_y = torch.minimum(torch.amin(cy, 1), center2d[:, 1] - lp_rad)
        hi_y = torch.maximum(torch.amax(cy, 1), center2d[:, 1] + lp_rad)
        return lo_x, hi_x, lo_y, hi_y

    grid = torch.tensor([tiles_x, tiles_y], dtype=means3d.dtype, device=means3d.device)
    # Radii and visibility keep the fixed 3-unit cutoff (the densifier and
    # the screen-size prune read them); binning uses the alpha-cutoff extent
    # sqrt(2 ln(255 op)), outside which the compositor's gate drops every
    # blend.
    full = torch.full_like(opacity, CUTOFF)
    lo_x, hi_x, lo_y, hi_y = corner_aabb(full)
    radius = torch.ceil(0.5 * torch.maximum(hi_x - lo_x, hi_y - lo_y))
    rmin3, rmax3 = _tile_bounds(torch.stack([lo_x, lo_y], -1), torch.stack([hi_x, hi_y], -1),
                                grid)
    rect3_wh = torch.clamp(rmax3 - rmin3, min=0)
    visible = visible & ((rect3_wh[..., 0] * rect3_wh[..., 1]) > 0)

    t2 = 2.0 * torch.log(255.0 * torch.clamp(opacity, min=1e-6))
    cut_a = torch.minimum(full, torch.sqrt(torch.clamp(t2, min=0.0)))
    lo_x, hi_x, lo_y, hi_y = corner_aabb(cut_a)
    rmin, rmax = _tile_bounds(torch.stack([lo_x, lo_y], -1), torch.stack([hi_x, hi_y], -1), grid)
    rect_wh = torch.clamp(rmax - rmin, min=0)
    tiles = (rect_wh[..., 0] * rect_wh[..., 1]).to(torch.int32)

    dirs = sh_ops.normalize_dirs(means3d - settings.campos)
    rgb = sh_ops.eval_sh(shs, dirs, settings.sh_degree, clamp=True)

    # Camera-space normal, flipped toward the camera as in the paper.
    nw = _cross(R[..., :, 0], R[..., :, 1])
    n_view = nw[:, 0:1] * V[0, :3] + nw[:, 1:2] * V[1, :3] + nw[:, 2:3] * V[2, :3]
    n_view = n_view * torch.where(n_view[:, 2:3] > 0, -1.0, 1.0)

    return dict(
        M=M, md=md, center2d=center2d, normal_view=n_view,
        depths=depths, opacity=opacity, rgb=rgb,
        radii=torch.where(visible, radius, torch.zeros_like(radius)).to(torch.int32),
        rect_min=rmin, rect_max=rmax,
        tiles_touched=torch.where(visible, tiles, torch.zeros_like(tiles)),
    )


def _pixel_chunk(p0: int, pixel_chunk: int, fields: torch.Tensor, tile_x: torch.Tensor,
                 tile_y: torch.Tensor, seg: torch.Tensor, seg_start: torch.Tensor,
                 num_tiles: int, with_stats: bool):
    """Composite pixels [p0, p0 + pixel_chunk) of every tile.

    Entries lie on the last axis ([P, K] temporaries; the tile rebases are
    ``index_select``s, whose backward is one ``index_add_``). Returns per
    (pixel, tile) sums [9, P, T] of w (r, g, b), w z, w (normal), the
    distortion term and log T over the contributing entries, and, with
    ``with_stats``, per entry over these pixels [4, K]: the contributing
    count, count x opacity, the sum of w and the sum of the incoming T."""
    device = fields.device
    p = torch.arange(p0, p0 + pixel_chunk, device=device)[:, None]           # [P,1]
    px = tile_x + (p % config.BLOCK_X).to(fields.dtype)                       # [P,K]
    py = tile_y + (p // config.BLOCK_X).to(fields.dtype)
    (m00, m01, m02, m10, m11, m12, m20, m21, m22, md0, md1, md2, cx, cy, op,
     r, g, b, n0, n1, n2) = fields

    # Ray-splat intersection: s_h = cross(px m_w - m_px, py m_w - m_py).
    kx = px * m20 - m00
    ky = px * m21 - m01
    kz = px * m22 - m02
    lx = py * m20 - m10
    ly = py * m21 - m11
    lz = py * m22 - m12
    sx = ky * lz - kz * ly
    sy = kz * lx - kx * lz
    sz = kx * ly - ky * lx
    sz_safe = torch.where(torch.abs(sz) < 1e-9, torch.full_like(sz, 1e-9), sz)
    u = sx / sz_safe
    v = sy / sz_safe
    rho3d = u * u + v * v

    ddx = px - cx
    ddy = py - cy
    rho2d = (ddx * ddx + ddy * ddy) / FILTER_VAR_2D
    # The low-pass: whichever Gaussian is larger. torch.minimum passes half
    # the gradient to each side of a tie, as jnp.minimum does.
    use3d = rho3d <= rho2d
    rho = torch.minimum(rho3d, rho2d)
    G = torch.exp(-0.5 * rho)

    zhit = md0 * u + md1 * v + md2
    depth_px = torch.where(use3d, zhit, md2.expand_as(zhit))

    alpha = torch.minimum(torch.tensor(config.ALPHA_MAX, dtype=fields.dtype, device=device),
                          op * G)
    gate = (alpha >= config.ALPHA_EPS) & (depth_px > config.NEAR_CULL_Z)
    abar = torch.where(gate, alpha, torch.zeros_like(alpha))

    log1ma = torch.log1p(-abar)
    # Exclusive running sums, float64, rebased at each tile's first entry.
    l64 = log1ma.double()
    lex = torch.cumsum(l64, dim=1) - l64
    T_in = torch.exp((lex - lex.index_select(1, seg_start)).to(fields.dtype))

    trigger = gate & (T_in * (1.0 - abar) < config.T_EPS)
    t_int = trigger.to(torch.int32)
    tcum_ex = torch.cumsum(t_int, dim=1) - t_int
    dead = (tcum_ex - tcum_ex.index_select(1, seg_start)) > 0
    contrib = gate & ~trigger & ~dead

    w = torch.where(contrib, abar * T_in, torch.zeros_like(abar))
    wz = w * depth_px
    w64, wz64 = w.double(), wz.double()
    A_in = torch.cumsum(w64, dim=1) - w64
    D_in = torch.cumsum(wz64, dim=1) - wz64
    A_in = (A_in - A_in.index_select(1, seg_start)).to(fields.dtype)
    D_in = (D_in - D_in.index_select(1, seg_start)).to(fields.dtype)
    dist_term = 2.0 * w * (depth_px * A_in - D_in)

    vals = torch.stack([w * r, w * g, w * b, wz, w * n0, w * n1, w * n2, dist_term,
                        torch.where(contrib, log1ma, torch.zeros_like(log1ma))])   # [9,P,K]
    sums = torch.zeros((vals.shape[0], pixel_chunk, num_tiles), dtype=vals.dtype,
                       device=device).index_add(2, seg, vals)
    if not with_stats:
        return sums, None
    cnt = contrib.sum(dim=0).to(fields.dtype)
    stats = torch.stack([cnt, cnt * op, w.sum(dim=0),
                         torch.where(contrib, T_in, torch.zeros_like(T_in)).sum(dim=0)])
    return sums, stats


def render_tiled_2dgs(means3d, opacities_raw, scales, rotations, shs,
                      settings: RenderSettings,
                      mean2d_offset_ndc: Optional[torch.Tensor] = None,
                      with_stats: bool = False, tile_row_offset: int = 0,
                      tile_rows: Optional[int] = None) -> dict:
    """Render N surfels through the tiled pipeline; differentiable in every
    float input unless ``with_stats``.

    Returns {"render" [3,H,W], "radii" [N] int32, "final_T" [H,W], "depth"
    [H,W] (sum of w z), "normal" [3,H,W] (sum of w n), "distortion" [H,W],
    "num_rendered" int}. With ``with_stats`` the render runs without
    autograd (the JAX package's stop_gradient), and the dict also holds the
    3DGS renderer's five per-Gaussian statistics over the pixels each
    Gaussian contributes to (out-of-image pixels of ragged tiles included):
    "gaussians_count", "touched_pixels" (int32), "opacity_important_score",
    "T_alpha_important_score" (sum of w) and "transmittance_sum". Each
    chunk of PIXEL_CHUNK pixels runs under activation checkpointing when
    autograd records it, so the backward holds one chunk's [PIXEL_CHUNK, K]
    temporaries at a time. With ``tile_rows``, only that band of tile rows
    from ``tile_row_offset`` is rendered, as by ``render_tiled``: the images
    are the band's ``tile_rows * 16`` rows."""
    tiles_x, tiles_y, H, W = viewport(settings, tile_row_offset, tile_rows)
    num_tiles = tiles_x * tiles_y
    with torch.no_grad() if with_stats else contextlib.nullcontext():
        pre = preprocess_2dgs(means3d, opacities_raw, scales, rotations, shs, settings,
                              mean2d_offset_ndc=mean2d_offset_ndc)
        ent = bin_and_sort(pre["rect_min"], pre["rect_max"], pre["tiles_touched"],
                           pre["depths"], tiles_x, tiles_y, tile_row_offset)
        s_gidx, s_tile = ent["s_gidx"], ent["s_tile"]
        # One [21, N] -> [21, K] gather of every per-entry field.
        fields = torch.cat([pre["M"].reshape(-1, 9).T, pre["md"].T, pre["center2d"].T,
                            pre["opacity"][None, :], pre["rgb"].T, pre["normal_view"].T],
                           dim=0).index_select(1, s_gidx)
        tile_x = ((s_tile % tiles_x) * config.BLOCK_X).to(fields.dtype)
        tile_y = ((s_tile // tiles_x + tile_row_offset) * config.BLOCK_Y).to(fields.dtype)
        seg_start = ent["range_start"].to(torch.int64)[s_tile]

        chunks, stats = [], None
        for p0 in range(0, config.BLOCK_SIZE, PIXEL_CHUNK):
            args = (p0, PIXEL_CHUNK, fields, tile_x, tile_y, s_tile, seg_start, num_tiles,
                    with_stats)
            if torch.is_grad_enabled() and fields.requires_grad:
                sums, st = checkpoint(_pixel_chunk, *args, use_reentrant=False)
            else:
                sums, st = _pixel_chunk(*args)
            chunks.append(sums)
            if with_stats:
                stats = st if stats is None else stats + st
        tile_vals = torch.cat(chunks, dim=1).permute(2, 1, 0)              # [T,256,9]

        padded_h, padded_w = tiles_y * config.BLOCK_Y, tiles_x * config.BLOCK_X

        def stitch(x):
            extra = x.shape[2:]
            x = x.reshape(tiles_y, tiles_x, config.BLOCK_Y, config.BLOCK_X, *extra)
            return torch.movedim(x, 2, 1).reshape(padded_h, padded_w, *extra)[:H, :W]

        img = stitch(tile_vals)                                             # [H,W,9]
        T_full = torch.exp(img[..., 8])
        image = img[..., 0:3] + T_full[..., None] * settings.bg[None, None, :]
        out = {
            "render": image.permute(2, 0, 1),
            "radii": pre["radii"],
            "final_T": T_full,
            "depth": img[..., 3],
            "normal": img[..., 4:7].permute(2, 0, 1),
            "distortion": img[..., 7],
            "num_rendered": ent["num_rendered"],
        }
        if with_stats:
            per_gaussian = torch.zeros((stats.shape[0], means3d.shape[0]), dtype=stats.dtype,
                                       device=stats.device).index_add_(1, s_gidx, stats)
            count = per_gaussian[0].to(torch.int32)
            out.update(gaussians_count=count, touched_pixels=count,
                       opacity_important_score=per_gaussian[1],
                       T_alpha_important_score=per_gaussian[2],
                       transmittance_sum=per_gaussian[3])
        return out
