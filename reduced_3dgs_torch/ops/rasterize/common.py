"""Per-Gaussian preprocessing shared by the renderers (counterpart of
reduced_3dgs_tpu/ops/rasterize/common.py:49-183).

``preprocess`` culls, projects, builds the conic and colour of every
Gaussian and bins it to tiles. The semantics are the CUDA rasterizer's:
near cull at view z 0.2, the opacity sigmoid applied here, radii by the
3-sigma rule, and SH colour with the +0.5 offset and positive clamp. Tiles
are binned with the alpha-contour box, which is never wider than the
3-sigma rectangle. ``colors_precomp`` replaces the SH colour with given
colours, used as they are (no offset, no clamp), as the packed-SH render
does. ``mark_visible`` is the rasterizer's frustum test, which reduces to
the near cull.

On CUDA tensors ``preprocess`` runs the two hand-written kernels of
``csrc/preprocess.cu`` through ``preprocess_kernel.Preprocess``; on CPU
tensors it runs ``preprocess_plain``, the same function in plain PyTorch
(the version the tests hold to the JAX package). There is no fallback from
one to the other. Either way the float fields are the rows of one [10, N]
matrix, ``fields``, in the compositor's row order.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ... import config
from .. import projection as proj
from .. import sh as sh_ops


class RenderSettings(NamedTuple):
    """Rasterization settings; tensors lie on the render device."""
    image_height: int
    image_width: int
    tanfovx: float
    tanfovy: float
    bg: torch.Tensor                 # [3]
    scale_modifier: float
    viewmatrix: torch.Tensor         # [4,4] row-vector storage
    projmatrix: torch.Tensor         # [4,4] row-vector storage (full proj)
    campos: torch.Tensor             # [3]
    sh_degree: int = 3


class PreprocessedGaussians(NamedTuple):
    """Per-Gaussian screen-space quantities."""
    depths: torch.Tensor          # [N] view-space z
    means2d: torch.Tensor         # [N,2] pixel coordinates
    conic: torch.Tensor           # [N,3] inverse 2D covariance (A,B,C)
    opacity: torch.Tensor         # [N] activated opacity
    rgb: torch.Tensor             # [N,3] view-dependent colour
    radii: torch.Tensor           # [N] int32 screen radius (0 = culled)
    rect_min: torch.Tensor        # [N,2] int32 tile rect (x,y)
    rect_max: torch.Tensor        # [N,2] int32 tile rect, exclusive
    tiles_touched: torch.Tensor   # [N] int32
    # [10,N] the compositor's field matrix (``composite.pack_fields``' row
    # order); the float fields above are views of its rows.
    fields: torch.Tensor


def tile_grid(settings: RenderSettings):
    tiles_x = (settings.image_width + config.BLOCK_X - 1) // config.BLOCK_X
    tiles_y = (settings.image_height + config.BLOCK_Y - 1) // config.BLOCK_Y
    return tiles_x, tiles_y


def preprocess(means3d: torch.Tensor, opacities_raw: torch.Tensor,
               scales: torch.Tensor, rotations: torch.Tensor,
               shs: torch.Tensor, settings: RenderSettings,
               mean2d_offset_ndc: Optional[torch.Tensor] = None,
               colors_precomp: Optional[torch.Tensor] = None) -> PreprocessedGaussians:
    """Screen-space quantities of N Gaussians; the arguments are
    ``preprocess_plain``'s.

    CPU tensors go to ``preprocess_plain``. CUDA tensors go through the
    kernels (``preprocess_kernel.Preprocess``, which checks them and raises
    on any other device), and ``fields`` is the matrix they wrote."""
    if means3d.device.type == "cpu":
        return preprocess_plain(means3d, opacities_raw, scales, rotations, shs, settings,
                                mean2d_offset_ndc, colors_precomp)
    from .preprocess_kernel import Preprocess
    fields, radii, rect_min, rect_max, tiles_touched = Preprocess.apply(
        means3d, opacities_raw, scales, rotations, shs, mean2d_offset_ndc, colors_precomp,
        settings.viewmatrix, settings.projmatrix, settings.campos, settings)
    return _with_fields(fields, radii, rect_min, rect_max, tiles_touched)


def _with_fields(fields, radii, rect_min, rect_max, tiles_touched) -> PreprocessedGaussians:
    """The result whose float fields are the rows of ``fields`` [10,N]."""
    return PreprocessedGaussians(
        depths=fields[9], means2d=fields[0:2].T, conic=fields[2:5].T, opacity=fields[5],
        rgb=fields[6:9].T, radii=radii, rect_min=rect_min, rect_max=rect_max,
        tiles_touched=tiles_touched, fields=fields)


def preprocess_plain(means3d: torch.Tensor, opacities_raw: torch.Tensor,
                     scales: torch.Tensor, rotations: torch.Tensor,
                     shs: torch.Tensor, settings: RenderSettings,
                     mean2d_offset_ndc: Optional[torch.Tensor] = None,
                     colors_precomp: Optional[torch.Tensor] = None) -> PreprocessedGaussians:
    """Screen-space quantities of N Gaussians, in plain PyTorch.

    Args: means3d [N,3]; opacities_raw [N] or [N,1] opacity logits; scales
    [N,3] activated; rotations [N,4] normalised; shs [N,K,3] degree-masked
    SH coefficients; mean2d_offset_ndc [N,2] (zeros), added to the
    projected NDC xy before ``ndc2pix``, so its gradient is the screen-space
    gradient in the reference's (0.5 W, 0.5 H) scaling, which the densifier
    accumulates. ``colors_precomp`` [N,3], when given, is the colour and
    ``shs`` is not read. Every row is alive: the port keeps no capacity padding, so
    the JAX function's ``alive`` mask is not ported."""
    H, W = settings.image_height, settings.image_width
    tiles_x, tiles_y = tile_grid(settings)
    focal_x, focal_y = proj.focals_from_fov(W, H, settings.tanfovx, settings.tanfovy)

    opac = opacities_raw.reshape(-1)
    depths = proj.world_to_view(means3d, settings.viewmatrix)[..., 2]
    visible = depths > config.NEAR_CULL_Z

    p_proj_xy = proj.project_points(means3d, settings.projmatrix)[..., :2]
    if mean2d_offset_ndc is not None:
        p_proj_xy = p_proj_xy + mean2d_offset_ndc
    cov3d = proj.build_cov3d(scales, settings.scale_modifier, rotations)
    cov2d = proj.build_cov2d(means3d, cov3d, settings.viewmatrix,
                             focal_x, focal_y, settings.tanfovx, settings.tanfovy,
                             valid=visible)
    conic, det = proj.invert_cov2d(cov2d)
    visible = visible & (det != 0.0)

    radius = torch.ceil(3.0 * torch.sqrt(proj.cov2d_lambda_max(cov2d, det)))
    point_image = torch.stack(
        [proj.ndc2pix(p_proj_xy[..., 0], W), proj.ndc2pix(p_proj_xy[..., 1], H)], dim=-1)

    opacity = torch.sigmoid(opac)

    # Visibility and radii follow the 3-sigma rule (densification and
    # screen-size pruning read them). Binning uses the axis-aligned box of
    # the contour op * G = 1/255, outside which the compositor's alpha gate
    # drops every blend: |dx| <= sqrt(t2 Sigma_xx), |dy| <= sqrt(t2 Sigma_yy)
    # with t2 = 2 ln(255 op), clamped by the 3-sigma radius.
    rect3_min, rect3_max = proj.tile_rect(point_image, radius, tiles_x, tiles_y)
    rect3_wh = torch.clamp(rect3_max - rect3_min, min=0)
    visible = visible & ((rect3_wh[..., 0] * rect3_wh[..., 1]) > 0)

    t2 = torch.clamp(2.0 * torch.log(255.0 * torch.clamp(opacity, min=1e-6)), min=0.0)
    bin_wx = torch.minimum(radius, torch.sqrt(t2 * torch.clamp(cov2d[..., 0], min=0.0)))
    bin_wy = torch.minimum(radius, torch.sqrt(t2 * torch.clamp(cov2d[..., 2], min=0.0)))
    rect_min, rect_max = proj.tile_rect(point_image, torch.stack([bin_wx, bin_wy], dim=-1),
                                        tiles_x, tiles_y)
    rect_wh = torch.clamp(rect_max - rect_min, min=0)
    tiles = (rect_wh[..., 0] * rect_wh[..., 1]).to(torch.int32)

    if colors_precomp is None:
        dirs = sh_ops.normalize_dirs(means3d - settings.campos)
        rgb = sh_ops.eval_sh(shs, dirs, settings.sh_degree, clamp=True)
    else:
        rgb = colors_precomp

    radii = torch.where(visible, radius, torch.zeros_like(radius)).to(torch.int32)
    tiles_touched = torch.where(visible, tiles, torch.zeros_like(tiles))
    fields = torch.stack([point_image[:, 0], point_image[:, 1], conic[:, 0], conic[:, 1],
                          conic[:, 2], opacity, rgb[:, 0], rgb[:, 1], rgb[:, 2], depths])
    return _with_fields(fields, radii, rect_min, rect_max, tiles_touched)


def mark_visible(means3d: torch.Tensor, viewmatrix: torch.Tensor) -> torch.Tensor:
    """[N] bool: view-space z > NEAR_CULL_Z. The CUDA rasterizer's
    ``in_frustum`` also computes NDC coordinates but decides on this test
    alone."""
    return proj.world_to_view(means3d, viewmatrix)[..., 2] > config.NEAR_CULL_Z


def pixel_centers(height: int, width: int, device=None) -> torch.Tensor:
    """[H*W, 2] pixel-centre coordinates (x, y), row-major."""
    ys = torch.arange(height, dtype=torch.float32, device=device)
    xs = torch.arange(width, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
