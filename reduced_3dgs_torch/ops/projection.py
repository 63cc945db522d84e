"""Camera and Gaussian projection math (counterpart of
reduced_3dgs_tpu/ops/projection.py).

Matrices keep the row-vector storage of the JAX package and of 3DGS:
points transform as ``p' = [p, 1] @ M``, and ``full_proj = world_view @
proj``. A column-vector habit here would flip every camera.
"""
from __future__ import annotations

import math

import torch

from ..config import BLOCK_X, BLOCK_Y, COV2D_LOWPASS

assert BLOCK_X == BLOCK_Y
BLOCK = BLOCK_X


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Normalised quaternions (r, x, y, z) [..., 4] -> rotations [..., 3, 3]
    acting on column vectors."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def build_cov3d(scales: torch.Tensor, scale_modifier, rotations: torch.Tensor) -> torch.Tensor:
    """World covariance R diag(s)^2 R^T, s = scale_modifier * scales [..., 3]."""
    R = quat_to_rotmat(rotations)
    RS = R * (scales * scale_modifier)[..., None, :]
    return (RS[..., :, None, 0] * RS[..., None, :, 0]
            + RS[..., :, None, 1] * RS[..., None, :, 1]
            + RS[..., :, None, 2] * RS[..., None, :, 2])


def transform_points(points: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """Homogeneous row-vector transform [p, 1] @ M -> [..., 4]."""
    return (points[..., 0:1] * matrix[0, :] + points[..., 1:2] * matrix[1, :]
            + points[..., 2:3] * matrix[2, :] + matrix[3, :])


def world_to_view(points: torch.Tensor, viewmatrix: torch.Tensor) -> torch.Tensor:
    return transform_points(points, viewmatrix)[..., :3]


def project_points(points: torch.Tensor, projmatrix: torch.Tensor, eps: float = 1e-7):
    """World -> NDC through the full projection matrix, [..., 3]."""
    p_hom = transform_points(points, projmatrix)
    p_w = 1.0 / (p_hom[..., 3:4] + eps)
    return p_hom[..., :3] * p_w


def ndc2pix(v: torch.Tensor, size) -> torch.Tensor:
    """NDC [-1, 1] -> continuous pixel coordinate."""
    return ((v + 1.0) * size - 1.0) * 0.5


def build_cov2d(means3d, cov3d, viewmatrix, focal_x, focal_y, tan_fovx, tan_fovy,
                valid=None) -> torch.Tensor:
    """EWA screen-space covariance, packed (cov_xx, cov_xy, cov_yy) [..., 3].

    The view-space point is clamped to 1.3 * tan_fov before the Jacobian,
    and 0.3 px is added to the diagonal. Rows with ``valid`` False get view
    z = 1, so a culled point on the camera plane does not divide by zero."""
    t = world_to_view(means3d, viewmatrix)
    tz = t[..., 2]
    if valid is not None:
        tz = torch.where(valid, tz, torch.ones_like(tz))
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    tx = torch.clamp(t[..., 0] / tz, -limx, limx) * tz
    ty = torch.clamp(t[..., 1] / tz, -limy, limy) * tz

    inv_tz = 1.0 / tz
    j00 = focal_x * inv_tz
    j02 = -focal_x * tx * inv_tz * inv_tz
    j11 = focal_y * inv_tz
    j12 = -focal_y * ty * inv_tz * inv_tz
    # Row-vector storage: the world->view rotation acting on column vectors
    # is viewmatrix[:3, :3]^T, so its rows are the columns of W below.
    W = viewmatrix[:3, :3]
    T0 = j00[..., None] * W[:, 0] + j02[..., None] * W[:, 2]
    T1 = j11[..., None] * W[:, 1] + j12[..., None] * W[:, 2]
    S_T0 = (cov3d[..., :, 0] * T0[..., None, 0]
            + cov3d[..., :, 1] * T0[..., None, 1]
            + cov3d[..., :, 2] * T0[..., None, 2])
    S_T1 = (cov3d[..., :, 0] * T1[..., None, 0]
            + cov3d[..., :, 1] * T1[..., None, 1]
            + cov3d[..., :, 2] * T1[..., None, 2])
    cov_xx = torch.sum(T0 * S_T0, dim=-1) + COV2D_LOWPASS
    cov_xy = torch.sum(T0 * S_T1, dim=-1)
    cov_yy = torch.sum(T1 * S_T1, dim=-1) + COV2D_LOWPASS
    return torch.stack([cov_xx, cov_xy, cov_yy], dim=-1)


def invert_cov2d(cov2d: torch.Tensor):
    """Packed 2D covariance -> (conic (A, B, C), det); the exponent is
    -0.5 (A dx^2 + C dy^2) - B dx dy."""
    a, b, c = cov2d[..., 0], cov2d[..., 1], cov2d[..., 2]
    det = a * c - b * b
    # Double where: 1/det at det == 0 would give an infinite derivative that
    # turns the masked branch's zero cotangent into NaN.
    nonzero = det != 0.0
    det_safe = torch.where(nonzero, det, torch.ones_like(det))
    det_inv = torch.where(nonzero, 1.0 / det_safe, torch.zeros_like(det))
    conic = torch.stack([c * det_inv, -b * det_inv, a * det_inv], dim=-1)
    return conic, det


def cov2d_lambda_max(cov2d: torch.Tensor, det: torch.Tensor) -> torch.Tensor:
    """Largest eigenvalue of the 2x2 screen covariance."""
    mid = 0.5 * (cov2d[..., 0] + cov2d[..., 2])
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    return mid + disc


def tile_rect(point_image: torch.Tensor, radius: torch.Tensor, tiles_x: int, tiles_y: int):
    """Tile rectangle [rect_min, rect_max) of int32 tile coordinates [..., 2].

    ``radius`` is [...] (one radius) or [..., 2] (per-axis half-widths). The
    minimum truncates toward zero; the maximum is floor(hi / 16) + 1, which
    covers float centres exactly. Both are clipped to the grid in float
    before the integer conversion, which gives the JAX package's result for
    every finite input."""
    if radius.dim() < point_image.dim():
        radius = radius[..., None]
    rmin = torch.trunc((point_image - radius) / BLOCK)
    rmax = torch.floor((point_image + radius) / BLOCK) + 1

    def clip_to_grid(v):
        return torch.stack([torch.clamp(v[..., 0], 0, tiles_x),
                            torch.clamp(v[..., 1], 0, tiles_y)], dim=-1).to(torch.int32)

    return clip_to_grid(rmin), clip_to_grid(rmax)


def build_projection_matrix(znear: float, zfar: float, fovx: float, fovy: float,
                            device=None) -> torch.Tensor:
    """Perspective projection in row-vector storage (NDC x, y in [-1, 1],
    z in [0, 1])."""
    tan_half_fovx = math.tan(fovx * 0.5)
    tan_half_fovy = math.tan(fovy * 0.5)
    top = tan_half_fovy * znear
    bottom = -top
    right = tan_half_fovx * znear
    left = -right
    P = torch.zeros((4, 4), dtype=torch.float32, device=device)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    # Built as a column-vector matrix; transpose into row-vector storage.
    return P.T.contiguous()


def world_view_transform_from_rt(R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Stored (R, T) -> row-vector world_view_transform M, p_view = [p, 1] @ M."""
    M = torch.zeros((4, 4), dtype=torch.float32, device=R.device)
    M[:3, :3] = R
    M[3, :3] = T
    M[3, 3] = 1.0
    return M


def camera_center_from_world_view(world_view: torch.Tensor) -> torch.Tensor:
    """Camera position in world space from the row-vector W2V matrix."""
    return torch.linalg.inv(world_view)[3, :3]


def focals_from_fov(width: int, height: int, tan_fovx, tan_fovy):
    return width / (2.0 * tan_fovx), height / (2.0 * tan_fovy)
