"""Spherical-harmonics evaluation up to degree 3 (counterpart of
reduced_3dgs_tpu/ops/sh.py).

Per-Gaussian degrees are applied by masking coefficient rows to zero
(``degree_coeff_mask``), as in the JAX package.
"""
from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)

MAX_SH_DEGREE = 3


def num_sh_coeffs(degree: int) -> int:
    """Number of SH coefficients of a degree, DC included."""
    return (degree + 1) ** 2


def sh_basis(dirs: torch.Tensor, degree: int = MAX_SH_DEGREE) -> torch.Tensor:
    """Real SH basis [..., (degree+1)**2] along unit directions [..., 3]."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    cols = [torch.full_like(x, SH_C0)]
    if degree > 0:
        cols += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        cols += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree > 2:
        cols += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(cols, dim=-1)


def eval_sh(shs: torch.Tensor, dirs: torch.Tensor, degree: int = MAX_SH_DEGREE,
            clamp: bool = True) -> torch.Tensor:
    """SH coefficients [..., K, 3] -> RGB [..., 3], with the +0.5 offset and,
    when ``clamp``, the positive clamp (zero gradient where clamped). The
    clamp is ``torch.maximum``, whose gradient at a colour of exactly 0 is
    1/2, as ``jnp.maximum``'s (``torch.clamp`` passes all of it); the SH
    cull bakes a colour that was clamped in every view to exactly that."""
    basis = sh_basis(dirs, degree)
    k = basis.shape[-1]
    rgb = torch.sum(basis[..., :, None] * shs[..., :k, :], dim=-2) + 0.5
    if clamp:
        rgb = torch.maximum(rgb, torch.zeros_like(rgb))
    return rgb


def normalize_dirs(vecs: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """v * rsqrt(|v|^2 + eps^2): finite value and gradient at v = 0."""
    sq = torch.sum(vecs * vecs, dim=-1, keepdim=True)
    if eps:
        sq = sq + eps * eps
    return vecs * torch.rsqrt(sq)


def degree_coeff_mask(degrees: torch.Tensor, max_degree: int = MAX_SH_DEGREE) -> torch.Tensor:
    """Bool mask [..., (max_degree+1)**2 - 1] of the rest coefficients each
    Gaussian uses: row j is on iff j < (deg + 1)**2 - 1."""
    n_rest = num_sh_coeffs(max_degree) - 1
    n_enabled = (degrees + 1) ** 2 - 1
    idx = torch.arange(n_rest, device=degrees.device)
    return idx < n_enabled[..., None]
