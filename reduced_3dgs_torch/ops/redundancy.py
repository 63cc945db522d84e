"""Redundancy-metric ops for resolution-aware pruning (counterpart of
reduced_3dgs_tpu/ops/redundancy.py:23-144).

  * ``find_minimum_projected_pixel_size``: per point, the smallest world
    size of one pixel over the cameras that see it;
  * ``sphere_ellipsoid_intersection``: per point, which of its neighbours'
    ellipsoids, grown by the point's sphere radius, contain it;
  * ``allocate_minimum_redundancy_value``: per point, the smallest
    redundancy count among the points that list it as an intersecting
    neighbour.

Plain torch ops on the points' device; the per-point work is chunked by
rows under a byte budget. A neighbour id below 0 (an empty slot of
``ops.knn.knn``) never intersects and is never a segment of the minimum.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import projection as proj

# Bytes the per-row gathers of one chunk may take.
_BUDGET_BYTES = 256 * 1024 ** 2
# The pixel size of a point no camera sees (the reference's initial value).
_UNSEEN_SIZE = 10000.0


def find_minimum_projected_pixel_size(
        full_proj: torch.Tensor,       # [K,4,4] row-vector world -> clip
        inv_full_proj: torch.Tensor,   # [K,4,4]
        xyz: torch.Tensor,             # [N,3]
        image_heights, image_widths    # K ints each
        ) -> torch.Tensor:
    """[N] minimum over the cameras of the world-space size of one pixel.

    For each camera whose NDC box ([-1,1]^2 x [0,1]) holds the point: the
    world distance between the unprojections of (0, 0, z) and of one pixel
    step along the image's longer side, (2/W, 0, z) or (0, 2/H, z), at the
    point's NDC depth z. Points no camera sees keep 10000."""
    sizes = torch.full((xyz.shape[0],), _UNSEEN_SIZE, dtype=xyz.dtype, device=xyz.device)
    lower = torch.tensor([-1.0, -1.0, 0.0], dtype=xyz.dtype, device=xyz.device)
    for projm, inv_projm, h, w in zip(full_proj, inv_full_proj, image_heights, image_widths):
        p_proj = proj.project_points(xyz, projm)
        inside = torch.all(p_proj <= 1.0, dim=-1) & torch.all(p_proj >= lower, dim=-1)
        depth = p_proj[:, 2]
        # float32 as the JAX package divides: 2 / float32(side).
        h, w = np.float32(h), np.float32(w)
        dx, dy = (np.float32(2.0) / w, 0.0) if w > h else (0.0, np.float32(2.0) / h)

        def unproject(x, y):
            p = torch.stack([torch.full_like(depth, float(x)), torch.full_like(depth, float(y)),
                             depth], dim=-1)
            hom = proj.transform_points(p, inv_projm)
            return hom[:, :3] / (hom[:, 3:4] + 1e-7)

        d = unproject(dx, dy) - unproject(0.0, 0.0)
        size = torch.sqrt(torch.sum(d * d, dim=-1))
        sizes = torch.where(inside, torch.minimum(sizes, size), sizes)
    return sizes


def sphere_ellipsoid_intersection(
        xyz: torch.Tensor,                 # [N,3]
        scales: torch.Tensor,              # [N,3] activated
        rotations: torch.Tensor,           # [N,4] normalised quaternions
        neighbour_indices: torch.Tensor,   # [N,K] ids, -1 for an empty slot
        sphere_radius: torch.Tensor,       # [N]
        use_neighbour_rotation: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counts [N] int32, mask [N,K] bool): neighbour j of point i
    intersects when the offset from j to i, in the rotation frame R, lies
    inside j's ellipsoid grown by i's radius:
    sum_a (offset R)_a^2 / (scale_j,a + r_i)^2 < 1.

    R is the QUERY point's rotation, as in the reference's
    ``sphereEllipsoidIntersection`` and the JAX package;
    ``use_neighbour_rotation`` takes the neighbour's instead."""
    n, k = neighbour_indices.shape
    per_row = k * 4 * (3 * 6 + (9 if use_neighbour_rotation else 0))
    rows = max(1, _BUDGET_BYTES // per_row)
    masks = []
    for r0 in range(0, n, rows):
        nbr = neighbour_indices[r0:r0 + rows]
        safe = nbr.clamp(min=0)
        diff = xyz[r0:r0 + rows, None, :] - xyz[safe]                         # [r,K,3]
        aug = scales[safe] + sphere_radius[r0:r0 + rows, None, None]          # [r,K,3]
        if use_neighbour_rotation:
            local = torch.einsum("nki,nkij->nkj", diff, proj.quat_to_rotmat(rotations[safe]))
        else:
            local = torch.einsum("nki,nij->nkj", diff,
                                 proj.quat_to_rotmat(rotations[r0:r0 + rows]))
        val = torch.sum((local * local) / (aug * aug), dim=-1)                # [r,K]
        masks.append((val < 1.0) & (nbr >= 0))
    mask = torch.cat(masks, dim=0) if masks else torch.zeros((0, k), dtype=torch.bool,
                                                             device=xyz.device)
    return torch.sum(mask, dim=1, dtype=torch.int32), mask


def allocate_minimum_redundancy_value(
        redundancy_values: torch.Tensor,   # [N] int
        neighbour_indices: torch.Tensor,   # [N,K] ids, -1 for an empty slot
        intersection_mask: torch.Tensor    # [N,K] bool
        ) -> torch.Tensor:
    """[N] int32: for each point, the smallest ``redundancy_values[i]`` over
    the rows i that list it with the mask set; every result starts at N and
    a listing with the mask clear offers N (the reference's
    ``findMinimumRedundancyValue`` initialised to P, and the JAX package's
    segment minimum)."""
    n = redundancy_values.shape[0]
    flat_idx = neighbour_indices.reshape(-1)
    flat_val = redundancy_values.to(torch.int32)[:, None].expand(
        neighbour_indices.shape).reshape(-1)
    flat_val = torch.where(intersection_mask.reshape(-1) & (flat_idx >= 0), flat_val,
                           torch.full_like(flat_val, n))
    out = torch.full((n,), n, dtype=torch.int32, device=redundancy_values.device)
    return out.scatter_reduce_(0, flat_idx.clamp(min=0), flat_val, reduce="amin")
