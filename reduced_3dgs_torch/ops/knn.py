"""Spatial K-nearest neighbours (counterpart of reduced_3dgs_tpu/ops/knn.py).

The same algorithm as the JAX package, so that both compute the same
neighbours:

  1. Per ordering, sort the cloud along a 30-bit Morton curve of a rotated
     copy of it (stable sort), cut the sorted cloud into blocks of
     ``window`` points, and score each block against itself and its
     ``neighbors`` adjacent blocks on each side with exact squared
     distances (sums of squared differences: the |a|^2 + |b|^2 - 2ab
     expansion misorders near-ties) and a top-k.
  2. Merge the per-ordering k-lists of each row: an id that occurs in
     several lists keeps its first copy, the later ones get an infinite
     distance, then one top-k.
  3. ``refine_rounds`` NN-descent rounds: the candidates of a row are its
     incumbents and the k-lists of its first ``refine_sample`` incumbents,
     merged the same way.

Defaults are the JAX package's: ``window`` 512, ``n_orders`` 2,
``refine_rounds`` 2, ``neighbors`` 1, ``refine_sample`` 4 for ``knn``, and
``window`` 64 without refinement for ``mean_knn_dist_sq``.

Differences from the JAX package, none of which changes a neighbour set
where both find k real neighbours:

  * Every top-k is exact (``torch.topk``); the JAX package uses
    ``lax.approx_max_k``, which is exact on the CPU.
  * The distance tensors are processed in chunks of blocks or rows sized by
    a byte budget (``_BUDGET_BYTES``). The TPU-only parts are gone: the
    bucket-selection top-k, the ``R3DGS_KNN_TOPK`` knob and its unaggregated
    path, the tagged float bit-cast that carries ids through one gather,
    and the row chunking sized for TPU lane padding.
  * A row with fewer than k valid candidates (N <= k, or a masked cloud)
    gets infinite distances and id -1 in its empty slots. The JAX package's
    empty slots carry infinite distances too, but their id is -1 with bit 30
    cleared (-1073741825), a side effect of that bit-cast.

Ids are int64 (torch's index type); the JAX package returns int32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# Bytes that one chunk's distance tensor and its top-k intermediates may
# take on the device.
_BUDGET_BYTES = 512 * 1024 ** 2
_MASK32 = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits over 30 (Morton interleave): the JAX package's uint32
    arithmetic with wraparound, in int64 masked to 32 bits."""
    v = ((v * 0x00010001) & _MASK32) & 0xFF0000FF
    v = ((v * 0x00000101) & _MASK32) & 0x0F00F00F
    v = ((v * 0x00000011) & _MASK32) & 0xC30C30C3
    v = ((v * 0x00000005) & _MASK32) & 0x49249249
    return v


def morton_codes(points: torch.Tensor) -> torch.Tensor:
    """[N] 30-bit Morton codes (int64) of ``points`` [N,3] over their
    bounding box."""
    lo = torch.min(points, dim=0).values
    extent = torch.clamp(torch.max(points, dim=0).values - lo, min=1e-12)
    q = torch.clamp((points - lo) / extent * 1023.0, 0, 1023).to(torch.int64)
    return (_expand_bits(q[:, 0]) * 4 + _expand_bits(q[:, 1]) * 2
            + _expand_bits(q[:, 2])) & _MASK32


def _order_rotation(i: int) -> Optional[np.ndarray]:
    """The rotation [3,3] (float32) of ordering ``i``: None (identity) for
    the first, then fixed random orthogonal matrices. Rotations decorrelate
    the Morton orderings; a diagonal jitter would only shift one curve."""
    if i == 0:
        return None
    rng = np.random.default_rng(1234 + i)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q.astype(np.float32)


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances of broadcastable [..., 3] point arrays, summed
    x, y, z in order, as the JAX package sums them."""
    d = a[..., 0] - b[..., 0]
    acc = d * d
    d = a[..., 1] - b[..., 1]
    acc = acc + d * d
    d = a[..., 2] - b[..., 2]
    return acc + d * d


def _k_smallest(dist: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, positions) of the k smallest along the last axis, ascending."""
    return torch.topk(dist, k, dim=-1, largest=False, sorted=True)


def _merge_klists(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Merge m candidate lists per row, each free of duplicates.

    dists, ids: [N, m, w]. An id that occurs in several lists keeps its
    first occurrence; later copies get an infinite distance so that the
    final top-k does not spend slots on them."""
    n, m, w = ids.shape
    if m > 1:
        dup = torch.zeros((n, m, w), dtype=torch.bool, device=ids.device)
        rows = max(1, _BUDGET_BYTES // (w * w * 2))
        for r0 in range(0, n, rows):
            blk = ids[r0:r0 + rows]
            for b in range(1, m):
                for a in range(b):
                    dup[r0:r0 + rows, b] |= (blk[:, b, :, None] == blk[:, a, None, :]).any(-1)
        dists = dists.masked_fill(dup, float("inf"))
    d, pos = _k_smallest(dists.reshape(n, m * w), k)
    return d, torch.gather(ids.reshape(n, m * w), 1, pos)


def _pad_rows(x: torch.Tensor, after: int, value, before: int = 0) -> torch.Tensor:
    """``x`` with ``before`` and ``after`` rows of ``value`` around it."""
    if before == after == 0:
        return x

    def fill(count):
        return torch.full((count,) + tuple(x.shape[1:]), value, dtype=x.dtype, device=x.device)
    return torch.cat([fill(before), x, fill(after)], dim=0)


def _order_blocked_topk(pts: torch.Tensor, valid: Optional[torch.Tensor],
                        rot: Optional[np.ndarray], k: int, block: int, neighbors: int):
    """Top-k per point from one Morton ordering, blocked and contiguous.

    The candidates of a point in sorted block b are every point of blocks
    b - neighbors .. b + neighbors: at least ``neighbors * block`` ranks on
    each side. Returns (dists [N,k], ids [N,k]) in the original row order."""
    n = pts.shape[0]
    if rot is not None:
        rp = pts @ torch.as_tensor(rot, device=pts.device).T
    else:
        rp = pts
    order = torch.sort(morton_codes(rp), stable=True).indices

    pad = (-n) % block
    nb = (n + pad) // block
    sv = (torch.ones((n,), dtype=torch.bool, device=pts.device) if valid is None
          else valid[order])
    blocks = _pad_rows(pts[order], pad, 0.0).reshape(nb, block, 3)
    bids = _pad_rows(order, pad, -1).reshape(nb, block)
    bval = _pad_rows(sv, pad, False).reshape(nb, block)

    # `neighbors` invalid blocks on each end; the candidates of block b are
    # ext[b : b + 2 * neighbors + 1], flattened.
    nbh = neighbors
    ext_p = _pad_rows(blocks, nbh, 0.0, before=nbh)
    ext_i = _pad_rows(bids, nbh, -1, before=nbh)
    ext_v = _pad_rows(bval, nbh, False, before=nbh)
    span = range(2 * nbh + 1)
    cand_p = torch.cat([ext_p[s:s + nb] for s in span], dim=1)          # [nb,C,3]
    cand_i = torch.cat([ext_i[s:s + nb] for s in span], dim=1)          # [nb,C]
    cand_v = torch.cat([ext_v[s:s + nb] for s in span], dim=1)          # [nb,C]
    c = cand_p.shape[1]
    if c < k:
        raise ValueError(f"{c} candidates per block cannot give {k} neighbours")

    out_d = torch.empty((nb * block, k), dtype=pts.dtype, device=pts.device)
    out_i = torch.empty((nb * block, k), dtype=torch.int64, device=pts.device)
    g = max(1, _BUDGET_BYTES // (block * c * 4 * 3))
    for b0 in range(0, nb, g):
        q, qi = blocks[b0:b0 + g], bids[b0:b0 + g]
        cp, ci, cv = cand_p[b0:b0 + g], cand_i[b0:b0 + g], cand_v[b0:b0 + g]
        dist = _sq_dist(q[:, :, None, :], cp[:, None, :, :])                 # [g,B,C]
        bad = (ci[:, None, :] == qi[:, :, None]) | ~cv[:, None, :]
        d, pos = _k_smallest(dist.masked_fill_(bad, float("inf")), k)
        ids = torch.gather(ci[:, None, :].expand(-1, block, -1), 2, pos)
        rows = slice(b0 * block, b0 * block + d.shape[0] * block)
        out_d[rows] = d.reshape(-1, k)
        out_i[rows] = ids.reshape(-1, k)

    # Back to the original row order (pad slots sit at sorted ranks >= n).
    d_orig = torch.empty((n, k), dtype=pts.dtype, device=pts.device)
    i_orig = torch.empty((n, k), dtype=torch.int64, device=pts.device)
    d_orig[order] = out_d[:n]
    i_orig[order] = out_i[:n]
    return d_orig, i_orig


def _chunked_refine(pts: torch.Tensor, k: int, d: torch.Tensor, i: torch.Tensor,
                    sample: int):
    """One NN-descent round: the candidates of a row are its incumbents and
    the k-lists of its first ``sample`` incumbents, (1 + sample) lists free
    of duplicates each, merged by ``_merge_klists``. The incumbents'
    distances ride in; a neighbour's neighbour is scored afresh."""
    n = pts.shape[0]
    sample = min(sample, k)
    out_d, out_i = torch.empty_like(d), torch.empty_like(i)
    # Per row: the gathered points and distances of sample * k candidates and
    # the merge's pairwise id tests.
    per_row = sample * k * (3 * 4 + 4 + 8) * 3 + (sample + 1) * k * k
    rows = max(1, _BUDGET_BYTES // per_row)
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        idx_c = torch.arange(r0, r1, device=pts.device)
        i_c = i[r0:r1]
        src = i_c[:, :sample]
        nn2 = i[src.clamp(min=0)]                                           # [R,s,k]
        nn2 = torch.where((src >= 0)[..., None], nn2, torch.full_like(nn2, -1))
        flat = nn2.reshape(r1 - r0, sample * k)
        dist = _sq_dist(pts[r0:r1, None, :], pts[flat.clamp(min=0)])        # [R,s*k]
        invalid = (flat == idx_c[:, None]) | (flat < 0)
        dist = dist.masked_fill_(invalid, float("inf")).reshape(r1 - r0, sample, k)
        out_d[r0:r1], out_i[r0:r1] = _merge_klists(
            torch.cat([d[r0:r1, None, :], dist], dim=1),
            torch.cat([i_c[:, None, :], nn2], dim=1), k)
    return out_d, out_i


def knn(points: torch.Tensor, k: int, window: int = 512,
        mask: Optional[torch.Tensor] = None, n_orders: int = 2,
        refine_rounds: int = 2, neighbors: int = 1,
        refine_sample: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """K nearest neighbours of every point, itself excluded: (squared
    distances [N,k] ascending, ids [N,k] int64), on the points' device.

    ``mask`` [N] bool: points where it is False are never returned as
    neighbours, and their own rows are meaningless. Empty slots (fewer than
    k valid candidates) hold an infinite distance and id -1."""
    if mask is not None:
        hi = torch.max(points, dim=0).values
        lo = torch.min(points, dim=0).values
        # Masked points go to a far corner, so that they sort away from the rest.
        far = hi + 10.0 * (hi - lo + 1.0)
        pts = torch.where(mask[:, None], points, far[None, :])
    else:
        pts = points
    ds, ids = [], []
    for o in range(n_orders):
        d_o, i_o = _order_blocked_topk(pts, mask, _order_rotation(o), k, window, neighbors)
        ds.append(d_o)
        ids.append(i_o)
    if n_orders > 1:
        d, i = _merge_klists(torch.stack(ds, dim=1), torch.stack(ids, dim=1), k)
    else:
        d, i = ds[0], ids[0]
    for _ in range(refine_rounds):
        d, i = _chunked_refine(pts, k, d, i, refine_sample)
    return d, torch.where(torch.isinf(d), torch.full_like(i, -1), i)


def knn_index_subset(points: torch.Tensor, k: int, neighbor_mask: torch.Tensor,
                     **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
    """``knn`` where only the points flagged in ``neighbor_mask`` may be
    returned as neighbours (simple-knn's ``distIndexQ``)."""
    return knn(points, k, mask=neighbor_mask, **kwargs)


def knn_exact(points: torch.Tensor, k: int,
              mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact O(N^2) KNN, for tests and small N."""
    dist = _sq_dist(points[:, None, :], points[None, :, :])
    dist.fill_diagonal_(float("inf"))
    if mask is not None:
        dist = dist.masked_fill(~mask[None, :], float("inf"))
    return _k_smallest(dist, k)


def mean_knn_dist_sq(points: torch.Tensor, window: int = 64,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N] mean of the 3 smallest squared distances, the point itself
    included (simple-knn's distCUDA2): (d1^2 + d2^2) / 3 with d1, d2 the
    two nearest neighbours' distances, an empty slot counting 0."""
    d2, _ = knn(points, 2, window=window, mask=mask, n_orders=2, refine_rounds=0)
    d2 = torch.where(torch.isfinite(d2), d2, torch.zeros_like(d2))
    return (d2[:, 0] + d2[:, 1]) / 3.0
