"""Weighted Lloyd K-Means (counterpart of reduced_3dgs_tpu/ops/kmeans.py:24-149).

The JAX package's semantics, kept exactly:

  * squared distances by the expansion |x|^2 - 2 x.c + |c|^2, clamped at 0,
    with the product in full float32 (TF32 off on the card, as the JAX
    package multiplies at ``precision="highest"``); ``torch.cdist`` rounds
    otherwise and would flip near-tie argmins;
  * the nearest centre is the first index on ties (``argmin``);
  * Lloyd stops when the squared shift of the centres is at most
    tol * max(mean(var(x, axis=0)), 1e-30), the population variance over
    every row, rows of weight 0 included, or after ``max_iter`` iterations;
    one final assignment follows; an empty cluster keeps its centre;
  * ``num_clusters <= 1`` gives the weighted mean;
  * a warm start with K or more rows takes the first K and draws nothing;
    with fewer, k-means++ seeds and the given rows overwrite the first ones.

Lloyd's assignment is ``assign``'s, in chunks of 65,536 rows (the JAX
package materialises the whole [N, K] distance matrix: 614 MB per iteration
for 600,000 rows at K = 256), so Lloyd's ids and ``assign``'s are one
computation. The centroid sums are ``index_add_``, float atomics on the
card whose last bits vary between runs. Ids are int64, torch's index type.

k-means++ draws from a weighted subsample of 8,192 rows taken with
replacement, with a ``torch.Generator`` seeded from ``seed``. It cannot
reproduce the JAX package's draw: a caller who needs that seeding passes its
K centres as ``init_centers``, which then skips the draw.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

ASSIGN_CHUNK = 65536
SEED_SAMPLE = 8192


@contextlib.contextmanager
def _full_float32():
    """Float32 matrix products in full precision (no TF32) inside the block."""
    precision = torch.get_float32_matmul_precision()
    if precision != "highest":
        torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if precision != "highest":
            torch.set_float32_matmul_precision(precision)


def pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[N, K] squared distances by the matmul expansion, clamped at 0."""
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    c2 = torch.sum(c * c, dim=1)[None, :]
    with _full_float32():
        xc = torch.matmul(x, c.T)
    return torch.clamp(x2 - 2.0 * xc + c2, min=0.0)


def assign(x: torch.Tensor, centers: torch.Tensor, chunk: int = ASSIGN_CHUNK) -> torch.Tensor:
    """Nearest-centre ids [N] (int64), ``chunk`` rows at a time."""
    return torch.cat([torch.argmin(pairwise_sq_dists(xs, centers), dim=1)
                      for xs in x.split(chunk)])


def lloyd(x: torch.Tensor, weights: torch.Tensor, init_centers: torch.Tensor,
          max_iter: int, tol: float) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Weighted Lloyd iterations from ``init_centers``: (centers [K, D], ids
    [N], the number of iterations run). Reads the shift on the host once
    per iteration, for the stopping rule."""
    k = init_centers.shape[0]
    tol_eff = torch.tensor(tol, dtype=x.dtype, device=x.device) * torch.clamp(
        torch.mean(torch.var(x, dim=0, correction=0)), min=1e-30)
    wx = x * weights[:, None]
    centers, it, moving = init_centers, 0, True
    while it < max_iter and moving:
        ids = assign(x, centers)
        sums = torch.zeros_like(centers).index_add_(0, ids, wx)
        cnts = torch.zeros((k,), dtype=x.dtype, device=x.device).index_add_(0, ids, weights)
        new_centers = torch.where(cnts[:, None] > 0, sums / cnts[:, None], centers)
        moving = bool(torch.sum((new_centers - centers) ** 2) > tol_eff)
        centers, it = new_centers, it + 1
    return centers, assign(x, centers), it


def _draw(p: torch.Tensor, count: int, generator: torch.Generator) -> torch.Tensor:
    """``count`` indices drawn with replacement, each with probability
    proportional to ``p``, by inverse CDF (an all-zero ``p`` gives the last
    index)."""
    cdf = torch.cumsum(p, 0)
    u = torch.rand((count,), generator=generator, dtype=p.dtype, device=p.device) * cdf[-1]
    return torch.searchsorted(cdf, u, right=True).clamp_(max=p.numel() - 1)


def kmeanspp_init(x: torch.Tensor, weights: torch.Tensor, num_clusters: int,
                  seed: int = 0, sample: int = SEED_SAMPLE) -> torch.Tensor:
    """k-means++ seeding on a weighted subsample of ``sample`` rows: [K, D]."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    take = min(sample, x.shape[0])
    xs = x[_draw(weights / torch.clamp(torch.sum(weights), min=1e-12), take, gen)]
    first = xs[_draw(torch.ones((take,), dtype=x.dtype, device=x.device), 1, gen)]
    centers = torch.zeros((num_clusters, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = first[0]
    d2 = torch.sum((xs - first) ** 2, dim=1)
    for k in range(1, num_clusters):
        c = xs[_draw(d2 / torch.clamp(torch.sum(d2), min=1e-12), 1, gen)]
        centers[k] = c[0]
        d2 = torch.minimum(d2, torch.sum((xs - c) ** 2, dim=1))
    return centers


def kmeans(x: torch.Tensor, num_clusters: int, weights: Optional[torch.Tensor] = None,
           init_centers: Optional[torch.Tensor] = None, max_iter: int = 100,
           tol: float = 1e-4, seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted Lloyd K-Means of ``x`` [N, D]: (centers [K, D], ids [N]).

    ``weights`` [N] are non-negative (0 ignores a row); ``init_centers``
    [<=K, D] warm-starts, completed by k-means++ picks; ``tol`` is relative,
    as in sklearn (see the module docstring)."""
    n = x.shape[0]
    num_clusters = int(num_clusters)
    if weights is None:
        weights = torch.ones((n,), dtype=x.dtype, device=x.device)
    if num_clusters <= 1:
        wsum = torch.clamp(torch.sum(weights), min=1e-12)
        center = torch.sum(x * weights[:, None], dim=0, keepdim=True) / wsum
        return center, torch.zeros((n,), dtype=torch.int64, device=x.device)
    if init_centers is not None and init_centers.shape[0] >= num_clusters:
        centers0 = init_centers[:num_clusters]
    else:
        centers0 = kmeanspp_init(x, weights, num_clusters, seed)
        if init_centers is not None and init_centers.shape[0] > 0:
            centers0[: init_centers.shape[0]] = init_centers
    centers, ids, _ = lloyd(x, weights, centers0, max_iter, tol)
    return centers, ids
