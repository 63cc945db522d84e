"""ExcludeZeroSHQuantizer (counterpart of
reduced_3dgs_tpu/quantization/exclude_zeros.py:11-62): the all-zero rows of
an SH band (coefficients that SH culling removed) get id 0, whose centroid
is pinned at exactly zero, so they stay exactly 0 through quantization.
K-Means runs on the other rows only, by giving the zero rows weight 0."""
from __future__ import annotations

import torch

from ..ops.kmeans import kmeans
from .quantizer import REST_PREFIX, VectorQuantizer


class ExcludeZeroSHQuantizer(VectorQuantizer):

    def __init__(self, *args, treat_as_zero: float = 1e-8, **kwargs):
        super().__init__(*args, **kwargs)
        self.treat_as_zero = treat_as_zero

    def zeros_mask(self, values: torch.Tensor) -> torch.Tensor:
        return torch.all(torch.abs(values) < self.treat_as_zero, dim=-1)

    def has_zero(self, values: torch.Tensor) -> bool:
        return bool(torch.any(self.zeros_mask(values)))

    def generate_codebook_exclude_zero(self, values, num_clusters=256, init_codebook=None):
        """K-Means with K - 1 clusters on the non-zero rows and the zero
        centroid at id 0. A warm codebook that is all zero is dropped; one
        of more than K - 1 rows is cut to its last K - 1 (a codebook of the
        last event keeps its zero centroid first)."""
        zmask = self.zeros_mask(values)
        zero = torch.zeros((1, values.shape[1]), dtype=values.dtype, device=values.device)
        if bool(torch.all(zmask)):
            return zero, torch.zeros((values.shape[0],), dtype=torch.int64, device=values.device)
        if init_codebook is not None:
            if float(torch.max(torch.abs(init_codebook))) < self.treat_as_zero:
                init_codebook = None
            elif init_codebook.shape[0] > num_clusters - 1:
                init_codebook = init_codebook[-(num_clusters - 1):]
        nz_centers, nz_ids = kmeans(values, int(num_clusters) - 1,
                                    weights=(~zmask).to(values.dtype),
                                    init_centers=init_codebook, max_iter=self.max_iter,
                                    tol=self.tol, seed=self.seed)
        return torch.cat([zero, nz_centers]), torch.where(zmask, 0, nz_ids + 1)

    def produce_clusters_of(self, model, key: str, init_codebook=None):
        if not key.startswith(REST_PREFIX):
            return super().produce_clusters_of(model, key, init_codebook)
        vals = self.values(model, key)
        if init_codebook is not None:
            init_codebook = torch.as_tensor(init_codebook, dtype=vals.dtype, device=vals.device)
        generate = (self.generate_codebook_exclude_zero if self.has_zero(vals)
                    else self.generate_codebook)
        cb, ids = generate(vals, self.num_clusters_of(key), init_codebook)
        return cb, ids.reshape(-1, 3)
