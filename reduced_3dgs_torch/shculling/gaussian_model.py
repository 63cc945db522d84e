"""Model with a per-Gaussian SH degree (counterpart of
reduced_3dgs_tpu/shculling/gaussian_model.py:21-64).

The int buffer ``_degrees`` [N] selects how many SH bands each Gaussian
uses; ``masked_features`` multiplies the rest coefficients beyond it by
zero, so they neither colour the render nor receive gradient (exactly zero:
the product's gradient is the mask times the cotangent).
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.gaussian_model import GaussianModel
from ..ops import sh as sh_ops


class VariableSHGaussianModel(GaussianModel):

    def __init__(self, sh_degree: int = 3, device="cuda"):
        super().__init__(sh_degree, device=device)
        self.register_buffer("_degrees", torch.zeros((0,), dtype=torch.int32, device=self.device))

    def masked_features(self) -> torch.Tensor:
        mask = sh_ops.degree_coeff_mask(self._degrees, self.max_sh_degree)
        rest = self._features_rest * mask[..., None]
        return torch.cat([self._features_dc, rest], dim=1)

    def init_degrees(self):
        """Every Gaussian at the maximum degree."""
        self._degrees = torch.full((self.num_points,), self.max_sh_degree,
                                   dtype=torch.int32, device=self.device)
        return self

    def load_numpy(self, params, degrees=None):
        """As GaussianModel.load_numpy; ``degrees`` [N] is the JAX model's
        ``_degrees`` array, all at the maximum degree when None (so
        ``load_ply``, which comes through here, resets every degree)."""
        super().load_numpy(params)
        if degrees is None:
            return self.init_degrees()
        self._degrees = torch.tensor(np.asarray(degrees, np.int32), device=self.device)
        return self
