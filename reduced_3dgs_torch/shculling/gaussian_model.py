"""Model with a per-Gaussian SH degree (counterpart of
reduced_3dgs_tpu/shculling/gaussian_model.py:21-78).

The int buffer ``_degrees`` [N] selects how many SH bands each Gaussian
uses; ``masked_features`` multiplies the rest coefficients beyond it by
zero, so they neither colour the render nor receive gradient (exactly zero:
the product's gradient is the mask times the cotangent). ``aux_state`` and
``aux_set`` carry it through the trainer's row removal and appending (new
rows take ``aux_for_new_points``: the maximum degree), and SH culling sets
it with ``aux_set``.

``CameraTrainableVariableSHGaussianModel`` is the model of the ``camera-*``
modes; the ``*Gsplat*`` names are the JAX registry's aliases of the same
3DGS classes. ``VariableSHGsplat2DGSGaussianModel`` (and its camera-trainable
twin) keeps the same parameters and reduction state and renders them as
surfels (``ops/rasterize/twodgs.py``); every caller renders through
``render`` (``render_band`` included), so training, importance pruning, SH
culling and their sharded forms all see the surfel renderer.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.gaussian_model import CameraTrainableGaussianModel, GaussianModel
from ..ops import sh as sh_ops
from ..ops.rasterize.twodgs import render_tiled_2dgs


class VariableSHGaussianModel(GaussianModel):

    def __init__(self, sh_degree: int = 3, device="cuda"):
        super().__init__(sh_degree, device=device)
        self.register_buffer("_degrees", torch.zeros((0,), dtype=torch.int32, device=self.device))

    def masked_features(self, params=None, degrees=None) -> torch.Tensor:
        """As GaussianModel.masked_features, with the rest coefficients
        beyond ``degrees`` (the model's own when None) zeroed."""
        params = self.param_dict() if params is None else params
        degrees = self._degrees if degrees is None else degrees
        mask = sh_ops.degree_coeff_mask(degrees, self.max_sh_degree)
        rest = params["features_rest"] * mask[..., None]
        return torch.cat([params["features_dc"], rest], dim=1)

    def aux_state(self):
        """``_degrees`` moves with the rows when the trainer removes some
        (the JAX model's ``update_points_remove``)."""
        return {"degrees": self._degrees}

    def aux_set(self, aux):
        self._degrees = aux["degrees"]
        return self

    def aux_for_new_points(self, m: int):
        """Points that densification adds start at the maximum degree."""
        return {"degrees": torch.full((m,), self.max_sh_degree, dtype=torch.int32,
                                      device=self.device)}

    def init_degrees(self):
        """Every Gaussian at the maximum degree."""
        self._degrees = torch.full((self.num_points,), self.max_sh_degree,
                                   dtype=torch.int32, device=self.device)
        return self

    def create_from_pcd(self, *args, **kwargs):
        """As GaussianModel.create_from_pcd, every Gaussian at the maximum
        degree."""
        super().create_from_pcd(*args, **kwargs)
        return self.init_degrees()

    def load_numpy(self, params, degrees=None):
        """As GaussianModel.load_numpy; ``degrees`` [N] is the JAX model's
        ``_degrees`` array, all at the maximum degree when None (so
        ``load_ply``, which comes through here, resets every degree)."""
        super().load_numpy(params)
        if degrees is None:
            return self.init_degrees()
        self._degrees = torch.tensor(np.asarray(degrees, np.int32), device=self.device)
        return self


class CameraTrainableVariableSHGaussianModel(VariableSHGaussianModel,
                                             CameraTrainableGaussianModel):
    pass


VariableSHGsplatGaussianModel = VariableSHGaussianModel
CameraTrainableVariableSHGsplatGaussianModel = CameraTrainableVariableSHGaussianModel


class VariableSHGsplat2DGSGaussianModel(VariableSHGaussianModel):
    """The variable-SH model rendered as 2D (surfel) Gaussians: the same
    parameters and reduction features; the third scale is ignored by the
    renderer."""

    # The event sweeps render camera by camera at the exact entry count: the
    # surfel compositor is plain PyTorch and pays for every slot of a static
    # buffer (the 2DGS step took 900.58-1023.08 ms under one against 366.89
    # ms before; PERF.md §6).
    static_sweeps = False

    def render(self, camera, mean2d_offset_ndc=None, *, params=None, degrees=None,
               with_stats: bool = False, tile_row_offset: int = 0, tile_rows=None,
               key_buffer_size=None) -> dict:
        """As ``GaussianModel.render``, through ``render_tiled_2dgs`` (whose
        dict adds "normal" and "distortion")."""
        return render_tiled_2dgs(*self.render_array_args(params, degrees),
                                 self.render_settings(camera),
                                 mean2d_offset_ndc=mean2d_offset_ndc, with_stats=with_stats,
                                 tile_row_offset=tile_row_offset, tile_rows=tile_rows,
                                 key_buffer_size=key_buffer_size)


class CameraTrainableVariableSHGsplat2DGSGaussianModel(VariableSHGsplat2DGSGaussianModel,
                                                       CameraTrainableGaussianModel):
    pass
