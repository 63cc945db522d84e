"""Gaussian point-cloud model (counterpart of
reduced_3dgs_tpu/models/gaussian_model.py:58-410).

Raw parameters are ``nn.Parameter``s: ``_xyz [N,3]``, ``_features_dc
[N,1,3]``, ``_features_rest [N,M,3]``, ``_scaling [N,3]`` (log),
``_rotation [N,4]`` (unnormalised) and ``_opacity [N,1]`` (logit).
``forward(camera)`` renders through the tiled pipeline, and ``render(camera,
mean2d_offset_ndc)`` is the same render with the trainer's screen-space
offset; both are differentiable in the parameters unless ``with_stats``.
``render`` also renders from explicit parameters and degrees that are not
the model's own (the JAX model's functional ``render(params, camera,
aux)``), which SH culling needs. ``render_band`` renders one band of tile
rows (the multi-device trainer's and sweeps' one dispatch point, JAX
models/gaussian_model.py:268-290). ``mark_visible`` is the near-plane test
of each centre. PLY files use the
standard 3DGS layout, so the JAX package reads what this writes and the
other way round.
"""
from __future__ import annotations

import math
import os
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..dataset.camera import Camera
from ..ops.rasterize.common import RenderSettings, mark_visible
from ..ops.rasterize.tiled import render_tiled
from ..utils import profiling
from ..utils.device import resolve_device
from . import ply as plyio

PARAM_NAMES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


def normalized_rotation(rot: torch.Tensor) -> torch.Tensor:
    """q * rsqrt(|q|^2 + 1e-24): finite value and gradient at q = 0."""
    return rot * torch.rsqrt(torch.sum(rot * rot, dim=-1, keepdim=True) + 1e-24)


def camera_settings(camera: Camera, scale_modifier: float = 1.0,
                    sh_degree: int = 3) -> RenderSettings:
    """The rasterization settings of ``camera``."""
    return RenderSettings(
        image_height=camera.image_height,
        image_width=camera.image_width,
        tanfovx=math.tan(camera.FoVx * 0.5),
        tanfovy=math.tan(camera.FoVy * 0.5),
        bg=camera.bg_color,
        scale_modifier=scale_modifier,
        viewmatrix=camera.world_view_transform,
        projmatrix=camera.full_proj_transform,
        campos=camera.camera_center,
        sh_degree=sh_degree,
    )


class GaussianModel(nn.Module):
    """Standard 3DGS model (max SH degree ``sh_degree``, default 3)."""

    # The event sweeps render views of one size and FoV through a static key
    # buffer, as one captured body on the card (``ops.rasterize.sweep``).
    static_sweeps = True

    def __init__(self, sh_degree: int = 3, device="cuda"):
        super().__init__()
        self.max_sh_degree = int(sh_degree)
        self.active_sh_degree = int(sh_degree)
        self.scale_modifier = 1.0
        self.device = resolve_device(device)
        n_rest = (self.max_sh_degree + 1) ** 2 - 1
        shapes = dict(xyz=(0, 3), features_dc=(0, 1, 3), features_rest=(0, n_rest, 3),
                      scaling=(0, 3), rotation=(0, 4), opacity=(0, 1))
        for name in PARAM_NAMES:
            setattr(self, f"_{name}",
                    nn.Parameter(torch.zeros(shapes[name], device=self.device)))

    # --- activations -------------------------------------------------------
    @property
    def get_scaling(self):
        return torch.exp(self._scaling)

    @property
    def get_rotation(self):
        return normalized_rotation(self._rotation)

    @property
    def num_points(self) -> int:
        return int(self._xyz.shape[0])

    def param_dict(self) -> Dict[str, torch.Tensor]:
        """The raw parameters by their JAX-package names."""
        return {name: getattr(self, f"_{name}") for name in PARAM_NAMES}

    def masked_features(self, params: Optional[Dict[str, torch.Tensor]] = None,
                        degrees: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[N, 1+M, 3] SH features of ``params`` (the model's own when None)
        as the renderer reads them. ``degrees`` is used by models with
        per-Gaussian SH degrees and ignored here."""
        del degrees
        params = self.param_dict() if params is None else params
        return torch.cat([params["features_dc"], params["features_rest"]], dim=1)

    # --- state that moves with the rows -------------------------------------
    @torch.no_grad()
    def set_parameters(self, params: Dict[str, torch.Tensor]):
        """Replace the six parameters with new ``nn.Parameter``s holding
        ``params`` (their row count may differ from the current one), each
        contiguous whatever its source's layout (a PLY's SH rows arrive
        transposed): Adam's moments are contiguous, and its kernel takes
        parameters and gradients of their layout alone."""
        for name in PARAM_NAMES:
            setattr(self, f"_{name}", nn.Parameter(
                params[name].detach().clone(memory_format=torch.contiguous_format)))
        return self

    def aux_state(self) -> Dict[str, torch.Tensor]:
        """Non-trainable per-Gaussian state; none here."""
        return {}

    def aux_set(self, aux: Dict[str, torch.Tensor]):
        del aux
        return self

    def aux_for_new_points(self, m: int) -> Dict[str, torch.Tensor]:
        """``aux_state`` rows for m points that densification adds; none."""
        del m
        return {}

    # --- parameters from outside --------------------------------------------
    def load_numpy(self, params: Dict[str, np.ndarray], degrees=None):
        """Set the parameters from the JAX package's parameter dict (the six
        arrays of ``GaussianModel.parameters()``, as numpy). ``degrees`` is
        used by models with per-Gaussian SH degrees and ignored here."""
        del degrees
        return self.set_parameters({
            name: torch.tensor(np.asarray(params[name], np.float32), device=self.device)
            for name in PARAM_NAMES})

    # --- construction from a point cloud ---------------------------------------
    @torch.no_grad()
    def create_from_pcd(self, points, colors, scene_extent: float = 1.0):
        """Initialise from a sparse point cloud (the COLMAP start): centres
        ``points`` [N,3], DC colour from ``colors`` [N,3] in [0, 1], no higher
        bands, identity rotations, opacity 0.1, and isotropic log scales of
        sqrt(max(mean_knn_dist_sq, 1e-7)), computed on the model's device
        (simple-knn's distCUDA2 in the reference). Sets
        ``spatial_lr_scale`` to ``scene_extent``."""
        from ..ops.knn import mean_knn_dist_sq
        from ..ops.sh import SH_C0
        from ..utils.math import inverse_sigmoid
        points = torch.as_tensor(np.asarray(points, np.float32), device=self.device)
        colors = torch.as_tensor(np.asarray(colors, np.float32), device=self.device)
        n = points.shape[0]
        n_rest = (self.max_sh_degree + 1) ** 2 - 1
        dist2 = torch.clamp(mean_knn_dist_sq(points), min=1e-7)
        scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
        rotation = torch.zeros((n, 4), device=self.device)
        rotation[:, 0] = 1.0
        self.set_parameters(dict(
            xyz=points,
            features_dc=((colors - 0.5) / SH_C0)[:, None, :],
            features_rest=torch.zeros((n, n_rest, 3), device=self.device),
            scaling=scales,
            rotation=rotation,
            opacity=inverse_sigmoid(torch.full((n, 1), 0.1, device=self.device))))
        self.spatial_lr_scale = float(scene_extent)
        return self

    # --- rendering ----------------------------------------------------------
    def render_settings(self, camera: Camera) -> RenderSettings:
        return camera_settings(camera, self.scale_modifier, self.active_sh_degree)

    def render_array_args(self, params: Optional[Dict[str, torch.Tensor]] = None,
                          degrees: Optional[torch.Tensor] = None):
        """Renderer inputs from ``params`` (the model's own when None):
        means, opacity logits, scales, rotations, SH."""
        p = self.param_dict() if params is None else params
        return (p["xyz"], p["opacity"], torch.exp(p["scaling"]),
                normalized_rotation(p["rotation"]), self.masked_features(params, degrees))

    def forward(self, camera: Camera, with_stats: bool = False) -> dict:
        """Render the model from ``camera``; see ``render_tiled`` for the
        output dict and the statistics."""
        return self.render(camera, with_stats=with_stats)

    def render(self, camera: Camera,
               mean2d_offset_ndc: Optional[torch.Tensor] = None, *,
               params: Optional[Dict[str, torch.Tensor]] = None,
               degrees: Optional[torch.Tensor] = None,
               with_stats: bool = False, tile_row_offset: int = 0,
               tile_rows: Optional[int] = None,
               key_buffer_size: Optional[int] = None) -> dict:
        """Render from ``params`` and ``degrees`` (the model's own when
        None), differentiably unless ``with_stats`` (the counterpart of the
        JAX model's functional ``render``; every row is alive, as the port
        keeps no capacity padding). ``mean2d_offset_ndc`` [N,2] is the zero
        offset whose gradient is the screen-space gradient the trainer
        accumulates. ``tile_rows`` renders the band of that many tile rows
        from ``tile_row_offset`` (see ``render_tiled``). ``key_buffer_size``
        bins into a static buffer of that many entries, with no host sync;
        the output then holds "overflow" and "num_rendered" as tensors, as
        the JAX model's does."""
        with profiling.span("preprocess"):
            arrays = self.render_array_args(params, degrees)
        return render_tiled(*arrays, self.render_settings(camera),
                            mean2d_offset_ndc=mean2d_offset_ndc, with_stats=with_stats,
                            tile_row_offset=tile_row_offset, tile_rows=tile_rows,
                            key_buffer_size=key_buffer_size)

    def render_band(self, camera: Camera, tile_row_offset: int, tile_rows: int,
                    mean2d_offset_ndc: Optional[torch.Tensor] = None, *,
                    params: Optional[Dict[str, torch.Tensor]] = None,
                    degrees: Optional[torch.Tensor] = None,
                    with_stats: bool = False) -> dict:
        """The band of ``tile_rows`` tile rows from the image's tile row
        ``tile_row_offset``, rendered as ``render`` renders the image (the
        projection is the full image's): the one call through which the
        sharded trainer and sweeps render, so that every model family shards
        the same way (a family with another renderer overrides ``render``)."""
        return self.render(camera, mean2d_offset_ndc, params=params, degrees=degrees,
                           with_stats=with_stats, tile_row_offset=tile_row_offset,
                           tile_rows=tile_rows)

    def mark_visible(self, camera: Camera) -> torch.Tensor:
        """[N] bool: each centre in front of the camera's near plane."""
        return mark_visible(self._xyz.detach(), camera.world_view_transform)

    # --- PLY I/O (standard 3DGS layout) -------------------------------------
    def ply_arrays(self):
        n = self.num_points

        def host(t):
            return t.detach().cpu().numpy().astype(np.float32)

        xyz = host(self._xyz)
        f_dc = host(self._features_dc).reshape(n, -1)
        # 3DGS stores f_rest channel-major: all of channel 0, then 1, then 2.
        f_rest = host(self._features_rest).transpose(0, 2, 1).reshape(n, -1)
        return (xyz, f_dc, f_rest, host(self._opacity), host(self._scaling),
                host(self._rotation))

    def save_ply(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        xyz, f_dc, f_rest, opacities, scale, rotation = self.ply_arrays()
        n = xyz.shape[0]
        fields = OrderedDict()
        fields["x"], fields["y"], fields["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
        for nm in ["nx", "ny", "nz"]:
            fields[nm] = np.zeros(n, np.float32)
        for i in range(f_dc.shape[1]):
            fields[f"f_dc_{i}"] = f_dc[:, i]
        for i in range(f_rest.shape[1]):
            fields[f"f_rest_{i}"] = f_rest[:, i]
        fields["opacity"] = opacities[:, 0]
        for i in range(scale.shape[1]):
            fields[f"scale_{i}"] = scale[:, i]
        for i in range(rotation.shape[1]):
            fields[f"rot_{i}"] = rotation[:, i]
        vertex = plyio.fields_to_struct(fields, list(fields.keys()))
        plyio.write_ply(path, OrderedDict(vertex=vertex))

    def load_ply(self, path: str):
        v = plyio.read_ply(path)["vertex"]
        n = len(v)
        n_rest = (self.max_sh_degree + 1) ** 2 - 1
        rest_names = sorted([nm for nm in v.dtype.names if nm.startswith("f_rest_")],
                            key=lambda nm: int(nm.split("_")[-1]))
        if rest_names:
            f_rest = np.stack([v[nm] for nm in rest_names], axis=1).astype(np.float32)
            f_rest = f_rest.reshape(n, 3, -1).transpose(0, 2, 1)
        else:
            f_rest = np.zeros((n, n_rest, 3), np.float32)
        params = dict(
            xyz=np.stack([v["x"], v["y"], v["z"]], axis=1),
            features_dc=np.stack([v[f"f_dc_{i}"] for i in range(3)], axis=1)[:, None, :],
            features_rest=f_rest,
            opacity=v["opacity"][:, None],
            scaling=np.stack([v[f"scale_{i}"] for i in range(3)], axis=1),
            rotation=np.stack([v[f"rot_{i}"] for i in range(4)], axis=1))
        return self.load_numpy(params)


class CameraTrainableGaussianModel(GaussianModel):
    """The model of the ``camera-*`` modes. Every render differentiates
    through the camera's matrices already, so the class only marks the
    model, as the JAX package's registry does."""
