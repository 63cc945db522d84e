"""Packed variable-degree SH, the inference form of an SH-culled model
(counterpart of reduced_3dgs_tpu/models/packed_sh.py:31-139).

After the SH cull a Gaussian of degree d needs only (d+1)^2 - 1 rest
coefficient rows. ``pack_variable_sh`` sorts the Gaussians by degree
(stably) and keeps exactly those rows, ragged and row-major:
sum_i ((d_i+1)^2 - 1) rows of 3 instead of 15 per Gaussian, with the count
of each degree group. ``packed_sh_colors`` evaluates each group with the SH
basis cut at its degree, and ``render_packed`` feeds those colours to the
tiled renderer as ``colors_precomp``: binning, sorting and compositing (the
forward compositor, ``composite_fwd`` on the card) are the dense render's,
so the packed model renders as the dense one. The JAX functions'
``key_buffer_size`` sizes a static buffer that the port does not have.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..ops import sh as sh_ops
from ..ops.rasterize.tiled import render_tiled
from .gaussian_model import camera_settings, normalized_rotation


def pack_variable_sh(params: Dict[str, torch.Tensor], degrees) -> Dict:
    """Sort the Gaussians by SH degree and drop the rows beyond each degree.

    Args: ``params``, the dense parameters (xyz, features_dc,
    features_rest [N,M,3], scaling, rotation, opacity); ``degrees`` [N]
    int, each Gaussian's degree.

    Returns the parameters in degree order without ``features_rest``, plus
    ``features_rest_packed`` [sum of rows, 3], ``group_counts`` (a list: the
    number of Gaussians of each degree 0..max) and ``degrees`` (sorted),
    on the parameters' device."""
    params = {k: torch.as_tensor(v) for k, v in params.items()}
    device = params["xyz"].device
    degrees = torch.as_tensor(degrees, device=device).to(torch.int64)
    order = torch.sort(degrees, stable=True).indices
    max_deg = int(degrees.max()) if degrees.numel() else 0
    counts = torch.bincount(degrees, minlength=max_deg + 1).tolist()
    rest = params["features_rest"][order]
    rows, start = [], 0
    for d, c in enumerate(counts):
        k = (d + 1) ** 2 - 1
        if c and k:
            rows.append(rest[start:start + c, :k, :].reshape(-1, 3))
        start += c
    packed = (torch.cat(rows, dim=0) if rows
              else torch.zeros((0, 3), dtype=rest.dtype, device=device))
    out = {k: v[order] for k, v in params.items() if k != "features_rest"}
    out.update(features_rest_packed=packed, group_counts=counts,
               degrees=degrees[order].to(torch.int32))
    return out


def unpack_variable_sh(packed: Dict, max_sh_degree: int = 3) -> Dict:
    """Inverse of ``pack_variable_sh``: dense [N,M,3] rest features (zero
    beyond each degree), in the packed (degree) order."""
    counts = packed["group_counts"]
    flat = packed["features_rest_packed"]
    m = (max_sh_degree + 1) ** 2 - 1
    rest = torch.zeros((sum(counts), m, 3), dtype=flat.dtype, device=flat.device)
    start, fstart = 0, 0
    for d, c in enumerate(counts):
        k = (d + 1) ** 2 - 1
        if c and k:
            rest[start:start + c, :k, :] = flat[fstart:fstart + c * k].reshape(c, k, 3)
        fstart += c * k
        start += c
    out = {k: v for k, v in packed.items()
           if k not in ("features_rest_packed", "group_counts", "degrees")}
    out["features_rest"] = rest
    return out


def packed_sh_colors(packed: Dict, campos: torch.Tensor) -> torch.Tensor:
    """[N,3] colour of each packed Gaussian seen from ``campos``: each
    degree group through ``eval_sh`` at its degree, with the positive
    clamp, as the dense render colours it."""
    xyz, dc = packed["xyz"], packed["features_dc"]
    flat = packed["features_rest_packed"]
    dirs = sh_ops.normalize_dirs(xyz - campos)
    cols, start, fstart = [], 0, 0
    for d, c in enumerate(packed["group_counts"]):
        if c == 0:
            continue
        k = (d + 1) ** 2 - 1
        shs = dc[start:start + c]
        if k:
            shs = torch.cat([shs, flat[fstart:fstart + c * k].reshape(c, k, 3)], dim=1)
        cols.append(sh_ops.eval_sh(shs, dirs[start:start + c], d, clamp=True))
        fstart += c * k
        start += c
    if not cols:
        return torch.zeros((0, 3), dtype=xyz.dtype, device=xyz.device)
    return torch.cat(cols, dim=0)


def packed_num_coeff_rows(degrees) -> int:
    """Rows of the ragged rest coefficients: sum((d_i+1)^2 - 1)."""
    d = torch.as_tensor(degrees).to(torch.int64)
    return int(((d + 1) ** 2 - 1).sum())


def render_packed(packed: Dict, camera) -> dict:
    """Render a packed model through the tiled pipeline with
    ``colors_precomp``, at the camera's own settings; the output dict is
    ``render_tiled``'s. The raw opacity goes in (the preprocess takes its
    sigmoid), with the scales exponentiated and the rotations normalised as
    the dense model's."""
    settings = camera_settings(camera)
    colors = packed_sh_colors(packed, settings.campos)
    return render_tiled(packed["xyz"], packed["opacity"], torch.exp(packed["scaling"]),
                        normalized_rotation(packed["rotation"]), None, settings,
                        colors_precomp=colors)
