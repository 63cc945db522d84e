"""Per-Gaussian colour statistics for SH culling (counterpart of
reduced_3dgs_tpu/ops/shculling_stats.py:30-155).

For every camera, ``calculate_colours_variance``:

  1. renders with statistics (the statistics compositor, a CUDA kernel on
     the card) to get, per Gaussian, the mean incoming transmittance
     w = sum(T_in) / max(touched pixels, 1) and whether it is visible;
  2. evaluates the Gaussian's colour truncated at every SH degree 0..max
     (``colours_by_degree``);
  3. accumulates w-weighted distances from each truncated colour to the
     full one, and a weighted running mean and variance (West's update) of
     the full colour.

The JAX package scans over the stacked cameras in one jitted program to
spare TPU dispatches; the port loops over the cameras.
"""
from __future__ import annotations

import torch

from . import sh as sh_ops


def colours_by_degree(features: torch.Tensor, dirs: torch.Tensor, degrees: torch.Tensor,
                      max_sh_degree: int = 3) -> torch.Tensor:
    """[N, max_sh_degree+1, 3]: the colour at each truncation degree d, the
    SH sum through band d plus 0.5 clamped at 0 (the running sum is not
    clamped), and 0 for d above the Gaussian's own degree."""
    basis = sh_ops.sh_basis(dirs, max_sh_degree)                  # [N, (D+1)^2]
    terms = basis[..., None] * features[:, :basis.shape[-1], :]   # [N, (D+1)^2, 3]
    running = terms[:, 0, :] + 0.5
    outs = [torch.clamp(running, min=0.0)]
    for d in range(1, max_sh_degree + 1):
        running = running + torch.sum(terms[:, d * d:(d + 1) ** 2, :], dim=1)
        outs.append(torch.clamp(running, min=0.0))
    cols = torch.stack(outs, dim=1)
    enabled = (torch.arange(max_sh_degree + 1, device=degrees.device)[None, :]
               <= degrees[:, None])
    return torch.where(enabled[..., None], cols, torch.zeros_like(cols))


@torch.no_grad()
def calculate_colours_variance(cameras, model, params: dict, degrees: torch.Tensor,
                               active_sh_degree: int):
    """(avg_distances [N, max(D, 1)], variance [N, 1, 3], mean [N, 1, 3]) of
    the Gaussians of ``params`` with ``degrees``, rendered by ``model`` from
    every camera of ``cameras``, where D = ``active_sh_degree``. ``params``
    and ``degrees`` need not be the model's own: the culler renders its
    updated features before it writes them."""
    max_deg = active_sh_degree
    n = params["xyz"].shape[0]
    device = params["xyz"].device
    coeff_mask = sh_ops.degree_coeff_mask(degrees, sh_ops.MAX_SH_DEGREE)
    features = torch.cat([params["features_dc"],
                          params["features_rest"] * coeff_mask[..., None]], dim=1)

    w_sum = torch.zeros((n, 1), dtype=torch.float32, device=device)
    mean = torch.zeros((n, 1, 3), dtype=torch.float32, device=device)
    variance = torch.zeros((n, 1, 3), dtype=torch.float32, device=device)
    dist_accum = torch.zeros((n, max(max_deg, 1)), dtype=torch.float32, device=device)
    for camera in cameras:
        out = model.render(camera, params=params, degrees=degrees, with_stats=True)
        present = out["radii"] > 0
        touched = out["touched_pixels"].to(torch.float32)
        w = (out["transmittance_sum"] / torch.clamp(touched, min=1.0))[:, None]   # [N,1]

        dirs = sh_ops.normalize_dirs(params["xyz"] - camera.camera_center)
        cols = colours_by_degree(features, dirs, degrees, max_deg)
        cols = torch.where(present[:, None, None], cols, torch.zeros_like(cols))

        full = cols[:, max_deg, :]                                           # [N,3]
        if max_deg > 0:
            d = torch.linalg.vector_norm(full[:, None, :] - cols[:, :max_deg, :], dim=-1)
            dist_accum += w * torch.where(torch.isnan(d), torch.zeros_like(d), d)

        w_sum_new = w_sum + w
        coeff = torch.where(w_sum_new > 0, w / w_sum_new, torch.zeros_like(w))
        delta = full[:, None, :] - mean
        mean_new = torch.where(present[:, None, None], mean + coeff[..., None] * delta, mean)
        variance = torch.where(present[:, None, None],
                               variance + w[..., None] * delta * (full[:, None, :] - mean_new),
                               variance)
        mean, w_sum = mean_new, w_sum_new

    avg_dist = dist_accum / torch.clamp(w_sum, min=1e-20)
    variance = variance / torch.clamp(w_sum[..., None], min=1e-20)
    return avg_dist, variance, mean
