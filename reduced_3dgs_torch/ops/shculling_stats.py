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
     the full colour, camera after camera in the given order.

More than one view of one image size and FoV, for the 3DGS family
(``sweeps_statically``), take the counterpart of JAX's one-program
``sweep`` (:137-152): every view renders through the static key buffer, and
on the card the per-view body, West's update included, is a CUDA graph
replayed once per view (``rasterize.sweep.static_sweep``). Unlike JAX's
sweep, which never reads the overflow flag and so colours from a truncated
render when the buffer overflows, the port ORs the flags and sweeps again
at twice the buffer, as the importance sweep does. Other views, and the
2DGS family (``static_sweeps`` False), take the loop: one eager render per
view at its exact entry count.
"""
from __future__ import annotations

import torch

from . import sh as sh_ops
from .rasterize.sweep import static_sweep, sweeps_statically


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


def colour_accumulators(n: int, max_deg: int, device) -> dict:
    """The sweep's zeroed sums: the weight sum [N,1], the running mean and
    variance [N,1,3] and the distance sums [N, max(D, 1)]."""
    return {"w_sum": torch.zeros((n, 1), dtype=torch.float32, device=device),
            "mean": torch.zeros((n, 1, 3), dtype=torch.float32, device=device),
            "variance": torch.zeros((n, 1, 3), dtype=torch.float32, device=device),
            "dist": torch.zeros((n, max(max_deg, 1)), dtype=torch.float32, device=device)}


def _accumulate(acc: dict, out: dict, camera, params: dict, degrees: torch.Tensor,
                max_deg: int):
    """One camera's render ``out`` added into ``acc`` in place."""
    coeff_mask = sh_ops.degree_coeff_mask(degrees, sh_ops.MAX_SH_DEGREE)
    features = torch.cat([params["features_dc"],
                          params["features_rest"] * coeff_mask[..., None]], dim=1)
    present = out["radii"] > 0
    touched = out["touched_pixels"].to(torch.float32)
    w = (out["transmittance_sum"] / torch.clamp(touched, min=1.0))[:, None]   # [N,1]

    dirs = sh_ops.normalize_dirs(params["xyz"] - camera.camera_center)
    cols = colours_by_degree(features, dirs, degrees, max_deg)
    cols = torch.where(present[:, None, None], cols, torch.zeros_like(cols))

    full = cols[:, max_deg, :]                                               # [N,3]
    if max_deg > 0:
        d = torch.linalg.vector_norm(full[:, None, :] - cols[:, :max_deg, :], dim=-1)
        acc["dist"] += w * torch.where(torch.isnan(d), torch.zeros_like(d), d)

    w_sum, mean, variance = acc["w_sum"], acc["mean"], acc["variance"]
    w_sum_new = w_sum + w
    coeff = torch.where(w_sum_new > 0, w / w_sum_new, torch.zeros_like(w))
    delta = full[:, None, :] - mean
    mean_new = torch.where(present[:, None, None], mean + coeff[..., None] * delta, mean)
    variance.copy_(torch.where(present[:, None, None],
                               variance + w[..., None] * delta * (full[:, None, :] - mean_new),
                               variance))
    mean.copy_(mean_new)
    w_sum.copy_(w_sum_new)


def colours_body(params: dict, degrees: torch.Tensor, max_deg: int):
    """The sweep's per-view body for ``make_body(K, acc)``: ``body(model,
    camera)`` renders ``params`` and ``degrees`` with statistics through a
    static buffer of K entries, adds the view into ``acc`` in place and
    returns the 0-d overflow flag."""
    def make_body(key_buffer_size: int, acc: dict):
        def body(model, camera):
            out = model.render(camera, params=params, degrees=degrees, with_stats=True,
                               key_buffer_size=key_buffer_size)
            _accumulate(acc, out, camera, params, degrees, max_deg)
            return out["overflow"]
        return body
    return make_body


@torch.no_grad()
def calculate_colours_variance(cameras, model, params: dict, degrees: torch.Tensor,
                               active_sh_degree: int, key_buffer=None, on_regrow=None):
    """(avg_distances [N, max(D, 1)], variance [N, 1, 3], mean [N, 1, 3]) of
    the Gaussians of ``params`` with ``degrees``, rendered by ``model`` from
    every camera of ``cameras``, where D = ``active_sh_degree``. ``params``
    and ``degrees`` need not be the model's own: the culler renders its
    updated features before it writes them. A static sweep starts at
    ``key_buffer`` and calls ``on_regrow(K)`` after regrowing
    (``static_sweep``)."""
    max_deg = active_sh_degree
    n = params["xyz"].shape[0]
    device = params["xyz"].device
    cams = list(cameras)
    if sweeps_statically(model, cams):
        acc = static_sweep(model, cams, colours_body(params, degrees, max_deg),
                           lambda: colour_accumulators(n, max_deg, device), key_buffer,
                           on_regrow)
    else:
        acc = colour_accumulators(n, max_deg, device)
        for camera in cams:
            out = model.render(camera, params=params, degrees=degrees, with_stats=True)
            _accumulate(acc, out, camera, params, degrees, max_deg)
    avg_dist = acc["dist"] / torch.clamp(acc["w_sum"], min=1e-20)
    variance = acc["variance"] / torch.clamp(acc["w_sum"][..., None], min=1e-20)
    return avg_dist, variance, acc["mean"]
