"""The event sweeps over the (data, tile) mesh: importance counts and
SH-culling colour moments (counterpart of reduced_3dgs_tpu/parallel/stats.py).

The single-device sweeps (``importance.trainer.prune_list``,
``ops.shculling_stats.calculate_colours_variance``) render every camera in
turn, on the card as one captured body replayed per view. Here, as in the
sharded train step, and eagerly (gloo's collectives run on the host and
cannot be captured; JAX too runs one program per batch):

  * the data ranks take different cameras of a batch of n_data same-size
    cameras; a short last batch is padded with its first camera at weight 0;
  * the tile ranks render the bands of their camera with statistics
    (``render_band``);
  * band partial sums become per-camera totals by a sum over the tile
    ranks, then batch totals by a weighted sum over the data ranks.

Each rank adds up its own weighted band partials over all its batches, and
one ``all_reduce`` over the mesh at the end sums them: a sum over the tile
ranks, then over the data ranks, reordered. The colour statistics need each
camera's totals first (the weight is the mean incoming transmittance
sum(T_in) / touched pixels, a ratio of two totals), so those two sums go
over the tile ranks per camera, and the weighted moment sums (W, sum w c,
sum w c^2, sum w d), which can be added in any order where West's running
update of the single-device path cannot, go over the data ranks at the end.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..dataset.camera import resized_camera
from ..ops import sh as sh_ops
from ..ops.shculling_stats import colours_by_degree
from .sharding import Mesh, band_layout


def _camera_batches(cameras, n_data: int):
    """(n_data cameras, their weights) for every batch: same-size cameras
    together, a short batch padded with its first camera at weight 0."""
    groups = {}
    for cam in cameras:
        groups.setdefault((cam.image_height, cam.image_width), []).append(cam)
    for group in groups.values():
        for i in range(0, len(group), n_data):
            chunk = group[i:i + n_data]
            weights = [1.0] * len(chunk) + [0.0] * (n_data - len(chunk))
            yield chunk + [chunk[0]] * (n_data - len(chunk)), weights


@torch.no_grad()
def _sweep(model, cameras, mesh: Mesh, *, params=None, degrees=None, moments: bool = False,
           features=None, max_deg: int = 0) -> dict:
    """Every camera of ``cameras`` rendered with statistics over the mesh;
    the summed dict of "count", "opacity_score", "t_alpha_score" and, with
    ``moments``, "w_sum", "m1", "m2" and "dist", per Gaussian."""
    p = model.param_dict() if params is None else params
    xyz = p["xyz"].detach()
    n, dev = xyz.shape[0], xyz.device
    counts = torch.zeros((3, n), dtype=torch.float32, device=dev)
    mom = {"w_sum": torch.zeros((n,), dtype=torch.float32, device=dev),
           "m1": torch.zeros((n, 3), dtype=torch.float32, device=dev),
           "m2": torch.zeros((n, 3), dtype=torch.float32, device=dev),
           "dist": torch.zeros((n, max(max_deg, 1)), dtype=torch.float32, device=dev)}
    for batch, weights in _camera_batches(cameras, mesh.shape["data"]):
        camera, w_cam = batch[mesh.data_rank], weights[mesh.data_rank]
        band_tiles, _, _ = band_layout(camera.image_height, mesh.shape["tile"])
        out = model.render_band(camera, mesh.tile_rank * band_tiles, band_tiles,
                                params=params, degrees=degrees, with_stats=True)
        counts += w_cam * torch.stack([out["gaussians_count"].to(torch.float32),
                                       out["opacity_important_score"],
                                       out["T_alpha_important_score"]])
        if not moments:
            continue
        touched, transm = mesh.all_reduce(
            [out["touched_pixels"].to(torch.float32), out["transmittance_sum"]], "tile")
        present = out["radii"] > 0
        w = w_cam * torch.where(present, transm / torch.clamp(touched, min=1.0),
                                torch.zeros_like(transm))
        cols = colours_by_degree(features, sh_ops.normalize_dirs(xyz - camera.camera_center),
                                 degrees, max_deg)
        cols = torch.where(present[:, None, None], cols, torch.zeros_like(cols))
        full = cols[:, max_deg, :]
        mom["w_sum"] += w
        mom["m1"] += w[:, None] * full
        mom["m2"] += w[:, None] * full * full
        if max_deg > 0:
            d = torch.linalg.vector_norm(full[:, None, :] - cols[:, :max_deg, :], dim=-1)
            mom["dist"] += w[:, None] * torch.where(torch.isnan(d), torch.zeros_like(d), d)
    count, opacity_score, t_alpha_score = mesh.all_reduce([counts])[0]
    totals = {"count": count, "opacity_score": opacity_score, "t_alpha_score": t_alpha_score}
    if moments:
        totals.update(zip(mom, mesh.all_reduce(list(mom.values()), "data")))
    return totals


def sharded_prune_list(model, dataset, mesh: Mesh, resize: Optional[int] = None):
    """The sharded ``importance.trainer.prune_list``: (count int32, opacity
    score, T_alpha score), each [N], summed over every camera."""
    cams = [resized_camera(camera, resize, model._xyz.device) for camera in dataset]
    totals = _sweep(model, cams, mesh)
    return (totals["count"].to(torch.int32), totals["opacity_score"],
            totals["t_alpha_score"])


@torch.no_grad()
def sharded_colours_variance(cameras, model, params: dict, degrees: torch.Tensor,
                             active_sh_degree: int, mesh: Mesh):
    """The sharded ``ops.shculling_stats.calculate_colours_variance``:
    (avg_distances [N, max(D, 1)], variance [N, 1, 3], mean [N, 1, 3]), with
    the single-device path's normalisation, from the weighted moment sums."""
    max_deg = active_sh_degree
    coeff_mask = sh_ops.degree_coeff_mask(degrees, sh_ops.MAX_SH_DEGREE)
    features = torch.cat([params["features_dc"],
                          params["features_rest"] * coeff_mask[..., None]], dim=1)
    totals = _sweep(model, list(cameras), mesh, params=params, degrees=degrees, moments=True,
                    features=features, max_deg=max_deg)
    w_sum = totals["w_sum"][:, None]                                        # [N,1]
    denom = torch.clamp(w_sum, min=1e-20)
    mean = torch.where(w_sum > 0, totals["m1"] / denom,
                       torch.zeros_like(totals["m1"]))[:, None, :]         # [N,1,3]
    var_sum = totals["m2"] - totals["m1"] ** 2 / denom
    variance = torch.clamp(var_sum, min=0.0)[:, None, :] / denom[..., None]
    return totals["dist"] / denom, variance, mean
