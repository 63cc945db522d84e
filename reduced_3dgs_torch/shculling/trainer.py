"""SH band culling (counterpart of reduced_3dgs_tpu/shculling/trainer.py:25-142).

At ``cull_at_steps`` (default [15000]) the colour statistics of every
Gaussian are taken over all cameras, then

  1. low-variance culling: where the weighted colour std is below
     ``std_threshold`` (0.04), the degree drops to 0, the weighted mean
     colour is baked into the DC coefficients ((mean - 0.5) / SH_C0) and the
     rest coefficients are zeroed;
  2. low-distance culling: for the bands from high to low, where the
     weighted distance of the colour truncated at that band from the full
     colour is below ``cdist_threshold`` (6), the degree is capped there and
     the coefficients above it are zeroed.

The second pass of statistics renders the features and degrees the first
pass produced, before they are written to the model. The culler writes the
features in place and leaves Adam's moments as they are. For cameras of one
image size and FoV both passes are static sweeps
(``calculate_colours_variance``): on the card each is a CUDA graph captured
for the pass and replayed per view, and the second pass captures a graph of
its own, since its features and degrees are other tensors than the first
pass's (two captures a cull, each after one eager view). The culler passes
its engine's key buffer to both sweeps and takes back a regrown one
(``BaseTrainer.sweep_buffer``).
When the trainer's engine has a device mesh (``parallel.ShardedTrainer``),
both passes run over it per batch (``parallel.stats.sharded_colours_variance``).
"""
from __future__ import annotations

import torch

from ..dataset.camera import sweep_cameras
from ..ops.sh import SH_C0
from ..ops.shculling_stats import calculate_colours_variance
from ..trainer import AbstractTrainer, BaseTrainer, Trainer, TrainerWrapper
from ..utils import profiling
from .gaussian_model import VariableSHGaussianModel


def _low_variance_colour_culling(degrees, features_dc, features_rest, threshold,
                                 weighted_variance, weighted_mean):
    std = torch.sqrt(weighted_variance)
    std = torch.where(torch.isnan(std), torch.zeros_like(std), std)
    std = torch.mean(std, dim=2)[:, 0]                        # [N]
    mask = std < threshold
    new_dc = (weighted_mean - 0.5) / SH_C0                    # [N,1,3]
    features_dc = torch.where(mask[:, None, None], new_dc, features_dc)
    degrees = torch.where(mask, torch.zeros_like(degrees), degrees)
    features_rest = torch.where(mask[:, None, None], torch.zeros_like(features_rest),
                                features_rest)
    return degrees, features_dc, features_rest


def _low_distance_colour_culling(degrees, features_rest, threshold, colour_distances,
                                 active_sh_degree):
    colour_distances = torch.where(torch.isnan(colour_distances),
                                   torch.zeros_like(colour_distances), colour_distances)
    coeff_idx = torch.arange(features_rest.shape[1], device=features_rest.device)
    for sh_degree in range(active_sh_degree - 1, 0, -1):
        coeffs_num = (sh_degree + 1) ** 2 - 1
        mask = colour_distances[:, sh_degree] < threshold
        degrees = torch.where(mask, torch.clamp(degrees, max=sh_degree), degrees)
        zero_rows = mask[:, None] & (coeff_idx >= coeffs_num)[None, :]
        features_rest = torch.where(zero_rows[..., None], torch.zeros_like(features_rest),
                                    features_rest)
    return degrees, features_rest


@torch.no_grad()
def cull_sh_bands(model: VariableSHGaussianModel, cameras, threshold: float = 0,
                  std_threshold: float = 0.0, mesh=None, engine=None):
    """Cull the SH bands of ``model`` from statistics over ``cameras``: sets
    its degrees and rewrites its DC and rest features in place. With
    ``mesh`` (a ``parallel.Mesh``), the statistics are swept over it;
    ``engine``, the training engine, sizes a static sweep's key buffer and
    takes back a regrown one."""
    params = {k: p.detach() for k, p in model.param_dict().items()}
    degrees = model.aux_state()["degrees"]
    if mesh is not None:
        from ..parallel.stats import sharded_colours_variance

        def stats_fn(*args):
            return sharded_colours_variance(*args, mesh=mesh)
    else:
        cameras = sweep_cameras(cameras)

        def stats_fn(*args):
            # Read before each pass: the first may have regrown the buffer.
            buffer = {} if engine is None or not cameras else engine.sweep_buffer(cameras[0])
            return calculate_colours_variance(*args, **buffer)

    _, weighted_variance, weighted_mean = stats_fn(
        cameras, model, params, degrees, model.active_sh_degree)
    degrees, f_dc, f_rest = _low_variance_colour_culling(
        degrees, params["features_dc"], params["features_rest"], std_threshold,
        weighted_variance, weighted_mean)
    params = dict(params, features_dc=f_dc, features_rest=f_rest)

    colour_distances, _, _ = stats_fn(
        cameras, model, params, degrees, model.active_sh_degree)
    degrees, f_rest = _low_distance_colour_culling(
        degrees, params["features_rest"], threshold, colour_distances,
        model.active_sh_degree)

    model._features_dc.copy_(f_dc)
    model._features_rest.copy_(f_rest)
    model.aux_set({"degrees": degrees})
    return model


class SHCuller(TrainerWrapper):
    """Fires ``cull_sh_bands`` after the steps in ``cull_at_steps``."""

    def __init__(self, base_trainer: AbstractTrainer, dataset,
                 cdist_threshold: float = 6, std_threshold: float = 0.04,
                 cull_at_steps=(15000,)):
        super().__init__(base_trainer)
        if not isinstance(self.model, VariableSHGaussianModel):
            raise TypeError("SHCuller requires a VariableSHGaussianModel")
        self.dataset = dataset
        self.cdist_threshold = cdist_threshold
        self.std_threshold = std_threshold
        self.cull_at_steps = list(cull_at_steps)

    def fires(self, step: int) -> bool:
        return step in self.cull_at_steps


    def fires_at(self, step: int) -> bool:
        return self.fires(step) or super().fires_at(step)

    def optim_step(self):
        ret = super().optim_step()
        if self.fires(self.curr_step):
            profiling.count("events.sh_cull")
            with profiling.span("event.sh_cull", step=self.curr_step):
                cull_sh_bands(self.model, self.dataset, self.cdist_threshold,
                              self.std_threshold, mesh=getattr(self.engine, "mesh", None),
                              engine=self.engine)
        return ret


def SHCullingTrainerWrapper(base_trainer_constructor, model: VariableSHGaussianModel,
                            dataset, cdist_threshold: float = 6,
                            std_threshold: float = 0.04, cull_at_steps=(15000,),
                            **configs):
    return SHCuller(base_trainer_constructor(model, dataset, **configs), dataset,
                    cdist_threshold=cdist_threshold, std_threshold=std_threshold,
                    cull_at_steps=cull_at_steps)


def BaseSHCullingTrainer(model: VariableSHGaussianModel, dataset, **configs):
    return SHCullingTrainerWrapper(BaseTrainer, model, dataset, **configs)


def SHCullingTrainer(model: VariableSHGaussianModel, dataset, **configs):
    return SHCullingTrainerWrapper(Trainer, model, dataset, **configs)
