"""Opacity, screen-size and world-size pruning (counterpart of
reduced_3dgs_tpu/trainer/densifier/opacity_pruner.py:24-85).

Every ``prune_interval`` steps in [prune_from_iter, prune_until_iter], a
Gaussian is removed when its opacity is below ``prune_opacity_threshold``,
or, once the prune step is past ``prune_big_from_iter`` (strictly), when its
largest screen radius since the statistics were last reset exceeds
``prune_screensize_threshold`` or its largest scale exceeds
0.1 * prune_percent_too_big * scene_extent. The mask stays on the device.

Where this pruner wraps ``SplitCloneDensifier`` (``DensificationDensifierWrapper``)
and both fire at one step, the split resets the statistics first, so the
screen-size criterion reads zeroed radii and removes nothing at that step.
The JAX package does the same, and so does vanilla 3DGS, whose
densification zeroes ``max_radii2D`` before its prune; the port follows.
"""
from __future__ import annotations

from typing import Callable

import torch

from ...utils import profiling
from .abc import AbstractDensifier, DensificationInstruction, DensifierWrapper


class OpacityPruner(DensifierWrapper):

    def __init__(self, base_densifier: AbstractDensifier, dataset,
                 scene_extent: float = None,
                 prune_from_iter: int = 1000,
                 prune_until_iter: int = 15000,
                 prune_interval: int = 100,
                 prune_screensize_threshold: float = 20,
                 prune_percent_too_big: float = 1,
                 prune_opacity_threshold: float = 0.005,
                 prune_big_from_iter: int = 3000):
        super().__init__(base_densifier)
        if scene_extent is None:
            scene_extent = dataset.scene_extent() if dataset is not None else 1.0
        self.scene_extent = float(scene_extent)
        self.prune_from_iter = prune_from_iter
        self.prune_until_iter = prune_until_iter
        self.prune_interval = prune_interval
        self.prune_screensize_threshold = prune_screensize_threshold
        self.prune_percent_too_big = prune_percent_too_big
        self.prune_opacity_threshold = prune_opacity_threshold
        self.prune_big_from_iter = prune_big_from_iter
        self._curr_prune_step = 0

    @torch.no_grad()
    def prune(self) -> torch.Tensor:
        """[N] bool removal mask, on the model's device, tallied under
        ``events.prune.removed``."""
        with profiling.span("event.prune"):
            engine = self.trainer.engine
            params = engine.model.param_dict()
            mask = torch.sigmoid(params["opacity"][:, 0]) < self.prune_opacity_threshold
            if self._curr_prune_step > self.prune_big_from_iter:
                mask |= engine.max_radii2d > self.prune_screensize_threshold
                max_scaling = torch.max(torch.exp(params["scaling"]), dim=1).values
                mask |= max_scaling > 0.1 * self.prune_percent_too_big * self.scene_extent
            profiling.tally("events.prune.removed", mask.sum())
        return mask

    def fires(self, step: int) -> bool:
        return (self.prune_from_iter <= step <= self.prune_until_iter
                and step % self.prune_interval == 0)


    def fires_at(self, step: int) -> bool:
        return self.fires(step) or super().fires_at(step)

    def densify_and_prune(self, loss, out, camera, step: int) -> DensificationInstruction:
        ret = super().densify_and_prune(loss, out, camera, step)
        if self.fires(step):
            self._curr_prune_step = step
            ret = ret.merge_remove(self.prune())
        return ret


def OpacityPrunerDensifierWrapper(
        base_densifier_constructor: Callable[..., AbstractDensifier],
        model, dataset, **configs):
    """OpacityPruner over the densifier that
    ``base_densifier_constructor(model, dataset, **configs)`` builds."""
    keys = ("scene_extent", "prune_from_iter", "prune_until_iter", "prune_interval",
            "prune_screensize_threshold", "prune_percent_too_big",
            "prune_opacity_threshold", "prune_big_from_iter")
    own = {k: configs.pop(k) for k in keys if k in configs}
    return OpacityPruner(base_densifier_constructor(model, dataset, **configs), dataset, **own)
