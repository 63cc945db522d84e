"""Trainer wrapper extensions: opacity reset, depth supervision and scale
regularisation (counterpart of reduced_3dgs_tpu/trainer/extensions.py:25-159).

``OpacityResetter`` clamps every opacity to at most the reset value after
each ``opacity_reset_interval``-th step (vanilla 3DGS's reset_opacity),
zeroing the opacity's Adam moments and keeping Adam's count.
``DepthSupervisor`` adds an L1 term between the render's expected depth and
the camera's ``ground_truth_depth`` (cameras without one add nothing), with
a weight that decays log-linearly over ``depth_l1_weight_max_steps`` steps
of ``extras["step"]``. ``ScaleRegularizer`` penalises needle Gaussians.

The JAX module's docstring also names the trainable cameras: their port,
``CameraTrainer`` and ``CameraTrainerWrapper``, is ``trainer/camera_trainer.py``.
"""
from __future__ import annotations

import math

import torch

from ..utils.math import abs_diff, inverse_sigmoid
from .abc import AbstractTrainer, TrainerWrapper


class OpacityResetter(TrainerWrapper):
    """After the steps that are multiples of ``opacity_reset_interval`` in
    (0, opacity_reset_until_iter], every opacity becomes
    inverse_sigmoid(min(sigmoid(opacity), opacity_reset_value)), and the
    opacity's Adam moments become zero."""

    def __init__(self, base_trainer: AbstractTrainer,
                 opacity_reset_interval: int = 3000,
                 opacity_reset_value: float = 0.01,
                 opacity_reset_until_iter: int = 15000):
        super().__init__(base_trainer)
        self.opacity_reset_interval = opacity_reset_interval
        self.opacity_reset_value = opacity_reset_value
        self.opacity_reset_until_iter = opacity_reset_until_iter

    def fires(self, step: int) -> bool:
        return (step % self.opacity_reset_interval == 0
                and 0 < step <= self.opacity_reset_until_iter)


    def fires_at(self, step: int) -> bool:
        return self.fires(step) or super().fires_at(step)

    def optim_step(self):
        ret = super().optim_step()
        if self.fires(self.curr_step):
            engine = self.engine
            with torch.no_grad():
                op = engine.model._opacity
                op.copy_(inverse_sigmoid(torch.clamp(torch.sigmoid(op),
                                                     max=self.opacity_reset_value)))
            engine.adam.m["opacity"].zero_()
            engine.adam.v["opacity"].zero_()
        return ret


def OpacityResetTrainerWrapper(base_trainer_constructor, model, dataset,
                               opacity_reset_interval: int = 3000,
                               opacity_reset_value: float = 0.01,
                               opacity_reset_until_iter: int = 15000,
                               **configs):
    return OpacityResetter(
        base_trainer_constructor(model, dataset, **configs),
        opacity_reset_interval=opacity_reset_interval,
        opacity_reset_value=opacity_reset_value,
        opacity_reset_until_iter=opacity_reset_until_iter)


def depth_weight(step: torch.Tensor, log_wi: float, log_wf: float,
                 max_steps: int) -> torch.Tensor:
    """exp(log_wi (1 - t) + log_wf t) with t = clip(step / max_steps, 0, 1)
    for Adam's count ``step`` (a 0-d tensor): a 0-d float32 tensor,
    computed where the count lives as the JAX package computes it in its
    step, so that a captured step replays it."""
    t = torch.clamp(step.to(torch.float32) / max_steps, 0.0, 1.0)
    return torch.exp(log_wi * (1.0 - t) + log_wf * t)


class DepthSupervisor(TrainerWrapper):
    """Adds weight * sum(|depth / max(1 - final_T, 1e-6) - gt|) / max(n, 1)
    over the pixels with gt > 0 and alpha = 1 - final_T > 0.5, where n counts
    the pixels with gt > 0, for cameras with a ``ground_truth_depth``. The
    weight decays from ``depth_l1_weight_init`` to ``depth_l1_weight_final``
    with ``extras["step"]`` (``depth_weight``)."""

    def __init__(self, base_trainer: AbstractTrainer,
                 depth_l1_weight_init: float = 1.0,
                 depth_l1_weight_final: float = 0.01,
                 depth_l1_weight_max_steps: int = 30000):
        super().__init__(base_trainer)
        base = self.base_trainer.loss_pure()
        log_wi = math.log(max(depth_l1_weight_init, 1e-30))
        log_wf = math.log(max(depth_l1_weight_final, 1e-30))
        max_steps = depth_l1_weight_max_steps

        def with_depth(params, out, camera, extras):
            loss = base(params, out, camera, extras)
            gt = camera.ground_truth_depth
            if gt is not None:
                weight = depth_weight(extras["step"], log_wi, log_wf, max_steps)
                alpha = 1.0 - out["final_T"]
                depth = out["depth"] / torch.clamp(alpha, min=1e-6)
                valid = gt > 0
                err = torch.where(valid & (alpha > 0.5), abs_diff(depth, gt),
                                  torch.zeros_like(depth))
                denom = torch.clamp(valid.sum(), min=1)
                loss = loss + weight * torch.sum(err) / denom
            return loss

        self._loss = with_depth

    def loss_pure(self):
        return self._loss


def DepthTrainerWrapper(base_trainer_constructor, model, dataset,
                        depth_l1_weight_init: float = 1.0,
                        depth_l1_weight_final: float = 0.01,
                        depth_l1_weight_max_steps: int = 30000,
                        **configs):
    return DepthSupervisor(
        base_trainer_constructor(model, dataset, **configs),
        depth_l1_weight_init=depth_l1_weight_init,
        depth_l1_weight_final=depth_l1_weight_final,
        depth_l1_weight_max_steps=depth_l1_weight_max_steps)


class ScaleRegularizer(TrainerWrapper):
    """Adds scale_reg_weight * mean(max(max_scale / min_scale - cap, 0)), the
    anisotropy penalty, with cap ``scale_reg_max_ratio``."""

    def __init__(self, base_trainer: AbstractTrainer,
                 scale_reg_weight: float = 0.01,
                 scale_reg_max_ratio: float = 10.0):
        super().__init__(base_trainer)
        base = self.base_trainer.loss_pure()
        cap = scale_reg_max_ratio
        w = scale_reg_weight

        def with_reg(params, out, camera, extras):
            loss = base(params, out, camera, extras)
            s = torch.exp(params["scaling"])
            ratio = torch.max(s, dim=1).values / torch.clamp(torch.min(s, dim=1).values,
                                                             min=1e-12)
            return loss + w * torch.mean(torch.clamp(ratio - cap, min=0.0))

        self._loss = with_reg

    def loss_pure(self):
        return self._loss


def ScaleRegularizeTrainerWrapper(base_trainer_constructor, model, dataset,
                                  scale_reg_weight: float = 0.01,
                                  scale_reg_max_ratio: float = 10.0,
                                  **configs):
    return ScaleRegularizer(
        base_trainer_constructor(model, dataset, **configs),
        scale_reg_weight=scale_reg_weight,
        scale_reg_max_ratio=scale_reg_max_ratio)
