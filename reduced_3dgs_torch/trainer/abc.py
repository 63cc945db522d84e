"""Trainer abstractions: the wrapper-onion pattern (counterpart of
reduced_3dgs_tpu/trainer/abc.py:22-73, 120-164).

The innermost ``BaseTrainer`` is the engine: it owns the parameters, the
Adam state and the densification statistics, and runs one step. Wrappers
compose loss terms (``loss_pure``) and post-update hooks (``optim_step``).
``step`` is the template: it reads the outermost ``model`` property (the
quantize wrapper hooks there), runs one engine update with the outermost
composed loss, then the hook chain.

Windows (JAX trainer/abc.py:76-113, 154-164): ``step_many`` runs k steps
through ``engine.update_many`` (on the card, replays of one captured CUDA
graph) and fires the hook chain once, after the last. ``max_window`` sizes a
window so that no step inside it, but the last, is one where a hook does
work (``fires_at``) or where the engine's schedules advance
(``advances_at``). Every wrapper with hooks declares ``fires_at``; a
wrapper that overrides ``optim_step`` or ``model`` without declaring it
ends every window, so an unknown hook is never skipped.
"""
from __future__ import annotations

import abc
from typing import Tuple

from ..utils import profiling


class AbstractTrainer(abc.ABC):

    @property
    @abc.abstractmethod
    def engine(self) -> "AbstractTrainer":
        """The innermost BaseTrainer, which owns the state."""

    @property
    @abc.abstractmethod
    def model(self):
        ...

    @property
    @abc.abstractmethod
    def curr_step(self) -> int:
        ...

    @curr_step.setter
    def curr_step(self, v: int):
        raise NotImplementedError

    @abc.abstractmethod
    def loss_pure(self):
        """The loss function (params, out, camera, extras) -> scalar tensor,
        where ``params`` are the model's named parameters and ``out`` is the
        render's output dict. ``extras`` carries ``loss_scalars``."""

    def loss_scalars(self) -> dict:
        """Scalar inputs of ``loss_pure``, merged across the onion."""
        return {}

    def camera_adjustment(self, camera):
        """Trainable-camera hook: None, or (delta tensors, apply(camera,
        delta) -> camera, consume_grads(grads)) from the camera trainer
        (``camera_trainer.CameraTrainer``); the engine renders through the
        adjusted camera and hands the delta's gradients back."""
        return None

    def adjusted_camera(self, camera):
        """``camera`` with the pose the trainer learned for it; the camera
        itself under every trainer but the camera trainer."""
        return camera

    def optim_step(self):
        """Post-update hook chain; wrappers call super().optim_step() first."""
        return None

    def step(self, camera) -> Tuple:
        """One training step: returns (loss, render output dict)."""
        with profiling.span("step", step=self.curr_step + 1):
            model = self.model  # the property read that quantize wrappers hook
            del model
            loss, out = self.engine.update(self, camera)
            with profiling.span("hooks"):
                self.optim_step()
        return loss, out

    # ----------------------------------------------------------- windows
    def fires_at(self, step: int) -> bool:
        """Would this trainer's hooks (``optim_step``, or the ``model``
        property at the start of the next step) do work when ``curr_step``
        is ``step``? The base trainer has no hooks."""
        return False

    def max_window(self, k_max: int) -> int:
        """The largest k <= k_max such that steps curr_step + 1 ..
        curr_step + k fire no hook and advance no schedule before the last
        of them."""
        t0 = self.curr_step
        engine = self.engine
        k = 1
        while (k < k_max and not self.fires_at(t0 + k)
               and not engine.advances_at(t0 + k)):
            k += 1
        return k

    def step_many(self, cameras) -> Tuple:
        """``len(cameras)`` steps, then the hook chain once: (losses, ys),
        the per-step losses as 0-d device tensors and ys with "loss" and,
        when the cameras carry ground truth, "psnr" per step. The caller
        sizes the window with ``max_window``."""
        with profiling.span("window", step=self.curr_step + 1, k=len(cameras)):
            model = self.model  # the property read that quantize wrappers hook
            del model
            losses, ys = self.engine.update_many(self, cameras)
            with profiling.span("hooks"):
                self.optim_step()
        return losses, ys


class TrainerWrapper(AbstractTrainer):
    """Delegates everything to ``base_trainer``."""

    def __init__(self, base_trainer: AbstractTrainer):
        self.base_trainer = base_trainer

    @property
    def engine(self):
        return self.base_trainer.engine

    @property
    def model(self):
        return self.base_trainer.model

    @property
    def curr_step(self) -> int:
        return self.base_trainer.curr_step

    @curr_step.setter
    def curr_step(self, v: int):
        self.base_trainer.curr_step = v

    def loss_pure(self):
        return self.base_trainer.loss_pure()

    def loss_scalars(self) -> dict:
        return self.base_trainer.loss_scalars()

    def camera_adjustment(self, camera):
        return self.base_trainer.camera_adjustment(camera)

    def adjusted_camera(self, camera):
        return self.base_trainer.adjusted_camera(camera)

    def optim_step(self):
        return self.base_trainer.optim_step()

    def fires_at(self, step: int) -> bool:
        # A subclass that overrides a hook (optim_step or the model
        # property) without declaring fires_at ends every window.
        cls = type(self)
        own_hooks = (cls.optim_step is not TrainerWrapper.optim_step
                     or cls.model is not TrainerWrapper.model)
        if own_hooks and cls.fires_at is TrainerWrapper.fires_at:
            return True
        return self.base_trainer.fires_at(step)
