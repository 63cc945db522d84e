"""Densifier abstractions and the trainer that drives them (counterpart of
reduced_3dgs_tpu/trainer/densifier/abc.py:23-313).

A chain of ``DensifierWrapper``s ends in a ``NoopDensifier``. After every
step, ``DensificationTrainer`` asks the chain for a
``DensificationInstruction`` (wrappers extend it through super() and OR
their removal masks with ``merge_remove``) and applies it to the engine's
state: every per-Gaussian tensor (parameters, Adam moments, the model's
degrees, the densification statistics) loses the removed rows together.

Only removal is ported. An instruction that adds points (``new_points`` or
``appends``: split and clone) raises NotImplementedError until the
densification slice ports it. The JAX package's capacity-static device fast
path (``_apply_instruction_device``) and ``fires_at`` exist for XLA's static
shapes and fused step windows, and are not ported.
"""
from __future__ import annotations

import abc
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..abc import AbstractTrainer, TrainerWrapper
from ..base import Trainer
from ..functional import keep_rows


class DensificationInstruction(NamedTuple):
    new_points: Optional[Dict[str, Any]] = None   # param-name -> [M, ...]
    remove_mask: Optional[torch.Tensor] = None    # [N] bool
    appends: tuple = ()

    def merge_remove(self, mask: Optional[torch.Tensor]) -> "DensificationInstruction":
        """This instruction with ``mask`` ORed into its removal mask."""
        if mask is None:
            return self
        if self.remove_mask is None:
            return self._replace(remove_mask=mask)
        return self._replace(remove_mask=self.remove_mask | mask)


class AbstractDensifier(abc.ABC):

    def __init__(self, model):
        self._model = model
        self.trainer: Optional[AbstractTrainer] = None  # set by DensificationTrainer

    @property
    def model(self):
        return self._model

    @abc.abstractmethod
    def densify_and_prune(self, loss, out, camera, step: int) -> DensificationInstruction:
        ...


class NoopDensifier(AbstractDensifier):
    """Chain terminator."""

    def densify_and_prune(self, loss, out, camera, step: int) -> DensificationInstruction:
        return DensificationInstruction()


class DensifierWrapper(AbstractDensifier):

    def __init__(self, base_densifier: AbstractDensifier):
        super().__init__(base_densifier.model)
        self.base_densifier = base_densifier

    @property
    def model(self):
        return self.base_densifier.model

    def densify_and_prune(self, loss, out, camera, step: int) -> DensificationInstruction:
        return self.base_densifier.densify_and_prune(loss, out, camera, step)


def _inject_trainer(densifier: AbstractDensifier, trainer: AbstractTrainer):
    d = densifier
    while d is not None:
        d.trainer = trainer
        d = getattr(d, "base_densifier", None)


class DensificationTrainer(TrainerWrapper):
    """Runs the densifier chain after every step on the engine's last step
    (loss, output, camera) and applies the instruction it returns."""

    def __init__(self, base_trainer: AbstractTrainer, densifier: AbstractDensifier):
        super().__init__(base_trainer)
        self.densifier = densifier
        _inject_trainer(densifier, self)

    def optim_step(self):
        ret = super().optim_step()
        io = self.engine._last_step_io_engine
        if io is None:
            return ret
        loss, out, camera = io
        self.apply_instruction(self.densifier.densify_and_prune(loss, out, camera,
                                                                self.curr_step))
        return ret

    def apply_instruction(self, instruction: DensificationInstruction):
        if instruction.new_points is not None or instruction.appends:
            raise NotImplementedError(
                "adding points (split, clone) comes with the densification slice of the "
                "port; only removal is ported")
        if instruction.remove_mask is None:
            return
        engine = self.engine
        keep = ~instruction.remove_mask.to(torch.bool)
        engine.set_state_trees(keep_rows(engine.state_trees(), keep))

    @classmethod
    def from_densifier_constructor(cls, densifier_constructor, model, dataset,
                                   trainer_constructor=Trainer, **configs):
        base = trainer_constructor(model, dataset, **configs)
        densifier = densifier_constructor(model, dataset, **configs)
        return cls(base, densifier)
