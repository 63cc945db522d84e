"""Densifier abstractions and the trainer that drives them (counterpart of
reduced_3dgs_tpu/trainer/densifier/abc.py:23-313).

A chain of ``DensifierWrapper``s ends in a ``NoopDensifier``. After every
step, ``DensificationTrainer`` asks the chain for a
``DensificationInstruction`` (wrappers extend it through super(): they OR
their removal masks in with ``merge_remove`` and add rows with
``add_append``) and applies it to the engine's state in one event: every
per-Gaussian tensor (parameters, Adam moments, the model's degrees, the
densification statistics) loses the removed rows and gains the new ones
together. New rows get zero Adam moments and statistics and the model's
``aux_for_new_points``.

Each densifier declares ``fires_at(step)``, whether its
``densify_and_prune`` does work at ``step``, so that a window of steps
(``AbstractTrainer.step_many``) ends there: the base densifier says yes
(an unknown densifier ends every window), ``NoopDensifier`` no, and a
``DensifierWrapper`` that overrides ``densify_and_prune`` without declaring
its own ends every window (JAX densifier/abc.py:73-112, 143-144).

Not ported: the JAX package's capacity and its capacity-static device fast
path (``_apply_instruction_device``) with its overflow fallback; they exist
for XLA's static shapes.
"""
from __future__ import annotations

import abc
from typing import Any, Dict, NamedTuple, Optional

import torch

from ...utils import profiling
from ..abc import AbstractTrainer, TrainerWrapper
from ..base import Trainer
from ..functional import append_rows, keep_rows


class AppendSpec(NamedTuple):
    """For every source row where ``select`` [N] bool is True, append
    ``copies`` rows taken from ``values`` (parameter name -> [N, copies, ...];
    rows where ``select`` is False are ignored)."""
    select: torch.Tensor
    values: Dict[str, torch.Tensor]
    copies: int


class DensificationInstruction(NamedTuple):
    new_points: Optional[Dict[str, Any]] = None   # param-name -> [M, ...]
    remove_mask: Optional[torch.Tensor] = None    # [N] bool
    appends: tuple = ()                           # AppendSpecs

    def merge_remove(self, mask: Optional[torch.Tensor]) -> "DensificationInstruction":
        """This instruction with ``mask`` ORed into its removal mask."""
        if mask is None:
            return self
        if self.remove_mask is None:
            return self._replace(remove_mask=mask)
        return self._replace(remove_mask=self.remove_mask | mask)

    def add_append(self, spec: AppendSpec) -> "DensificationInstruction":
        return self._replace(appends=self.appends + (spec,))


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

    def fires_at(self, step: int) -> bool:
        """Would ``densify_and_prune`` do work at ``step``?"""
        return True


class NoopDensifier(AbstractDensifier):
    """Chain terminator."""

    def densify_and_prune(self, loss, out, camera, step: int) -> DensificationInstruction:
        return DensificationInstruction()

    def fires_at(self, step: int) -> bool:
        return False


class DensifierWrapper(AbstractDensifier):

    def __init__(self, base_densifier: AbstractDensifier):
        super().__init__(base_densifier.model)
        self.base_densifier = base_densifier

    @property
    def model(self):
        return self.base_densifier.model

    def densify_and_prune(self, loss, out, camera, step: int) -> DensificationInstruction:
        return self.base_densifier.densify_and_prune(loss, out, camera, step)

    def fires_at(self, step: int) -> bool:
        cls = type(self)
        if (cls.densify_and_prune is not DensifierWrapper.densify_and_prune
                and cls.fires_at is DensifierWrapper.fires_at):
            return True
        return self.base_densifier.fires_at(step)


def _inject_trainer(densifier: AbstractDensifier, trainer: AbstractTrainer):
    d = densifier
    while d is not None:
        d.trainer = trainer
        d = getattr(d, "base_densifier", None)


def appended_points(instruction: DensificationInstruction,
                    device) -> Optional[Dict[str, torch.Tensor]]:
    """The rows ``instruction`` adds, by parameter name, [M, ...] on
    ``device``: its ``new_points``, then each AppendSpec's selected rows in
    source order, ``copies`` in a row (the JAX package's order:
    ``scatter_append`` lands them at n + copies * rank + j). None when it
    adds none."""
    parts = [] if instruction.new_points is None else [instruction.new_points]
    for sp in instruction.appends:
        parts.append({k: v[sp.select].reshape((-1,) + tuple(v.shape[2:]))
                      for k, v in sp.values.items()})
    if not parts:
        return None
    return {k: torch.cat([torch.as_tensor(p[k], device=device) for p in parts], dim=0)
            for k in parts[-1]}


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
        step = self.curr_step
        with (profiling.span("event.densify", step=step) if self.densifier.fires_at(step)
              else profiling.NO_SPAN):
            self.apply_instruction(self.densifier.densify_and_prune(loss, out, camera, step))
        return ret

    def fires_at(self, step: int) -> bool:
        return self.densifier.fires_at(step) or super().fires_at(step)

    def apply_instruction(self, instruction: DensificationInstruction):
        """Remove the rows of ``remove_mask`` (over the rows that existed
        before the event) and append the instruction's new rows after the
        kept ones, in one event. Rows appended are never removed in it.
        An instruction that carries a mask or rows counts as one
        ``events.densify``, with the Gaussians it added and removed, and
        reads the tallies the chain held (``profiling.flush_tallies``)."""
        if (instruction.remove_mask is None and instruction.new_points is None
                and not instruction.appends):
            return
        with profiling.span("event.apply"):
            profiling.flush_tallies()
            engine = self.engine
            n = self.model.num_points
            keep = (None if instruction.remove_mask is None
                    else ~instruction.remove_mask.to(torch.bool))
            with profiling.sync("event_rows",
                                sum(len(sp.values) for sp in instruction.appends)):
                new = appended_points(instruction, self.model._xyz.device)
            m = 0 if new is None else next(iter(new.values())).shape[0]
            trees = engine.state_trees()
            with profiling.sync("event_rows",
                                0 if keep is None else sum(len(t) for t in trees.values())):
                trees = (keep_rows(trees, keep) if new is None else
                         append_rows(trees, keep, new, self.model.aux_for_new_points(m)))
            engine.set_state_trees(trees)
        profiling.count("events.densify")
        profiling.count("events.densify.added", m)
        profiling.count("events.densify.removed", n + m - self.model.num_points)

    @classmethod
    def from_densifier_constructor(cls, densifier_constructor, model, dataset,
                                   trainer_constructor=Trainer, **configs):
        base = trainer_constructor(model, dataset, **configs)
        densifier = densifier_constructor(model, dataset, **configs)
        return cls(base, densifier)
