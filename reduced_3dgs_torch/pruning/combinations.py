"""Pruning trainer compositions (counterpart of
reduced_3dgs_tpu/pruning/combinations.py:16-58)."""
from __future__ import annotations

from functools import partial
from typing import Callable

from ..trainer import (AbstractDensifier, DensificationTrainer, DepthTrainerWrapper,
                       NoopDensifier, SplitCloneDensifierWrapper)
from .trainer import BasePruningTrainer, PruningDensifierWrapper


def DepthPruningTrainer(model, dataset, **configs):
    return DepthTrainerWrapper(BasePruningTrainer, model, dataset, **configs)


PruningTrainer = DepthPruningTrainer


def ReducedDensificationDensifierWrapper(
        base_densifier_constructor: Callable[..., AbstractDensifier],
        model, dataset, **configs) -> AbstractDensifier:
    """Mercy pruning over vanilla clone and split:
    BasePruner(SplitCloneDensifier(...))."""
    return PruningDensifierWrapper(
        partial(SplitCloneDensifierWrapper, base_densifier_constructor),
        model, dataset, **configs)


def ReducedDensificationTrainerWrapper(
        base_densifier_constructor: Callable[..., AbstractDensifier],
        model, dataset, **configs):
    return DensificationTrainer.from_densifier_constructor(
        partial(ReducedDensificationDensifierWrapper, base_densifier_constructor),
        model, dataset, **configs)


def BaseReducedDensificationTrainer(model, dataset, **configs):
    return ReducedDensificationTrainerWrapper(
        lambda model, dataset, **cfg: NoopDensifier(model), model, dataset, **configs)


def DepthReducedDensificationTrainer(model, dataset, **configs):
    return DepthTrainerWrapper(BaseReducedDensificationTrainer, model, dataset, **configs)


ReducedDensificationTrainer = DepthReducedDensificationTrainer
# The reference's README names this composition BasePrunerInDensifyTrainer.
BasePrunerInDensifyTrainer = BaseReducedDensificationTrainer
