"""Named trainer compositions (counterpart of reduced_3dgs_tpu/combinations.py:37-131).

The trainers of the non-camera modes, each the JAX package's onion layer
for layer:

  * ``densify-shculling``: ``SHCullingOpacityResetDensificationTrainer``,
    SHCuller(OpacityResetter(DepthSupervisor(DensificationTrainer(Trainer,
    OpacityPruner(SplitCloneDensifier(NoopDensifier))))));
  * ``pruning``: ``FullPruningTrainer``, DepthSupervisor(DensificationTrainer(
    Trainer, BasePruner(ImportancePruner(NoopDensifier))));
  * ``pruning-shculling``: ``SHCullingFullPruningTrainer``, SHCuller over it;
  * ``densify-pruning``: ``OpacityResetFullReducedDensificationTrainer``,
    OpacityResetter(DepthSupervisor(DensificationTrainer(Trainer,
    BasePruner(SplitCloneDensifier(ImportancePruner(NoopDensifier))))));
  * ``densify-pruning-shculling``, the flagship:
    ``SHCullingOpacityResetFullReducedDensificationTrainer``, SHCuller over
    the last.

``BasePruner`` is the opacity/size prune with the mercy prune ORed in
(``pruning/trainer.py``). Where events coincide after one step, the
densifier chain runs first (inside ``DensificationTrainer.optim_step``;
within it the importance prune, then split and clone, then the opacity and
mercy prune, their masks ORed over the rows before the event), then the
opacity reset, then the SH cull. ``prepare.modes`` maps each mode to its
trainer here; the camera compositions are not ported yet.
"""
from __future__ import annotations

from functools import partial

from .importance import ImportancePruningDensifierWrapper
from .pruning import PruningDensifierWrapper, ReducedDensificationDensifierWrapper
from .shculling import SHCullingTrainerWrapper, VariableSHGaussianModel
from .trainer import (DensificationTrainer, DepthTrainerWrapper, NoopDensifier,
                      OpacityResetDensificationTrainer, OpacityResetTrainerWrapper)


def _noop(model, dataset, **configs):
    del dataset, configs
    return NoopDensifier(model)


# --- importance pruning and mercy pruning -----------------------------------

def FullPruningDensifierWrapper(base_densifier_constructor, model, dataset, **configs):
    return PruningDensifierWrapper(
        partial(ImportancePruningDensifierWrapper, base_densifier_constructor),
        model, dataset, **configs)


def FullPruningTrainerWrapper(base_densifier_constructor, model, dataset, **configs):
    return DensificationTrainer.from_densifier_constructor(
        partial(FullPruningDensifierWrapper, base_densifier_constructor),
        model, dataset, **configs)


def BaseFullPruningTrainer(model, dataset, **configs):
    return FullPruningTrainerWrapper(_noop, model, dataset, **configs)


def DepthFullPruningTrainer(model, dataset, **configs):
    return DepthTrainerWrapper(BaseFullPruningTrainer, model, dataset, **configs)


FullPruningTrainer = DepthFullPruningTrainer


# --- the same with split and clone ------------------------------------------

def FullReducedDensificationDensifierWrapper(base_densifier_constructor, model, dataset,
                                             **configs):
    return ReducedDensificationDensifierWrapper(
        partial(ImportancePruningDensifierWrapper, base_densifier_constructor),
        model, dataset, **configs)


def FullReducedDensificationTrainerWrapper(base_densifier_constructor, model, dataset,
                                           **configs):
    return DensificationTrainer.from_densifier_constructor(
        partial(FullReducedDensificationDensifierWrapper, base_densifier_constructor),
        model, dataset, **configs)


def BaseFullReducedDensificationTrainer(model, dataset, **configs):
    return FullReducedDensificationTrainerWrapper(_noop, model, dataset, **configs)


def DepthFullReducedDensificationTrainer(model, dataset, **configs):
    return DepthTrainerWrapper(BaseFullReducedDensificationTrainer, model, dataset,
                               **configs)


FullReducedDensificationTrainer = DepthFullReducedDensificationTrainer


def OpacityResetFullReducedDensificationTrainer(model, dataset, **configs):
    return OpacityResetTrainerWrapper(FullReducedDensificationTrainer, model, dataset,
                                      **configs)


# --- SH culling over them ---------------------------------------------------

def SHCullingOpacityResetDensificationTrainer(model: VariableSHGaussianModel, dataset,
                                              **configs):
    return SHCullingTrainerWrapper(OpacityResetDensificationTrainer, model, dataset,
                                   **configs)


def SHCullingFullPruningTrainer(model: VariableSHGaussianModel, dataset, **configs):
    return SHCullingTrainerWrapper(FullPruningTrainer, model, dataset, **configs)


def SHCullingFullReducedDensificationTrainer(model: VariableSHGaussianModel, dataset,
                                             **configs):
    return SHCullingTrainerWrapper(FullReducedDensificationTrainer, model, dataset,
                                   **configs)


def SHCullingOpacityResetFullReducedDensificationTrainer(model: VariableSHGaussianModel,
                                                         dataset, **configs):
    return SHCullingTrainerWrapper(OpacityResetFullReducedDensificationTrainer, model,
                                   dataset, **configs)
