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
opacity reset, then the SH cull. The eight ``Camera*`` compositions are
``CameraTrainerWrapper`` over the composition of the same name without the
prefix; the five ``camera-*`` modes use five of them. ``prepare.modes``
maps each mode to its trainer here.
"""
from __future__ import annotations

from functools import partial

from .importance import ImportancePruningDensifierWrapper
from .pruning import PruningDensifierWrapper, ReducedDensificationDensifierWrapper
from .shculling import SHCullingTrainer, SHCullingTrainerWrapper, VariableSHGaussianModel
from .trainer import (CameraTrainerWrapper, DensificationTrainer, DepthTrainerWrapper,
                      NoopDensifier, OpacityResetDensificationTrainer,
                      OpacityResetTrainerWrapper)


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


# --- trainable cameras over them --------------------------------------------

def CameraSHCullingTrainer(model, dataset, **configs):
    return CameraTrainerWrapper(SHCullingTrainer, model, dataset, **configs)


def CameraFullPruningTrainer(model, dataset, **configs):
    return CameraTrainerWrapper(FullPruningTrainer, model, dataset, **configs)


def CameraFullReducedDensificationTrainer(model, dataset, **configs):
    return CameraTrainerWrapper(FullReducedDensificationTrainer, model, dataset, **configs)


def CameraOpacityResetFullReducedDensificationTrainer(model, dataset, **configs):
    return CameraTrainerWrapper(OpacityResetFullReducedDensificationTrainer, model, dataset,
                                **configs)


def CameraSHCullingOpacityResetDensificationTrainer(model, dataset, **configs):
    return CameraTrainerWrapper(SHCullingOpacityResetDensificationTrainer, model, dataset,
                                **configs)


def CameraSHCullingFullPruningTrainer(model, dataset, **configs):
    return CameraTrainerWrapper(SHCullingFullPruningTrainer, model, dataset, **configs)


def CameraSHCullingFullReducedDensificationTrainer(model, dataset, **configs):
    return CameraTrainerWrapper(SHCullingFullReducedDensificationTrainer, model, dataset,
                                **configs)


def CameraSHCullingOpacityResetFullReducedDensificationTrainer(model, dataset, **configs):
    return CameraTrainerWrapper(SHCullingOpacityResetFullReducedDensificationTrainer, model,
                                dataset, **configs)
