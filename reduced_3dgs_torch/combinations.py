"""Named trainer compositions (counterpart of reduced_3dgs_tpu/combinations.py).

Ported so far: ``SHCullingOpacityResetDensificationTrainer``, the trainer
of the ``densify-shculling`` mode (combinations.py:110-113 of the JAX
package), which composes

    SHCuller(OpacityResetter(DepthSupervisor(DensificationTrainer(
        Trainer, OpacityPruner(SplitCloneDensifier(NoopDensifier))))))

Where events coincide after one step, the densifier chain runs first
(inside ``DensificationTrainer.optim_step``), then the opacity reset, then
the SH cull. The compositions with mercy pruning, importance pruning inside
the densifier chain and trainable cameras, and the mode registry, are not
ported yet.
"""
from __future__ import annotations

from .shculling import SHCullingTrainerWrapper, VariableSHGaussianModel
from .trainer import OpacityResetDensificationTrainer


def SHCullingOpacityResetDensificationTrainer(model: VariableSHGaussianModel, dataset,
                                              **configs):
    return SHCullingTrainerWrapper(OpacityResetDensificationTrainer, model, dataset,
                                   **configs)
