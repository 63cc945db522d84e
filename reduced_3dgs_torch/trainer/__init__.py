from functools import partial

from .abc import AbstractTrainer, TrainerWrapper  # noqa: F401
from .base import BaseTrainer, Trainer  # noqa: F401
from .camera_trainer import CameraTrainer, CameraTrainerWrapper  # noqa: F401
from .densifier import (AbstractDensifier, AppendSpec,  # noqa: F401
                        DensificationDensifierWrapper, DensificationInstruction,
                        DensificationTrainer, DensifierWrapper, NoopDensifier,
                        OpacityPruner, OpacityPrunerDensifierWrapper, SplitCloneDensifier,
                        SplitCloneDensifierWrapper)
from .extensions import (DepthSupervisor, DepthTrainerWrapper,  # noqa: F401
                         OpacityResetter, OpacityResetTrainerWrapper, ScaleRegularizer,
                         ScaleRegularizeTrainerWrapper)


def _noop_ctor(model, dataset, **configs):
    del dataset, configs
    return NoopDensifier(model)


def BaseDensificationTrainer(model, dataset, **configs):
    """Vanilla-3DGS densification trainer:
    DensificationTrainer(Trainer, OpacityPruner(SplitCloneDensifier(NoopDensifier)))
    (counterpart of reduced_3dgs_tpu/trainer/__init__.py:20-24)."""
    return DensificationTrainer.from_densifier_constructor(
        partial(DensificationDensifierWrapper, _noop_ctor), model, dataset, **configs)


def DepthDensificationTrainer(model, dataset, **configs):
    """BaseDensificationTrainer with depth supervision."""
    return DepthTrainerWrapper(BaseDensificationTrainer, model, dataset, **configs)


def OpacityResetDensificationTrainer(model, dataset, **configs):
    """DepthDensificationTrainer with the periodic opacity reset, the trainer
    under every densify-* mode."""
    return OpacityResetTrainerWrapper(DepthDensificationTrainer, model, dataset, **configs)
