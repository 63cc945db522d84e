from functools import partial

from .abc import (AbstractDensifier, AppendSpec, DensificationInstruction,  # noqa: F401
                  DensificationTrainer, DensifierWrapper, NoopDensifier)
from .opacity_pruner import OpacityPruner, OpacityPrunerDensifierWrapper  # noqa: F401
from .split_clone import SplitCloneDensifier, SplitCloneDensifierWrapper  # noqa: F401


def DensificationDensifierWrapper(base_densifier_constructor, model, dataset, **configs):
    """Vanilla-3DGS densification: OpacityPruner over SplitCloneDensifier
    over the densifier that ``base_densifier_constructor`` builds (counterpart
    of reduced_3dgs_tpu/trainer/densifier/__init__.py:9-15)."""
    return OpacityPrunerDensifierWrapper(
        partial(SplitCloneDensifierWrapper, base_densifier_constructor),
        model, dataset, **configs)
