from .combinations import (BasePrunerInDensifyTrainer,  # noqa: F401
                           BaseReducedDensificationTrainer, DepthPruningTrainer,
                           DepthReducedDensificationTrainer, PruningTrainer,
                           ReducedDensificationDensifierWrapper, ReducedDensificationTrainer,
                           ReducedDensificationTrainerWrapper)
from .trainer import (BasePruner, BasePruningTrainer,  # noqa: F401
                      PruningDensifierWrapper, PruningTrainerWrapper,
                      calculate_redundancy_metric, mercy_gaussians, mercy_points)
