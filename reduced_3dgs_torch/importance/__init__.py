from .trainer import (BaseImportancePruningTrainer, ImportancePruner,  # noqa: F401
                      ImportancePruningDensifierWrapper,
                      ImportancePruningTrainerWrapper, calculate_v_imp_score,
                      count_render, prune_gaussians, prune_list, score2mask)
