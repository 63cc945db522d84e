from .gaussian_model import VariableSHGaussianModel  # noqa: F401
from .trainer import (BaseSHCullingTrainer, SHCuller, SHCullingTrainer,  # noqa: F401
                      SHCullingTrainerWrapper, cull_sh_bands)
