from .gaussian_model import (CameraTrainableVariableSHGaussianModel,  # noqa: F401
                             CameraTrainableVariableSHGsplatGaussianModel,
                             VariableSHGaussianModel, VariableSHGsplatGaussianModel)
from .trainer import (BaseSHCullingTrainer, SHCuller, SHCullingTrainer,  # noqa: F401
                      SHCullingTrainerWrapper, cull_sh_bands)
