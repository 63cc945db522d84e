from .gaussian_model import (CameraTrainableVariableSHGaussianModel,  # noqa: F401
                             CameraTrainableVariableSHGsplat2DGSGaussianModel,
                             CameraTrainableVariableSHGsplatGaussianModel,
                             VariableSHGaussianModel, VariableSHGsplat2DGSGaussianModel,
                             VariableSHGsplatGaussianModel)
from .trainer import (BaseSHCullingTrainer, SHCuller, SHCullingTrainer,  # noqa: F401
                      SHCullingTrainerWrapper, cull_sh_bands)
