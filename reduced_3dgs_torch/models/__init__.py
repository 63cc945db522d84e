from . import packed_sh, ply  # noqa: F401
from .gaussian_model import CameraTrainableGaussianModel, GaussianModel  # noqa: F401
