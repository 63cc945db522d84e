from . import ply  # noqa: F401
from .gaussian_model import GaussianModel  # noqa: F401
