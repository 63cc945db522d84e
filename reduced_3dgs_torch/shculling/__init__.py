from .gaussian_model import VariableSHGaussianModel  # noqa: F401
