from .abc import AbstractQuantizer, QuantizeTrainerWrapper  # noqa: F401
from .exclude_zeros import ExcludeZeroSHQuantizer  # noqa: F401
from .quantizer import VectorQuantizer, compute_uint_dtype  # noqa: F401
from .wrapper import VectorQuantizeTrainer, VectorQuantizeTrainerWrapper  # noqa: F401
