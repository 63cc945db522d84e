from .abc import AbstractTrainer, TrainerWrapper  # noqa: F401
from .base import BaseTrainer, Trainer  # noqa: F401
from .densifier import (AbstractDensifier, DensificationInstruction,  # noqa: F401
                        DensificationTrainer, DensifierWrapper, NoopDensifier)
