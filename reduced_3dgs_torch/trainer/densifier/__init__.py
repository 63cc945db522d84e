from .abc import (AbstractDensifier, DensificationInstruction,  # noqa: F401
                  DensificationTrainer, DensifierWrapper, NoopDensifier)
