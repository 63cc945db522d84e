"""Learning-rate schedules (counterpart of reduced_3dgs_tpu/utils/schedule.py:
the vanilla-3DGS exponential log-lerp schedule that ``Trainer`` applies to
xyz)."""
from __future__ import annotations

import math


def get_expon_lr_func(lr_init: float, lr_final: float, lr_delay_steps: int = 0,
                      lr_delay_mult: float = 1.0, max_steps: int = 1000000):
    """step -> learning rate: log-linear from ``lr_init`` to ``lr_final``
    over ``max_steps``, scaled by a sine ramp from ``lr_delay_mult`` over the
    first ``lr_delay_steps``."""
    def helper(step):
        if lr_init == lr_final == 0.0:
            return 0.0
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
                0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
        else:
            delay_rate = 1.0
        t = min(max(step / max_steps, 0.0), 1.0)
        log_lerp = math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
        return delay_rate * log_lerp

    return helper
