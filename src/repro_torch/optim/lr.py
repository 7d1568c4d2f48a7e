"""Learning-rate schedules. A schedule maps the step (a Python int) to the
learning rate, a Python float holding a float32 value, as the reference's
``repro/optim/lr.py`` returns a float32 array."""
from __future__ import annotations

import numpy as np

__all__ = ["constant"]


def constant(lr: float):
    value = float(np.float32(lr))
    return lambda step: value
