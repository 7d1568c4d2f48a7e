"""Learning-rate schedules + the paper's configuration rule (Smith 2017).

A schedule maps the step (a Python int) to the learning rate, a Python float
holding a float32 value, as the reference's ``repro/optim/lr.py`` returns a
float32 array. The reference computes its schedules in float32 on the
device, so they are computed here on the host in ``np.float32``, one
operation at a time and in the reference's order; float64 would differ.
``np.cos`` and XLA's ``cos`` may differ by one float32 ulp.

The paper sets a constant learning rate via an LR range test: geometrically
sweep the LR, evaluate the loss after one iteration, locate the two "knees"
(where loss starts decreasing significantly / starts increasing again) and
take their geometric mean (paper App. G, Fig. 9).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["constant", "cosine", "warmup_cosine", "smith_lr_range_test"]

f32 = np.float32


def constant(lr: float):
    value = float(f32(lr))
    return lambda step: value


def _cosine_f32(lr: float, total_steps: int, final_frac: float, step: int) -> np.float32:
    t = min(max(f32(step) / f32(total_steps), f32(0.0)), f32(1.0))
    wave = f32(1.0) + np.cos(f32(np.pi) * t)
    # (1 - final_frac) * 0.5 is a Python product, rounded to float32 once.
    return f32(lr) * (f32(final_frac) + f32((1 - final_frac) * 0.5) * wave)


def cosine(lr: float, total_steps: int, final_frac: float = 0.1):
    return lambda step: float(_cosine_f32(lr, total_steps, final_frac, step))


def warmup_cosine(lr: float, warmup: int, total_steps: int, final_frac: float = 0.1):
    total = max(total_steps - warmup, 1)

    def sched(step):
        s = f32(step)
        if s < warmup:
            return float(f32(lr) * s / f32(max(warmup, 1)))
        return float(_cosine_f32(lr, total, final_frac, step - warmup))
    return sched


def smith_lr_range_test(
    one_step_loss: Callable[[float], float],
    lr_min: float = 1e-6,
    lr_max: float = 10.0,
    n_points: int = 25,
    drop_frac: float = 0.05,
) -> tuple[float, np.ndarray, np.ndarray]:
    """The paper's LR selection rule.

    ``one_step_loss(lr)`` is the training loss after ONE iteration from the
    common initialization; ``drop_frac`` is the relative decrease/increase
    threshold defining the knees. Returns (selected_lr, lrs, losses).
    """
    lrs = np.geomspace(lr_min, lr_max, n_points)
    losses = np.array([float(one_step_loss(float(lr))) for lr in lrs])
    base = losses[0]
    finite = np.isfinite(losses)
    # knee 1: first lr where loss drops significantly below the small-lr level
    dec = np.nonzero(finite & (losses < base * (1 - drop_frac)))[0]
    if len(dec) == 0:
        return float(lrs[len(lrs) // 2]), lrs, losses
    k1 = dec[0]
    # knee 2: first lr after k1 where loss rises back above the minimum
    lmin = np.nanmin(np.where(finite, losses, np.nan))
    inc = [i for i in range(k1 + 1, n_points)
           if (not finite[i]) or losses[i] > min(base, lmin * (1 + drop_frac) + drop_frac * abs(base))]
    k2 = inc[0] if inc else n_points - 1
    lr = float(np.sqrt(lrs[k1] * lrs[k2]))  # geometric mean of the knees
    return lr, lrs, losses
