"""LR schedules (reference: ``repro/optim/schedules.py``): the linear decay
across FL rounds that the paper uses.  Steps are host integers; the rate is
computed in float32 as the reference computes it."""

from __future__ import annotations

import numpy as np


def linear_decay(lr: float, total_steps: int, floor: float = 0.0):
    f32 = np.float32

    def f(step):
        frac = np.clip(f32(step) / f32(max(total_steps, 1)), f32(0), f32(1))
        return f32(f32(lr) * (f32(1) - frac) + f32(floor) * frac)
    return f
