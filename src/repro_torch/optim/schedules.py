"""LR schedules (reference: ``repro/optim/schedules.py``): the linear decay
across FL rounds that the paper uses, plus WSD (warmup-stable-decay, MiniCPM
[arXiv:2404.06395]), cosine and constant.  Steps are host integers; each
rate is computed in float32 as the reference computes it."""

from __future__ import annotations

import numpy as np

f32 = np.float32


def constant(lr: float):
    return lambda step: f32(lr)


def linear_decay(lr: float, total_steps: int, floor: float = 0.0):
    def f(step):
        frac = np.clip(f32(step) / f32(max(total_steps, 1)), f32(0), f32(1))
        return f32(f32(lr) * (f32(1) - frac) + f32(floor) * frac)
    return f


def cosine(lr: float, total_steps: int, warmup: int = 0, floor: float = 0.0):
    def f(step):
        s = f32(step)
        if s < warmup:
            return f32(f32(lr) * np.clip(s / f32(max(warmup, 1)), f32(0),
                                         f32(1)))
        prog = np.clip((s - f32(warmup)) / f32(max(total_steps - warmup, 1)),
                       f32(0), f32(1))
        return f32(f32(floor) + f32(0.5) * f32(lr - floor)
                   * (f32(1) + np.cos(f32(np.pi) * prog)))
    return f


def wsd(lr: float, total_steps: int, warmup_frac: float = 0.05,
        decay_frac: float = 0.1, floor_frac: float = 0.1):
    """Warmup → stable → decay (MiniCPM's schedule)."""
    warmup = max(int(total_steps * warmup_frac), 1)
    decay_start = int(total_steps * (1 - decay_frac))

    def f(step):
        s = f32(step)
        if s < warmup:
            return f32(f32(lr) * np.clip(s / f32(warmup), f32(0), f32(1)))
        if s < decay_start:
            return f32(lr)
        prog = np.clip((s - f32(decay_start))
                       / f32(max(total_steps - decay_start, 1)),
                       f32(0), f32(1))
        return f32(f32(lr) * (f32(1) - f32(1 - floor_frac) * prog))
    return f
