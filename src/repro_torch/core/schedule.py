"""Rank-budget schedule (reference: ``repro/core/schedule.py``; paper Eq.
13) — cubic decay from the initial budget to the target budget between
warm-up and final-stabilization rounds."""

from __future__ import annotations

import numpy as np


def rank_budget(t: int, *, b0: int, b_target: int, t_warmup: int,
                t_final: int, total_rounds: int) -> int:
    """Total number of ranks kept across all modules at round ``t``.

    b(t) = b0                                   0 ≤ t < t_w
         = b_T + (b0 − b_T)·(1 − (t−t_w)/(T−t_w−t_f))³    t_w ≤ t < T − t_f
         = b_T                                  otherwise
    """
    if t < t_warmup:
        return int(b0)
    horizon = total_rounds - t_warmup - t_final
    if horizon <= 0 or t >= total_rounds - t_final:
        return int(b_target)
    prog = (t - t_warmup) / horizon
    prog = min(max(prog, 0.0), 1.0)
    b = b_target + (b0 - b_target) * (1.0 - prog) ** 3
    return int(np.floor(b))
