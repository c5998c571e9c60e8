"""Functional Adam (reference: ``repro/optim/optimizers.py:adam``).

Same API as the reference: ``opt.init(params) -> state``,
``opt.update(grads, state, params) -> (updates, state)`` over trees of
tensors.  The moments are float32 tensors beside the parameters; the step
counter is a host integer in the state, so the schedule and the bias
corrections are worked out on the host in float32, as the reference's f32
arithmetic gives them, and no step reads the device.  The moments are
stored in float32 only: bf16/int8 storage is not ported yet (ROADMAP.md
queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.pytree import tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def adam(lr: float | Callable, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Adam with bias correction: ``u = -lr_t·(m/c1)/(sqrt(v/c2)+eps)``."""
    lr_fn = lr if callable(lr) else (lambda _: np.float32(lr))
    f32 = np.float32

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def init(params):
        return {"step": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = float(lr_fn(step))
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g.float().square(),
                      state["nu"], grads)
        c1 = float(f32(1) - f32(b1) ** f32(step))
        c2 = float(f32(1) - f32(b2) ** f32(step))

        def u(m, v, p=None):
            upd = -lr_t * (m / c1) / ((v / c2).sqrt() + eps)
            return upd if p is None else upd.to(p.dtype)

        upd = (tree_map(u, mu, nu) if params is None
               else tree_map(u, mu, nu, params))
        return upd, {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init, update)
