"""Optimizers and LR schedules (reference: ``repro/optim``)."""

from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adam, state_nbytes)
from repro_torch.optim.schedules import linear_decay  # noqa: F401
