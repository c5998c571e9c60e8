"""Optimizers and LR schedules (reference: ``repro/optim``)."""

from repro_torch.optim.optimizers import Optimizer, adam  # noqa: F401
from repro_torch.optim.schedules import linear_decay  # noqa: F401
