"""Optimizers and LR schedules (reference: ``repro/optim``)."""

from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adam, state_nbytes)
from repro_torch.optim.schedules import (  # noqa: F401
    constant, cosine, linear_decay, wsd)
