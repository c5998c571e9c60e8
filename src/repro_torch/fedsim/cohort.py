"""Per-client batch streams (reference: ``repro/fedsim/cohort.py``, only
``client_batch_rng``: the cohort runner itself is not ported yet)."""

from __future__ import annotations

import numpy as np


def client_batch_rng(seed: int, rnd: int, cid: int) -> np.random.Generator:
    """The per-(seed, round, client) batch-order stream the reference's
    runners share."""
    return np.random.default_rng(seed * 1000 + rnd * 97 + int(cid))
