"""FedArb (reference: ``repro/core/arbitration.py``; paper §IV-B2, Eq. 15):
server-side threshold arbitration.

    M_global[i] = True  iff  (1/|K|)·Σ_k M_k[i] > T_h

and the arbitrated mask is AND-ed with the previous global mask so ranks only
ever stay or decrease (§IV-C).  The aggregate-only form (vote sums under
secure aggregation) and the FedARA-global ablation are not ported yet
(ROADMAP.md queue 1 items 8 and 10).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from repro_torch.core import importance as IMP
from repro_torch.core import masks as MK


def arbitrate(local_masks: Sequence[Any], threshold: float,
              prev_global: Any | None = None) -> Any:
    """Threshold vote over client masks → new global mask tree."""
    if not local_masks:
        return prev_global
    flats = []
    layout = None
    for m in local_masks:
        f, layout = IMP.flat_concat(MK.to_np(m))
        flats.append(f.astype(np.float32))
    frac = np.mean(flats, axis=0)
    voted = frac > threshold
    if prev_global is not None:
        prev_flat, _ = IMP.flat_concat(MK.to_np(prev_global))
        voted = np.logical_and(voted, prev_flat.astype(bool))
    return IMP.unflatten(voted, layout)
