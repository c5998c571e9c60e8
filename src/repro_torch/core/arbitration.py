"""FedArb (reference: ``repro/core/arbitration.py``; paper §IV-B2, Eq. 15):
server-side threshold arbitration.

    M_global[i] = True  iff  (1/|K|)·Σ_k M_k[i] > T_h

and the arbitrated mask is AND-ed with the previous global mask so ranks only
ever stay or decrease (§IV-C).  ``arbitrate_from_votes`` is the
aggregate-only form that secure aggregation uses (the server sees vote
sums only).  The FedARA-global ablation (``arbitrate_global``) is not ported
yet (ROADMAP.md queue 1 item 14).
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
    return IMP.unflatten(voted, layout, local_masks[0])


def arbitrate_from_votes(vote_sums: Any, n_reporting: int, threshold: float,
                         prev_global: Any | None = None) -> Any:
    """Aggregate-only FedArb: arbitration from *summed* one-hot votes.

    ``vote_sums`` is either a mask-structured tree of per-rank vote counts or
    the flat vector a secure-aggregation round decodes (layout then taken
    from ``prev_global``).  Equivalent to ``arbitrate(local_masks, ...)`` on
    the per-client mask lists whose elementwise sum is ``vote_sums`` — the
    invariant that lets the server allocate ranks without ever seeing an
    individual client's mask (the division mirrors ``np.mean``'s f32
    arithmetic so the two paths agree bit-for-bit at the threshold).
    """
    if n_reporting <= 0:
        return prev_global
    if isinstance(vote_sums, np.ndarray):
        flat = vote_sums.reshape(-1)
        if prev_global is None:
            raise ValueError("flat vote_sums needs prev_global for layout")
        _, layout = IMP.flat_concat(MK.to_np(prev_global))
    else:
        flat, layout = IMP.flat_concat(MK.to_np(vote_sums))
    frac = flat.astype(np.float32) / np.float32(n_reporting)
    voted = frac > threshold
    if prev_global is not None:
        prev_flat, _ = IMP.flat_concat(MK.to_np(prev_global))
        voted = np.logical_and(voted, prev_flat.astype(bool))
    return IMP.unflatten(voted, layout, prev_global if isinstance(
        vote_sums, np.ndarray) else vote_sums)
