"""Layer-pattern planner (reference: ``repro/models/plan.py``).

The JAX package stacks a repeated block pattern and scans over it: the
smallest period that tiles the pattern, repeated, then an unrolled tail
(Gemma3: ``(5 × local, attn) × 4 + 2 × local``; Zamba2: ``(5 × mamba,
shared_attn) × 6 + 2 × mamba``).  The port runs a plain Python loop over
per-layer trees and stacks nothing; it keeps ``build_plan`` so that
``repro_torch.bridge`` knows where the reference put each layer
(``dec.body.p<j>``, ``dec.tail.t<i>``).  The reference's ``stack_meta`` is
its scan's machinery and is not carried over."""

from __future__ import annotations

import dataclasses

SHARED = "shared_attn"      # one block's params reused at every occurrence


@dataclasses.dataclass(frozen=True)
class Plan:
    period: tuple[str, ...]     # block kinds inside the scanned body
    repeats: int                # number of scan iterations (0 → no scan)
    tail: tuple[str, ...]       # unrolled trailing blocks

    @property
    def n_layers(self) -> int:
        return len(self.period) * self.repeats + len(self.tail)


def build_plan(pattern: tuple[str, ...]) -> Plan:
    n = len(pattern)
    for p in range(1, n + 1):
        repeats = n // p
        if repeats < 2:
            break
        period = pattern[:p]
        if all(pattern[i] == period[i % p] for i in range(repeats * p)) \
                and pattern[repeats * p:] == period[:n - repeats * p]:
            return Plan(period, repeats, pattern[repeats * p:])
    return Plan((), 0, tuple(pattern))
