"""Fixed-point modular field for secure-aggregation simulation (reference:
``repro/secagg/field.py``, a numpy copy).

Secure aggregation sums client vectors inside a finite field so that pairwise
masks (masking.py) cancel *exactly*: floating point cannot do that (masks of
magnitude 2³¹ would swamp an f32 payload), so the CommPru wire vector is
first clipped to ``±clip``, scaled by ``2^frac_bits``, rounded to integers,
and lifted into Z_{2^bits}.  All field arithmetic is exact integer arithmetic
mod 2^bits — the aggregate is bit-identical under any client permutation —
and ``decode_sum`` center-lifts the summed field element back to f32.

Headroom: the decoded sum is only faithful while
``n_clients · clip · 2^frac_bits`` stays below half the modulus; ``FieldSpec``
checks that bound so a mis-sized field fails loudly instead of wrapping.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    bits: int = 32            # field modulus is 2^bits (stored in uint64)
    frac_bits: int = 16       # fixed-point fractional bits (resolution 2^-16)
    clip: float = 8.0         # per-element clip applied before quantization

    def __post_init__(self):
        # 62 is the ceiling: the center-lift in decode_sum and the quantized
        # values must fit signed int64 (2^63 itself overflows the cast)
        if not 8 <= self.bits <= 62:
            raise ValueError(f"field bits must be in [8, 62], got {self.bits}")
        if self.frac_bits >= self.bits - 1:
            raise ValueError("frac_bits must leave integer headroom")

    @property
    def modulus(self) -> int:
        return 1 << self.bits

    @property
    def scale(self) -> float:
        return float(1 << self.frac_bits)

    @property
    def q_max(self) -> int:
        """Largest |quantized value| a single client can contribute."""
        return int(round(self.clip * self.scale))

    def max_clients(self) -> int:
        """How many clients can sum before the centered range overflows."""
        return max(0, (self.modulus // 2 - 1) // max(self.q_max, 1))

    def check_headroom(self, n_clients: int) -> None:
        if n_clients > self.max_clients():
            raise ValueError(
                f"field 2^{self.bits} with clip={self.clip}, "
                f"frac_bits={self.frac_bits} overflows beyond "
                f"{self.max_clients()} clients (asked for {n_clients})")

    # ---- element-wise codec ------------------------------------------------

    def encode(self, vec: np.ndarray) -> np.ndarray:
        """f32 vector → field elements (uint64, values < modulus)."""
        w = np.clip(np.asarray(vec, np.float64), -self.clip, self.clip)
        q = np.rint(w * self.scale).astype(np.int64)
        return np.mod(q, self.modulus).astype(np.uint64)

    def add(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Exact modular addition (commutative — order cannot matter)."""
        return np.mod(a.astype(np.uint64) + b.astype(np.uint64),
                      np.uint64(self.modulus))

    def sub(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        return np.mod(a.astype(np.uint64) - b.astype(np.uint64),
                      np.uint64(self.modulus))

    def neg(self, a: np.ndarray) -> np.ndarray:
        return np.mod(np.uint64(self.modulus) - a.astype(np.uint64),
                      np.uint64(self.modulus))

    def decode_sum(self, agg: np.ndarray) -> np.ndarray:
        """Field aggregate → f32 sum (center-lift then unscale)."""
        v = agg.astype(np.int64)
        half = self.modulus // 2
        v = np.where(v >= half, v - self.modulus, v)
        return (v.astype(np.float64) / self.scale).astype(np.float32)

    def wire_bytes(self, n_elements: int) -> int:
        """Exact payload bytes for ``n_elements`` field elements."""
        return (n_elements * self.bits + 7) // 8

    @property
    def resolution(self) -> float:
        """Per-element quantization step (half of it bounds the error)."""
        return 1.0 / self.scale


def sum_encoded(encoded: list[np.ndarray], spec: FieldSpec) -> np.ndarray:
    """Exact modular sum of per-client encodings (any order, same bits)."""
    if not encoded:
        return np.zeros((0,), np.uint64)
    acc = np.zeros_like(encoded[0])
    for e in encoded:
        acc = spec.add(acc, e)
    return acc
