"""Pairwise / self masks and Shamir-share *accounting* (Bonawitz et al. '17;
reference: ``repro/secagg/masking.py``, a numpy copy).

No real cryptography runs here — the simulation replaces the DH key
agreement with a deterministic seeded PRG per (round, pair), which preserves
the two properties the systems questions depend on:

  cancellation   client i adds +PRG(s_ij), client j adds −PRG(s_ij); the pair
                 vanishes from the field sum iff both masked inputs arrive,
  recoverability the server can re-expand a dropped client's pairwise masks
                 (resp. a survivor's self mask) once it holds ≥ t Shamir
                 shares of the corresponding seed — we account the shares'
                 bytes and reconstruct the mask from the seed directly.

Byte costs use the sizes a faithful implementation would ship: 32-byte
public keys / seeds and 33-byte Shamir shares (secret + x-coordinate).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.secagg.field import FieldSpec

KEY_BYTES = 32            # simulated DH public key (two per client: c, s)
SEED_BYTES = 32           # per-pair / self-mask PRG seed
SHARE_BYTES = SEED_BYTES + 1   # Shamir share: secret-sized payload + x coord

_PAIR_TAG, _SELF_TAG = 0x9E37, 0x85EB


def _prg(*material: int) -> np.random.Generator:
    """Deterministic PRG stream from integer seed material (Philox-backed
    stand-in for AES-CTR expansion of an agreed secret)."""
    return np.random.default_rng([int(m) & 0x7FFFFFFF for m in material])


def pair_mask(round_seed: int, i: int, j: int, n: int,
              spec: FieldSpec) -> np.ndarray:
    """The shared pairwise mask for clients (i, j) — symmetric in (i, j).

    Client ``min(i,j)`` adds it, client ``max(i,j)`` subtracts it, so the
    full-cohort field sum telescopes to zero.
    """
    lo, hi = (i, j) if i < j else (j, i)
    gen = _prg(_PAIR_TAG, round_seed, lo, hi)
    return gen.integers(0, spec.modulus, size=n, dtype=np.uint64)


def self_mask(round_seed: int, i: int, n: int, spec: FieldSpec) -> np.ndarray:
    """Client i's self mask b_i (double-masking: protects x_i if the server
    learns pairwise secrets of a client it wrongly believes dropped)."""
    gen = _prg(_SELF_TAG, round_seed, i)
    return gen.integers(0, spec.modulus, size=n, dtype=np.uint64)


def mask_input(wire_enc: np.ndarray, round_seed: int, cid: int,
               participants: list[int], spec: FieldSpec) -> np.ndarray:
    """y_i = x_i + b_i + Σ_{j>i} m_ij − Σ_{j<i} m_ij  (mod 2^bits)."""
    y = spec.add(wire_enc, self_mask(round_seed, cid, wire_enc.size, spec))
    for j in participants:
        if j == cid:
            continue
        m = pair_mask(round_seed, cid, j, wire_enc.size, spec)
        y = spec.add(y, m) if cid < j else spec.sub(y, m)
    return y


# ---------------------------------------------------------------------------
# Shamir-share accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShamirSpec:
    """t-of-n secret sharing bookkeeping (shares are never materialized —
    reconstruction is simulated by re-expanding the seed once the byte cost
    of collecting ≥ t shares has been charged)."""
    n: int
    threshold: int
    share_bytes: int = SHARE_BYTES

    def __post_init__(self):
        if not 1 <= self.threshold <= self.n:
            raise ValueError(f"threshold {self.threshold} ∉ [1, {self.n}]")

    def deal_bytes_per_client(self) -> int:
        """Phase 1 upload: one share of *two* secrets (self-mask seed and
        pairwise secret key) for each of the n−1 other participants."""
        return 2 * (self.n - 1) * self.share_bytes

    def unmask_bytes_per_survivor(self, n_survivors: int,
                                  n_dropped: int) -> int:
        """Phase 3 upload: the share this survivor holds of every *other*
        survivor's self-mask seed plus every dropped client's pairwise key."""
        return (max(n_survivors - 1, 0) + n_dropped) * self.share_bytes

    def recovery_bytes(self, n_survivors: int, n_dropped: int) -> int:
        """Extra phase-3 traffic attributable to dropout recovery."""
        return n_survivors * n_dropped * self.share_bytes

    def can_reconstruct(self, n_survivors: int) -> bool:
        return n_survivors >= self.threshold


def threshold_for(n_participants: int, frac: float) -> int:
    """Shamir threshold t = ⌈frac·n⌉, clamped to [1, n]."""
    return min(max(1, int(np.ceil(frac * n_participants))), n_participants)
