"""Mergeable quantile sketches + seedable reservoir sampling, stdlib-only.

Population-scale telemetry cannot keep per-client samples: a 1000-client
round observing one latency per client per round is 10⁶ floats over a
thousand rounds, and per-client label sets multiply the registry.  This
module provides the two bounded-memory summaries the live telemetry plane
is built on:

:class:`Sketch`
    A DDSketch-style log-bucketed quantile sketch [Masson et al., VLDB'19].
    Values map to geometric buckets ``key = ceil(log_γ |v|)`` with
    ``γ = (1+α)/(1−α)``, so every value in a bucket is within relative
    error ``α`` of the bucket midpoint.  Guarantees, for any stream:

    * **relative-error bound** — ``|quantile(q) − exact_q| ≤ α·|exact_q|``
      where ``exact_q`` is the nearest-rank quantile of the full stream
      (rank convention identical to the historical ``Histogram`` sampler:
      ``rank = round(q·(n−1))``), up to float rounding at bucket edges;
    * **mergeability** — ``merge`` adds bucket counts, so
      ``sketch(a).merge(sketch(b))`` has *bit-identical state* to a sketch
      fed the concatenated stream, in any association order.  Per-client →
      per-cohort → per-run rollups therefore compose without widening the
      error bound.

    Memory is O(#buckets) = O(log(vmax/vmin)/α); a ``max_buckets`` guard
    (generous by default) collapses the smallest-magnitude buckets if a
    stream's dynamic range is pathological — only the extreme low tail
    loses precision, and two sketches collapse identically under merge
    order because collapse is re-derived from the combined keys.

:class:`Reservoir`
    Vitter's Algorithm R: a uniform sample of the whole stream in a
    fixed-size buffer, seeded so runs are reproducible.  Replaces the old
    first-``N`` histogram buffer, whose "sample" was just warmup.  Used
    for exemplars (concrete values behind a sketch quantile) and for any
    consumer that wants raw observations rather than bucket counts.

Serialization (``to_dict``/``from_dict``) is plain-JSON-safe so sketches
ride the JSONL trace inside rollup spans and metric events.

Port of ``repro/obs/sketch.py``, the same code under the
``repro_torch.obs`` package name.
"""

from __future__ import annotations

import math
import random

DEFAULT_REL_ERR = 0.01
DEFAULT_MAX_BUCKETS = 4096


class Sketch:
    """Log-bucketed mergeable quantile sketch with relative-error bound."""

    __slots__ = ("rel_err", "gamma", "_lg", "pos", "neg", "zero",
                 "count", "total", "vmin", "vmax", "max_buckets")

    def __init__(self, rel_err: float = DEFAULT_REL_ERR,
                 max_buckets: int = DEFAULT_MAX_BUCKETS):
        if not 0.0 < rel_err < 1.0:
            raise ValueError(f"rel_err must be in (0, 1), got {rel_err}")
        self.rel_err = rel_err
        self.gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self._lg = math.log(self.gamma)
        self.pos: dict[int, int] = {}
        self.neg: dict[int, int] = {}
        self.zero = 0
        self.count = 0
        self.total = 0.0
        self.vmin: float | None = None
        self.vmax: float | None = None
        self.max_buckets = max_buckets

    # ---- ingest ------------------------------------------------------------

    def _key(self, mag: float) -> int:
        return math.ceil(math.log(mag) / self._lg)

    def add(self, v: float, n: int = 1) -> None:
        v = float(v)
        if v != v or v in (float("inf"), float("-inf")):
            return                            # non-finite: not representable
        if v > 0.0:
            k = self._key(v)
            self.pos[k] = self.pos.get(k, 0) + n
        elif v < 0.0:
            k = self._key(-v)
            self.neg[k] = self.neg.get(k, 0) + n
        else:
            self.zero += n
        self.count += n
        self.total += v * n
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        if len(self.pos) + len(self.neg) > self.max_buckets:
            self._collapse()

    def _collapse(self) -> None:
        """Fold the smallest-magnitude buckets together until under the cap.
        Deterministic given the key set, so merge order cannot produce
        diverging collapsed states."""
        while len(self.pos) + len(self.neg) > self.max_buckets:
            side = self.pos if len(self.pos) >= len(self.neg) else self.neg
            ks = sorted(side)
            if len(ks) < 2:
                break
            lo, nxt = ks[0], ks[1]
            side[nxt] += side.pop(lo)

    def merge(self, other: "Sketch") -> "Sketch":
        """Fold ``other`` into this sketch (associative + commutative on the
        bucket state; see module docstring).  Requires equal ``rel_err``."""
        if abs(other.gamma - self.gamma) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with different rel_err "
                f"({self.rel_err} vs {other.rel_err})")
        for k, n in other.pos.items():
            self.pos[k] = self.pos.get(k, 0) + n
        for k, n in other.neg.items():
            self.neg[k] = self.neg.get(k, 0) + n
        self.zero += other.zero
        self.count += other.count
        self.total += other.total
        if other.vmin is not None:
            self.vmin = other.vmin if self.vmin is None \
                else min(self.vmin, other.vmin)
        if other.vmax is not None:
            self.vmax = other.vmax if self.vmax is None \
                else max(self.vmax, other.vmax)
        if len(self.pos) + len(self.neg) > self.max_buckets:
            self._collapse()
        return self

    # ---- queries -----------------------------------------------------------

    def _mid(self, key: int) -> float:
        # bucket (γ^(k−1), γ^k]; midpoint 2γ^k/(γ+1) is within rel_err of
        # every value in the bucket
        return 2.0 * self.gamma ** key / (self.gamma + 1.0)

    def quantile(self, q: float) -> float | None:
        """Nearest-rank quantile estimate (None when empty): the value at
        ``rank = round(q·(count−1))``, within ``rel_err`` relative error."""
        if self.count == 0:
            return None
        rank = int(round(q * (self.count - 1)))
        rank = max(0, min(self.count - 1, rank))
        seen = 0
        # ascending value order: most-negative … zero … most-positive
        for k in sorted(self.neg, reverse=True):
            seen += self.neg[k]
            if rank < seen:
                return -self._mid(k)
        seen += self.zero
        if rank < seen:
            return 0.0
        for k in sorted(self.pos):
            seen += self.pos[k]
            if rank < seen:
                return self._mid(k)
        return self.vmax                      # numerically unreachable guard

    def summary(self) -> dict:
        out = {"count": self.count, "sum": self.total,
               "min": self.vmin, "max": self.vmax}
        if self.count:
            for q, tag in ((0.5, "p50"), (0.9, "p90"), (0.95, "p95"),
                           (0.99, "p99")):
                out[tag] = self.quantile(q)
        return out

    # ---- serialization (JSON-safe; rides the JSONL trace) ------------------

    def to_dict(self) -> dict:
        return {"rel_err": self.rel_err, "count": self.count,
                "sum": self.total, "min": self.vmin, "max": self.vmax,
                "zero": self.zero,
                "pos": {str(k): n for k, n in self.pos.items()},
                "neg": {str(k): n for k, n in self.neg.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "Sketch":
        sk = cls(rel_err=d.get("rel_err", DEFAULT_REL_ERR))
        sk.count = int(d.get("count", 0))
        sk.total = float(d.get("sum", 0.0))
        sk.vmin = d.get("min")
        sk.vmax = d.get("max")
        sk.zero = int(d.get("zero", 0))
        sk.pos = {int(k): int(n) for k, n in (d.get("pos") or {}).items()}
        sk.neg = {int(k): int(n) for k, n in (d.get("neg") or {}).items()}
        return sk

    def state(self) -> tuple:
        """Hashable snapshot of the mergeable state — what the associativity
        contract compares.  Bucket counts, zero count, and min/max merge
        bit-identically in any order; ``total`` is deliberately excluded
        (float addition is order-sensitive, so sums agree only to relative
        rounding, not bitwise — every quantile answer depends solely on the
        state captured here)."""
        return (self.count, self.zero, self.vmin, self.vmax,
                tuple(sorted(self.pos.items())),
                tuple(sorted(self.neg.items())))


class Reservoir:
    """Vitter's Algorithm R: seeded uniform sample of an unbounded stream."""

    __slots__ = ("cap", "n", "items", "_rng")

    def __init__(self, cap: int, seed: int = 0):
        if cap < 1:
            raise ValueError(f"cap must be >= 1, got {cap}")
        self.cap = cap
        self.n = 0                          # stream length seen so far
        self.items: list[float] = []
        self._rng = random.Random(seed)

    def add(self, v: float) -> None:
        self.n += 1
        if len(self.items) < self.cap:
            self.items.append(v)
        else:
            j = self._rng.randrange(self.n)
            if j < self.cap:
                self.items[j] = v

    def merge(self, other: "Reservoir") -> "Reservoir":
        """Approximate union sample: each slot draws from either source with
        probability proportional to its stream length.  Deterministic given
        this reservoir's rng state."""
        if other.n == 0:
            return self
        if self.n == 0:
            self.n = other.n
            self.items = list(other.items)
            while len(self.items) > self.cap:   # adopt within our own cap
                self.items.pop(self._rng.randrange(len(self.items)))
            return self
        total = self.n + other.n
        k = min(self.cap, len(self.items) + len(other.items))
        merged = []
        for _ in range(k):
            src = self if self._rng.random() < self.n / total else other
            merged.append(src.items[self._rng.randrange(len(src.items))])
        self.items = merged
        self.n = total
        return self

    def quantile(self, q: float) -> float | None:
        if not self.items:
            return None
        s = sorted(self.items)
        return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]
