"""Labeled counters / gauges / histograms, stdlib-only.

Instruments are registered per (name, sorted-label-set) pair, so
``m.counter("pipeline.up_bytes", codec="signsgd", stage="stage2")`` returns
the same accumulator on every call.  The registry lives on the process
tracer (``repro_torch.obs.trace``); when tracing is disabled every factory
returns a shared per-kind no-op instrument — zero allocation, zero
arithmetic on the hot path — whose ``value``/``summary()`` shape matches
the live instrument of the same kind, so disabled-tracing code paths can
never branch differently on instrument shape.

Histograms keep exact count/sum/min/max plus two bounded-memory stream
summaries from ``repro_torch.obs.sketch``:

* a mergeable DDSketch-style quantile sketch (relative-error bound
  ``sketch.DEFAULT_REL_ERR``) that ``quantile()``/``summary()`` read —
  p50/p95/p99 reflect the *whole* stream, not the first ``SAMPLE_CAP``
  warmup observations the old buffer kept;
* a seeded reservoir (Vitter's R, cap ``SAMPLE_CAP``) of exemplar values,
  deterministic per (name, labels) so runs are reproducible.

Label-cardinality cap: unbounded label *values* (``client=<id>`` over a
1000-client cohort) would blow up the registry and the exposition page.
Per (metric name, label key), at most ``LABEL_CARD_CAP`` distinct values
are tracked; further values collapse into one ``__overflow__`` series, so
aggregate sums stay exact while cardinality stays O(1) in cohort size.

Port of ``repro/obs/metrics.py``, the same code under the
``repro_torch.obs`` package name.
"""

from __future__ import annotations

import zlib

from repro_torch.obs.sketch import Reservoir, Sketch

SAMPLE_CAP = 4096
LABEL_CARD_CAP = 64
OVERFLOW_LABEL = "__overflow__"


def flat_key(name: str, labels: tuple) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    __slots__ = ("name", "labels", "value")
    kind = "counter"

    def __init__(self, name, labels):
        self.name, self.labels = name, labels
        self.value = 0

    def inc(self, n=1):
        self.value += n


class Gauge:
    __slots__ = ("name", "labels", "value")
    kind = "gauge"

    def __init__(self, name, labels):
        self.name, self.labels = name, labels
        self.value = 0.0

    def set(self, v):
        self.value = v


class Histogram:
    __slots__ = ("name", "labels", "sketch", "reservoir")
    kind = "histogram"

    def __init__(self, name, labels):
        self.name, self.labels = name, labels
        self.sketch = Sketch()
        # deterministic per-series seed: reproducible exemplars per run
        self.reservoir = Reservoir(
            SAMPLE_CAP, seed=zlib.crc32(flat_key(name, labels).encode()))

    def observe(self, v):
        v = float(v)
        self.sketch.add(v)
        self.reservoir.add(v)

    # exact scalar accumulators stay exact in the sketch
    @property
    def count(self):
        return self.sketch.count

    @property
    def total(self):
        return self.sketch.total

    @property
    def vmin(self):
        return self.sketch.vmin

    @property
    def vmax(self):
        return self.sketch.vmax

    def quantile(self, q: float) -> float | None:
        """Whole-stream quantile from the sketch, within its relative-error
        bound (None when empty)."""
        return self.sketch.quantile(q)

    def summary(self) -> dict:
        return self.sketch.summary()

    @property
    def value(self):
        return self.summary()


class Metrics:
    enabled = True

    def __init__(self):
        self._data: dict[tuple, object] = {}
        # (metric name, label key) -> set of distinct label values seen
        self._label_values: dict[tuple, set] = {}

    def _cap_labels(self, name, labels) -> dict:
        for k, v in labels.items():
            vals = self._label_values.setdefault((name, k), set())
            if v in vals:
                continue
            if len(vals) >= LABEL_CARD_CAP:
                labels[k] = OVERFLOW_LABEL
            else:
                vals.add(v)
        return labels

    def _get(self, cls, name, labels):
        if labels:
            labels = self._cap_labels(name, labels)
        lk = tuple(sorted(labels.items()))
        key = (name, lk)
        inst = self._data.get(key)
        if inst is None:
            inst = self._data[key] = cls(name, lk)
        elif not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{inst.kind}, requested {cls.kind}")
        return inst

    def counter(self, name, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def instruments(self) -> list:
        """Live instruments in sorted registry order (for the exposition)."""
        return [inst for _, inst in sorted(self._data.items())]

    def snapshot(self) -> dict:
        """Flat ``name{label=v,...} -> value`` dict (histograms summarize)."""
        return {flat_key(name, lk): inst.value
                for (name, lk), inst in sorted(self._data.items())}

    def events(self) -> list[dict]:
        """Metric events for the JSONL trace (emitted once, at close).
        Histogram rows carry the full mergeable sketch so offline tooling
        can re-derive any quantile and merge across runs."""
        out = []
        for (name, lk), inst in sorted(self._data.items()):
            ev = {"type": "metric", "metric": inst.kind, "name": name,
                  "labels": dict(lk), "value": inst.value}
            if inst.kind == "histogram":
                ev["sketch"] = inst.sketch.to_dict()
            out.append(ev)
        return out


class _NullCounter:
    __slots__ = ()
    kind = "counter"
    value = 0

    def inc(self, n=1):
        return None


class _NullGauge:
    __slots__ = ()
    kind = "gauge"
    value = 0.0

    def set(self, v):
        return None


# shape-compatible with Histogram.summary() on an empty stream
_EMPTY_HIST_SUMMARY = {"count": 0, "sum": 0.0, "min": None, "max": None}


class _NullHistogram:
    __slots__ = ()
    kind = "histogram"
    count = 0
    total = 0.0
    vmin = None
    vmax = None

    def observe(self, v):
        return None

    def quantile(self, q):
        return None

    def summary(self):
        return dict(_EMPTY_HIST_SUMMARY)

    @property
    def value(self):
        return self.summary()


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()


class NullMetrics:
    enabled = False

    def counter(self, name, **labels):
        return _NULL_COUNTER

    def gauge(self, name, **labels):
        return _NULL_GAUGE

    def histogram(self, name, **labels):
        return _NULL_HISTOGRAM

    def snapshot(self):
        return {}

    def events(self):
        return []

    def instruments(self):
        return []


NULL_METRICS = NullMetrics()
