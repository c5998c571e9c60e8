"""Nested span tracing with wall-clock *and* simulated-clock timestamps
(reference: ``repro/obs/trace.py``).

One process-wide tracer, off by default.  When disabled, ``get_tracer()``
returns a shared :class:`NullTracer` whose every method is a no-op returning
shared singletons — instrumented hot paths pay an attribute lookup and a
call, never an allocation, a string format, or (critically) a host sync.

When enabled (``configure(path=...)``), spans buffer in memory as plain
dicts and are written once at ``close()`` as JSONL (one event per line; see
``repro_torch.obs.export`` for the schema, the Chrome-trace converter, and
the ``summarize``/``diff``/``check`` CLI).

No host sync on a step's path: attribute values that live on the card are
recorded through :meth:`Span.lazy`, which stores the 0-d tensor unresolved.
All pending lazies are resolved at ``close()`` (or an explicit
``resolve_pending()``) in ONE device→host copy per device, a
``torch.stack`` of them — instrumentation never adds per-span copies.

The simulated clock is cooperative: runners publish their sim time via
``tracer.sim_time`` (see ``repro_torch.obs.record.RunRecorder``); every
span stamps ``sim_t0``/``sim_dur`` from it alongside the wall clock.
"""

from __future__ import annotations

import json
import random
import sys
import time

from repro_torch.obs.metrics import Metrics, NULL_METRICS

SCHEMA_VERSION = 1


def client_keep(seed: int, rnd: int, cid: int, rate: float) -> bool:
    """Deterministic head-sampling decision for one client's spans in one
    round.  Keyed by ``(seed, round, client)`` so the same run config keeps
    the same clients — traces diff cleanly across reruns — while distinct
    rounds rotate through the cohort.  ``rate >= 1`` keeps everything;
    ``rate <= 0`` keeps nothing (tail-keep on alert still applies; see
    ``repro_torch.obs.record``)."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    mixed = (int(seed) * 1000003 + int(rnd)) * 1000003 + int(cid)
    return random.Random(mixed).random() < rate


class Lazy:
    """A deferred (possibly on-device) scalar attribute value.

    Holds the raw value until the tracer's single batched resolve turns it
    into a host float.  Serializes as its resolved value.
    """

    __slots__ = ("value", "resolved")

    def __init__(self, value):
        self.value = value
        self.resolved = False

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Lazy({self.value!r}, resolved={self.resolved})"


def _json_default(o):
    if isinstance(o, Lazy):
        o = o.value
    try:
        return float(o)
    except (TypeError, ValueError):
        return repr(o)


class Span:
    """One timed region.  Usable as a context manager or via begin()/end()."""

    __slots__ = ("name", "kind", "sid", "parent", "attrs", "_tr", "_t0",
                 "_sim0", "_done")

    def __init__(self, tracer, name, kind, sid, parent, attrs):
        self._tr = tracer
        self.name = name
        self.kind = kind
        self.sid = sid
        self.parent = parent
        self.attrs = attrs
        self._t0 = tracer._now()
        self._sim0 = tracer.sim_time
        self._done = False

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def lazy(self, key, value) -> "Span":
        """Record a device scalar without forcing a host sync (see module
        docstring); resolved in one batch at close()."""
        lz = Lazy(value)
        self.attrs[key] = lz
        self._tr._lazies.append(lz)
        return self

    def end(self, **attrs) -> None:
        if self._done:
            return
        self._done = True
        if attrs:
            self.attrs.update(attrs)
        tr = self._tr
        if tr._stack and tr._stack[-1] == self.sid:
            tr._stack.pop()
        elif self.sid in tr._stack:
            tr._stack.remove(self.sid)
        tr._emit({
            "type": "span", "id": self.sid, "parent": self.parent,
            "name": self.name, "kind": self.kind,
            "t0": self._t0, "dur": tr._now() - self._t0,
            "sim_t0": self._sim0, "sim_dur": tr.sim_time - self._sim0,
            "attrs": self.attrs})

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class Tracer:
    """Buffering tracer: spans/events in memory, one JSONL write at close."""

    enabled = True

    def __init__(self, path: str | None = None, meta: dict | None = None,
                 client_sample: float | None = None, sample_seed: int = 0):
        self.path = path
        self.sim_time = 0.0
        self.metrics = Metrics()
        # cohort-scale sampling knobs (consumed by record.RunRecorder):
        # None/1.0 = keep every client span; (0,1) = head-sample by
        # client_keep(sample_seed, rnd, cid, rate) with tail-keep on alert.
        self.client_sample = client_sample
        self.sample_seed = sample_seed
        # compile accounting (obs.profile): nvcc builds, graph captures
        self.profile = True
        # live telemetry plane (obs.live.LiveServer) when attached
        self.live = None
        self._t_origin = time.perf_counter()
        self._events: list[dict] = [{
            "type": "meta", "schema": SCHEMA_VERSION,
            "t_epoch": time.time(), "meta": dict(meta or {})}]
        self._stack: list[int] = []
        self._next_id = 0
        self._lazies: list[Lazy] = []
        self._subs: list = []

    def _now(self) -> float:
        return time.perf_counter() - self._t_origin

    # ---- live event stream -------------------------------------------------

    def subscribe(self, fn) -> None:
        """Register a live-stream consumer called with every span/event dict
        the moment it lands in the buffer (spans arrive at *end*).  Consumers
        may emit further events through the tracer (``obs.health`` emits
        ``alert`` events this way); they must tolerate — and not re-process —
        their own emissions."""
        self._subs.append(fn)

    def _emit(self, ev: dict) -> None:
        self._events.append(ev)
        for fn in self._subs:
            fn(ev)

    # ---- event-window editing (trace sampling) -----------------------------

    def mark(self) -> int:
        """Bookmark the current end of the event buffer.  Pair with
        :meth:`window`/:meth:`replace_window` to prune a bounded region
        (one round's client spans) off the hot path at a round boundary."""
        return len(self._events)

    def window(self, mark: int) -> list[dict]:
        """Events emitted since ``mark`` (the pruning candidates)."""
        return self._events[mark:]

    def replace_window(self, mark: int, events: list[dict]) -> None:
        """Replace everything after ``mark`` with ``events``.  Subscribers
        are NOT re-notified: they already saw the originals at emission time
        (the health monitor and live server deliberately observe the
        *unsampled* stream; only the persisted buffer is thinned)."""
        self._events[mark:] = events

    def begin(self, name: str, kind: str = "span", **attrs) -> Span:
        sid = self._next_id
        self._next_id += 1
        parent = self._stack[-1] if self._stack else None
        self._stack.append(sid)
        return Span(self, name, kind, sid, parent, attrs)

    def span(self, name: str, kind: str = "span", **attrs) -> Span:
        """Alias of begin(); Span is its own context manager."""
        return self.begin(name, kind, **attrs)

    def event(self, name: str, sim_t: float | None = None, **attrs) -> dict:
        ev = {"type": "event", "name": name, "t": self._now(),
              "sim_t": self.sim_time if sim_t is None else sim_t,
              "attrs": attrs}
        self._emit(ev)
        return ev

    def point_span(self, name: str, kind: str = "span", dur: float = 0.0,
                   **attrs) -> dict:
        """Record an already-finished region as a complete span, parented
        under the innermost *open* span.  Used by ``obs.profile``'s compile
        spans (a kernel build, a CUDA-graph capture), which are timed where
        they run and recorded after: parenting under the open round/dispatch
        span is what attributes the compile to the round that triggered
        it."""
        sid = self._next_id
        self._next_id += 1
        now = self._now()
        ev = {"type": "span", "id": sid,
              "parent": self._stack[-1] if self._stack else None,
              "name": name, "kind": kind,
              "t0": max(now - dur, 0.0), "dur": dur,
              "sim_t0": self.sim_time, "sim_dur": 0.0, "attrs": attrs}
        self._emit(ev)
        return ev

    def resolve_pending(self) -> int:
        """Resolve every Lazy attribute: the tensors of each device in ONE
        ``torch.stack(...).cpu()``, anything else by ``float``."""
        pend = [lz for lz in self._lazies if not lz.resolved]
        self._lazies = []
        if not pend:
            return 0
        vals = [lz.value for lz in pend]
        torch = sys.modules.get("torch")    # no tensor exists without it
        if torch is not None:
            by_dev: dict = {}
            for i, v in enumerate(vals):
                if isinstance(v, torch.Tensor) and v.numel() == 1:
                    by_dev.setdefault(v.device, []).append(i)
            for idx in by_dev.values():
                host = torch.stack([vals[i].detach().reshape(()).double()
                                    for i in idx]).cpu().tolist()
                for i, v in zip(idx, host):
                    vals[i] = v
        for lz, v in zip(pend, vals):
            try:
                lz.value = float(v)
            except (TypeError, ValueError, RuntimeError):
                lz.value = repr(v)
            lz.resolved = True
        return len(pend)

    def events(self) -> list[dict]:
        return self._events

    def close(self) -> list[dict]:
        """Resolve lazies, flush metrics into the event list, write JSONL
        (when a path was configured), and disable this tracer."""
        if not self.enabled:
            return self._events
        self.resolve_pending()
        self._events.extend(self.metrics.events())
        self.enabled = False
        if self.path:
            with open(self.path, "w") as f:
                for ev in self._events:
                    f.write(json.dumps(ev, default=_json_default) + "\n")
        return self._events


class _NullSpan:
    """Shared do-nothing span: the disabled hot path allocates nothing."""

    __slots__ = ()
    attrs: dict = {}

    def set(self, **attrs):
        return self

    def lazy(self, key, value):
        return self

    def end(self, **attrs):
        return None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


NULL_SPAN = _NullSpan()


class NullTracer:
    """Process-wide no-op tracer installed when tracing is disabled."""

    enabled = False
    path = None
    sim_time = 0.0
    metrics = NULL_METRICS
    client_sample = None
    sample_seed = 0
    profile = False
    live = None

    def begin(self, name, kind="span", **attrs):
        return NULL_SPAN

    span = begin

    def event(self, name, sim_t=None, **attrs):
        return None

    def point_span(self, name, kind="span", dur=0.0, **attrs):
        return None

    def subscribe(self, fn):
        return None

    def resolve_pending(self):
        return 0

    def events(self):
        return []

    def close(self):
        return []


NULL_TRACER = NullTracer()
_TRACER: Tracer | NullTracer = NULL_TRACER


def configure(path: str | None = None, enabled: bool = True,
              meta: dict | None = None, health: bool = True,
              profile: bool = True, client_sample: float | None = None,
              sample_seed: int = 0) -> Tracer | NullTracer:
    """Install the process tracer.  ``enabled=False`` (or ``disable()``)
    restores the shared no-op tracer.

    By default an enabled tracer also gets the *active* observability layer:
    ``health=True`` subscribes the streaming health detectors (structured
    ``alert`` events — see ``repro_torch.obs.health``), ``profile=True``
    records compile accounting: a ``compile`` span for each kernel library
    ``nvcc`` builds and for each CUDA-graph capture, attributed to the open
    round/dispatch span (see ``repro_torch.obs.profile``).

    ``client_sample`` in (0, 1) head-samples per-client spans at round
    boundaries (deterministic by ``(sample_seed, round, client)``, tail-keep
    on alert, cohort rollup sketches preserved — see
    ``repro_torch.obs.record``)."""
    global _TRACER
    _TRACER = Tracer(path=path, meta=meta, client_sample=client_sample,
                     sample_seed=sample_seed) if enabled else NULL_TRACER
    if enabled:
        _TRACER.profile = profile
        if health:
            from repro_torch.obs import health as _health
            _health.attach(_TRACER)
    return _TRACER


def disable() -> NullTracer:
    global _TRACER
    _TRACER = NULL_TRACER
    return _TRACER


def get_tracer() -> Tracer | NullTracer:
    return _TRACER


def close() -> list[dict]:
    """Close the active tracer (flush + write) and restore the null one."""
    global _TRACER
    evs = _TRACER.close()
    _TRACER = NULL_TRACER
    return evs


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL_CTX = _NullCtx()


def annotate(name: str):
    """A ``torch.profiler.record_function`` range around a dispatch site
    (cohort dispatch, prefill, decode) while tracing is enabled, so a
    profiler trace shows it; a shared no-op context when tracing is
    disabled or torch is absent."""
    if not _TRACER.enabled:
        return _NULL_CTX
    try:
        from torch.profiler import record_function
    except ImportError:
        return _NULL_CTX
    return record_function(name)
