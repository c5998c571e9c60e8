"""Streaming health detectors over the trace/metric event stream.

Each detector consumes the same span/event dicts the tracer buffers (and
the JSONL trace serializes), so the detectors run identically in two modes:

  live     ``attach(tracer)`` subscribes a :class:`HealthMonitor` to the
           tracer's event stream; every triggered detector emits a
           structured ``alert`` event *into the same trace*, timestamped at
           the moment the triggering span/event landed.
  offline  ``scan(events)`` replays a JSONL trace through a fresh monitor
           and returns the alert payloads — by construction identical to
           the attrs of the ``alert`` events a live run would have emitted
           (the forensics contract: alerts are reconstructable from the
           JSONL alone, no live-process state).

Detectors (thresholds in :class:`Thresholds`):

  nan_loss         a round span reports a non-finite loss
  loss_divergence  round loss exceeds ``divergence_factor`` × best-so-far
  rank_collapse    dynamic rank allocation pruned a module to zero ranks
                   everywhere (from the recorder's ``rank_alloc`` events —
                   the paper's RankDet signal, surfaced the round it fires)
  ef_blowup        a client's error-feedback residual norm exceeds
                   ``ef_blowup_factor`` × the warmup-median baseline (the
                   codec is diverging instead of contracting)
  dropout_skew     a secagg round lost ≥ ``dropout_frac`` of its cohort
  secagg_abort     a secagg round aborted below the Shamir threshold
  straggler_skew   slowest client cost ≥ ``straggler_ratio`` × the round's
                   median client cost (from the runners' cost attrs)
  client_drift     cosine dispersion of the decoded client delta wires
                   exceeds ``drift_dispersion`` — the FeDeRA-style
                   heterogeneity signal the pipeline measures at aggregate

Stdlib-only, like the rest of the offline ``repro_torch.obs`` surface.

Port of ``repro/obs/health.py``, the same code under the
``repro_torch.obs`` package name.
"""

from __future__ import annotations

import dataclasses


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and x == x \
        and x not in (float("inf"), float("-inf"))


@dataclasses.dataclass
class Thresholds:
    divergence_factor: float = 2.5      # loss > factor × best finite loss
    divergence_min_rounds: int = 2      # rounds observed before it can fire
    ef_blowup_factor: float = 10.0      # ef_norm > factor × warmup median
    ef_warmup: int = 8                  # observations forming the baseline
    drift_dispersion: float = 0.9       # 1 − mean pairwise cosine of wires
    dropout_frac: float = 0.5           # secagg dropped/participants
    straggler_ratio: float = 8.0        # round cost max / median


class HealthMonitor:
    """Feed span/event dicts in stream order; collect structured alerts."""

    def __init__(self, thresholds: Thresholds | None = None):
        self.th = thresholds or Thresholds()
        self.alerts: list[dict] = []
        self._best_loss: float | None = None
        self._rounds_seen = 0
        self._dead: set[str] = set()
        self._ef_warm: list[float] = []
        self._ef_baseline: float | None = None
        self._ef_fired: set = set()

    # ---- one event ---------------------------------------------------------

    def feed(self, ev: dict) -> list[dict]:
        """Process one span/event dict; returns the alerts it triggered."""
        new: list[dict] = []
        t = ev.get("type")
        if t == "span":
            kind = ev.get("kind")
            if kind == "round":
                new.extend(self._round(ev.get("attrs") or {}))
            elif kind == "secagg":
                new.extend(self._secagg(ev.get("attrs") or {}))
        elif t == "event":
            name = ev.get("name")
            if name == "rank_alloc":
                new.extend(self._ranks(ev.get("attrs") or {}))
            elif name == "encode":
                new.extend(self._encode(ev.get("attrs") or {}))
            elif name == "drift":
                new.extend(self._drift(ev.get("attrs") or {}))
        self.alerts.extend(new)
        return new

    # ---- detectors ---------------------------------------------------------

    def _round(self, a: dict) -> list[dict]:
        out = []
        rnd, loss = a.get("rnd"), a.get("loss")
        if loss is not None and not _finite(loss):
            out.append({"alert": "nan_loss", "rnd": rnd, "loss": loss})
        elif _finite(loss):
            best = self._best_loss
            if best is not None and self._rounds_seen >= \
                    self.th.divergence_min_rounds \
                    and loss > self.th.divergence_factor * best:
                out.append({"alert": "loss_divergence", "rnd": rnd,
                            "loss": loss, "best": best})
            self._best_loss = loss if best is None else min(best, loss)
            self._rounds_seen += 1
        cm, cmed = a.get("cost_max"), a.get("cost_med")
        if _finite(cm) and _finite(cmed) and cmed > 0 \
                and cm / cmed >= self.th.straggler_ratio:
            out.append({"alert": "straggler_skew", "rnd": rnd,
                        "cost_max": cm, "cost_med": cmed,
                        "ratio": cm / cmed})
        return out

    def _secagg(self, a: dict) -> list[dict]:
        out = []
        rnd = a.get("rnd")
        n = a.get("participants") or 0
        dropped = a.get("n_dropped") or 0
        if a.get("aborted"):
            out.append({"alert": "secagg_abort", "rnd": rnd,
                        "n_dropped": dropped, "participants": n})
        elif n and dropped / n >= self.th.dropout_frac:
            out.append({"alert": "dropout_skew", "rnd": rnd,
                        "n_dropped": dropped, "participants": n,
                        "frac": dropped / n})
        return out

    def _ranks(self, a: dict) -> list[dict]:
        out = []
        rnd = a.get("rnd")
        for mod, info in sorted((a.get("modules") or {}).items()):
            live = info.get("live") if isinstance(info, dict) else info
            if live == 0 and mod not in self._dead:
                self._dead.add(mod)
                out.append({"alert": "rank_collapse", "rnd": rnd,
                            "module": mod,
                            "total": (info.get("total")
                                      if isinstance(info, dict) else None)})
            elif live:
                self._dead.discard(mod)     # revived (arbitration re-admits)
        return out

    def _encode(self, a: dict) -> list[dict]:
        ef = a.get("ef_norm")
        if not _finite(ef):
            return []
        if self._ef_baseline is None:
            self._ef_warm.append(ef)
            if len(self._ef_warm) >= self.th.ef_warmup:
                s = sorted(self._ef_warm)
                self._ef_baseline = s[len(s) // 2]
            return []
        cid = a.get("cid")
        if self._ef_baseline > 0 \
                and ef > self.th.ef_blowup_factor * self._ef_baseline \
                and cid not in self._ef_fired:
            self._ef_fired.add(cid)
            return [{"alert": "ef_blowup", "cid": cid, "ef_norm": ef,
                     "baseline": self._ef_baseline}]
        return []

    def _drift(self, a: dict) -> list[dict]:
        d = a.get("dispersion")
        if _finite(d) and d >= self.th.drift_dispersion:
            return [{"alert": "client_drift", "rnd": a.get("rnd"),
                     "dispersion": d, "n": a.get("n")}]
        return []


def attach(tracer, thresholds: Thresholds | None = None) -> HealthMonitor:
    """Subscribe a monitor to a live tracer; triggered detectors emit
    ``alert`` events into the same trace (attrs == the alert payload)."""
    mon = HealthMonitor(thresholds)

    def on_event(ev: dict) -> None:
        if ev.get("type") == "event" and ev.get("name") == "alert":
            return                                  # never re-process alerts
        for alert in mon.feed(ev):
            tracer.event("alert", **alert)

    tracer.subscribe(on_event)
    return mon


def scan(events: list[dict], thresholds: Thresholds | None = None
         ) -> list[dict]:
    """Offline replay: the alerts a live monitor would have raised, from the
    JSONL alone.  ``alert`` events already present are skipped, so scanning
    a live-monitored trace reproduces its embedded alerts exactly."""
    mon = HealthMonitor(thresholds)
    for ev in events:
        if ev.get("type") == "event" and ev.get("name") == "alert":
            continue
        mon.feed(ev)
    return mon.alerts


def embedded_alerts(events: list[dict]) -> list[dict]:
    """The ``alert`` events a live monitor wrote into a trace (attrs only)."""
    return [dict(e.get("attrs") or {}) for e in events
            if e.get("type") == "event" and e.get("name") == "alert"]
