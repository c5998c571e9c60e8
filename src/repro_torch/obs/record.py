"""RunRecorder: the runners' ``history`` dict as a *view over the trace*
(reference: ``repro/obs/record.py``).

Every federated runner (sequential oracle, cohort, fused, async — see
``federated/server.py`` and ``fedsim/runner.py``) records its history
through one object.  RunRecorder IS that
dict (it subclasses ``dict``, so every existing consumer — tests, benches,
launchers — reads the same keys), but each mutation flows through a method
that simultaneously emits the matching trace span or event.  One
bookkeeping path; ``repro_torch.obs.export.summarize`` reconstructs ``comm_gb``
/ ``sim_time_s`` / secagg phase bytes from the trace to exact equality.

Float-exactness contract: ``end_round`` accumulates
``comm_gb += (down + up) / 1e9`` per round, in round order, exactly like
the pre-refactor runners did — and stamps the same ints on the round span
— so summarize's event-order fold replays identical float additions.
The async runner's trailing in-flight bytes go through
``inflight_comm`` (an event, ordered after every round span).

Cohort-scale trace sampling: when the tracer was configured with
``client_sample`` in (0, 1), per-client spans are head-sampled at the
round boundary — deterministic by ``(sample_seed, round, client)`` — with
**tail-keep on alert** (any client that tripped a ``repro_torch.obs.health``
detector that round keeps its spans regardless of the head decision).
Every pruned round gains one ``cohort_rollup`` span carrying mergeable
sketches (``repro_torch.obs.sketch``) of the per-client distributions, so a
1000-client round emits O(sample + alerts) events while p50/p95/p99 stay
within the sketch's relative-error bound.  Round spans, alert events, and
the exact byte/sim-time counters are never pruned, so ``export.summarize``
/ ``check`` reconstruct ``comm_gb``/``sim_time_s`` to exact equality from
a sampled trace.  Pruning runs off the hot path (one pass over the round's
event window at ``end_round``); the health monitor and live server
subscribe to the tracer and therefore saw every event before it was
thinned.
"""

from __future__ import annotations

from repro_torch.obs import trace as _trace
from repro_torch.obs.sketch import Sketch

ROLLUP_KIND = "rollup"


class RunRecorder(dict):
    def __init__(self, runner: str, fc=None, extra_keys=()):
        super().__init__()
        self._tr = _trace.get_tracer()
        self._dead: set[str] = set()
        self._runner = runner
        self._rounds_total = None
        self._mark = None
        self._rnd = None
        self["rounds"] = []
        self["acc"] = []
        self["comm_gb"] = 0.0
        self["sim_time_s"] = 0.0
        for k in extra_keys:
            self[k] = []
        attrs = {"runner": runner}
        if fc is not None:
            attrs.update(rounds=fc.rounds,
                         clients_per_round=fc.clients_per_round,
                         codec=fc.codec, secagg=fc.secagg, seed=fc.seed)
            self._rounds_total = fc.rounds
        self._run_span = self._tr.begin("run", kind="run", **attrs)

    # ---- spans -------------------------------------------------------------

    def begin_round(self, rnd: int, phase: str = "fed"):
        tr = self._tr
        rate = tr.client_sample
        if tr.enabled and rate is not None and rate < 1.0:
            self._rnd = int(rnd)
            self._mark = tr.mark()
        return tr.begin("round", kind="round", rnd=int(rnd), phase=phase)

    def begin_client(self, cid: int, **attrs):
        return self._tr.begin("client", kind="client", cid=int(cid), **attrs)

    # ---- simulated clock ---------------------------------------------------

    def add_sim(self, dt: float) -> None:
        self["sim_time_s"] += dt
        self._tr.sim_time = self["sim_time_s"]

    def set_sim(self, t: float) -> None:
        self["sim_time_s"] = t
        self._tr.sim_time = t

    # ---- round accounting --------------------------------------------------

    def end_round(self, span, log, down: int, up: int) -> None:
        """Append the RoundLog and accumulate comm — the one place either
        happens (identical float op order to the historical runners)."""
        self["rounds"].append(log)
        self["comm_gb"] += (down + up) / 1e9
        if self._mark is not None:
            self._sample_round()
        span.end(down_bytes=int(down), up_bytes=int(up),
                 sim_time_s=self["sim_time_s"], comm_gb=self["comm_gb"],
                 loss=log.loss, acc=log.acc)
        tr = self._tr
        if tr.enabled:
            # device-memory watermark at the round boundary (repro_torch.obs
            # .profile; silently nothing on backends without memory stats)
            from repro_torch.obs import profile as _profile
            _profile.sample_memory(tr)
            if tr.live is not None:
                tr.live.publish(tr, progress={
                    "runner": self._runner, "round": len(self["rounds"]),
                    "rounds": self._rounds_total, "loss": log.loss,
                    "acc": log.acc, "comm_gb": self["comm_gb"],
                    "sim_time_s": self["sim_time_s"]})

    # ---- cohort-scale trace sampling (off the hot path) --------------------

    def _sample_round(self) -> None:
        """Prune this round's per-client spans down to the head sample plus
        any alert-implicated clients, and emit one ``cohort_rollup`` span
        with merged sketches of the dropped distributions.  Runs once per
        round, before the round span ends (so the rollup parents under it);
        see module docstring for the retention contract."""
        tr = self._tr
        mark, self._mark = self._mark, None
        rnd, self._rnd = self._rnd, None
        window = tr.window(mark)
        rate = tr.client_sample
        # sketch every numeric attribute across ALL client spans (pre-prune)
        sketches: dict[str, Sketch] = {}
        cids: set = set()
        for ev in window:
            if ev.get("type") != "span" or ev.get("kind") != "client":
                continue
            attrs = ev.get("attrs") or {}
            cid = attrs.get("cid")
            if cid is None:
                continue
            cids.add(cid)
            for k, v in attrs.items():
                if k != "cid" and isinstance(v, (int, float)) \
                        and not isinstance(v, bool):
                    sketches.setdefault(k, Sketch()).add(v)
            d = ev.get("dur")
            if isinstance(d, (int, float)):
                sketches.setdefault("wall_s", Sketch()).add(d)
        if not cids:
            return
        # tail-keep: clients implicated in any alert this round survive
        keep = {c for c in cids
                if _trace.client_keep(tr.sample_seed, rnd, c, rate)}
        for ev in window:
            if ev.get("type") == "event" and ev.get("name") == "alert":
                cid = (ev.get("attrs") or {}).get("cid")
                if cid is not None:
                    keep.add(cid)
        # drop unsampled client spans, their descendant spans, and their
        # per-client events (never alert events).  Children end before
        # parents, so descent is resolved by walking parent chains.
        span_parent = {ev["id"]: ev.get("parent") for ev in window
                       if ev.get("type") == "span"}
        dropped: set = set()
        for ev in window:
            if ev.get("type") == "span" and ev.get("kind") == "client":
                cid = (ev.get("attrs") or {}).get("cid")
                if cid is not None and cid not in keep:
                    dropped.add(ev["id"])

        def _under_dropped(sid) -> bool:
            while sid is not None:
                if sid in dropped:
                    return True
                sid = span_parent.get(sid)
            return False

        kept_events = []
        for ev in window:
            if ev.get("type") == "span":
                if _under_dropped(ev["id"]):
                    continue
            elif ev.get("type") == "event" and ev.get("name") != "alert":
                cid = (ev.get("attrs") or {}).get("cid")
                if cid is not None and cid not in keep:
                    continue
            kept_events.append(ev)
        tr.replace_window(mark, kept_events)
        tr.point_span(
            "cohort_rollup", kind=ROLLUP_KIND, rnd=rnd, rate=rate,
            n_clients=len(cids), n_kept=len(keep & cids),
            sketches={k: sk.to_dict() for k, sk in sorted(sketches.items())})

    # ---- rank-allocation trajectory (FedARA §IV) ---------------------------

    def record_ranks(self, rnd: int, masks_np, votes=None) -> None:
        """One ``rank_alloc`` trace event per arbitration: per-module
        live/total rank counts (plus optional per-module importance votes),
        and a ``module_pruned`` event the first round a module's count hits
        zero — the paper's rank trajectory / RankDet signal as first-class
        trace data, so ``summarize``/``report`` rebuild it from JSONL alone.
        No-op (zero work) while tracing is disabled."""
        if not self._tr.enabled or not masks_np:
            return
        from repro_torch.core import pruning as _pruning
        mods = _pruning.module_rank_summary(masks_np)
        if votes:
            for mod, frac in votes.items():
                if mod in mods:
                    mods[mod]["importance"] = float(frac)
        live = sum(m["live"] for m in mods.values())
        total = sum(m["total"] for m in mods.values())
        self._tr.event("rank_alloc", rnd=int(rnd), live=live, total=total,
                       n_dead=sum(1 for m in mods.values()
                                  if m["live"] == 0),
                       modules=mods)
        for mod, m in sorted(mods.items()):
            if m["live"] == 0 and mod not in self._dead:
                self._dead.add(mod)
                self._tr.event("module_pruned", rnd=int(rnd), module=mod)
            elif m["live"]:
                self._dead.discard(mod)
        g = self._tr.metrics.gauge
        g("ranks.live").set(live)
        g("ranks.total").set(total)

    def inflight_comm(self, down: int, up: int) -> None:
        """Async: broadcasts/uploads in flight when the run ended were still
        transmitted; they count toward comm but belong to no round."""
        self["comm_gb"] += (down + up) / 1e9
        self._tr.event("inflight_comm", down_bytes=int(down),
                       up_bytes=int(up))

    # ---- async event log (same schema the tracer emits) --------------------

    def async_event(self, now: float, name: str, **attrs) -> None:
        ev = {"type": "event", "name": name, "sim_t": round(now, 9),
              "attrs": attrs}
        self["events"].append(ev)
        self._tr.event(name, sim_t=ev["sim_t"], **attrs)

    # ---- privacy accounting ------------------------------------------------

    def record_secagg(self, entry: dict) -> None:
        self["secagg_rounds"].append(entry)

    def record_eps(self, rnd: int, eps: float) -> None:
        self["dp_eps"].append((rnd, eps))
        self._tr.metrics.gauge("dp.epsilon").set(eps)

    # ---- run close ---------------------------------------------------------

    def finish(self) -> None:
        self._run_span.end(final_acc=self.get("final_acc"),
                           comm_gb=self["comm_gb"],
                           sim_time_s=self["sim_time_s"],
                           wall_s=self.get("wall_s"))
