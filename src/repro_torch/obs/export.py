"""Trace export / reconstruction: JSONL IO, Chrome trace JSON, summaries
(reference: ``repro/obs/export.py``).

``summarize`` reconstructs the run-level accounting that the runners'
``history`` dicts report — ``comm_gb``, ``sim_time_s``, per-phase secagg
bytes — *from the trace alone*, to exact equality.  That works because the
recorder (``repro_torch.obs.record``) emits one round span per history round with
the same integer byte counts, and spans land in the event list in the order
the rounds accumulated, so folding ``(down + up) / 1e9`` over the event
stream replays the identical float additions (plus the async runner's
trailing ``inflight_comm`` event).  This is the acceptance contract the
trace-parity tests pin.

``chrome_trace`` converts the span list to Chrome trace-event JSON
(``ph: "X"`` complete events, µs timestamps) loadable in Perfetto / chrome
about://tracing.
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
import time

SCHEMA_VERSION = 1
EVENT_TYPES = ("meta", "span", "event", "metric")
METRIC_KINDS = ("counter", "gauge", "histogram")


def read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def write_jsonl(path: str, events: list[dict]) -> None:
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")


# ---------------------------------------------------------------------------
# Chrome trace-event JSON (Perfetto-viewable)
# ---------------------------------------------------------------------------

def chrome_trace(events: list[dict]) -> dict:
    out = [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
            "args": {"name": "repro"}}]
    for e in events:
        if e.get("type") == "span":
            out.append({
                "ph": "X", "name": e["name"], "cat": e["kind"],
                "pid": 0, "tid": 0,
                "ts": e["t0"] * 1e6, "dur": max(e["dur"], 0.0) * 1e6,
                "args": dict(e.get("attrs") or {},
                             sim_t0=e.get("sim_t0"),
                             sim_dur=e.get("sim_dur"))})
        elif e.get("type") == "event":
            out.append({
                "ph": "i", "name": e["name"], "s": "g",
                "pid": 0, "tid": 0, "ts": e["t"] * 1e6,
                "args": dict(e.get("attrs") or {}, sim_t=e.get("sim_t"))})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# Summaries
# ---------------------------------------------------------------------------

def summarize(events: list[dict]) -> dict:
    """Flat summary reconstructing the run's history-level accounting."""
    spans = [e for e in events if e.get("type") == "span"]
    kinds: dict[str, int] = {}
    for s in spans:
        kinds[s["kind"]] = kinds.get(s["kind"], 0) + 1

    # comm_gb: replay the runners' per-round float accumulation in event
    # order (round spans end in round order; inflight_comm trails) — see
    # module docstring for why this is exact, not just close.
    comm_gb = 0.0
    sim_time_s = 0.0
    n_rounds = down_bytes = up_bytes = 0
    for e in events:
        if e.get("type") == "span" and e.get("kind") == "round":
            a = e.get("attrs") or {}
            # tolerant .get: synthetic / partial traces (health fixtures,
            # hand-built repros) may omit byte attrs — summarize must
            # degrade, not crash (``check`` is where strictness lives)
            dn, up = a.get("down_bytes", 0), a.get("up_bytes", 0)
            comm_gb += (dn + up) / 1e9
            sim_time_s = a.get("sim_time_s", sim_time_s)
            down_bytes += dn
            up_bytes += up
            n_rounds += 1
        elif e.get("type") == "event" and e.get("name") == "inflight_comm":
            a = e.get("attrs") or {}
            comm_gb += (a.get("down_bytes", 0) + a.get("up_bytes", 0)) / 1e9

    out = {"schema": SCHEMA_VERSION, "n_rounds": n_rounds,
           "comm_gb": comm_gb, "sim_time_s": sim_time_s,
           "down_bytes": down_bytes, "up_bytes": up_bytes, "spans": kinds}

    for s in spans:
        if s["kind"] == "run":
            a = s.get("attrs") or {}
            for k in ("runner", "final_acc", "wall_s"):
                if k in a:
                    out[k] = a[k]

    phase_bytes: dict[str, dict] = {}
    sa_rounds = recovery = dropped = 0
    for s in spans:
        a = s.get("attrs") or {}
        if s["kind"] == "secagg-phase":
            pb = phase_bytes.setdefault(s["name"], {"down": 0, "up": 0})
            pb["down"] += a.get("down", 0)
            pb["up"] += a.get("up", 0)
        elif s["kind"] == "secagg":
            sa_rounds += 1
            recovery += a.get("recovery_bytes", 0)
            dropped += a.get("n_dropped", 0)
    if sa_rounds:
        out["secagg"] = {"rounds": sa_rounds, "phase_bytes": phase_bytes,
                         "recovery_bytes": recovery, "n_dropped": dropped}

    # alerts: the health monitor's embedded events, by type (forensics —
    # no live-process state needed, the JSONL carries them)
    from repro_torch.obs import health as H
    alerts = H.embedded_alerts(events)
    by_type: dict[str, int] = {}
    for a in alerts:
        k = a.get("alert", "?")
        by_type[k] = by_type.get(k, 0) + 1
    out["alerts"] = {"n": len(alerts), "by_type": by_type}

    # compile accounting (repro_torch.obs.profile): is the round loop flat?
    from repro_torch.obs import profile as P
    cs = P.compile_stats(events)
    if cs["by_stage"]:
        out["compiles"] = {"backend": cs["n"], "eval": cs["eval"],
                           "setup": cs["setup"],
                           "after_first_round": cs["after_first_round"],
                           "total_s": cs["total_s"]}

    # rank trajectory (FedARA's whole point): final live/total budget and
    # prune count from the recorder's rank_alloc events
    traj = rank_trajectory(events)
    if traj["rounds"]:
        last = traj["rounds"][-1]
        out["ranks"] = {"rounds": len(traj["rounds"]),
                        "final_live": traj["live"][last],
                        "total": traj["total"],
                        "n_pruned": len(traj["pruned"])}

    # cohort rollups (trace sampling): merge each round's sketches into
    # run-level distributions — the per-client → per-cohort → per-run
    # composition the sketch's merge contract guarantees stays within the
    # relative-error bound.  Counters above remain exact (round spans are
    # never pruned); only these distributions are sketched.
    rollup = rollup_summary(events)
    if rollup:
        out["rollup"] = rollup

    metrics = {}
    for e in events:
        if e.get("type") == "metric":
            lk = tuple(sorted((e.get("labels") or {}).items()))
            key = lk and f"{e['name']}{{{','.join(f'{k}={v}' for k, v in lk)}}}" or e["name"]
            metrics[key] = e["value"]
    if metrics:
        out["metrics"] = metrics
    return out


def rollup_summary(events: list[dict]) -> dict:
    """Merge every ``cohort_rollup`` span's sketches into run-level
    per-metric distributions.  Returns ``{}`` when the trace was unsampled
    (no rollup spans)::

      {"rounds": n, "n_clients": Σ, "n_kept": Σ, "rate": last seen,
       "dists": {key: {"count", "sum", "min", "max", "p50", ...}}}
    """
    from repro_torch.obs.sketch import Sketch
    merged: dict[str, Sketch] = {}
    out = {"rounds": 0, "n_clients": 0, "n_kept": 0, "rate": None}
    for e in events:
        if e.get("type") != "span" or e.get("kind") != "rollup":
            continue
        a = e.get("attrs") or {}
        out["rounds"] += 1
        out["n_clients"] += a.get("n_clients", 0)
        out["n_kept"] += a.get("n_kept", 0)
        if a.get("rate") is not None:
            out["rate"] = a["rate"]
        for k, d in (a.get("sketches") or {}).items():
            sk = Sketch.from_dict(d)
            if k in merged:
                merged[k].merge(sk)
            else:
                merged[k] = sk
    if not out["rounds"]:
        return {}
    out["dists"] = {k: sk.summary() for k, sk in sorted(merged.items())}
    return out


def rank_trajectory(events: list[dict]) -> dict:
    """Reconstruct the per-module rank trajectory from ``rank_alloc`` /
    ``module_pruned`` events alone (the recorder emits one per arbitration —
    see ``repro_torch.obs.record.RunRecorder.record_ranks``).

    Returns::

      {"rounds": [rnd, ...],                  # in event order
       "modules": {path: {rnd: live_ranks}},  # per-module trajectory
       "total":   total rank budget (Σ per-module totals, last seen),
       "live":    {rnd: Σ live ranks},
       "pruned":  [{"rnd": r, "module": path}, ...]}
    """
    out = {"rounds": [], "modules": {}, "total": 0, "live": {},
           "pruned": []}
    for e in events:
        if e.get("type") != "event":
            continue
        a = e.get("attrs") or {}
        if e.get("name") == "rank_alloc":
            rnd = a.get("rnd")
            out["rounds"].append(rnd)
            total = live = 0
            for mod, info in (a.get("modules") or {}).items():
                ml = info.get("live", 0) if isinstance(info, dict) else info
                mt = info.get("total", 0) if isinstance(info, dict) else 0
                out["modules"].setdefault(mod, {})[rnd] = ml
                total += mt
                live += ml
            out["total"] = total or a.get("total", out["total"])
            out["live"][rnd] = live if total else a.get("live", live)
        elif e.get("name") == "module_pruned":
            out["pruned"].append({"rnd": a.get("rnd"),
                                  "module": a.get("module")})
    return out


def flatten(d: dict, prefix: str = "") -> dict:
    """Nested summary → dotted-key dict of numeric leaves (for diff)."""
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "."))
        elif isinstance(v, bool):
            out[key] = int(v)
        elif isinstance(v, (int, float)):
            out[key] = v
    return out


def diff(sum_a: dict, sum_b: dict) -> dict:
    """Key → {a, b, delta, rel} over the union of numeric summary leaves."""
    fa, fb = flatten(sum_a), flatten(sum_b)
    out = {}
    for name in sorted(set(fa) | set(fb)):
        va, vb = fa.get(name), fb.get(name)
        ent = {"a": va, "b": vb}
        if va is not None and vb is not None:
            ent["delta"] = vb - va
            # NaN-safe: NaN != NaN, and rel of a NaN delta is NaN
            ent["rel"] = (vb - va) / abs(va) if va else (
                0.0 if vb == va else float("inf"))
        out[name] = ent
    return out


# ---------------------------------------------------------------------------
# Schema validation
# ---------------------------------------------------------------------------

def check(events: list[dict], require_kinds: list[str] | None = None,
          require_metrics: list[str] | None = None) -> list[str]:
    """Validate the trace's shape; returns problems (empty == valid).

    ``require_kinds`` / ``require_metrics`` demand span kinds and metric
    *names* (labels ignored) — the CI gates use them to assert a traced run
    actually recorded what it claims to."""
    problems: list[str] = []
    if not events:
        return ["empty trace"]
    head = events[0]
    if head.get("type") != "meta":
        problems.append("first event is not a meta record")
    elif head.get("schema") != SCHEMA_VERSION:
        problems.append(f"schema {head.get('schema')!r} != {SCHEMA_VERSION}")
    ids = set()
    kinds = set()
    metric_names = set()
    for i, e in enumerate(events):
        t = e.get("type")
        if t not in EVENT_TYPES:
            problems.append(f"event {i}: unknown type {t!r}")
            continue
        if t == "span":
            missing = [k for k in ("id", "name", "kind", "t0", "dur",
                                   "sim_t0", "sim_dur", "attrs")
                       if k not in e]
            if missing:
                problems.append(f"span {i}: missing {missing}")
                continue
            if e["id"] in ids:
                problems.append(f"span {i}: duplicate id {e['id']}")
            ids.add(e["id"])
            kinds.add(e["kind"])
            if e["dur"] < 0:
                problems.append(f"span {i}: negative dur {e['dur']}")
            if not isinstance(e["attrs"], dict):
                problems.append(f"span {i}: attrs is not a dict")
            if e["kind"] == "round":
                a = e.get("attrs") or {}
                for k in ("down_bytes", "up_bytes"):
                    v = a.get(k)
                    if not isinstance(v, int) or v < 0:
                        problems.append(
                            f"round span {i}: bad {k} {v!r} (want int ≥ 0)")
                if not isinstance(a.get("sim_time_s"), (int, float)):
                    problems.append(f"round span {i}: missing sim_time_s")
            elif e["kind"] == "rollup":
                a = e.get("attrs") or {}
                for k in ("n_clients", "n_kept"):
                    if not isinstance(a.get(k), int) or a[k] < 0:
                        problems.append(
                            f"rollup span {i}: bad {k} {a.get(k)!r}")
                sks = a.get("sketches")
                if not isinstance(sks, dict):
                    problems.append(f"rollup span {i}: sketches not a dict")
                else:
                    for k, d in sks.items():
                        if not isinstance(d, dict) \
                                or not isinstance(d.get("count"), int):
                            problems.append(
                                f"rollup span {i}: malformed sketch {k!r}")
        elif t == "event":
            if "name" not in e or "t" not in e:
                problems.append(f"event {i}: missing name/t")
        elif t == "metric":
            if e.get("metric") not in METRIC_KINDS:
                problems.append(
                    f"metric {i}: unknown kind {e.get('metric')!r}")
            if "name" in e:
                metric_names.add(e["name"])
    # parents may close after their children; validate refs post-hoc
    for i, e in enumerate(events):
        if e.get("type") == "span" and e.get("parent") is not None \
                and e["parent"] not in ids:
            problems.append(f"span {i}: dangling parent {e['parent']}")
    for k in require_kinds or ():
        if k not in kinds:
            problems.append(f"required span kind {k!r} absent")
    for m in require_metrics or ():
        if m not in metric_names:
            problems.append(f"required metric {m!r} absent")
    return problems


# ---------------------------------------------------------------------------
# Provenance (trace meta + BENCH_* rows)
# ---------------------------------------------------------------------------

def provenance(extra: dict | None = None) -> dict:
    """Commit / torch and CUDA versions / device name and count /
    BENCH_QUICK — best effort, never raises, imports torch only if it is
    importable."""
    out = {"python": platform.python_version(),
           "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
           "bench_quick": os.environ.get("BENCH_QUICK", "")}
    try:
        r = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                           capture_output=True, text=True, timeout=10)
        out["commit"] = r.stdout.strip() if r.returncode == 0 else "unknown"
    except Exception:
        out["commit"] = "unknown"
    try:
        import torch
        out["torch"] = torch.__version__
        out["cuda"] = torch.version.cuda or "none"
        if torch.cuda.is_available():
            out["device"] = torch.cuda.get_device_name(0)
            out["platform"] = "gpu"
            out["n_devices"] = torch.cuda.device_count()
        else:
            out["device"] = out["platform"] = "cpu"
            out["n_devices"] = 0
    except Exception:
        out["torch"] = out["cuda"] = out["device"] = out["platform"] = \
            "unavailable"
        out["n_devices"] = 0
    if extra:
        out.update(extra)
    return out
