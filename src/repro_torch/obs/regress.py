"""Bench regression sentinel: fresh ``BENCH_*.json`` vs committed trajectory.

``python -m repro_torch.obs regress fresh.json committed.json`` flattens both
files into named scalars, classifies each key by what kind of number it is,
and applies a noise-aware tolerance per class:

  time     one-sided: only a *slowdown* beyond ``--time-tol`` (default 75%)
           fails — CI boxes are slower and noisier than the machine that
           committed the baseline, and a surprise speedup is not a bug.
           Bench times are already steady-state medians (warmup intervals
           dropped — see ``benchmarks/common.steady_state``); any raw
           numeric list encountered during flatten is reduced to its median
           for the same reason.
  speedup  one-sided the other way: fails only when the cohort advantage
           shrinks below ``1 − speedup_tol`` of the committed value.
  bytes    near-exact two-sided (default 1e-6 relative): wire bytes are
           deterministic, so any drift is a real codec/pipeline change.
  metric   loss/accuracy, two-sided ``--metric-tol`` (default 15%): seeds
           are fixed, but cross-platform float folds wobble.
  quantile sketch-backed percentile keys (``p50``/``p95``/``p99`` leaves —
           see ``repro_torch.obs.sketch``): two-sided at twice the sketch's
           documented relative-error bound (default 2 %), NOT the loose
           metric class — two correct sketches of the same stream can
           differ by at most one bucket width on each side.
  info     everything else (event counts, sample counts, sim times whose
           scale depends on the bench's round count) — reported, never
           fatal.  Likewise keys present in only one file: quick-mode
           benches emit fewer rows/rounds than the committed full run, and
           a missing key must not fail CI.

Noisy rows (``"noisy": true`` — no steady-state samples survived warmup)
are skipped wholesale.  The ``async`` section is informational: its scale
is proportional to the bench's configured round count, which differs
between quick and full mode.

Exit status: 1 iff any classified key regressed, 0 otherwise.
Stdlib-only, like the rest of the offline ``repro_torch.obs`` surface.

Port of ``repro/obs/regress.py``, the same code under the
``repro_torch.obs`` package name.
"""

from __future__ import annotations

import dataclasses
import json
import re

from repro_torch.obs.sketch import DEFAULT_REL_ERR

_INFO_SECTIONS = ("async", "provenance")
_QUANTILE_LEAF = re.compile(r"^p\d{1,2}$")


@dataclasses.dataclass
class Tolerances:
    time_tol: float = 0.75      # fresh_time  <= committed * (1 + tol)
    speedup_tol: float = 0.5    # fresh_speed >= committed * (1 - tol)
    byte_tol: float = 1e-6      # |rel drift| <= tol
    metric_tol: float = 0.15    # |rel drift| <= tol
    # two sketches of the same stream differ by ≤ rel_err on each side
    quantile_tol: float = 2 * DEFAULT_REL_ERR


def _median(vals):
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def classify(key: str) -> str:
    """Key class from its flattened name (see module docstring)."""
    root = key.split(".", 1)[0]
    leaf = key.rsplit(".", 1)[-1]
    if root in _INFO_SECTIONS:
        return "info"
    if leaf.endswith("_samples") or leaf in ("noisy", "ndev", "events"):
        return "info"
    if _QUANTILE_LEAF.match(leaf):
        return "quantile"
    if "speedup" in leaf:
        return "speedup"
    if leaf.endswith("_s") or "time" in leaf or "latency" in leaf:
        return "time"
    if "bytes" in leaf or root == "codec":
        return "bytes"
    if "loss" in leaf or "acc" in leaf or "staleness" in leaf:
        return "metric"
    return "info"


def flatten(bench: dict) -> dict[str, float]:
    """Flatten a BENCH_*.json dict into ``dotted.key -> scalar``.

    Structure-aware where it matters, generic elsewhere:

    * ``rows`` (a list of per-cpr records) is re-keyed by its ``cpr`` field
      so quick mode (one cpr) and full mode (three) align on the rows they
      share; rows flagged ``noisy`` are dropped entirely.
    * convergence-style curves (lists of ``[cum_bytes, loss]`` pairs) become
      per-round ``bytes<i>`` / ``loss<i>`` keys — comparison happens on the
      round indices both runs have.
    * any other list of numbers collapses to its median; non-numeric leaves
      are dropped.
    """
    flat: dict[str, float] = {}

    def put(key, v):
        if isinstance(v, bool):
            flat[key] = float(v)
        elif isinstance(v, (int, float)) and v == v:
            flat[key] = float(v)

    def walk(obj, prefix):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(v, f"{prefix}.{k}" if prefix else str(k))
        elif isinstance(obj, list):
            if obj and all(isinstance(p, (list, tuple)) and len(p) == 2
                           and all(isinstance(x, (int, float)) for x in p)
                           for p in obj):
                for i, (b, l) in enumerate(obj):
                    put(f"{prefix}.bytes{i}", b)
                    put(f"{prefix}.loss{i}", l)
            elif obj and all(isinstance(x, (int, float)) and
                             not isinstance(x, bool) for x in obj):
                put(prefix, _median(obj))
        else:
            put(prefix, obj)

    for k, v in bench.items():
        if k == "rows" and isinstance(v, list):
            for rec in v:
                if not isinstance(rec, dict) or rec.get("noisy"):
                    continue
                cpr = rec.get("cpr", "?")
                walk({kk: vv for kk, vv in rec.items() if kk != "cpr"},
                     f"rows.cpr{cpr}")
        else:
            walk(v, str(k))
    return flat


def compare(fresh: dict, committed: dict,
            tol: Tolerances | None = None) -> dict:
    """Compare two loaded BENCH dicts.  Returns::

      {"failures": [{key, kind, fresh, committed, limit}],
       "checked": [...], "info": [...], "only_fresh": [...],
       "only_committed": [...], "ok": bool}
    """
    tol = tol or Tolerances()
    ff, cf = flatten(fresh), flatten(committed)
    res = {"failures": [], "checked": [], "info": [],
           "only_fresh": sorted(set(ff) - set(cf)),
           "only_committed": sorted(set(cf) - set(ff))}
    for key in sorted(set(ff) & set(cf)):
        f, c = ff[key], cf[key]
        kind = classify(key)
        rec = {"key": key, "kind": kind, "fresh": f, "committed": c}
        if kind == "info":
            res["info"].append(rec)
            continue
        bad = False
        if kind == "time":
            rec["limit"] = c * (1.0 + tol.time_tol)
            bad = f > rec["limit"]
        elif kind == "speedup":
            rec["limit"] = c * (1.0 - tol.speedup_tol)
            bad = f < rec["limit"]
        else:
            t = {"bytes": tol.byte_tol,
                 "quantile": tol.quantile_tol}.get(kind, tol.metric_tol)
            denom = max(abs(c), 1e-12)
            rec["limit"] = t
            rec["rel"] = abs(f - c) / denom
            bad = rec["rel"] > t
        (res["failures"] if bad else res["checked"]).append(rec)
    res["ok"] = not res["failures"]
    return res


def load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def format_report(res: dict, fresh_path: str = "fresh",
                  committed_path: str = "committed") -> str:
    lines = [f"regress: {fresh_path} vs {committed_path} — "
             f"{len(res['checked'])} ok, {len(res['failures'])} regressed, "
             f"{len(res['info'])} informational"]
    for r in res["failures"]:
        lines.append(f"  FAIL {r['key']} [{r['kind']}]: "
                     f"fresh={r['fresh']:.6g} committed={r['committed']:.6g}"
                     f" limit={r['limit']:.6g}")
    for r in res["checked"]:
        lines.append(f"  ok   {r['key']} [{r['kind']}]: "
                     f"fresh={r['fresh']:.6g} committed={r['committed']:.6g}")
    if res["only_committed"]:
        lines.append("  missing in fresh (not fatal): "
                     + ", ".join(res["only_committed"]))
    if res["only_fresh"]:
        lines.append("  new in fresh (not compared): "
                     + ", ".join(res["only_fresh"]))
    lines.append("RESULT: " + ("PASS" if res["ok"] else "REGRESSION"))
    return "\n".join(lines)
