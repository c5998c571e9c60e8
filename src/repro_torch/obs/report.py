"""Static run report from the JSONL trace alone — no live-process state.

``python -m repro_torch.obs report trace.jsonl [-o report.html]`` builds:

  * run header (runner / final accuracy / wall+sim clocks / comm_gb)
  * the FedARA rank trajectory as a per-module × per-round heatmap
    (cell shade = live/total rank fraction; ``×`` marks the round a module
    was pruned) — reconstructed from the recorder's ``rank_alloc`` events
  * bytes by codec × pipeline stage, from the pipeline's labeled counters
  * the latency table (histogram metric rows: count + p50/p95/p99) —
    sketch-backed quantiles render through the same columns as exact ones
  * the alert timeline (embedded ``alert`` events, or a fresh offline
    ``health.scan`` when the trace predates live monitoring)
  * compile accounting (``repro_torch.obs.profile``): per-stage counts, compiles
    after round 1 (should be 0 — the retrace-flatness claim), eval/setup
  * device-time attribution (``profile.self_times``): where the wall clock
    went per span kind, self-time vs nested compile time

``render_text`` targets a terminal (unicode shade blocks); ``render_html``
emits one self-contained file, inline styles only.  Stdlib-only.

Port of ``repro/obs/report.py``, the same code under the
``repro_torch.obs`` package name.
"""

from __future__ import annotations

import html as _html

from repro_torch.obs import export as E
from repro_torch.obs import health as H
from repro_torch.obs import profile as P

_SHADES = " ░▒▓█"


def _shade(frac: float) -> str:
    return _SHADES[max(0, min(len(_SHADES) - 1,
                              int(frac * (len(_SHADES) - 1) + 0.5)))]


def build_report(events: list[dict]) -> dict:
    """Everything the renderers need, as plain data."""
    meta = next((e for e in events if e.get("type") == "meta"), {})
    summary = E.summarize(events)
    traj = E.rank_trajectory(events)
    alerts = H.embedded_alerts(events) or H.scan(events)

    # per-module totals (constant across rounds) for heatmap shading
    totals: dict[str, int] = {}
    for e in events:
        if e.get("type") == "event" and e.get("name") == "rank_alloc":
            for mod, info in ((e.get("attrs") or {}).get("modules")
                              or {}).items():
                if isinstance(info, dict) and info.get("total"):
                    totals[mod] = info["total"]

    # bytes by codec × stage from the pipeline's labeled counters
    bytes_by: dict[tuple, dict] = {}
    for e in events:
        if e.get("type") != "metric" or \
                e.get("name") not in ("pipeline.up_bytes",
                                      "pipeline.down_bytes"):
            continue
        lb = e.get("labels") or {}
        key = (str(lb.get("codec")), str(lb.get("stage")))
        rec = bytes_by.setdefault(key, {"up": 0, "down": 0})
        rec["up" if e["name"].endswith("up_bytes") else "down"] += \
            e.get("value") or 0

    # latency table: every histogram metric row renders through the same
    # count/p50/p95/p99 columns whether its quantiles came from the live
    # whole-stream sketch or a hand-built exact summary dict — the sketch's
    # summary() shape IS the exact one's
    latency = []
    for e in events:
        if e.get("type") != "metric" or e.get("metric") != "histogram":
            continue
        v = e.get("value") or {}
        if not isinstance(v, dict):
            continue
        lb = e.get("labels") or {}
        key = e["name"] if not lb else \
            f"{e['name']}{{{','.join(f'{k}={x}' for k, x in sorted(lb.items()))}}}"
        latency.append({"key": key, "count": v.get("count", 0),
                        "p50": v.get("p50"), "p95": v.get("p95"),
                        "p99": v.get("p99")})

    return {"meta": meta.get("meta") or {},
            "summary": summary,
            "trajectory": traj,
            "rank_totals": totals,
            "bytes_by": [{"codec": c, "stage": s, **rec}
                         for (c, s), rec in sorted(bytes_by.items())],
            "latency": latency,
            "alerts": alerts,
            "compiles": P.compile_stats(events),
            "self_times": P.self_times(events)}


# ---------------------------------------------------------------------------
# Terminal rendering
# ---------------------------------------------------------------------------

def render_text(rep: dict) -> str:
    L: list[str] = []
    s = rep["summary"]
    head = [f"rounds={s.get('n_rounds')}", f"comm_gb={s.get('comm_gb'):.6f}"]
    for k in ("runner", "final_acc", "wall_s", "sim_time_s"):
        if s.get(k) not in (None, 0.0):
            head.append(f"{k}={s[k]}")
    L.append("== run ==")
    L.append("  " + "  ".join(head))

    traj, totals = rep["trajectory"], rep["rank_totals"]
    if traj["rounds"]:
        L.append("== rank trajectory (live/total per module; × = pruned) ==")
        rounds = traj["rounds"]
        pruned_at = {(p["module"], p["rnd"]) for p in rep["trajectory"]
                     ["pruned"]}
        width = max((len(m) for m in traj["modules"]), default=0)
        L.append(f"  {'module'.ljust(width)}  " +
                 "".join(str(r % 10) for r in rounds))
        for mod in sorted(traj["modules"]):
            row = []
            for r in rounds:
                live = traj["modules"][mod].get(r)
                if live is None:
                    row.append(".")
                elif (mod, r) in pruned_at:
                    row.append("×")
                else:
                    tot = totals.get(mod) or 1
                    row.append(_shade(live / tot))
            L.append(f"  {mod.ljust(width)}  {''.join(row)}")
        last = rounds[-1]
        L.append(f"  final live ranks: {traj['live'].get(last)}"
                 f"/{traj['total']}  pruned modules: {len(traj['pruned'])}")

    if rep["bytes_by"]:
        L.append("== bytes by codec × stage ==")
        for r in rep["bytes_by"]:
            L.append(f"  {r['codec']:>10} {r['stage']:>8}  "
                     f"up={int(r['up'])}  down={int(r['down'])}")

    if rep.get("latency"):
        L.append("== latency (histogram quantiles) ==")
        width = max(len(r["key"]) for r in rep["latency"])
        for r in rep["latency"]:
            qs = "  ".join(
                f"{tag}={r[tag] * 1e3:.2f}ms" if isinstance(
                    r.get(tag), (int, float)) else f"{tag}=-"
                for tag in ("p50", "p95", "p99"))
            L.append(f"  {r['key'].ljust(width)}  n={r['count']:<6d} {qs}")

    L.append(f"== alerts ({len(rep['alerts'])}) ==")
    for a in rep["alerts"]:
        rest = {k: v for k, v in a.items() if k != "alert"}
        L.append(f"  {a.get('alert', '?'):>16}  "
                 + "  ".join(f"{k}={v}" for k, v in rest.items()))
    if not rep["alerts"]:
        L.append("  (none)")

    c = rep["compiles"]
    if c["by_stage"]:
        L.append("== compiles ==")
        L.append("  " + "  ".join(f"{k}={v}"
                                  for k, v in sorted(c["by_stage"].items())))
        L.append(f"  backend total={c['n']}  setup={c['setup']}  "
                 f"eval={c['eval']}  after_round_1={c['after_first_round']}"
                 f"  ({c['total_s']:.3f}s)")
        if c["by_round"]:
            L.append("  by round: " + "  ".join(
                f"r{r}:{n}" for r, n in sorted(c["by_round"].items())))

    st = rep["self_times"]
    if st:
        L.append("== device time by span (self = minus children) ==")
        rows = sorted(st.items(), key=lambda kv: -kv[1]["self_s"])[:12]
        width = max(len(k) for k, _ in rows)
        for key, r in rows:
            L.append(f"  {key.ljust(width)}  n={r['n']:<4d} "
                     f"total={r['total_s']:8.3f}s  self={r['self_s']:8.3f}s"
                     f"  compile={r['compile_s']:.3f}s")
    return "\n".join(L)


# ---------------------------------------------------------------------------
# HTML rendering (one self-contained file, inline styles)
# ---------------------------------------------------------------------------

def _esc(x) -> str:
    return _html.escape(str(x))


def render_html(rep: dict) -> str:
    s = rep["summary"]
    out = ["<!doctype html><html><head><meta charset='utf-8'>"
           "<title>repro_torch.obs report</title></head>"
           "<body style='font-family:monospace;margin:2em;'>"]
    out.append("<h2>repro_torch.obs run report</h2><p>")
    for k in ("runner", "n_rounds", "comm_gb", "final_acc", "wall_s",
              "sim_time_s"):
        if s.get(k) is not None:
            out.append(f"<b>{_esc(k)}</b>={_esc(s[k])} ")
    out.append("</p>")

    traj, totals = rep["trajectory"], rep["rank_totals"]
    if traj["rounds"]:
        rounds = traj["rounds"]
        pruned_at = {(p["module"], p["rnd"]) for p in traj["pruned"]}
        out.append("<h3>Rank trajectory</h3>"
                   "<table style='border-collapse:collapse;'>"
                   "<tr><th style='text-align:left;'>module</th>")
        out.extend(f"<th style='padding:0 3px;'>{_esc(r)}</th>"
                   for r in rounds)
        out.append("</tr>")
        for mod in sorted(traj["modules"]):
            out.append(f"<tr><td>{_esc(mod)}</td>")
            for r in rounds:
                live = traj["modules"][mod].get(r)
                if live is None:
                    out.append("<td></td>")
                    continue
                tot = totals.get(mod) or 1
                frac = live / tot
                # green→red ramp on live-rank fraction; pruned cells marked
                bg = (f"background:rgb({int(230 - 130 * frac)},"
                      f"{int(100 + 130 * frac)},100);")
                mark = "×" if (mod, r) in pruned_at else str(live)
                out.append(f"<td title='{_esc(mod)} r{_esc(r)}: "
                           f"{live}/{tot}' style='text-align:center;"
                           f"padding:0 3px;{bg}'>{_esc(mark)}</td>")
            out.append("</tr>")
        out.append("</table>")
        last = rounds[-1]
        out.append(f"<p>final live ranks {_esc(traj['live'].get(last))}"
                   f"/{_esc(traj['total'])}, "
                   f"{len(traj['pruned'])} modules pruned</p>")

    if rep["bytes_by"]:
        out.append("<h3>Bytes by codec × stage</h3><table border='1' "
                   "style='border-collapse:collapse;'>"
                   "<tr><th>codec</th><th>stage</th><th>up</th>"
                   "<th>down</th></tr>")
        for r in rep["bytes_by"]:
            out.append(f"<tr><td>{_esc(r['codec'])}</td>"
                       f"<td>{_esc(r['stage'])}</td>"
                       f"<td>{int(r['up'])}</td>"
                       f"<td>{int(r['down'])}</td></tr>")
        out.append("</table>")

    if rep.get("latency"):
        out.append("<h3>Latency (histogram quantiles)</h3><table border='1' "
                   "style='border-collapse:collapse;'>"
                   "<tr><th>metric</th><th>n</th><th>p50</th><th>p95</th>"
                   "<th>p99</th></tr>")
        for r in rep["latency"]:
            cells = "".join(
                f"<td>{r[tag] * 1e3:.2f}ms</td>" if isinstance(
                    r.get(tag), (int, float)) else "<td>-</td>"
                for tag in ("p50", "p95", "p99"))
            out.append(f"<tr><td>{_esc(r['key'])}</td>"
                       f"<td>{r['count']}</td>{cells}</tr>")
        out.append("</table>")

    out.append(f"<h3>Alerts ({len(rep['alerts'])})</h3>")
    if rep["alerts"]:
        out.append("<ul>")
        for a in rep["alerts"]:
            rest = {k: v for k, v in a.items() if k != "alert"}
            out.append(f"<li><b>{_esc(a.get('alert', '?'))}</b> "
                       + " ".join(f"{_esc(k)}={_esc(v)}"
                                  for k, v in rest.items()) + "</li>")
        out.append("</ul>")
    else:
        out.append("<p>(none)</p>")

    c = rep["compiles"]
    if c["by_stage"]:
        out.append("<h3>Compiles</h3><p>")
        out.append(" ".join(f"{_esc(k)}={v}"
                            for k, v in sorted(c["by_stage"].items())))
        out.append(f"<br>backend total={c['n']} setup={c['setup']} "
                   f"eval={c['eval']} "
                   f"after_round_1={c['after_first_round']}</p>")

    st = rep["self_times"]
    if st:
        out.append("<h3>Device time by span</h3><table border='1' "
                   "style='border-collapse:collapse;'>"
                   "<tr><th>span</th><th>n</th><th>total_s</th>"
                   "<th>self_s</th><th>compile_s</th></tr>")
        for key, r in sorted(st.items(),
                             key=lambda kv: -kv[1]["self_s"])[:12]:
            out.append(f"<tr><td>{_esc(key)}</td><td>{r['n']}</td>"
                       f"<td>{r['total_s']:.3f}</td>"
                       f"<td>{r['self_s']:.3f}</td>"
                       f"<td>{r['compile_s']:.3f}</td></tr>")
        out.append("</table>")
    out.append("</body></html>")
    return "".join(out)
