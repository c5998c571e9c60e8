"""Trace triage CLI:
``python -m repro_torch.obs summarize|diff|check|chrome|regress|report|top``.

  summarize trace.jsonl [--format human|json]
      Reconstruct run-level accounting (comm_gb / sim_time_s / secagg
      phase bytes / rank trajectory / alerts / compiles / metrics) from
      the JSONL trace.
  diff a.jsonl b.jsonl [--rel-tol X] [--format human|json]
      Numeric summary deltas between two runs; with --rel-tol, exit 1 when
      any shared key moved by more than X (relative).
  check trace.jsonl [--require-kinds run,round,...]
        [--require-metrics pipeline.up_bytes,...]
      Schema validation; exit 1 on any problem (CI gate).
  chrome trace.jsonl [-o out.json]
      Convert to Chrome trace-event JSON (load in Perfetto or
      about://tracing).  An empty / span-less trace converts to a valid
      (empty) Chrome trace rather than erroring.
  regress fresh_BENCH.json committed_BENCH.json [--time-tol ...]
      Bench regression sentinel: noise-aware comparison of a fresh bench
      run against the committed trajectory; exit 1 on regression (CI
      gate — see ``repro_torch.obs.regress``).
  report trace.jsonl [-o report.html]
      Static report (rank heatmap, bytes by codec × stage, alert
      timeline, compile counts); terminal rendering by default, one
      self-contained HTML file with -o.
  top trace.jsonl | top http://host:port [--refresh S] [-n N] [--no-ansi]
      Live ANSI view: round progress, loss-trend sparkline, bytes by
      codec, p50/p95/p99 latency, active alerts.  Tails a JSONL trace or
      a live ``/snapshot`` endpoint (``--metrics-port``); one line per
      refresh when stdout is not a TTY.

Stdlib-only, like the rest of ``repro_torch.obs`` — runs without torch.

Port of ``repro/obs/__main__.py``, the same code under the
``repro_torch.obs`` package name.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs import export as E


def _print_flat(d: dict, indent: str = "") -> None:
    for k, v in d.items():
        if isinstance(v, dict):
            print(f"{indent}{k}:")
            _print_flat(v, indent + "  ")
        else:
            print(f"{indent}{k}: {v}")


def _cmd_summarize(args) -> int:
    s = E.summarize(E.read_jsonl(args.trace))
    if args.format == "json":
        print(json.dumps(s, indent=1))
    else:
        _print_flat(s)
    return 0


def _cmd_check(args) -> int:
    kinds = [k for k in (args.require_kinds or "").split(",") if k]
    mets = [m for m in (args.require_metrics or "").split(",") if m]
    try:
        events = E.read_jsonl(args.trace)
    except (OSError, json.JSONDecodeError) as e:
        print(f"unreadable trace: {e}", file=sys.stderr)
        return 1
    problems = E.check(events, require_kinds=kinds, require_metrics=mets)
    for p in problems:
        print(f"PROBLEM: {p}", file=sys.stderr)
    if not problems:
        n = sum(1 for e in events if e.get("type") == "span")
        print(f"ok: {len(events)} events, {n} spans, schema "
              f"{E.SCHEMA_VERSION}")
    return 1 if problems else 0


def _cmd_diff(args) -> int:
    d = E.diff(E.summarize(E.read_jsonl(args.a)),
               E.summarize(E.read_jsonl(args.b)))
    if args.format == "json":
        print(json.dumps(d, indent=1))
    else:
        for key, ent in d.items():
            if ent.get("delta"):
                rel = ent.get("rel")
                print(f"{key}: {ent['a']} -> {ent['b']}  "
                      f"(rel {rel:+.4f})" if rel is not None else
                      f"{key}: {ent['a']} -> {ent['b']}")
            elif ent["a"] is None or ent["b"] is None:
                print(f"{key}: only in {'b' if ent['a'] is None else 'a'}")
    if args.rel_tol is not None:
        over = [k for k, ent in d.items()
                if ent.get("rel") is not None
                and abs(ent["rel"]) > args.rel_tol]
        if over:
            print(f"FAIL: {len(over)} keys moved past rel tol "
                  f"{args.rel_tol}: {', '.join(over)}", file=sys.stderr)
            return 1
    return 0


def _cmd_chrome(args) -> int:
    ct = E.chrome_trace(E.read_jsonl(args.trace))
    out = args.out or (args.trace.rsplit(".", 1)[0] + "_chrome.json")
    with open(out, "w") as f:
        json.dump(ct, f)
    print(f"wrote {out} ({len(ct['traceEvents'])} events) — open in "
          "https://ui.perfetto.dev")
    return 0


def _cmd_regress(args) -> int:
    from repro_torch.obs import regress as R
    tol = R.Tolerances(time_tol=args.time_tol,
                       speedup_tol=args.speedup_tol,
                       byte_tol=args.byte_tol,
                       metric_tol=args.metric_tol)
    if args.quantile_tol is not None:
        tol.quantile_tol = args.quantile_tol
    try:
        fresh, committed = R.load(args.fresh), R.load(args.committed)
    except (OSError, json.JSONDecodeError) as e:
        print(f"unreadable bench json: {e}", file=sys.stderr)
        return 1
    res = R.compare(fresh, committed, tol)
    if args.format == "json":
        print(json.dumps(res, indent=1))
    else:
        print(R.format_report(res, args.fresh, args.committed))
    return 0 if res["ok"] else 1


def _cmd_report(args) -> int:
    from repro_torch.obs import report as REP
    rep = REP.build_report(E.read_jsonl(args.trace))
    if args.out:
        with open(args.out, "w") as f:
            f.write(REP.render_html(rep))
        print(f"wrote {args.out}")
    else:
        print(REP.render_text(rep))
    return 0


def _cmd_top(args) -> int:
    from repro_torch.obs import top as T
    return T.run(args.source, refresh=args.refresh,
                 iterations=args.iterations,
                 ansi=False if args.no_ansi else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("summarize", help="reconstruct run accounting")
    p.add_argument("trace")
    p.add_argument("--format", choices=["human", "json"], default="human")
    p.set_defaults(fn=_cmd_summarize)

    p = sub.add_parser("check", help="validate trace schema (CI gate)")
    p.add_argument("trace")
    p.add_argument("--require-kinds", default="",
                   help="comma-separated span kinds that must be present")
    p.add_argument("--require-metrics", default="",
                   help="comma-separated metric names that must be present")
    p.set_defaults(fn=_cmd_check)

    p = sub.add_parser("diff", help="run-to-run summary regression diff")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--rel-tol", type=float, default=None,
                   help="exit 1 when any shared key moves past this")
    p.add_argument("--format", choices=["human", "json"], default="human")
    p.set_defaults(fn=_cmd_diff)

    p = sub.add_parser("chrome", help="convert to Chrome/Perfetto JSON")
    p.add_argument("trace")
    p.add_argument("-o", "--out", default=None)
    p.set_defaults(fn=_cmd_chrome)

    p = sub.add_parser("regress",
                       help="bench regression sentinel (CI gate)")
    p.add_argument("fresh", help="fresh BENCH_*.json")
    p.add_argument("committed", help="committed BENCH_*.json baseline")
    p.add_argument("--time-tol", type=float, default=0.75,
                   help="allowed one-sided slowdown fraction (default .75)")
    p.add_argument("--speedup-tol", type=float, default=0.5,
                   help="allowed one-sided speedup shrink (default .5)")
    p.add_argument("--byte-tol", type=float, default=1e-6,
                   help="two-sided relative byte drift (default 1e-6)")
    p.add_argument("--metric-tol", type=float, default=0.15,
                   help="two-sided relative loss/acc drift (default .15)")
    p.add_argument("--quantile-tol", type=float, default=None,
                   help="two-sided drift for sketch-backed pNN keys "
                        "(default: 2x the sketch relative-error bound)")
    p.add_argument("--format", choices=["human", "json"], default="human")
    p.set_defaults(fn=_cmd_regress)

    p = sub.add_parser("report", help="static run report from the JSONL")
    p.add_argument("trace")
    p.add_argument("-o", "--out", default=None,
                   help="write self-contained HTML here (default: terminal)")
    p.set_defaults(fn=_cmd_report)

    p = sub.add_parser("top", help="live ANSI telemetry view")
    p.add_argument("source",
                   help="JSONL trace path or live base URL / /snapshot URL")
    p.add_argument("--refresh", type=float, default=2.0,
                   help="seconds between refreshes (default 2)")
    p.add_argument("-n", "--iterations", type=int, default=None,
                   help="stop after N refreshes (default: until Ctrl-C)")
    p.add_argument("--no-ansi", action="store_true",
                   help="force one-line-per-refresh mode even on a TTY")
    p.set_defaults(fn=_cmd_top)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
