"""``obs top`` — curses-free ANSI live view of a run's telemetry.

Tails either a written JSONL trace (re-read each refresh; cheap at trace
sizes the sampler produces) or a live ``/snapshot`` endpoint served by
``repro_torch.obs.live`` — both yield the same snapshot shape, so the renderer
is source-agnostic:

    $ python -m repro_torch.obs top trace.jsonl
    $ python -m repro_torch.obs top http://localhost:9100 --refresh 1

Renders round progress, the loss trend as a sparkline, bytes by codec,
p50/p95/p99 step latency, and active alerts.  On a TTY the frame redraws
in place (ANSI cursor-home + clear-to-end, no curses); when stdout is a
pipe it degrades to one summary line per refresh so logs stay greppable.
Stdlib-only, like the rest of ``repro_torch.obs``.

Port of ``repro/obs/top.py``, the same code under the
``repro_torch.obs`` package name.
"""

from __future__ import annotations

import json
import re
import sys
import time
import urllib.request

SPARK = "▁▂▃▄▅▆▇█"
_LABELED = re.compile(r"^(?P<name>[^{]+)\{(?P<labels>.*)\}$")


def fetch(source: str, timeout: float = 5.0) -> dict:
    """One snapshot from a URL (``/snapshot`` endpoint) or a JSONL path."""
    if source.startswith(("http://", "https://")):
        url = source.rstrip("/")
        if not url.endswith("/snapshot"):
            url += "/snapshot"
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return json.loads(r.read().decode())
    from repro_torch.obs import export as E
    from repro_torch.obs import live as L
    return L.snapshot_from_events(E.read_jsonl(source))


def sparkline(values: list, width: int = 40) -> str:
    vals = [v for v in values if isinstance(v, (int, float)) and v == v]
    if not vals:
        return ""
    vals = vals[-width:]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(SPARK[int((v - lo) / span * (len(SPARK) - 1))]
                   for v in vals)


def _split_key(key: str) -> tuple[str, dict]:
    m = _LABELED.match(key)
    if not m:
        return key, {}
    labels = dict(p.split("=", 1) for p in m.group("labels").split(",")
                  if "=" in p)
    return m.group("name"), labels


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "kB", "MB", "GB"):
        if abs(n) < 1000:
            return f"{n:.1f} {unit}"
        n /= 1000
    return f"{n:.1f} TB"


def render(snap: dict, width: int = 78) -> str:
    """Full-frame rendering of one snapshot (TTY mode)."""
    lines = []
    prog = snap.get("progress") or {}
    head = "obs top"
    if prog.get("runner"):
        head += f" · {prog['runner']}"
    if prog.get("round") is not None:
        total = prog.get("rounds")
        head += f" · round {prog['round']}" + (f"/{total}" if total else "")
    if prog.get("steps") is not None:
        head += f" · step {prog['steps']}"
    lines.append(head)
    lines.append("─" * min(width, len(head) + 8))

    stat = []
    if isinstance(prog.get("loss"), (int, float)):
        stat.append(f"loss {prog['loss']:.4f}")
    if isinstance(prog.get("acc"), (int, float)) and prog["acc"] == prog["acc"]:
        stat.append(f"acc {prog['acc']:.4f}")
    if isinstance(prog.get("comm_gb"), (int, float)):
        stat.append(f"comm {prog['comm_gb'] * 1e3:.1f} MB")
    if isinstance(prog.get("sim_time_s"), (int, float)):
        stat.append(f"sim {prog['sim_time_s']:.0f}s")
    for k in ("running", "waiting", "finished"):
        if prog.get(k) is not None:
            stat.append(f"{k} {prog[k]}")
    if stat:
        lines.append("  ".join(stat))

    trend = snap.get("loss_trend") or []
    if trend:
        spark = sparkline([p[1] for p in trend])
        if spark:
            lines.append(f"loss trend  {spark}")

    metrics = snap.get("metrics") or {}
    by_codec: dict[str, float] = {}
    lat_rows = []
    for key, val in sorted(metrics.items()):
        name, labels = _split_key(key)
        if name in ("pipeline.up_bytes", "pipeline.down_bytes") \
                and isinstance(val, (int, float)):
            codec = labels.get("codec", "?")
            by_codec[codec] = by_codec.get(codec, 0) + val
        elif isinstance(val, dict) and "p50" in val and name.endswith("_s"):
            lat_rows.append((key, val))
    if by_codec:
        lines.append("bytes by codec  " + "  ".join(
            f"{c}={_fmt_bytes(v)}" for c, v in sorted(by_codec.items())))
    if lat_rows:
        lines.append("latency" + " " * 17 + "p50        p95        p99")
        for key, s in lat_rows:
            p95 = s.get("p95", s.get("p90"))
            lines.append(f"  {key[:20]:<20}"
                         f"{s['p50'] * 1e3:>8.2f}ms "
                         f"{(p95 or 0) * 1e3:>8.2f}ms "
                         f"{s.get('p99', 0) * 1e3:>8.2f}ms")

    alerts = snap.get("alerts") or []
    if alerts:
        lines.append(f"alerts ({len(alerts)}):")
        for a in alerts[-5:]:
            kind = a.get("alert", "?")
            rest = ", ".join(f"{k}={v}" for k, v in sorted(a.items())
                             if k != "alert")
            lines.append(f"  ⚠ {kind}  {rest}"[:width])
    else:
        lines.append("alerts: none")
    return "\n".join(lines)


def render_line(snap: dict) -> str:
    """One-line rendering (non-TTY mode: a pipe gets greppable rows)."""
    prog = snap.get("progress") or {}
    bits = []
    if prog.get("round") is not None:
        total = prog.get("rounds")
        bits.append(f"round={prog['round']}" + (f"/{total}" if total else ""))
    if prog.get("steps") is not None:
        bits.append(f"steps={prog['steps']}")
    for k in ("loss", "acc", "comm_gb", "sim_time_s"):
        v = prog.get(k)
        if isinstance(v, (int, float)) and v == v:
            bits.append(f"{k}={v:.4g}")
    bits.append(f"alerts={len(snap.get('alerts') or [])}")
    return "  ".join(bits) if bits else "(no progress yet)"


def run(source: str, refresh: float = 2.0, iterations: int | None = None,
        ansi: bool | None = None, out=None) -> int:
    """The ``obs top`` loop.  ``iterations=None`` runs until Ctrl-C (or a
    dead endpoint); tests pass a small count.  ``ansi=None`` auto-detects
    (TTY → full-frame redraw, pipe → one line per refresh)."""
    out = out or sys.stdout
    if ansi is None:
        ansi = bool(getattr(out, "isatty", lambda: False)())
    i = 0
    errors = 0
    while iterations is None or i < iterations:
        i += 1
        try:
            snap = fetch(source)
            errors = 0
        except (OSError, ValueError) as e:
            errors += 1
            if errors >= 3:
                sys.stderr.write(f"obs top: source unreachable: {e}\n")
                return 1
            time.sleep(refresh)
            continue
        if ansi:
            # cursor home + clear-to-end: repaint without curses
            out.write("\x1b[H\x1b[J" + render(snap) + "\n")
        else:
            out.write(render_line(snap) + "\n")
        out.flush()
        if iterations is None or i < iterations:
            try:
                time.sleep(refresh)
            except KeyboardInterrupt:
                return 0
    return 0
