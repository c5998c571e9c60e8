"""Live telemetry plane: an in-process HTTP server over the tracer's state.

``LiveServer`` is a stdlib ``ThreadingHTTPServer`` on a daemon thread
exposing three read-only endpoints:

``/metrics``
    Prometheus text exposition format v0.0.4.  Counters and gauges map
    directly; histograms render as ``summary`` families — per-quantile
    sample lines (``p50``/``p90``/``p95``/``p99`` from the whole-stream
    sketch), plus exact ``_sum`` and ``_count``.  Scrapeable by any
    Prometheus-compatible collector; no client library involved.

``/healthz``
    JSON liveness: ``ok`` (no active health alerts), the active alerts
    (``repro_torch.obs.health`` detector output), last-round progress, uptime.

``/snapshot``
    Flat JSON of everything the ``obs top`` viewer renders: progress,
    the full metric snapshot, the loss trend, recent alerts.

Hot-path discipline: the server never reads tracer state on request
threads.  Producers call :meth:`publish` at *boundaries* (round end,
engine step) — optionally throttled by ``min_interval`` — which renders
the exposition text and snapshot once, under a lock; request handlers
serve those prebuilt bytes.  When tracing is disabled nothing publishes
and nothing is attached: the NullTracer's ``live`` slot is ``None`` and
the instrumented code's only cost is that attribute check.

``snapshot_from_events`` builds the same snapshot shape from a written
JSONL trace, so ``obs top`` renders identically whether it tails a file
or polls a live ``/snapshot`` endpoint.

Port of ``repro/obs/live.py``, the same code under the
``repro_torch.obs`` package name.
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

EXPOSITION_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_QUANTILES = ((0.5, "0.5"), (0.9, "0.9"), (0.95, "0.95"), (0.99, "0.99"))
ALERT_CAP = 100
TREND_CAP = 512


def _prom_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _prom_label_value(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
                 .replace("\n", "\\n")


def _prom_labels(labels: tuple, extra: tuple = ()) -> str:
    pairs = [(k, v) for k, v in labels] + list(extra)
    if not pairs:
        return ""
    inner = ",".join(f'{_prom_name(k)}="{_prom_label_value(v)}"'
                     for k, v in pairs)
    return "{" + inner + "}"


def _prom_num(v) -> str:
    if v is None:
        return "NaN"
    if isinstance(v, bool):
        return str(int(v))
    return repr(float(v)) if isinstance(v, float) else str(v)


def exposition(metrics) -> str:
    """Render a ``Metrics`` registry as Prometheus text exposition v0.0.4.
    Histograms render as ``summary`` families (sketch quantiles + exact
    sum/count).  Stable order: one ``# TYPE`` line per family, series in
    registry (sorted) order."""
    families: dict[str, tuple[str, list[str]]] = {}
    for inst in metrics.instruments():
        pname = _prom_name(inst.name)
        if inst.kind == "histogram":
            ptype, lines = families.setdefault(pname, ("summary", []))
            s = inst.summary()
            for q, tag in _QUANTILES:
                lines.append(
                    f"{pname}{_prom_labels(inst.labels, (('quantile', tag),))}"
                    f" {_prom_num(inst.quantile(q))}")
            lbl = _prom_labels(inst.labels)
            lines.append(f"{pname}_sum{lbl} {_prom_num(s['sum'])}")
            lines.append(f"{pname}_count{lbl} {s['count']}")
        else:
            ptype, lines = families.setdefault(
                pname, ("counter" if inst.kind == "counter" else "gauge", []))
            lines.append(
                f"{pname}{_prom_labels(inst.labels)} {_prom_num(inst.value)}")
    out = []
    for pname in sorted(families):
        ptype, lines = families[pname]
        out.append(f"# TYPE {pname} {ptype}")
        out.extend(lines)
    return "\n".join(out) + "\n" if out else "\n"


def snapshot_from_events(events: list[dict]) -> dict:
    """The ``/snapshot`` shape reconstructed from a written JSONL trace
    (file mode of ``obs top``): progress from run/round spans, metrics from
    the close-time metric events, alerts from the embedded stream."""
    from repro_torch.obs import health as H
    progress: dict = {}
    trend: list = []
    n_rounds = 0
    for e in events:
        t = e.get("type")
        a = e.get("attrs") or {}
        if t == "span" and e.get("kind") == "run":
            for k in ("runner", "rounds"):
                if k in a:
                    progress[k] = a[k]
        elif t == "span" and e.get("kind") == "round":
            n_rounds += 1
            progress.update(round=n_rounds, loss=a.get("loss"),
                            acc=a.get("acc"), comm_gb=a.get("comm_gb"),
                            sim_time_s=a.get("sim_time_s"))
            if isinstance(a.get("loss"), (int, float)):
                trend.append([a.get("rnd", n_rounds - 1), a["loss"]])
    metrics = {}
    for e in events:
        if e.get("type") == "metric":
            lk = tuple(sorted((e.get("labels") or {}).items()))
            key = e["name"] if not lk else \
                f"{e['name']}{{{','.join(f'{k}={v}' for k, v in lk)}}}"
            metrics[key] = e["value"]
    return {"progress": progress, "metrics": metrics,
            "loss_trend": trend[-TREND_CAP:],
            "alerts": H.embedded_alerts(events)[-ALERT_CAP:]}


class LiveServer:
    """Threaded HTTP server publishing tracer state; see module docstring."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._lock = threading.Lock()
        self._text = "\n"
        self._snapshot: dict = {"progress": {}, "metrics": {},
                                "loss_trend": [], "alerts": []}
        self._alerts: list[dict] = []
        self._trend: list[list] = []
        self._last_pub = 0.0
        self._t0 = time.monotonic()
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr lines
                return None

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    with outer._lock:
                        body = outer._text.encode()
                    self._send(200, EXPOSITION_CONTENT_TYPE, body)
                elif path == "/healthz":
                    with outer._lock:
                        payload = {
                            "ok": not outer._alerts,
                            "alerts": list(outer._alerts),
                            "progress": dict(
                                outer._snapshot.get("progress") or {}),
                            "uptime_s": time.monotonic() - outer._t0}
                    self._send(200, "application/json",
                               json.dumps(payload).encode())
                elif path == "/snapshot":
                    with outer._lock:
                        body = json.dumps(outer._snapshot).encode()
                    self._send(200, "application/json", body)
                else:
                    self._send(404, "text/plain", b"not found\n")

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="obs-live-server")
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    # ---- producer side -----------------------------------------------------

    def attach(self, tracer) -> "LiveServer":
        """Wire this server to a tracer: set its ``live`` slot (producers
        publish through it at boundaries) and subscribe to the live event
        stream for alerts and the loss trend.  Subscription happens at
        emission time, before any trace sampling prunes the buffer — the
        live plane always sees the full stream."""
        tracer.live = self
        tracer.subscribe(self._on_event)
        return self

    def _on_event(self, ev: dict) -> None:
        t = ev.get("type")
        if t == "event" and ev.get("name") == "alert":
            with self._lock:
                self._alerts.append(dict(ev.get("attrs") or {}))
                del self._alerts[:-ALERT_CAP]
        elif t == "span" and ev.get("kind") == "round":
            a = ev.get("attrs") or {}
            if isinstance(a.get("loss"), (int, float)):
                with self._lock:
                    self._trend.append([a.get("rnd"), a["loss"]])
                    del self._trend[:-TREND_CAP]

    def publish(self, tracer, progress: dict | None = None,
                min_interval: float = 0.0) -> bool:
        """Render tracer metrics into the served exposition/snapshot.  Called
        by producers at round / engine-step boundaries — never per client,
        never per batch.  ``min_interval`` throttles high-frequency callers
        (the serving engine publishes at most a few times a second)."""
        now = time.monotonic()
        with self._lock:
            if min_interval and now - self._last_pub < min_interval:
                return False
            self._last_pub = now
        text = exposition(tracer.metrics)
        snap = tracer.metrics.snapshot()
        with self._lock:
            self._text = text
            if progress is not None:
                self._snapshot["progress"] = dict(progress)
            self._snapshot["metrics"] = snap
            self._snapshot["loss_trend"] = list(self._trend)
            self._snapshot["alerts"] = list(self._alerts)
        return True

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def serve_live(port: int = 0, host: str = "127.0.0.1") -> LiveServer:
    """Start a LiveServer attached to the active tracer.  Requires tracing
    to be enabled first (``obs.configure``) — the live plane is a view over
    the tracer, and keeping the disabled path at literally zero cost means
    there is nothing to serve without one."""
    from repro_torch.obs import trace as _trace
    tr = _trace.get_tracer()
    if not tr.enabled:
        raise RuntimeError(
            "live telemetry needs an enabled tracer: call obs.configure() "
            "before serve_live()")
    return LiveServer(port=port, host=host).attach(tr)
