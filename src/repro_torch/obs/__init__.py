"""repro_torch.obs — unified observability: span tracing + labeled metrics
(reference: ``repro/obs/__init__.py``).

Stdlib-only (torch is touched lazily and only when tracing is enabled).
One process-wide tracer, disabled by default; the runners, the upload
pipeline, secagg and the serving engine are instrumented against the no-op
tracer's zero-cost surface.

    from repro_torch import obs
    obs.configure(path="trace.jsonl", meta=obs.provenance())
    ...  # run training / serving
    obs.close()                      # writes the JSONL trace

    $ python -m repro_torch.obs summarize trace.jsonl
    $ python -m repro_torch.obs check trace.jsonl --require-kinds run,round \\
          --require-metrics pipeline.up_bytes
    $ python -m repro_torch.obs diff a.jsonl b.jsonl --rel-tol 0.02
    $ python -m repro_torch.obs chrome trace.jsonl      # → Perfetto
    $ python -m repro_torch.obs report trace.jsonl -o report.html
    $ python -m repro_torch.obs regress fresh_BENCH.json BENCH_fedsim.json

Live plane (``--metrics-port`` in the launch CLIs, or ``serve_live()``):

    $ python -m repro_torch.launch.fed_train --metrics-port 9100 ... &
    $ curl -s localhost:9100/metrics       # Prometheus text exposition
    $ python -m repro_torch.obs top http://localhost:9100   # or: top trace.jsonl

See trace.py (spans, wall+sim clocks, lazy device scalars, sampling
hooks), metrics.py (labeled counters/gauges/histograms, label-cardinality
cap), sketch.py (mergeable quantile sketches + seeded reservoirs),
export.py (JSONL / Chrome trace / summarize / check / diff /
rank_trajectory / rollup_summary), record.py (RunRecorder: the runners'
history dict as a view over the trace, rank_alloc events, cohort-scale
trace sampling), health.py (streaming alert detectors), profile.py
(kernel-build and CUDA-graph-capture spans, CUDA memory watermarks),
live.py (/metrics /healthz /snapshot HTTP plane), top.py (ANSI live
viewer), regress.py (bench regression sentinel), report.py (static
HTML/terminal report).
"""

from repro_torch.obs.export import (chrome_trace, check, diff,
                                    provenance, rank_trajectory, read_jsonl,
                                    rollup_summary, summarize, write_jsonl)
from repro_torch.obs.health import HealthMonitor, Thresholds
from repro_torch.obs.health import scan as health_scan
from repro_torch.obs.live import LiveServer, serve_live
from repro_torch.obs.record import RunRecorder
from repro_torch.obs.sketch import Reservoir, Sketch
from repro_torch.obs.trace import (NULL_TRACER, Lazy, NullTracer, Span,
                                   Tracer, annotate, close, configure,
                                   disable, get_tracer)


def get_metrics():
    """The active tracer's metric registry (a no-op registry when
    tracing is disabled)."""
    return get_tracer().metrics


__all__ = [
    "configure", "disable", "close", "get_tracer", "get_metrics",
    "annotate", "Tracer", "NullTracer", "NULL_TRACER", "Span", "Lazy",
    "RunRecorder", "read_jsonl", "write_jsonl", "chrome_trace",
    "summarize", "check", "diff", "provenance", "rank_trajectory",
    "rollup_summary", "HealthMonitor", "Thresholds", "health_scan",
    "LiveServer", "serve_live", "Sketch", "Reservoir",
]
