"""Port parity for ``repro_torch.obs``'s live telemetry plane, case for
case with ``tests/test_obs_live.py``: the Prometheus exposition text of the
same metrics equals the reference's and parses; ``/metrics``, ``/healthz``
and ``/snapshot``; ``obs top`` in file and URL modes.  Then the traced
async run (``buffer_k`` 3, stragglers) against the reference's from the
same bridged weights, and a ``fed_train --metrics-port`` subprocess on the
CPU scraped while it runs (CPU)."""

import io
import json
import os
import re
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from repro.obs import live as JL
from repro.obs import top as JTOP
from repro.obs.metrics import Metrics as JMetrics
from repro_torch import obs
from repro_torch.obs import export as E
from repro_torch.obs import live as L
from repro_torch.obs import top as TOP
from repro_torch.obs.metrics import Metrics
from test_torch_baselines import _one_thread  # noqa: F401 (autouse)
from test_torch_obs import (assert_parity, assert_same_metrics,  # noqa: F401
                            assert_same_trace, port_run, reference_run,
                            setup)

REPO = Path(__file__).resolve().parents[1]
_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_SAMPLE = re.compile(
    rf"^(?P<name>{_NAME})(?:\{{(?P<labels>[^}}]*)\}})? (?P<value>\S+)$")
_TYPE = re.compile(rf"^# TYPE (?P<name>{_NAME}) "
                   r"(?P<type>counter|gauge|summary|histogram|untyped)$")
_LABEL = re.compile(rf'^{_NAME}="(?:[^"\\]|\\.)*"$')


def parse_exposition(text: str) -> dict:
    """Minimal Prometheus text v0.0.4 parser (``tests/test_obs_live.py``'s):
    ``{family: {"type": t, "samples": [(name, labels, value)]}}``; raises
    AssertionError on any malformed line."""
    families: dict = {}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            m = _TYPE.match(line)
            assert m, f"line {ln}: bad comment/TYPE line: {line!r}"
            assert m.group("name") not in families, f"line {ln}: duplicate"
            families[m.group("name")] = {"type": m.group("type"),
                                         "samples": []}
            continue
        m = _SAMPLE.match(line)
        assert m, f"line {ln}: bad sample line: {line!r}"
        name = fam = m.group("name")
        for suffix in ("_sum", "_count", "_bucket"):
            if name.endswith(suffix) and name[:-len(suffix)] in families:
                fam = name[:-len(suffix)]
        assert fam in families, f"line {ln}: sample before TYPE: {line!r}"
        labels = {}
        if m.group("labels"):
            for pair in re.split(r",(?=[a-zA-Z_])", m.group("labels")):
                assert _LABEL.match(pair), f"line {ln}: bad label {pair!r}"
                k, v = pair.split("=", 1)
                labels[k] = v[1:-1]
        val = m.group("value")
        families[fam]["samples"].append(
            (name, labels, float(val) if val != "NaN" else None))
    return families


def _sample_metrics(cls):
    m = cls()
    m.counter("pipeline.up_bytes", codec="signsgd", stage="stage2").inc(512)
    m.counter("pipeline.up_bytes", codec="int8", stage="stage2").inc(256)
    m.gauge("dp.epsilon").set(1.25)
    for i in range(1, 101):
        m.histogram("serve.step_s").observe(i / 1000.0)
    return m


def _exposition(ops):
    m, jm = Metrics(), JMetrics()
    ops(m)
    ops(jm)
    text = L.exposition(m)
    assert text == JL.exposition(jm)
    return parse_exposition(text)


def test_exposition_is_valid_and_complete():
    text = L.exposition(_sample_metrics(Metrics))
    assert text == JL.exposition(_sample_metrics(JMetrics))
    fams = parse_exposition(text)
    up = fams["pipeline_up_bytes"]
    assert up["type"] == "counter"
    assert {s[1].get("codec") for s in up["samples"]} == {"signsgd", "int8"}
    assert sum(s[2] for s in up["samples"]) == 768
    assert fams["dp_epsilon"]["samples"][0][2] == 1.25
    step = fams["serve_step_s"]
    assert step["type"] == "summary"
    quants = {s[1]["quantile"]: s[2] for s in step["samples"]
              if "quantile" in s[1]}
    assert set(quants) == {"0.5", "0.9", "0.95", "0.99"}
    assert quants["0.5"] == pytest.approx(0.0505, rel=0.02)
    assert [s[2] for s in step["samples"]
            if s[0] == "serve_step_s_count"] == [100]


def test_exposition_empty_registry():
    assert _exposition(lambda m: None) == {}


def test_exposition_escapes_label_values():
    fams = _exposition(lambda m: m.counter("c", path='a"b\\c').inc())
    ((_, _, v),) = fams["c"]["samples"]
    assert v == 1


def _get(url, timeout=5):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def test_live_server_endpoints(tmp_path):
    try:
        tr = obs.configure(str(tmp_path / "t.jsonl"), profile=False)
        live = obs.serve_live()
        try:
            tr.metrics.counter("rounds.total").inc(3)
            tr.metrics.histogram("serve.step_s").observe(0.01)
            live.publish(tr, progress={"round": 3, "rounds": 10,
                                       "loss": 0.5})
            code, ctype, body = _get(live.url + "/metrics")
            assert code == 200 and ctype == L.EXPOSITION_CONTENT_TYPE \
                == JL.EXPOSITION_CONTENT_TYPE
            fams = parse_exposition(body.decode())
            assert fams["rounds_total"]["samples"][0][2] == 3
            code, ctype, body = _get(live.url + "/healthz")
            hz = json.loads(body)
            assert code == 200 and ctype == "application/json"
            assert hz["ok"] is True and hz["alerts"] == []
            assert hz["progress"]["round"] == 3 and hz["uptime_s"] >= 0
            code, _, body = _get(live.url + "/snapshot")
            snap = json.loads(body)
            assert snap["progress"]["loss"] == 0.5
            assert snap["metrics"]["rounds.total"] == 3
            assert _get(live.url + "/nope")[0] == 404
        finally:
            live.stop()
    finally:
        obs.disable()


def test_live_server_sees_alerts_and_round_trend(tmp_path):
    try:
        tr = obs.configure(str(tmp_path / "t.jsonl"), health=False,
                           profile=False)
        live = obs.serve_live()
        try:
            sp = tr.begin("round", kind="round", rnd=0)
            sp.end(down_bytes=1, up_bytes=1, sim_time_s=0.0, loss=2.0)
            tr.event("alert", alert="nan_loss", rnd=0)
            live.publish(tr)
            hz = json.loads(_get(live.url + "/healthz")[2])
            assert hz["ok"] is False
            assert hz["alerts"][0]["alert"] == "nan_loss"
            snap = json.loads(_get(live.url + "/snapshot")[2])
            assert snap["loss_trend"] == [[0, 2.0]]
        finally:
            live.stop()
    finally:
        obs.disable()


def test_publish_throttle():
    try:
        tr = obs.configure(None, health=False, profile=False)
        live = L.LiveServer()
        try:
            live.attach(tr)
            assert live.publish(tr, min_interval=30.0) is True
            assert live.publish(tr, min_interval=30.0) is False
            assert live.publish(tr) is True
        finally:
            live.stop()
    finally:
        obs.disable()


def test_serve_live_requires_enabled_tracer():
    obs.disable()
    with pytest.raises(RuntimeError):
        obs.serve_live()


def test_null_tracer_has_no_live_cost_surface():
    obs.disable()
    tr = obs.get_tracer()
    assert tr.live is None and tr.client_sample is None


def _write_trace(mod, path):
    try:
        tr = mod.configure(path, health=False, profile=False)
        run = tr.begin("run", kind="run", runner="cohort", rounds=2)
        for rnd in range(2):
            sp = tr.begin("round", kind="round", rnd=rnd)
            sp.end(down_bytes=100, up_bytes=200, sim_time_s=float(rnd + 1),
                   comm_gb=(rnd + 1) * 3e-7, loss=2.0 - rnd, acc=0.5)
        tr.metrics.counter("pipeline.up_bytes", codec="signsgd",
                           stage="stage2").inc(400)
        tr.metrics.histogram("serve.step_s").observe(0.02)
        run.end()
        mod.close()
    finally:
        mod.disable()
    return path


def _strip_uptime(snap):
    return {k: v for k, v in snap.items() if k not in ("uptime_s", "t")}


def test_top_file_mode_renders(tmp_path):
    from repro import obs as jobs
    path = _write_trace(obs, str(tmp_path / "run.jsonl"))
    jpath = _write_trace(jobs, str(tmp_path / "ref.jsonl"))
    snap = TOP.fetch(path)
    assert _strip_uptime(snap) == _strip_uptime(JTOP.fetch(jpath))
    frame = TOP.render(snap)
    assert "round 2/2" in frame and "loss trend" in frame
    assert "signsgd" in frame and "p99" in frame
    assert "alerts: none" in frame
    line = TOP.render_line(snap)
    assert "round=2/2" in line and "loss=1" in line
    out = io.StringIO()
    assert TOP.run(path, refresh=0.01, iterations=2, out=out) == 0
    lines = [ln for ln in out.getvalue().splitlines() if ln]
    assert len(lines) == 2 and all("round=2/2" in ln for ln in lines)
    ansi = io.StringIO()
    assert TOP.run(path, refresh=0.01, iterations=1, ansi=True,
                   out=ansi) == 0
    assert ansi.getvalue().startswith("\x1b[H\x1b[J")


def test_top_url_mode(tmp_path):
    try:
        tr = obs.configure(str(tmp_path / "t.jsonl"), health=False,
                           profile=False)
        live = obs.serve_live()
        try:
            tr.metrics.counter("rounds.total").inc()
            live.publish(tr, progress={"round": 1, "rounds": 4,
                                       "loss": 1.5})
            assert TOP.fetch(live.url)["progress"]["round"] == 1
            out = io.StringIO()
            assert TOP.run(live.url, refresh=0.01, iterations=1,
                           out=out) == 0
            assert "round=1/4" in out.getvalue()
        finally:
            live.stop()
    finally:
        obs.disable()


def test_top_unreachable_source_exits_nonzero(tmp_path):
    assert TOP.run(str(tmp_path / "nope.jsonl"), refresh=0.0, iterations=5,
                   out=io.StringIO()) == 1


def test_top_cli_subcommand(tmp_path, capsys):
    from repro_torch.obs.__main__ import main as obs_main
    path = _write_trace(obs, str(tmp_path / "run.jsonl"))
    assert obs_main(["top", path, "-n", "1", "--no-ansi"]) == 0
    assert "round=2/2" in capsys.readouterr().out


def test_sparkline():
    for vals in ([], [1.0], [1, 2, 3, 4, 5, 6, 7, 8], [3, 1, 2]):
        assert TOP.sparkline(vals) == JTOP.sparkline(vals)
    s = TOP.sparkline([1, 2, 3, 4, 5, 6, 7, 8])
    assert s[0] == TOP.SPARK[0] and s[-1] == TOP.SPARK[-1]


# ---- the reference's traced async run ---------------------------------------

ASYNC_KW = dict(runner="async", buffer_k=3, straggler=0.25)


def test_traced_async_run_parity(setup, tmp_path):  # noqa: F811
    """Round spans and the trailing ``inflight_comm`` event reproduce
    ``comm_gb`` exactly; every history event is mirrored into the trace;
    the trace is the reference's."""
    want, jev, params = reference_run(setup, str(tmp_path / "ref.jsonl"),
                                      **ASYNC_KW)
    h, events = port_run(setup, str(tmp_path / "port.jsonl"), params,
                         **ASYNC_KW)
    assert E.check(events, require_kinds=["run", "round"]) == []
    assert_parity(h, E.summarize(events))
    assert all(ev["type"] == "event" and "sim_t" in ev
               for ev in h["events"])
    traced = [e for e in events if e.get("type") == "event"
              and e.get("name") in ("dispatch", "update")]
    assert len(traced) == len(h["events"])
    assert [{k: e[k] for k in ("type", "name", "sim_t", "attrs")}
            for e in traced] == h["events"] == want["events"]
    assert [e for e in events if e.get("name") == "inflight_comm"]
    assert_same_trace(events, jev)
    assert_same_metrics(events, jev)


# ---- fed_train --metrics-port, scraped while it runs ------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_fed_train_metrics_port_smoke(tmp_path):
    """``fed_train --device cpu --trace --metrics-port`` on a free port:
    ``/metrics`` parses and carries nonzero counters while the run lasts,
    ``/healthz`` has ``progress``, the process exits 0, and the trace it
    writes summarizes to the totals it prints."""
    trace = str(tmp_path / "fed.jsonl")
    # one thread for torch and BLAS, as the in-process runs here take
    # (``_one_thread``): tier-1's parallel workers share the cores
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.fed_train",
         "--device", "cpu", "--strategy", "fedlora", "--rounds", "4",
         "--clients", "4", "--clients-per-round", "2", "--runner", "seq",
         "--codec", "int8", "--trace", trace, "--metrics-port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=str(tmp_path))
    scraped = {}
    try:
        url = f"http://127.0.0.1:{port}"
        deadline = time.time() + 300
        while time.time() < deadline and proc.poll() is None:
            try:
                _, ctype, body = _get(url + "/metrics", timeout=2)
                fams = parse_exposition(body.decode())
                if any("pipeline" in f for f in fams):
                    scraped = {"metrics": fams, "ctype": ctype,
                               "healthz": json.loads(
                                   _get(url + "/healthz", timeout=2)[2])}
                    break
            except OSError:
                pass
            time.sleep(0.05)
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-3000:]
    assert scraped, "never scraped a populated /metrics mid-run:\n" + \
        out[-3000:]
    assert scraped["ctype"] == L.EXPOSITION_CONTENT_TYPE
    up = scraped["metrics"]["pipeline_up_bytes"]["samples"]
    assert any(s[1].get("codec") == "int8" and s[2] > 0 for s in up)
    assert "progress" in scraped["healthz"]
    assert "final acc" in out and f"trace written to {trace}" in out
    s = E.summarize(E.read_jsonl(trace))
    assert s["n_rounds"] == 4
    total_mb = float(re.search(r"total comm ([0-9.]+) MB", out).group(1))
    assert round(s["comm_gb"] * 1e3, 1) == total_mb
