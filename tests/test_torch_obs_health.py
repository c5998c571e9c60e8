"""Port parity for ``repro_torch.obs``'s health detectors, bench regression
sentinel, forensics report and compile accounting, case for case with
``tests/test_obs_health.py``: each synthetic trace goes through both
packages and the outputs must be equal, with the reference's exact
payloads.  The regress cases build their bench JSON in ``tmp_path``.  The
port's compile stages (``nvcc`` kernel builds, ``graph_capture``) are
checked over synthetic ``compile`` spans, as the card makes them.  Then
the reference's traced 3-round FedARA cohort run against the port's from
the same bridged weights: the same trace, the rank trajectory, no alert
(CPU)."""

import json
import math

import pytest

from repro.obs import export as JE
from repro.obs import health as JH
from repro.obs import profile as JP
from repro.obs import regress as JR
from repro.obs import report as JREP
from repro.obs.__main__ import main as jobs_main
from repro_torch import obs
from repro_torch.obs import export as E
from repro_torch.obs import health as H
from repro_torch.obs import profile as P
from repro_torch.obs import regress as R
from repro_torch.obs import report as REP
from repro_torch.obs.__main__ import main as obs_main
from test_torch_baselines import _one_thread  # noqa: F401 (autouse)
from test_torch_obs import (assert_parity, assert_same_metrics,  # noqa: F401
                            assert_same_trace, port_run, reference_run,
                            setup)


def _meta():
    return {"type": "meta", "schema": 1, "t_epoch": 0.0, "meta": {}}


def _round(rnd, **attrs):
    return {"type": "span", "id": 100 + rnd, "parent": None, "name": "round",
            "kind": "round", "t0": float(rnd), "dur": 1.0,
            "sim_t0": 0.0, "sim_dur": 0.0, "attrs": {"rnd": rnd, **attrs}}


def _secagg(rnd, **attrs):
    return {"type": "span", "id": 200 + rnd, "parent": None, "name": "secagg",
            "kind": "secagg", "t0": float(rnd), "dur": 0.1,
            "sim_t0": 0.0, "sim_dur": 0.0, "attrs": {"rnd": rnd, **attrs}}


def _event(name, **attrs):
    return {"type": "event", "name": name, "t": 0.0, "sim_t": 0.0,
            "attrs": attrs}


def _span(sid, parent, name, kind, dur, **attrs):
    return {"type": "span", "id": sid, "parent": parent, "name": name,
            "kind": kind, "t0": 0.0, "dur": dur, "sim_t0": 0.0,
            "sim_dur": 0.0, "attrs": attrs}


def _scan(tmp_path, events):
    """Both packages' offline scan of the JSONL round trip; equal."""
    p = str(tmp_path / "trace.jsonl")
    E.write_jsonl(p, [_meta()] + events)
    got = H.scan(E.read_jsonl(p))
    want = JH.scan(JE.read_jsonl(p))
    assert json.dumps(got, sort_keys=True) == \
        json.dumps(want, sort_keys=True)
    return got


# ---- detectors: exact payloads -------------------------------------------

def test_nan_loss_alert(tmp_path):
    alerts = _scan(tmp_path, [_round(0, loss=1.0),
                              _round(1, loss=float("nan"))])
    assert len(alerts) == 1
    a = alerts[0]
    assert a["alert"] == "nan_loss" and a["rnd"] == 1
    assert math.isnan(a["loss"])


@pytest.mark.parametrize("rounds,want", [
    ([(0, 1.0), (1, 0.8), (2, 3.0)],
     [{"alert": "loss_divergence", "rnd": 2, "loss": 3.0, "best": 0.8}]),
    ([(0, 1.0), (1, 9.0)], []),              # needs min rounds on record
])
def test_loss_divergence(tmp_path, rounds, want):
    assert _scan(tmp_path, [_round(r, loss=v) for r, v in rounds]) == want


def test_straggler_skew_alert(tmp_path):
    assert _scan(tmp_path, [_round(0, loss=1.0, cost_max=8.0,
                                   cost_med=1.0)]) == [
        {"alert": "straggler_skew", "rnd": 0, "cost_max": 8.0,
         "cost_med": 1.0, "ratio": 8.0}]


def test_secagg_abort_and_dropout_skew(tmp_path):
    assert _scan(tmp_path, [
        _secagg(0, participants=4, n_dropped=1),
        _secagg(1, participants=4, n_dropped=2),
        _secagg(2, participants=4, n_dropped=3, aborted=True)]) == [
        {"alert": "dropout_skew", "rnd": 1, "n_dropped": 2,
         "participants": 4, "frac": 0.5},
        {"alert": "secagg_abort", "rnd": 2, "n_dropped": 3,
         "participants": 4}]


def test_rank_collapse_fires_once_until_revived(tmp_path):
    mod = "dec.layers.0.attn.wq"
    live = [4, 0, 0, 2, 0]
    alerts = _scan(tmp_path, [
        _event("rank_alloc", rnd=r, modules={mod: {"live": n, "total": 12}})
        for r, n in enumerate(live)])
    assert alerts == [
        {"alert": "rank_collapse", "rnd": 1, "module": mod, "total": 12},
        {"alert": "rank_collapse", "rnd": 4, "module": mod, "total": 12}]


def test_ef_blowup_alert_once_per_client(tmp_path):
    warm = [_event("encode", cid=c, ef_norm=1.0) for c in range(8)]
    assert _scan(tmp_path, warm + [
        _event("encode", cid=5, ef_norm=20.0),
        _event("encode", cid=5, ef_norm=30.0),
        _event("encode", cid=6, ef_norm=0.9)]) == [
        {"alert": "ef_blowup", "cid": 5, "ef_norm": 20.0, "baseline": 1.0}]


def test_client_drift_alert(tmp_path):
    assert _scan(tmp_path, [
        _event("drift", n=4, mean_cos=0.5, dispersion=0.5),
        _event("drift", n=4, mean_cos=0.02, dispersion=0.98)]) == [
        {"alert": "client_drift", "rnd": None, "dispersion": 0.98, "n": 4}]


def test_scan_skips_embedded_alerts(tmp_path):
    evs = [_round(0, loss=float("nan")),
           _event("alert", alert="nan_loss", rnd=0, loss=None)]
    alerts = _scan(tmp_path, evs)
    assert len(alerts) == 1 and alerts[0]["alert"] == "nan_loss"
    p = str(tmp_path / "emb.jsonl")
    E.write_jsonl(p, [_meta()] + evs)
    assert H.embedded_alerts(E.read_jsonl(p)) == \
        JH.embedded_alerts(JE.read_jsonl(p)) == \
        [{"alert": "nan_loss", "rnd": 0, "loss": None}]


def test_live_attach_mirrors_scan():
    try:
        tr = obs.configure(None, health=True, profile=False)
        rsp = tr.begin("round", kind="round", rnd=0)
        rsp.end(loss=float("inf"), down_bytes=0, up_bytes=0, sim_time_s=0.0)
        evs = tr.events()
    finally:
        obs.disable()
    emb = H.embedded_alerts(evs)
    assert len(emb) == 1 and emb[0]["alert"] == "nan_loss"
    assert H.scan(evs) == emb == JH.scan(evs)
    assert H.Thresholds() == H.Thresholds(**vars(JH.Thresholds()))


# ---- regress --------------------------------------------------------------

def _mini_bench():
    return {
        "ndev": 2,
        "rows": [{"cpr": 4, "seq_round_s": [1.0, 1.1, 0.9],
                  "cohort_round_s": [0.5, 0.55, 0.45],
                  "seq_samples": 3, "cohort_samples": 3,
                  "noisy": False, "speedup": 2.0},
                 {"cpr": 8, "seq_round_s": [2.0], "cohort_round_s": [1.0],
                  "noisy": True, "speedup": 2.0}],
        "codec": {"identity": 1000, "topk": 120},
        "convergence": {"fedlora": [[100, 2.0], [200, 1.5]]},
        "async": {"wall_s": 3.0, "events": 50, "mean_staleness": 1.2},
    }


def _compare(fresh, committed):
    got = R.compare(fresh, committed)
    assert got == JR.compare(fresh, committed)
    return got


def test_regress_self_compare_passes():
    res = _compare(_mini_bench(), _mini_bench())
    assert res["ok"] and res["failures"] == [] and res["checked"]


def test_regress_catches_median_slowdown():
    fresh = _mini_bench()
    fresh["rows"][0]["cohort_round_s"] = [1.0, 1.1, 0.9]
    res = _compare(fresh, _mini_bench())
    assert not res["ok"]
    assert any("cohort_round_s" in f["key"] for f in res["failures"])


@pytest.mark.parametrize("speedup,ok", [(10.0, True), (0.5, False)])
def test_regress_speedup_is_one_sided(speedup, ok):
    fresh = _mini_bench()
    fresh["rows"][0]["speedup"] = speedup
    res = _compare(fresh, _mini_bench())
    assert res["ok"] is ok
    if not ok:
        assert any("speedup" in f["key"] for f in res["failures"])


def test_regress_missing_and_extra_keys_never_fail():
    fresh = _mini_bench()
    del fresh["async"]
    fresh["rows"] = fresh["rows"][:1]
    committed = _mini_bench()
    committed["extra_section"] = {"x_s": 1.0}
    res = _compare(fresh, committed)
    assert res["ok"] and res["only_committed"]


def test_regress_noisy_and_info_keys_are_informational():
    fresh = _mini_bench()
    fresh["rows"][1]["cohort_round_s"] = [99.0]
    fresh["async"]["wall_s"] = 99.0
    assert _compare(fresh, _mini_bench())["ok"]


@pytest.mark.parametrize("key,cls", [
    ("rows.cpr4.cohort_round_s", "time"), ("rows.cpr4.speedup", "speedup"),
    ("codec.topk", "bytes"), ("convergence.fedlora.loss1", "metric"),
    ("async.wall_s", "info"), ("rows.cpr4.seq_samples", "info")])
def test_regress_classify(key, cls):
    assert R.classify(key) == JR.classify(key) == cls


def test_regress_cli_on_a_bench_file(tmp_path, capsys):
    """The CLI against a bench JSON written here: a self-compare passes
    (text and JSON), a 2x slowdown fails, as in the reference."""
    bench = str(tmp_path / "BENCH_mini.json")
    json.dump(_mini_bench(), open(bench, "w"))
    assert obs_main(["regress", bench, bench]) == 0
    out = capsys.readouterr().out
    assert jobs_main(["regress", bench, bench]) == 0
    assert capsys.readouterr().out == out and "RESULT: PASS" in out
    assert obs_main(["regress", bench, bench, "--format", "json"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["ok"] and res["failures"] == []
    slow = _mini_bench()
    for row in slow["rows"]:
        row["cohort_round_s"] = [2 * x for x in row["cohort_round_s"]]
    slow_p = str(tmp_path / "slow.json")
    json.dump(slow, open(slow_p, "w"))
    assert obs_main(["regress", slow_p, bench]) == 1
    assert "RESULT: REGRESSION" in capsys.readouterr().out


# ---- report and self-times -------------------------------------------------

def _report_events():
    mod_a, mod_b = "dec.layers.0.attn.wq", "dec.layers.0.attn.wv"
    return [
        _round(0, loss=1.0, down_bytes=10, up_bytes=20, sim_time_s=1.0),
        _round(1, loss=float("nan"), down_bytes=10, up_bytes=20,
               sim_time_s=1.0),
        _event("rank_alloc", rnd=0, live=10, total=24,
               modules={mod_a: {"live": 6, "total": 12},
                        mod_b: {"live": 4, "total": 12}}),
        _event("rank_alloc", rnd=1, live=6, total=24,
               modules={mod_a: {"live": 6, "total": 12},
                        mod_b: {"live": 0, "total": 12}}),
        _event("module_pruned", rnd=1, module=mod_b),
        _span(300, None, "backend_compile", "compile", 1.5),
        {"type": "metric", "metric": "counter", "name": "pipeline.up_bytes",
         "labels": {"codec": "topk", "stage": "stage2"}, "value": 1234},
    ]


def _report(path):
    rep = REP.build_report(E.read_jsonl(path))
    jrep = JREP.build_report(JE.read_jsonl(path))
    assert json.dumps(rep, sort_keys=True, default=repr) == \
        json.dumps(jrep, sort_keys=True, default=repr)
    assert REP.render_text(rep) == JREP.render_text(jrep)
    return rep


def test_report_build_and_render(tmp_path):
    p = str(tmp_path / "rep.jsonl")
    E.write_jsonl(p, [_meta()] + _report_events())
    rep = _report(p)
    assert rep["trajectory"]["rounds"] == [0, 1]
    assert rep["trajectory"]["pruned"] == [{"rnd": 1,
                                            "module": "dec.layers.0.attn.wv"}]
    assert any(b["codec"] == "topk" and b["up"] == 1234
               for b in rep["bytes_by"])
    assert any(a["alert"] == "nan_loss" for a in rep["alerts"])
    assert rep["compiles"]["n"] == 1
    txt = REP.render_text(rep)
    assert "dec.layers.0.attn.wv" in txt and "×" in txt
    html = REP.render_html(rep)
    assert html.lstrip().lower().startswith("<!doctype html>")
    assert "nan_loss" in html


def test_self_times_attribution(tmp_path):
    events = [_span(1, None, "round", "round", 10.0, rnd=0),
              _span(2, 1, "cohort_step", "dispatch", 6.0),
              _span(3, 2, "backend_compile", "compile", 2.0)]
    p = str(tmp_path / "st.jsonl")
    E.write_jsonl(p, [_meta()] + events)
    st = P.self_times(E.read_jsonl(p))
    assert st == JP.self_times(JE.read_jsonl(p))
    assert "compile/backend_compile" not in st
    assert st["round/round"] == {"n": 1, "total_s": 10.0, "self_s": 4.0,
                                 "compile_s": 0.0}
    assert st["dispatch/cohort_step"] == {"n": 1, "total_s": 6.0,
                                          "self_s": 4.0, "compile_s": 2.0}
    rep = _report(p)
    assert rep["self_times"] == st
    assert "device time by span" in REP.render_text(rep)


def test_report_cli_writes_html(tmp_path, capsys):
    p = str(tmp_path / "rep.jsonl")
    E.write_jsonl(p, [_meta()] + _report_events())
    out = str(tmp_path / "rep.html")
    assert obs_main(["report", p, "-o", out]) == 0
    assert open(out).read().lstrip().lower().startswith("<!doctype html>")
    capsys.readouterr()
    assert obs_main(["report", p]) == 0
    assert "dec.layers.0.attn.wq" in capsys.readouterr().out


# ---- the port's compile stages: synthetic nvcc / capture spans -------------

def _compile_events():
    """What a traced card run records: the kernels built during setup, a
    fused run whose block (dispatch with ``rnd``) captured the round, an
    eval that captured nothing, and a round-1 rebuild."""
    return [
        _span(1, None, "nvcc", "compile", 30.0, stage="nvcc",
              lib="bea_fused"),
        _span(2, None, "nvcc", "compile", 35.0, stage="nvcc",
              lib="bea_batched"),
        _span(10, None, "run", "run", 9.0),
        _span(11, 10, "cohort_dispatch", "dispatch", 2.0, fused=4, rnd=0,
              sig="float32[3,8,128]"),
        _span(12, 11, "graph_capture", "compile", 0.5, stage="graph_capture",
              launches={"bea_dense_grouped": 144}),
        _span(13, 10, "round", "round", 0.1, rnd=0),
        _span(14, 10, "cohort_dispatch", "dispatch", 1.0, fused=4, rnd=4),
        _span(15, 10, "round", "round", 0.1, rnd=4),
        _span(16, 15, "evaluate", "eval", 0.2, task="cls"),
        _span(17, None, "round", "round", 0.3, rnd=5),
        _span(18, 17, "nvcc", "compile", 1.0, stage="nvcc", lib="flash"),
    ]


def test_compile_stats_over_the_ports_stages():
    cs = P.compile_stats(_compile_events())
    assert cs["by_stage"] == {"nvcc": 3, "graph_capture": 1}
    assert cs["n"] == 4 and cs["setup"] == 2
    assert cs["by_round"] == {0: 1, 5: 1}
    assert cs["after_first_round"] == 1
    assert cs["by_signature"] == {"float32[3,8,128]": 1}
    assert cs["total_s"] == 66.5
    # a reference trace's stages count as the reference counts them
    ref = [e for e in _report_events() if e.get("type") == "span"] + [
        _span(301, 300, "jaxpr_trace", "compile", 0.5)]
    assert P.compile_stats(ref) == JP.compile_stats(ref)


def test_compile_spans_follow_the_open_span_and_the_profile_switch():
    try:
        tr = obs.configure(None, health=False)
        with tr.span("cohort_dispatch", kind="dispatch", rnd=0):
            P.compile_span("graph_capture", 0.25, launches={"x": 3})
        P.compile_span("nvcc", 2.0, lib="bea_fused")
        evs = tr.close()
    finally:
        obs.disable()
    cap, nv = [e for e in evs if e.get("kind") == "compile"]
    dsp = next(e for e in evs if e.get("kind") == "dispatch")
    assert cap["parent"] == dsp["id"] and cap["attrs"]["launches"] == \
        {"x": 3}
    assert nv["parent"] is None and nv["dur"] == 2.0
    assert P.compile_stats(evs)["by_round"] == {0: 1}
    counts = {e["labels"]["stage"]: e["value"] for e in evs
              if e.get("name") == "profile.compiles"}
    assert counts == {"graph_capture": 1, "nvcc": 1}
    try:
        tr = obs.configure(None, health=False, profile=False)
        assert P.compile_span("nvcc", 1.0) is None
        assert tr.close()[1:] == []
    finally:
        obs.disable()
    assert P.compile_span("nvcc", 1.0) is None          # tracing off


def test_memory_sample_records_nothing_without_a_cuda_context():
    try:
        tr = obs.configure(None, health=False)
        assert P.sample_memory(tr) is None
        assert tr.events()[1:] == []
    finally:
        obs.disable()
    assert P.sample_memory(obs.get_tracer()) is None


def test_shape_signature_over_tensors_and_arrays():
    import numpy as np
    import torch
    sig = P.shape_signature({"a": torch.zeros(3, 8, dtype=torch.float32),
                             "b": [torch.zeros(3, 8), np.zeros(2, np.int32)]},
                            np.ones(4, bool))
    assert sig == "bool[4];float32[3,8]x2;int32[2]"
    jsig = JP.shape_signature({"a": np.zeros((3, 8), np.float32),
                               "b": [np.zeros((3, 8), np.float32),
                                     np.zeros(2, np.int32)]},
                              np.ones(4, bool))
    assert sig == jsig


# ---- graceful degradation and check ----------------------------------------

def test_cli_graceful_on_empty_and_spanless_traces(tmp_path, capsys):
    empty = str(tmp_path / "empty.jsonl")
    E.write_jsonl(empty, [_meta()])
    spanless = str(tmp_path / "spanless.jsonl")
    E.write_jsonl(spanless, [_meta(), _event("dispatch", cid=0)])
    for p in (empty, spanless):
        assert obs_main(["summarize", p, "--format", "json"]) == 0
        s = json.loads(capsys.readouterr().out)
        assert s["n_rounds"] == 0
        assert s == JE.summarize(JE.read_jsonl(p))
        assert obs_main(["report", p]) == 0
        capsys.readouterr()
        assert obs_main(["chrome", p, "-o", str(tmp_path / "ct.json")]) == 0
        capsys.readouterr()
    assert obs_main(["check", spanless, "--require-kinds", "round"]) == 1
    capsys.readouterr()


def test_check_require_metrics(tmp_path, capsys):
    p = str(tmp_path / "m.jsonl")
    E.write_jsonl(p, [_meta(), _round(0, loss=1.0, down_bytes=0, up_bytes=0,
                                      sim_time_s=0.0),
                      {"type": "metric", "metric": "counter",
                       "name": "pipeline.up_bytes",
                       "labels": {"codec": "topk"}, "value": 7}])
    assert obs_main(["check", p, "--require-metrics",
                     "pipeline.up_bytes"]) == 0
    capsys.readouterr()
    assert obs_main(["check", p, "--require-metrics",
                     "pipeline.up_bytes,serve.step_s"]) == 1
    assert "serve.step_s" in capsys.readouterr().err


# ---- forensics over the reference's 3-round FedARA cohort run ---------------

@pytest.fixture(scope="module")
def fedara_runs(setup, tmp_path_factory):  # noqa: F811
    d = tmp_path_factory.mktemp("fedara")
    kw = dict(runner="cohort", strategy="fedara", rounds=3)
    want, jev, params = reference_run(setup, str(d / "ref.jsonl"), **kw)
    h, events = port_run(setup, str(d / "port.jsonl"), params, **kw)
    return h, events, want, jev


def test_fedara_trace_matches_the_reference(fedara_runs):
    h, events, want, jev = fedara_runs
    assert E.check(events, require_kinds=["run", "round", "client",
                                          "dispatch", "pipeline"]) == []
    assert_parity(h, E.summarize(events))
    assert_same_trace(events, jev)
    assert_same_metrics(events, jev)


def test_compile_flat_after_first_round(fedara_runs):
    """The reference pins zero XLA compiles after round 0; the port's CPU
    run builds no kernel and captures no graph, so no compile span is in
    any round (``tests/test_torch_cuda.py`` counts them on the card)."""
    _, events, _, jev = fedara_runs
    cs = P.compile_stats(events)
    assert cs["after_first_round"] == 0 == \
        JP.compile_stats(jev)["after_first_round"]
    assert cs["by_stage"] == {} and cs["n"] == 0


def test_rank_trajectory_reconstructs_history(fedara_runs):
    h, events, want, jev = fedara_runs
    traj = E.rank_trajectory(events)
    assert traj["live"] == {lg.rnd: lg.live_ranks for lg in h["rounds"]}
    assert traj["live"] == JE.rank_trajectory(jev)["live"]
    assert traj["total"] >= max(traj["live"].values())
    for per_round in traj["modules"].values():
        assert set(per_round) <= set(traj["rounds"])
    s = E.summarize(events)
    assert s["ranks"]["rounds"] == len(h["rounds"])
    assert s["ranks"]["final_live"] == h["rounds"][-1].live_ranks
    assert s["ranks"] == JE.summarize(jev)["ranks"]


def test_clean_run_emits_no_alerts(fedara_runs):
    _, events, _, _ = fedara_runs
    assert H.embedded_alerts(events) == []
    assert H.scan(events) == []
    assert E.summarize(events)["alerts"] == {"n": 0, "by_type": {}}


def test_memory_watermark_events_absent_on_the_cpu(fedara_runs):
    """Round ends sample the card's allocator; a CPU run has no CUDA
    context and records no ``memory`` event (the card's case is in
    ``tests/test_torch_cuda.py``)."""
    _, events, _, _ = fedara_runs
    assert [e for e in events if e.get("name") == "memory"] == []
