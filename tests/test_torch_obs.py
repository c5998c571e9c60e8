"""Port parity for ``repro_torch.obs``, case for case with
``tests/test_obs.py``: the tracer core, metrics, the export goldens and
the CLI run the same operations and event lists through both packages and
must give equal outputs; then the trace-parity acceptance contract on the
port's own runners — each traced run's ``summarize`` equals its history
exactly — and the reference's traced cohort run (MINI with 1 layer,
``--secagg mask --codec signsgd`` with dropout) against the port's from
the same bridged weights: span and event counts per (kind, name) equal,
round, client, secagg, secagg-phase and pipeline attributes exact, the
encode and drift events' integers exact and their float norms within the
whole-run loss tolerance (CPU).

``tests/test_torch_obs_health.py`` (the 3-round FedARA cohort run) and
``tests/test_torch_obs_live.py`` (the async run) reuse the whole-run
helpers here.

Tracing is process-global state; every test that enables it restores the
null tracer in a ``finally``."""

import collections
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs.distilbert import MINI as JMINI
from repro.data import synthetic as JDATA
from repro.federated import baselines as JBL
from repro.federated import partition as JPART
from repro.federated import server as JSRV
from repro.models import Model as JaxModel
from repro.obs import export as JE
from repro.obs.__main__ import main as jobs_main
from repro_torch import obs
from repro_torch.bridge import from_jax
from repro_torch.configs.distilbert import MINI
from repro_torch.data import synthetic as DATA
from repro_torch.federated import baselines as BL
from repro_torch.federated import server as SRV
from repro_torch.models import Model
from repro_torch.obs import export as E
from repro_torch.obs.__main__ import main as obs_main
from repro_torch.obs.metrics import NULL_METRICS, SAMPLE_CAP, Metrics
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER
from test_torch_baselines import _one_thread  # noqa: F401 (autouse)

LOSS_RTOL = 1e-3             # whole-run losses, the port's tolerance
TIMING = ("t", "t0", "dur", "t_epoch", "wall_s")


def _untimed(ev):
    """An event without its wall-clock fields (a rollup's sketch of the
    client spans' durations too, and a meta without the provenance, which
    names each package's framework)."""
    out = {k: v for k, v in ev.items() if k not in TIMING}
    if "attrs" in out:
        out["attrs"] = {k: v for k, v in out["attrs"].items()
                        if k not in TIMING}
        if "sketches" in out["attrs"]:
            out["attrs"]["sketches"] = {
                k: v for k, v in out["attrs"]["sketches"].items()
                if k not in TIMING}
    if out.get("type") == "meta":
        out.pop("meta", None)
    return out


def _same_events(got, want):
    assert [_untimed(e) for e in got] == [_untimed(e) for e in want]


def _both(scenario, tmp_path=None):
    """Run ``scenario(obs_module, path)`` against both packages; return the
    port's events after checking them equal to the reference's."""
    out = []
    for mod in (obs, jobs):
        path = str(tmp_path / f"{mod.__name__}.jsonl") if tmp_path else None
        try:
            out.append(scenario(mod, path))
        finally:
            mod.disable()
    _same_events(*out)
    return out[0]


# ---- tracer core ------------------------------------------------------------

def test_trace_schema_roundtrip(tmp_path):
    def scenario(mod, path):
        tr = mod.configure(path, meta={"cmd": "unit"}, profile=False)
        with tr.span("run", kind="run", runner="seq"):
            rsp = tr.begin("round", kind="round", rnd=0)
            with tr.span("client", kind="client", cid=3):
                pass
            tr.event("dispatch", sim_t=1.5, cid=3)
            rsp.end(down_bytes=10, up_bytes=20, sim_time_s=2.0)
        tr.metrics.counter("pipeline.up_bytes", codec="signsgd").inc(20)
        mod.close()
        return mod.read_jsonl(path)

    events = _both(scenario, tmp_path)
    assert E.check(events, require_kinds=["run", "round", "client"]) == []
    assert events[0]["meta"]["cmd"] == "unit"
    spans = {e["name"]: e for e in events if e["type"] == "span"}
    assert spans["client"]["parent"] == spans["round"]["id"]
    assert spans["round"]["parent"] == spans["run"]["id"]
    assert spans["run"]["parent"] is None
    ev = next(e for e in events if e["type"] == "event")
    assert ev["name"] == "dispatch" and ev["sim_t"] == 1.5
    met = next(e for e in events if e["type"] == "metric")
    assert met["value"] == 20 and met["labels"] == {"codec": "signsgd"}


def test_out_of_order_span_end_keeps_stack_sane():
    def scenario(mod, _):
        tr = mod.configure(None, profile=False)
        outer = tr.begin("outer")
        inner = tr.begin("inner")
        outer.end()
        inner.end()
        tr.begin("later").end()
        outer.end()                       # double-end is idempotent
        return tr.events()

    evs = _both(scenario)
    assert next(e for e in evs if e.get("name") == "later")["parent"] is None
    assert sum(1 for e in evs if e.get("name") == "outer") == 1


def test_disabled_tracer_is_shared_noop():
    obs.disable()
    tr = obs.get_tracer()
    assert tr is NULL_TRACER and not tr.enabled and not tr.profile
    assert tr.begin("x", kind="round", rnd=1) is NULL_SPAN
    assert tr.span("y") is NULL_SPAN
    assert NULL_SPAN.set(a=1) is NULL_SPAN
    assert NULL_SPAN.lazy("k", torch.zeros(())) is NULL_SPAN
    assert tr.event("e", sim_t=0.0) is None
    assert tr.events() == [] and tr.close() == []
    assert tr.metrics is NULL_METRICS
    c = tr.metrics.counter("n", codec="int8")
    assert c is tr.metrics.counter("other")
    c.inc(5)
    assert c.value == 0 and tr.metrics.snapshot() == {}
    g, h = tr.metrics.gauge("m"), tr.metrics.histogram("h")
    assert g is tr.metrics.gauge("m2") and h is tr.metrics.histogram("h2")
    g.set(3.3)
    h.observe(1.0)
    assert g.value == 0.0
    assert h.value == h.summary() == jobs.get_tracer().metrics.histogram(
        "h").summary()
    assert h.quantile(0.5) is None and h.count == 0
    ctx = obs.annotate("cohort_dispatch")
    with ctx:
        pass
    assert ctx is obs.annotate("again")


def test_annotate_is_a_profiler_range_while_tracing():
    try:
        obs.configure(None, health=False)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]) as prof:
            with obs.annotate("cohort_dispatch"):
                torch.ones(2) + 1
    finally:
        obs.disable()
    assert "cohort_dispatch" in {e.key for e in prof.key_averages()}


def test_lazy_attrs_resolve_in_one_batch(tmp_path):
    """0-d tensors ride spans unresolved and come back in one stack per
    device at close; any other value by ``float``."""
    path = str(tmp_path / "lazy.jsonl")
    try:
        tr = obs.configure(path, health=False)
        sp = tr.begin("round", kind="round", rnd=0)
        sp.lazy("loss", torch.tensor(0.25))
        sp.lazy("steps", torch.tensor(3, dtype=torch.int32))
        sp.lazy("host", np.float32(0.5))
        sp.end(down_bytes=0, up_bytes=0, sim_time_s=0.0)
        calls = []
        real_stack = torch.stack

        def stack(ts, *a, **k):
            calls.append(len(ts))
            return real_stack(ts, *a, **k)

        torch.stack = stack
        try:
            assert tr.resolve_pending() == 3
        finally:
            torch.stack = real_stack
        assert calls == [2]                     # both tensors, one stack
        assert sp.attrs["loss"].resolved and sp.attrs["loss"].value == 0.25
        assert tr.resolve_pending() == 0
        obs.close()
    finally:
        obs.disable()
    (rnd,) = [e for e in E.read_jsonl(path) if e.get("kind") == "round"]
    assert rnd["attrs"] == {"rnd": 0, "loss": 0.25, "steps": 3.0,
                            "host": 0.5, "down_bytes": 0, "up_bytes": 0,
                            "sim_time_s": 0.0}


# ---- metrics ---------------------------------------------------------------

def _metrics_scenario(mod_metrics, ops):
    m = mod_metrics()
    ops(m)
    return m.snapshot(), m.events()


def _both_metrics(ops):
    from repro.obs.metrics import Metrics as JMetrics
    got = _metrics_scenario(Metrics, ops)
    assert json.dumps(got, sort_keys=True) == \
        json.dumps(_metrics_scenario(JMetrics, ops), sort_keys=True)
    return got[0]


def test_metrics_label_identity_and_aggregation():
    def ops(m):
        a = m.counter("up_bytes", codec="signsgd", stage="stage2")
        assert a is m.counter("up_bytes", stage="stage2", codec="signsgd")
        a.inc(3)
        a.inc(4)
        m.counter("up_bytes", codec="int8", stage="stage2")
        m.gauge("eps").set(1.25)
        for v in (1.0, 2.0, 3.0, 4.0, 5.0):
            m.histogram("resid").observe(v)

    snap = _both_metrics(ops)
    assert snap["up_bytes{codec=signsgd,stage=stage2}"] == 7
    assert snap["up_bytes{codec=int8,stage=stage2}"] == 0
    assert snap["eps"] == 1.25
    assert snap["resid"]["count"] == 5 and snap["resid"]["sum"] == 15.0
    assert snap["resid"]["p50"] == pytest.approx(3.0, rel=0.01)


def test_histogram_quantiles():
    snap = _both_metrics(lambda m: [m.histogram("lat").observe(float(i))
                                    for i in range(1, 102)])
    s = snap["lat"]
    assert s["p50"] == pytest.approx(51.0, rel=0.01)
    assert s["p95"] == pytest.approx(96.0, rel=0.01)
    assert s["p99"] == pytest.approx(100.0, rel=0.01)
    assert set(s) == {"count", "sum", "min", "max",
                      "p50", "p90", "p95", "p99"}


def test_metrics_kind_mismatch_raises():
    m = Metrics()
    m.counter("x")
    with pytest.raises(TypeError):
        m.gauge("x")


def test_histogram_sample_buffer_is_bounded():
    from repro.obs.metrics import Metrics as JMetrics
    h, jh = Metrics().histogram("big"), JMetrics().histogram("big")
    for i in range(SAMPLE_CAP + 100):
        h.observe(float(i))
        jh.observe(float(i))
    assert h.count == SAMPLE_CAP + 100
    assert len(h.reservoir.items) == SAMPLE_CAP
    assert h.reservoir.items == jh.reservoir.items
    assert any(v >= SAMPLE_CAP for v in h.reservoir.items)
    assert h.vmax == float(SAMPLE_CAP + 99)


def test_histogram_quantiles_reflect_whole_stream_not_warmup():
    def ops(m):
        h = m.histogram("shift")
        for v in [1.0] * SAMPLE_CAP + [100.0] * (9 * SAMPLE_CAP):
            h.observe(v)

    assert _both_metrics(ops)["shift"]["p50"] == pytest.approx(100.0,
                                                               rel=0.01)


def test_label_cardinality_cap():
    from repro_torch.obs.metrics import LABEL_CARD_CAP, OVERFLOW_LABEL
    n = LABEL_CARD_CAP + 50

    def ops(m):
        for i in range(n):
            m.counter("per_client", client=str(i)).inc()
        m.counter("per_client", client="3").inc()

    snap = _both_metrics(ops)
    series = [k for k in snap if k.startswith("per_client{")]
    assert len(series) == LABEL_CARD_CAP + 1
    assert snap[f"per_client{{client={OVERFLOW_LABEL}}}"] == \
        n - LABEL_CARD_CAP
    assert sum(snap[k] for k in series) == n + 1
    assert snap["per_client{client=3}"] == 2


def test_metric_events_serialize_for_trace():
    m = Metrics()
    m.counter("n", phase="masked").inc(2)
    (ev,) = m.events()
    assert ev == {"type": "metric", "metric": "counter", "name": "n",
                  "labels": {"phase": "masked"}, "value": 2}


# ---- export goldens ----------------------------------------------------------

def _golden_events():
    return [
        {"type": "meta", "schema": 1, "t_epoch": 0.0, "meta": {}},
        {"type": "span", "id": 0, "parent": None, "name": "run",
         "kind": "run", "t0": 0.0, "dur": 1.0, "sim_t0": 0.0, "sim_dur": 3.0,
         "attrs": {"runner": "seq", "final_acc": 0.5, "wall_s": 1.0}},
        {"type": "span", "id": 1, "parent": 0, "name": "round",
         "kind": "round", "t0": 0.0, "dur": 0.4, "sim_t0": 0.0,
         "sim_dur": 1.5,
         "attrs": {"rnd": 0, "down_bytes": 10, "up_bytes": 20,
                   "sim_time_s": 1.5}},
        {"type": "span", "id": 2, "parent": 0, "name": "round",
         "kind": "round", "t0": 0.4, "dur": 0.4, "sim_t0": 1.5,
         "sim_dur": 1.5,
         "attrs": {"rnd": 1, "down_bytes": 30, "up_bytes": 40,
                   "sim_time_s": 3.0}},
        {"type": "span", "id": 3, "parent": 1, "name": "advertise",
         "kind": "secagg-phase", "t0": 0.0, "dur": 0.0, "sim_t0": 0.0,
         "sim_dur": 0.0, "attrs": {"down": 5, "up": 7, "time_s": 0.1}},
        {"type": "span", "id": 4, "parent": 1, "name": "secagg",
         "kind": "secagg", "t0": 0.0, "dur": 0.1, "sim_t0": 0.0,
         "sim_dur": 0.0,
         "attrs": {"rnd": 0, "recovery_bytes": 64, "n_dropped": 1}},
        {"type": "event", "name": "inflight_comm", "t": 0.9, "sim_t": 3.0,
         "attrs": {"down_bytes": 100, "up_bytes": 0}},
        {"type": "metric", "metric": "counter", "name": "sched.admits",
         "labels": {}, "value": 4},
    ]


def test_summarize_golden():
    s = E.summarize(_golden_events())
    assert s == JE.summarize(_golden_events())
    assert s["n_rounds"] == 2
    assert s["down_bytes"] == 40 and s["up_bytes"] == 60
    assert s["comm_gb"] == ((10 + 20) / 1e9 + (30 + 40) / 1e9
                            + (100 + 0) / 1e9)
    assert s["sim_time_s"] == 3.0
    assert s["secagg"] == {"rounds": 1,
                           "phase_bytes": {"advertise": {"down": 5, "up": 7}},
                           "recovery_bytes": 64, "n_dropped": 1}
    assert s["metrics"]["sched.admits"] == 4


def _corruptions():
    evs = _golden_events()
    dup = [dict(e) for e in evs]
    dup[1] = dict(dup[1], id=2)
    bad = [dict(e) for e in evs]
    bad[2] = dict(bad[2], attrs={"down_bytes": 1.5, "up_bytes": 0,
                                 "sim_time_s": 0.0})
    rollup = evs + [{"type": "span", "id": 99, "parent": None,
                     "name": "cohort_rollup", "kind": "rollup", "t0": 0.0,
                     "dur": 0.0, "sim_t0": 0.0, "sim_dur": 0.0,
                     "attrs": {"n_clients": 5, "n_kept": "two",
                               "sketches": {"loss": {"pos": {}}}}}]
    return {"ok": (evs, ["run", "round", "secagg"], "[]"),
            "kind": (evs, ["pipeline"], "'pipeline' absent"),
            "empty": ([], None, "empty trace"),
            "dup": (dup, None, "duplicate id"),
            "bytes": (bad, None, "bad down_bytes"),
            "meta": (evs[1:], None, "not a meta record"),
            "orphan": (evs + [dict(evs[2], id=99, parent=98)], None,
                       "dangling parent"),
            "rollup": (rollup, None, "malformed sketch")}


@pytest.mark.parametrize("case", sorted(_corruptions()))
def test_check_golden_and_corruptions(case):
    evs, kinds, needle = _corruptions()[case]
    problems = E.check(evs, require_kinds=kinds)
    assert problems == JE.check(evs, require_kinds=kinds)
    if needle == "[]":
        assert problems == []
    else:
        assert any(needle in p for p in problems), problems


def test_diff_golden():
    a = {"comm_gb": 1.0, "n_rounds": 2, "only_a": 5}
    b = {"comm_gb": 1.1, "n_rounds": 2, "only_b": 7}
    d = E.diff(a, b)
    assert d == JE.diff(a, b)
    assert d["comm_gb"]["rel"] == pytest.approx(0.1)
    assert d["only_a"]["b"] is None and d["only_b"]["a"] is None


def test_chrome_trace_golden():
    ct = E.chrome_trace(_golden_events())
    assert ct == JE.chrome_trace(_golden_events())
    xs = [e for e in ct["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == 5
    rnd = next(e for e in xs if e["name"] == "round")
    assert rnd["ts"] == 0.0 and rnd["dur"] == pytest.approx(0.4e6)


def test_cli_summarize_check_diff_chrome(tmp_path, capsys):
    p1 = str(tmp_path / "a.jsonl")
    E.write_jsonl(p1, _golden_events())
    evs2 = _golden_events()
    evs2[2]["attrs"]["up_bytes"] = 400
    p2 = str(tmp_path / "b.jsonl")
    E.write_jsonl(p2, evs2)
    for argv, rc in ((["check", p1, "--require-kinds", "run,round"], 0),
                     (["check", p1, "--require-kinds", "pipeline"], 1),
                     (["summarize", p1, "--format", "json"], 0),
                     (["summarize", p1], 0),
                     (["diff", p1, p2], 0),
                     (["diff", p1, p2, "--rel-tol", "0.5"], 1)):
        assert obs_main(argv) == rc, argv
        got = capsys.readouterr()
        assert jobs_main(argv) == rc
        want = capsys.readouterr()
        assert (got.out, got.err) == (want.out, want.err), argv
    out = str(tmp_path / "c.json")
    assert obs_main(["chrome", p1, "-o", out]) == 0
    assert json.load(open(out))["traceEvents"]


def test_cli_check_unreadable(tmp_path, capsys):
    p = tmp_path / "garbage.jsonl"
    p.write_text("not json\n")
    assert obs_main(["check", str(p)]) == 1
    assert "unreadable" in capsys.readouterr().err


# ---- whole runs: shared helpers -------------------------------------------

@pytest.fixture(scope="module")
def setup():
    """``tests/test_obs.py``'s setup: MINI with 1 layer, 6 Dirichlet(0.3)
    clients of 400 samples, for both packages."""
    jcfg = JMINI.with_(n_layers=1, layer_pattern=("attn",))
    train = JDATA.make_classification(400, 10, jcfg.vocab_size, 24, seed=1)
    test = JDATA.make_classification(120, 10, jcfg.vocab_size, 24, seed=2)
    parts = JPART.dirichlet_partition(train.labels, 6, alpha=0.3, seed=0)
    return dict(jcfg=jcfg, cfg=MINI.with_(n_layers=1,
                                          layer_pattern=("attn",)),
                train=train, test=test, parts=parts,
                data=(DATA.Dataset(train.tokens, train.labels),
                      DATA.Dataset(test.tokens, test.labels)))


def _fc(mod, rounds, **kw):
    return mod.FedConfig(rounds=rounds, clients_per_round=3, batch_size=16,
                         max_local_batches=2, eval_every=rounds, lr=3e-3,
                         **kw)


def reference_run(setup, path, strategy="fedlora", rounds=2, **kw):
    """``tests/test_obs.py:_traced_run`` → (history, events, the weights
    of its ``_init_run`` bridged to the port)."""
    strat = JBL.all_strategies(rounds=rounds)[strategy]
    jm = JaxModel(setup["jcfg"], peft=strat.peft, unroll=True)
    try:
        jobs.configure(path, meta=jobs.provenance({"cmd": "test"}))
        h = JSRV.run_federated(jm, strat, setup["parts"], setup["train"],
                               setup["test"], _fc(JSRV, rounds, **kw))
        jobs.close()
    finally:
        jobs.disable()
    base, tr = jm.init(jax.random.key(0))
    params = from_jax(jax.tree.map(np.asarray, base),
                      jax.tree.map(np.asarray, tr), None)[:2]
    return h, JE.read_jsonl(path), params


def port_run(setup, path, params, strategy="fedlora", rounds=2, **kw):
    """The same run through the port (traced to ``path``; untraced when
    ``path`` is None) → (history, events)."""
    strat = BL.all_strategies(rounds=rounds)[strategy]
    model = Model(setup["cfg"], peft=strat.peft)
    try:
        if path is not None:
            obs.configure(path, meta=obs.provenance({"cmd": "test"}))
        h = SRV.run_federated(model, strat, setup["parts"], *setup["data"],
                              _fc(SRV, rounds, **kw), device="cpu",
                              params=params)
        if path is not None:
            obs.close()
    finally:
        obs.disable()
    return h, (E.read_jsonl(path) if path is not None else [])


def assert_parity(h, s):
    """``tests/test_obs.py:_assert_parity``: summarize replays the history's
    accounting exactly."""
    assert s["comm_gb"] == h["comm_gb"]
    assert s["sim_time_s"] == h["sim_time_s"]
    assert s["n_rounds"] == len(h["rounds"])
    assert s["down_bytes"] == sum(lg.down_bytes for lg in h["rounds"])
    assert s["up_bytes"] == sum(lg.up_bytes for lg in h["rounds"])
    if h.get("final_acc") == h.get("final_acc"):
        assert s["final_acc"] == h["final_acc"]


def _module(path):
    """The reference's unrolled layer path → the port's layer list."""
    parts = path.split(".")
    if len(parts) > 2 and parts[1] == "tail" and parts[2][:1] == "t":
        parts[1:3] = ["layers", parts[2][1:]]
    return ".".join(parts)


def _close(a, b, what):
    assert math.isfinite(a) == math.isfinite(b), what
    if math.isfinite(b):
        assert a == pytest.approx(b, rel=LOSS_RTOL, abs=1e-6), what


FLOAT_ATTRS = {"loss", "norm", "ef_norm", "mean_cos", "dispersion"}
N_EVAL = 120 // 16 * 16            # eval samples of the setup's test set


def _keyed(events):
    """{(type, kind, name): [event, ...]} over spans and events, without the
    reference's JAX compile spans and compile-cache events."""
    out = collections.defaultdict(list)
    for e in events:
        if e.get("type") == "span" and e.get("kind") != "compile":
            out[("span", e["kind"], e["name"])].append(e)
        elif e.get("type") == "event" and e["name"] != "compile_cache":
            out[("event", "", e["name"])].append(e)
    return out


def assert_same_trace(events, want):
    """The port's trace against the reference's: the same spans and events
    per (kind, name) in the same order, their attributes exact but for
    losses, norms and dispersions (within LOSS_RTOL), accuracies (within
    one eval sample), dispatch signatures (dtypes differ) and rank paths
    (mapped).  The port's cohort dispatch spans also carry ``loss_sum``,
    the cohort's device losses resolved at close."""
    got, ref = _keyed(events), _keyed(want)
    assert {k: len(v) for k, v in got.items()} == \
        {k: len(v) for k, v in ref.items()}
    for key, evs in got.items():
        for a, b in zip(evs, ref[key]):
            pa, pb = dict(a["attrs"]), dict(b["attrs"])
            if key[0] == "event":
                assert a["sim_t"] == b["sim_t"], key
            if key[1] == "dispatch":
                pa.pop("sig", None)
                pb.pop("sig", None)
                assert math.isfinite(pa.pop("loss_sum", 0.0)), key
            if key[2] == "rank_alloc":
                pb["modules"] = {_module(k): v
                                 for k, v in pb["modules"].items()}
            if key[2] == "module_pruned":
                pb["module"] = _module(pb["module"])
            for k in ("acc", "final_acc"):
                if k in pb:
                    x, y = pa.pop(k), pb.pop(k)
                    assert (x != x and y != y) or abs(x - y) <= 1 / N_EVAL
            for k in FLOAT_ATTRS & set(pb):
                _close(pa.pop(k), pb.pop(k), (key, k))
            pa.pop("wall_s", None)
            pb.pop("wall_s", None)
            assert pa == pb, key


def assert_same_metrics(events, want):
    """Counter and gauge values and histogram counts equal per (name,
    labels), but for the reference's compile accounting."""
    def table(evs):
        out = {}
        for e in evs:
            if e.get("type") != "metric" or e["name"].startswith("profile."):
                continue
            key = (e["name"], tuple(sorted(e["labels"].items())))
            out[key] = e["value"]["count"] if e["metric"] == "histogram" \
                else e["value"]
        return out

    assert table(events) == table(want)


# ---- whole runs: the reference's acceptance setting ---------------------------

SECAGG_KW = dict(runner="cohort", secagg="mask", codec="signsgd",
                 dropout=0.3, event_seed=3, secagg_threshold=0.5)


@pytest.fixture(scope="module")
def secagg_runs(setup, tmp_path_factory):
    d = tmp_path_factory.mktemp("secagg")
    want, jev, params = reference_run(setup, str(d / "ref.jsonl"),
                                      **SECAGG_KW)
    h, ev = port_run(setup, str(d / "port.jsonl"), params, **SECAGG_KW)
    hu, _ = port_run(setup, None, params, **SECAGG_KW)
    return dict(h=h, events=ev, want=want, jev=jev, params=params,
                untraced=hu)


def test_traced_secagg_signsgd_run_parity(secagg_runs):
    """The reference's acceptance run on the port: check passes with every
    kind, summarize reconstructs the history exactly (per-phase secagg
    bytes too), byte metrics carry codec labels."""
    h, events = secagg_runs["h"], secagg_runs["events"]
    assert E.check(events, require_kinds=[
        "run", "round", "client", "pipeline", "secagg", "secagg-phase",
        "dispatch", "eval"]) == []
    s = E.summarize(events)
    assert_parity(h, s)
    want = {}
    for r in h["secagg_rounds"]:
        for name, pc in r["phases"].items():
            w = want.setdefault(name, {"down": 0, "up": 0})
            w["down"] += pc["down"]
            w["up"] += pc["up"]
    assert s["secagg"]["phase_bytes"] == want
    assert s["secagg"]["rounds"] == len(h["secagg_rounds"])
    assert s["secagg"]["recovery_bytes"] == \
        sum(r["recovery_bytes"] for r in h["secagg_rounds"])
    assert any(k.startswith("pipeline.up_bytes{") and "codec=signsgd" in k
               for k in s["metrics"])


def test_secagg_trace_matches_the_reference(secagg_runs):
    assert_same_trace(secagg_runs["events"], secagg_runs["jev"])
    assert_same_metrics(secagg_runs["events"], secagg_runs["jev"])
    s, js = E.summarize(secagg_runs["events"]), \
        JE.summarize(secagg_runs["jev"])
    for k in ("n_rounds", "comm_gb", "sim_time_s", "down_bytes", "up_bytes",
              "secagg", "alerts"):
        assert s[k] == js[k], k


def test_untraced_run_history_identical(secagg_runs):
    """Tracing off, the recorder is just the dict: the same keys and
    values as the traced run, and no event anywhere."""
    h, hu = secagg_runs["h"], secagg_runs["untraced"]
    assert isinstance(hu, dict) and set(hu) == set(h)
    assert obs.get_tracer().events() == []
    for k in ("rounds", "acc", "comm_gb", "sim_time_s", "final_acc",
              "secagg_rounds", "dp_eps", "masks"):
        assert hu[k] == h[k], k
    for a, b in zip(hu["rounds"], h["rounds"]):
        assert a.loss == b.loss


def test_zero_round_run_guard(setup):
    """rounds=0: both sync runners report final_acc=NaN and no rounds."""
    for runner in ("seq", "cohort"):
        strat = BL.all_strategies(rounds=1)["fedlora"]
        fc = SRV.FedConfig(rounds=0, clients_per_round=3, batch_size=16,
                           max_local_batches=2, eval_every=1, lr=3e-3,
                           runner=runner)
        h = SRV.run_federated(Model(setup["cfg"], peft=strat.peft), strat,
                              setup["parts"], *setup["data"], fc,
                              device="cpu")
        assert h["rounds"] == [] and h["comm_gb"] == 0.0
        assert h["final_acc"] != h["final_acc"]


# ---- the port's other runners: summarize equals the history exactly ----------

@pytest.mark.parametrize("kw", [
    dict(runner="seq", strategy="slora", rounds=3),
    dict(runner="seq", codec="int8"),
    dict(runner="cohort", fuse_rounds=2, rounds=4),
    dict(runner="cohort", fuse_rounds=2, rounds=2, codec="topk"),
], ids=["seq-slora", "seq-int8", "fused", "fused-fallback"])
def test_port_trace_reconstructs_its_history(setup, tmp_path, secagg_runs,
                                             kw):
    """SLoRA's stage-1 rounds, the int8 wire, the fused runner's replayed
    rounds and a fused config that falls back: each trace summarizes to its
    own history exactly, with the fallback's reason on the trace."""
    path = str(tmp_path / "run.jsonl")
    h, events = port_run(setup, path, secagg_runs["params"], **kw)
    assert E.check(events, require_kinds=["run", "round", "client"]) == []
    assert_parity(h, E.summarize(events))
    rounds = [e for e in events if e.get("kind") == "round"]
    assert [r["attrs"]["rnd"] for r in rounds] == \
        [lg.rnd for lg in h["rounds"]]
    if kw.get("strategy") == "slora":
        phases = [r["attrs"]["phase"] for r in rounds]
        assert phases.count("stage1") == h["stage1"]["rounds"] >= 1
        assert any(e.get("name") == "encode"
                   and e["attrs"]["stage"] == "stage1" for e in events)
    fallback = [e for e in events if e.get("name") == "fused_fallback"]
    if kw.get("codec") == "topk":
        assert fallback[0]["attrs"]["reason"].startswith("codec 'topk'")
    elif kw.get("fuse_rounds"):
        assert fallback == []
        dsp = [e for e in events if e.get("kind") == "dispatch"]
        assert [d["attrs"]["rnd"] for d in dsp] == [0, 2]
        assert all(d["attrs"]["fused"] == 2 for d in dsp)


# ---- serving instrumentation ----------------------------------------------

def test_scheduler_stats_and_bounded_retention():
    from repro.serving.scheduler import Scheduler as JScheduler
    from repro_torch.serving.scheduler import Scheduler

    def drive(cls):
        sch = cls(n_slots=2, max_seq=16, max_retained=3)
        for _ in range(5):
            sch.submit("t", np.arange(4), 0)
        ok = sch.submit("t", np.arange(4), 4)
        sch.admit()
        sch.reject(ok, "unknown adapter", kind="unknown_adapter")
        return sch

    sch = drive(Scheduler)
    st = sch.stats()
    assert st == drive(JScheduler).stats()
    assert st["submitted"] == 6
    assert st["rejects"] == {"invalid": 5, "unknown_adapter": 1}
    assert st["admits"] == 1
    assert len(sch.rejected) == 3


def test_scheduler_mirrors_its_counters_into_metrics():
    from repro.serving.scheduler import Scheduler as JScheduler
    from repro_torch.serving.scheduler import Scheduler

    def scenario(mod, _):
        mod.configure(None, health=False, profile=False)
        cls = Scheduler if mod is obs else JScheduler
        sch = cls(n_slots=2, max_seq=16)
        sch.submit("t", np.arange(4), 0)
        a = sch.submit("t", np.arange(4), 4)
        sch.submit("t", np.arange(4), 4)
        sch.submit("t", np.arange(4), 4)
        sch.admit()
        sch.defer(a)
        return mod.get_metrics().events()

    evs = _both(scenario)
    assert {e["name"]: e["value"] for e in evs} == {
        "sched.admits": 2, "sched.preemptions": 1, "sched.rejects": 1}


def test_engine_latency_stats_and_step_spans():
    """The reference's ``stats()["latency"]`` keys (p50/p95/p99 of a step's
    and a request's host wall clock), whether or not tracing is on; with
    tracing, one ``engine.step`` span per step and the token counters."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine, serve_requests
    cfg = get_config("qwen2_0p5b", smoke=True)
    prompts, aids = [list(range(1, 12)), [5, 6, 7]], ["client0", "client1"]
    eng = build_engine(cfg, n_slots=2, max_seq=20, n_tenants=2, device="cpu")
    serve_requests(eng, prompts, aids, 4)
    lat = eng.stats()["latency"]
    assert set(lat) == {"step_s", "request_s"}
    assert lat["request_s"]["count"] == 2
    assert lat["step_s"]["count"] == eng.steps
    for s in lat.values():
        assert set(s) == {"count", "sum", "min", "max",
                          "p50", "p90", "p95", "p99"}
        assert 0 <= s["p50"] <= s["p95"] <= s["p99"]
    try:
        obs.configure(None, health=False)
        eng = build_engine(cfg, n_slots=2, max_seq=20, n_tenants=2,
                           device="cpu")
        reqs = serve_requests(eng, prompts, aids, 4)
        evs = obs.close()
    finally:
        obs.disable()
    steps = [e for e in evs if e.get("kind") == "serving"]
    assert len(steps) == eng.stats()["steps"]
    assert [s["attrs"]["step"] for s in steps] == \
        list(range(1, eng.steps + 1))
    met = {e["name"]: e["value"] for e in evs if e.get("type") == "metric"}
    assert met["sched.admits"] == 2
    assert met["serve.decode_tokens"] + eng.prefill_calls == \
        sum(len(r.out) for r in reqs) + sum(len(p) for p in prompts) - \
        met["serve.prefill_tokens"]
    assert met["serve.step_s"]["count"] == eng.steps
    assert met["serve.request_s"]["count"] == 2


# ---- cohort-scale trace sampling --------------------------------------------

class _StubLog:
    def __init__(self, loss, acc):
        self.loss, self.acc = loss, acc


def _run_synthetic(mod, n_clients, rounds, client_sample, alert_cid=None):
    try:
        mod.configure(None, health=False, profile=False,
                      client_sample=client_sample, sample_seed=0)
        rec = mod.RunRecorder("cohort")
        for rnd in range(rounds):
            rsp = rec.begin_round(rnd)
            down = up = 0
            for cid in range(n_clients):
                csp = rec.begin_client(cid)
                up += 1000 + cid
                down += 2000
                if cid == alert_cid:
                    mod.get_tracer().event("alert", alert="ef_blowup",
                                           cid=cid, rnd=rnd)
                csp.end(n_steps=4, up_bytes=1000 + cid,
                        loss=1.0 + cid * 1e-3)
            rec.add_sim(12.5)
            rec.end_round(rsp, _StubLog(1.5, 0.5), down, up)
        rec.finish()
        return rec, mod.close()
    finally:
        mod.disable()


def _both_synthetic(*a, **k):
    rec, evs = _run_synthetic(obs, *a, **k)
    jrec, jevs = _run_synthetic(jobs, *a, **k)
    _same_events(evs, jevs)
    assert {k: v for k, v in rec.items() if k != "rounds"} == \
        {k: v for k, v in jrec.items() if k != "rounds"}
    return rec, evs


def test_sampled_1000_client_round_acceptance():
    from repro_torch.obs.sketch import DEFAULT_REL_ERR
    n, rounds = 1000, 2
    rec_full, ev_full = _both_synthetic(n, rounds, None)
    rec_smp, ev_smp = _both_synthetic(n, rounds, 0.02)
    assert len(ev_smp) <= 0.05 * len(ev_full)
    s = E.summarize(ev_smp)
    assert s["comm_gb"] == rec_smp["comm_gb"] == rec_full["comm_gb"]
    assert s["sim_time_s"] == rec_smp["sim_time_s"]
    assert E.check(ev_smp) == []
    ro = s["rollup"]
    assert ro["rounds"] == rounds and ro["n_clients"] == n * rounds
    losses = sorted([1.0 + cid * 1e-3 for cid in range(n)] * rounds)
    for q, tag in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
        exact = losses[int(round(q * (len(losses) - 1)))]
        assert abs(ro["dists"]["loss"][tag] - exact) <= \
            DEFAULT_REL_ERR * exact * (1 + 1e-6)


def test_sampling_is_deterministic_and_head_sampled():
    from repro_torch.obs.trace import client_keep
    _, ev = _both_synthetic(300, 1, 0.1)
    kept = sorted(e["attrs"]["cid"] for e in ev if e.get("kind") == "client")
    assert kept == [c for c in range(300) if client_keep(0, 0, c, 0.1)]


def test_tail_keep_on_alert():
    from repro_torch.obs.trace import client_keep
    alert_cid = next(c for c in range(200)
                     if not client_keep(0, 0, c, 0.05))
    _, events = _both_synthetic(200, 1, 0.05, alert_cid=alert_cid)
    kept = {e["attrs"]["cid"] for e in events if e.get("kind") == "client"}
    assert alert_cid in kept
    (rollup,) = [e for e in events if e.get("kind") == "rollup"]
    assert rollup["attrs"]["n_kept"] == len(kept)


def test_unsampled_trace_has_no_rollups():
    _, events = _both_synthetic(20, 1, None)
    assert not [e for e in events if e.get("kind") == "rollup"]
    assert E.summarize(events).get("rollup") is None
