"""Port parity for ``repro_torch.obs.sketch`` against ``repro.obs.sketch``,
case for case with ``tests/test_obs_sketch.py``: every stream goes through
both packages' sketches and reservoirs, whose states, quantiles and
serialized forms must be equal, and the reference's bounds hold for the
port (relative error against the exact nearest-rank quantile, the merge
contract, the bucket cap, seeded reservoirs).

Property tests run through the ``tests/_hyp`` shim."""

import json
import random

import pytest

from _hyp import given, settings, st
from repro.obs import sketch as J
from repro_torch.obs import sketch as P


def _exact_quantile(vals, q):
    s = sorted(vals)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


def _bound(exact):
    return P.DEFAULT_REL_ERR * abs(exact) * (1 + 1e-6) + 1e-12


def _fill(mod, vals, **kw):
    sk = mod.Sketch(**kw)
    for v in vals:
        sk.add(v)
    return sk


def _both(vals, **kw):
    """The port's sketch of ``vals``, checked equal to the reference's."""
    p, j = _fill(P, vals, **kw), _fill(J, vals, **kw)
    assert p.state() == j.state()
    assert p.to_dict() == j.to_dict()
    return p


_FINITE = st.floats(allow_nan=False, allow_infinity=False,
                    min_value=-1e12, max_value=1e12)


def test_constants_equal_the_reference():
    assert P.DEFAULT_REL_ERR == J.DEFAULT_REL_ERR


@settings(max_examples=200, deadline=None)
@given(st.lists(_FINITE, max_size=200), st.lists(_FINITE, max_size=200))
def test_merge_equals_concatenated_stream(xs, ys):
    merged = _both(xs).merge(_both(ys))
    assert merged.state() == _both(xs + ys).state()
    assert merged.state() == _fill(J, xs).merge(_fill(J, ys)).state()


@settings(max_examples=100, deadline=None)
@given(st.lists(_FINITE, max_size=100), st.lists(_FINITE, max_size=100),
       st.lists(_FINITE, max_size=100))
def test_merge_associativity(xs, ys, zs):
    left = _both(xs).merge(_both(ys)).merge(_both(zs))
    right = _both(xs).merge(_both(ys).merge(_both(zs)))
    assert left.state() == right.state() == _both(xs + ys + zs).state()


@settings(max_examples=150, deadline=None)
@given(st.lists(st.floats(min_value=1e-9, max_value=1e9), min_size=1,
                max_size=300),
       st.sampled_from([0.5, 0.9, 0.95, 0.99]))
def test_relative_error_bound_positive_streams(vals, q):
    exact = _exact_quantile(vals, q)
    est = _both(vals).quantile(q)
    assert est == _fill(J, vals).quantile(q)
    assert abs(est - exact) <= _bound(exact), (q, est, exact)


@settings(max_examples=150, deadline=None)
@given(st.lists(_FINITE, min_size=1, max_size=300),
       st.sampled_from([0.0, 0.5, 0.99, 1.0]))
def test_relative_error_bound_mixed_sign_streams(vals, q):
    exact = _exact_quantile(vals, q)
    est = _both(vals).quantile(q)
    assert est == _fill(J, vals).quantile(q)
    assert abs(est - exact) <= _bound(exact), (q, est, exact)


@settings(max_examples=100, deadline=None)
@given(st.lists(_FINITE, max_size=200))
def test_serialization_roundtrip_property(vals):
    sk = _both(vals)
    d = json.loads(json.dumps(sk.to_dict()))
    back, jback = P.Sketch.from_dict(d), J.Sketch.from_dict(d)
    assert back.state() == sk.state() == jback.state()
    for q in (0.1, 0.5, 0.9):
        assert back.quantile(q) == sk.quantile(q) == jback.quantile(q)


def test_adversarial_streams_examples():
    streams = [
        [10.0 ** e for e in range(-9, 10)],
        [1.0] * 999 + [1e9],
        [0.0] * 10 + [1e-12, 1e12],
        list(range(1, 1001)),
        list(range(1000, 0, -1)),
        [-(1.5 ** k) for k in range(40)],
        [((-1) ** i) * (i + 1) for i in range(500)],
    ]
    for vals in streams:
        sk, jsk = _both(vals), _fill(J, vals)
        assert sk.count == len(vals)
        assert sk.vmin == min(vals) and sk.vmax == max(vals)
        for q in (0.01, 0.25, 0.5, 0.75, 0.95, 0.99):
            exact = _exact_quantile(vals, q)
            est = sk.quantile(q)
            assert est == jsk.quantile(q)
            assert abs(est - exact) <= _bound(exact), (vals[:3], q)
        assert sk.summary() == jsk.summary()


def test_merge_contract_example_and_add_weighted():
    rng = random.Random(7)
    a = [rng.lognormvariate(0, 3) for _ in range(2000)]
    b = [-rng.expovariate(1.0) for _ in range(500)] + [0.0] * 3
    assert _both(a).merge(_both(b)).state() == _both(a + b).state()
    w, jw = P.Sketch(), J.Sketch()
    w.add(2.5, n=10)
    jw.add(2.5, n=10)
    assert w.state() == _both([2.5] * 10).state() == jw.state()


def test_empty_and_single_value_sketches():
    sk = _both([])
    assert sk.quantile(0.5) is None
    assert sk.summary() == J.Sketch().summary() == {
        "count": 0, "sum": 0.0, "min": None, "max": None}
    assert P.Sketch.from_dict(sk.to_dict()).state() == sk.state()
    one = _both([42.0])
    assert one.quantile(0.0) == pytest.approx(42.0, rel=P.DEFAULT_REL_ERR)
    assert one.quantile(1.0) == _fill(J, [42.0]).quantile(1.0)


def test_non_finite_values_are_ignored():
    sk = _both([1.0, float("nan"), float("inf"), float("-inf"), 3.0])
    assert sk.count == 2
    assert sk.vmax == 3.0


def test_merge_rejects_mismatched_rel_err():
    with pytest.raises(ValueError):
        P.Sketch(rel_err=0.01).merge(P.Sketch(rel_err=0.05))


def test_bucket_collapse_caps_memory():
    vals = [10.0 ** e for e in range(-200, 200)]
    sk = _both(vals, max_buckets=32)
    assert len(sk.pos) <= 32
    assert sk.count == 400
    exact = 10.0 ** 199
    assert abs(sk.quantile(1.0) - exact) <= _bound(exact)


def test_jsonl_roundtrip_through_trace_file(tmp_path):
    sk = _both([random.Random(3).gauss(5, 2) for _ in range(1000)])
    path = tmp_path / "sk.jsonl"
    with open(path, "w") as f:
        f.write(json.dumps({"type": "span", "kind": "rollup",
                            "attrs": {"sketches": {"loss": sk.to_dict()}}})
                + "\n")
    with open(path) as f:
        ev = json.loads(f.readline())
    back = P.Sketch.from_dict(ev["attrs"]["sketches"]["loss"])
    assert back.state() == sk.state()
    assert back.quantile(0.95) == sk.quantile(0.95) == \
        J.Sketch.from_dict(ev["attrs"]["sketches"]["loss"]).quantile(0.95)


def _res(mod, cap, seed, vals):
    r = mod.Reservoir(cap, seed=seed)
    for v in vals:
        r.add(v)
    return r


def test_reservoir_is_seeded_and_deterministic():
    vals = [float(v) for v in range(1000)]
    r1, r2 = _res(P, 16, 9, vals), _res(P, 16, 9, vals)
    assert r1.items == r2.items == _res(J, 16, 9, vals).items
    assert r1.n == r2.n == 1000
    assert len(r1.items) == 16
    assert _res(P, 16, 10, vals).items != r1.items


def test_reservoir_samples_whole_stream():
    vals = [1.0] * 64 + [100.0] * (64 * 20)
    r = _res(P, 64, 0, vals)
    assert r.items == _res(J, 64, 0, vals).items
    assert sum(1 for v in r.items if v == 100.0) / len(r.items) > 0.5


def test_reservoir_merge_weighted():
    a, b = _res(P, 32, 1, [1.0] * 900), _res(P, 32, 2, [2.0] * 100)
    ja, jb = _res(J, 32, 1, [1.0] * 900), _res(J, 32, 2, [2.0] * 100)
    a.merge(b)
    ja.merge(jb)
    assert a.n == ja.n == 1000
    assert a.items == ja.items and len(a.items) == 32
    assert sum(1 for v in a.items if v == 1.0) > len(a.items) / 2
    e = P.Reservoir(8)
    e.merge(P.Reservoir(8))
    assert e.n == 0 and e.items == []
    e.merge(a)
    assert e.n == a.n and len(e.items) == 8
