"""Performance forensics on the card: compile accounting, CUDA memory
watermarks, and the per-signature dispatch attribution they hang off
(reference: ``repro/obs/profile.py``, rewritten for PyTorch and CUDA: there
is no ``jax.monitoring`` and no XLA program to count).

Compile accounting
------------------
Two things compile in the port, and each records one completed
``compile``-kind span (``compile_span``) parented under the innermost
*open* span, the round / dispatch / eval span that triggered it:

- ``nvcc``: ``kernels/_build.py:build`` compiles a kernel library (one
  span per library it builds; a cache hit records none);
- ``graph_capture``: ``fedsim/fused.py:CohortRound._capture`` captures a
  cohort round as a CUDA graph (the span carries the launches the capture
  recorded).

The cohort runner wraps its dispatch in a ``dispatch`` span stamped with
``shape_signature(...)``, so compile spans are keyed by the shapes that
caused them.  ``compile_stats(events)`` is the offline side: per-round /
per-signature / per-stage counts and seconds from the JSONL alone — "a
fused run captures its round once, in the first block" is an assertion,
not a hope.

Memory watermarks
-----------------
``sample_memory(tracer)`` records each card's
``torch.cuda.memory_stats`` (``allocated_bytes.all.current`` / ``.peak``)
as one ``memory`` event + gauges; the recorder calls it at round
boundaries.  Reading the allocator's counters does not synchronize.
Without an initialized CUDA context (a CPU run) it records nothing, as the
reference does on backends without memory stats.

Device-time attribution
-----------------------
``self_times(events)`` charges wall time to the span that spent it
(duration minus direct children), with nested compile time carved out per
row.

Everything consuming a written trace (``compile_stats``, ``self_times``)
is stdlib-only like the rest of ``repro_torch.obs``.
"""

from __future__ import annotations

import sys

# the stages that are one whole compilation each: the reference's XLA
# compile and the port's two (sub-stages such as jaxpr tracing are not)
COUNTED_STAGES = ("backend_compile", "nvcc", "graph_capture")


def compile_span(stage: str, dur: float, **attrs) -> dict | None:
    """Record one finished compilation of ``stage`` that took ``dur``
    seconds, under the open span (None while tracing or compile accounting
    is off)."""
    from repro_torch.obs import trace as _trace
    tr = _trace.get_tracer()
    if not tr.enabled or not tr.profile:
        return None
    tr.metrics.counter("profile.compiles", stage=stage).inc()
    return tr.point_span(stage, kind="compile", dur=float(dur), stage=stage,
                         **attrs)


def shape_signature(*trees) -> str:
    """Stable signature of the tensors a dispatch runs over: sorted leaf
    ``dtype[shape]`` strings with multiplicities, for torch tensors and
    numpy arrays alike.  A CUDA graph is valid only for the shapes it was
    captured with; a changed signature explains a ``compile`` span under
    the dispatch that carries it."""
    from repro_torch.pytree import leaves
    counts: dict[str, int] = {}
    for tree in trees:
        for leaf in leaves(tree):
            if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
                dt = str(leaf.dtype).removeprefix("torch.")
                k = f"{dt}[{','.join(map(str, leaf.shape))}]"
            else:
                k = type(leaf).__name__
            counts[k] = counts.get(k, 0) + 1
    return ";".join(f"{k}x{n}" if n > 1 else k
                    for k, n in sorted(counts.items()))


def sample_memory(tracer) -> dict | None:
    """One ``memory`` event with each card's allocated bytes in use and
    their peak since the last ``reset_peak_memory_stats`` (plus gauges), or
    None when tracing is off or no CUDA context exists."""
    if not tracer.enabled:
        return None
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    devs = {}
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        if not ms:
            continue
        in_use = int(ms.get("allocated_bytes.all.current", 0))
        peak = int(ms.get("allocated_bytes.all.peak", in_use))
        devs[str(i)] = {"bytes_in_use": in_use, "peak_bytes_in_use": peak}
        tracer.metrics.gauge("profile.bytes_in_use", device=str(i)).set(
            in_use)
        g = tracer.metrics.gauge("profile.peak_bytes_in_use", device=str(i))
        g.set(max(peak, g.value))
    if not devs:
        return None
    return tracer.event("memory", devices=devs)


# ---------------------------------------------------------------------------
# Offline reconstruction (stdlib-only)
# ---------------------------------------------------------------------------

def self_times(events: list[dict]) -> dict:
    """Per-span device-time attribution from the trace alone.

    Wall duration is attributed to the span that *spent* it: each span's
    self-time is its duration minus the durations of its direct children,
    so a ``dispatch`` span's self-time is the device execute + dispatch
    overhead with nested ``compile`` spans carved out (compile time is
    reported separately per row).  The reference's compile stages can
    overlap (an outer jit's ``jaxpr_trace`` covers inner jits' stages), so
    ``compile_s`` may exceed the parent's wall — treat it as attribution,
    not a partition.  Grouped by
    ``(kind, name)``::

      {"kind/name": {"n", "total_s", "self_s", "compile_s"}}
    """
    spans = {e["id"]: e for e in events if e.get("type") == "span"}
    child_s: dict = {}
    compile_s: dict = {}
    for e in spans.values():
        p = e.get("parent")
        if p is None or p not in spans:
            continue
        d = e.get("dur", 0.0) or 0.0
        child_s[p] = child_s.get(p, 0.0) + d
        if e.get("kind") == "compile":
            compile_s[p] = compile_s.get(p, 0.0) + d
    rows: dict = {}
    for e in spans.values():
        if e.get("kind") == "compile":
            continue
        key = f"{e.get('kind') or '?'}/{e.get('name') or '?'}"
        r = rows.setdefault(key, {"n": 0, "total_s": 0.0, "self_s": 0.0,
                                  "compile_s": 0.0})
        d = e.get("dur", 0.0) or 0.0
        r["n"] += 1
        r["total_s"] += d
        r["self_s"] += max(0.0, d - child_s.get(e["id"], 0.0))
        r["compile_s"] += compile_s.get(e["id"], 0.0)
    return rows


def compile_stats(events: list[dict]) -> dict:
    """Attribute every ``compile`` span to its enclosing region.

    Returns::

      {"n": total compiles, "total_s": all compile-stage seconds,
       "by_stage": {stage: count}, "by_round": {rnd: compiles},
       "by_signature": {sig: compiles}, "eval": ..., "setup": ...,
       "after_first_round": compiles in rounds ≥ 1,
       "cache_hits": ..., "cache_misses": ...}

    Counts are whole compilations, the ``COUNTED_STAGES``: a kernel
    library's ``nvcc`` build, a CUDA-graph capture, and the reference's XLA
    ``backend_compile`` (its sub-stages such as jaxpr tracing are not
    counted); ``total_s`` sums every compile-stage duration.  A compile
    span under an ``eval`` span is bucketed as eval; one under a
    ``dispatch`` span that carries ``rnd`` (the fused runner's block, which
    runs before its rounds are recorded) counts to that round; one with no
    round ancestor is ``setup``.

    ``cache_hits``/``cache_misses`` count persistent-compilation-cache
    outcomes (``compile_cache`` events; the reference's, none in the port).
    """
    spans = {e["id"]: e for e in events if e.get("type") == "span"}
    out = {"n": 0, "total_s": 0.0, "by_stage": {}, "by_round": {},
           "by_signature": {}, "eval": 0, "setup": 0,
           "after_first_round": 0, "cache_hits": 0, "cache_misses": 0}
    for e in events:
        if e.get("type") == "event" and e.get("name") == "compile_cache":
            res = (e.get("attrs") or {}).get("result")
            if res == "cache_hits":
                out["cache_hits"] += 1
            elif res == "cache_misses":
                out["cache_misses"] += 1
    for e in spans.values():
        if e.get("kind") != "compile":
            continue
        stage = e.get("name", "?")
        out["by_stage"][stage] = out["by_stage"].get(stage, 0) + 1
        out["total_s"] += e.get("dur", 0.0) or 0.0
        if stage not in COUNTED_STAGES:
            continue
        out["n"] += 1
        rnd = sig = None
        is_eval = False
        p = e.get("parent")
        while p is not None and p in spans:
            ps = spans[p]
            if ps.get("kind") == "eval":
                is_eval = True
            if ps.get("kind") == "dispatch":
                pa = ps.get("attrs") or {}
                if sig is None:
                    sig = pa.get("sig")
                if pa.get("rnd") is not None:
                    rnd = pa["rnd"]
                    break
            if ps.get("kind") == "round":
                rnd = (ps.get("attrs") or {}).get("rnd")
                break
            p = ps.get("parent")
        if sig is not None:
            out["by_signature"][sig] = out["by_signature"].get(sig, 0) + 1
        if is_eval:
            out["eval"] += 1
        elif rnd is None:
            out["setup"] += 1
        else:
            out["by_round"][rnd] = out["by_round"].get(rnd, 0) + 1
            if isinstance(rnd, (int, float)) and rnd >= 1:
                out["after_first_round"] += 1
    return out
