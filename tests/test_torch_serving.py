"""Port parity for the serving slice on the CPU: the registry's padded and
scaling-folded trees equal JAX's exactly, the scheduler keeps its
invariants, and the port's engine reproduces the JAX engine's greedy tokens
on the same weights — batched equal to unbatched inside the port too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.serving import AdapterRegistry as JaxRegistry
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import bridge_tree
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.pytree import flatten_with_paths
from repro_torch.serving import (AdapterRegistry, RegistryFullError,
                                 Scheduler, ServingEngine)
from repro_torch.serving.registry import bucket_for


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def served():
    """tests/test_serving.py's fixture: SMOKE base + tenants at ranks 4 and
    8 (E bumped, top rank pruned), in JAX and carried to the port."""
    cfg = jax_get_config("qwen2_0p5b", smoke=True)
    model = JaxModel(cfg, peft="bea")
    base, _ = model.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    tenants = {}
    for tid, r in [("t4", 4), ("t8", 8)]:
        m_t = JaxModel(cfg.with_(adapter_rank=r), peft="bea")
        _, tr = m_t.init(jax.random.key(0))

        def bump(tree):
            if isinstance(tree, dict):
                return {k: jnp.asarray(rng.normal(size=v.shape) * 0.05,
                                       v.dtype) if k == "E" else bump(v)
                        for k, v in tree.items()}
            return tree

        masks = jax.tree.map(lambda m: m.at[..., -1].set(False),
                             m_t.init_masks())
        tenants[tid] = (bump(tr), masks, r)
    port_base = bridge_tree(_np(base))
    port_tenants = {tid: (bridge_tree(_np(tr)), bridge_tree(_np(m)), r)
                    for tid, (tr, m, r) in tenants.items()}
    return cfg, model, base, tenants, port_base, port_tenants


def _jax_engine(cfg, model, base, tenants, n_slots, chunk_prefill=True):
    eng = JaxEngine(model, base, n_slots=n_slots, max_seq=24,
                    chunk_prefill=chunk_prefill)
    for tid, (tr, masks, r) in tenants.items():
        eng.register_adapter(tid, tr, masks, rank=r, alpha=cfg.adapter_alpha)
    return eng


def _port_engine(port_base, port_tenants, n_slots, use_kernels=True,
                 chunk_prefill=True):
    cfg = get_config("qwen2_0p5b", smoke=True)
    eng = ServingEngine(Model(cfg, use_kernels=use_kernels), port_base,
                        n_slots=n_slots, max_seq=24, device="cpu",
                        chunk_prefill=chunk_prefill)
    for tid, (tr, masks, r) in port_tenants.items():
        eng.register_adapter(tid, tr, masks, rank=r, alpha=cfg.adapter_alpha)
    return eng


PLANS_SEED = 3


def _plans(vocab):
    rng = np.random.default_rng(PLANS_SEED)             # tests/test_serving.py
    return [("t4", rng.integers(0, vocab, 6)), ("t8", rng.integers(0, vocab, 9)),
            ("t4", rng.integers(0, vocab, 8)), ("t8", rng.integers(0, vocab, 5))]


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tid,serving_scaling", [("t4", 4.0), ("t8", 4.0),
                                                 ("t8", 2.0)])
def test_registry_trees_equal_jax_exactly(served, tid, serving_scaling):
    cfg, _, _, tenants, _, port_tenants = served
    tr, masks, r = tenants[tid]
    jreg = JaxRegistry(serving_scaling, bucket_sizes=(4, 8, 16))
    je = jreg.register(tid, tr, masks, rank=r, alpha=cfg.adapter_alpha)
    ptr, pmasks, _ = port_tenants[tid]
    preg = AdapterRegistry(serving_scaling, bucket_sizes=(4, 8, 16))
    pe = preg.register(tid, ptr, pmasks, rank=r, alpha=cfg.adapter_alpha)
    assert (pe.rank, pe.bucket, pe.nbytes) == (je.rank, je.bucket, je.nbytes)
    for got_tree, want_tree in ((pe.adapters, je.adapters),
                                (pe.masks, je.masks)):
        got = flatten_with_paths(got_tree)
        want = flatten_with_paths(bridge_tree(_np(want_tree)))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), path


def _tiny_adapters(rank, d=6, n=5, seed=0):
    rng = np.random.default_rng(seed)
    mod = {"A": torch.tensor(rng.normal(size=(rank, d)), dtype=torch.float32),
           "B": torch.tensor(rng.normal(size=(n, rank)), dtype=torch.float32),
           "E": torch.tensor(rng.normal(size=(rank,)), dtype=torch.float32)}
    masks = {"dec": {"attn": {"wq": torch.ones(rank, dtype=torch.bool)}}}
    return {"adapters": {"dec": {"attn": {"wq": mod}}}}, masks


def test_registry_pads_to_bucket_and_folds_scaling():
    reg = AdapterRegistry(serving_scaling=2.0, bucket_sizes=(4, 8))
    tr, masks = _tiny_adapters(3)
    e = reg.register("t", tr, masks, rank=3, scaling=4.0)
    assert e.rank == 3 and e.bucket == 4
    mod = e.adapters["dec"]["attn"]["wq"]
    assert mod["A"].shape == (4, 6) and mod["B"].shape == (5, 4)
    orig = tr["adapters"]["dec"]["attn"]["wq"]
    assert torch.equal(mod["E"][:3], orig["E"] * 2.0)
    assert mod["E"][3] == 0 and not e.masks["dec"]["attn"]["wq"][3]
    assert bucket_for(9, (4, 8)) == 9


def test_registry_lru_pin_and_refcount():
    reg = AdapterRegistry(serving_scaling=1.0, bucket_sizes=(4,),
                          max_entries=2)
    for tid in ("a", "b"):
        reg.register(tid, *_tiny_adapters(4), rank=4, scaling=1.0)
    reg.get("a")                                 # b is now least recent
    reg.register("c", *_tiny_adapters(4), rank=4, scaling=1.0)
    assert reg.ids() == ["a", "c"] and reg.evictions == 1
    with pytest.raises(KeyError):
        reg.get("b")
    reg.pin("a")
    reg.acquire("c")
    with pytest.raises(RegistryFullError):       # both protected
        reg.register("d", *_tiny_adapters(4), rank=4, scaling=1.0)
    assert reg.ids() == ["a", "c"]               # atomic: nothing lost
    reg.release("c")
    reg.register("d", *_tiny_adapters(4), rank=4, scaling=1.0)
    assert "a" in reg and "c" not in reg


def test_registry_capacity_bytes_eviction():
    tr, masks = _tiny_adapters(4)
    one = AdapterRegistry(serving_scaling=1.0, bucket_sizes=(4,))
    e = one.register("x", tr, masks, rank=4, scaling=1.0)
    reg = AdapterRegistry(serving_scaling=1.0, bucket_sizes=(4,),
                          capacity_bytes=int(e.nbytes * 2.5))
    for tid in ("a", "b", "c"):
        reg.register(tid, *_tiny_adapters(4), rank=4, scaling=1.0)
    assert reg.ids() == ["b", "c"] and reg.host_bytes <= reg.capacity_bytes


# --------------------------------------------------------------------------
# scheduler
# --------------------------------------------------------------------------

def test_scheduler_slots_never_shared_and_reclaimed():
    sch = Scheduler(n_slots=3, max_seq=32)
    reqs = [sch.submit("t", np.arange(4), 4) for _ in range(7)]
    admitted = sch.admit()
    slots = [r.slot for r in admitted]
    assert len(set(slots)) == 3 and sch.admit() == []
    sch.finish(admitted[1])
    nxt = sch.admit()
    assert len(nxt) == 1 and nxt[0].slot == slots[1]
    for r in sch.running():
        sch.finish(r)
    assert sch.n_free == 3 and sch.n_waiting == 3
    assert reqs[0].state == "finished"


def test_scheduler_rejects_and_defers():
    sch = Scheduler(n_slots=2, max_seq=8)
    assert sch.submit("t", np.arange(6), 4).state == "rejected"
    assert sch.submit("t", np.arange(4), 0).state == "rejected"
    assert sch.stats()["rejects"] == {"invalid": 2}
    a = sch.submit("t", np.arange(4), 2)
    sch.submit("t", np.arange(4), 2)
    first, _ = sch.admit()
    sch.defer(first)
    assert first is a and a.state == "waiting" and sch.admit()[0] is a


# --------------------------------------------------------------------------
# engine: the JAX engine's greedy tokens, batched == unbatched
# --------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels,chunk_prefill", [
    (True, True), (False, True), (True, False)])
def test_engine_tokens_equal_jax_engine(served, use_kernels, chunk_prefill):
    cfg, model, base, tenants, port_base, port_tenants = served
    plans = _plans(cfg.vocab_size)
    jeng = _jax_engine(cfg, model, base, tenants, 3, chunk_prefill)
    jreqs = [jeng.submit(tid, p, 3) for tid, p in plans]
    jeng.run()
    peng = _port_engine(port_base, port_tenants, 3, use_kernels,
                        chunk_prefill)
    preqs = [peng.submit(tid, p, 3) for tid, p in plans]
    peng.run()
    assert all(r.state == "finished" and len(r.out) == 3 for r in preqs)
    assert [r.out for r in preqs] == [r.out for r in jreqs]
    st = peng.stats()
    assert st["steps"] == jeng.steps
    assert st["prefill_calls"] == jeng.prefill_calls == 4
    assert st["registry"]["buckets"] == [4, 8]
    assert st["scheduler"]["finished"] == 4


def test_port_engine_batched_equals_unbatched(served):
    cfg, *_, port_base, port_tenants = served
    plans = _plans(cfg.vocab_size)
    eng = _port_engine(port_base, port_tenants, 3)
    reqs = [eng.submit(tid, p, 3) for tid, p in plans]
    eng.run()
    for req, (tid, prompt) in zip(reqs, plans):
        solo = _port_engine(port_base, port_tenants, 1)
        sr = solo.submit(tid, prompt, 3)
        solo.run()
        assert sr.out == req.out, f"rid={req.rid} {sr.out} != {req.out}"


def test_port_engine_matches_native_rank_model(served):
    """The padded/scaling-folded registry form reproduces the tenant's
    native-rank model exactly (greedy tokens)."""
    cfg, *_, port_base, port_tenants = served
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, 7)
    eng = _port_engine(port_base, port_tenants, 1)
    req = eng.submit("t8", prompt, 3)
    eng.run()
    tr, masks, r = port_tenants["t8"]
    m_t = Model(get_config("qwen2_0p5b", smoke=True).with_(adapter_rank=r))
    cache = m_t.init_cache(1, 24, "cpu")
    logits, cache = m_t.prefill(port_base, tr, masks,
                                torch.as_tensor(prompt)[None], cache)
    toks = [int(logits[0].argmax())]
    for _ in range(2):
        logits, cache = m_t.decode_step(port_base, tr, masks,
                                        torch.tensor([[toks[-1]]]), cache)
        toks.append(int(logits[0].argmax()))
    assert toks == req.out


def test_engine_run_aborts_on_wedged_registry(served):
    *_, port_base, port_tenants = served
    eng = _port_engine(port_base, {}, 2)
    eng.registry.max_entries = 1
    tr, masks, r = port_tenants["t4"]
    eng.register_adapter("pinned", tr, masks, rank=r, pin=True)
    eng.registry.loader = lambda aid: dict(trainable=tr, masks=masks, rank=r)
    for _ in range(3):
        eng.submit("other", np.arange(4), 2)
    with pytest.raises(RegistryFullError):
        eng.run()


def test_engine_continuous_batching_reuses_slots(served):
    cfg, *_, port_base, port_tenants = served
    rng = np.random.default_rng(9)
    eng = _port_engine(port_base, port_tenants, 2)
    reqs = [eng.submit(["t4", "t8"][i % 2],
                       rng.integers(0, cfg.vocab_size, 5), 2)
            for i in range(5)]
    eng.run()
    assert all(r.state == "finished" for r in reqs)
    assert eng.scheduler.n_free == 2
    starts = sorted(r.start_step for r in reqs)
    assert starts[0] < starts[2] < starts[4]
    assert eng.stats()["finished"] == 5


def test_unknown_adapter_is_rejected_not_served(served):
    *_, port_base, port_tenants = served
    eng = _port_engine(port_base, port_tenants, 2)
    bad = eng.submit("nobody", np.arange(4), 2)
    ok = eng.submit("t4", np.arange(4), 2)
    eng.run()
    assert bad.state == "rejected" and "nobody" in bad.error
    assert ok.state == "finished" and len(ok.out) == 2
