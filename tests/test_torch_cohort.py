"""Port parity for the cohort runner (``repro_torch.fedsim.cohort`` and
``runner.run_cohort``): the client-grouped plain ``bea_dense`` and its
autograd against per-client calls; a model forward over a stacked cohort
against each client's own forward; ``tests/test_fedsim.py``'s FedARA cohort
run (MINI with 2 layers, 10 Dirichlet(0.1) clients, 3 a round, batch 16,
3 local batches, lr 3e-3) through the reference's cohort runner, the port's
cohort runner (kernel wrappers and plain ops) and the port's seq oracle
from the same bridged weights; the simulated stragglers; and re-bucketing
(CPU)."""

import jax
import numpy as np
import pytest
import torch

from repro.configs.distilbert import MINI as JMINI
from repro.data import synthetic as JDATA
from repro.federated import baselines as JBL
from repro.federated import partition as JPART
from repro.federated import server as JSRV
from repro.fedsim.cohort import build_cohort as jbuild_cohort
from repro.models import Model as JaxModel
from repro_torch.bridge import from_jax
from repro_torch.configs.distilbert import MINI
from repro_torch.data import synthetic as DATA
from repro_torch.federated import baselines as BL
from repro_torch.federated import server as SRV
from repro_torch.fedsim import cohort as CH
from repro_torch.kernels import ref
from repro_torch.kernels.bea_fused import BeaDenseGrouped
from repro_torch.models import Model
from repro_torch.pytree import flatten_with_paths, leaves, tree_map
from test_torch_baselines import _one_thread  # noqa: F401 (autouse)

RTOL = ATOL = 2e-4         # tests/test_fedsim.py:64, cohort vs seq
ROUNDS = 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def su():
    jcfg = JMINI.with_(n_layers=2, layer_pattern=("attn",) * 2)
    train = JDATA.make_classification(600, 20, jcfg.vocab_size, 32, seed=1)
    test = JDATA.make_classification(200, 20, jcfg.vocab_size, 32, seed=2)
    parts = JPART.dirichlet_partition(train.labels, 10, alpha=0.1, seed=0)
    return dict(jcfg=jcfg, cfg=MINI.with_(n_layers=2,
                                          layer_pattern=("attn",) * 2),
                train=train, test=test, parts=parts,
                data=(DATA.Dataset(train.tokens, train.labels),
                      DATA.Dataset(test.tokens, test.labels)))


def _fc(mod, runner, **kw):
    rounds = kw.pop("rounds", ROUNDS)
    return mod.FedConfig(rounds=rounds, clients_per_round=3, batch_size=16,
                         max_local_batches=kw.pop("max_local_batches", 3),
                         eval_every=kw.pop("eval_every", rounds), lr=3e-3,
                         runner=runner, **kw)


def _strat(pkg, name, rounds=ROUNDS):
    s = pkg.all_strategies(rounds=rounds)[name]
    if hasattr(s, "total_rounds"):
        s.total_rounds, s.warmup_rounds, s.final_rounds_frac = rounds, 1, 0.34
    return s


def jax_run(su, runner, name="fedara", **kw):
    """The reference's run and its ``_init_run`` weights, bridged."""
    strat = _strat(JBL, name, kw.get("rounds", ROUNDS))
    jm = JaxModel(su["jcfg"], peft=strat.peft, unroll=True)
    want = JSRV.run_federated(jm, strat, su["parts"], su["train"], su["test"],
                              _fc(JSRV, runner, **kw))
    base, tr = jm.init(jax.random.key(0))
    return want, from_jax(_np(base), _np(tr), None)[:2]


def port_run(su, runner, params=None, name="fedara", use_kernels=True,
             **kw):
    strat = _strat(BL, name, kw.get("rounds", ROUNDS))
    model = Model(su["cfg"], peft=strat.peft, use_kernels=use_kernels)
    return SRV.run_federated(model, strat, su["parts"], *su["data"],
                             _fc(SRV, runner, **kw), device="cpu",
                             params=params)


def assert_parity(h, want, loss_rtol=RTOL, loss_atol=ATOL):
    """Per round: bytes, live ranks, dead modules and the clock equal,
    losses within the tolerance; the final masks equal."""
    assert len(h["rounds"]) == len(want["rounds"])
    for a, b in zip(h["rounds"], want["rounds"]):
        assert (a.rnd, a.down_bytes, a.up_bytes, a.live_ranks,
                a.dead_modules, a.trainable_params) == \
            (b.rnd, b.down_bytes, b.up_bytes, b.live_ranks, b.dead_modules,
             b.trainable_params), a.rnd
        assert a.sim_time_s == b.sim_time_s, a.rnd
        np.testing.assert_allclose(a.loss, b.loss, rtol=loss_rtol,
                                   atol=loss_atol)
    assert h["comm_gb"] == want["comm_gb"]
    got, exp = flatten_with_paths(h["masks"]), flatten_with_paths(
        _port_masks(want["masks"]))
    assert [p for p, _ in got] == [p for p, _ in exp]
    for (path, a), (_, b) in zip(got, exp):
        assert np.array_equal(np.asarray(a), np.asarray(b)), path


def _port_masks(tree):
    """A reference mask tree in the port's layout (unrolled ``tail`` →
    ``layers``)."""
    if isinstance(tree, dict):
        if "tail" in tree:
            return {"layers": [_port_masks(tree["tail"][f"t{i}"])
                               for i in range(len(tree["tail"]))]}
        return {k: _port_masks(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port_masks(v) for v in tree]
    return None if tree is None else np.asarray(tree)


@pytest.fixture(scope="module")
def fedara_runs(su):
    want, params = jax_run(su, "cohort")
    return dict(want=want, params=params,
                seq=port_run(su, "seq", params))


# --------------------------------------------------------------------------
# units
# --------------------------------------------------------------------------

def test_grouped_plain_bea_dense_equals_per_client_calls_and_grads():
    rng = np.random.default_rng(0)
    c, m, k, n, r, s = 3, 20, 24, 16, 6, 1.7
    x, w = rng.normal(size=(c, m, k)), rng.normal(size=(k, n))
    a, b, e = (rng.normal(size=(c, r, k)), rng.normal(size=(c, n, r)),
               rng.normal(size=(c, r)))
    mask = np.ones(r, bool)
    mask[2] = False
    t = [torch.tensor(v, dtype=torch.float32) for v in (x, w, a, b, e)]
    mk = torch.tensor(mask)
    got = ref.bea_dense_grouped_ref(*t, mk, s)
    for i in range(c):
        want = ref.bea_dense_ref(t[0][i], t[1], t[2][i], t[3][i], t[4][i],
                                 mk, s)
        np.testing.assert_allclose(got[i].numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
    # grads: the autograd Function (plain forward on the CPU) against each
    # client's own autograd of the plain single-client form
    g = torch.tensor(rng.normal(size=(c, m, n)), dtype=torch.float32)
    req = [v.clone().requires_grad_(True) for v in t]
    y = BeaDenseGrouped.apply(*req, mk, s)
    grads = torch.autograd.grad(y, req, g)
    for i in range(c):
        one = [req[0][i].detach(), t[1], t[2][i], t[3][i], t[4][i]]
        one = [v.clone().requires_grad_(True) for v in one]
        gi = torch.autograd.grad(ref.bea_dense_ref(*one, mk, s), one, g[i])
        for j, gj in ((0, gi[0]), (2, gi[2]), (3, gi[3]), (4, gi[4])):
            np.testing.assert_allclose(grads[j][i].numpy(), gj.numpy(),
                                       rtol=1e-5, atol=1e-5)
    want_w = sum(torch.autograd.grad(ref.bea_dense_ref(
        t[0][i], req[1], t[2][i], t[3][i], t[4][i], mk, s), req[1], g[i])[0]
        for i in range(c))
    np.testing.assert_allclose(grads[1].numpy(), want_w.numpy(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("peft", ["bea", "lora", "adapter_h"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_cohort_forward_and_loss_equal_each_clients_own(peft, use_kernels):
    """``cls_loss(..., clients=True)`` over C stacked clients: each
    client's logits, loss and grads are those of its own forward, with the
    base and the rank masks shared (one rank masked)."""
    cfg = MINI.with_(n_layers=2, layer_pattern=("attn",) * 2)
    model = Model(cfg, peft=peft, use_kernels=use_kernels)
    base, tr = model.init(0, "cpu")
    c = 3
    gen = torch.Generator().manual_seed(1)
    stacked = tree_map(lambda x: x[None] + 0.05 * torch.randn(
        (c,) + tuple(x.shape), generator=gen), tr)
    masks = None
    if peft == "bea":
        masks = model.init_masks("cpu")
        masks["dec"]["layers"][0]["attn"]["wq"][3] = False
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (c, 4, 32))),
             "labels": torch.as_tensor(rng.integers(0, cfg.n_classes,
                                                    (c, 4)))}
    req = tree_map(lambda x: x.clone().requires_grad_(True), stacked)
    total, (loss, acc) = model.cls_loss(base, req, masks, batch,
                                        clients=True)
    grads = torch.autograd.grad(total, leaves(req))
    assert loss.shape == acc.shape == (c,)
    for i in range(c):
        one = tree_map(lambda x: x[i].detach().clone().requires_grad_(True),
                       stacked)
        li, (_, ai) = model.cls_loss(base, one, masks,
                                     {k: v[i] for k, v in batch.items()})
        gi = torch.autograd.grad(li, leaves(one))
        np.testing.assert_allclose(loss[i].item(), li.item(), rtol=1e-5)
        assert acc[i].item() == ai.item()
        for g_c, g_i in zip(grads, gi):
            scale = max(g_i.abs().max().item(), 1e-12)
            assert (g_c[i] - g_i).abs().max().item() <= 1e-4 * scale


# --------------------------------------------------------------------------
# whole runs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [False, True])
def test_cohort_matches_reference_cohort_and_port_seq(su, fedara_runs,
                                                      use_kernels):
    """``tests/test_fedsim.py::test_cohort_matches_sequential_oracle`` on
    the port: its cohort run against the reference's cohort run and
    against its own seq oracle, from the same weights."""
    h = port_run(su, "cohort", fedara_runs["params"],
                 use_kernels=use_kernels)
    assert_parity(h, fedara_runs["want"])
    assert_parity(h, fedara_runs["seq"])
    assert abs(h["final_acc"] - fedara_runs["seq"]["final_acc"]) <= 0.02
    assert h["sim_time_s"] > 0.0
    lives = [lg.live_ranks for lg in h["rounds"]]
    assert lives[-1] < lives[0]


def test_cohort_stragglers_and_dropout_stretch_the_clock(su):
    """``tests/test_fedsim.py::test_cohort_simulates_stragglers_and_dropout``
    on the port, with the reference's clock for the same draws."""
    kw = dict(name="fedlora", dropout=0.3, straggler=0.5, event_seed=3)
    want, params = jax_run(su, "cohort", **kw)
    h = port_run(su, "cohort", params, **kw)
    h0 = port_run(su, "cohort", params, name="fedlora")
    assert h["sim_time_s"] > h0["sim_time_s"]
    assert np.isfinite(h["final_acc"])
    assert [lg.sim_time_s for lg in h["rounds"]] == \
        [lg.sim_time_s for lg in want["rounds"]]
    assert [(lg.down_bytes, lg.up_bytes) for lg in h["rounds"]] == \
        [(lg.down_bytes, lg.up_bytes) for lg in want["rounds"]]
    np.testing.assert_allclose([lg.loss for lg in h["rounds"]],
                               [lg.loss for lg in want["rounds"]],
                               rtol=RTOL, atol=ATOL)


def test_cohort_private_branch_matches_reference(su):
    """FedARA's cohort run under signSGD, secure aggregation and DP: the
    cohort's uploads go through the pipeline's codec and the private round
    (no on-device average); bytes, ranks, masks, the clock, every secagg
    round's entry and the ε trajectory as the reference's."""
    kw = dict(codec="signsgd", secagg="mask", dp_clip=1.0,
              dp_noise_multiplier=1.0)
    want, params = jax_run(su, "cohort", **kw)
    h = port_run(su, "cohort", params, **kw)
    assert_parity(h, want, loss_rtol=1e-3, loss_atol=0.0)
    assert h["secagg_rounds"] == want["secagg_rounds"]
    assert h["dp_eps"] == want["dp_eps"] and h["dp"] == want["dp"]


def test_build_cohort_and_rebucket_match_reference(su):
    """``tests/test_fused.py:227-260``: re-bucketing keeps the same real
    steps in a pow-2 step axis; the port's rectangles equal the
    reference's."""
    train = JDATA.make_classification(800, 20, su["jcfg"].vocab_size, 32,
                                      seed=1)
    parts = JPART.iid_partition(train.labels, 12, seed=0)
    fc = SRV.FedConfig(rounds=1, clients_per_round=4, batch_size=16,
                       max_local_batches=7)
    sel = [0, 1, 2, 3]
    data = DATA.Dataset(train.tokens, train.labels)
    full = CH.build_cohort(data, parts, sel, fc, 0, 4)
    snug = CH.build_cohort(data, parts, sel, fc, 0, 4, bucket=True)
    assert full.step_mask.shape[1] == 7 and snug.step_mask.shape[1] == 4
    np.testing.assert_array_equal(full.n_steps, snug.n_steps)
    np.testing.assert_array_equal(full.weights, snug.weights)
    np.testing.assert_array_equal(full.step_mask[:, :4], snug.step_mask)
    assert not full.step_mask[:, 4:].any()
    jfc = JSRV.FedConfig(rounds=1, clients_per_round=4, batch_size=16,
                         max_local_batches=7)
    for bucket, got in ((False, full), (True, snug)):
        want = jbuild_cohort(train, parts, sel, jfc, 0, 4, bucket=bucket)
        for k in want.batches:
            np.testing.assert_array_equal(got.batches[k], want.batches[k])
        np.testing.assert_array_equal(got.step_mask, want.step_mask)
        np.testing.assert_array_equal(got.weights, want.weights)
        assert got.cids == want.cids and got.fallback == want.fallback
    # a cohort with sub-batch clients reports them as fallbacks, as the
    # reference does
    small = CH.build_cohort(su["data"][0], su["parts"], list(range(10)),
                            SRV.FedConfig(batch_size=16, max_local_batches=3),
                            0, 10)
    jsmall = jbuild_cohort(su["train"], su["parts"], list(range(10)),
                           JSRV.FedConfig(batch_size=16, max_local_batches=3),
                           0, 10)
    assert small.fallback == jsmall.fallback and small.fallback


def test_rebucket_run_parity(su):
    """Dropping all-masked padding steps changes nothing: the masked steps
    never touch the params (``tests/test_fused.py::
    test_rebucket_run_parity``)."""
    kw = dict(name="fedlora", rounds=2, max_local_batches=7)
    h_full = port_run(su, "cohort", **kw)
    h_snug = port_run(su, "cohort", rebucket=True, **kw)
    for a, b in zip(h_full["rounds"], h_snug["rounds"]):
        assert a.loss == b.loss and a.up_bytes == b.up_bytes
    assert h_full["final_acc"] == h_snug["final_acc"]
