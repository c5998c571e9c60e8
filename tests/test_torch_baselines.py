"""Port parity for the baselines slice, part 1: the bottleneck adapters,
``lora_dense_ref``, ``BeaDense``'s W gradient, the BERT configs, the device
cost model, the strategy registry and the FedAdapter byte count against the
JAX package on the same numpy inputs; then whole federated runs of FedLoRA,
FedAdapter-H/P and FedSVD on ``tests/test_system.py``'s MINI (2 layers,
unrolled) through ``repro.federated.server.run_federated`` and through the
port from the same bridged weights (CPU).  ``tests/test_torch_baselines_init
.py`` runs the strategies that rewrite the initial weights and
``tests/test_torch_slora.py`` SLoRA; both reuse the helpers here."""

import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bert as JB
from repro.configs.distilbert import MINI as JMINI
from repro.configs.distilbert import SMOKE as JSMOKE
from repro.core import adapters as JAD
from repro.data import synthetic as JDATA
from repro.federated import baselines as JBL
from repro.federated import devices as JDV
from repro.federated import partition as JPART
from repro.federated import server as JSRV
from repro.kernels import ref as jref
from repro.models import Model as JaxModel
from repro.models import blocks as JBK
from repro.models import layers as JL
from repro_torch.bridge import bridge_tree, from_jax
from repro_torch.configs import bert as TB
from repro_torch.configs import get_config
from repro_torch.configs.distilbert import MINI, SMOKE
from repro_torch.core import adapters as AD
from repro_torch.data import synthetic as DATA
from repro_torch.federated import baselines as BL
from repro_torch.federated import devices as DV
from repro_torch.federated import server as SRV
from repro_torch.kernels import ref
from repro_torch.kernels.bea_fused import BeaDense
from repro_torch.models import Model
from repro_torch.models import blocks as BK
from repro_torch.pytree import flatten_with_paths, leaves

TOL = 1e-5          # one function, f32, summation order only
LOSS_RTOL = 1e-3    # per-round losses of two whole runs
RUN_KW = dict(rounds=3, clients_per_round=2, batch_size=16,
              max_local_batches=2, eval_every=3, lr=3e-3)
N_EVAL = min(200 // 16, 16) * 16     # eval samples of a run's final round


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tier-1 runs test files in parallel workers; the small ops of a whole
    federated run (and numpy's small SVDs) then thrash when every worker
    also spreads each op over all cores, so these modules run torch, BLAS
    and OpenMP on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        limits = contextlib.nullcontext()
    else:
        limits = threadpool_limits(1)
    with limits:
        yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} × {scale}"


def _same_tensors(got, want):
    """Exact equality of two port trees of tensors (paths and bits)."""
    g, w = flatten_with_paths(got), flatten_with_paths(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b), path


# --------------------------------------------------------------------------
# whole-run helpers, shared with the other two baseline files
# --------------------------------------------------------------------------

def _setup():
    """tests/test_system.py's MINI (2 layers) and data, for both packages."""
    jcfg = JMINI.with_(n_layers=2, layer_pattern=("attn",) * 2)
    train = JDATA.make_classification(600, 20, jcfg.vocab_size, 32, seed=1)
    test = JDATA.make_classification(200, 20, jcfg.vocab_size, 32, seed=2)
    parts = JPART.dirichlet_partition(train.labels, 10, alpha=0.1, seed=0)
    cfg = MINI.with_(n_layers=2, layer_pattern=("attn",) * 2)
    data = (DATA.Dataset(train.tokens, train.labels),
            DATA.Dataset(test.tokens, test.labels))
    return dict(jcfg=jcfg, cfg=cfg, train=train, test=test, parts=parts,
                data=data)


def _jax_model(su, name):
    jstrat = JBL.all_strategies(rounds=RUN_KW["rounds"])[name]
    jcfg = su["jcfg"]
    return jstrat, JaxModel(jcfg.with_(adapter_rank=jstrat.init_rank(jcfg)),
                            peft=jstrat.peft, unroll=True)


def _jax_run(su, name, jstrat=None):
    """The reference's run of strategy ``name`` and its ``_init_run``
    weights (before ``post_init``), bridged to the port."""
    js, jm = _jax_model(su, name)
    jstrat = jstrat or js
    want = JSRV.run_federated(jm, jstrat, su["parts"], su["train"],
                              su["test"], JSRV.FedConfig(**RUN_KW))
    base, tr = jm.init(jax.random.key(0))
    return want, from_jax(_np(base), _np(tr), None)[:2]


def _port_run(su, strat, params, use_kernels):
    cfg = su["cfg"]
    model = Model(cfg.with_(adapter_rank=strat.init_rank(cfg)),
                  peft=strat.peft, use_kernels=use_kernels)
    return SRV.run_federated(model, strat, su["parts"], *su["data"],
                             SRV.FedConfig(**RUN_KW), device="cpu",
                             params=params)


def _assert_same_run(h, want):
    """Per round: bytes, trainable counts, live ranks and the simulated
    clock equal, losses within LOSS_RTOL (NaN in stage-1 rounds only, finite
    in every other); comm_gb equal, final accuracy within one eval sample,
    SLoRA's stage-1 stats equal."""
    logs, jlogs = h["rounds"], want["rounds"]
    assert len(logs) == len(jlogs) == RUN_KW["rounds"]
    s1_rounds = want.get("stage1", {}).get("rounds", 0)
    for a, b in zip(logs, jlogs):
        assert (a.rnd, a.down_bytes, a.up_bytes, a.live_ranks,
                a.dead_modules, a.trainable_params) == \
            (b.rnd, b.down_bytes, b.up_bytes, b.live_ranks, b.dead_modules,
             b.trainable_params), a.rnd
        if a.rnd < s1_rounds:
            assert math.isnan(a.loss) and math.isnan(b.loss), a.rnd
        else:
            assert math.isfinite(a.loss) and math.isfinite(b.loss), a.rnd
            assert a.loss == pytest.approx(b.loss, rel=LOSS_RTOL)
        assert a.sim_time_s == b.sim_time_s
    assert h["comm_gb"] == want["comm_gb"]
    assert abs(h["final_acc"] - want["final_acc"]) <= 1 / N_EVAL
    assert h.get("stage1") == want.get("stage1")


# --------------------------------------------------------------------------
# units
# --------------------------------------------------------------------------

def test_apply_bottleneck_matches_jax():
    rng = np.random.default_rng(0)
    d, size = 128, 24
    x = rng.normal(size=(3, 7, d)).astype(np.float32)
    ad = {"down": rng.normal(size=(d, size)) / np.sqrt(d),
          "up": rng.normal(size=(size, d)) / np.sqrt(size),
          "bd": rng.normal(size=size), "bu": rng.normal(size=d)}
    ad = {k: v.astype(np.float32) for k, v in ad.items()}
    want = JAD.apply_bottleneck(jnp.asarray(x),
                                {k: jnp.asarray(v) for k, v in ad.items()})
    got = AD.apply_bottleneck(torch.from_numpy(x),
                              {k: torch.from_numpy(v) for k, v in ad.items()})
    _close(got.numpy(), want, what="apply_bottleneck")


def test_lora_dense_ref_matches_jax():
    rng = np.random.default_rng(1)
    m, k, n, r = 9, 64, 48, 12
    x, w = rng.normal(size=(m, k)), rng.normal(size=(k, n)) / 8
    a, b = rng.normal(size=(r, k)) / 8, rng.normal(size=(n, r))
    mask = rng.random(r) < 0.7
    ops = [t.astype(np.float32) for t in (x, w, a, b)]
    want = jref.lora_dense_ref(*map(jnp.asarray, ops), jnp.asarray(mask), 1.3)
    got = ref.lora_dense_ref(*map(torch.from_numpy, ops),
                             torch.from_numpy(mask), 1.3)
    _close(got.numpy(), want, what="lora_dense_ref")


@pytest.mark.parametrize("m,k,n,r", [(24, 64, 48, 4), (100, 128, 256, 12)])
def test_bea_dense_w_grad_matches_jax_grad(m, k, n, r):
    """``BeaDense`` with W needing a gradient (SLoRA's stage 1): every grad,
    dW included, against ``jax.grad`` of ``layers.dense_apply`` at 1e-5,
    and against the autograd of the plain form bit for bit."""
    rng = np.random.default_rng(m + k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    a = (rng.normal(size=(r, k)) / np.sqrt(k)).astype(np.float32)
    b = rng.normal(size=(n, r)).astype(np.float32)
    e = rng.normal(size=r).astype(np.float32)
    mask = np.ones(r, bool)
    mask[1] = False
    g = rng.normal(size=(m, n)).astype(np.float32)
    s = 16.0 / r

    def f(x_, w_, a_, b_, e_):
        y = JL.dense_apply({"w": w_}, x_, {"A": a_, "B": b_, "E": e_},
                           jnp.asarray(mask), s)
        return (y * jnp.asarray(g)).sum()

    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x, w, a, b, e)))

    def leaves_():
        return [torch.from_numpy(t).requires_grad_(True)
                for t in (x, w, a, b, e)]

    lv = leaves_()
    y = BeaDense.apply(*lv, torch.from_numpy(mask), s)
    got = torch.autograd.grad(y, lv, torch.from_numpy(g))
    for name, gt, wt in zip(("X", "W", "A", "B", "E"), got, want):
        _close(gt.numpy(), wt, what=f"d{name}")
    lv2 = leaves_()
    y2 = ref.bea_dense_ref(*lv2, torch.from_numpy(mask), s)
    plain = torch.autograd.grad(y2, lv2, torch.from_numpy(g))
    for name, gt, pt in zip(("X", "W", "A", "B", "E"), got, plain):
        assert torch.equal(gt, pt), f"d{name} differs from plain autograd"


@pytest.mark.parametrize("peft", ["adapter_h", "adapter_p"])
def test_bottleneck_block_meta_matches_jax(peft):
    want = JBK.block_adapter_meta(JSMOKE, "attn", peft)
    got = BK.block_adapter_meta(SMOKE, "attn", peft)
    assert sorted(got) == sorted(want)
    size = 2 * SMOKE.adapter_rank
    for where in got:
        assert {k: m.shape for k, m in got[where].items()} == \
            {k: m.shape for k, m in want[where].items()}
        assert {k: m.init for k, m in got[where].items()} == \
            {k: m.init for k, m in want[where].items()}
        assert got[where]["down"].shape == (SMOKE.d_model, size)
    assert ("post_attn" in got) == (peft == "adapter_h")
    with pytest.raises(ValueError, match="no rank masks"):
        Model(SMOKE, peft=peft).mask_meta()


@pytest.mark.parametrize("name", ["CONFIG", "MINI", "SMOKE"])
def test_bert_configs_match_reference(name):
    want, got = getattr(JB, name), getattr(TB, name)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.pdtype == got.cdtype == torch.float32
    assert get_config("bert") == TB.CONFIG
    assert get_config("bert", smoke=True) == TB.SMOKE


@pytest.mark.parametrize("device", list(JDV.PROFILES))
def test_round_cost_total_time_and_energy_match_reference(device):
    assert DV.POWER_W == JDV.POWER_W
    for model in ("distilbert", "bert"):
        runs = [(3, 120_000, 80_000, 1.0), (5, 7, 0, 0.5), (0, 1e6, 2e6, 1.0)]
        got = [DV.round_cost(device, model, *r) for r in runs]
        want = [JDV.round_cost(device, model, *r) for r in runs]
        assert [(c.compute_s, c.comm_s, c.total_s) for c in got] == \
            [(c.compute_s, c.comm_s, c.total_s) for c in want]
        assert DV.total_time(device, model, got) == \
            JDV.total_time(device, model, want)
        for idle in (0.35, 0.0, 1.0):
            assert DV.energy_j(device, got, idle) == \
                JDV.energy_j(device, want, idle)
    for cid in range(4):
        assert DV.compute_s(cid, "bert", 3, slow=4.0) == \
            JDV.compute_s(cid, "bert", 3, slow=4.0)


def test_strategy_registry_matches_reference():
    want = JBL.all_strategies(rounds=7)
    got = BL.all_strategies(rounds=7)
    assert list(got) == list(want)
    for name in want:
        assert got[name].name == want[name].name == name
        assert got[name].peft == want[name].peft
        assert got[name].init_rank(MINI) == want[name].init_rank(JMINI)
    assert got["fedara"].total_rounds == 7


@pytest.mark.parametrize("name", ["fedadapter_h", "fedadapter_p"])
def test_fedadapter_bytes_count_the_head_only_as_the_reference_does(name):
    """A quirk of the reference, reproduced: ``Strategy.comm_down`` counts
    adapter bytes through ``core/comm.py:count_params``, which sees only
    modules with both A and B, so FedAdapter-H/P report the classifier
    head's bytes alone (the pipeline still averages the whole bottleneck
    tree).  At ``distilbert-smoke``: 10,320 bytes, 2,580 head parameters
    × 4, of 11,316 trainable parameters for FedAdapter-H."""
    jstrat = JBL.all_strategies()[name]
    jm = JaxModel(JSMOKE, peft=jstrat.peft, unroll=True)
    _, jtr = jm.init(jax.random.key(0))
    tr = bridge_tree(_np(jtr))
    strat = BL.all_strategies()[name]
    head = sum(t.numel() for t in leaves(tr["head"]))
    assert strat.comm_down(tr, None) == jstrat.comm_down(jtr, None) \
        == 4 * head == 10_320
    assert strat.comm_up(tr, None) == jstrat.comm_up(jtr, None)
    n_train = sum(t.numel() for t in leaves(tr))
    assert n_train == sum(int(np.prod(x.shape))
                          for x in jax.tree.leaves(jtr))
    if name == "fedadapter_h":
        assert n_train == 11_316


@pytest.mark.parametrize("peft", ["adapter_h", "adapter_p"])
def test_bottleneck_model_loss_and_grads_match_jax(peft):
    """A FedAdapter classifier forward, loss and every trainable grad on
    bridged weights (with the bottlenecks' zero-init leaves moved off zero)
    against ``Model.cls_loss`` under ``jax.value_and_grad``."""
    jm = JaxModel(JSMOKE, peft=peft, unroll=True)
    jbase, jtr = jm.init(jax.random.key(3))
    rng = np.random.default_rng(3)
    jtr = jax.tree.map(
        lambda t: t + 0.1 * rng.normal(size=t.shape).astype(np.float32), jtr)
    toks = rng.integers(0, JSMOKE.vocab_size, (4, 16))
    labels = rng.integers(0, JSMOKE.n_classes, 4)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (_, (jloss, _)), jg = jax.value_and_grad(
        lambda t: jm.cls_loss(jbase, t, None, jb, remat=False),
        has_aux=True)(jtr)
    base, tr, _ = from_jax(_np(jbase), _np(jtr), None)
    flat = [t.requires_grad_(True) for t in leaves(tr)]
    model = Model(SMOKE, peft=peft)
    loss, _ = model.cls_loss(base, tr, None,
                             {"tokens": torch.as_tensor(toks),
                              "labels": torch.as_tensor(labels)})
    got = torch.autograd.grad(loss, flat)
    _close(loss.item(), float(jloss), 2e-4, "loss")
    want = leaves(bridge_tree(_np(jg)))
    assert len(got) == len(want)
    for gt, wt in zip(got, want):
        _close(gt.numpy(), wt.numpy(), 2e-4, "grad")


# --------------------------------------------------------------------------
# whole runs: FedLoRA, FedAdapter-H/P, FedSVD
# --------------------------------------------------------------------------

STRATEGIES = ["fedlora", "fedadapter_h", "fedadapter_p", "fedsvd"]


@pytest.fixture(scope="module")
def runs():
    su = _setup()
    return su, {name: _jax_run(su, name) for name in STRATEGIES}


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("name", STRATEGIES)
def test_whole_run_matches_jax(runs, name, use_kernels):
    su, by_name = runs
    want, params = by_name[name]
    h = _port_run(su, BL.all_strategies(RUN_KW["rounds"])[name], params,
                  use_kernels)
    _assert_same_run(h, want)
    if name == "fedlora":       # tests/test_system.py::test_fedlora_flat_comm
        assert h["rounds"][0].down_bytes == h["rounds"][1].down_bytes
    if name.startswith("fedadapter"):
        assert h["rounds"][0].down_bytes == 2 * 4 * 20 * (128 + 1)
        assert h["rounds"][0].trainable_params > 20 * (128 + 1)
