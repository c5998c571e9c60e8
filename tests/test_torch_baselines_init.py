"""Port parity for the baselines slice, part 2: the strategies that rewrite
the initial weights.  FFA-LoRA-dr's orthogonal A (a QR in numpy) and
FeDeRA's SVD split of the base are exact against the JAX package's on the
same bridged weights; ``tests/test_system.py``'s ffa-freezes-A and
federa-base-residual checks on the port; and whole federated runs of
FFA-LoRA, FFA-LoRA-dr and FeDeRA against the reference's from the same
weights (CPU), with the helpers of ``tests/test_torch_baselines.py``."""

import jax
import numpy as np
import pytest
import torch

from repro.federated import baselines as JBL
from repro_torch.bridge import bridge_tree
from repro_torch.federated import baselines as BL
from repro_torch.models import Model
from test_torch_baselines import _one_thread  # noqa: F401 (autouse)
from test_torch_baselines import (RUN_KW, _assert_same_run, _jax_model,
                                  _jax_run, _np, _port_run, _same_tensors,
                                  _setup)


def _modules(tree):
    """The adapter modules of a trainable tree, in tree order."""
    if isinstance(tree, dict) and "A" in tree:
        return [tree]
    items = (tree.values() if isinstance(tree, dict)
             else tree if isinstance(tree, list) else ())
    return [m for v in items for m in _modules(v)]


@pytest.fixture(scope="module")
def su():
    return _setup()


def _post_init_both(su, name):
    """The reference's and the port's ``post_init`` on the same weights →
    ((jax base, jax trainable) as port trees, (port base, port trainable),
    the bridged weights before post_init, the port model)."""
    jstrat, jm = _jax_model(su, name)
    jbase, jtr = jm.init(jax.random.key(0))
    jb1, jt1 = jstrat.post_init(jm, jbase, jtr, jax.random.key(1))
    base0, tr0 = bridge_tree(_np(jbase)), bridge_tree(_np(jtr))
    strat = BL.all_strategies()[name]
    cfg = su["cfg"]
    model = Model(cfg.with_(adapter_rank=strat.init_rank(cfg)),
                  peft=strat.peft)
    got = strat.post_init(model, base0, tr0)
    want = (bridge_tree(_np(jb1)), bridge_tree(_np(jt1)))
    return want, got, (base0, tr0), model


def test_ffa_dr_orthogonal_a_is_exact(su):
    (jb, jt), (b, t), (b0, t0), model = _post_init_both(su, "ffa_lora_dr")
    _same_tensors(t, jt)
    _same_tensors(b, jb)
    a = _modules(t["adapters"])[0]["A"]
    assert a.shape[0] == 2 * su["cfg"].adapter_rank
    torch.testing.assert_close(a @ a.T, torch.eye(a.shape[0]), atol=1e-5,
                               rtol=0)
    assert not torch.equal(a, _modules(t0["adapters"])[0]["A"])


def test_federa_post_init_is_exact(su):
    (jb, jt), (b, t), (b0, _), _ = _post_init_both(su, "federa")
    _same_tensors(t, jt)
    _same_tensors(b, jb)
    # every adapted linear was rewritten, and the port's base tree is new
    assert not torch.equal(b["dec"]["layers"][1]["attn"]["wo"]["w"],
                           b0["dec"]["layers"][1]["attn"]["wo"]["w"])
    assert torch.equal(b["embed"]["tok"], b0["embed"]["tok"])


def test_federa_base_residual(su):
    """tests/test_system.py::test_federa_base_residual on the port: the
    base is rewritten so base + scaling·(BA)ᵀ ≈ the original W."""
    _, (b1, t1), (b0, _), model = _post_init_both(su, "federa")
    cfg = model.cfg
    scaling = cfg.adapter_alpha / cfg.adapter_rank
    for i in range(cfg.n_layers):
        w0 = b0["dec"]["layers"][i]["mlp"]["w1"]["w"].numpy()
        w1 = b1["dec"]["layers"][i]["mlp"]["w1"]["w"].numpy()
        mod = t1["adapters"]["dec"]["layers"][i]["mlp"]["w1"]
        delta = scaling * (mod["A"].numpy().T @ mod["B"].numpy().T)
        np.testing.assert_allclose(w1 + delta, w0, rtol=1e-3, atol=1e-4)
    wq0 = b0["dec"]["layers"][0]["attn"]["wq"]["w"]
    wq1 = b1["dec"]["layers"][0]["attn"]["wq"]["w"]
    mod = t1["adapters"]["dec"]["layers"][0]["attn"]["wq"]
    delta = scaling * (mod["A"].T @ mod["B"].T)
    np.testing.assert_allclose((wq1.reshape(delta.shape) + delta).numpy(),
                               wq0.reshape(delta.shape).numpy(), rtol=1e-3,
                               atol=1e-4)


STRATEGIES = ["ffa_lora", "ffa_lora_dr", "federa"]


@pytest.fixture(scope="module")
def runs(su):
    return {name: _jax_run(su, name) for name in STRATEGIES}


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("name", STRATEGIES)
def test_whole_run_matches_jax(su, runs, name, use_kernels):
    want, params = runs[name]
    strat = BL.all_strategies(RUN_KW["rounds"])[name]
    h = _port_run(su, strat, params, use_kernels)
    _assert_same_run(h, want)
    if name.startswith("ffa"):
        # tests/test_system.py::test_ffa_freezes_a: every A is bitwise the
        # post_init A (the gate zeroes A's updates), B has trained
        _, tr0 = strat.post_init(None, *params)
        for m0, m1 in zip(_modules(tr0["adapters"]),
                          _modules(h["trainable"]["adapters"])):
            assert torch.equal(m0["A"], m1["A"])
        assert float(_modules(h["trainable"]["adapters"])[0]["B"]
                     .abs().sum()) > 0


def test_jax_reference_ffa_freezes_a_too(su, runs):
    """The reference's own FFA run keeps its initial A (its test's check),
    so the port's bitwise check above holds the same property."""
    want, _ = runs["ffa_lora"]
    _, jm = _jax_model(su, "ffa_lora")
    _, jtr0 = jm.init(jax.random.key(0))
    m0 = _modules(bridge_tree(_np(jtr0))["adapters"])[0]
    m1 = _modules(bridge_tree(_np(want["trainable"]))["adapters"])[0]
    np.testing.assert_allclose(m0["A"].numpy(), m1["A"].numpy(), rtol=1e-6)
    assert isinstance(JBL.all_strategies()["ffa_lora"], JBL.FFALoRA)
