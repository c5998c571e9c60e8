"""The fused cohort runner (``repro_torch.fedsim.fused``) and the Adam
moment storage (``repro_torch.optim``), against ``tests/test_fused.py``'s
contracts: on the fast path the fused run's history equals the eager cohort
run's exactly (rtol 0), under dropout and stragglers and with FFA-LoRA's
optimizer gate too; ``eligible`` names every source of per-round host work
and an ineligible config runs eagerly; blocks never cross an eval round;
bf16 and int8 moments step as the reference's optimizer does on the same
numpy inputs (per client on a stacked cohort), count their bytes as the
reference does, and train as the f32 moments do within the reference's
tolerances (CPU)."""

import jax
import numpy as np
import pytest
import torch

from repro import optim as JOPT
from repro.configs.distilbert import MINI as JMINI
from repro.fedsim import fused as JFU
from repro.models import Model as JaxModel
from repro_torch import optim as OPT
from repro_torch.configs.distilbert import MINI
from repro_torch.data import synthetic as DATA
from repro_torch.federated import baselines as BL
from repro_torch.federated import server as SRV
from repro_torch.federated.partition import iid_partition
from repro_torch.fedsim import fused as FU
from repro_torch.models import Model
from repro_torch.pytree import leaves
from test_torch_baselines import _one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def su():
    """``tests/test_fused.py``'s setup: IID, so every client holds at least
    one batch (the fast path's precondition)."""
    cfg = MINI.with_(n_layers=2, layer_pattern=("attn",) * 2)
    train = DATA.make_classification(800, 20, cfg.vocab_size, 32, seed=1)
    test = DATA.make_classification(200, 20, cfg.vocab_size, 32, seed=2)
    return cfg, train, test, iid_partition(train.labels, 12, seed=0)


def _run(su, strategy="fedlora", rounds=8, **kw):
    cfg, train, test, parts = su
    strat = BL.all_strategies(rounds=rounds)[strategy]
    model = Model(cfg.with_(adapter_rank=strat.init_rank(cfg)),
                  peft=strat.peft)
    fc = SRV.FedConfig(rounds=rounds, clients_per_round=4, batch_size=16,
                       max_local_batches=kw.pop("max_local_batches", 2),
                       eval_every=4, lr=3e-3, runner="cohort", **kw)
    return SRV.run_federated(model, strat, parts, train, test, fc,
                             device="cpu")


def _eq_or_nan(a, b):
    return a == b or (a != a and b != b)


def _assert_history_parity(h_e, h_f):
    """Key-for-key equal histories: bytes, ranks, clock, losses and
    accuracies exactly (rtol 0)."""
    assert set(h_e) == set(h_f)
    assert len(h_e["rounds"]) == len(h_f["rounds"])
    for a, b in zip(h_e["rounds"], h_f["rounds"]):
        assert (a.rnd, a.down_bytes, a.up_bytes, a.live_ranks,
                a.dead_modules, a.trainable_params, a.sim_time_s) == \
            (b.rnd, b.down_bytes, b.up_bytes, b.live_ranks, b.dead_modules,
             b.trainable_params, b.sim_time_s)
        assert _eq_or_nan(a.loss, b.loss) and _eq_or_nan(a.acc, b.acc)
    assert h_e["comm_gb"] == h_f["comm_gb"]
    assert h_e["sim_time_s"] == h_f["sim_time_s"]
    assert h_e["acc"] == h_f["acc"]


# --------------------------------------------------------------------------
# fused ↔ eager parity
# --------------------------------------------------------------------------

@pytest.mark.parametrize("strategy,rounds,kw", [
    ("fedlora", 8, {}),
    ("fedlora", 8, dict(dropout=0.5, straggler=0.3, event_seed=3)),
    ("ffa_lora", 4, {})])
def test_fused_matches_eager_cohort_exactly(su, strategy, rounds, kw):
    """K = 4 blocks replay the eager cohort run exactly: the same round body,
    the same RNG draws in the same order, the same float-order bookkeeping;
    all-dropped rounds keep the carry; FFA-LoRA's gate rides through."""
    h_e = _run(su, strategy, rounds, fuse_rounds=1, **kw)
    h_f = _run(su, strategy, rounds, fuse_rounds=4, **kw)
    _assert_history_parity(h_e, h_f)
    for x, y in zip(leaves(h_e["trainable"]), leaves(h_f["trainable"])):
        assert torch.equal(x, y)
    assert h_f["sim_time_s"] > 0


def test_ineligible_config_runs_eagerly(su):
    """``fuse_rounds > 1`` with a codec takes the eager path: the same
    history as ``fuse_rounds = 1``."""
    h_e = _run(su, rounds=4, fuse_rounds=1, codec="int8")
    h_f = _run(su, rounds=4, fuse_rounds=4, codec="int8")
    _assert_history_parity(h_e, h_f)


def test_fused_blocks_never_cross_eval_boundary():
    for mod in (FU, JFU):
        fc = SRV.FedConfig(rounds=10, eval_every=4)
        assert mod._block_rounds(0, 16, fc) == [0, 1, 2, 3]
        assert mod._block_rounds(4, 2, fc) == [4, 5]
        assert mod._block_rounds(6, 16, fc) == [6, 7]
        assert mod._block_rounds(8, 16, fc) == [8, 9]
        fc1 = SRV.FedConfig(rounds=3, eval_every=10 ** 6)
        assert mod._block_rounds(0, 16, fc1) == [0, 1, 2]


def test_eligible_gates_every_host_work_source(su):
    _, _, _, parts = su
    strats = BL.all_strategies(rounds=8)
    ok_fc = SRV.FedConfig(rounds=8, batch_size=16)
    assert FU.eligible(ok_fc, strats["fedlora"], parts) == (True, "")
    cases = [
        (SRV.FedConfig(codec="int8", batch_size=16), "fedlora", "codec"),
        (SRV.FedConfig(secagg="mask", batch_size=16), "fedlora", "secagg"),
        (SRV.FedConfig(dp_clip=1.0, dp_noise_multiplier=0.5, batch_size=16),
         "fedlora", "DP"),
        (ok_fc, "fedara", "mask"),
        (ok_fc, "slora", "stage-1"),
        (SRV.FedConfig(rebucket=True, batch_size=16), "fedlora", "bucket")]
    for fc, name, frag in cases:
        ok, why = FU.eligible(fc, strats[name], parts)
        assert not ok and frag.lower() in why.lower(), (name, why)
    ragged = [p[:8] if i == 0 else p for i, p in enumerate(parts)]
    ok, why = FU.eligible(ok_fc, strats["fedlora"], ragged)
    assert not ok and "sub-batch" in why


# --------------------------------------------------------------------------
# Adam moment storage
# --------------------------------------------------------------------------

def _moment_inputs(c=None, seed=0):
    """Params and four grad trees (numpy), each client's scaled apart so
    that the int8 absmax scales differ per client."""
    rng = np.random.default_rng(seed)
    lead = () if c is None else (c,)
    scale = (1.0 if c is None
             else np.array([0.01, 1.0, 30.0])[:, None, None])
    p = {"a": rng.normal(size=lead + (5, 7)).astype(np.float32),
         "b": {"w": rng.normal(size=lead + (3, 4)).astype(np.float32)}}
    gs = [{"a": (rng.normal(size=lead + (5, 7)) * scale).astype(np.float32),
           "b": {"w": (rng.normal(size=lead + (3, 4)) * scale)
                 .astype(np.float32)}} for _ in range(4)]
    return p, gs


def _jax_steps(dtype, p, gs):
    opt = JOPT.adam(JOPT.linear_decay(3e-3, 8), state_dtype=dtype)
    st = opt.init(p)
    ups = []
    for g in gs:
        u, st = opt.update(g, st, p)
        ups.append(jax.tree.map(np.asarray, u))
    return ups, st


def _port_steps(dtype, p, gs, clients=False):
    opt = OPT.adam(OPT.linear_decay(3e-3, 8), state_dtype=dtype)
    pt = {"a": torch.tensor(p["a"]), "b": {"w": torch.tensor(p["b"]["w"])}}
    st = opt.init(pt, clients=clients)
    ups = []
    for g in gs:
        gt = {"a": torch.tensor(g["a"]), "b": {"w": torch.tensor(g["b"]["w"])}}
        u, st = opt.update(gt, st, pt)
        ups.append(u)
    return ups, st


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_adam_moment_storage_matches_reference(dtype):
    """Four steps on numpy inputs: the port's updates and stored moments
    equal the reference's (int8: q and scale bit for bit)."""
    p, gs = _moment_inputs()
    jups, jst = _jax_steps(dtype, p, gs)
    ups, st = _port_steps(dtype, p, gs)
    for ju, u in zip(jups, ups):
        for k in ("a",):
            np.testing.assert_allclose(u[k].numpy(), ju[k], rtol=1e-6,
                                       atol=1e-9)
        np.testing.assert_allclose(u["b"]["w"].numpy(), ju["b"]["w"],
                                   rtol=1e-6, atol=1e-9)
    mu, jmu = st["mu"]["a"], jst["mu"]["a"]
    if dtype == "int8":
        assert mu["q"].dtype == torch.int8 and mu["scale"].ndim == 0
        np.testing.assert_array_equal(mu["q"].numpy(), np.asarray(jmu["q"]))
        assert mu["scale"].item() == pytest.approx(float(jmu["scale"]),
                                                   rel=1e-6)
        assert st["nu"]["a"].dtype == torch.bfloat16
    else:
        assert str(mu.dtype).endswith(dtype)
    assert st["step"] == int(jst["step"])


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_stacked_moments_scale_per_client_as_the_reference_vmap(dtype):
    """On a stacked C = 3 cohort whose clients' grads differ by 3000× in
    scale, every client's update and int8 scale equal the reference's
    optimizer run on that client alone (its ``vmap`` over clients); a
    scale over the whole stack would crush the small client's momentum."""
    p, gs = _moment_inputs(c=3)
    ups, st = _port_steps(dtype, p, gs, clients=True)
    if dtype == "int8":
        assert st["mu"]["a"]["scale"].shape == (3,)
    for i in range(3):
        pi = {"a": p["a"][i], "b": {"w": p["b"]["w"][i]}}
        gi = [{"a": g["a"][i], "b": {"w": g["b"]["w"][i]}} for g in gs]
        jups, jst = _jax_steps(dtype, pi, gi)
        for ju, u in zip(jups, ups):
            np.testing.assert_allclose(u["a"][i].numpy(), ju["a"],
                                       rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(u["b"]["w"][i].numpy(),
                                       ju["b"]["w"], rtol=1e-6, atol=1e-9)
        if dtype == "int8":
            np.testing.assert_array_equal(st["mu"]["a"]["q"][i].numpy(),
                                          np.asarray(jst["mu"]["a"]["q"]))
            assert st["mu"]["a"]["scale"][i].item() == pytest.approx(
                float(jst["mu"]["a"]["scale"]), rel=1e-6)


def test_state_nbytes_matches_reference_on_mini():
    """``tests/test_fused.py::test_quantized_opt_state_bytes_on_mini``:
    4 + 2·4·n for f32, 4 + 2·2·n for bf16, less again for int8 — and each
    the reference's count on the same tree."""
    jcfg = JMINI.with_(n_layers=2, layer_pattern=("attn",) * 2)
    _, jtr = JaxModel(jcfg, peft="lora", unroll=True).init(jax.random.key(0))
    _, tr = Model(MINI.with_(n_layers=2, layer_pattern=("attn",) * 2),
                  peft="lora").init(0, "cpu")
    n_par = sum(t.numel() for t in leaves(tr))
    assert n_par == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jtr))
    sizes = {d: OPT.state_nbytes(OPT.adam(1e-3, state_dtype=d).init(tr))
             for d in ("float32", "bfloat16", "int8")}
    for d, got in sizes.items():
        assert got == JOPT.state_nbytes(JOPT.adam(1e-3, state_dtype=d)
                                        .init(jtr)), d
    assert sizes["float32"] == 4 + 2 * 4 * n_par
    assert sizes["bfloat16"] == 4 + 2 * 2 * n_par
    n_leaf = len(leaves(tr))
    assert sizes["int8"] == 4 + n_par + 4 * n_leaf + 2 * n_par
    stacked = OPT.state_nbytes(OPT.adam(1e-3, state_dtype="int8").init(
        {"w": torch.zeros(3, 5, 7)}, clients=True))
    assert stacked == 4 + 3 * 35 + 4 * 3 + 2 * 3 * 35
    with pytest.raises(ValueError, match="state_dtype"):
        OPT.adam(1e-3, state_dtype="fp8")


def test_quantized_opt_state_converges(su):
    """``tests/test_fused.py::test_quantized_opt_state_converges`` on the
    port: bf16 (int8) moments track the f32 losses within rtol 0.05 (0.15);
    bytes and the clock do not depend on the storage."""
    h32 = _run(su, rounds=4, fuse_rounds=4)
    for dtype, rtol in (("bfloat16", 0.05), ("int8", 0.15)):
        hq = _run(su, rounds=4, fuse_rounds=4, opt_state_dtype=dtype)
        for a, b in zip(h32["rounds"], hq["rounds"]):
            assert np.isfinite(b.loss)
            np.testing.assert_allclose(b.loss, a.loss, rtol=rtol)
        assert hq["comm_gb"] == h32["comm_gb"]
        assert hq["sim_time_s"] == h32["sim_time_s"]
