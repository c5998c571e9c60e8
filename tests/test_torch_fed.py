"""Port parity for the training slice's federated side: the synthetic data,
partitions and batch streams bit for bit; importance, MaskGen, the budget
schedule, FedArb, RankDet and CommPru exactly on the same numpy trees; the
CommPru wire; and end to end, ``tests/test_system.py``'s FedARA run (MINI
with 2 layers, 4 rounds) through ``repro.federated.server.run_federated``
and through the port from the same initial weights (CPU)."""

import jax
import numpy as np
import pytest
import torch

from repro.configs.distilbert import MINI as JMINI
from repro.configs.distilbert import SMOKE as JSMOKE
from repro.core import arbitration as JARB
from repro.core import comm as JCOMM
from repro.core import importance as JIMP
from repro.core import masks as JMK
from repro.core import pruning as JPR
from repro.core import schedule as JSCH
from repro.core.fedara import FedARA as JFedARA
from repro.data import synthetic as JDATA
from repro.federated import partition as JPART
from repro.federated import server as JSRV
from repro.federated.baselines import all_strategies
from repro.fedsim import transport as JT
from repro.fedsim.cohort import client_batch_rng as jax_client_batch_rng
from repro.models import Model as JaxModel
from repro_torch.bridge import bridge_tree, from_jax
from repro_torch.configs.distilbert import MINI
from repro_torch.core import arbitration as ARB
from repro_torch.core import comm as COMM
from repro_torch.core import importance as IMP
from repro_torch.core import masks as MK
from repro_torch.core import pruning as PR
from repro_torch.core import schedule as SCH
from repro_torch.core.fedara import FedARA
from repro_torch.data import synthetic as DATA
from repro_torch.federated import partition as PART
from repro_torch.federated import server as SRV
from repro_torch.fedsim import transport as T
from repro_torch.fedsim.cohort import client_batch_rng
from repro_torch.launch import fed_train
from repro_torch.models import Model
from repro_torch.pytree import flatten_with_paths


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    """A JAX numpy tree in the port's layout, leaves still numpy."""
    if isinstance(tree, dict):
        if "tail" in tree:
            return {"layers": [_port(tree["tail"][f"t{i}"])
                               for i in range(len(tree["tail"]))]}
        return {k: _port(v) for k, v in tree.items()}
    return np.asarray(tree)


def _same_tree(got, want):
    """Exact equality of two numpy trees in the port's layout."""
    g, w = flatten_with_paths(got), flatten_with_paths(_port(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), path


# --------------------------------------------------------------------------
# data, partitions, batch streams
# --------------------------------------------------------------------------

def test_data_partition_and_batch_streams_bit_for_bit():
    for seed in (1, 2):
        want = JDATA.make_classification(300, 20, 2048, 32, seed=seed)
        got = DATA.make_classification(300, 20, 2048, 32, seed=seed)
        assert np.array_equal(got.tokens, want.tokens)
        assert np.array_equal(got.labels, want.labels)
        assert got.tokens.dtype == want.tokens.dtype == np.int32
    labels = want.labels
    for got, want_ in ((PART.dirichlet_partition(labels, 10, 0.1, seed=0),
                        JPART.dirichlet_partition(labels, 10, 0.1, seed=0)),
                       (PART.pathological_partition(labels, 7, 2, 3),
                        JPART.pathological_partition(labels, 7, 2, 3))):
        assert len(got) == len(want_)
        assert all(np.array_equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(got, want_))
    for seed, rnd, cid in ((0, 0, 3), (5, 7, 11)):
        a, b = client_batch_rng(seed, rnd, cid), jax_client_batch_rng(
            seed, rnd, cid)
        assert np.array_equal(a.integers(0, 1 << 30, 16),
                              b.integers(0, 1 << 30, 16))
    data = DATA.Dataset(want.tokens, want.labels)
    for bt, bw in zip(DATA.batches(data, 16, client_batch_rng(0, 1, 2),
                                   epochs=2),
                      JDATA.batches(data, 16, jax_client_batch_rng(0, 1, 2),
                                    epochs=2)):
        assert all(np.array_equal(bt[k], bw[k]) for k in ("tokens", "labels"))


# --------------------------------------------------------------------------
# host rank allocation: the same numpy trees give the same answers exactly
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trees():
    """SMOKE adapters, grads and three local masks in the JAX layout, with
    one dead module and one half-pruned one in the global mask."""
    jm = JaxModel(JSMOKE, peft="bea", unroll=True)
    rng = np.random.default_rng(4)

    def fill(meta_tree, scale=1.0):
        return jax.tree.map(lambda m: (rng.normal(size=m.shape) * scale)
                            .astype(np.float32), meta_tree,
                            is_leaf=lambda x: hasattr(x, "init"))

    ad = fill(jm.adapter_meta())
    gr = fill(jm.adapter_meta(), 1e-2)
    glob = jax.tree.map(np.array, jm.init_masks())       # writable copies
    glob["dec"]["tail"]["t1"]["attn"]["wv"][:] = False
    glob["dec"]["tail"]["t0"]["mlp"]["w1"][::2] = False
    head = {"w": rng.normal(size=(JSMOKE.d_model, 20)).astype(np.float32),
            "b": rng.normal(size=20).astype(np.float32)}
    return dict(ad=ad, gr=gr, glob=glob, head=head)


@pytest.mark.parametrize("method", ["mag", "grad", "mixed", "sensitivity"])
def test_importance_scores_equal_reference_exactly(trees, method):
    tad = bridge_tree(trees["ad"])
    tgr = bridge_tree(trees["gr"])
    want, jema = JIMP.score_tree(trees["ad"], trees["gr"], method)
    got, ema = IMP.score_tree(tad, tgr, method)
    _same_tree(got, want)
    if method == "sensitivity":            # a second round folds the EMA
        want, _ = JIMP.score_tree(trees["ad"], trees["gr"], method,
                                  ema_state=jema)
        got, _ = IMP.score_tree(tad, tgr, method, ema_state=ema)
        _same_tree(got, want)


def test_masks_schedule_and_arbitration_equal_reference_exactly(trees):
    scores, _ = JIMP.score_tree(trees["ad"], None, "mag")
    tscores, _ = IMP.score_tree(bridge_tree(trees["ad"]), None, "mag")
    n = JMK.total_ranks(scores)
    assert MK.total_ranks(tscores) == n
    local = []
    for b in (0, 1, 7, n // 2, n - 1, n):
        want = JMK.generate_local_masks(scores, b)
        got = MK.generate_local_masks(tscores, b)
        _same_tree(got, want)
        assert MK.count_true(got) == JMK.count_true(want) == b
        local.append((got, want))
    kw = dict(b0=n, b_target=n // 4, t_warmup=2, t_final=3)
    for total in (4, 10, 30):
        assert [SCH.rank_budget(t, total_rounds=total, **kw)
                for t in range(total)] == JSCH.budget_series(total, **kw)
    for th in (0.0, 0.5, 2 / 3):
        for prev in (None, trees["glob"]):
            want = JARB.arbitrate([w for _, w in local[2:5]], th, prev)
            got = ARB.arbitrate([g for g, _ in local[2:5]], th,
                                None if prev is None else _port(prev))
            _same_tree(got, want)
    assert MK.topk_margin(tscores, n // 2) > 0


def test_pruning_and_comm_equal_reference_exactly(trees):
    ad, glob = trees["ad"], trees["glob"]
    tad, tglob = bridge_tree(ad), _port(glob)
    assert len(PR.dead_modules(tglob)) == len(JPR.dead_modules(glob)) == 1
    assert PR.dead_modules(tglob) == ["dec.layers.1.attn.wv"]
    gate, jgate = PR.trainable_gate(tad, tglob), JPR.trainable_gate(ad, glob)
    for (path, g), (_, jg) in zip(flatten_with_paths(gate),
                                  flatten_with_paths(_port(_np(jgate)))):
        assert np.all(jg == float(g)), path
    for masks in (None, glob):
        tm = None if masks is None else _port(masks)
        assert COMM.count_params(tad, tm) == JCOMM.count_params(ad, masks)
        assert COMM.bytes_down(tad, tm) == JCOMM.bytes_down(ad, masks)
        assert COMM.bytes_up(tad, tm, 2) == JCOMM.bytes_up(ad, masks, 2)
        assert np.array_equal(COMM.pack(tad, tm), JCOMM.pack(ad, masks))
    _same_tree(_unflat_np(COMM.prune_tree(tad, tglob)),
               _np(JCOMM.prune_tree(ad, glob)))
    assert PR.count_trainable(tad) == JPR.count_trainable(ad)

    full = {"adapters": ad, "head": trees["head"]}
    tfull = {"adapters": tad, "head": bridge_tree(trees["head"])}
    wire = T.flatten_update(tfull, tglob)
    assert np.array_equal(wire, JT.flatten_update(full, glob))
    _same_tree(T.unflatten_update(wire, tfull, tglob),
               _np(JT.unflatten_update(wire, full, glob)))
    assert T.mask_wire_bytes(tglob) == JT.mask_wire_bytes(glob)
    s, js = FedARA(), JFedARA()
    assert s.comm_down(tfull, tglob) == js.comm_down(full, glob)
    assert s.comm_up(tfull, None) == js.comm_up(full, None)
    og = s.optimizer_gate(tfull, tglob)
    assert float(og["head"]["w"]) == 1.0
    assert float(og["adapters"]["dec"]["layers"][1]["attn"]["wv"]["A"]) == 0


def _unflat_np(tree):
    if isinstance(tree, dict):
        return {k: _unflat_np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unflat_np(v) for v in tree]
    return tree.numpy()


def test_fedavg_weighted_mean():
    trees = [{"w": torch.tensor([1.0, 2.0])}, {"w": torch.tensor([3.0, 6.0])}]
    out = SRV.fedavg(trees, [1.0, 3.0])
    np.testing.assert_allclose(out["w"].numpy(), [2.5, 5.0])


# --------------------------------------------------------------------------
# end to end: tests/test_system.py's FedARA run, JAX and port
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def system_run():
    jcfg = JMINI.with_(n_layers=2, layer_pattern=("attn",) * 2)
    train = JDATA.make_classification(600, 20, jcfg.vocab_size, 32, seed=1)
    test = JDATA.make_classification(200, 20, jcfg.vocab_size, 32, seed=2)
    parts = JPART.dirichlet_partition(train.labels, 10, alpha=0.1, seed=0)
    kw = dict(rounds=4, clients_per_round=3, batch_size=16,
              max_local_batches=3, eval_every=4, lr=3e-3)
    strat = all_strategies(rounds=4)["fedara"]
    strat.total_rounds, strat.warmup_rounds = 4, 1
    strat.final_rounds_frac = 0.25
    jm = JaxModel(jcfg, peft=strat.peft, unroll=True)
    want = JSRV.run_federated(jm, strat, parts, train, test,
                              JSRV.FedConfig(**kw))
    base, tr = jm.init(jax.random.key(0))          # _init_run's weights
    params = from_jax(_np(base), _np(tr), None)[:2]
    cfg = MINI.with_(n_layers=2, layer_pattern=("attn",) * 2)
    data = (DATA.Dataset(train.tokens, train.labels),
            DATA.Dataset(test.tokens, test.labels))
    return dict(want=want, cfg=cfg, parts=parts, data=data, kw=kw,
                params=params)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_fedara_round_trip_matches_jax(system_run, use_kernels):
    """Per round: bytes, live ranks, dead modules and trainable counts
    equal, losses within rtol 1e-3, the simulated clock equal; then the
    four assertions of ``tests/test_system.py::test_fedara_round_trip``."""
    sr = system_run
    strat = FedARA(total_rounds=4, warmup_rounds=1, final_rounds_frac=0.25)
    model = Model(sr["cfg"], peft=strat.peft, use_kernels=use_kernels)
    h = SRV.run_federated(model, strat, sr["parts"], *sr["data"],
                          SRV.FedConfig(**sr["kw"]), device="cpu",
                          params=sr["params"])
    logs, jlogs = h["rounds"], sr["want"]["rounds"]
    assert len(logs) == len(jlogs) == 4
    for a, b in zip(logs, jlogs):
        if a.live_ranks != b.live_ranks:
            scores, _ = IMP.score_tree(h["trainable"]["adapters"], None)
            pytest.fail(f"masks diverge first in round {a.rnd}: live ranks "
                        f"{a.live_ranks} vs {b.live_ranks}; the port's final "
                        f"top-k score margin there is "
                        f"{MK.topk_margin(scores, b.live_ranks)}")
        assert (a.down_bytes, a.up_bytes, a.dead_modules,
                a.trainable_params) == (b.down_bytes, b.up_bytes,
                                        b.dead_modules, b.trainable_params)
        assert a.loss == pytest.approx(b.loss, rel=1e-3)
        assert a.sim_time_s == b.sim_time_s
    n_eval = min(200 // 16, 16) * 16
    assert abs(h["final_acc"] - sr["want"]["final_acc"]) <= 1 / n_eval
    assert h["comm_gb"] == sr["want"]["comm_gb"]
    _same_tree(h["masks"], sr["want"]["masks"])
    # tests/test_system.py::test_fedara_round_trip, on the port's history
    assert logs[-1].down_bytes < logs[0].down_bytes
    lives = [lg.live_ranks for lg in logs]
    assert all(a >= b for a, b in zip(lives, lives[1:]))
    assert lives[-1] < lives[0]
    assert not np.isnan(h["final_acc"])


# --------------------------------------------------------------------------
# entry points: the card unless asked for the CPU; unported options raise
# --------------------------------------------------------------------------

def test_run_federated_and_cli_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot show")
    train = DATA.make_classification(40, 4, MINI.vocab_size, 8, seed=1)
    parts = PART.dirichlet_partition(train.labels, 2, 0.5)
    model = Model(MINI.with_(n_layers=1, layer_pattern=("attn",)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SRV.run_federated(model, FedARA(total_rounds=1), parts, train, train,
                          SRV.FedConfig(rounds=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fed_train.main(["--rounds", "1", "--clients", "2"])


@pytest.mark.parametrize("argv", [
    ["--runner", "cohort", "--dropout", "0.3", "--straggler", "0.5"],
    ["--runner", "async", "--buffer-k", "2", "--event-seed", "7"],
    ["--runner", "cohort", "--fuse-rounds", "2",
     "--opt-state-dtype", "int8"]])
def test_fed_train_cli_runs_the_fedsim_runners_on_cpu(capsys, argv):
    """The cohort, async and fused runners through the CLI with the
    reference's flags (they raised before they were ported)."""
    h = fed_train.main(["--strategy", "fedlora", "--rounds", "2",
                        "--clients", "4", "--clients-per-round", "2",
                        "--device", "cpu"] + argv)
    out = capsys.readouterr().out
    assert len(h["rounds"]) == 2 and "device=cpu" in out
    assert h["sim_time_s"] > 0 and np.isfinite(h["final_acc"])
    assert ("events" in h) == ("async" in argv)


@pytest.mark.parametrize("strategy,rounds", [
    ("fedlora", 2), ("slora", 3), ("fedadapter_h", 2), ("fedadapter_p", 2),
    ("federa", 2), ("ffa_lora", 2), ("ffa_lora_dr", 2), ("fedsvd", 2)])
def test_fed_train_cli_runs_the_baselines_on_cpu(capsys, strategy, rounds):
    """Every baseline runs through the CLI (they raised before they were
    ported); SLoRA prints the reference's ``stage1:`` line."""
    h = fed_train.main(["--strategy", strategy, "--rounds", str(rounds),
                        "--clients", "4", "--clients-per-round", "2",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(h["rounds"]) == rounds and "device=cpu" in out
    assert h["rounds"][0].down_bytes == h["rounds"][-1].down_bytes \
        or strategy == "slora"
    if strategy == "slora":
        assert "stage1: 1 rounds  up " in out and "clipped 0" in out
        assert h["stage1"]["rounds"] == 1
    else:
        assert "stage1:" not in out


def test_fed_train_cli_on_cpu(capsys):
    with pytest.raises(SystemExit):         # argparse: not a choice
        fed_train.main(["--strategy", "nope", "--device", "cpu"])
    h = fed_train.main(["--rounds", "2", "--clients", "4",
                        "--clients-per-round", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "round   1" in out and "device=cpu" in out
    assert len(h["rounds"]) == 2 and h["rounds"][1].live_ranks < 288
