"""Port parity of whole seq runs over the compressed and private wire: FedARA
under each lossy codec (int8, topk, signsgd, powersgd), under secure
aggregation (identity and signsgd), under the DP clip alone and with noise,
and SLoRA with the clip, a codec and secure aggregation in its stage 1, on
``tests/test_system.py``'s MINI (2 layers) through
``repro.federated.server.run_federated`` and through the port from the same
bridged weights (CPU).  In every run the bytes, ranks, masks, simulated
clock, ``secagg_rounds``, ``dp_eps`` and clip counts are exact and the
losses within the baselines' tolerance.  Then the new ``fed_train`` flags
through ``main``.  Helpers from ``tests/test_torch_baselines.py``."""

import jax
import numpy as np
import pytest

from repro.federated import server as JSRV
from repro.launch import fed_train as jfed_train
from repro_torch.bridge import bridge_tree, from_jax
from repro_torch.federated import baselines as BL
from repro_torch.federated import server as SRV
from repro_torch.fedsim import transport as T
from repro_torch.launch import fed_train
from repro_torch.models import Model
from test_torch_baselines import _one_thread  # noqa: F401 (autouse)
from test_torch_baselines import (RUN_KW, _assert_same_run, _jax_model, _np,
                                  _setup)
from test_torch_fed import _same_tree

RUNS = {
    "int8": ("fedara", dict(codec="int8")),
    "topk": ("fedara", dict(codec="topk")),
    "signsgd": ("fedara", dict(codec="signsgd")),
    "powersgd": ("fedara", dict(codec="powersgd", powersgd_rank=3)),
    "secagg": ("fedara", dict(secagg="mask", clients_per_round=3)),
    "secagg-signsgd": ("fedara", dict(secagg="mask", codec="signsgd",
                                      clients_per_round=3)),
    "dp-clip": ("fedara", dict(dp_clip=0.05)),
    "dp-noise": ("fedara", dict(dp_clip=0.05, dp_noise_multiplier=1.0)),
    "slora-dp-clip": ("slora", dict(dp_clip=0.05)),
    "slora-signsgd": ("slora", dict(codec="signsgd", dp_clip=0.05)),
    "slora-secagg": ("slora", dict(codec="signsgd", secagg="mask",
                                   dp_clip=0.05, dp_noise_multiplier=0.5,
                                   clients_per_round=3)),
}


@pytest.fixture(scope="module")
def su():
    return _setup()


def _strategies(su, name):
    """The reference's strategy and model, and the port's strategy set up
    alike: FedARA prunes from round 1 on; SLoRA carries the reference's
    gate across (its own draws from Python's salted ``hash``)."""
    jstrat, jm = _jax_model(su, name)
    strat = BL.all_strategies(rounds=RUN_KW["rounds"])[name]
    for s in (jstrat, strat):
        if name == "fedara":
            s.warmup_rounds, s.final_rounds_frac = 1, 0.34
    if name == "slora":
        gate = bridge_tree(_np(jstrat.sparse_gate(jm.init(
            jax.random.key(0))[0], 0)))
        strat.sparse_gate = lambda base, seed=0: gate
    return jstrat, jm, strat


def _runs(su, key):
    name, kw = RUNS[key]
    jstrat, jm, strat = _strategies(su, name)
    fkw = dict(RUN_KW, **kw)
    want = JSRV.run_federated(jm, jstrat, su["parts"], su["train"],
                              su["test"], JSRV.FedConfig(**fkw))
    base, tr = jm.init(jax.random.key(0))
    cfg = su["cfg"]
    model = Model(cfg.with_(adapter_rank=strat.init_rank(cfg)),
                  peft=strat.peft)
    h = SRV.run_federated(model, strat, su["parts"], *su["data"],
                          SRV.FedConfig(**fkw), device="cpu",
                          params=from_jax(_np(base), _np(tr), None)[:2])
    return h, want


def fkw_clients(kw):
    return kw.get("clients_per_round", RUN_KW["clients_per_round"])


@pytest.mark.parametrize("key", list(RUNS))
def test_private_and_compressed_run_matches_jax(su, key):
    """Per round: bytes, trainable counts, live ranks, dead modules and the
    clock equal, losses within 1e-3; the final masks, ``secagg_rounds``
    (phase bytes and times, recovery bytes, dropped and clipped counts),
    the ε trajectory, the ``dp`` summary and SLoRA's stage-1 stats
    (clipped count included) equal."""
    h, want = _runs(su, key)
    _assert_same_run(h, want)
    if want["masks"] is not None:
        _same_tree(h["masks"], want["masks"])
    assert h["secagg_rounds"] == want["secagg_rounds"]
    assert h["dp_eps"] == want["dp_eps"]
    assert h.get("dp") == want.get("dp")
    name, kw = RUNS[key]
    n_private = RUN_KW["rounds"] if "secagg" in kw else 0
    assert len(h["secagg_rounds"]) == n_private
    assert all(r["n_dropped"] == 0 and r["recovery_bytes"] == 0
               and not r["aborted"] for r in h["secagg_rounds"])
    assert len(h["dp_eps"]) == (RUN_KW["rounds"]
                                if kw.get("dp_noise_multiplier") else 0)
    if name == "fedara":
        lives = [lg.live_ranks for lg in h["rounds"]]
        assert lives[-1] < lives[0]            # the masks did prune
    if "dp_clip" in kw and "secagg" in kw:     # every upload clipped
        assert [r["n_clipped"] for r in h["secagg_rounds"]] == \
            [fkw_clients(kw)] * RUN_KW["rounds"]
    if name == "slora" and "dp_clip" in kw:     # every stage-1 upload
        assert h["stage1"]["n_clipped"] == fkw_clients(kw)


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

PRIVATE_ARGV = ["--rounds", "2", "--clients", "4", "--clients-per-round",
                "3", "--codec", "signsgd", "--secagg", "mask", "--dp-clip",
                "1.0", "--dp-noise-multiplier", "1.0"]


def _tail_lines(out, *prefixes):
    return [ln for ln in out.splitlines() if ln.startswith(prefixes)]


def test_fed_train_cli_privacy_flags_print_the_reference_lines(capsys):
    """``--codec signsgd --secagg mask --dp-clip --dp-noise-multiplier``:
    the protocol-bytes and ε lines equal the reference CLI's (two rounds:
    the masks prune after the second, so neither line depends on the
    weights, which the two CLIs draw differently)."""
    h = fed_train.main(PRIVATE_ARGV + ["--device", "cpu"])
    out = capsys.readouterr().out
    jfed_train.main(PRIVATE_ARGV)
    jout = capsys.readouterr().out
    lines = _tail_lines(out, "secagg:", "DP:")
    assert len(lines) == 2 and lines == _tail_lines(jout, "secagg:", "DP:")
    assert len(h["secagg_rounds"]) == 2 and h["dp"]["clip"] == 1.0


def test_fed_train_cli_codec_and_secagg_knobs(capsys, monkeypatch):
    """``--powersgd-rank`` sets q in the first round's upload bytes;
    ``--secagg-threshold`` and ``--secagg-bits`` reach the run's config and
    the bits price the masked upload; a privacy mode with a codec that is
    not field-exact is refused."""
    h = fed_train.main(["--rounds", "1", "--clients", "4",
                        "--clients-per-round", "2", "--codec", "powersgd",
                        "--powersgd-rank", "3", "--device", "cpu"])
    n = T.flatten_update(h["trainable"], None).size
    m = int(np.ceil(np.sqrt(n)))
    mask_bytes = T.mask_wire_bytes(h["masks"])
    assert h["rounds"][0].up_bytes == \
        2 * (4 * 3 * (m + -(-n // m)) + T.HEADER_BYTES + mask_bytes)
    seen = []

    def run(*args, **kw):
        seen.append(args[5])
        return SRV.run_federated(*args, **kw)

    monkeypatch.setattr(fed_train, "run_federated", run)
    h = fed_train.main(["--rounds", "1", "--clients", "4",
                        "--clients-per-round", "3", "--secagg", "mask",
                        "--secagg-threshold", "1.0", "--secagg-bits", "40",
                        "--device", "cpu"])
    assert (seen[0].secagg_threshold, seen[0].secagg_bits) == (1.0, 40)
    n_votes = 8 * mask_bytes
    L = n + 1 + n_votes                  # wire, weight, one-hot rank votes
    assert h["secagg_rounds"][0]["phases"]["masked"]["up"] == \
        3 * ((L * 40 + 7) // 8 + T.HEADER_BYTES)
    assert "secagg: 1 rounds" in capsys.readouterr().out
    with pytest.raises(ValueError, match="field-exact"):
        fed_train.main(["--codec", "int8", "--secagg", "mask",
                        "--device", "cpu"])
