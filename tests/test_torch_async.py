"""Port parity for the async (FedBuff) runner (``repro_torch.fedsim.runner.
run_async``): on ``tests/test_fedsim.py``'s setup (MINI with 2 layers, 10
Dirichlet(0.1) clients, batch 16, 3 local batches, lr 3e-3) the port's
event log equals the reference's exactly and its per-round losses are
within the whole-run tolerance, from the same bridged weights; the
reference's determinism and staleness checks on the port; FedARA's masks
under async (CPU)."""

import numpy as np
import pytest

from repro.federated import server as JSRV
from repro_torch.federated import server as SRV
from repro_torch.fedsim import runner as FR
from test_torch_baselines import _one_thread  # noqa: F401 (autouse)
from test_torch_cohort import assert_parity, jax_run, port_run, su  # noqa: F401

LOSS_RTOL = 1e-3          # the port's whole-run tolerance (test_torch_fed.py)
KW = dict(name="fedlora", buffer_k=2, straggler=0.3, event_seed=7)


@pytest.fixture(scope="module")
def runs(su):  # noqa: F811
    want, params = jax_run(su, "async", **KW)
    return dict(want=want, params=params,
                h1=port_run(su, "async", params, **KW),
                h2=port_run(su, "async", params, **KW))


def test_async_events_equal_the_reference(runs):
    h, want = runs["h1"], runs["want"]
    assert h["events"] == want["events"]
    assert_parity(h, want, loss_rtol=LOSS_RTOL, loss_atol=0.0)
    assert [lg.staleness for lg in h["rounds"]] == \
        [lg.staleness for lg in want["rounds"]]
    assert set(h) == set(want)


def test_async_seeded_determinism(su, runs):  # noqa: F811
    """``tests/test_fedsim.py::test_async_seeded_determinism``."""
    h1, h2 = runs["h1"], runs["h2"]
    assert h1["events"] == h2["events"]
    assert [lg.loss for lg in h1["rounds"]] == [lg.loss for lg in h2["rounds"]]
    assert h1["sim_time_s"] == h2["sim_time_s"]
    h3 = port_run(su, "async", runs["params"], **dict(KW, event_seed=8))
    assert h1["events"] != h3["events"]


def test_async_staleness_is_tracked(runs):
    """``tests/test_fedsim.py::test_async_staleness_is_tracked``."""
    h = runs["h1"]
    assert len(h["rounds"]) == 3
    assert any(lg.staleness > 0 for lg in h["rounds"])
    assert all(np.isfinite(lg.loss) for lg in h["rounds"])
    assert h["comm_gb"] > 0


def test_async_fedara_masks_equal_the_reference(su):  # noqa: F811
    """FedARA under async: every buffered aggregation arbitrates the
    buffer's local masks; ranks, masks, bytes and events as the
    reference's."""
    kw = dict(buffer_k=3, dropout=0.2, event_seed=1)
    want, params = jax_run(su, "async", **kw)
    h = port_run(su, "async", params, **kw)
    assert h["events"] == want["events"]
    assert_parity(h, want, loss_rtol=LOSS_RTOL, loss_atol=0.0)


def test_async_refuses_privacy_and_helpers_match():
    with pytest.raises(ValueError, match="async"):
        SRV.validate_config(SRV.FedConfig(runner="async", secagg="mask"))
    with pytest.raises(ValueError, match="unknown runner"):
        SRV.validate_config(SRV.FedConfig(runner="nope"))
    from repro.fedsim import runner as JFR
    for n in (0, 5, 16, 40, 200):
        for fc, jfc in ((SRV.FedConfig(batch_size=16, max_local_batches=3),
                         JSRV.FedConfig(batch_size=16, max_local_batches=3)),
                        (SRV.FedConfig(batch_size=8, local_epochs=2),
                         JSRV.FedConfig(batch_size=8, local_epochs=2))):
            assert FR._n_local_batches(n, fc) == JFR._n_local_batches(n, jfc)
    fc = SRV.FedConfig(seed=3, event_seed=5)
    jfc = JSRV.FedConfig(seed=3, event_seed=5)
    assert np.array_equal(FR._event_rng(fc).random(8),
                          JFR._event_rng(jfc).random(8))
    assert [FR._compute_s(c, fc, 3, 4.0) for c in range(6)] == \
        [JFR._compute_s(c, jfc, 3, 4.0) for c in range(6)]
    assert [FR.device_of(c) for c in range(6)] == \
        [JFR.device_of(c) for c in range(6)]
