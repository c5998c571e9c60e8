"""Port parity for ``repro/secagg/`` and aggregate-only FedArb: the field's
encode, add, sum and decode (saturation included), the pair and self masks,
the Shamir byte formulas, ``run_round``'s costs with and without dropouts
and its abort below threshold, ``aggregate_round`` (a missing upload's
masks recovered, DP noise, vote sums), the DP clip, RDP, ε and noise,
``arbitrate_from_votes``, and every refusal of
``tests/test_secagg.py::test_privacy_config_validation``, each on the same
numpy inputs made from a seed as the reference (CPU)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import arbitration as JARB
from repro.core.fedara import FedARA as JFedARA
from repro.federated.server import FedConfig as JFedConfig
from repro.federated.server import validate_privacy_config as jvalidate
from repro.fedsim import transport as JT
from repro.secagg import dp as JDP
from repro.secagg import field as JF
from repro.secagg import masking as JMSK
from repro.secagg import protocol as JSA
from repro_torch.core import arbitration as ARB
from repro_torch.core.fedara import FedARA
from repro_torch.federated.server import (FedConfig, validate_config,
                                          validate_privacy_config)
from repro_torch.fedsim import transport as T
from repro_torch.fedsim.pipeline import EncodedUpdate
from repro_torch.secagg import dp as DP
from repro_torch.secagg import field as F
from repro_torch.secagg import masking as MSK
from repro_torch.secagg import protocol as SA


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# --------------------------------------------------------------------------
# field
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bits,frac_bits,clip", [(32, 16, 8.0), (16, 8, 2.0),
                                                 (62, 24, 8.0)])
def test_field_encode_add_sum_decode_with_saturation(bits, frac_bits, clip):
    """Elements beyond ±clip saturate; every field op and the decoded sum
    equal the reference's bit for bit, and so do the spec's bounds."""
    spec, jspec = F.FieldSpec(bits, frac_bits, clip), \
        JF.FieldSpec(bits, frac_bits, clip)
    rng = np.random.default_rng(bits)
    vecs = [(rng.standard_normal(300) * clip * 0.8).astype(np.float32)
            for _ in range(3)]
    vecs[0][:5] = [clip * 3, -clip * 3, clip, -clip, 0.0]   # saturation
    enc = [spec.encode(v) for v in vecs]
    for e, v in zip(enc, vecs):
        _same(e, jspec.encode(v))
    _same(spec.add(enc[0], enc[1]), jspec.add(enc[0], enc[1]))
    _same(spec.sub(enc[0], enc[1]), jspec.sub(enc[0], enc[1]))
    _same(spec.neg(enc[2]), jspec.neg(enc[2]))
    s, js = F.sum_encoded(enc, spec), JF.sum_encoded(enc, jspec)
    _same(s, js)
    _same(spec.decode_sum(s), jspec.decode_sum(js))
    assert spec.decode_sum(spec.encode(vecs[0]))[0] == clip      # saturated
    _same(F.sum_encoded([], spec), JF.sum_encoded([], jspec))
    assert (spec.modulus, spec.scale, spec.q_max, spec.max_clients(),
            spec.wire_bytes(301), spec.resolution) == \
        (jspec.modulus, jspec.scale, jspec.q_max, jspec.max_clients(),
         jspec.wire_bytes(301), jspec.resolution)


def test_field_spec_refusals_match_the_reference():
    for kw in ({"bits": 7}, {"bits": 63}, {"bits": 16, "frac_bits": 15}):
        for cls in (F.FieldSpec, JF.FieldSpec):
            with pytest.raises(ValueError):
                cls(**kw)
    spec = F.FieldSpec(bits=16, frac_bits=8, clip=8.0)
    spec.check_headroom(spec.max_clients())
    with pytest.raises(ValueError, match="overflows"):
        spec.check_headroom(spec.max_clients() + 1)


# --------------------------------------------------------------------------
# masks and Shamir accounting
# --------------------------------------------------------------------------

def test_pair_and_self_masks_match_and_cancel():
    spec, jspec = F.FieldSpec(), JF.FieldSpec()
    for seed, i, j in [(0, 0, 1), (100_003, 4, 2), (7, 3, 9)]:
        m = MSK.pair_mask(seed, i, j, 257, spec)
        _same(m, JMSK.pair_mask(seed, i, j, 257, jspec))
        _same(m, MSK.pair_mask(seed, j, i, 257, spec))       # symmetric
        _same(MSK.self_mask(seed, i, 257, spec),
              JMSK.self_mask(seed, i, 257, jspec))
    parts = [2, 5, 7]
    x = {c: spec.encode(np.random.default_rng(c).standard_normal(64))
         for c in parts}
    y = {c: MSK.mask_input(x[c], 11, c, parts, spec) for c in parts}
    for c in parts:
        _same(y[c], JMSK.mask_input(x[c], 11, c, parts, jspec))
    agg = F.sum_encoded(list(y.values()), spec)
    for c in parts:
        agg = spec.sub(agg, MSK.self_mask(11, c, 64, spec))
    _same(agg, F.sum_encoded(list(x.values()), spec))        # masks cancel


@pytest.mark.parametrize("n,frac", [(1, 2 / 3), (3, 2 / 3), (10, 0.5),
                                    (7, 1.0), (5, 0.01)])
def test_shamir_byte_formulas_and_threshold(n, frac):
    t = MSK.threshold_for(n, frac)
    assert t == JMSK.threshold_for(n, frac)
    sh, jsh = MSK.ShamirSpec(n, t), JMSK.ShamirSpec(n, t)
    assert sh.deal_bytes_per_client() == jsh.deal_bytes_per_client()
    for surv in range(n + 1):
        drop = n - surv
        assert sh.unmask_bytes_per_survivor(surv, drop) == \
            jsh.unmask_bytes_per_survivor(surv, drop)
        assert sh.recovery_bytes(surv, drop) == jsh.recovery_bytes(surv, drop)
        assert sh.can_reconstruct(surv) == jsh.can_reconstruct(surv)
    with pytest.raises(ValueError):
        MSK.ShamirSpec(n, n + 1)


# --------------------------------------------------------------------------
# the protocol round
# --------------------------------------------------------------------------

def _link_of(links):
    return lambda cid: links[cid % len(links)]


def _same_round(sa, jsa):
    assert (sa.participants, sa.survivors, sa.dropped, sa.threshold,
            sa.recovery_bytes, sa.aborted) == \
        (jsa.participants, jsa.survivors, jsa.dropped, jsa.threshold,
         jsa.recovery_bytes, jsa.aborted)
    assert list(sa.phases) == list(jsa.phases) == list(SA.PHASES)
    for k in sa.phases:
        assert dataclasses.asdict(sa.phases[k]) == \
            dataclasses.asdict(jsa.phases[k]), k
    assert (sa.down_bytes, sa.up_bytes, sa.time_s) == \
        (jsa.down_bytes, jsa.up_bytes, jsa.time_s)
    for a, b in ((sa.sum_vec, jsa.sum_vec), (sa.field_sum, jsa.field_sum)):
        assert (a is None) == (b is None)
        if b is not None:
            _same(a, b)


@pytest.mark.parametrize("dropped,parts", [([], [0, 3, 4, 8]),
                                           ([4], [0, 3, 4, 8]),
                                           ([0, 3, 8], [0, 3, 4, 8])])
def test_run_round_costs_recovery_and_abort(dropped, parts):
    """No dropout, one dropout (its pair masks recovered from the
    survivors' shares) and three of four dropped (below the ⌈2/3·4⌉ = 3
    threshold: the round aborts after paying its first phases)."""
    rng = np.random.default_rng(len(dropped))
    wires = {c: rng.standard_normal(50 + 7 * c).astype(np.float32)
             for c in parts if c not in dropped}
    links = [T.link_for(d) for d in ("rpi5", "orin_nano", "agx_orin")]
    jlinks = [JT.link_for(d) for d in ("rpi5", "orin_nano", "agx_orin")]
    sa = SA.run_round(wires, parts, dropped, SA.SecAggConfig(), 42,
                      _link_of(links))
    jsa = JSA.run_round(wires, parts, dropped, JSA.SecAggConfig(), 42,
                        _link_of(jlinks))
    _same_round(sa, jsa)
    assert sa.aborted == (len(dropped) == 3)
    if not sa.aborted:       # the survivors' plain sum, up to the field grid
        L = SA.agree_length(wires)
        plain = sum(np.pad(w, (0, L - w.size)) for w in wires.values())
        assert np.abs(sa.sum_vec - plain).max() <= \
            len(wires) * SA.SecAggConfig().field.resolution
    with pytest.raises(ValueError, match="surviving"):
        SA.run_round({}, parts, [], SA.SecAggConfig(), 1)


def _uploads(cids, n, rng, votes=True, clipped=()):
    return [EncodedUpdate(
        cid=c, wire=(rng.standard_normal(n) * 0.3).astype(np.float32),
        delta=None, nbytes=0, weight=float(10 + 7 * c),
        votes={"b": rng.random(6) < 0.5, "a": rng.random(4) < 0.5}
        if votes else None, clipped=c in clipped) for c in cids]


def _unflatten(wire, like, masks_np):
    return {"w": wire}


def _jax_unflatten(wire, like, masks_np):
    return {"w": jnp.asarray(wire)}


@pytest.mark.parametrize("case", [
    dict(secagg="mask"),
    dict(secagg="mask", dropped=[6]),
    dict(secagg="mask", dp_clip=1.0, dp_noise_multiplier=1.1),
    dict(dp_clip=1.0, dp_noise_multiplier=0.7),
    dict(dp_clip=1.0),
    dict(secagg="mask", dropped=[1, 6, 9]),
], ids=["secagg", "secagg-dropout", "secagg-dp", "dp-noise", "dp-clip",
        "abort"])
def test_aggregate_round_matches_reference(case):
    """``aggregate_round`` over encoded uploads, a missing upload's masks
    recovered from the survivors' shares: the new trainable (a tensor on
    ``bc``'s device), the vote sums, the reporting count, every protocol
    byte and second, the clip count and the noise std equal the
    reference's."""
    case = dict(case)
    dropped = case.pop("dropped", [])
    participants = [1, 4, 6, 9]
    rng = np.random.default_rng(3)
    ups = _uploads([c for c in participants if c not in dropped], 40, rng,
                   clipped={4})
    kw = dict(seed=5, clients_per_round=len(participants), **case)
    fc, jfc = FedConfig(**kw), JFedConfig(**kw)
    bc = {"w": torch.linspace(-1, 1, 40)}
    jbc = {"w": jnp.asarray(bc["w"].numpy())}
    out = SA.aggregate_round(bc, ups, participants, None, fc, 2,
                             unflatten=_unflatten)
    jout = JSA.aggregate_round(jbc, ups, participants, None, jfc, 2,
                               unflatten=_jax_unflatten)
    assert isinstance(out.trainable["w"], torch.Tensor)
    _same(out.trainable["w"].numpy(), np.asarray(jout.trainable["w"]))
    assert (out.n_reporting, out.up_bytes, out.down_bytes, out.time_s,
            out.n_clipped, out.noise_std, out.aborted) == \
        (jout.n_reporting, jout.up_bytes, jout.down_bytes, jout.time_s,
         jout.n_clipped, jout.noise_std, jout.aborted)
    assert (out.vote_sums is None) == (jout.vote_sums is None)
    if jout.vote_sums is not None:
        _same(out.vote_sums, jout.vote_sums)
    assert (out.secagg is None) == (jout.secagg is None)
    if jout.secagg is not None:
        _same_round(out.secagg, jout.secagg)
        assert out.secagg.dropped == dropped
    assert out.aborted == (len(dropped) == 3)
    if not out.aborted and not out.secagg:
        assert out.n_clipped == 1


def test_private_helpers_match_reference():
    for kw in ({}, {"secagg": "mask"}, {"dp_clip": 0.5},
               {"dp_noise_multiplier": 1.0, "dp_clip": 1.0}):
        assert SA.wants_private(FedConfig(**kw)) == \
            JSA.wants_private(JFedConfig(**kw))
    fc = FedConfig(seed=7, secagg_bits=40, secagg_frac_bits=20,
                   secagg_clip=4.0)
    jfc = JFedConfig(seed=7, secagg_bits=40, secagg_frac_bits=20,
                     secagg_clip=4.0)
    assert dataclasses.asdict(SA.field_spec(fc)) == \
        dataclasses.asdict(JSA.field_spec(jfc))
    assert SA.round_seed(fc, 3) == JSA.round_seed(jfc, 3)
    _same(SA._pad(np.ones(3, np.float32), 5),
          JSA._pad(np.ones(3, np.float32), 5))


# --------------------------------------------------------------------------
# DP
# --------------------------------------------------------------------------

def test_clip_noise_rdp_and_epsilon():
    """The clip and the noise bit for bit; RDP at every order and ε along a
    trajectory to 1e-12 relative."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal(1000).astype(np.float32)
    for clip in (0.0, 0.5, 100.0):
        (a, n), (b, jn) = DP.clip_to_norm(w, clip), JDP.clip_to_norm(w, clip)
        _same(a, b)
        assert n == jn
    for z, c in ((1.1, 0.7), (0.0, 1.0), (1.0, 0.0)):
        _same(DP.gaussian_sum_noise(333, c, z, np.random.default_rng(
            [5, 0xD9, 2])), JDP.gaussian_sum_noise(333, c, z,
                                                   np.random.default_rng(
                                                       [5, 0xD9, 2])))
    for q, sigma in ((0.3, 1.0), (1.0, 1.1), (0.01, 0.6), (0.0, 1.0),
                     (0.3, 0.0)):
        got = DP.rdp_subsampled_gaussian(q, sigma)
        want = JDP.rdp_subsampled_gaussian(q, sigma)
        assert got.shape == want.shape
        fin = np.isfinite(want)
        assert np.array_equal(fin, np.isfinite(got))
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12, atol=0)
    acc, jacc = DP.RDPAccountant(1.1, 0.3), JDP.RDPAccountant(1.1, 0.3)
    assert acc.epsilon() == jacc.epsilon() == 0.0
    for _ in range(5):
        acc.step()
        jacc.step()
        for delta in (1e-5, 1e-3):
            assert acc.epsilon(delta) == pytest.approx(
                jacc.epsilon(delta), rel=1e-12, abs=0)
    assert DP.RDPAccountant(0.0, 0.5).epsilon() == float("inf")


# --------------------------------------------------------------------------
# aggregate-only FedArb
# --------------------------------------------------------------------------

def test_arbitrate_from_votes_equals_reference_and_arbitrate():
    rng = np.random.default_rng(4)
    shapes = {"a": 4, "z": 6}
    local = [{k: rng.random(n) < 0.6 for k, n in shapes.items()}
             for _ in range(5)]
    prev = {k: rng.random(n) < 0.8 for k, n in shapes.items()}
    tree_sums = {k: sum(m[k].astype(np.float32) for m in local)
                 for k in shapes}
    flat = np.concatenate([tree_sums["a"], tree_sums["z"]])
    for threshold in (0.2, 0.4, 0.5, 0.6):
        for sums, p in ((tree_sums, None), (tree_sums, prev), (flat, prev)):
            got = ARB.arbitrate_from_votes(sums, 5, threshold, p)
            want = JARB.arbitrate_from_votes(sums, 5, threshold, p)
            assert sorted(got) == sorted(want)
            for k in got:
                _same(got[k], want[k])
                _same(got[k], ARB.arbitrate(local, threshold, p)[k])
    assert ARB.arbitrate_from_votes(flat, 0, 0.5, prev) is prev
    with pytest.raises(ValueError, match="prev_global"):
        ARB.arbitrate_from_votes(flat, 5, 0.5, None)
    s, js = FedARA(), JFedARA()
    for args in ((flat, 5, prev), (None, 5, prev), (flat, 0, prev)):
        got, want = s.arbitrate_votes(1, *args), js.arbitrate_votes(1, *args)
        for k in want:
            _same(got[k], want[k])


# --------------------------------------------------------------------------
# the privacy configuration
# --------------------------------------------------------------------------

REFUSED = [dict(secagg="mask", codec="int8"), dict(dp_clip=1.0, codec="topk"),
           dict(secagg="mask", codec="powersgd"),
           dict(secagg="mask", runner="async"), dict(dp_noise_multiplier=1.0),
           dict(secagg="bogus"), dict(secagg="mask", secagg_clip=0.5),
           dict(secagg="mask", dp_clip=9.0),
           dict(secagg="mask", secagg_bits=70),
           dict(secagg="mask", secagg_bits=16, clients_per_round=200)]


@pytest.mark.parametrize("kw", REFUSED, ids=[str(k) for k in REFUSED])
def test_privacy_config_refusals_match_the_reference(kw):
    """Each case of ``tests/test_secagg.py::test_privacy_config_validation``
    (and the field's own refusals) raises ``ValueError`` in the reference and
    in the port, through ``validate_config`` as well."""
    with pytest.raises(ValueError):
        jvalidate(JFedConfig(**kw))
    with pytest.raises(ValueError):
        validate_privacy_config(FedConfig(**kw))
    with pytest.raises(ValueError):
        validate_config(FedConfig(**kw))


def test_privacy_configs_the_reference_accepts_run_on_the_seq_server():
    for kw in (dict(secagg="mask", dp_clip=1.0, dp_noise_multiplier=1.0),
               dict(secagg="mask", codec="signsgd", dp_clip=1.0,
                    dp_noise_multiplier=1.0),
               dict(codec="powersgd", powersgd_rank=3), dict(codec="int8"),
               dict(codec="topk")):
        jvalidate(JFedConfig(**kw))
        validate_config(FedConfig(**kw))
    # the cohort runner takes the private branch too (the reference's
    # refusal is async's alone)
    jvalidate(JFedConfig(secagg="mask", runner="cohort"))
    validate_config(FedConfig(secagg="mask", runner="cohort"))
