"""Port parity for the codecs of ``repro/fedsim/transport.py`` and the
delta-coded broadcast of ``repro/fedsim/pipeline.py``: every codec's payload
and byte count bit for bit over ``tests/test_pipeline.py``'s sizes (empty,
one element, tail blocks), ``ErrorFeedback`` over a 5-step stream,
PowerSGD's keyed warm start across a wire-length change, the codec registry,
``make_fc_codec``, ``cast_like`` and ``DeltaChannel`` across a mask change
that forces a resync, on the same numpy inputs made from a seed (CPU)."""

import jax
import numpy as np
import pytest
import torch

from repro.configs.distilbert import MINI as JMINI
from repro.federated.server import FedConfig as JFedConfig
from repro.fedsim import pipeline as JPL
from repro.fedsim import transport as JT
from repro.models import Model as JaxModel
from repro_torch.bridge import bridge_tree
from repro_torch.core import masks as MK
from repro_torch.federated.server import FedConfig
from repro_torch.fedsim import pipeline as PL
from repro_torch.fedsim import transport as T
from repro_torch.pytree import flatten_with_paths

# tests/test_pipeline.py's sizes: empty, one element, block edges and tails
SIZES = [0, 1, 2, 7, 63, 64, 65, 127, 128, 129, 130, 255, 256, 257, 1000,
         2048, 4096]
CODECS = [("identity", {}), ("int8", {}), ("int8", {"block": 128}),
          ("topk", {}), ("topk", {"frac": 0.3}), ("signsgd", {}),
          ("signsgd", {"block": 128}), ("powersgd", {}),
          ("powersgd", {"rank": 1}), ("powersgd", {"rank": 4})]


def _wire(n, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(n) * scale
            ).astype(np.float32)


def _same_payload(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same_payload(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name,kw", CODECS,
                         ids=[f"{n}-{kw}" for n, kw in CODECS])
def test_codec_payload_bytes_and_decode_bit_for_bit(name, kw):
    """For every size: the payload arrays (dtype, shape, bits), the exact
    byte count and the decoded wire equal the reference's."""
    for n in SIZES:
        w = _wire(n, seed=n)
        codec, jcodec = T.make_codec(name, **kw), JT.make_codec(name, **kw)
        payload, nbytes = codec.encode(w, key=3)
        jpayload, jnbytes = jcodec.encode(w, key=3)
        assert nbytes == jnbytes, (name, n)
        _same_payload(payload, jpayload)
        dec = codec.decode(payload, n)
        assert dec.dtype == np.float32 and dec.shape == (n,)
        assert np.array_equal(dec, jcodec.decode(jpayload, n)), (name, n)


def test_byte_formulas_of_the_wire():
    """The formulas the card run predicts bytes with, at a ragged size."""
    n = 1_000_003
    w = _wire(n, seed=1)
    m = int(np.ceil(np.sqrt(n)))
    k = -(-n // m)
    want = {"identity": 4 * n + 4,
            "int8": n + 4 * -(-n // 256) + 4,
            "topk": 8 * round(0.1 * n) + 4,
            "signsgd": -(-n // 8) + 4 * -(-n // 256) + 4,
            "powersgd": 4 * 2 * (m + k) + 4}
    for name, nbytes in want.items():
        assert T.make_codec(name).encode(w, key=0)[1] == nbytes, name


@pytest.mark.parametrize("name", ["int8", "topk", "signsgd", "powersgd"])
def test_error_feedback_five_step_stream(name):
    """``ErrorFeedback.roundtrip`` over 5 steps of a stream, two endpoints
    and one length change: decoded wires, bytes and residuals equal."""
    ef, jef = T.ErrorFeedback(T.make_codec(name)), \
        JT.ErrorFeedback(JT.make_codec(name))
    rng = np.random.default_rng(11)
    for step, (key, n) in enumerate([("a", 700), ("b", 700), ("a", 700),
                                     ("a", 300), ("b", 700)]):
        w = rng.standard_normal(n).astype(np.float32) * (0.8 ** step)
        dec, nbytes = ef.roundtrip(key, w)
        jdec, jnbytes = jef.roundtrip(key, w)
        assert nbytes == jnbytes and np.array_equal(dec, jdec), step
    assert sorted(ef._resid) == sorted(jef._resid) == ["a", "b"]
    for key in ef._resid:
        assert np.array_equal(ef._resid[key], jef._resid[key]), key


def test_powersgd_keyed_warm_start_across_a_length_change():
    """Warm factors per endpoint key, reset when the wire length changes:
    every payload and every stored Q equals the reference's."""
    p, jp = T.PowerSGD(rank=2), JT.PowerSGD(rank=2)
    for key, n, seed in [(1, 200, 5), (2, 200, 6), (1, 200, 7), (1, 64, 8),
                         (1, 64, 9), (2, 200, 10)]:
        w = _wire(n, seed=seed)
        payload, nbytes = p.encode(w, key=key)
        jpayload, jnbytes = jp.encode(w, key=key)
        assert nbytes == jnbytes
        _same_payload(payload, jpayload)
    assert set(p._q) == set(jp._q) == {1, 2}
    assert p._q[1].shape[0] == 8                 # k for n=64
    for key in p._q:
        assert np.array_equal(p._q[key], jp._q[key])
    q = np.random.default_rng(0).standard_normal((40, 3))
    assert np.array_equal(T._orthonormalize(q.astype(np.float32)),
                          JT._orthonormalize(q.astype(np.float32)))


def test_codec_registry_field_exact_and_fc_codec():
    assert set(T._CODECS) == set(JT._CODECS)
    assert T.FIELD_EXACT == JT.FIELD_EXACT == ("identity", "signsgd")
    for name in T._CODECS:
        assert T.make_codec(name).field_exact == \
            JT.make_codec(name).field_exact
    with pytest.raises(ValueError, match="unknown codec"):
        T.make_codec("bogus")
    for codec in ["identity", "int8", "topk", "signsgd", "powersgd"]:
        got = PL.make_fc_codec(FedConfig(codec=codec, powersgd_rank=3))
        want = JPL.make_fc_codec(JFedConfig(codec=codec, powersgd_rank=3))
        assert (got is None) == (want is None)
        if want is not None:
            assert type(got).__name__ == type(want).__name__
            assert getattr(got, "rank", None) == getattr(want, "rank", None)


def test_cast_like_keeps_the_dtypes_and_devices_of_like():
    like = {"a": torch.zeros(3, dtype=torch.bfloat16),
            "b": {"c": torch.zeros(2, 2)}}
    dec = {"a": np.float32([1.5, 2.25, -3.0]),
           "b": {"c": np.arange(4, dtype=np.float32).reshape(2, 2)}}
    out = T.cast_like(dec, like)
    assert out["a"].dtype == torch.bfloat16
    assert out["a"].tolist() == [1.5, 2.25, -3.0]
    assert out["b"]["c"].dtype == torch.float32
    assert np.array_equal(out["b"]["c"].numpy(), dec["b"]["c"])


# --------------------------------------------------------------------------
# the delta-coded broadcast channel
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trees():
    """MINI's (2 layers) trainable tree and rank masks in both packages, and
    three targets the server would broadcast in turn (numpy, seed 0)."""
    jm = JaxModel(JMINI.with_(n_layers=2, layer_pattern=("attn",) * 2),
                  unroll=True)
    _, jtr = jm.init(jax.random.key(0))
    jmasks = jax.tree.map(np.asarray, jm.init_masks())
    rng = np.random.default_rng(0)
    targets = [jax.tree.map(lambda x: (np.asarray(x) + 0.01 * i * rng.normal(
        size=x.shape)).astype(np.float32), jtr) for i in range(3)]
    pruned = jax.tree.map(lambda m: m.copy(), jmasks)
    pruned["dec"]["tail"]["t1"]["attn"]["wq"][3:] = False
    pruned["dec"]["tail"]["t0"]["mlp"]["w2"][:5] = False
    return dict(targets=targets, port=[bridge_tree(t) for t in targets],
                jmasks=jmasks, pruned=pruned,
                masks=MK.to_np(bridge_tree(jmasks)),
                pmasks=MK.to_np(bridge_tree(pruned)))


@pytest.mark.parametrize("codec", ["signsgd", "int8", "powersgd"])
def test_delta_channel_resyncs_on_a_mask_change(trees, codec):
    """Three sends: two under the full masks, the third under pruned masks
    (a shorter wire, so the channel resyncs).  Every reconstruction equals
    the reference's bit for bit and every byte count too; the port's comes
    back as tensors of the target's dtypes."""
    ch = PL.DeltaChannel(T.make_codec(codec), T.flatten_update,
                         T.unflatten_update, ("down", "down"))
    jch = JPL.DeltaChannel(JT.make_codec(codec), JT.flatten_update,
                           JT.unflatten_update, ("down", "down"))
    sends = [(0, "masks", "jmasks"), (1, "masks", "jmasks"),
             (2, "pmasks", "pruned")]
    lengths = []
    for i, m, jm in sends:
        masks_np, jmasks_np = trees[m], trees[jm]
        bc, nbytes = ch.send(trees["port"][i], masks_np)
        jbc, jnbytes = jch.send(trees["targets"][i], jmasks_np)
        assert nbytes == jnbytes, i
        lengths.append(T.flatten_update(bc, masks_np).size)
        want = bridge_tree(jax.tree.map(np.asarray, jbc))
        got, exp = flatten_with_paths(bc), flatten_with_paths(want)
        assert [p for p, _ in got] == [p for p, _ in exp]
        for (path, a), (_, b) in zip(got, exp):
            assert isinstance(a, torch.Tensor) and a.dtype == b.dtype
            assert torch.equal(a, b), (i, path)
    assert lengths[2] < lengths[0]          # the pruned wire resynced
    # with no codec the channel passes the target through unpriced
    plain = PL.DeltaChannel(None, T.flatten_update, T.unflatten_update, "d")
    assert plain.send(trees["port"][0], None) == (trees["port"][0], 0)


# --------------------------------------------------------------------------
# the upload stages: EF residual, DP clip, codec, field snap
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(codec="signsgd", secagg="mask", dp_clip=1.0),
    dict(codec="signsgd"), dict(codec="int8"),
    dict(codec="topk"), dict(codec="powersgd", powersgd_rank=2),
    dict(dp_clip=1.0), dict(secagg="mask")],
    ids=["signsgd-secagg-clip", "signsgd", "int8", "topk", "powersgd",
         "clip", "secagg"])
def test_upload_stages_over_a_stream_match_reference(kw):
    """``UploadPipeline.encode`` over 5 uploads of two clients (one changes
    its wire length): the decoded wire, bytes, clip flag, norm, decoded
    tree and the EF residual after every step equal the reference's."""
    fc, jfc = FedConfig(**kw), JFedConfig(**kw)
    pipe, jpipe = PL.UploadPipeline(fc), JPL.UploadPipeline(jfc)
    rng = np.random.default_rng(2)
    for step, (cid, n) in enumerate([(0, 900), (1, 900), (0, 900),
                                     (1, 500), (0, 900)]):
        delta = {"adapters": {}, "head": {
            "b": (rng.standard_normal(20) * 0.2).astype(np.float32),
            "w": (rng.standard_normal(n) * 0.1 * (1 + step)).astype(
                np.float32)}}
        e = pipe.encode(PL.ClientUpdate(cid, delta, 3.0), None)
        je = jpipe.encode(JPL.ClientUpdate(cid, delta, 3.0), None)
        assert (e.nbytes, e.clipped, e.norm) == (je.nbytes, je.clipped,
                                                 je.norm), step
        assert np.array_equal(e.wire, je.wire), step
        for k in ("b", "w"):
            assert np.array_equal(e.delta["head"][k],
                                  np.asarray(je.delta["head"][k])), step
        assert sorted(pipe._resid) == sorted(jpipe._resid)
        for c in pipe._resid:
            assert np.array_equal(pipe._resid[c], jpipe._resid[c]), step
    if kw.get("codec") not in (None, "identity"):
        assert pipe._resid               # error feedback engaged
