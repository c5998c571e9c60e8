"""Port parity for the static-batch serving loop (``launch/serve.py``'s
``legacy_static_batch``, reference ``repro/launch/serve.py:83``) and the
cross-attention cache (CPU, float32, SMOKE widths): BART's cache metas,
prefill logits, self and cross k/v caches and decode steps against the
reference's ``Model.prefill`` / ``decode_step``; the loop itself for BART
and InternVL2 against a reference loop on the same requests (the
reference's own draws) and bridged weights; the teacher-forced replay the
card's check uses; the two reference quirks the loop meets (ROADMAP.md
queue 4 quirks 12 and 13); the engine's refusal and the CLI."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import serve as JSV
from repro.models import Model as JaxModel
from repro.pytree import materialize as jax_materialize
from repro_torch.bridge import from_jax
from repro_torch.configs import get_config
from repro_torch.launch import serve as TSV
from repro_torch.models import Model
from repro_torch.models import attention as TATT

TOL = 1e-5              # caches (rtol = atol), tests/test_torch_encdec.py
LOGIT_SHARE_TOL = 2e-6  # logits: atol as a share of max|logit|, as Gemma's
B, PROMPT, GEN = 2, 8, 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, what="", tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=what)


def _close_logits(got, want, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=TOL,
                               atol=LOGIT_SHARE_TOL * np.abs(want).max(),
                               err_msg=what)


def _args(**kw):
    return argparse.Namespace(**{"batch": B, "prompt_len": PROMPT,
                                 "gen": GEN, "device": "cpu", **kw})


def _perturbed(jm, seed):
    base, tr = jm.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    tr = jax.tree_util.tree_map_with_path(
        lambda p, v: v + jnp.asarray(rng.normal(size=v.shape) * 0.3, v.dtype)
        if str(p[-1].key) == "E" else v, tr)
    masks = jax.tree.map(lambda m: m.at[..., 2].set(False), jm.init_masks())
    return base, tr, masks


def _reference_requests(cfg_j):
    """The reference loop's draws (``repro/launch/serve.py:93-107``), in
    its order, from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg_j.vocab_size, (B, PROMPT))}
    if cfg_j.is_encoder_decoder:
        out["enc_tokens"] = rng.integers(0, cfg_j.vocab_size, (B, 2 * PROMPT))
    if cfg_j.modality == "vision":
        out["prefix_embeds"] = (rng.normal(size=(
            B, cfg_j.n_prefix_embeds, cfg_j.d_model)) * 0.1).astype(
            np.float32)
    return out


def _reference_loop(jm, trees, requests, total, src_len):
    """The reference's prefill and greedy decode steps at a cache of
    ``total`` positions (its own loop sizes it prompt + gen) → (tokens
    (B, GEN), logits per step, the cache after prefill)."""
    base, tr, masks = trees
    cache = jax_materialize(jm.cache_meta(B, total, src_len=src_len),
                            jax.random.key(1))
    batch = {k: jnp.asarray(v) for k, v in requests.items()}
    logits, cache = jm.prefill(base, tr, masks, batch, cache)
    after_prefill = cache
    steps, toks = [np.asarray(logits)], []
    for i in range(GEN):
        tok = np.array(jnp.argmax(logits, -1))
        toks.append(tok)
        if i == GEN - 1:
            break
        logits, cache = jm.decode_step(base, tr, masks,
                                       jnp.asarray(tok[:, None], jnp.int32),
                                       cache)
        steps.append(np.asarray(logits))
    return np.stack(toks, 1), steps, after_prefill


@pytest.fixture(scope="module", params=["bart", "internvl2_1b"])
def loop_case(request):
    arch = request.param
    cfg_j = jax_get_config(arch, smoke=True)
    jm = JaxModel(cfg_j, peft="bea")
    trees = _perturbed(jm, 5)
    requests = _reference_requests(cfg_j)
    n_prefix = cfg_j.n_prefix_embeds if cfg_j.modality == "vision" else 0
    src_len = 2 * PROMPT if cfg_j.is_encoder_decoder else 0
    toks, steps, cache = _reference_loop(jm, trees, requests,
                                         n_prefix + PROMPT + GEN, src_len)
    return dict(arch=arch, cfg=get_config(arch, smoke=True), cfg_j=cfg_j,
                jm=jm, jax_trees=trees, trees=from_jax(*map(_np, trees)),
                requests=requests, tokens=toks, logits=steps, cache=cache,
                n_prefix=n_prefix, src_len=src_len)


# --------------------------------------------------------------------------
# the cross-attention cache
# --------------------------------------------------------------------------

def test_bart_cache_metas_match_reference():
    """Each ``dec`` block: a self-attention cache over the decoder's
    positions and a cross-attention cache over the encoder's (reference
    ``blocks.py:75-86``, one layer of its stacked body)."""
    cfg_j = jax_get_config("bart", smoke=True)
    ref = JaxModel(cfg_j, peft="bea").cache_meta(3, 10, src_len=6)
    ref = ref["dec"]["body"]["p0"]
    got = Model(get_config("bart", smoke=True)).cache_meta(3, 10, src_len=6)
    assert len(got["dec"]["layers"]) == cfg_j.n_layers
    assert tuple(got["pos"].shape) == (3,)
    for layer in got["dec"]["layers"]:
        assert set(layer) == {"attn_cache", "xattn_cache"}
        for c in ("attn_cache", "xattn_cache"):
            for kv in ("k", "v"):
                assert tuple(layer[c][kv].shape) == ref[c][kv].shape[1:]
                assert layer[c][kv].dtype == torch.float32
    assert TATT.cross_cache_meta(get_config("bart", smoke=True), 3, 6)[
        "k"].shape == (3, 6, 4, 32)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_logits_and_caches_match_reference(loop_case, use_kernels):
    """Prefill of the loop's requests: the last position's logits, every
    layer's self-attention k/v (BART's in ``attn_cache``, P + S rows for
    InternVL2), BART's cross-attention k/v (the encoder run once) and the
    position decode goes on from."""
    c = loop_case
    model = Model(c["cfg"], use_kernels=use_kernels)
    base, tr, masks = c["trees"]
    total = c["n_prefix"] + PROMPT + GEN
    cache = model.init_cache(B, total, "cpu", src_len=c["src_len"])
    batch = TSV.static_batch_inputs(c["cfg"], B, PROMPT, "cpu")
    for k, v in c["requests"].items():          # the reference's draws
        assert np.array_equal(batch[k].numpy(), v), k
    with torch.no_grad():
        logits, cache = model.prefill(base, tr, masks, batch, cache)
    _close_logits(logits.numpy(), c["logits"][0], "prefill")
    n = c["n_prefix"] + PROMPT
    assert cache["pos"].tolist() == [n] * B
    ref = c["cache"]["dec"]["body"]["p0"]
    for i, layer in enumerate(cache["dec"]["layers"]):
        selfc = layer["attn_cache"] if c["src_len"] else layer
        want = ref["attn_cache"]
        for kv in ("k", "v"):
            _close(selfc[kv].numpy(), np.asarray(want[kv][i]),
                   f"layer {i} self {kv}")
            assert not selfc[kv][:, n:].any()
            if c["src_len"]:
                got_x = layer["xattn_cache"][kv]
                assert got_x.shape[1] == c["src_len"]
                _close(got_x.numpy(), np.asarray(ref["xattn_cache"][kv][i]),
                       f"layer {i} cross {kv}")


@pytest.mark.parametrize("use_kernels", [False, True])
def test_static_batch_loop_matches_reference(loop_case, use_kernels, capsys):
    """``legacy_static_batch`` on bridged weights: the greedy tokens and
    every step's logits equal the reference's prefill / decode loop on the
    same requests (BART's decode through the cross-attention cache)."""
    c = loop_case
    out = TSV.legacy_static_batch(c["cfg"], _args(), params=c["trees"],
                                  use_kernels=use_kernels)
    assert out["tokens"].shape == (B, GEN)
    assert out["tokens"].numpy().tolist() == c["tokens"].tolist()
    assert len(out["logits"]) == GEN
    for i, (got, want) in enumerate(zip(out["logits"], c["logits"])):
        _close_logits(got.numpy(), want, f"step {i}")
    assert "[legacy static batch]" in capsys.readouterr().out


def test_forced_replay_gives_the_same_logits(loop_case):
    """The teacher-forced replay (``force``) the card's check runs plain
    against the kernel run: fed the first run's tokens, it gives the same
    logits at every step."""
    c = loop_case
    first = TSV.legacy_static_batch(c["cfg"], _args(), params=c["trees"])
    again = TSV.legacy_static_batch(c["cfg"], _args(), params=c["trees"],
                                    use_kernels=False, force=first["tokens"])
    assert torch.equal(again["tokens"], first["tokens"])
    for a, b in zip(first["logits"], again["logits"]):
        _close_logits(b.numpy(), a.numpy())


def test_bart_decode_reads_the_cross_cache():
    """Cross-attention in decode projects q and o only: the keys and
    values come from the cache, so clearing the cache changes the output,
    and ``kv_x`` is not needed."""
    cfg = get_config("bart", smoke=True)
    model = Model(cfg, use_kernels=False)
    base, _ = model.init(0, "cpu")
    p = base["dec"]["layers"][0]["xattn"]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 1, cfg.d_model, generator=gen)
    cache = {"k": torch.randn(2, 5, 4, 32, generator=gen),
             "v": torch.randn(2, 5, 4, 32, generator=gen)}
    rows = torch.arange(2)
    got, kept = TATT.attention(p, x, cfg, mode="decode", cache=cache,
                               rows=rows, cross=True, causal=False)
    assert kept is cache and got.shape == (2, 1, cfg.d_model)
    zero = {k: torch.zeros_like(v) for k, v in cache.items()}
    other, _ = TATT.attention(p, x, cfg, mode="decode", cache=zero,
                              rows=rows, cross=True, causal=False)
    assert (got - other).abs().max().item() > 1e-4
    with pytest.raises(NotImplementedError, match="encoder"):
        TATT.attention(base["dec"]["layers"][0]["attn"], x, cfg,
                       mode="decode", cache=cache, rows=rows,
                       pos=torch.zeros(2, dtype=torch.long), causal=False)


# --------------------------------------------------------------------------
# the reference's quirks on this loop (ROADMAP.md queue 4)
# --------------------------------------------------------------------------

def test_quirk12_reference_cli_crashes_on_a_vision_model():
    """The reference's loop sizes the cache prompt + gen with no room for
    the patch rows its prefill writes, so its CLI raises at
    internvl2-smoke; its own ``Model.prefill`` / ``decode_step`` with a
    cache of P + S + gen rows work, the first decode step equal to a full
    forward at that position (the port's loop sizes the cache so)."""
    with pytest.raises(ValueError, match="Incompatible shapes"):
        JSV.main(["--arch", "internvl2_1b", "--smoke", "--batch", "2",
                  "--prompt-len", "8", "--gen", "4"])
    cfg_j = jax_get_config("internvl2_1b", smoke=True)
    jm = JaxModel(cfg_j, peft="bea")
    trees = _perturbed(jm, 3)
    req = _reference_requests(cfg_j)
    toks, steps, _ = _reference_loop(
        jm, trees, req, cfg_j.n_prefix_embeds + PROMPT + GEN, 0)
    full = {"tokens": jnp.asarray(np.concatenate([req["tokens"],
                                                  toks[:, :1]], 1)),
            "prefix_embeds": jnp.asarray(req["prefix_embeds"])}
    fwd = jm.forward(*trees, full, remat=False)[0][:, -1]
    _close_logits(steps[1], fwd, "decode step 1 vs forward")


def _bart_decode_vs_forward(jm, trees, req):
    """The reference's first decode step and its full forward over
    prompt + that token, at the new token's position."""
    toks, steps, _ = _reference_loop(jm, trees, req, PROMPT + GEN,
                                     2 * PROMPT)
    full = {"tokens": jnp.asarray(np.concatenate([req["tokens"],
                                                  toks[:, :1]], 1)),
            "enc_tokens": jnp.asarray(req["enc_tokens"])}
    fwd = np.asarray(jm.forward(*trees, full, remat=False)[0][:, -1])
    return steps[1], fwd, toks


def test_quirk13_reference_decode_embeds_at_position_zero():
    """The reference's decode embeds each new token with no position
    offset: at BART (learned positions) its first decode step differs from
    a full forward at that position, by the position table alone (zeroed,
    the two agree); the port's loop reproduces the reference's decode,
    not its forward."""
    cfg_j = jax_get_config("bart", smoke=True)
    jm = JaxModel(cfg_j, peft="bea")
    trees = _perturbed(jm, 0)
    req = _reference_requests(cfg_j)
    dec, fwd, toks = _bart_decode_vs_forward(jm, trees, req)
    gap = np.abs(dec - fwd).max()
    assert gap > 100 * LOGIT_SHARE_TOL * np.abs(fwd).max(), gap
    base0 = dict(trees[0])
    base0["embed"] = {**base0["embed"],
                      "pos": jnp.zeros_like(base0["embed"]["pos"])}
    dec0, fwd0, _ = _bart_decode_vs_forward(jm, (base0,) + trees[1:], req)
    _close_logits(dec0, fwd0, "zeroed position table")
    out = TSV.legacy_static_batch(get_config("bart", smoke=True), _args(),
                                  params=from_jax(*map(_np, trees)),
                                  force=torch.from_numpy(toks))
    _close_logits(out["logits"][1].numpy(), dec, "the port's decode")


# --------------------------------------------------------------------------
# the entry points
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["bart", "internvl2_1b"])
def test_engine_refuses_with_a_pointer_to_the_loop(arch):
    """The engine serves decoder-only text (the reference's engine v1):
    encoder-decoder and vision models are pointed at the static-batch
    loop."""
    cfg = get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match="legacy_static_batch"):
        TSV.build_engine(cfg, n_slots=1, max_seq=8, device="cpu")


def test_bart_serve_cli_runs_on_cpu(capsys):
    TSV.main(["--arch", "bart", "--smoke", "--device", "cpu", "--batch", "3",
              "--prompt-len", "6", "--gen", "3"])
    out = capsys.readouterr().out
    assert "[legacy static batch] device=cpu" in out and "src=12" in out
    toks = eval(out.strip().splitlines()[-1].split(":", 1)[1])
    assert len(toks) == 3


def test_the_loop_refuses_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the loop runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSV.legacy_static_batch(get_config("bart", smoke=True),
                                _args(device=None))
