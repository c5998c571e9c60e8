"""Port parity for the encoder-decoder (BART SMOKE, f32): the configs, the
bridge of the JAX package's scanned encoder and decoder stacks, LM logits,
``lm_loss`` and every adapter gradient (the encoder's, the decoder's
self-attention, cross-attention and MLP adapters) against
``Model.lm_loss`` under ``jax.value_and_grad``, with encoder inputs longer
than the decoder's so that cross-attention runs with Sq ≠ Sk; and the
serving entry points refusing an encoder-decoder config."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bart as JB
from repro.models import Model as JaxModel
from repro.models import attention as JATT
from repro_torch.bridge import from_jax
from repro_torch.configs import bart as TB
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import attention as TATT
from repro_torch.pytree import flatten_with_paths, tree_map

TOL = 1e-5          # rtol = atol, tests/test_torch_model.py:137
B, SE, SD = 2, 24, 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=TOL,
                               atol=TOL, err_msg=what)


@pytest.mark.parametrize("name", ["CONFIG", "MINI", "SMOKE"])
def test_bart_configs_match_reference(name):
    want, got = getattr(JB, name), getattr(TB, name)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.pdtype == got.cdtype == torch.float32
    assert get_config("bart") == TB.CONFIG
    assert get_config("bart", smoke=True) == TB.SMOKE


@pytest.fixture(scope="module")
def encdec_case():
    cfg_j = JB.SMOKE
    jm = JaxModel(cfg_j, peft="bea")
    base, tr = jm.init(jax.random.key(5))
    rng = np.random.default_rng(5)
    tr = jax.tree_util.tree_map_with_path(
        lambda p, v: v + jnp.asarray(rng.normal(size=v.shape) * 0.3, v.dtype)
        if str(p[-1].key) == "E" else v, tr)
    masks = jax.tree.map(lambda m: m.at[..., 2].set(False), jm.init_masks())
    enc = rng.integers(0, cfg_j.vocab_size, (B, SE)).astype(np.int32)
    toks = rng.integers(0, cfg_j.vocab_size, (B, SD)).astype(np.int32)
    targets = rng.integers(0, cfg_j.vocab_size, (B, SD)).astype(np.int32)
    targets[1, :4] = -1
    jb = {"tokens": jnp.asarray(toks), "enc_tokens": jnp.asarray(enc),
          "targets": jnp.asarray(targets)}
    logits = jm.forward(base, tr, masks, jb, remat=False)[0]
    (total, (loss, aux)), grads = jax.value_and_grad(
        lambda t: jm.lm_loss(base, t, masks, jb, remat=False),
        has_aux=True)(tr)
    tb = {k: torch.from_numpy(np.array(v)).long() for k, v in jb.items()}
    return dict(cfg=TB.SMOKE, jm=jm, jax_trees=(base, tr, masks),
                trees=from_jax(_np(base), _np(tr), _np(masks)),
                grads=from_jax(_np(grads), None, None)[0], batch=tb,
                logits=np.asarray(logits), total=float(total),
                loss=float(loss))


def test_bridge_carries_the_stacked_encoder(encdec_case):
    """The scanned ``enc``/``dec`` plans (``body.p0`` with a leading layer
    axis) become per-layer lists; encoder norms, cross-attention weights
    and the ``xattn`` adapters and masks cross exactly."""
    cfg = encdec_case["cfg"]
    jbase, jtr, jmasks = encdec_case["jax_trees"]
    base, tr, masks = encdec_case["trees"]
    assert "body" in jbase["enc"] and "body" in jbase["dec"]
    assert len(base["enc"]["layers"]) == cfg.n_encoder_layers
    assert len(base["dec"]["layers"]) == cfg.n_layers
    model = Model(cfg, peft="bea")
    for got, meta in ((base, model.base_meta()),
                      (tr, model.trainable_meta()),
                      (masks, model.mask_meta())):
        gp = flatten_with_paths(got)
        mp = flatten_with_paths(meta, is_leaf=lambda x: hasattr(x, "init"))
        assert [p for p, _ in gp] == [p for p, _ in mp]
        assert all(tuple(t.shape) == m.shape and t.dtype == m.dtype
                   for (_, t), (_, m) in zip(gp, mp))
    for i in range(cfg.n_encoder_layers):
        np.testing.assert_array_equal(
            base["enc"]["layers"][i]["attn"]["wq"]["w"].numpy(),
            np.asarray(jbase["enc"]["body"]["p0"]["attn"]["wq"]["w"][i]))
        np.testing.assert_array_equal(
            tr["adapters"]["dec"]["layers"][i]["xattn"]["wv"]["A"].numpy(),
            np.asarray(jtr["adapters"]["dec"]["body"]["p0"]["xattn"]["wv"]
                       ["A"][i]))
        np.testing.assert_array_equal(
            masks["enc"]["layers"][i]["mlp"]["w1"].numpy(),
            np.asarray(jmasks["enc"]["body"]["p0"]["mlp"]["w1"][i]))
    np.testing.assert_array_equal(base["enc_norm"]["scale"].numpy(),
                                  np.asarray(jbase["enc_norm"]["scale"]))
    assert "b" not in base["dec"]["layers"][0]["xattn"]["wq"]


@pytest.mark.parametrize("use_kernels", [False, True])
def test_encdec_logits_match_jax(encdec_case, use_kernels):
    base, tr, masks = encdec_case["trees"]
    model = Model(encdec_case["cfg"], peft="bea", use_kernels=use_kernels)
    with torch.no_grad():
        logits = model.forward(base, tr, masks, encdec_case["batch"])
    assert logits.shape == (B, SD, encdec_case["cfg"].vocab_size)
    _close(logits.numpy(), encdec_case["logits"], "logits")


@pytest.mark.parametrize("use_kernels", [False, True])
def test_encdec_lm_loss_and_adapter_grads_match_jax(encdec_case,
                                                    use_kernels):
    base, tr, masks = encdec_case["trees"]
    cfg = encdec_case["cfg"]
    model = Model(cfg, peft="bea", use_kernels=use_kernels)
    flat = []

    def leaf(t):
        flat.append(t.clone().requires_grad_(True))
        return flat[-1]

    req = tree_map(leaf, tr)
    total, (loss, aux) = model.lm_loss(base, req, masks, encdec_case["batch"])
    _close(total.item(), encdec_case["total"], "total")
    _close(loss.item(), encdec_case["loss"], "loss")
    got = torch.autograd.grad(total, flat)
    it = iter(got)
    got = tree_map(lambda _: next(it), req)
    want = dict(flatten_with_paths(encdec_case["grads"]))
    paths = flatten_with_paths(got)
    assert [p for p, _ in paths] == sorted(want)
    # 6 linears an encoder layer, 10 a decoder layer, A, B and E each
    assert len(paths) == 3 * (6 * cfg.n_encoder_layers + 10 * cfg.n_layers)
    for path, g in paths:
        _close(g.numpy(), want[path].numpy(), path)
    assert got["adapters"]["enc"]["layers"][0]["attn"]["wq"]["E"].abs().sum()
    assert got["adapters"]["dec"]["layers"][1]["xattn"]["wk"]["A"].abs().sum()


@pytest.mark.parametrize("use_kernel", [False, True])
def test_cross_attention_sq_ne_sk_matches_jax(encdec_case, use_kernel):
    """One decoder layer's cross-attention: queries (B, 16) over encoder
    keys (B, 24), no mask and no RoPE, with its adapters."""
    cfg = encdec_case["cfg"]
    jbase, jtr, jmasks = encdec_case["jax_trees"]
    base, tr, masks = encdec_case["trees"]
    rng = np.random.default_rng(11)
    x = rng.normal(size=(B, SD, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(B, SE, cfg.d_model)).astype(np.float32)
    pick = lambda t: jax.tree.map(lambda a: a[1], t)   # noqa: E731
    want, _ = JATT.attention(
        pick(jbase["dec"]["body"]["p0"]["xattn"]), jnp.asarray(x), JB.SMOKE,
        mode="train", ad=pick(jtr["adapters"]["dec"]["body"]["p0"]["xattn"]),
        masks=pick(jmasks["dec"]["body"]["p0"]["xattn"]),
        kv_x=jnp.asarray(enc), cross=True)
    got, cache = TATT.attention(
        base["dec"]["layers"][1]["xattn"], torch.from_numpy(x), cfg,
        mode="train", ad=tr["adapters"]["dec"]["layers"][1]["xattn"],
        masks=masks["dec"]["layers"][1]["xattn"], kv_x=torch.from_numpy(enc),
        use_kernel=use_kernel, causal=False)
    assert cache is None and got.shape == (B, SD, cfg.d_model)
    _close(got.numpy(), np.asarray(want), "cross-attention")


def test_serving_refuses_an_encoder_decoder():
    """The multi-tenant engine serves decoder-only text, as the reference's
    engine v1 does: an encoder-decoder is pointed at the static-batch loop
    (``launch/serve.py:legacy_static_batch``, which serves it through the
    cross-attention cache; ``tests/test_torch_legacy_serve.py``), and an
    encoder's bidirectional self-attention has no decode."""
    from repro_torch.launch import serve
    cfg = TB.SMOKE
    with pytest.raises(NotImplementedError, match="legacy_static_batch"):
        serve.build_engine(cfg, n_slots=1, max_seq=8, device="cpu")
    model = Model(cfg, peft="bea", use_kernels=False)
    base, _ = model.init(0, "cpu")
    cache = model.init_cache(1, 8, "cpu", src_len=3)
    with pytest.raises(NotImplementedError, match="encoder"):
        TATT.attention(base["enc"]["layers"][0]["attn"],
                       torch.zeros(1, 1, cfg.d_model), cfg, mode="decode",
                       cache=cache["dec"]["layers"][0]["attn_cache"],
                       rows=torch.zeros(1, dtype=torch.long),
                       pos=torch.zeros(1, dtype=torch.long), causal=False)
