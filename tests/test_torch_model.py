"""Port parity for the model slice: configs, parameter trees, the weight
bridge, layer primitives, and Qwen2 SMOKE prefill/decode logits against the
JAX package on the same weights (CPU, float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import layers as JL
from repro.pytree import tree_bytes as jax_tree_bytes
from repro_torch.bridge import bridge_tree, from_jax, to_tensor
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import layers as TL
from repro_torch.pytree import (ParamMeta, flatten_with_paths, materialize,
                                tree_bytes, tree_map)

TOL = 2e-4          # tests/test_flash_kernel.py:64, the model-level tier


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("smoke,arch,alias", [
    pytest.param(False, "qwen2_0p5b", "qwen2-0.5b", id="False"),
    pytest.param(True, "qwen2_0p5b", "qwen2-0.5b", id="True"),
    *(pytest.param(smoke, arch, alias, id=f"{arch}-{smoke}")
      for arch, alias in (("gemma2_2b", "gemma2-2b"), ("gemma3_1b", "gemma3-1b"),
                          ("granite_moe_1b_a400m", "granite-moe-1b-a400m"),
                          ("kimi_k2_1t_a32b", "kimi-k2-1t-a32b"))
      for smoke in (False, True))])
def test_config_matches_reference(smoke, arch, alias):
    ref = jax_get_config(arch, smoke=smoke)
    got = get_config(arch, smoke=smoke)
    for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab_size", "qkv_bias", "rope_theta",
              "act", "glu", "tie_embeddings", "layer_pattern",
              "adapter_targets", "adapter_rank", "adapter_alpha",
              "param_dtype", "compute_dtype", "sliding_window",
              "attn_softcap", "final_softcap", "rms_offset",
              "post_block_norm", "embed_scale", "source", "family",
              "n_experts", "top_k", "capacity_factor", "router_aux_coef"):
        assert getattr(got, f) == getattr(ref, f), f
    assert got.pdtype == (torch.float32 if smoke else torch.bfloat16)
    assert got.cdtype == got.pdtype
    assert get_config(alias, smoke=smoke) == got


def test_unported_arch_raises_with_roadmap_pointer():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("seamless_m4t_large_v2")


# --------------------------------------------------------------------------
# parameter trees and the bridge
# --------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_meta_tree_bytes_match_reference(smoke):
    """Same parameters, same dtypes: byte totals of base and adapters agree
    with the JAX metas (no allocation — the full config stays abstract)."""
    jm = JaxModel(jax_get_config("qwen2_0p5b", smoke=smoke), peft="bea")
    tm = Model(get_config("qwen2_0p5b", smoke=smoke), peft="bea")
    assert tree_bytes(tm.base_meta()) == jax_tree_bytes(jm.base_meta())
    assert tree_bytes(tm.trainable_meta()) == \
        jax_tree_bytes(jm.trainable_meta())


def test_model_init_follows_its_metas():
    tm = Model(get_config("qwen2_0p5b", smoke=True))
    base, tr = tm.init(0, "cpu")
    masks, cache = tm.init_masks("cpu"), tm.init_cache(3, 10, "cpu")
    for tree, meta in ((base, tm.base_meta()), (tr, tm.trainable_meta()),
                       (masks, tm.mask_meta()), (cache, tm.cache_meta(3, 10))):
        got = flatten_with_paths(tree)
        want = flatten_with_paths(meta, is_leaf=lambda m: isinstance(
            m, ParamMeta))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, t), (_, m) in zip(got, want):
            assert tuple(t.shape) == m.shape and t.dtype == m.dtype, path
    assert len(base["dec"]["layers"]) == 2
    assert base["dec"]["layers"][0]["attn"]["wq"]["w"].shape == (128, 4, 32)
    assert bool(masks["dec"]["layers"][1]["mlp"]["w2"].all())


def test_materialize_init_kinds_and_scales():
    meta = {"n": ParamMeta((256, 512), init="normal", scale=2.0),
            "f": ParamMeta((64, 32), init="normal", fan_in=16),
            "s": ParamMeta((200, 300), init="scaled_normal", scale=0.25),
            "u": ParamMeta((100, 100), init="uniform", scale=0.5),
            "z": ParamMeta((3,), init="zeros"),
            "o": ParamMeta((3,), torch.bfloat16, init="ones")}
    t = materialize(meta, 0, "cpu")
    assert abs(t["n"].std().item() - 2.0 / np.sqrt(256)) < 0.01
    assert abs(t["f"].std().item() - 1.0 / 4.0) < 0.02
    assert abs(t["s"].std().item() - 0.25) < 0.01
    assert t["u"].abs().max().item() <= 0.5 and t["u"].std().item() > 0.2
    assert torch.equal(t["z"], torch.zeros(3))
    assert t["o"].dtype == torch.bfloat16 and bool((t["o"] == 1).all())
    again = materialize(meta, 0, "cpu")
    assert torch.equal(t["n"], again["n"])              # seeded per path
    assert not torch.equal(t["n"], materialize(meta, 1, "cpu")["n"])


def test_flatten_with_paths_sorted_and_indexed():
    tree = {"b": [torch.zeros(1), torch.ones(1)], "a": {"y": 1, "x": 2}}
    assert [p for p, _ in flatten_with_paths(tree)] == \
        ["a.x", "a.y", "b.0", "b.1"]


def test_bridge_bf16_and_layer_unstacking_exact():
    rng = np.random.default_rng(0)
    arr = jnp.asarray(rng.normal(size=(3, 4, 5)), jnp.bfloat16)
    t = to_tensor(np.asarray(arr))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(arr.astype(jnp.float32)))
    tree = {"dec": {"body": {"p0": {"w": np.arange(6).reshape(3, 2)}}},
            "x": np.ones(2)}
    out = bridge_tree(tree)
    assert [layer["w"].tolist() for layer in out["dec"]["layers"]] == \
        [[0, 1], [2, 3], [4, 5]]


# --------------------------------------------------------------------------
# layer primitives
# --------------------------------------------------------------------------

def test_rmsnorm_rope_embed_match_reference():
    cfg_j = jax_get_config("qwen2_0p5b", smoke=True)
    cfg_t = get_config("qwen2_0p5b", smoke=True)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 128)).astype(np.float32) * 3
    scale = rng.normal(size=(128,)).astype(np.float32)
    want = JL.norm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x), cfg_j)
    got = TL.norm_apply({"scale": torch.from_numpy(scale)},
                        torch.from_numpy(x), cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)

    q = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    pos = np.array([[3, 4, 5, 6, 7, 8, 9], [0, 1, 2, 3, 4, 5, 100]])
    want = JL.rope(jnp.asarray(q), jnp.asarray(pos), 1e6)
    got = TL.rope(torch.from_numpy(q), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)

    tok = rng.normal(size=(512, 128)).astype(np.float32)
    ids = rng.integers(0, 512, (2, 5))
    want = JL.embed_apply({"tok": jnp.asarray(tok)}, jnp.asarray(ids), cfg_j)
    got = TL.embed_apply({"tok": torch.from_numpy(tok)},
                         torch.from_numpy(ids), cfg_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# the model: prefill + decode logits against JAX
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_weights():
    cfg = jax_get_config("qwen2_0p5b", smoke=True)
    jm = JaxModel(cfg, peft="bea")
    base, tr = jm.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    # E off its zero init and a pruned top rank, so the adapters matter
    tr = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.asarray(rng.normal(size=v.shape) * 0.05, v.dtype)
        if str(p[-1].key) == "E" else v, tr)
    masks = jax.tree.map(lambda m: m.at[..., -1].set(False), jm.init_masks())
    return cfg, jm, base, tr, masks


@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_and_decode_logits_match_jax(smoke_weights, use_kernels):
    cfg, jm, base, tr, masks = smoke_weights
    rng = np.random.default_rng(4)
    b, s, t_max = 2, 7, 16
    prompt = rng.integers(0, cfg.vocab_size, (b, s))
    steps = rng.integers(0, cfg.vocab_size, (3, b, 1))

    cache = jax.tree.map(lambda m: jnp.zeros(m.shape, m.dtype),
                         jm.cache_meta(b, t_max),
                         is_leaf=lambda x: hasattr(x, "init"))
    want_pre, cache = jm.prefill(base, tr, masks, {"tokens":
                                                   jnp.asarray(prompt)}, cache)
    want_dec = []
    for tok in steps:
        lg, cache = jm.decode_step(base, tr, masks, jnp.asarray(tok), cache)
        want_dec.append(np.asarray(lg))

    tb, ttr, tmask = from_jax(_np(base), _np(tr), _np(masks))
    tm = Model(get_config("qwen2_0p5b", smoke=True), use_kernels=use_kernels)
    tcache = tm.init_cache(b, t_max, "cpu")
    got_pre, tcache = tm.prefill(tb, ttr, tmask, torch.from_numpy(prompt),
                                 tcache)
    np.testing.assert_allclose(got_pre.numpy(), np.asarray(want_pre),
                               rtol=TOL, atol=TOL)
    assert tcache["pos"].tolist() == [s, s]
    for tok, want in zip(steps, want_dec):
        got, tcache = tm.decode_step(tb, ttr, tmask, torch.from_numpy(tok),
                                     tcache)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert tcache["pos"].tolist() == [s + 3, s + 3]


def test_ragged_rows_decode_like_solo_rows(smoke_weights):
    """decode_rows with per-row positions and adapters equals each row
    decoded alone (the batched decode replaces the JAX vmap over rows)."""
    cfg, jm, base, tr, masks = smoke_weights
    tb, ttr, tmask = from_jax(_np(base), _np(tr), _np(masks))
    tm = Model(get_config("qwen2_0p5b", smoke=True))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in (3, 6)]
    solo, caches = [], []
    for p in prompts:
        c = tm.init_cache(1, 12, "cpu")
        _, c = tm.prefill(tb, ttr, tmask, torch.from_numpy(p), c)
        caches.append(c)
        lg, _ = tm.decode_step(tb, ttr, tmask, torch.tensor([[5]]),
                               _clone(c))
        solo.append(lg[0])
    joint = {"dec": {"layers": [
        {k: torch.cat([a[k], b_[k]]) for k in ("k", "v")}
        for a, b_ in zip(caches[0]["dec"]["layers"],
                         caches[1]["dec"]["layers"])]},
        "pos": torch.cat([caches[0]["pos"], caches[1]["pos"]])}
    stacks = {"dec": ttr["adapters"]["dec"]}
    st = tree_map(lambda t: torch.stack([t, t]), stacks)
    sm = tree_map(lambda t: torch.stack([t, t]), tmask)
    got = tm.decode_rows(tb, st, sm, torch.tensor([1, 0], dtype=torch.int32),
                         torch.tensor([5, 5]), joint, torch.tensor([0, 1]))
    for g, want in zip(got, solo):
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert joint["pos"].tolist() == [4, 7]


def _clone(cache):
    return {"dec": {"layers": [{k: v.clone() for k, v in layer.items()}
                               for layer in cache["dec"]["layers"]]},
            "pos": cache["pos"].clone()}
