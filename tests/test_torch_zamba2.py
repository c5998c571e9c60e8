"""Port parity for Zamba2-1.2B LM fine-tuning (CPU, float32, SMOKE widths:
d_model 128, pattern ``(mamba, shared_attn) × 2``, 4 heads of 32 with a
16-token window, SSD of 8 heads × 32 with state 16 and chunk 16, 48
tokens): the config, the metas with one ``dec.shared`` tree, ``build_plan``
against the reference's, the bridge of both reference layouts (and of the
full config's metas, abstractly), the whole model's logits, ``lm_loss``
and every adapter gradient (the shared adapter's the sum over its
occurrences), five train steps, the bottleneck PEFT kinds on the shared
block, FedARA's masks, importance and comm bytes over the unrolled
adapters; the refusals and the ``train.py`` CLI.  Weights cross by
``bridge.from_jax(..., pattern=)``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro import optim as JOPT
from repro.configs import get_config as jax_get_config
from repro.core import comm as JCOMM
from repro.core import importance as JIMP
from repro.core.fedara import FedARA as JFedARA
from repro.data import synthetic as JS
from repro.launch import steps as JST
from repro.models import Ctx
from repro.models import Model as JaxModel
from repro.models import plan as JPLAN
from repro.pytree import tree_bytes as jax_tree_bytes
from repro_torch import optim as TOPT
from repro_torch.bridge import bridge_tree, from_jax, relayout
from repro_torch.configs import get_config
from repro_torch.core import comm as COMM
from repro_torch.core import importance as IMP
from repro_torch.core.fedara import FedARA
from repro_torch.launch import steps as TST
from repro_torch.launch import train as TTR
from repro_torch.models import Model
from repro_torch.models import blocks as TBK
from repro_torch.models import plan as TPLAN
from repro_torch.pytree import flatten_with_paths, tree_bytes, tree_map

# rtol 1e-5 and atol 1e-5 of the tensor's largest |value|: the SSD's
# chunked scan sums in an order XLA and torch choose apart
# (tests/test_torch_ssm.py)
TOL = 1e-5
LOGIT_SHARE_TOL = 2e-6      # logits: atol as a share of max|logit|
STEP_TOL = 1e-4             # five Adam steps, tests/test_torch_launch_train.py
ARCH = "zamba2_1p2b"
PATTERN = ("mamba", "shared_attn", "mamba", "shared_attn")
B, S = 2, 48                # 48 tokens: the 16-token window binds


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, what="", tol=TOL):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=tol,
                               atol=tol * scale, err_msg=what)


def _close_logits(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=LOGIT_SHARE_TOL * np.abs(want).max())


def _e_off_zero(tree, rng):
    return jax.tree_util.tree_map_with_path(
        lambda p, v: v + jnp.asarray(rng.normal(size=v.shape) * 0.3, v.dtype)
        if str(p[-1].key) == "E" else v, tree)


def _bridge(base, tr, masks):
    return from_jax(_np(base), None if tr is None else _np(tr),
                    None if masks is None else _np(masks), pattern=PATTERN)


def _is_meta(m):
    return hasattr(m, "init")


# --------------------------------------------------------------------------
# the config, the plan and the metas
# --------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(smoke):
    ref = jax_get_config(ARCH, smoke=smoke)
    got = get_config(ARCH, smoke=smoke)
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "head_dim", "d_ff", "vocab_size", "layer_pattern",
              "sliding_window", "ssm_state", "ssm_head_dim", "ssm_expand",
              "ssm_conv", "ssm_chunk", "pos_emb", "act", "glu",
              "tie_embeddings", "rope_theta", "adapter_targets",
              "adapter_rank", "adapter_alpha", "param_dtype",
              "compute_dtype", "source", "d_inner", "ssm_heads", "causal",
              "attn_softcap", "final_softcap", "post_block_norm"):
        assert getattr(got, f) == getattr(ref, f), f
    assert get_config("zamba2-1.2b", smoke=smoke) == got
    if not smoke:
        assert got.layer_pattern.count("shared_attn") == 6
        assert (got.n_layers, got.d_inner, got.ssm_heads) == (38, 4096, 64)


def _plan_cases():
    """Known patterns: tests/test_plan.py's and the configs' own."""
    cases = [("moe",) * 61, ("local", "attn") * 13,
             (("local",) * 5 + ("attn",)) * 4 + ("local", "local"),
             (("mamba",) * 5 + ("shared_attn",)) * 6 + ("mamba", "mamba"),
             ("attn",), PATTERN, ("mamba", "shared_attn", "mamba")]
    return cases + [tuple(jax_get_config(a).layer_pattern)
                    for a in ("gemma3_1b", "mamba2_780m", ARCH)]


@pytest.mark.parametrize("pattern", _plan_cases())
def test_build_plan_matches_reference_on_known_patterns(pattern):
    got, want = TPLAN.build_plan(pattern), JPLAN.build_plan(pattern)
    assert (got.period, got.repeats, got.tail, got.n_layers) == (
        want.period, want.repeats, want.tail, want.n_layers)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.sampled_from(["attn", "local", "moe", "mamba",
                                 "shared_attn"]), min_size=1, max_size=40))
def test_build_plan_matches_reference(pattern):
    pattern = tuple(pattern)
    got, want = TPLAN.build_plan(pattern), JPLAN.build_plan(pattern)
    assert (got.period, got.repeats, got.tail) == (want.period, want.repeats,
                                                   want.tail)
    assert got.period * got.repeats + got.tail == pattern


def _abstract(tree):
    """A reference meta tree as numpy views of one zero each (nothing is
    allocated at the meta's size), for the bridge's layout alone."""
    return jax.tree.map(lambda m: np.broadcast_to(
        np.zeros((), np.dtype(m.dtype)), m.shape), tree, is_leaf=_is_meta)


def _shapes(tree, port: bool):
    return {p: (tuple(m.shape), str(m.dtype).split(".")[-1]) for p, m in
            flatten_with_paths(tree, is_leaf=_is_meta if port else None)}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("peft", ["bea", "lora", "adapter_h", "adapter_p"])
def test_metas_match_reference(smoke, peft):
    """Byte totals of the base and trainable trees equal the reference's;
    ``dec.shared`` is one tree (an ``attn`` block's), empty entries stand at
    the shared positions, and each reference layout's metas, bridged
    abstractly, give the port's leaves, shapes and dtypes — 38 layers for
    the full config under ``unroll=False`` (a body of 5 stacked 6 times
    and a tail of 2)."""
    cfg_j, cfg = jax_get_config(ARCH, smoke=smoke), get_config(ARCH,
                                                                smoke=smoke)
    tm = Model(cfg, peft=peft)
    for unroll in (False, True):
        jm = JaxModel(cfg_j, peft=peft, unroll=unroll)
        assert tree_bytes(tm.base_meta()) == jax_tree_bytes(jm.base_meta())
        assert tree_bytes(tm.trainable_meta()) == \
            jax_tree_bytes(jm.trainable_meta())
        pairs = [(tm.base_meta(), jm.base_meta()),
                 (tm.trainable_meta(), jm.trainable_meta())]
        if peft in ("bea", "lora"):
            pairs.append((tm.mask_meta(), jm.mask_meta()))
        for port, ref in pairs:
            bridged = relayout(_abstract(ref), cfg.layer_pattern)
            assert _shapes(bridged, False) == _shapes(port, True)
    base = tm.base_meta()
    layers = base["dec"]["layers"]
    assert len(layers) == cfg.n_layers
    shared_at = [i for i, k in enumerate(cfg.layer_pattern)
                 if k == "shared_attn"]
    assert [i for i, lay in enumerate(layers) if not lay] == shared_at
    assert set(base["dec"]["shared"]) == {"ln1", "attn", "ln2", "mlp"}
    ad = tm.adapter_meta()["dec"]
    assert all(not ad["layers"][i] for i in shared_at)
    assert set(ad["shared"]) == ({"post_mlp", "post_attn"}
                                 if peft == "adapter_h" else {"post_mlp"}
                                 if peft == "adapter_p" else {"attn", "mlp"})
    if not smoke:
        assert len(shared_at) == 6 and len(layers) == 38


def test_full_config_unroll_false_metas_bridge_to_38_layers():
    """The full config's reference stacks ``(5 × mamba, shared_attn)``
    six times (``body.p0``..``p4``, no ``p5``) and a tail of two: bridged
    abstractly, 38 layers in pattern order and ``shared`` once."""
    cfg_j = jax_get_config(ARCH)
    jm = JaxModel(cfg_j, peft="bea")
    ref = jm.base_meta()["dec"]
    assert sorted(ref["body"]) == ["p0", "p1", "p2", "p3", "p4"]
    assert sorted(ref["tail"]) == ["t0", "t1"] and "shared" in ref
    got = relayout(_abstract(jm.base_meta()), cfg_j.layer_pattern)["dec"]
    kinds = ["shared_attn" if not lay else "mamba" for lay in got["layers"]]
    assert tuple(kinds) == cfg_j.layer_pattern
    assert got["shared"]["attn"]["wq"]["w"].shape == (2048, 32, 64)
    assert got["layers"][0]["ssm"]["in_proj"]["w"].shape == (2048, 8384)
    assert got["layers"][37]["ssm"]["out_proj"]["w"].shape == (4096, 2048)


# --------------------------------------------------------------------------
# the bridge
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def layouts():
    """The reference's SMOKE init under both layouts."""
    cfg_j = jax_get_config(ARCH, smoke=True)
    out = {}
    for unroll in (False, True):
        jm = JaxModel(cfg_j, peft="bea", unroll=unroll)
        base, tr = jm.init(jax.random.key(3))
        out[unroll] = (jm, base, tr, jm.init_masks())
    return out


@pytest.mark.parametrize("unroll", [False, True])
def test_both_reference_layouts_bridge_to_four_layers(layouts, unroll):
    """``unroll=False``: ``body.p0`` stacked twice (the period ``(mamba,
    shared_attn)``, no ``p1``); ``unroll=True``: ``tail.t0`` and ``t2``.
    Both bridge to four layers in pattern order, empty at 1 and 3, layer
    ``2·i`` the reference's ``i``-th mamba layer, and ``shared`` once to
    ``dec.shared``."""
    jm, base, tr, masks = layouts[unroll]
    dec = base["dec"]
    if unroll:
        assert set(dec) == {"tail", "shared"} and set(dec["tail"]) == {"t0",
                                                                       "t2"}
    else:
        assert set(dec) == {"body", "shared"} and set(dec["body"]) == {"p0"}
        assert dec["body"]["p0"]["ssm"]["a_log"].shape[0] == 2
    for tree in _bridge(base, tr, masks):
        layers = tree["dec"]["layers"] if "dec" in tree else \
            tree["adapters"]["dec"]["layers"]
        assert len(layers) == 4
        assert [bool(lay) for lay in layers] == [True, False, True, False]
        assert "ssm" in layers[0] and "ssm" in layers[2]
    tb, ttr, tm = _bridge(base, tr, masks)
    assert set(tb["dec"]["shared"]) == {"ln1", "attn", "ln2", "mlp"}
    assert set(ttr["adapters"]["dec"]["shared"]) == {"attn", "mlp"}
    assert set(tm["dec"]["shared"]) == {"attn", "mlp"}
    for port, ref in ((tb, base), (ttr["adapters"], tr["adapters"]),
                      (tm, masks)):
        for i in (0, 1):
            want = (ref["dec"]["tail"][f"t{2 * i}"] if unroll else
                    jax.tree.map(lambda t: t[i], ref["dec"]["body"]["p0"]))
            got = flatten_with_paths(port["dec"]["layers"][2 * i])
            wflat = flatten_with_paths(bridge_tree(_np(want)))
            assert [p for p, _ in got] == [p for p, _ in wflat]
            assert all(torch.equal(x, y) for (_, x), (_, y) in zip(got, wflat))
        got = flatten_with_paths(port["dec"]["shared"])
        wflat = flatten_with_paths(bridge_tree(_np(ref["dec"]["shared"])))
        assert [p for p, _ in got] == [p for p, _ in wflat]
        assert all(torch.equal(x, y) for (_, x), (_, y) in zip(got, wflat))


def test_bridge_raises_on_a_wrong_or_missing_pattern(layouts):
    """A shared tree without the pattern, a pattern of another length or
    with the shared block elsewhere: each raises, none returns fewer
    layers than the pattern has.  (The unrolled tree has no entry at a
    shared position, so a pattern that drops the trailing shared
    position, ``PATTERN[:3]``, fits it: it is caught in the stacked
    layout, whose repeat count it changes.)"""
    for unroll in (False, True):
        base = _np(layouts[unroll][1])
        with pytest.raises(ValueError, match="pattern"):
            from_jax(base, None, None)
        wrongs = [PATTERN + ("mamba",), PATTERN + ("mamba", "shared_attn"),
                  ("shared_attn", "mamba", "shared_attn", "mamba"),
                  ("mamba",) * 4, ("mamba", "shared_attn") * 3,
                  ("mamba", "mamba", "mamba", "shared_attn")]
        if not unroll:
            wrongs.append(PATTERN[:3])
        for wrong in wrongs:
            with pytest.raises(ValueError):
                from_jax(base, None, None, pattern=wrong)


def test_bridge_without_shared_keeps_its_layout():
    """A pattern without ``shared_attn`` bridges as without the pattern
    (Gemma3's SMOKE-width period of six and tail, scanned)."""
    cfg_j = jax_get_config("gemma3_1b", smoke=True)
    jm = JaxModel(cfg_j, peft="bea")
    base, tr = jm.init(jax.random.key(1))
    masks = jm.init_masks()
    plain = from_jax(_np(base), _np(tr), _np(masks))
    with_pattern = from_jax(_np(base), _np(tr), _np(masks),
                            pattern=cfg_j.layer_pattern)
    for a, b in zip(plain, with_pattern):
        fa, fb = flatten_with_paths(a), flatten_with_paths(b)
        assert [p for p, _ in fa] == [p for p, _ in fb]
        assert all(torch.equal(x, y) for (_, x), (_, y) in zip(fa, fb))


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def _perturbed(jm, seed):
    base, tr = jm.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    tr = _e_off_zero(tr, rng)
    masks = jax.tree.map(lambda m: m.at[..., 1].set(False), jm.init_masks())
    return base, tr, masks, rng


def _batch(rng, vocab, b=B, s=S):
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    targets = rng.integers(0, vocab, (b, s)).astype(np.int32)
    targets[0, :5] = -1
    return ({"tokens": jnp.asarray(toks), "targets": jnp.asarray(targets)},
            {"tokens": torch.from_numpy(toks).long(),
             "targets": torch.from_numpy(targets).long()})


def _jax_logits(jm):
    return jax.jit(lambda b, t, m, x: jm.forward(b, t, m, x, remat=False)[0])


@pytest.fixture(scope="module")
def case():
    cfg_j = jax_get_config(ARCH, smoke=True)
    jm = JaxModel(cfg_j, peft="bea")
    base, tr, masks, rng = _perturbed(jm, 4)
    jb, tb = _batch(rng, cfg_j.vocab_size)
    logits = _jax_logits(jm)(base, tr, masks, jb)
    (total, (loss, aux)), grads = jax.jit(jax.value_and_grad(
        lambda t, b, m, x: jm.lm_loss(b, t, m, x, remat=False),
        has_aux=True))(tr, base, masks, jb)
    return dict(cfg=get_config(ARCH, smoke=True), cfg_j=cfg_j,
                trees=_bridge(base, tr, masks),
                grads=_bridge(grads, None, None)[0], batch=tb,
                logits=np.asarray(logits), total=float(total),
                loss=float(loss))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_zamba2_logits_match_jax(case, use_kernels):
    base, tr, masks = case["trees"]
    cfg = case["cfg"]
    model = Model(cfg, peft="bea", use_kernels=use_kernels)
    assert model.pattern == PATTERN
    with torch.no_grad():
        logits = model.forward(base, tr, masks, case["batch"])
    assert logits.shape == (B, S, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    _close_logits(logits.numpy(), case["logits"])


@functools.cache
def _reference():
    cfg_j = jax_get_config(ARCH, smoke=True)
    jm = JaxModel(cfg_j, peft="bea")
    return cfg_j, jm, _jax_logits(jm)


@pytest.mark.parametrize("seed", range(10))
def test_zamba2_logits_match_jax_over_seeds(seed):
    cfg_j, jm, fwd = _reference()
    base, tr, masks, rng = _perturbed(jm, seed)
    jb, tb = _batch(rng, cfg_j.vocab_size)
    want = np.asarray(fwd(base, tr, masks, jb), np.float64)
    trees = _bridge(base, tr, masks)
    for use_kernels in (False, True):
        model = Model(get_config(ARCH, smoke=True), peft="bea",
                      use_kernels=use_kernels)
        with torch.no_grad():
            _close_logits(model.forward(*trees, tb).numpy(), want)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_zamba2_lm_loss_and_adapter_grads_match_jax(case, use_kernels):
    """Every adapter leaf's grad, the shared block's included: its one
    leaf is used at both shared positions, so autograd sums the two
    occurrences' grads, as ``jax.grad`` does over the reference's one
    ``shared`` tree."""
    base, tr, masks = case["trees"]
    model = Model(case["cfg"], peft="bea", use_kernels=use_kernels)
    flat = []

    def leaf(t):
        flat.append(t.clone().requires_grad_(True))
        return flat[-1]

    req = tree_map(leaf, tr)
    total, (loss, aux) = model.lm_loss(base, req, masks, case["batch"])
    _close(total.item(), case["total"], "total")
    _close(loss.item(), case["loss"], "loss")
    assert aux.item() == 0.0
    it = iter(torch.autograd.grad(total, flat))
    got = tree_map(lambda _: next(it), req)
    want = dict(flatten_with_paths(case["grads"]))
    paths = flatten_with_paths(got)
    assert [p for p, _ in paths] == sorted(want)
    # 2 mamba layers × (in_proj, out_proj) and the shared block's 7
    # linears, each A, B and E
    assert len(paths) == 3 * (2 * 2 + 7)
    for path, g in paths:
        _close(g.numpy(), want[path].numpy(), path)
    shared = got["adapters"]["dec"]["shared"]
    assert not shared["attn"]["wq"]["E"][1]            # masked rank
    assert shared["mlp"]["w2"]["E"].abs().sum() > 0


def test_shared_grad_is_the_sum_over_occurrences(case):
    """The shared adapter's grad equals the sum of the grads that two
    separate copies, one per occurrence, would get."""
    base, tr, masks = case["trees"]
    model = Model(case["cfg"], peft="bea", use_kernels=False)
    shared = tr["adapters"]["dec"]["shared"]
    one = tree_map(lambda t: t.clone().requires_grad_(True), shared)
    tr1 = {**tr, "adapters": {"dec": {**tr["adapters"]["dec"],
                                      "shared": one}}}
    g_one = torch.autograd.grad(model.lm_loss(base, tr1, masks,
                                              case["batch"])[0],
                                [one["attn"]["wq"]["A"]])[0]
    copies = [tree_map(lambda t: t.clone().requires_grad_(True), shared)
              for _ in range(2)]
    calls = iter(copies)
    orig = TBK.block_apply

    def split_apply(p, x, cfg, *, kind="attn", ad=None, **kw):
        if kind == "shared_attn":
            ad = next(calls)
        return orig(p, x, cfg, kind=kind, ad=ad, **kw)

    TBK.block_apply = split_apply
    try:
        total = model.lm_loss(base, tr, masks, case["batch"])[0]
    finally:
        TBK.block_apply = orig
    g_two = torch.autograd.grad(total, [c["attn"]["wq"]["A"]
                                        for c in copies])
    assert all(g.abs().sum() > 0 for g in g_two)
    _close(g_one.numpy(), (g_two[0] + g_two[1]).numpy(), "sum")


def test_zamba2_five_train_steps_match_reference(case):
    """Adam steps the shared adapter once a step: its leaf appears once in
    the trainable tree."""
    cfg_j = case["cfg_j"]
    jm = JaxModel(cfg_j, peft="bea")
    base, tr = jm.init(jax.random.key(6))
    masks = jax.tree.map(lambda m: m.at[..., 0].set(False), jm.init_masks())
    n, b = 5, 2
    data = JS.make_lm_stream(n * b, cfg_j.vocab_size, S, seed=2)
    jstep = jax.jit(JST.make_train_step(
        jm, JOPT.adam(JOPT.linear_decay(3e-3, n)), Ctx(), task="lm"))
    tbase, ttr, tmasks = _bridge(base, tr, masks)
    topt = TOPT.adam(TOPT.linear_decay(3e-3, n))
    tstep = TST.make_train_step(Model(case["cfg"]), topt, task="lm")
    js, ts = JOPT.adam(JOPT.linear_decay(3e-3, n)).init(tr), topt.init(ttr)
    for i in range(n):
        sl = slice(i * b, (i + 1) * b)
        jb = {"tokens": jnp.asarray(data["tokens"][sl]),
              "targets": jnp.asarray(data["targets"][sl])}
        tb = {k: torch.as_tensor(np.array(v)).long() for k, v in jb.items()}
        tr, js, jmet = jstep(base, tr, js, masks, jb)
        ttr, ts, tmet = tstep(tbase, ttr, ts, tmasks, tb)
        _close(tmet["loss"].item(), float(jmet["loss"]), f"step {i}",
               STEP_TOL)
    want = dict(flatten_with_paths(_bridge(tr, None, None)[0]))
    got = flatten_with_paths(ttr)
    assert [p for p, _ in got] == sorted(want)
    for path, t in got:
        _close(t.numpy(), want[path].numpy(), path, STEP_TOL)
    assert any(t.abs().sum() > 0 for p, t in got
               if p.startswith("adapters.dec.shared") and p.endswith(".E"))


@pytest.mark.parametrize("peft", ["adapter_h", "adapter_p"])
def test_bottleneck_kinds_match_reference(peft):
    """FedAdapter-H/P on Zamba2: the shared block gets an ``attn`` block's
    bottlenecks (``post_attn`` under H, ``post_mlp``), one set at both
    occurrences; a mamba block only ``post_mlp``."""
    cfg_j = jax_get_config(ARCH, smoke=True)
    jm = JaxModel(cfg_j, peft=peft)
    base, tr = jm.init(jax.random.key(8))
    rng = np.random.default_rng(8)
    tr = jax.tree.map(lambda v: v + jnp.asarray(
        rng.normal(size=v.shape) * 0.1, v.dtype), tr)
    jb, tb = _batch(rng, cfg_j.vocab_size)
    want = _jax_logits(jm)(base, tr, None, jb)
    tbase, ttr, _ = _bridge(base, tr, None)
    dec = ttr["adapters"]["dec"]
    assert set(dec["layers"][0]) == {"post_mlp"}
    assert set(dec["shared"]) == ({"post_attn", "post_mlp"}
                                  if peft == "adapter_h" else {"post_mlp"})
    model = Model(get_config(ARCH, smoke=True), peft=peft)
    with torch.no_grad():
        got = model.forward(tbase, ttr, None, tb)
    _close_logits(got.numpy(), want)


# --------------------------------------------------------------------------
# FedARA's pieces over the unrolled Zamba2 adapter tree
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zamba_trees():
    jm = JaxModel(jax_get_config(ARCH, smoke=True), peft="bea", unroll=True)
    rng = np.random.default_rng(21)

    def fill(scale):
        return jax.tree.map(
            lambda m: rng.normal(size=m.shape).astype(np.float32) * scale,
            jm.adapter_meta(), is_leaf=_is_meta)

    ad, gr = fill(0.2), fill(1e-2)
    glob = jax.tree.map(np.array, jm.init_masks())
    glob["dec"]["tail"]["t0"]["ssm"]["in_proj"][::2] = False
    glob["dec"]["shared"]["attn"]["wq"][:] = False
    glob["dec"]["shared"]["mlp"]["w1"][1] = False
    return dict(ad=ad, gr=gr, glob=glob)


def _b(tree):
    return bridge_tree(_np(tree), pattern=PATTERN)


@pytest.mark.parametrize("method", ["mag", "grad", "mixed", "sensitivity"])
def test_importance_over_zamba2_adapters_matches_reference(zamba_trees,
                                                           method):
    t = zamba_trees
    want, _ = JIMP.score_tree(t["ad"], t["gr"], method)
    got, _ = IMP.score_tree(_b(t["ad"]), _b(t["gr"]), method)
    wflat = dict(flatten_with_paths(_b(want)))
    gflat = flatten_with_paths(got)
    assert len(gflat) == len(wflat) == 2 * 2 + 7
    assert sum(p.startswith("dec.shared") for p, _ in gflat) == 7
    for path, s in gflat:
        np.testing.assert_allclose(np.asarray(s), wflat[path].numpy(),
                                   rtol=1e-6, atol=0, err_msg=path)


def test_fedara_local_masks_over_zamba2_adapters(zamba_trees):
    """One mask set for the shared block (7 modules, not 14), equal to the
    reference's at three rounds of the budget schedule."""
    t = zamba_trees
    s, js = FedARA(), JFedARA()
    n = (2 * 2 + 7) * 4
    for rnd in (0, 6, 40):
        want = js.local_masks(rnd, t["ad"], t["gr"], n)
        got = s.local_masks(rnd, _b(t["ad"]), _b(t["gr"]), n)
        wflat = dict(flatten_with_paths(_b(want)))
        gflat = flatten_with_paths(got)
        assert sorted(wflat) == [p for p, _ in gflat]
        assert sum(p.startswith("dec.shared") for p, _ in gflat) == 7
        for path, m in gflat:
            assert np.array_equal(np.asarray(m, bool), wflat[path].numpy()), \
                (rnd, path)
        assert got["dec"]["layers"][1] == {} and got["dec"]["layers"][3] == {}
    # the server's vote over two clients' masks keeps every slot too
    locs = [js.local_masks(6, t["ad"], t[k], n) for k in ("gr", "ad")]
    want = js.arbitrate(6, locs, t["glob"])
    got = s.arbitrate(6, [_b(m) for m in locs], _b(t["glob"]))
    assert len(got["dec"]["layers"]) == 4 and got["dec"]["layers"][3] == {}
    wflat = dict(flatten_with_paths(_b(want)))
    gflat = flatten_with_paths(got)
    assert sorted(wflat) == [p for p, _ in gflat]
    for path, m in gflat:
        assert np.array_equal(np.asarray(m, bool), wflat[path].numpy()), path


def test_comm_over_zamba2_adapters_matches_reference(zamba_trees):
    """``count_params`` and ``bytes_down`` equal the reference's, the shared
    block's bytes counted once.  ``pack``'s wire holds each module's
    segment as the reference packs that module; the modules follow each
    package's tree order (the port's ``dec.layers`` before ``dec.shared``,
    the reference's ``dec.shared`` before ``dec.tail``), and ``unpack``
    restores the port's tree."""
    t = zamba_trees
    tad = _b(t["ad"])
    for masks in (None, t["glob"]):
        tm = None if masks is None else tree_map(
            lambda m: np.asarray(m, bool), _b(masks))
        assert COMM.count_params(tad, tm) == JCOMM.count_params(t["ad"],
                                                                masks)
        assert COMM.bytes_down(tad, tm) == JCOMM.bytes_down(t["ad"], masks)
        wire = COMM.pack(tad, tm)
        segs = []
        for path, _, _ in COMM.iter_modules(tad, tm or {}):
            keys = path.split(".")
            ref_keys = (["dec", "shared"] + keys[2:] if keys[1] == "shared"
                        else ["dec", "tail", f"t{keys[2]}"] + keys[3:])
            mod, msk = t["ad"], masks
            for k in ref_keys:
                mod = mod[k]
                msk = None if msk is None else msk[k]
            segs.append(JCOMM.pack({"m": mod}, None if msk is None
                                   else {"m": msk}))
        np.testing.assert_array_equal(wire, np.concatenate(segs))
        assert wire.size == JCOMM.pack(t["ad"], masks).size
        back = COMM.unpack(wire, tad, tm)
        for (p, got), (_, full) in zip(flatten_with_paths(back),
                                       flatten_with_paths(tad)):
            if masks is None:
                np.testing.assert_array_equal(np.asarray(got),
                                              full.numpy(), err_msg=p)


def test_empty_slots_survive_the_flat_round_trips():
    """The shared positions' empty ``dec.layers`` slots come back from every
    flat form: ``unflatten_keys`` (an inner slot from the keys, a trailing
    one from ``like``), the federated pipeline's host and device copies,
    the transport's wire and SLoRA's sparse gate over the base."""
    from repro_torch.federated.baselines import SLoRA
    from repro_torch.fedsim import pipeline as PL
    from repro_torch.fedsim import transport as TP
    from repro_torch.pytree import flatten_with_keys, unflatten_keys

    model = Model(get_config(ARCH, smoke=True))
    base, tr = model.init(0, "cpu")
    items = flatten_with_keys(tr)
    short = unflatten_keys(items)["adapters"]["dec"]["layers"]
    assert len(short) == 3 and short[1] == {}
    trees = [unflatten_keys(items, tr), PL.to_host(tr),
             PL.to_device(PL.to_host(tr), tr),
             TP.unflatten_update(TP.flatten_update(tr, None), tr, None),
             SLoRA().sparse_gate(base)]
    for got, like in zip(trees, [tr] * 4 + [base]):
        layers = (got.get("adapters") or got)["dec"]["layers"]
        assert len(layers) == 4 and layers[1] == {} and layers[3] == {}
        assert [p for p, _ in flatten_with_paths(got)] == [
            p for p, _ in flatten_with_paths(like)]
    for (p, a), (_, b) in zip(flatten_with_paths(trees[2]),
                              flatten_with_paths(tr)):
        assert torch.equal(a, b), p


# --------------------------------------------------------------------------
# the entry points
# --------------------------------------------------------------------------

def test_zamba2_serving_and_cohort_refuse_with_roadmap_pointer():
    """Zamba2's serving (a KV ring cache per shared occurrence, the SSM
    state) is ROADMAP.md queue 1 item 13's; the cohort's client-batched
    forward refuses at the first mamba block and at a shared block."""
    cfg = get_config(ARCH, smoke=True)
    model = Model(cfg, use_kernels=False)
    base, tr = model.init(0, "cpu")
    toks = torch.zeros(1, 4, dtype=torch.long)
    for call in (lambda: model.cache_meta(1, 8),
                 lambda: model.prefill(base, tr, None, toks),
                 lambda: TBK.block_cache_meta(cfg, "shared_attn", 1, 8),
                 lambda: Model(cfg.with_(sliding_window=None, n_layers=2,
                                         layer_pattern=("attn",
                                                        "shared_attn")),
                               use_kernels=False).cache_meta(1, 8),
                 lambda: TBK.block_apply(
                     base["dec"]["shared"], torch.zeros(1, 4, cfg.d_model),
                     cfg, mode="prefill", kind="shared_attn")):
        with pytest.raises(NotImplementedError, match="queue 1 item 13"):
            call()
    from repro_torch.launch import serve
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        serve.build_engine(cfg, n_slots=1, max_seq=8, device="cpu")
    ctr = tree_map(lambda t: t[None], tr)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        model.lm_loss(base, ctr, None, {"tokens": toks[None],
                                        "targets": toks[None]}, clients=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TBK.block_apply(base["dec"]["shared"],
                        torch.zeros(1, 1, 4, cfg.d_model), cfg, mode="train",
                        kind="shared_attn", clients=True)


def test_zamba2_init_seeds_the_shared_block_once():
    """``init`` and ``init_masks`` give ``dec.shared`` one tree drawn by its
    own path, distinct from every layer's, and nothing at the shared
    positions."""
    model = Model(get_config(ARCH, smoke=True))
    base, tr = model.init(0, "cpu")
    masks = model.init_masks("cpu")
    for tree in (base["dec"], tr["adapters"]["dec"], masks["dec"]):
        assert tree["layers"][1] == {} and tree["layers"][3] == {}
        assert "shared" in tree
    wq = base["dec"]["shared"]["attn"]["wq"]["w"]
    assert not torch.equal(wq, model.init(1, "cpu")[0]["dec"]["shared"][
        "attn"]["wq"]["w"])
    assert wq.shape == (128, 4, 32)
    assert tr["adapters"]["dec"]["shared"]["attn"]["wq"]["A"].shape == (4, 128)
    assert masks["dec"]["shared"]["mlp"]["w2"].shape == (4,)


def test_zamba2_train_cli_runs_on_cpu(capsys):
    out = TTR.main(["--arch", ARCH, "--device", "cpu", "--smoke", "--steps",
                    "3", "--seq", "32"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[1] for ln in lines[:-1]] == ["0", "1", "2"]
    assert lines[-1].startswith("done: 3 steps")
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert set(out["base"]["dec"]["layers"][0]) == {"ln1", "ssm"}
    assert out["base"]["dec"]["layers"][1] == {}
    assert "shared" in out["trainable"]["adapters"]["dec"]
