"""Port parity for the Mamba2 SSD block and Mamba2-780M LM fine-tuning
(CPU, float32, SMOKE widths: d_model 128, d_inner 256, 8 SSM heads of 32,
state 16, chunk 16, 48 tokens): the configs and metas, ``_conv_causal``,
``_gated_norm``, ``ssd_chunked`` and ``ssm_apply`` (BEA adapters on
in_proj/out_proj, a partial mask) and their gradients against the
reference; ``ssd_chunked`` at chunks 64 and 256, where the reference's
exponent overflows to NaN and the port equals a float64 sequential
recurrence; the whole model's logits, ``lm_loss`` and every adapter
gradient, five train steps, the reference built ``unroll=False``,
bottleneck PEFT kinds, FedARA's masks, importance and comm bytes over a
Mamba2 adapter tree; the refusals and the ``train.py`` CLI.  Weights cross
by ``bridge.from_jax``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JOPT
from repro.configs import get_config as jax_get_config
from repro.core import comm as JCOMM
from repro.core import importance as JIMP
from repro.core.fedara import FedARA as JFedARA
from repro.data import synthetic as JS
from repro.launch import steps as JST
from repro.models import Ctx
from repro.models import Model as JaxModel
from repro.models import ssm as JSSM
from repro.pytree import materialize as jax_materialize
from repro.pytree import tree_bytes as jax_tree_bytes
from repro_torch import optim as TOPT
from repro_torch.bridge import bridge_tree, from_jax
from repro_torch.configs import get_config
from repro_torch.core import comm as COMM
from repro_torch.core import importance as IMP
from repro_torch.core.fedara import FedARA
from repro_torch.launch import steps as TST
from repro_torch.launch import train as TTR
from repro_torch.models import Model
from repro_torch.models import blocks as TBK
from repro_torch.models import ssm as TSSM
from repro_torch.pytree import flatten_with_paths, tree_bytes, tree_map

# rtol 1e-5 and atol 1e-5 of the tensor's largest |value| (never below 1e-5):
# the SSD sums 16-48 products a position through a chunked scan whose order
# XLA and torch choose apart, so its grads of magnitude ~80 differ between
# them by more than an absolute 1e-5, while both y's hold RECUR_TOL of a
# float64 recurrence (test_ssd_chunked_and_grads_match_reference)
TOL = 1e-5
# logits: atol as a share of max|logit|, as tests/test_torch_gemma.py
# (test_mamba2_logits_match_jax_over_seeds holds it at ten seeds)
LOGIT_SHARE_TOL = 2e-6
STEP_TOL = 1e-4     # five Adam steps, tests/test_torch_launch_train.py
# a float64 sequential recurrence against the f32 chunked scan: relative
# to the largest |y|, the gate chip_smoke.py holds on the card
RECUR_TOL = 1e-4
ARCH = "mamba2_780m"
B, S = 2, 48


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


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _e_off_zero(tree, rng):
    return jax.tree_util.tree_map_with_path(
        lambda p, v: v + jnp.asarray(rng.normal(size=v.shape) * 0.3, v.dtype)
        if str(p[-1].key) == "E" else v, tree)


# --------------------------------------------------------------------------
# configs and metas
# --------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(smoke):
    ref = jax_get_config(ARCH, smoke=smoke)
    got = get_config(ARCH, smoke=smoke)
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "head_dim", "d_ff", "vocab_size", "layer_pattern",
              "ssm_state", "ssm_head_dim", "ssm_expand", "ssm_conv",
              "ssm_chunk", "pos_emb", "act", "glu", "tie_embeddings",
              "adapter_targets", "adapter_rank", "adapter_alpha",
              "param_dtype", "compute_dtype", "source", "d_inner",
              "ssm_heads"):
        assert getattr(got, f) == getattr(ref, f), f
    assert get_config("mamba2-780m", smoke=smoke) == got
    if not smoke:
        assert (got.d_inner, got.ssm_heads, got.ssm_chunk) == (3072, 48, 256)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("peft", ["bea", "lora", "adapter_h", "adapter_p"])
def test_metas_match_reference(smoke, peft):
    """Same leaves, shapes and dtypes (a_log, dt_bias, d_skip and the gated
    norm's scale f32 in the bf16 model too, conv_w (K, C)); byte totals of
    the base and trainable trees equal the reference's."""
    cfg_j, cfg = jax_get_config(ARCH, smoke=smoke), get_config(ARCH,
                                                                smoke=smoke)
    want = dict(flatten_with_paths(JSSM.ssm_meta(cfg_j),
                                   is_leaf=lambda m: hasattr(m, "init")))
    got = flatten_with_paths(TSSM.ssm_meta(cfg),
                             is_leaf=lambda m: hasattr(m, "init"))
    assert [p for p, _ in got] == sorted(want)
    for path, m in got:
        w = want[path]
        assert m.shape == tuple(w.shape), path
        assert str(m.dtype).split(".")[1] == str(np.dtype(w.dtype)), path
        assert (m.init, m.scale) == (w.init, w.scale), path
    assert dict(got)["conv_w"].shape == (cfg.ssm_conv, cfg.d_inner
                                         + 2 * cfg.ssm_state)
    for name in ("a_log", "dt_bias", "d_skip", "gate_norm.scale"):
        assert dict(got)[name].dtype == torch.float32
    jm, tm = JaxModel(cfg_j, peft=peft), Model(cfg, peft=peft)
    assert tree_bytes(tm.base_meta()) == jax_tree_bytes(jm.base_meta())
    assert tree_bytes(tm.trainable_meta()) == \
        jax_tree_bytes(jm.trainable_meta())


# --------------------------------------------------------------------------
# the block's parts against the reference
# --------------------------------------------------------------------------

def _ssd_inputs(seed, s=S, h=8, p=32, n=16, b=B):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    a = -np.exp(rng.normal(size=(h,)) * 0.5).astype(np.float32)
    bm, cm = (rng.normal(size=(b, s, n)).astype(np.float32) * 0.5
              for _ in range(2))
    return x, dt, a, bm, cm


@pytest.mark.parametrize("chunk", [16, 24])
def test_ssd_chunked_and_grads_match_reference(chunk):
    """y, the final state and the grads of every input (a weighted sum of
    y and the state) at S = 48: three chunks of 16, or two of 24 (the
    reference is finite at both); the port's y and the reference's each
    within RECUR_TOL of a float64 recurrence."""
    ins = _ssd_inputs(chunk)
    rng = np.random.default_rng(1)
    gy = rng.normal(size=ins[0].shape).astype(np.float32)
    gh = rng.normal(size=(B, 8, 32, 16)).astype(np.float32)

    def jloss(*args):
        y, hf = JSSM.ssd_chunked(*args, chunk)
        return (y * gy).sum() + (hf * gh).sum(), (y, hf)

    (_, (wy, wh)), wg = jax.value_and_grad(jloss, argnums=range(5),
                                           has_aux=True)(
        *map(jnp.asarray, ins))
    leaves = [_t(a).requires_grad_(True) for a in ins]
    y, hf = TSSM.ssd_chunked(*leaves, chunk)
    _close(y.detach().numpy(), wy, "y")
    _close(hf.detach().numpy(), wh, "state")
    got = torch.autograd.grad((y * _t(gy)).sum() + (hf * _t(gh)).sum(),
                              leaves)
    for name, g, w in zip(("x", "dt", "a", "b", "c"), got, wg):
        _close(g.numpy(), w, f"d{name}")
    want_y, _ = _recurrence(*ins)
    for label, yy in (("port", y.detach().numpy()), ("reference", wy)):
        np.testing.assert_allclose(yy, want_y, rtol=0, atol=RECUR_TOL * np.abs(
            want_y).max(), err_msg=label)


def _recurrence(x, dt, a, b, c):
    """The reference's decode formula (repro/models/ssm.py:171-176), one
    position at a time in float64: h ← exp(dt·a)·h + dt·x⊗b, y = h·c."""
    x, dt, a, b, c = (np.asarray(t, np.float64) for t in (x, dt, a, b, c))
    bs, s, h, p = x.shape
    state = np.zeros((bs, h, p, b.shape[-1]))
    ys = []
    for t in range(s):
        decay = np.exp(dt[:, t] * a)                          # (B, H)
        upd = np.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t], b[:, t])
        state = decay[..., None, None] * state + upd
        ys.append(np.einsum("bn,bhpn->bhp", c[:, t], state))
    return np.stack(ys, 1), state


@pytest.mark.parametrize("chunk", [64, 256])
def test_ssd_equals_recurrence_where_the_reference_overflows(chunk):
    """At the reference's own init (a = −e from a_log = 1, dt_bias = 0) the
    cumulated exponent above the diagonal overflows within a few dozen
    positions: the reference's y at chunks 64 and 256 holds NaN.  The port
    masks the exponent before exp and equals the float64 recurrence."""
    rng = np.random.default_rng(chunk)
    s, h, p, n = 256, 4, 16, 8
    x = rng.normal(size=(1, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(1, s, h)))).astype(np.float32)
    a = -np.exp(np.ones(h, np.float32))
    bm, cm = (rng.normal(size=(1, s, n)).astype(np.float32)
              for _ in range(2))
    ref_y, _ = JSSM.ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)), chunk)
    assert np.isnan(np.asarray(ref_y)).any()
    y, hf = TSSM.ssd_chunked(*map(_t, (x, dt, a, bm, cm)), chunk)
    want_y, want_h = _recurrence(x, dt, a, bm, cm)
    assert torch.isfinite(y).all() and torch.isfinite(hf).all()
    for got, want in ((y, want_y), (hf, want_h)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=RECUR_TOL * np.abs(want).max())
    # where the reference is finite (chunk 16) it equals the port too
    y16, _ = TSSM.ssd_chunked(*map(_t, (x, dt, a, bm, cm)), 16)
    ref16, _ = JSSM.ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)), 16)
    _close(y16.numpy(), np.asarray(ref16), "chunk 16")


def test_conv_causal_and_gated_norm_match_reference():
    cfg_j = jax_get_config(ARCH, smoke=True)
    rng = np.random.default_rng(3)
    c = cfg_j.d_inner + 2 * cfg_j.ssm_state
    x = rng.normal(size=(B, S, c)).astype(np.float32)
    w = rng.normal(size=(4, c)).astype(np.float32) * 0.5
    bias = rng.normal(size=(c,)).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)

    def jconv(x, w, bias):
        return (JSSM._conv_causal(x, w, bias)[0] * gy).sum()

    want = JSSM._conv_causal(*map(jnp.asarray, (x, w, bias)))[0]
    wg = jax.grad(jconv, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, bias)))
    leaves = [_t(a).requires_grad_(True) for a in (x, w, bias)]
    got = TSSM._conv_causal(*leaves)
    _close(got.detach().numpy(), np.asarray(want), "conv")
    for name, g, v in zip(("x", "w", "b"), torch.autograd.grad(
            (got * _t(gy)).sum(), leaves), wg):
        _close(g.numpy(), np.asarray(v), f"conv d{name}")
    # causal: a change at position 10 moves nothing before it
    x2 = x.copy()
    x2[:, 10] += 1.0
    moved = TSSM._conv_causal(_t(x2), _t(w), _t(bias)) - got.detach()
    assert moved[:, :10].abs().max() == 0 and moved[:, 10:14].abs().max() > 0

    d = cfg_j.d_inner
    y, z = (rng.normal(size=(B, S, d)).astype(np.float32) for _ in range(2))
    scale = rng.normal(size=(d,)).astype(np.float32)
    want = JSSM._gated_norm({"scale": jnp.asarray(scale)}, jnp.asarray(y),
                            jnp.asarray(z), cfg_j)
    got = TSSM._gated_norm({"scale": _t(scale)}, _t(y), _t(z))
    _close(got.numpy(), np.asarray(want), "gated norm")


@pytest.mark.parametrize("x", [[-30.0, -1.0, 0.0, 0.5, 19.0, 21.0, 40.0]])
def test_softplus_is_the_reference_logaddexp(x):
    """dt's softplus equals jax.nn.softplus past torch's threshold of 20."""
    t = torch.tensor(x)
    got = torch.logaddexp(t, torch.zeros(()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax.nn.softplus(jnp.asarray(x, jnp.float32))))


def _ssm_operands(seed, peft="bea"):
    cfg_j, cfg = jax_get_config(ARCH, smoke=True), get_config(ARCH,
                                                              smoke=True)
    w = jax_materialize(JSSM.ssm_meta(cfg_j), jax.random.key(seed))
    rng = np.random.default_rng(seed)
    w = dict(w, a_log=jnp.asarray(rng.normal(size=w["a_log"].shape) * 0.5,
                                  jnp.float32),
             dt_bias=jnp.asarray(rng.normal(size=w["dt_bias"].shape),
                                 jnp.float32))
    ad = _e_off_zero(jax_materialize(JSSM.ssm_adapter_meta(cfg_j, peft),
                                     jax.random.key(seed + 1)), rng)
    masks = {k: jnp.ones(v["A"].shape[-2], bool).at[1].set(False)
             for k, v in ad.items()}
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    return (cfg_j, w, ad, masks), (cfg, bridge_tree(_np(w)),
                                   bridge_tree(_np(ad)),
                                   bridge_tree(_np(masks))), x


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssm_apply_and_grads_match_reference(use_kernel):
    """One mixer with BEA adapters on in_proj and out_proj, rank 1 of each
    masked: the output and the grads of x, every adapter leaf and the
    SSM's own f32 parameters."""
    (cfg_j, w, ad, masks), (cfg, tw, tad, tmasks), x = _ssm_operands(2)
    g = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    def jloss(w, ad, x):
        out, _ = JSSM.ssm_apply(w, x, cfg_j, ad=ad, masks=masks)
        return (out * g).sum(), out

    (_, want), (gw, gad, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(w, ad, jnp.asarray(x))
    flat = []

    def leaf(t):
        flat.append(t.clone().requires_grad_(True))
        return flat[-1]

    rw, rad, rx = tree_map(leaf, tw), tree_map(leaf, tad), leaf(_t(x))
    out = TSSM.ssm_apply(rw, rx, cfg, ad=rad, masks=tmasks,
                         use_kernel=use_kernel)
    _close(out.detach().numpy(), np.asarray(want), "out")
    it = iter(torch.autograd.grad((out * _t(g)).sum(), flat))
    gw_t, gad_t = tree_map(lambda _: next(it), rw), tree_map(
        lambda _: next(it), rad)
    _close(next(it).numpy(), np.asarray(gx), "dx")
    for got, want_tree in ((gw_t, gw), (gad_t, gad)):
        want_flat = dict(flatten_with_paths(bridge_tree(_np(want_tree))))
        for path, t in flatten_with_paths(got):
            _close(t.numpy(), want_flat[path].numpy(), path)
    assert not gad_t["in_proj"]["E"][1] and not gad_t["out_proj"]["E"][1]


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_ssm_serving_modes_refuse_with_roadmap_pointer(mode):
    _, (cfg, tw, tad, tmasks), x = _ssm_operands(0)
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        TSSM.ssm_apply(tw, _t(x), cfg, mode=mode)


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
                trees=from_jax(_np(base), _np(tr), _np(masks)),
                grads=from_jax(_np(grads), None, None)[0], batch=tb,
                logits=np.asarray(logits), total=float(total),
                loss=float(loss))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_mamba2_logits_match_jax(case, use_kernels):
    base, tr, masks = case["trees"]
    cfg = case["cfg"]
    model = Model(cfg, peft="bea", use_kernels=use_kernels)
    assert model.pattern == ("mamba", "mamba")
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
def test_mamba2_logits_match_jax_over_seeds(seed):
    cfg_j, jm, fwd = _reference()
    base, tr, masks, rng = _perturbed(jm, seed)
    jb, tb = _batch(rng, cfg_j.vocab_size)
    want = np.asarray(fwd(base, tr, masks, jb), np.float64)
    trees = from_jax(_np(base), _np(tr), _np(masks))
    for use_kernels in (False, True):
        model = Model(get_config(ARCH, smoke=True), peft="bea",
                      use_kernels=use_kernels)
        with torch.no_grad():
            _close_logits(model.forward(*trees, tb).numpy(), want)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_mamba2_lm_loss_and_adapter_grads_match_jax(case, use_kernels):
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
    assert len(paths) == 3 * 2 * case["cfg"].n_layers   # in_proj, out_proj
    for path, g in paths:
        _close(g.numpy(), want[path].numpy(), path)
    assert not got["adapters"]["dec"]["layers"][0]["ssm"]["in_proj"]["E"][1]


def test_mamba2_five_train_steps_match_reference(case):
    cfg_j = case["cfg_j"]
    jm = JaxModel(cfg_j, peft="bea")
    base, tr = jm.init(jax.random.key(6))
    masks = jax.tree.map(lambda m: m.at[..., 0].set(False), jm.init_masks())
    n, b = 5, 2
    data = JS.make_lm_stream(n * b, cfg_j.vocab_size, S, seed=2)
    jstep = jax.jit(JST.make_train_step(
        jm, JOPT.adam(JOPT.linear_decay(3e-3, n)), Ctx(), task="lm"))
    tbase, ttr, tmasks = from_jax(_np(base), _np(tr), _np(masks))
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
    want = dict(flatten_with_paths(from_jax(_np(tr), None, None)[0]))
    got = flatten_with_paths(ttr)
    assert [p for p, _ in got] == sorted(want)
    for path, t in got:
        _close(t.numpy(), want[path].numpy(), path, STEP_TOL)
    assert any(t.abs().sum() > 0 for p, t in got if p.endswith(".E"))


def test_unroll_false_reference_bridges_the_stacked_layers():
    """The reference stacks Mamba2's layers as a one-kind period
    (``dec.body.p0``, a leading axis of n_layers): bridged, the port's layer
    ``i`` holds the reference's layer ``i`` and the logits agree; the
    unrolled reference gives the same trees."""
    cfg_j = jax_get_config(ARCH, smoke=True).with_(
        n_layers=4, layer_pattern=("mamba",) * 4)
    jm = JaxModel(cfg_j, peft="bea", unroll=False)
    base, tr, masks, rng = _perturbed(jm, 5)
    assert set(base["dec"]) == {"body"}
    assert base["dec"]["body"]["p0"]["ssm"]["a_log"].shape == (4, 8)
    tbase, ttr, tmasks = from_jax(_np(base), _np(tr), _np(masks))
    assert len(tbase["dec"]["layers"]) == 4
    for i in range(4):
        want = dict(flatten_with_paths(from_jax(_np(jax.tree.map(
            lambda t: t[i], base["dec"]["body"]["p0"])), None, None)[0]))
        for path, t in flatten_with_paths(tbase["dec"]["layers"][i]):
            assert torch.equal(t, want[path]), (i, path)
    jb, tb = _batch(rng, cfg_j.vocab_size)
    want = _jax_logits(jm)(base, tr, masks, jb)
    cfg = get_config(ARCH, smoke=True).with_(n_layers=4,
                                            layer_pattern=("mamba",) * 4)
    with torch.no_grad():
        _close(Model(cfg).forward(tbase, ttr, tmasks, tb).numpy(),
               np.asarray(want), "logits", 2e-4)


@pytest.mark.parametrize("peft", ["adapter_h", "adapter_p"])
def test_bottleneck_kinds_match_reference(peft):
    """FedAdapter-H/P on Mamba2: a mamba block gets only ``post_mlp`` (no
    ``post_attn``), applied to the residual stream after the mixer's
    residual, as the reference does."""
    cfg_j = jax_get_config(ARCH, smoke=True)
    jm = JaxModel(cfg_j, peft=peft)
    base, tr = jm.init(jax.random.key(8))
    rng = np.random.default_rng(8)
    tr = jax.tree.map(lambda v: v + jnp.asarray(
        rng.normal(size=v.shape) * 0.1, v.dtype), tr)
    jb, tb = _batch(rng, cfg_j.vocab_size)
    want = _jax_logits(jm)(base, tr, None, jb)
    tbase, ttr, _ = from_jax(_np(base), _np(tr), None)
    assert set(ttr["adapters"]["dec"]["layers"][0]) == {"post_mlp"}
    model = Model(get_config(ARCH, smoke=True), peft=peft)
    with torch.no_grad():
        got = model.forward(tbase, ttr, None, tb)
    _close_logits(got.numpy(), want)


# --------------------------------------------------------------------------
# FedARA's pieces over a Mamba2 adapter tree
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ssm_trees():
    jm = JaxModel(jax_get_config(ARCH, smoke=True), peft="bea", unroll=True)
    rng = np.random.default_rng(21)

    def fill(scale):
        return jax.tree.map(
            lambda m: rng.normal(size=m.shape).astype(np.float32) * scale,
            jm.adapter_meta(), is_leaf=lambda m: hasattr(m, "init"))

    ad, gr = fill(0.2), fill(1e-2)
    glob = jax.tree.map(np.array, jm.init_masks())
    glob["dec"]["tail"]["t0"]["ssm"]["in_proj"][::2] = False
    glob["dec"]["tail"]["t1"]["ssm"]["out_proj"][:] = False
    return dict(ad=ad, gr=gr, glob=glob)


@pytest.mark.parametrize("method", ["mag", "grad", "mixed", "sensitivity"])
def test_importance_over_ssm_adapters_matches_reference(ssm_trees, method):
    t = ssm_trees
    want, _ = JIMP.score_tree(t["ad"], t["gr"], method)
    got, _ = IMP.score_tree(bridge_tree(t["ad"]), bridge_tree(t["gr"]),
                            method)
    wflat = dict(flatten_with_paths(bridge_tree(_np(want))))
    gflat = flatten_with_paths(got)
    assert len(gflat) == len(wflat) == 2 * 2
    for path, s in gflat:
        np.testing.assert_allclose(np.asarray(s), wflat[path].numpy(),
                                   rtol=1e-6, atol=0, err_msg=path)


def test_fedara_local_masks_and_comm_over_ssm_adapters(ssm_trees):
    t = ssm_trees
    s, js = FedARA(), JFedARA()
    n = 2 * 2 * 4
    for rnd in (0, 6, 40):
        want = js.local_masks(rnd, t["ad"], t["gr"], n)
        got = s.local_masks(rnd, bridge_tree(t["ad"]), bridge_tree(t["gr"]),
                            n)
        wflat = dict(flatten_with_paths(bridge_tree(_np(want))))
        for path, m in flatten_with_paths(got):
            assert np.array_equal(np.asarray(m, bool), wflat[path].numpy()), \
                (rnd, path)
    tad = bridge_tree(t["ad"])
    for masks in (None, t["glob"]):
        tm = None if masks is None else tree_map(
            lambda m: np.asarray(m, bool), bridge_tree(masks))
        assert COMM.count_params(tad, tm) == JCOMM.count_params(t["ad"],
                                                                masks)
        assert COMM.bytes_down(tad, tm) == JCOMM.bytes_down(t["ad"], masks)
        assert np.array_equal(COMM.pack(tad, tm), JCOMM.pack(t["ad"], masks))


# --------------------------------------------------------------------------
# the entry points
# --------------------------------------------------------------------------

def test_mamba2_serving_and_cohort_refuse_with_roadmap_pointer():
    """SSM serving (the state cache, prefill's final state, the decode
    recurrence) is ROADMAP.md queue 1 item 13's; the cohort's
    client-batched forward over a mamba block, which no reference runner
    reaches, refuses too."""
    cfg = get_config(ARCH, smoke=True)
    model = Model(cfg, use_kernels=False)
    base, tr = model.init(0, "cpu")
    toks = torch.zeros(1, 4, dtype=torch.long)
    for call in (lambda: model.cache_meta(1, 8),
                 lambda: model.prefill(base, tr, None, toks),
                 lambda: TBK.block_cache_meta(cfg, "mamba", 1, 8)):
        with pytest.raises(NotImplementedError, match="queue 1 item 13"):
            call()
    from repro_torch.launch import serve
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        serve.build_engine(cfg, n_slots=1, max_seq=8, device="cpu")
    ctr = tree_map(lambda t: t[None], tr)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        model.lm_loss(base, ctr, None, {"tokens": toks[None],
                                        "targets": toks[None]}, clients=True)


def test_mamba2_train_cli_runs_on_cpu(capsys):
    out = TTR.main(["--arch", ARCH, "--device", "cpu", "--steps", "3",
                    "--seq", "32"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[1] for ln in lines[:-1]] == ["0", "1", "2"]
    assert lines[-1].startswith("done: 3 steps")
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert set(out["base"]["dec"]["layers"][0]) == {"ln1", "ssm"}
