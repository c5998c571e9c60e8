"""Port parity for the training slice's model side: the DistilBERT configs,
LayerNorm / learned positions / GELU, the differentiable kernel wrappers
(``BeaDense``, ``FlashAttention``) against ``jax.grad`` of the jnp forms,
SMOKE/MINI classifier logits, loss and every trainable grad against
``Model.cls_loss`` under ``jax.value_and_grad``, and Adam with the linear
decay over five steps (CPU, float32, numpy inputs from a seed)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import optim as JOPT
from repro.configs import distilbert as JD
from repro.core.adapters import apply_adapter as jax_apply_adapter
from repro.models import Model as JaxModel
from repro.models import attention as JATT
from repro.models import layers as JL
from repro_torch import optim as TOPT
from repro_torch.bridge import from_jax
from repro_torch.configs import distilbert as TD
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.kernels.bea_fused import BeaDense
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.models import Model
from repro_torch.models import layers as TL
from repro_torch.pytree import flatten_with_paths, tree_map

GRAD_TOL = 1e-5     # one function's grads, f32, summation order only
MODEL_TOL = 2e-4    # whole-model tier (tests/test_torch_model.py)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} × {scale}"


# --------------------------------------------------------------------------
# configs and layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["CONFIG", "MINI", "SMOKE"])
def test_distilbert_configs_match_reference(name):
    want, got = getattr(JD, name), getattr(TD, name)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.pdtype == got.cdtype == torch.float32
    assert get_config("distilbert") == TD.CONFIG
    assert get_config("distilbert", smoke=True) == TD.SMOKE


def test_layernorm_positions_gelu_match_reference():
    cfg_j, cfg_t = JD.MINI, TD.MINI
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 17, cfg_j.d_model)).astype(np.float32) * 3 + 0.5
    p = {"scale": rng.normal(size=cfg_j.d_model).astype(np.float32),
         "bias": rng.normal(size=cfg_j.d_model).astype(np.float32)}
    want = JL.norm_apply(p, jnp.asarray(x), cfg_j)
    got = TL.norm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert set(TL.norm_meta(cfg_t)) == set(JL.norm_meta(cfg_j)) \
        == {"scale", "bias"}

    emb = {"tok": rng.normal(size=(cfg_j.vocab_size, cfg_j.d_model))
           .astype(np.float32),
           "pos": rng.normal(size=(cfg_j.max_position, cfg_j.d_model))
           .astype(np.float32)}
    toks = rng.integers(0, cfg_j.vocab_size, (2, 29)).astype(np.int32)
    want = JL.embed_apply(emb, jnp.asarray(toks), cfg_j)
    got = TL.embed_apply({k: torch.from_numpy(v) for k, v in emb.items()},
                         torch.from_numpy(toks).long(), cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    jm, tm = JL.embed_meta(cfg_j), TL.embed_meta(cfg_t)
    assert tm["pos"].shape == jm["pos"].shape
    assert (tm["pos"].init, tm["pos"].scale) == (jm["pos"].init,
                                                 jm["pos"].scale)

    h = rng.normal(size=(5, 64)).astype(np.float32) * 4
    np.testing.assert_allclose(
        F.gelu(torch.from_numpy(h), approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(h))), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# the differentiable kernel wrappers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,r", [(32, 48, 40, 12), (17, 128, 256, 12),
                                     (9, 64, 16, 4)])
def test_bea_dense_function_grads_match_jax_grad(m, k, n, r):
    """dX, dA, dB, dE of ``BeaDense`` with one masked rank: against
    ``jax.grad`` of ``apply_adapter`` at 1e-5, and against the autograd of
    the plain form bit for bit."""
    rng = np.random.default_rng(m + k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    a = (rng.normal(size=(r, k)) / np.sqrt(k)).astype(np.float32)
    b = rng.normal(size=(n, r)).astype(np.float32)
    e = rng.normal(size=r).astype(np.float32)
    mask = np.ones(r, bool)
    mask[1] = False
    g = rng.normal(size=(m, n)).astype(np.float32)
    s = 16.0 / r

    def f(x_, a_, b_, e_):
        y = jax_apply_adapter(x_ @ jnp.asarray(w), x_,
                              {"A": a_, "B": b_, "E": e_}, jnp.asarray(mask),
                              s)
        return (y * jnp.asarray(g)).sum()

    want = jax.grad(f, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, a, b, e)))

    def leaves():
        return [torch.from_numpy(t).requires_grad_(True) for t in (x, a, b, e)]

    lv = leaves()
    y = BeaDense.apply(lv[0], torch.from_numpy(w), lv[1], lv[2], lv[3],
                       torch.from_numpy(mask), s)
    got = torch.autograd.grad(y, lv, torch.from_numpy(g))
    for name, gt, wt in zip("XABE", got, want):
        _close(gt.numpy(), wt, GRAD_TOL, f"d{name}")
    assert float(got[3][1]) == 0.0            # a masked rank gets no dE
    assert not got[1][1].any() and not got[2][:, 1].any()

    lv2 = leaves()
    y2 = ref.bea_dense_ref(lv2[0], torch.from_numpy(w), lv2[1], lv2[2],
                           lv2[3], torch.from_numpy(mask), s)
    plain = torch.autograd.grad(y2, lv2, torch.from_numpy(g))
    assert torch.equal(y, y2)
    for name, gt, pt in zip("XABE", got, plain):
        assert torch.equal(gt, pt), f"d{name} differs from plain autograd"


@pytest.mark.parametrize("b,s,h,kv,hd,causal", [
    (2, 32, 4, 4, 32, False), (1, 100, 12, 12, 64, False),
    (2, 24, 4, 2, 16, True)])
def test_flash_function_grads_match_jax_grad(b, s, h, kv, hd, causal):
    """dQ, dK, dV of ``FlashAttention`` against ``jax.grad`` of
    ``models/attention.py:_direct`` (non-causal as the encoder runs it)."""
    rng = np.random.default_rng(s)
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    g = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    pos = np.arange(s)
    m = (pos[None, :] <= pos[:, None]) if causal else np.ones((s, s), bool)

    def f(q_, k_, v_):
        o = JATT._direct(q_.reshape(b, s, kv, h // kv, hd), k_, v_,
                         jnp.asarray(m)[None, None, None], hd ** -0.5, 0.0)
        return (o.reshape(b, s, h, hd) * jnp.asarray(g)).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    lv = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    o = FlashAttention.apply(*lv, causal)
    got = torch.autograd.grad(o, lv, torch.from_numpy(g))
    for name, gt, wt in zip("QKV", got, want):
        _close(gt.numpy(), wt, GRAD_TOL, f"d{name}")


# --------------------------------------------------------------------------
# the classifier: logits, loss and every trainable grad
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["SMOKE", "MINI"])
def cls_case(request):
    cfg_j = getattr(JD, request.param)
    jm = JaxModel(cfg_j, peft="bea", unroll=True)
    base, tr = jm.init(jax.random.key(3))
    rng = np.random.default_rng(1)
    # E off its zero init and one dead module, so adapters and masks matter
    tr = jax.tree_util.tree_map_with_path(
        lambda p, x: x + jnp.asarray(rng.normal(size=x.shape) * 0.3,
                                     x.dtype)
        if getattr(p[-1], "key", None) == "E" else x, tr)
    masks = jm.init_masks()
    masks["dec"]["tail"]["t0"]["attn"]["wk"] = jnp.zeros(
        cfg_j.adapter_rank, bool)
    masks["dec"]["tail"]["t1"]["mlp"]["w2"] = jnp.asarray(
        np.arange(cfg_j.adapter_rank) % 2 == 0)
    toks = rng.integers(0, cfg_j.vocab_size, (3, 32)).astype(np.int32)
    labels = rng.integers(0, cfg_j.n_classes, 3).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    logits = jm.forward(base, tr, masks, jb, remat=False)[0]
    (total, (loss, acc)), grads = jax.value_and_grad(
        lambda t: jm.cls_loss(base, t, masks, jb, remat=False),
        has_aux=True)(tr)
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}
    return dict(cfg=getattr(TD, request.param),
                trees=from_jax(_np(base), _np(tr), _np(masks)),
                grads=from_jax(_np(grads), None, None)[0], batch=tb,
                logits=np.asarray(logits), loss=float(loss), acc=float(acc))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_cls_forward_loss_and_grads_match_jax(cls_case, use_kernels):
    base, tr, masks = cls_case["trees"]
    model = Model(cls_case["cfg"], peft="bea", use_kernels=use_kernels)
    flat = []

    def leaf(t):
        flat.append(t.clone().requires_grad_(True))
        return flat[-1]

    req = tree_map(leaf, tr)
    logits = model.forward(base, req, masks, cls_case["batch"])
    _close(logits.detach().numpy(), cls_case["logits"], MODEL_TOL, "logits")
    total, (loss, acc) = model.cls_loss(base, req, masks, cls_case["batch"])
    assert abs(loss.item() - cls_case["loss"]) <= MODEL_TOL * cls_case["loss"]
    assert acc.item() == cls_case["acc"]
    got = torch.autograd.grad(total, flat)
    it = iter(got)
    got = tree_map(lambda _: next(it), req)
    want = dict(flatten_with_paths(cls_case["grads"]))
    paths = flatten_with_paths(got)
    assert [p for p, _ in paths] == sorted(want)
    assert any("head" in p for p, _ in paths)
    for path, g in paths:
        _close(g.numpy(), want[path].numpy(), MODEL_TOL, path)


def test_head_meta_matches_reference():
    jm = JaxModel(JD.MINI, peft="bea", unroll=True)
    tm = Model(TD.MINI, peft="bea")
    jh, th = jm.trainable_meta()["head"], tm.trainable_meta()["head"]
    for k in ("w", "b"):
        assert (th[k].shape, th[k].init) == (jh[k].shape, jh[k].init)


# --------------------------------------------------------------------------
# Adam + linear decay
# --------------------------------------------------------------------------

def test_adam_linear_decay_match_reference_over_five_steps():
    rng = np.random.default_rng(7)
    shapes = {"a": (4, 6), "b": (5,), "c": (3, 2)}
    p_np = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    gs = [{k: rng.normal(size=s).astype(np.float32) * 10 ** (i - 2)
           for k, s in shapes.items()} for i in range(5)]
    jopt = JOPT.adam(JOPT.linear_decay(3e-3, 8))
    topt = TOPT.adam(TOPT.linear_decay(3e-3, 8))
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step, g in enumerate(gs, 1):
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tp = {k: tp[k] + tu[k] for k in tp}
        assert ts["step"] == int(js["step"]) == step
        for k in shapes:
            _close(tu[k].numpy(), np.asarray(ju[k]), 1e-6, f"update {k}")
            _close(tp[k].numpy(), np.asarray(jp[k]), 1e-6, f"param {k}")
            _close(ts["nu"][k].numpy(), np.asarray(js["nu"][k]), 1e-6, k)
    for s in range(0, 10):
        assert float(TOPT.linear_decay(3e-3, 8)(s)) \
            == float(JOPT.linear_decay(3e-3, 8)(jnp.int32(s)))
