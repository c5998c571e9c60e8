"""Port parity for causal-LM training: Qwen2 SMOKE (f32) LM logits,
``lm_loss`` with ignored (−1) targets and every adapter gradient against
``Model.lm_loss`` under ``jax.value_and_grad``, and one layer's RoPE'd,
causal GQA attention in train mode, through the kernel wrappers (their
plain versions on the CPU) and through the plain form.  Weights come from
the JAX package's scanned (``unroll=False``) model through the bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import attention as JATT
from repro_torch.bridge import from_jax
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import attention as TATT
from repro_torch.pytree import flatten_with_paths, tree_map

TOL = 1e-5          # rtol = atol, tests/test_torch_model.py:137
B, S = 2, 32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=TOL,
                               atol=TOL, err_msg=what)


@pytest.fixture(scope="module")
def lm_case():
    cfg_j = jax_get_config("qwen2_0p5b", smoke=True)
    jm = JaxModel(cfg_j, peft="bea")
    base, tr = jm.init(jax.random.key(4))
    rng = np.random.default_rng(4)
    # E off its zero init and pruned ranks, so adapters and masks matter
    tr = jax.tree_util.tree_map_with_path(
        lambda p, v: v + jnp.asarray(rng.normal(size=v.shape) * 0.3, v.dtype)
        if str(p[-1].key) == "E" else v, tr)
    masks = jax.tree.map(lambda m: m.at[..., 1].set(False), jm.init_masks())
    toks = rng.integers(0, cfg_j.vocab_size, (B, S)).astype(np.int32)
    targets = rng.integers(0, cfg_j.vocab_size, (B, S)).astype(np.int32)
    targets[0, :5] = -1
    targets[1, -3:] = -1
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(targets)}
    logits = jm.forward(base, tr, masks, jb, remat=False)[0]
    (total, (loss, aux)), grads = jax.value_and_grad(
        lambda t: jm.lm_loss(base, t, masks, jb, remat=False),
        has_aux=True)(tr)
    tb = {"tokens": torch.from_numpy(toks).long(),
          "targets": torch.from_numpy(targets).long()}
    return dict(cfg=get_config("qwen2_0p5b", smoke=True),
                trees=from_jax(_np(base), _np(tr), _np(masks)),
                grads=from_jax(_np(grads), None, None)[0], batch=tb,
                logits=np.asarray(logits), total=float(total),
                loss=float(loss), aux=float(aux), cfg_j=cfg_j,
                jax_trees=(base, tr, masks))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_lm_logits_match_jax(lm_case, use_kernels):
    base, tr, masks = lm_case["trees"]
    model = Model(lm_case["cfg"], peft="bea", use_kernels=use_kernels)
    with torch.no_grad():
        logits = model.forward(base, tr, masks, lm_case["batch"])
    assert logits.shape == (B, S, lm_case["cfg"].vocab_size)
    assert logits.dtype == torch.float32
    _close(logits.numpy(), lm_case["logits"], "logits")


@pytest.mark.parametrize("use_kernels", [False, True])
def test_lm_loss_and_adapter_grads_match_jax(lm_case, use_kernels):
    base, tr, masks = lm_case["trees"]
    model = Model(lm_case["cfg"], peft="bea", use_kernels=use_kernels)
    flat = []

    def leaf(t):
        flat.append(t.clone().requires_grad_(True))
        return flat[-1]

    req = tree_map(leaf, tr)
    total, (loss, aux) = model.lm_loss(base, req, masks, lm_case["batch"])
    _close(total.item(), lm_case["total"], "total")
    _close(loss.item(), lm_case["loss"], "loss")
    assert aux.item() == lm_case["aux"] == 0.0
    got = torch.autograd.grad(total, flat)
    it = iter(got)
    got = tree_map(lambda _: next(it), req)
    want = dict(flatten_with_paths(lm_case["grads"]))
    paths = flatten_with_paths(got)
    assert [p for p, _ in paths] == sorted(want)
    assert len(paths) == 3 * 7 * lm_case["cfg"].n_layers
    for path, g in paths:
        _close(g.numpy(), want[path].numpy(), path)
    # a masked rank takes no gradient
    assert not got["adapters"]["dec"]["layers"][0]["attn"]["wq"]["E"][1]


def test_lm_loss_ignores_negative_targets(lm_case):
    """Targets < 0 drop out of the mean: a row whose targets are all −1
    changes nothing, and the loss is the mean over the valid positions."""
    base, tr, masks = lm_case["trees"]
    model = Model(lm_case["cfg"], peft="bea", use_kernels=False)
    toks, targets = lm_case["batch"]["tokens"], lm_case["batch"]["targets"]
    with torch.no_grad():
        one, _ = model.lm_loss(base, tr, masks, {"tokens": toks[:1],
                                                 "targets": targets[:1]})
        both, _ = model.lm_loss(
            base, tr, masks, {"tokens": toks,
                              "targets": torch.cat([targets[:1],
                                                    -torch.ones_like(
                                                        targets[1:])])})
        logits = model.forward(base, tr, masks, {"tokens": toks[:1]})
        logp = torch.log_softmax(logits, -1)[0]
        valid = targets[0] >= 0
        mean = -logp[valid].gather(-1, targets[0][valid][:, None]).mean()
    torch.testing.assert_close(both, one, rtol=1e-6, atol=0)
    torch.testing.assert_close(one, mean, rtol=1e-6, atol=0)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_rope_train_mode_causal_gqa_attention_matches_jax(lm_case,
                                                          use_kernel):
    """One layer's attention in train mode: RoPE at positions 0..S-1 and
    the causal GQA core (4 query heads over 2 kv heads), with adapters."""
    cfg_j = lm_case["cfg_j"]
    jbase, jtr, jmasks = lm_case["jax_trees"]
    base, tr, masks = lm_case["trees"]
    assert cfg_j.pos_emb == "rope" and cfg_j.n_heads > cfg_j.n_kv_heads
    x = np.random.default_rng(9).normal(
        size=(B, S, cfg_j.d_model)).astype(np.float32)
    p_j = jax.tree.map(lambda t: t[0], jbase["dec"]["body"]["p0"]["attn"])
    ad_j = jax.tree.map(lambda t: t[0], jtr["adapters"]["dec"]["body"]["p0"]
                        ["attn"])
    m_j = jax.tree.map(lambda t: t[0], jmasks["dec"]["body"]["p0"]["attn"])
    want, _ = JATT.attention(p_j, jnp.asarray(x), cfg_j, mode="train",
                             ad=ad_j, masks=m_j, causal=True)
    layer = 0
    got, cache = TATT.attention(
        base["dec"]["layers"][layer]["attn"], torch.from_numpy(x),
        lm_case["cfg"], mode="train",
        ad=tr["adapters"]["dec"]["layers"][layer]["attn"],
        masks=masks["dec"]["layers"][layer]["attn"], use_kernel=use_kernel,
        causal=True)
    assert cache is None
    _close(got.numpy(), np.asarray(want), "attention")
    # causal: the first half of the sequence ignores the second half
    x2 = x.copy()
    x2[:, S // 2:] += 1.0
    got2, _ = TATT.attention(
        base["dec"]["layers"][layer]["attn"], torch.from_numpy(x2),
        lm_case["cfg"], mode="train",
        ad=tr["adapters"]["dec"]["layers"][layer]["attn"],
        masks=masks["dec"]["layers"][layer]["attn"], use_kernel=use_kernel,
        causal=True)
    torch.testing.assert_close(got2[:, :S // 2], got[:, :S // 2])


# --------------------------------------------------------------------------
# the federated lm task
# --------------------------------------------------------------------------

def test_evaluate_lm_returns_mean_nll():
    """``evaluate(task="lm")`` (the port of ``tests/test_fedsim.py::
    test_evaluate_lm_returns_mean_nll``): a mean next-token NLL of each
    eval batch's token stream, above 0.9·log V on a random base and equal
    to the reference's on bridged weights."""
    from repro.configs.distilbert import MINI as JMINI
    from repro.data.synthetic import make_classification as jax_data
    from repro.federated.server import FedConfig as JFC
    from repro.federated.server import evaluate as jax_evaluate
    from repro_torch.configs.distilbert import MINI
    from repro_torch.data.synthetic import make_classification
    from repro_torch.federated.server import FedConfig, evaluate

    cfg_j = JMINI.with_(n_layers=2, layer_pattern=("attn",) * 2, n_classes=0)
    cfg = MINI.with_(n_layers=2, layer_pattern=("attn",) * 2, n_classes=0)
    jm = JaxModel(cfg_j, peft="bea", unroll=True)
    base, tr = jm.init(jax.random.key(0))
    test = make_classification(200, 20, cfg.vocab_size, 32, seed=2)
    want = jax_evaluate(jm, base, tr, None,
                        jax_data(200, 20, cfg.vocab_size, 32, seed=2),
                        JFC(task="lm", batch_size=8, eval_batches=2))
    tbase, ttr, _ = from_jax(_np(base), _np(tr), None)
    fc = FedConfig(task="lm", batch_size=8, eval_batches=2)
    for use_kernels in (False, True):
        nll = evaluate(Model(cfg, peft="bea", use_kernels=use_kernels),
                       tbase, ttr, None, test, fc, "cpu")
        assert np.isfinite(nll) and nll > 0.9 * np.log(cfg.vocab_size)
        _close(nll, want, "mean nll")


def test_lm_train_step_over_clients_is_each_clients_step(lm_case):
    """The cohort's form of the lm task: ``make_train_step(..., "lm",
    clients=True)`` over two stacked clients gives each client the loss
    and the updated adapters of its own single-client step."""
    from repro_torch.federated import client as CL
    from repro_torch.optim import adam, linear_decay

    base, tr, masks = lm_case["trees"]
    model = Model(lm_case["cfg"], peft="bea", use_kernels=False)
    opt = adam(linear_decay(3e-3, 4))
    batch = lm_case["batch"]
    two = tree_map(lambda t: torch.stack([t, t * 0.5]), tr)
    cb = {k: torch.stack([v, v.flip(0)]) for k, v in batch.items()}
    pc, _, _, _, loss_c, aux_c = CL.make_train_step(
        model, opt, "lm", clients=True)(base, two, opt.init(two,
                                                             clients=True),
                                        masks, None, cb)
    assert loss_c.shape == aux_c.shape == (2,)
    step = CL.make_train_step(model, opt, "lm")
    for c in range(2):
        tr_c = tree_map(lambda t: t[c], two)
        p1, _, _, _, loss1, _ = step(base, tr_c, opt.init(tr_c), masks, None,
                                     {k: v[c] for k, v in cb.items()})
        torch.testing.assert_close(loss_c[c], loss1, rtol=1e-5, atol=1e-5)
        for (path, a), (_, b) in zip(flatten_with_paths(p1),
                                     flatten_with_paths(
                                         tree_map(lambda t: t[c], pc))):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5,
                                       msg=path)
