"""Port parity for InternVL2-1B (CPU, float32, SMOKE widths: d_model 128, 2
layers, 4 q over 2 kv heads of 32, 8 patch embeddings in front of 24
tokens): the config, the metas, the whole model's logits with a random
prefix (the prefix rows dropped before the head), ``lm_loss`` and every
adapter gradient, five train steps with a zero and a random prefix,
prefill and three decode steps against the reference's ``Model.prefill`` /
``decode_step`` with a cache of P + S + G rows, the CLIs and the cohort's
refusal.  Weights cross by ``bridge.from_jax``."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JOPT
from repro.configs import get_config as jax_get_config
from repro.data import synthetic as JS
from repro.launch import steps as JST
from repro.models import Ctx
from repro.models import Model as JaxModel
from repro.pytree import materialize as jax_materialize
from repro.pytree import tree_bytes as jax_tree_bytes
from repro_torch import optim as TOPT
from repro_torch.bridge import from_jax, relayout
from repro_torch.configs import get_config
from repro_torch.launch import serve as TSV
from repro_torch.launch import steps as TST
from repro_torch.launch import train as TTR
from repro_torch.models import Model
from repro_torch.pytree import flatten_with_paths, tree_bytes, tree_map

TOL = 1e-5              # loss, grads (rtol = atol), tests/test_torch_lm.py
LOGIT_SHARE_TOL = 2e-6  # logits: atol as a share of max|logit|, as Gemma's
STEP_TOL = 1e-4         # five Adam steps, tests/test_torch_launch_train.py
ARCH = "internvl2_1b"
B, S = 2, 24
P = 8                   # SMOKE's n_prefix_embeds


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


def _perturbed(jm, seed):
    """The reference's init with E off zero and rank 1 of every module
    pruned, so adapters and masks both matter."""
    base, tr = jm.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    tr = jax.tree_util.tree_map_with_path(
        lambda p, v: v + jnp.asarray(rng.normal(size=v.shape) * 0.3, v.dtype)
        if str(p[-1].key) == "E" else v, tr)
    masks = jax.tree.map(lambda m: m.at[..., 1].set(False), jm.init_masks())
    return base, tr, masks, rng


def _batch(rng, vocab, d, b=B, s=S, prefix="random"):
    """Tokens, targets and ``prefix_embeds`` (B, P, d): normal × 0.1 as
    ``tests/test_archs_smoke.py`` draws them, or zeros as ``train.py``
    feeds them."""
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    targets = rng.integers(0, vocab, (b, s)).astype(np.int32)
    targets[0, :5] = -1
    pe = (rng.normal(size=(b, P, d)) * 0.1 if prefix == "random"
          else np.zeros((b, P, d))).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "targets": jnp.asarray(targets),
             "prefix_embeds": jnp.asarray(pe)},
            {"tokens": torch.from_numpy(toks).long(),
             "targets": torch.from_numpy(targets).long(),
             "prefix_embeds": torch.from_numpy(pe)})


def _jax_logits(jm):
    """The reference's forward jitted with the weights as arguments, as its
    train step runs it."""
    return jax.jit(lambda b, t, m, x: jm.forward(b, t, m, x, remat=False)[0])


# --------------------------------------------------------------------------
# the config and the metas
# --------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(smoke):
    ref = jax_get_config(ARCH, smoke=smoke)
    got = get_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(ref):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name
    assert get_config("internvl2-1b", smoke=smoke) == got
    assert got.modality == "vision" and not got.qkv_bias
    assert got.n_prefix_embeds == (P if smoke else 256)
    assert got.pdtype == (torch.float32 if smoke else torch.bfloat16)


def _is_meta(m):
    return hasattr(m, "init")


def _abstract(tree):
    """A reference meta tree as numpy views of one zero each (nothing is
    allocated at the meta's size), for the bridge's layout alone."""
    return jax.tree.map(lambda m: np.broadcast_to(
        np.zeros((), np.dtype(m.dtype)), m.shape), tree, is_leaf=_is_meta)


def _shapes(tree, port: bool):
    return {p: (tuple(m.shape), str(m.dtype).split(".")[-1]) for p, m in
            flatten_with_paths(tree, is_leaf=_is_meta if port else None)}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("peft", ["bea", "lora", "adapter_h"])
def test_metas_match_reference(smoke, peft):
    """Base, trainable and (BEA, LoRA) mask metas: the reference's bridged
    abstractly give the port's leaves, shapes and dtypes, and the byte
    totals agree — no QKV bias, tied embeddings, no head."""
    cfg_j, cfg = jax_get_config(ARCH, smoke=smoke), get_config(ARCH,
                                                                smoke=smoke)
    tm, jm = Model(cfg, peft=peft), JaxModel(cfg_j, peft=peft)
    assert tree_bytes(tm.base_meta()) == jax_tree_bytes(jm.base_meta())
    assert tree_bytes(tm.trainable_meta()) == \
        jax_tree_bytes(jm.trainable_meta())
    pairs = [(tm.base_meta(), jm.base_meta()),
             (tm.trainable_meta(), jm.trainable_meta())]
    if peft != "adapter_h":
        pairs.append((tm.mask_meta(), jm.mask_meta()))
    for port, ref in pairs:
        assert _shapes(relayout(_abstract(ref), cfg.layer_pattern),
                       False) == _shapes(port, True)
    base = tm.base_meta()
    assert "head" not in base and "b" not in base["dec"]["layers"][0][
        "attn"]["wq"]
    assert len(base["dec"]["layers"]) == cfg.n_layers


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def case():
    cfg_j = jax_get_config(ARCH, smoke=True)
    jm = JaxModel(cfg_j, peft="bea")
    base, tr, masks, rng = _perturbed(jm, 4)
    jb, tb = _batch(rng, cfg_j.vocab_size, cfg_j.d_model)
    logits = _jax_logits(jm)(base, tr, masks, jb)
    (total, (loss, aux)), grads = jax.jit(jax.value_and_grad(
        lambda t, b, m, x: jm.lm_loss(b, t, m, x, remat=False),
        has_aux=True))(tr, base, masks, jb)
    return dict(cfg=get_config(ARCH, smoke=True), cfg_j=cfg_j, jm=jm,
                jax_trees=(base, tr, masks),
                trees=from_jax(_np(base), _np(tr), _np(masks)),
                grads=from_jax(_np(grads), None, None)[0], batch=tb,
                logits=np.asarray(logits), total=float(total),
                loss=float(loss))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_internvl2_logits_match_jax(case, use_kernels):
    """Logits cover the S tokens only: the P prefix rows run through the
    decoder and are sliced off after the final norm."""
    base, tr, masks = case["trees"]
    cfg = case["cfg"]
    model = Model(cfg, peft="bea", use_kernels=use_kernels)
    with torch.no_grad():
        logits = model.forward(base, tr, masks, case["batch"])
    assert logits.shape == (B, S, cfg.vocab_size)
    assert logits.dtype == torch.float32
    _close_logits(logits.numpy(), case["logits"], "logits")


@functools.cache
def _reference():
    cfg_j = jax_get_config(ARCH, smoke=True)
    jm = JaxModel(cfg_j, peft="bea")
    return cfg_j, jm, _jax_logits(jm)


@pytest.mark.parametrize("seed", range(10))
def test_internvl2_logits_match_jax_over_seeds(seed):
    cfg_j, jm, fwd = _reference()
    base, tr, masks, rng = _perturbed(jm, seed)
    jb, tb = _batch(rng, cfg_j.vocab_size, cfg_j.d_model)
    want = np.asarray(fwd(base, tr, masks, jb), np.float64)
    trees = from_jax(_np(base), _np(tr), _np(masks))
    for use_kernels in (False, True):
        model = Model(get_config(ARCH, smoke=True), peft="bea",
                      use_kernels=use_kernels)
        with torch.no_grad():
            got = model.forward(*trees, tb).numpy()
        np.testing.assert_allclose(
            got, want, rtol=0, atol=LOGIT_SHARE_TOL * np.abs(want).max(),
            err_msg=f"use_kernels={use_kernels}")


def test_the_prefix_moves_the_logits(case):
    """The prefix is not ignored: other patch embeddings give other
    logits (and the reference agrees on those too)."""
    base, tr, masks = case["trees"]
    model = Model(case["cfg"], use_kernels=False)
    other = {**case["batch"],
             "prefix_embeds": case["batch"]["prefix_embeds"] * -1.0}
    with torch.no_grad():
        a = model.forward(base, tr, masks, case["batch"])
        b = model.forward(base, tr, masks, other)
    assert (a - b).abs().max().item() > 1e-3
    jb = {k: jnp.asarray(v.numpy()) for k, v in other.items()}
    want = _jax_logits(case["jm"])(*case["jax_trees"], jb)
    _close_logits(b.numpy(), want)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_internvl2_lm_loss_and_adapter_grads_match_jax(case, use_kernels):
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
    assert len(paths) == 3 * 7 * case["cfg"].n_layers
    for path, g in paths:
        _close(g.numpy(), want[path].numpy(), path)
    assert not got["adapters"]["dec"]["layers"][0]["attn"]["wq"]["E"][1]


@pytest.mark.parametrize("prefix", ["zeros", "random"])
def test_internvl2_five_train_steps_match_reference(case, prefix):
    """Five steps of ``launch/steps.py``'s train step against the
    reference's jitted ones, with ``train.py``'s zero prefix and with a
    random one."""
    cfg_j = case["cfg_j"]
    jm = case["jm"]
    base, tr = jm.init(jax.random.key(6))
    masks = jax.tree.map(lambda m: m.at[..., 0].set(False), jm.init_masks())
    n, b = 5, 2
    data = JS.make_lm_stream(n * b, cfg_j.vocab_size, S, seed=2)
    rng = np.random.default_rng(7)
    jstep = jax.jit(JST.make_train_step(
        jm, JOPT.adam(JOPT.linear_decay(3e-3, n)), Ctx(), task="lm"))
    tbase, ttr, tmasks = from_jax(_np(base), _np(tr), _np(masks))
    topt = TOPT.adam(TOPT.linear_decay(3e-3, n))
    tstep = TST.make_train_step(Model(case["cfg"]), topt, task="lm")
    js, ts = JOPT.adam(JOPT.linear_decay(3e-3, n)).init(tr), topt.init(ttr)
    for i in range(n):
        sl = slice(i * b, (i + 1) * b)
        pe = (rng.normal(size=(b, P, cfg_j.d_model)) * 0.1
              if prefix == "random" else np.zeros((b, P, cfg_j.d_model)))
        jb = {"tokens": jnp.asarray(data["tokens"][sl]),
              "targets": jnp.asarray(data["targets"][sl]),
              "prefix_embeds": jnp.asarray(pe, jnp.float32)}
        tb = {k: torch.as_tensor(np.array(v)) for k, v in jb.items()}
        tb["tokens"], tb["targets"] = tb["tokens"].long(), \
            tb["targets"].long()
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


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [False, True])
def test_internvl2_prefill_and_decode_match_reference(case, use_kernels):
    """Prefill (P patch rows + S tokens) and three greedy decode steps
    against the reference's ``Model.prefill`` / ``decode_step`` with a
    cache of P + S + G rows (the reference's CLI sizes it S + G and
    crashes: ROADMAP.md queue 4 quirk 12).  Logits per step, the greedy
    tokens equal, and decode goes on from position P + S."""
    jm = case["jm"]
    base, tr, masks = case["jax_trees"]
    cfg_j = case["cfg_j"]
    rng = np.random.default_rng(11)
    b, s, g = 2, 7, 3
    prompt = rng.integers(0, cfg_j.vocab_size, (b, s)).astype(np.int32)
    pe = (rng.normal(size=(b, P, cfg_j.d_model)) * 0.1).astype(np.float32)
    t_max = P + s + g
    cache = jax_materialize(jm.cache_meta(b, t_max), jax.random.key(1))
    want, cache = jm.prefill(base, tr, masks,
                             {"tokens": jnp.asarray(prompt),
                              "prefix_embeds": jnp.asarray(pe)}, cache)
    tm = Model(case["cfg"], use_kernels=use_kernels)
    tb, ttr, tmask = case["trees"]
    tcache = tm.init_cache(b, t_max, "cpu")
    with torch.no_grad():
        got, tcache = tm.prefill(tb, ttr, tmask,
                                 {"tokens": torch.from_numpy(prompt).long(),
                                  "prefix_embeds": torch.from_numpy(pe)},
                                 tcache)
    assert tcache["pos"].tolist() == [P + s] * b
    _close_logits(got.numpy(), want, "prefill")
    for i in range(g):
        tok = np.array(jnp.argmax(want, -1))
        assert tok.tolist() == got.argmax(-1).tolist(), f"step {i}"
        want, cache = jm.decode_step(base, tr, masks,
                                     jnp.asarray(tok[:, None], jnp.int32),
                                     cache)
        with torch.no_grad():
            got, tcache = tm.decode_step(
                tb, ttr, tmask, torch.from_numpy(tok[:, None]).long(),
                tcache)
        _close_logits(got.numpy(), want, f"decode {i}")
    assert tcache["pos"].tolist() == [P + s + g] * b


def test_internvl2_cohort_with_a_prefix_refuses(case):
    """No reference runner trains a vision model federated: the cohort's
    client-batched forward with a prefix refuses with a pointer."""
    base, tr, masks = case["trees"]
    ctr = tree_map(lambda t: t[None], tr)
    batch = {k: v[None] for k, v in case["batch"].items()}
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Model(case["cfg"], use_kernels=False).lm_loss(
            base, ctr, masks, batch, clients=True)


def test_an_audio_model_refuses_with_a_pointer():
    cfg = get_config("bart", smoke=True).with_(modality="audio")
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        Model(cfg)


def test_internvl2_train_cli_runs_on_cpu(capsys):
    out = TTR.main(["--arch", ARCH, "--device", "cpu", "--steps", "3",
                    "--seq", "16"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[1] for ln in lines[:-1]] == ["0", "1", "2"]
    assert lines[-1].startswith("done: 3 steps")
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))


def test_internvl2_serve_cli_runs_on_cpu(capsys):
    """``serve.py --arch internvl2_1b`` takes the static-batch loop: P + 8
    prompt rows prefilled, 4 tokens a request."""
    TSV.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
              "--prompt-len", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert "[legacy static batch] device=cpu" in out and f"prefix={P}" in out
    toks = eval(out.strip().splitlines()[-1].split(":", 1)[1])
    assert len(toks) == 4
