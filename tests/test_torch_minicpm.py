"""Port parity for MiniCPM-2B LM fine-tuning (CPU, float32, SMOKE widths:
4 query heads over 4 kv heads of **36**, d_model 144, d_ff 288, 48
tokens): the configs, logits, ``lm_loss`` and every adapter gradient
against ``jax.grad`` of the reference with the kernels on and off, five
steps under the WSD schedule, the flash wrappers at f32 head dim 36
against the reference's Pallas kernel in interpret mode and their
gradients against the reference's jnp attention, the flash plan at head
dim 36, prefill and decode, and the ``train.py`` CLI.  Weights cross by
``bridge.from_jax``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JOPT
from repro.configs import get_config as jax_get_config
from repro.data import synthetic as JS
from repro.kernels import flash_attention as JFA
from repro.launch import steps as JST
from repro.models import Ctx
from repro.models import Model as JaxModel
from repro.models import attention as JATT
from repro_torch import optim as TOPT
from repro_torch.bridge import from_jax
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import FlashAttention, mha_flash
from repro_torch.launch import steps as TST
from repro_torch.launch import train as TTR
from repro_torch.models import Model
from repro_torch.pytree import flatten_with_paths, tree_map

# the module (repro_torch.kernels re-exports a function of the same name)
TFA = importlib.import_module("repro_torch.kernels.flash_attention")

TOL = 1e-5          # logits, loss, grads (rtol = atol), as tests/test_torch_lm.py
STEP_TOL = 1e-4     # five Adam steps, tests/test_torch_launch_train.py
FLASH_TOL = 2e-5    # the reference's own flash test, tests/test_flash_kernel.py:34
ARCH = "minicpm_2b"
B, S = 2, 48
HD = 36


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, what="", tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=what)


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


def _batch(rng, vocab, b=B, s=S):
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    targets = rng.integers(0, vocab, (b, s)).astype(np.int32)
    targets[0, :5] = -1
    return ({"tokens": jnp.asarray(toks), "targets": jnp.asarray(targets)},
            {"tokens": torch.from_numpy(toks).long(),
             "targets": torch.from_numpy(targets).long()})


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(smoke):
    ref = jax_get_config(ARCH, smoke=smoke)
    got = get_config(ARCH, smoke=smoke)
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "head_dim", "d_ff", "vocab_size", "act", "glu",
              "tie_embeddings", "rope_theta", "qkv_bias", "layer_pattern",
              "adapter_targets", "adapter_rank", "adapter_alpha",
              "param_dtype", "compute_dtype", "embed_scale", "rms_offset",
              "post_block_norm", "final_softcap", "source"):
        assert getattr(got, f) == getattr(ref, f), f
    assert get_config("minicpm-2b", smoke=smoke) == got
    assert got.n_heads == got.n_kv_heads           # MHA
    assert got.head_dim == (HD if smoke else 64)


@pytest.fixture(scope="module")
def case():
    cfg_j = jax_get_config(ARCH, smoke=True)
    jm = JaxModel(cfg_j, peft="bea")
    base, tr, masks, rng = _perturbed(jm, 4)
    jb, tb = _batch(rng, cfg_j.vocab_size)
    logits = jax.jit(lambda b, t, m, x: jm.forward(b, t, m, x, remat=False)[0])(
        base, tr, masks, jb)
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
def test_minicpm_logits_match_jax(case, use_kernels):
    base, tr, masks = case["trees"]
    cfg = case["cfg"]
    model = Model(cfg, peft="bea", use_kernels=use_kernels)
    with torch.no_grad():
        logits = model.forward(base, tr, masks, case["batch"])
    assert logits.shape == (B, S, cfg.vocab_size)
    assert base["dec"]["layers"][0]["attn"]["wq"]["w"].shape == (144, 4, HD)
    _close(logits.numpy(), case["logits"], "logits")


@pytest.mark.parametrize("use_kernels", [False, True])
def test_minicpm_lm_loss_and_adapter_grads_match_jax(case, use_kernels):
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


def test_minicpm_five_wsd_steps_match_reference(case):
    """Five steps of ``launch/steps.py``'s train step under MiniCPM's WSD
    schedule (warmup, stable, decay all within five steps at warmup and
    decay fractions of 0.2) against the reference's jitted ones."""
    cfg_j = case["cfg_j"]
    jm = JaxModel(cfg_j, peft="bea")
    base, tr = jm.init(jax.random.key(6))
    masks = jax.tree.map(lambda m: m.at[..., 0].set(False), jm.init_masks())
    n, b = 5, 2
    data = JS.make_lm_stream(n * b, cfg_j.vocab_size, S, seed=2)
    kw = dict(warmup_frac=0.2, decay_frac=0.2)
    jstep = jax.jit(JST.make_train_step(
        jm, JOPT.adam(JOPT.wsd(3e-3, n, **kw)), Ctx(), task="lm"))
    tbase, ttr, tmasks = from_jax(_np(base), _np(tr), _np(masks))
    topt = TOPT.adam(TOPT.wsd(3e-3, n, **kw))
    tstep = TST.make_train_step(Model(case["cfg"]), topt, task="lm")
    js, ts = JOPT.adam(JOPT.wsd(3e-3, n, **kw)).init(tr), topt.init(ttr)
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


# --------------------------------------------------------------------------
# flash at f32 head dim 36
# --------------------------------------------------------------------------

FLASH_CASES = [(2, 48, 48, 4, 4, True), (2, 48, 48, 4, 4, False),
               (1, 100, 100, 4, 2, True), (2, 37, 80, 4, 4, False),
               (1, 20, 20, 4, 4, True)]


@pytest.mark.parametrize("b,sq,sk,h,kv,causal", FLASH_CASES)
def test_mha_flash_hd36_matches_reference_kernel(b, sq, sk, h, kv, causal):
    """The port's ``mha_flash`` (its plain version on the CPU) against the
    reference's Pallas kernel in interpret mode at head dim 36: MHA and GQA,
    causal and not, Sq ≠ Sk, a ragged length and under 32 query rows."""
    rng = np.random.default_rng(sq * 3 + sk + h + kv)
    q = rng.normal(size=(b, sq, h, HD)).astype(np.float32)
    k, v = (rng.normal(size=(b, sk, kv, HD)).astype(np.float32)
            for _ in range(2))
    want = JFA.mha_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, interpret=True)
    got = mha_flash(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert got.shape == (b, sq, h, HD)
    _close(got.numpy(), np.asarray(want), f"{b}x{sq}x{sk}", FLASH_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_hd36_grads_match_reference(causal):
    """``FlashAttention`` at head dim 36: its output against the
    reference's Pallas kernel (interpret mode), its q, k and v grads
    against ``jax.grad`` of the reference's jnp attention (``_direct``, its
    training path) under the same mask."""
    rng = np.random.default_rng(36 + causal)
    b, s, h, kv = 2, S, 4, 4
    q, k, v = (rng.normal(size=(b, s, n, HD)).astype(np.float32)
               for n in (h, kv, kv))
    g = rng.normal(size=(b, s, h, HD)).astype(np.float32)
    pos = np.arange(s)
    mask = (pos[None, :] <= pos[:, None]) if causal else np.ones((s, s), bool)

    def jout(q, k, v):
        o = JATT._direct(q.reshape(b, s, kv, h // kv, HD), k, v,
                         jnp.asarray(mask)[None, None, None], HD ** -0.5, 0.0)
        return o.reshape(b, s, h, HD)

    wg = jax.grad(lambda *a: (jout(*a) * g).sum(), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    want = JFA.mha_flash(*map(jnp.asarray, (q, k, v)), causal=causal,
                         interpret=True)
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = FlashAttention.apply(*leaves, causal)
    _close(out.detach().numpy(), np.asarray(want), "output", FLASH_TOL)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, a, w in zip("qkv", got, wg):
        _close(a.numpy(), np.asarray(w), f"d{name}")


def test_plan_runs_f32_hd36_on_tf32_kernel_and_refuses_bf16():
    """An f32 call at head dim 36 takes the mma.sync bodies' plan (in f32,
    ``tf32_kernel``, on its tile padded to 40); bf16 at 36 is built for no
    body and raises, at every row count."""
    assert HD in TFA.F32_HEAD_DIMS and HD not in TFA.HEAD_DIMS
    for b, sq, sk in ((8, 512, 512), (2, 100, 100), (1, 20, 20)):
        assert TFA.plan(torch.float32, b, 4, sq, sk, HD) == TFA.Plan("mma")
        with pytest.raises(ValueError, match="queue 2 item 1"):
            TFA.plan(torch.bfloat16, b, 4, sq, sk, HD)


# --------------------------------------------------------------------------
# the entry points
# --------------------------------------------------------------------------

def test_minicpm_prefill_and_decode_match_jax(case):
    """MiniCPM needs nothing the dense decoder's serving path lacks: its
    prefill and three decode steps give the reference's logits."""
    jm = case["jm"]
    base, tr, masks = case["jax_trees"]
    rng = np.random.default_rng(4)
    b, s, t_max = 2, 7, 16
    prompt = rng.integers(0, case["cfg_j"].vocab_size, (b, s))
    steps = rng.integers(0, case["cfg_j"].vocab_size, (3, b, 1))
    cache = jax.tree.map(lambda m: jnp.zeros(m.shape, m.dtype),
                         jm.cache_meta(b, t_max),
                         is_leaf=lambda x: hasattr(x, "init"))
    want_pre, cache = jm.prefill(base, tr, masks,
                                 {"tokens": jnp.asarray(prompt)}, cache)
    tm = Model(case["cfg"])
    tb, ttr, tmask = case["trees"]
    tcache = tm.init_cache(b, t_max, "cpu")
    got, tcache = tm.prefill(tb, ttr, tmask, torch.from_numpy(prompt), tcache)
    _close(got.numpy(), np.asarray(want_pre), "prefill")
    for tok in steps:
        want, cache = jm.decode_step(base, tr, masks, jnp.asarray(tok), cache)
        got, tcache = tm.decode_step(tb, ttr, tmask, torch.from_numpy(tok),
                                     tcache)
        _close(got.numpy(), np.asarray(want), "decode")


def test_minicpm_train_cli_runs_on_cpu_under_wsd(capsys):
    out = TTR.main(["--arch", ARCH, "--device", "cpu", "--steps", "3",
                    "--seq", str(S), "--schedule", "wsd"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[1] for ln in lines[:-1]] == ["0", "1", "2"]
    assert lines[-1].startswith("done: 3 steps")
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert out["base"]["dec"]["layers"][0]["attn"]["wk"]["w"].shape == \
        (144, 4, HD)
