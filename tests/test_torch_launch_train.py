"""Port parity for the LM fine-tuning entry point: ``launch/steps.py``'s
train step over five Adam steps against the reference's under
``jax.jit`` (Qwen2 and BART SMOKE, bridged weights), the prefill and
decode steps, ``launch/train.py`` on the CPU with the reference's progress
lines, the LM and seq2seq data exactly, and the LR schedules at every step
(CPU, float32)."""

import re

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
from repro_torch import optim as TOPT
from repro_torch.bridge import from_jax
from repro_torch.configs import get_config
from repro_torch.data import synthetic as TS
from repro_torch.launch import steps as TST
from repro_torch.launch import train as TTR
from repro_torch.models import Model
from repro_torch.pytree import flatten_with_paths

STEP_TOL = 1e-4     # five Adam steps, losses and trainables (rtol = atol)
PROGRESS = re.compile(r"^step +(\d+)  loss (\d+\.\d{4})  \((\d+\.\d)s\)$")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", ["qwen2_0p5b", "bart"])
def test_train_step_matches_reference_over_five_steps(arch):
    cfg_j = jax_get_config(arch, smoke=True)
    jm = JaxModel(cfg_j, peft="bea")
    base, tr = jm.init(jax.random.key(6))
    masks = jax.tree.map(lambda m: m.at[..., 0].set(False), jm.init_masks())
    n, b, s = 5, 2, 16
    data = JS.make_lm_stream(n * b, cfg_j.vocab_size, s, seed=2)
    jstep = jax.jit(JST.make_train_step(
        jm, JOPT.adam(JOPT.linear_decay(3e-3, n)), Ctx(), task="lm"))
    tbase, ttr, tmasks = from_jax(_np(base), _np(tr), _np(masks))
    topt = TOPT.adam(TOPT.linear_decay(3e-3, n))
    tstep = TST.make_train_step(Model(get_config(arch, smoke=True)), topt,
                                task="lm")
    js, ts = JOPT.adam(JOPT.linear_decay(3e-3, n)).init(tr), topt.init(ttr)
    for i in range(n):
        sl = slice(i * b, (i + 1) * b)
        jb = {"tokens": jnp.asarray(data["tokens"][sl]),
              "targets": jnp.asarray(data["targets"][sl])}
        tb = {k: torch.as_tensor(np.array(v)).long() for k, v in jb.items()}
        if cfg_j.is_encoder_decoder:
            jb["enc_tokens"], tb["enc_tokens"] = jb["tokens"], tb["tokens"]
        tr, js, jmet = jstep(base, tr, js, masks, jb)
        ttr, ts, tmet = tstep(tbase, ttr, ts, tmasks, tb)
        np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]),
                                   rtol=STEP_TOL, atol=STEP_TOL)
        assert tmet["metric"].item() == float(jmet["metric"]) == 0.0
    assert ts["step"] == int(js["step"]) == n
    want = dict(flatten_with_paths(from_jax(_np(tr), None, None)[0]))
    got = flatten_with_paths(ttr)
    assert [p for p, _ in got] == sorted(want)
    for path, t in got:
        np.testing.assert_allclose(t.numpy(), want[path].numpy(),
                                   rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=path)
    # the adapters moved: E left its zero init
    assert any(t.abs().sum() > 0 for p, t in got if p.endswith(".E"))


def test_prefill_and_decode_steps_serve_the_decoder():
    cfg = get_config("qwen2_0p5b", smoke=True)
    model = Model(cfg, use_kernels=False)
    base, tr = model.init(1, "cpu")
    masks = model.init_masks("cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 7)))
    cache = model.init_cache(2, 12, "cpu")
    logits, cache = TST.make_prefill_step(model)(
        base, tr, masks, {"tokens": toks}, cache)
    want, _ = model.prefill(base, tr, masks, toks, model.init_cache(2, 12,
                                                                    "cpu"))
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    nxt, cache = TST.make_decode_step(model)(
        base, tr, masks, {"tokens": logits.argmax(-1)[:, None]}, cache)
    assert nxt.shape == (2, 1) and cache["pos"].tolist() == [8, 8]


@pytest.mark.parametrize("arch", ["qwen2_0p5b", "bart"])
def test_train_cli_on_cpu_prints_the_reference_progress(capsys, arch):
    out = TTR.main(["--arch", arch, "--device", "cpu", "--steps", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    got = [PROGRESS.match(ln) for ln in lines[:-1]]
    assert all(got), lines
    # the reference logs every 10% of the steps and the last: all 3 here
    assert [int(m.group(1)) for m in got] == [0, 1, 2]
    assert [float(m.group(2)) for m in got] == \
        [round(v, 4) for v in out["losses"]]
    assert re.match(r"^done: 3 steps in \d+\.\ds$", lines[-1])
    assert all(np.isfinite(out["losses"]))


def test_train_cli_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TTR.main(["--arch", "bart", "--steps", "1"])


@pytest.mark.parametrize("n,vocab,seq,seed", [(6, 97, 12, 3), (9, 512, 33, 0),
                                              (4, 2048, 5, 7)])
def test_lm_and_seq2seq_data_equal_the_reference(n, vocab, seq, seed):
    want, got = JS.make_lm_stream(n, vocab, seq, seed=seed), \
        TS.make_lm_stream(n, vocab, seq, seed=seed)
    assert set(got) == set(want) == {"tokens", "targets"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["tokens"][:, 1:],
                                  got["targets"][:, :-1])
    want, got = JS.make_seq2seq(n, vocab, seq + 1, min(seq, 4), seed=seed), \
        TS.make_seq2seq(n, vocab, seq + 1, min(seq, 4), seed=seed)
    for k in ("src", "tgt"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name,args", [
    ("constant", (2e-3,)), ("linear_decay", (2e-3, 50)),
    ("linear_decay", (3e-3, 7, 1e-4)), ("cosine", (2e-3, 50, 5)),
    ("cosine", (1e-3, 9, 0, 1e-4)), ("wsd", (2e-3, 50)),
    ("wsd", (3e-3, 13, 0.2, 0.3, 0.2))])
def test_schedules_equal_the_reference_at_every_step(name, args):
    want, got = getattr(JOPT, name)(*args), getattr(TOPT, name)(*args)
    for step in range(0, 64):
        w = float(want(jnp.int32(step)))
        g = got(step)
        assert isinstance(g, np.float32)
        assert abs(float(g) - w) <= 1e-7, (step, float(g), w)
    assert TTR.schedule("cosine", 2e-3, 20)(1) == TOPT.cosine(
        2e-3, 20, warmup=2)(1)
