"""Port parity for SLoRA (``repro/federated/baselines.py:SLoRA`` and the
seq server's stage 1): the full fine-tuning step's base grads and the
gated base update against the reference's, the sparse-gate wire per path,
the SVD init of LoRA from the stage-1 delta exactly, the port's own gate
(stable across processes, density about 0.05), and the whole SLoRA run
against the reference's from the same weights with the reference's gate
carried across (CPU), plus ``tests/test_pipeline.py``'s stage-1 checks
without DP.  Helpers from ``tests/test_torch_baselines.py``."""

import functools
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JOPT
from repro.federated import client as JCL
from repro.fedsim import pipeline as JPL
from repro.pytree import path_of
from repro_torch.bridge import bridge_tree
from repro_torch.federated import client as CL
from repro_torch.federated.baselines import SLoRA
from repro_torch.fedsim import pipeline as PL
from repro_torch.models import Model
from repro_torch.optim import adam, linear_decay
from repro_torch.pytree import flatten_with_paths, leaves, tree_map
from test_torch_baselines import _one_thread  # noqa: F401 (autouse)
from test_torch_baselines import (RUN_KW, _assert_same_run, _close,
                                  _jax_model, _jax_run, _np, _port_run,
                                  _same_tensors, _setup)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def su():
    return _setup()


@pytest.fixture(scope="module")
def jax_weights(su):
    """The reference SLoRA model's initial weights, its gate for seed 0,
    and both bridged to the port."""
    jstrat, jm = _jax_model(su, "slora")
    jbase, jtr = jm.init(jax.random.key(0))
    jgate = jstrat.sparse_gate(jbase, 0)
    return dict(jstrat=jstrat, jm=jm, jbase=jbase, jtr=jtr, jgate=jgate,
                base=bridge_tree(_np(jbase)), tr=bridge_tree(_np(jtr)),
                gate=bridge_tree(_np(jgate)))


def _port_path(jax_path: str) -> str:
    """``dec.tail.t3.attn.wq.w`` → ``dec.layers.3.attn.wq.w``."""
    return jax_path.replace("tail.t", "layers.")


def _jax_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_port_path(path_of(p)): np.asarray(x) for p, x in flat}


# --------------------------------------------------------------------------
# units
# --------------------------------------------------------------------------

# The stage-1 step is held against the port's plain path in float64, not
# the two f32 results against each other.  Measured on the CPU for this
# MINI step: each f32 grad lies within 9.7e-7 of its leaf's largest f64
# value (the reference's and the port's alike), and the reference's grads
# are bit for bit the same under XLA's 1-device and 4-device CPU setups.
# The f32 results differ in summation order only, so the grads are held at
# 10x that spread.  The base update is not a sum: Adam's first step moves
# an entry by lr*g/(|g|+eps), which multiplies a grad's rounding by up to
# lr/eps where |g| is near eps (an entry of dec.layers.1.attn.wo.w has
# g = 3.8e-8, and the f32 grads there differ by 10%).  So each updated
# entry is held to the f64 update within the step's derivative times the
# grad's bound.
GRAD_TOL = 1e-5         # of the leaf's largest |f64 grad|
UPDATE_ROUNDING = 1e-6  # of the leaf's largest |f64 weight|: f32's p + u
STEP_LR, ADAM_EPS = 3e-3, 1e-8


def _stage1_step(su, base, tr, gate, toks, labels):
    opt = adam(linear_decay(STEP_LR, 12), eps=ADAM_EPS)
    step = CL.make_train_step(Model(su["cfg"], peft="lora"), opt,
                              train_base=True)
    _, _, g, gb, loss, _ = step(
        base, tr, opt.init(tr), None, None,
        CL.device_batch({"tokens": toks, "labels": labels}, "cpu"))
    b1, _ = CL.make_base_update_step(opt)(base, opt.init(base), gb, gate)
    return dict(loss=loss.item(), gb=gb, g=g, b1=b1)


def _f64_stage1_step(su, base, tr, gate, toks, labels, monkeypatch):
    """The same step on the port's plain path in float64: the weights are
    cast, and the path's f32 casts (LayerNorm, scores, pooling, Adam's
    moments) become f64 casts for the call."""
    to64 = functools.partial(tree_map, lambda t: t.double())
    f32_cast = torch.Tensor.float
    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "float", lambda t: t.double()
                   if t.is_floating_point() else f32_cast(t))
        return _stage1_step(su, to64(base), to64(tr), gate, toks, labels)


def test_full_ft_step_and_gated_base_update_match_jax(su, jax_weights,
                                                      monkeypatch):
    """One stage-1 step: the loss, every base grad and every trainable
    grad of the reference's ``make_train_step(train_base=True)`` and of the
    port, then the gated Adam update of the base by
    ``make_base_update_step``, each against the port's f64 step.  The gate
    is the port's (a sha256 draw, the same in every process); the
    reference's salted-hash gate would put a different set of the
    ill-conditioned entries above in each process."""
    jw = jax_weights
    rng = np.random.default_rng(5)
    toks = rng.integers(0, su["cfg"].vocab_size, (8, 32))
    labels = rng.integers(0, su["cfg"].n_classes, 8)
    gate = SLoRA().sparse_gate(jw["base"], 0)
    jgate = _to_jax_paths(gate, jw["jgate"])
    jopt = JOPT.adam(JOPT.linear_decay(STEP_LR, 12), eps=ADAM_EPS)
    jstep = JCL.make_train_step(jw["jm"], jopt, "cls", train_base=True)
    _, _, jg, jgb, jloss, _ = jstep(
        jw["jbase"], jw["jtr"], jopt.init(jw["jtr"]), None, None,
        {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    jb1, _ = JCL.make_base_update_step(jopt)(
        jw["jbase"], jopt.init(jw["jbase"]), jgb, jgate)
    ref = dict(loss=float(jloss), **{k: bridge_tree(_np(v)) for k, v in
                                    (("gb", jgb), ("g", jg), ("b1", jb1))})
    port = _stage1_step(su, jw["base"], jw["tr"], gate, toks, labels)
    want = _f64_stage1_step(su, jw["base"], jw["tr"], gate, toks, labels,
                            monkeypatch)

    grad_bound = {}
    for side in (ref, port):
        _close(side["loss"], want["loss"], GRAD_TOL, "loss")
        for name in ("gb", "g"):
            gl, wl = flatten_with_paths(side[name]), \
                flatten_with_paths(want[name])
            assert [p for p, _ in gl] == [p for p, _ in wl]
            for (path, a), (_, b) in zip(gl, wl):
                assert a.dtype == torch.float32
                _close(a.numpy(), b.numpy(), GRAD_TOL, f"{name} {path}")
                grad_bound[path] = GRAD_TOL * b.abs().max().item()
        g64 = dict(flatten_with_paths(want["gb"]))
        for path, b in flatten_with_paths(want["b1"]):
            a = dict(flatten_with_paths(side["b1"]))[path].double()
            dg = grad_bound[path]
            g_lo = (g64[path].abs() - dg).clamp(min=0)
            bound = STEP_LR * dg * ADAM_EPS / (g_lo + ADAM_EPS) ** 2 \
                + UPDATE_ROUNDING * b.abs().max()
            err = (a - b).abs()
            assert bool((err <= bound).all()), \
                f"b1 {path}: {(err - bound).max().item()} over its bound"
    # off the gate, the base does not move
    w0 = jw["base"]["dec"]["layers"][0]["mlp"]["w1"]["w"]
    w1 = port["b1"]["dec"]["layers"][0]["mlp"]["w1"]["w"]
    off = gate["dec"]["layers"][0]["mlp"]["w1"]["w"] == 0
    assert torch.equal(w1[off], w0[off]) and not torch.equal(w1, w0)


def _to_jax_paths(tree, jtree):
    """A port tree as a tree of jax arrays shaped as the reference tree
    ``jtree`` (leaves matched by path: ``dec.tail.t<i>`` is the port's
    ``dec.layers.<i>``)."""
    got = dict(flatten_with_paths(tree))
    flat, treedef = jax.tree_util.tree_flatten_with_path(jtree)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(got[_port_path(path_of(p))].numpy())
                  for p, _ in flat])


def test_gate_wire_matches_jax_per_path(jax_weights):
    """``flatten_gate`` gives the reference's wire segment for every leaf
    (the trees order their leaves differently, so compare per path, and
    the lengths), and ``unflatten_gate`` inverts it exactly."""
    jw = jax_weights
    rng = np.random.default_rng(7)
    jdelta = jax.tree.map(
        lambda x: rng.normal(size=x.shape).astype(np.float32), jw["jbase"])
    delta, gate = bridge_tree(jdelta), jw["gate"]
    wire = PL.flatten_gate(delta, gate)
    jwire = JPL.flatten_gate(jdelta, jw["jgate"])
    assert wire.dtype == np.float32 and wire.shape == jwire.shape
    got, off = {}, 0
    for (path, d), (_, g) in zip(flatten_with_paths(delta),
                                 flatten_with_paths(gate)):
        n = int((g != 0).sum())
        got[path] = wire[off:off + n]
        off += n
    jd, jg = _jax_leaves(jdelta), _jax_leaves(jw["jgate"])
    assert sorted(got) == sorted(jd)
    for path, seg in got.items():
        want = JPL.flatten_gate({"x": jd[path]}, {"x": jg[path]})
        assert np.array_equal(seg, want), path
    back = PL.unflatten_gate(wire, delta, gate)
    jback = _jax_leaves(JPL.unflatten_gate(jwire, jdelta, jw["jgate"]))
    for path, t in flatten_with_paths(back):
        assert t.dtype == torch.float32
        assert np.array_equal(t.numpy(), jback[path]), path


def test_svd_init_from_delta_is_exact(su, jax_weights):
    """The LoRA init from the SVD of base1 − base0, on the same numpy
    inputs, equals the reference's bit for bit."""
    jw = jax_weights
    rng = np.random.default_rng(9)
    jbase1 = jax.tree.map(
        lambda x, g: np.asarray(x) + 1e-3 * np.asarray(g)
        * rng.normal(size=x.shape).astype(np.float32), jw["jbase"],
        jw["jgate"])
    jt = jw["jstrat"].svd_init_from_delta(jw["jm"], jw["jbase"], jbase1,
                                          jw["jtr"])
    model = Model(su["cfg"], peft="lora")
    t = SLoRA().svd_init_from_delta(model, jw["base"],
                                    bridge_tree(_np(jbase1)), jw["tr"])
    _same_tensors(t, bridge_tree(_np(jt)))
    assert t["adapters"]["dec"]["layers"][1]["mlp"]["w2"]["B"].abs().sum() > 0


_GATE_DIGEST = """
import hashlib, sys
sys.path.insert(0, "src")
from repro_torch.configs.distilbert import MINI
from repro_torch.federated.baselines import SLoRA
from repro_torch.models import Model
from repro_torch.pytree import leaves
base, _ = Model(MINI, peft="lora").init(0, "cpu")
g = SLoRA().sparse_gate(base, 0)
print(hashlib.sha256(b"".join(t.numpy().tobytes() for t in leaves(g)))
      .hexdigest())
"""


def test_port_gate_is_stable_across_processes_and_sparse():
    """The port's gate hashes leaf paths with sha256, not Python's salted
    ``hash``: two processes with different ``PYTHONHASHSEED`` draw the same
    gate.  Its density is the strategy's 0.05."""
    digests = set()
    for hash_seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=hash_seed)
        out = subprocess.run([sys.executable, "-c", _GATE_DIGEST], cwd=ROOT,
                             env=env, capture_output=True, text=True,
                             timeout=300, check=True)
        digests.add(out.stdout.strip())
    assert len(digests) == 1
    from repro_torch.configs.distilbert import MINI
    base, _ = Model(MINI, peft="lora").init(0, "cpu")
    g0, g1 = SLoRA().sparse_gate(base, 0), SLoRA().sparse_gate(base, 1)
    here = hashlib.sha256(b"".join(t.numpy().tobytes()
                                   for t in leaves(g0))).hexdigest()
    assert digests == {here}
    n = sum(t.numel() for t in leaves(base))
    on = sum(int(t.sum()) for t in leaves(g0))
    assert abs(on / n - 0.05) < 2e-3
    assert all(set(torch.unique(t).tolist()) <= {0.0, 1.0}
               for t in leaves(g0))
    assert any(not torch.equal(a, b) for a, b in zip(leaves(g0), leaves(g1)))
    assert SLoRA().stage1_comm_bytes(base) == int(n * 0.05) * 4


# --------------------------------------------------------------------------
# the whole run, the reference's gate carried across
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slora_run(su):
    return _jax_run(su, "slora")


def _port_slora(gate) -> SLoRA:
    strat = SLoRA()
    strat.sparse_gate = lambda base, seed=0: gate
    return strat


@pytest.mark.parametrize("use_kernels", [False, True])
def test_slora_run_matches_jax(su, jax_weights, slora_run, use_kernels):
    """Stage 1 (one round) and two LoRA rounds: bytes, trainable counts,
    the simulated clock, comm_gb and ``history["stage1"]`` equal, losses
    within 1e-3, final accuracy within one eval sample."""
    want, params = slora_run
    h = _port_run(su, _port_slora(jax_weights["gate"]), params, use_kernels)
    _assert_same_run(h, want)
    assert h["stage1"]["rounds"] == 1


def test_stage1_rides_the_pipeline(su, slora_run):
    """``tests/test_pipeline.py::test_stage1_rides_the_pipeline`` without
    DP, on the port's own gate: stage-1 uploads are byte-accounted on the
    sparse-gate wire (its f32 values and the 4-byte header per client),
    priced into the simulated clock, and its round's log carries them."""
    _, params = slora_run
    strat = SLoRA()
    h = _port_run(su, strat, params, False)
    assert h["stage1"] == {"rounds": 1, "up_bytes": h["rounds"][0].up_bytes,
                           "n_clipped": 0}
    s1 = h["rounds"][0]
    gate = strat.sparse_gate(params[0], 0)
    support = sum(int(t.sum()) for t in leaves(gate))
    assert s1.up_bytes == RUN_KW["clients_per_round"] * (4 * support + 4)
    assert s1.down_bytes == RUN_KW["clients_per_round"] * \
        strat.stage1_comm_bytes(params[0])
    assert s1.sim_time_s > 0 and np.isnan(s1.loss)
    assert s1.trainable_params == sum(t.numel() for t in leaves(params[0]))
    assert np.isfinite(h["final_acc"])
    assert not np.isnan(h["rounds"][1].loss)
