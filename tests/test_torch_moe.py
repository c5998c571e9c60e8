"""Port parity for the MoE block and the MoE LMs (CPU, float32, SMOKE
widths: Granite-3.0-1B-A400M and Kimi-K2, 4 experts top-2, d_ff 64): the
per-expert adapters, ``moe_meta``/``moe_adapter_meta``, the router's
top-k, capacity and slot order (identical integers, also at a capacity
factor that drops tokens), ``moe_apply``'s output, aux and gradients, the
deterministic combine against the reference's scatter-add, the whole
model's logits, ``lm_loss`` (total, loss, aux) and every adapter gradient
with the reference built unrolled and scanned, five train steps, the
expert-axis branches of CommPru, importance, FedARA and pruning, and the
``train.py`` CLI.  Weights cross by ``bridge.from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JOPT
from repro.configs import get_config as jax_get_config
from repro.core import adapters as JAD
from repro.core import comm as JCOMM
from repro.core import importance as JIMP
from repro.core import pruning as JPR
from repro.core.fedara import FedARA as JFedARA
from repro.data import synthetic as JS
from repro.launch import steps as JST
from repro.models import Ctx
from repro.models import Model as JaxModel
from repro.models import moe as JMOE
from repro.pytree import materialize as jax_materialize
from repro_torch import optim as TOPT
from repro_torch.bridge import bridge_tree, from_jax
from repro_torch.configs import get_config
from repro_torch.core import adapters as AD
from repro_torch.core import comm as COMM
from repro_torch.core import importance as IMP
from repro_torch.core import pruning as PR
from repro_torch.core.fedara import FedARA
from repro_torch.launch import steps as TST
from repro_torch.launch import train as TTR
from repro_torch.models import Model
from repro_torch.models import blocks as TBK
from repro_torch.models import moe as TMOE
from repro_torch.pytree import flatten_with_paths, materialize, tree_map

TOL = 1e-5          # rtol = atol, as tests/test_torch_lm.py
STEP_TOL = 1e-4     # five Adam steps, tests/test_torch_launch_train.py
ARCHS = ["granite_moe_1b_a400m", "kimi_k2_1t_a32b"]
B, S = 2, 48
DROPPING = 0.5      # capacity factor at which SMOKE drops routed tokens


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


def _grads(model, base, tr, masks, batch, **kw):
    flat = []

    def leaf(t):
        flat.append(t.clone().requires_grad_(True))
        return flat[-1]

    req = tree_map(leaf, tr)
    total, (loss, aux) = model.lm_loss(base, req, masks, batch, **kw)
    it = iter(torch.autograd.grad(total, flat))
    return total, loss, aux, tree_map(lambda _: next(it), req)


# --------------------------------------------------------------------------
# per-expert adapters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["bea", "lora", "ffa"])
@pytest.mark.parametrize("n_experts", [0, 3])
def test_adapter_meta_matches_reference(kind, n_experts):
    want = JAD.adapter_meta(kind, 16, 12, 4, n_experts=n_experts)
    got = AD.adapter_meta(kind, 16, 12, 4, n_experts=n_experts)
    assert sorted(got) == sorted(want)
    for k, m in got.items():
        assert m.shape == want[k].shape, k
        assert (m.init, m.scale) == (want[k].init, want[k].scale), k
    if n_experts:
        assert got["A"].shape == (3, 4, 16) and got["B"].shape == (3, 12, 4)


@pytest.mark.parametrize("masked", [False, True])
def test_apply_adapter_per_expert_matches_reference(masked):
    """x (E, C, d_in) through expert e's adapter for expert e's rows, the
    (r,) mask shared by every expert (tests/test_adapters.py:63's case
    with values)."""
    rng = np.random.default_rng(3)
    ad = {k: rng.normal(size=s).astype(np.float32)
          for k, s in (("A", (3, 4, 16)), ("B", (3, 12, 4)), ("E", (3, 4)))}
    x = rng.normal(size=(3, 7, 16)).astype(np.float32)
    y = rng.normal(size=(3, 7, 12)).astype(np.float32)
    mask = np.array([1, 0, 1, 1], bool) if masked else None
    want = JAD.apply_adapter(jnp.asarray(y), jnp.asarray(x),
                             jax.tree.map(jnp.asarray, ad),
                             None if mask is None else jnp.asarray(mask), 1.7)
    got = AD.apply_adapter(torch.from_numpy(y), torch.from_numpy(x),
                           bridge_tree(ad),
                           None if mask is None else torch.from_numpy(mask),
                           1.7)
    assert got.shape == (3, 7, 12)
    _close(got.numpy(), np.asarray(want), "per-expert apply_adapter")
    # expert e is expert e's plain adapter
    for e in range(3):
        one = AD.apply_adapter(torch.from_numpy(y[e]), torch.from_numpy(x[e]),
                               {k: torch.from_numpy(v[e]) for k, v in ad.items()},
                               None if mask is None else torch.from_numpy(mask),
                               1.7)
        _close(got[e].numpy(), one.numpy(), f"expert {e}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
def test_moe_metas_match_reference(arch, smoke):
    """``moe_meta`` and ``moe_adapter_meta`` (the router's at rank
    min(r, E)) leaf for leaf: shapes, dtypes and inits; at full width too
    (metas only, nothing allocated)."""
    cfg_j, cfg = jax_get_config(arch, smoke=smoke), get_config(arch, smoke)
    for jm, tm in ((JMOE.moe_meta(cfg_j), TMOE.moe_meta(cfg)),
                   (JMOE.moe_adapter_meta(cfg_j, "bea"),
                    TMOE.moe_adapter_meta(cfg, "bea"))):
        want = dict(flatten_with_paths(jm, is_leaf=lambda m: hasattr(
            m, "shape") and hasattr(m, "init")))
        got = flatten_with_paths(tm, is_leaf=lambda m: hasattr(m, "init"))
        assert [p for p, _ in got] == sorted(want)
        for path, m in got:
            w = want[path]
            assert m.shape == w.shape, path
            assert str(m.dtype).split(".")[-1] == str(np.dtype(w.dtype)), path
            assert (m.init, m.scale) == (w.init, w.scale), path
    r = cfg.adapter_rank
    ad = TMOE.moe_adapter_meta(cfg, "bea")
    assert ad["router"]["A"].shape == (min(r, cfg.n_experts), cfg.d_model)
    assert ad["w2"]["B"].shape == (cfg.n_experts, cfg.d_model, r)


# --------------------------------------------------------------------------
# routing, dispatch, combine
# --------------------------------------------------------------------------

def _moe_operands(arch, cf, seed, zero_router=False):
    """One MoE layer's reference weights and adapters (E off zero) and a
    token batch (T, d), each as JAX and as port trees."""
    cfg_j = jax_get_config(arch, smoke=True).with_(capacity_factor=cf)
    cfg = get_config(arch, smoke=True).with_(capacity_factor=cf)
    w = jax_materialize(JMOE.moe_meta(cfg_j), jax.random.key(seed))
    ad = jax_materialize(JMOE.moe_adapter_meta(cfg_j, "bea"),
                         jax.random.key(seed + 1))
    rng = np.random.default_rng(seed)
    ad = jax.tree_util.tree_map_with_path(
        lambda p, v: v + jnp.asarray(rng.normal(size=v.shape) * 0.3, v.dtype)
        if str(p[-1].key) == "E" else v, ad)
    if zero_router:                      # every expert equally likely
        w = dict(w, router={"w": jnp.zeros_like(w["router"]["w"])})
        ad = dict(ad, router=dict(ad["router"],
                                  E=jnp.zeros_like(ad["router"]["E"])))
    masks = {k: jnp.ones(v["A"].shape[-2], bool).at[1].set(False)
             for k, v in ad.items()}
    x = rng.normal(size=(B * S, cfg.d_model)).astype(np.float32)
    return (cfg_j, w, ad, masks), (cfg, bridge_tree(_np(w)),
                                   bridge_tree(_np(ad)),
                                   bridge_tree(_np(masks))), x


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [2.0, DROPPING])
def test_route_and_dispatch_matches_reference(arch, cf):
    """The slot table (``gidx``, ``valid``) and the capacity are the
    reference's integer for integer, weights ``gw``, the dispatched tokens
    and the aux within TOL; at the dropping factor some choices miss
    their expert's capacity, at SMOKE's 2.0 none do."""
    (cfg_j, jw, jad, jm), (cfg, w, ad, m), x = _moe_operands(arch, cf, 11)
    xe_j, gidx_j, gw_j, valid_j, aux_j = JMOE._route_and_dispatch(
        jnp.asarray(x), jw, jad, jm, cfg_j, cfg_j.n_experts, 0)
    xe, gidx, gw, valid, aux, slots, top_ids = TMOE._route_and_dispatch(
        torch.from_numpy(x), w, ad, m, cfg)
    c = TMOE._capacity(B * S, cfg)
    assert c == JMOE._capacity(B * S, cfg_j)
    assert xe.shape == (cfg.n_experts, c, cfg.d_model) == xe_j.shape
    assert np.array_equal(gidx.numpy(), np.asarray(gidx_j))
    assert np.array_equal(valid.numpy(), np.asarray(valid_j))
    _close(gw.numpy(), np.asarray(gw_j), "gw")
    _close(xe.detach().numpy(), np.asarray(xe_j), "xe")
    _close(aux.item(), float(aux_j), "aux")
    routed = B * S * cfg.top_k
    kept = int(valid.sum().item())
    assert kept == int((slots < gidx.numel()).sum())
    assert (kept < routed) if cf == DROPPING else (kept == routed)
    # each token's slots: its kept choices' experts, ascending
    for t in range(0, B * S, 17):
        got = [int(s) // c for s in slots[t] if s < gidx.numel()]
        assert got == sorted(got) and set(got) <= set(top_ids[t].tolist())


@pytest.mark.parametrize("cf", [2.0, DROPPING])
def test_top_k_ties_go_to_the_lower_expert_as_the_reference(cf):
    """A zero router gives every expert the same probability: the
    reference's ``lax.top_k`` takes experts 0 and 1 for every token, and
    so does the port's stable sort (``torch.topk`` does not promise an
    order among ties)."""
    (cfg_j, jw, jad, jm), (cfg, w, ad, m), x = _moe_operands(
        ARCHS[0], cf, 12, zero_router=True)
    *_, gidx_j, gw_j, valid_j, _ = JMOE._route_and_dispatch(
        jnp.asarray(x), jw, jad, jm, cfg_j, cfg_j.n_experts, 0)
    _, gidx, gw, valid, _, _, top_ids = TMOE._route_and_dispatch(
        torch.from_numpy(x), w, ad, m, cfg)
    assert torch.equal(top_ids, torch.tensor([[0, 1]] * (B * S)))
    assert np.array_equal(gidx.numpy(), np.asarray(gidx_j))
    assert np.array_equal(valid.numpy(), np.asarray(valid_j))
    _close(gw.numpy(), np.asarray(gw_j), "gw")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [2.0, DROPPING])
def test_moe_apply_and_grads_match_reference(arch, cf):
    """``moe_apply``'s y and aux, and the gradients of a random projection
    of y plus the aux with respect to x and every adapter leaf (through
    the dispatch's and the combine's gathers) against ``jax.grad``."""
    (cfg_j, jw, jad, jm), (cfg, w, ad, m), x = _moe_operands(arch, cf, 13)
    x3 = x.reshape(B, S, -1)
    g = np.random.default_rng(14).normal(size=x3.shape).astype(np.float32)

    def jloss(xx, a):
        y, aux = JMOE.moe_apply(jw, xx, cfg_j, None, a, jm)
        return jnp.sum(y * g) + aux, (y, aux)

    (_, (y_j, aux_j)), (gx_j, gad_j) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x3), jad)
    xt = torch.from_numpy(x3).requires_grad_(True)
    leaves = tree_map(lambda t: t.clone().requires_grad_(True), ad)
    y, aux = TMOE.moe_apply(w, xt, cfg, leaves, m)
    flat = [t for _, t in flatten_with_paths(leaves)]
    got = torch.autograd.grad((y * torch.from_numpy(g)).sum() + aux,
                              [xt] + flat)
    _close(y.detach().numpy(), np.asarray(y_j), "y")
    _close(aux.item(), float(aux_j), "aux")
    _close(got[0].numpy(), np.asarray(gx_j), "dx")
    want = dict(flatten_with_paths(bridge_tree(_np(gad_j))))
    for (path, _), gt in zip(flatten_with_paths(leaves), got[1:]):
        _close(gt.numpy(), want[path].numpy(), path)


@pytest.mark.parametrize("cf", [2.0, DROPPING])
def test_combine_matches_reference_scatter_add(cf):
    """The port's combine (each token sums its kept slots' rows in slot
    order) against the reference's ``zeros.at[gidx].add(ye)`` over the
    same slot table, with the empty slots' rows zero as the reference
    makes them; and the dispatch's backward against the scatter-add that
    ``jax.grad`` of the gather gives."""
    (cfg_j, jw, jad, jm), (cfg, w, ad, m), x = _moe_operands(ARCHS[0], cf, 15)
    _, gidx, gw, valid, _, slots, _ = TMOE._route_and_dispatch(
        torch.from_numpy(x), w, ad, m, cfg)
    rng = np.random.default_rng(16)
    rows = rng.normal(size=(gidx.numel(), cfg.d_model)).astype(np.float32)
    rows *= valid.numpy()[:, None]
    want = jnp.zeros((B * S, cfg.d_model)).at[jnp.asarray(gidx.numpy())].add(
        jnp.asarray(rows))
    got = TMOE._combine(torch.from_numpy(rows), slots)
    _close(got.numpy(), np.asarray(want), "combine")
    xt = torch.from_numpy(x).requires_grad_(True)
    xe = TMOE._Dispatch.apply(xt, gidx, valid, slots)
    (gx,) = torch.autograd.grad((xe * torch.from_numpy(rows)).sum(), [xt])
    gx_j = jax.grad(lambda xx: jnp.sum(
        xx[jnp.asarray(gidx.numpy())] * jnp.asarray(valid.numpy())[:, None]
        * rows))(jnp.asarray(x))
    _close(gx.numpy(), np.asarray(gx_j), "dispatch backward")


# --------------------------------------------------------------------------
# the whole model against the reference, unrolled and scanned
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[(a, u) for a in ARCHS
                                        for u in (True, False)],
                ids=lambda p: f"{p[0]}-{'unroll' if p[1] else 'scan'}")
def case(request):
    arch, unroll = request.param
    cfg_j = jax_get_config(arch, smoke=True)
    jm = JaxModel(cfg_j, peft="bea", unroll=unroll)
    base, tr, masks, rng = _perturbed(jm, 4)
    assert ("body" in base["dec"]) is not unroll
    jb, tb = _batch(rng, cfg_j.vocab_size)
    logits = jax.jit(lambda b, t, m, x: jm.forward(b, t, m, x, remat=False)[0])(
        base, tr, masks, jb)
    (total, (loss, aux)), grads = jax.jit(jax.value_and_grad(
        lambda t, b, m, x: jm.lm_loss(b, t, m, x, remat=False),
        has_aux=True))(tr, base, masks, jb)
    return dict(cfg=get_config(arch, smoke=True),
                trees=from_jax(_np(base), _np(tr), _np(masks)),
                grads=from_jax(_np(grads), None, None)[0], batch=tb,
                logits=np.asarray(logits), total=float(total),
                loss=float(loss), aux=float(aux))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_moe_logits_match_jax(case, use_kernels):
    base, tr, masks = case["trees"]
    cfg = case["cfg"]
    model = Model(cfg, peft="bea", use_kernels=use_kernels)
    assert model.pattern == ("moe",) * cfg.n_layers
    with torch.no_grad():
        logits = model.forward(base, tr, masks, case["batch"])
    assert logits.shape == (B, S, cfg.vocab_size)
    _close(logits.numpy(), case["logits"], "logits")


@pytest.mark.parametrize("use_kernels", [False, True])
def test_moe_lm_loss_aux_and_adapter_grads_match_jax(case, use_kernels):
    """(total, loss, aux) and every adapter grad (attention, router and
    per-expert w1/w3/w2) against ``jax.grad`` of the reference's
    ``lm_loss``; total = loss + router_aux_coef · aux with aux > 0."""
    base, tr, masks = case["trees"]
    cfg = case["cfg"]
    model = Model(cfg, peft="bea", use_kernels=use_kernels)
    total, loss, aux, got = _grads(model, base, tr, masks, case["batch"])
    _close(total.item(), case["total"], "total")
    _close(loss.item(), case["loss"], "loss")
    _close(aux.item(), case["aux"], "aux")
    assert aux.item() > 1.0              # E·Σ f·p̄ is 1 at perfect balance
    torch.testing.assert_close(total, loss + cfg.router_aux_coef * aux)
    want = dict(flatten_with_paths(case["grads"]))
    paths = flatten_with_paths(got)
    assert [p for p, _ in paths] == sorted(want)
    # 4 attention modules, the router and w1/w3/w2, three leaves each
    assert len(paths) == 3 * 8 * cfg.n_layers
    for path, g in paths:
        _close(g.numpy(), want[path].numpy(), path)
    layer = got["adapters"]["dec"]["layers"][0]["moe"]
    assert layer["w1"]["A"].shape == (cfg.n_experts, cfg.adapter_rank,
                                      cfg.d_model)


def test_masking_one_rank_zeroes_it_in_every_expert(case):
    """The (r,) mask of a per-expert module is shared by its experts: rank
    1, pruned by the fixture's masks, gets zero E, A and B grads in every
    expert, and moving its E leaves the loss as it was; an unmasked rank
    moves it."""
    base, tr, masks = case["trees"]
    model = Model(case["cfg"], peft="bea", use_kernels=False)
    assert masks["dec"]["layers"][0]["moe"]["w3"].shape == (
        case["cfg"].adapter_rank,)
    total, _, _, got = _grads(model, base, tr, masks, case["batch"])
    for name in ("w1", "w3", "w2"):
        g = got["adapters"]["dec"]["layers"][0]["moe"][name]
        assert not g["E"][:, 1].any() and not g["A"][:, 1].any()
        assert not g["B"][..., 1].any()
        assert g["E"][:, 0].abs().min() > 0          # every expert's rank 0
    with torch.no_grad():
        for rank, moves in ((1, False), (0, True)):
            tr2 = tree_map(lambda t: t.clone(), tr)
            tr2["adapters"]["dec"]["layers"][0]["moe"]["w3"]["E"][:, rank] += 5
            t2 = model.lm_loss(base, tr2, masks, case["batch"])[0]
            assert (t2.item() != total.item()) is moves, rank


def test_moe_five_train_steps_match_reference():
    cfg_j = jax_get_config(ARCHS[0], smoke=True)
    jm = JaxModel(cfg_j, peft="bea")
    base, tr = jm.init(jax.random.key(6))
    masks = jax.tree.map(lambda m: m.at[..., 0].set(False), jm.init_masks())
    n, b = 5, 2
    data = JS.make_lm_stream(n * b, cfg_j.vocab_size, S, seed=2)
    jstep = jax.jit(JST.make_train_step(
        jm, JOPT.adam(JOPT.linear_decay(3e-3, n)), Ctx(), task="lm"))
    tbase, ttr, tmasks = from_jax(_np(base), _np(tr), _np(masks))
    topt = TOPT.adam(TOPT.linear_decay(3e-3, n))
    tstep = TST.make_train_step(Model(get_config(ARCHS[0], smoke=True)),
                                topt, task="lm")
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
        _close(tmet["metric"].item(), float(jmet["metric"]), f"aux {i}",
               STEP_TOL)
    want = dict(flatten_with_paths(from_jax(_np(tr), None, None)[0]))
    got = flatten_with_paths(ttr)
    assert [p for p, _ in got] == sorted(want)
    for path, t in got:
        _close(t.numpy(), want[path].numpy(), path, STEP_TOL)


def test_route_replays_a_recorded_routing():
    """``record`` gets each MoE layer's top-k choice and dropped count;
    passing the choices back as ``route`` reproduces the loss and grads
    bit for bit, and another routing changes the loss."""
    cfg = get_config(ARCHS[0], smoke=True).with_(capacity_factor=DROPPING)
    model = Model(cfg, use_kernels=False)
    base, tr = model.init(0, "cpu")
    tr = tree_map(lambda t: t + 0.1, tr)
    masks = model.init_masks("cpu")
    _, tb = _batch(np.random.default_rng(2), cfg.vocab_size)
    rec = []
    total, _, aux, g = _grads(model, base, tr, masks, tb, record=rec)
    assert len(rec) == cfg.n_layers
    assert rec[0]["top_ids"].shape == (B * S, cfg.top_k)
    assert all(int(r["dropped"]) > 0 for r in rec)
    route = [r["top_ids"] for r in rec]
    total2, _, aux2, g2 = _grads(model, base, tr, masks, tb, route=route)
    assert total2.item() == total.item() and aux2.item() == aux.item()
    for (p, a), (_, b) in zip(flatten_with_paths(g), flatten_with_paths(g2)):
        assert torch.equal(a, b), p
    other = [r.flip(-1).roll(1, 0) for r in route]
    assert model.lm_loss(base, tr, masks, tb, route=other)[0].item() != \
        total.item()


# --------------------------------------------------------------------------
# the expert axis in CommPru, importance, FedARA and pruning
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def expert_trees():
    """Granite SMOKE's adapters (unrolled reference, so every mask is
    (r,)), off their init, with grads, and a global mask that prunes a
    per-expert module's ranks, the router's and one whole module."""
    jm = JaxModel(jax_get_config(ARCHS[0], smoke=True), peft="bea",
                  unroll=True)
    rng = np.random.default_rng(21)

    def fill(scale):
        return jax.tree.map(
            lambda m: rng.normal(size=m.shape).astype(np.float32) * scale,
            jm.adapter_meta(), is_leaf=lambda m: hasattr(m, "init"))

    ad, gr = fill(0.2), fill(1e-2)
    glob = jax.tree.map(np.array, jm.init_masks())
    glob["dec"]["tail"]["t0"]["moe"]["w1"][::2] = False
    glob["dec"]["tail"]["t0"]["moe"]["router"][1] = False
    glob["dec"]["tail"]["t1"]["moe"]["w2"][:] = False
    return dict(ad=ad, gr=gr, glob=glob)


def _port_masks(tree):
    return tree_map(lambda m: np.asarray(m, bool), bridge_tree(tree))


@pytest.mark.parametrize("method", ["mag", "grad", "mixed", "sensitivity"])
def test_expert_importance_matches_reference(expert_trees, method):
    """Per-expert modules score (r,): the expert axis averaged into the
    (layer, component) mask, as the reference's ``n_experts`` says; the
    port reads the expert axis off A's shape."""
    t = expert_trees
    want, jema = JIMP.score_tree(t["ad"], t["gr"], method, n_experts=4)
    got, ema = IMP.score_tree(bridge_tree(t["ad"]), bridge_tree(t["gr"]),
                              method)
    wflat = dict(flatten_with_paths(bridge_tree(_np(want))))
    gflat = flatten_with_paths(got)
    assert len(gflat) == len(wflat) == 2 * 8
    for path, s in gflat:
        np.testing.assert_array_equal(np.asarray(s), wflat[path].numpy())
    assert gflat[0][1].shape == (4,)


def test_fedara_local_masks_on_an_moe_tree_match_reference(expert_trees):
    t = expert_trees
    s, js = FedARA(), JFedARA(n_experts=4)
    n = 2 * 8 * 4
    for rnd in (0, 6, 40):
        want = js.local_masks(rnd, t["ad"], t["gr"], n)
        got = s.local_masks(rnd, bridge_tree(t["ad"]), bridge_tree(t["gr"]), n)
        wflat = dict(flatten_with_paths(bridge_tree(_np(want))))
        for path, m in flatten_with_paths(got):
            assert np.array_equal(np.asarray(m, bool), wflat[path].numpy()), \
                (rnd, path)


def test_expert_comm_and_pruning_match_reference(expert_trees):
    """Bytes, parameter counts (× experts), the wire's order (rank-major,
    each rank's experts in order), its inverse, the pruned tree, the gate
    and the live adapter FLOPs on per-expert modules."""
    ad, glob = expert_trees["ad"], expert_trees["glob"]
    tad, tglob = bridge_tree(ad), _port_masks(glob)
    for masks in (None, glob):
        tm = None if masks is None else _port_masks(masks)
        assert COMM.count_params(tad, tm) == JCOMM.count_params(ad, masks)
        assert COMM.bytes_down(tad, tm) == JCOMM.bytes_down(ad, masks)
        wire = COMM.pack(tad, tm)
        assert np.array_equal(wire, JCOMM.pack(ad, masks))
        back = COMM.unpack(wire, tad, tm)
        want = JCOMM.unpack(wire, ad, masks)
        wflat = dict(flatten_with_paths(bridge_tree(_np(want))))
        for path, v in flatten_with_paths(back):
            assert np.array_equal(v, wflat[path].numpy()), path
        assert PR.adapter_flops_per_token(tad, tm) == \
            JPR.adapter_flops_per_token(ad, masks)
    # unmasked, every rank of every expert travels: the whole tree
    assert COMM.count_params(tad) == PR.count_trainable(tad)
    pruned = dict(flatten_with_paths(COMM.prune_tree(tad, tglob)))
    wpruned = dict(flatten_with_paths(bridge_tree(_np(
        JCOMM.prune_tree(ad, glob)))))
    for path, v in pruned.items():
        assert np.array_equal(v.numpy(), wpruned[path].numpy()), path
    w1 = pruned["dec.layers.0.moe.w1.A"]
    assert not w1[:, ::2].any() and w1[:, 1::2].all()
    gate = PR.trainable_gate(tad, tglob)
    jgate = dict(flatten_with_paths(bridge_tree(_np(
        JPR.trainable_gate(ad, glob)))))
    for path, g in flatten_with_paths(gate):
        assert np.all(jgate[path].numpy() == float(g)), path
    assert PR.dead_modules(tglob) == ["dec.layers.1.moe.w2"]


# --------------------------------------------------------------------------
# the entry points
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_moe_serving_and_cohort_refuse_with_roadmap_pointer(arch):
    """MoE prefill and decode are serving work (ROADMAP.md queue 1 item
    13); the cohort's client-batched forward over an MoE block, which no
    runner of the reference reaches, refuses too."""
    cfg = get_config(arch, smoke=True)
    model = Model(cfg, use_kernels=False)
    base, tr = model.init(0, "cpu")
    toks = torch.zeros(1, 4, dtype=torch.long)
    for call in (lambda: model.cache_meta(1, 8),
                 lambda: model.prefill(base, tr, None, toks)):
        with pytest.raises(NotImplementedError, match="queue 1 item 13"):
            call()
    ctr = tree_map(lambda t: t[None], tr)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        model.lm_loss(base, ctr, None, {"tokens": toks[None],
                                        "targets": toks[None]}, clients=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TBK.block_apply(base["dec"]["layers"][0], torch.zeros(1, 1, 4, 128),
                        cfg, mode="train", kind="moe", clients=True)


def test_dense_blocks_return_a_zero_aux():
    cfg = get_config("qwen2_0p5b", smoke=True)
    p = materialize(TBK.block_meta(cfg, "attn"), 0, "cpu")
    x = torch.randn(1, 8, cfg.d_model)
    y, aux, cache = TBK.block_apply(p, x, cfg, mode="train", kind="attn")
    assert aux == 0.0 and cache is None and y.shape == x.shape


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_train_cli_runs_on_cpu_and_reports_aux(capsys, arch):
    out = TTR.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                    "3", "--seq", "32"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[1] for ln in lines[:-1]] == ["0", "1", "2"]
    for ln in lines[:-1]:
        words = ln.split()
        assert words[2] == "loss" and words[4] == "aux"
        assert 1.0 < float(words[5]) < 4.0
    assert lines[-1].startswith("done: 3 steps")
    assert len(out["aux"]) == 3 and all(a > 1.0 for a in out["aux"])
    assert all(np.isfinite(out["losses"]))
