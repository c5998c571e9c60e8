"""Client cohorts (reference: ``repro/fedsim/cohort.py``).

The sequential oracle (``federated/server.py``) trains each selected client
in turn: ``clients_per_round × local_batches`` forwards a round.  Here a
round's local phase is one forward, backward and Adam step per local batch
over every client of the cohort at once:

  - per-client params and optimizer states are stacked on a leading cohort
    axis, and the model runs with ``clients=True`` (the base shared, every
    adapted linear one client-grouped ``bea_dense`` call), as the
    reference ``vmap``s its local phase over clients;
  - the local steps are a host loop (the reference's ``lax.scan``); uneven
    client data is padded, and a padded step computes and then discards
    (``torch.where`` on the step's live mask), so real steps do exactly
    what the oracle's do;
  - FedAvg is the weighted f32 sum over the cohort axis divided by the
    weight total; weight-0 (padding) slots drop out.

One card holds the whole cohort, so nothing is sharded: the reference's
``shard_map`` over devices and its ``psum`` become this single weighted sum
(sharding the cohort over several cards waits for ROADMAP.md queue 1 item
14).  Clients whose data is smaller than one batch cannot join the
rectangle; ``build_cohort`` reports them as fallbacks and the runner routes
them through the oracle's per-client path.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any

import numpy as np
import torch

from repro_torch.data.synthetic import Dataset, batches as batch_iter
from repro_torch.federated import client as CL
from repro_torch.pytree import tree_map


def client_batch_rng(seed: int, rnd: int, cid: int) -> np.random.Generator:
    """The per-(seed, round, client) batch-order stream the reference's
    runners share."""
    return np.random.default_rng(seed * 1000 + rnd * 97 + int(cid))


@dataclasses.dataclass
class Cohort:
    """Host-side rectangle of one round's local datasets."""
    batches: dict                 # key -> (C, T, B, ...) np arrays
    step_mask: np.ndarray         # (C, T) bool — False for padded steps
    weights: np.ndarray           # (C,) f32 client data sizes (0 = pad slot)
    cids: list[int]               # real client ids, stacked order
    fallback: list[int]           # too-small clients → sequential path
    n_steps: np.ndarray           # (C,) int — real local steps per client


def build_cohort(train: Dataset, parts: list[np.ndarray], sel, fc, rnd: int,
                 pad_clients_to: int, bucket: bool = False) -> Cohort | None:
    """Materialize the selected clients' local batches into a padded
    rectangle, from the same batch streams as the sequential oracle.

    ``bucket=True`` re-buckets the step axis per round: T is the next power
    of two ≥ this cohort's real maximum step count instead of the global
    ``max_local_batches × local_epochs`` ceiling.
    """
    T = fc.max_local_batches * fc.local_epochs
    raw, weights, cids, fallback = [], [], [], []
    for cid in sel:
        idx = parts[cid]
        cd = Dataset(train.tokens[idx], train.labels[idx])
        gen = batch_iter(cd, fc.batch_size,
                         client_batch_rng(fc.seed, rnd, cid),
                         epochs=fc.local_epochs)
        bl = list(itertools.islice(gen, T))
        if not bl or any(v.shape[0] != fc.batch_size
                         for b in bl for v in b.values()):
            fallback.append(int(cid))
            continue
        raw.append(bl)
        weights.append(float(len(idx)))
        cids.append(int(cid))
    if not raw:
        return None
    if bucket:
        T = min(T, 1 << (max(len(bl) for bl in raw) - 1).bit_length())
    stacked, smask, nsteps = [], [], []
    for bl in raw:
        m = np.zeros(T, bool)
        m[:len(bl)] = True
        bl = bl + [bl[0]] * (T - len(bl))
        stacked.append({k: np.stack([b[k] for b in bl]) for k in bl[0]})
        smask.append(m)
        nsteps.append(int(m.sum()))
    C = max(pad_clients_to, len(stacked))
    while len(stacked) < C:                     # dead slots: weight 0, no steps
        stacked.append(stacked[0])
        smask.append(np.zeros(T, bool))
        weights.append(0.0)
        nsteps.append(0)
    return Cohort(
        batches={k: np.stack([s[k] for s in stacked]) for k in stacked[0]},
        step_mask=np.stack(smask), weights=np.asarray(weights, np.float32),
        cids=cids, fallback=fallback, n_steps=np.asarray(nsteps))


def device_inputs(batches: dict, step_mask: np.ndarray, weights: np.ndarray,
                  device) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """A cohort's (or a block of cohorts') batches as int64, step mask and
    weights on ``device``."""
    return ({k: torch.as_tensor(v, device=device).long()
             for k, v in batches.items()},
            torch.as_tensor(step_mask, device=device),
            torch.as_tensor(weights, device=device))


def stack_params(trainable: Any, n: int) -> Any:
    """n per-client copies of the (pruned) global trainable, stacked on a
    new leading axis."""
    return tree_map(lambda x: x[None].expand((n,) + tuple(x.shape)).clone(),
                    trainable)


def slice_client(tree_c: Any, i: int) -> Any:
    """One client's slice of a stacked tree."""
    return tree_map(lambda x: x[i], tree_c)


def _keep(live: torch.Tensor):
    """Per-client select: a live client's new value, else its old one."""
    def f(new, old):
        return torch.where(live.view((-1,) + (1,) * (new.ndim - 1)), new, old)
    return f


def make_local_phase(model, opt, task: str = "cls"):
    """The whole cohort's local-training phase: the inner loop of
    ``make_cohort_fn`` and of the fused round (``fedsim/fused.py``).

    ``local_phase(base, params0, masks, gate, bstack, smask) → (params,
    grads, losses, metrics)``: params0 stacked (C, …); bstack {key: (C, T,
    B, …)}; smask (C, T) bool on the device; losses and metrics (C, T).  The
    optimizer state is made anew on every call, as in the reference, so the
    step counter runs 1..T and every client's real steps come first.
    """
    step_fn = CL.make_train_step(model, opt, task, clients=True)

    def local_phase(base, params0, masks, gate, bstack, smask):
        opt_state = opt.init(params0, clients=True)
        # fused.py bakes the schedule and bias corrections of steps 1..T
        # into its graph: right only because every call starts at step 0
        assert opt_state["step"] == 0
        grads = tree_map(torch.zeros_like, params0)
        params = params0
        losses, metrics = [], []
        for t in range(smask.shape[1]):
            batch = {k: v[:, t] for k, v in bstack.items()}
            new_p, new_s, g, _, loss, metric = step_fn(
                base, params, opt_state, masks, gate, batch)
            keep = _keep(smask[:, t])
            params = tree_map(keep, new_p, params)
            opt_state = {"step": new_s["step"],
                         "mu": tree_map(keep, new_s["mu"], opt_state["mu"]),
                         "nu": tree_map(keep, new_s["nu"], opt_state["nu"])}
            grads = tree_map(keep, g, grads)
            losses.append(loss)
            metrics.append(metric)
        return params, grads, torch.stack(losses, 1), torch.stack(metrics, 1)

    return local_phase


def cohort_avg(params_c: Any, weights: torch.Tensor, carry: Any = None
               ) -> Any:
    """Weighted f32 FedAvg over the cohort axis, Σ wᵢ·pᵢ / Σ wᵢ, cast back
    to each leaf's dtype.  With ``carry`` (the fused round), a round whose
    weights sum to 0 (every client dropped) keeps the carry instead."""
    tot = tree_map(lambda p: torch.tensordot(weights, p.float(), dims=1),
                   params_c)
    wtot = weights.sum()
    if carry is None:
        return tree_map(lambda s, p: (s / wtot).to(p.dtype), tot, params_c)
    safe = torch.where(wtot > 0, wtot, torch.ones_like(wtot))
    return tree_map(lambda s, c: torch.where(wtot > 0, s / safe, c.float())
                    .to(c.dtype), tot, carry)


def make_cohort_fn(model, opt, task: str = "cls"):
    """The cohort round: ``fn(base, stacked, masks, gate, bstacks, smasks,
    weights) → (params_c, grads_c, losses_c, metrics_c, avg)``, where the
    ``_c`` outputs carry the cohort axis and ``avg`` is the weighted FedAvg
    of the final per-client params."""
    local_phase = make_local_phase(model, opt, task)

    def fn(base, stacked, masks, gate, bstacks, smasks, weights):
        params_c, grads_c, losses_c, metrics_c = local_phase(
            base, stacked, masks, gate, bstacks, smasks)
        return (params_c, grads_c, losses_c, metrics_c,
                cohort_avg(params_c, weights))

    return fn
