"""Cohort and async federated runners (reference: ``repro/fedsim/runner.py``).

Two execution modes behind ``FedConfig.runner`` (the sequential oracle stays
in ``federated/server.py``):

  cohort  barrier-synchronous rounds whose local phase trains the whole
          cohort at once (``fedsim/cohort.py``: one forward, backward and
          Adam step over every client per local batch) with the weighted
          FedAvg on the device; dropout and straggler injection and a
          simulated wall clock from the per-device-class transport links.
          ``fuse_rounds > 1`` takes ``fedsim/fused.py``'s replayed rounds
          where the config allows.
  async   FedBuff-style buffered aggregation [Nguyen et al. 2022]: clients
          train against the global version they were dispatched with; the
          server aggregates every K arrivals with size·(1+staleness)^-α
          weights on the accumulated deltas.

Every randomness source is seeded — selection from ``fc.seed`` (the oracle's
stream), event times, dropout and stragglers from ``[event_seed, seed]`` —
so one (seed, event_seed) pair gives the same history and event log, draw
for draw the reference's.  Both runners send ``fedsim.pipeline.ClientUpdate``
deltas through the shared delta pipeline, the seq oracle's wire.  The
history is a ``repro_torch.obs.RunRecorder`` (the reference's round,
client and dispatch spans and the async event log on the trace when
tracing is on).
"""

from __future__ import annotations

import heapq
import time
from typing import Callable

import numpy as np

from repro_torch import obs as OBS
from repro_torch.core import comm as COMM
from repro_torch.core import masks as MK
from repro_torch.core import pruning as PR
from repro_torch.data.synthetic import Dataset, batches
from repro_torch.device import resolve_device
from repro_torch.federated import client as CL
from repro_torch.federated import devices as DV
from repro_torch.federated import server as SV
from repro_torch.fedsim import cohort as CH
from repro_torch.fedsim import pipeline as PL
from repro_torch.fedsim import transport as T
from repro_torch.pytree import tree_map
from repro_torch.secagg import protocol as SA

device_of = DV.device_of          # shared client→device-class assignment


def _compute_s(cid: int, fc, n_batches: int, slow: float = 1.0) -> float:
    return DV.compute_s(cid, fc.device_profile, n_batches, slow)


def _event_rng(fc) -> np.random.Generator:
    return np.random.default_rng([fc.event_seed, fc.seed])


def _n_local_batches(n: int, fc) -> int:
    """Exact per-client local step count (mirrors data.synthetic.batches)."""
    per_epoch = n // fc.batch_size if n >= fc.batch_size else 1
    return min(fc.max_local_batches * fc.local_epochs,
               per_epoch * fc.local_epochs)


def _local_batches(train, parts, fc, stream_no: int, cid: int):
    """The oracle's batch stream of one client (``stream_no`` is the round,
    or for async the dispatch number, as in the reference)."""
    idx = parts[cid]
    return SV._take(
        batches(Dataset(train.tokens[idx], train.labels[idx]),
                fc.batch_size, CH.client_batch_rng(fc.seed, stream_no, cid),
                epochs=fc.local_epochs),
        fc.max_local_batches * fc.local_epochs)


def run(model, strategy, parts, train, test, fc,
        on_round: Callable | None = None, device=None, params=None) -> dict:
    if fc.runner == "async":
        return run_async(model, strategy, parts, train, test, fc, on_round,
                         device, params)
    if fc.runner == "cohort":
        return run_cohort(model, strategy, parts, train, test, fc, on_round,
                          device, params)
    raise ValueError(f"unknown runner {fc.runner!r} (seq|cohort|async)")


# ---------------------------------------------------------------------------
# cohort: barrier-sync rounds, one forward over the cohort per local step
# ---------------------------------------------------------------------------

def run_cohort(model, strategy, parts, train, test, fc,
               on_round: Callable | None = None, device=None,
               params=None) -> dict:
    device = resolve_device(device)
    if fc.fuse_rounds > 1:
        # the fused fast path (fedsim/fused.py); anything that needs host
        # work between rounds takes the eager loop below
        from repro_torch.fedsim import fused as FU
        ok, why = FU.eligible(fc, strategy, parts)
        if ok:
            return FU.run_fused(model, strategy, parts, train, test, fc,
                                on_round, device, params)
        OBS.get_tracer().event("fused_fallback", reason=why)
    base, trainable, masks, masks_np, n_rank_units, opt, rng = \
        SV._init_run(model, strategy, fc, device, params)
    step_fn = CL.make_train_step(model, opt, fc.task)     # ragged fallback
    cohort_fn = CH.make_cohort_fn(model, opt, fc.task)
    # one card holds the cohort: the reference pads it to a multiple of its
    # device count, here 1
    c_pad = min(fc.clients_per_round, len(parts))

    pipe = PL.UploadPipeline(fc, strategy)
    ev_rng = _event_rng(fc)
    private = SA.wants_private(fc)
    accountant = SV.make_accountant(fc, len(parts))

    history = OBS.RunRecorder("cohort", fc,
                              extra_keys=("secagg_rounds", "dp_eps"))
    t0 = time.perf_counter()

    s1_rounds = (strategy.stage1_rounds(fc.rounds)
                 if hasattr(strategy, "stage1_rounds") else 0)
    if s1_rounds:
        base, trainable = SV._run_stage1(model, strategy, base, trainable,
                                         parts, train, fc, opt, rng, history,
                                         device, accountant)

    for rnd in range(s1_rounds, fc.rounds):
        rsp = history.begin_round(rnd)
        sel = rng.choice(len(parts), size=c_pad, replace=False)
        # ---- CommPru'd broadcast (delta-coded when a codec is on) --------
        if masks_np is not None:
            trainable = dict(trainable,
                             adapters=COMM.prune_tree(trainable["adapters"],
                                                      masks_np))
        bc, down_per = pipe.broadcast(trainable, masks_np)
        down = down_per * len(sel)
        gate = strategy.optimizer_gate(bc, masks_np)

        # ---- dropout / straggler draws (fixed order → determinism) ------
        drops = ev_rng.random(len(sel)) < fc.dropout
        slows = np.where(ev_rng.random(len(sel)) < fc.straggler,
                         fc.straggler_slow, 1.0)
        active = [int(c) for c, d in zip(sel, drops) if not d]

        # ---- local phase: the whole cohort at once ------------------------
        cohort = CH.build_cohort(train, parts, active, fc, rnd, c_pad,
                                 bucket=fc.rebucket)
        avg, cohort_idx = None, {}
        if cohort is not None:
            stacked = CH.stack_params(bc, len(cohort.weights))
            inputs = CH.device_inputs(cohort.batches, cohort.step_mask,
                                      cohort.weights, device)
            # dispatch span keyed by the shapes the cohort step runs over;
            # its device losses ride it unresolved (one pull at close)
            tr = OBS.get_tracer()
            dsp = tr.begin("cohort_dispatch", kind="dispatch")
            if tr.enabled:
                from repro_torch.obs import profile as PROF
                dsp.set(sig=PROF.shape_signature(
                    stacked, cohort.batches, cohort.step_mask,
                    cohort.weights))
            with OBS.annotate("cohort_dispatch"):
                pc, gc, lc, mc, avg = cohort_fn(base, stacked, masks, gate,
                                                *inputs)
            if tr.enabled:
                dsp.lazy("loss_sum", lc.sum())
            dsp.end()
            cohort_idx = {cid: i for i, cid in enumerate(cohort.cids)}
            # ONE device→host copy of everything the host path reads; the
            # per-client params, grads and deltas below are host slices
            pull = {"pc": pc, "bc": bc, "lc": lc, "mc": mc}
            if strategy.uses_masks():
                pull["gc"] = gc
            host = PL.to_host(pull)
            lc, mc = host["lc"], host["mc"]
            dc = tree_map(lambda p, b: p - b[None], host["pc"], host["bc"])

        results, local_masks, encoded = [], [], []
        up = 0
        for cid in active:
            csp = history.begin_client(cid)
            if cid in cohort_idx:
                i = cohort_idx[cid]
                sm = cohort.step_mask[i]
                params_k = CH.slice_client(host["pc"], i)
                grads_k = CH.slice_client(host["gc"], i) \
                    if "gc" in host else None
                delta_k = CH.slice_client(dc, i)
                m = {"loss": float(np.mean(lc[i][sm])) if sm.any()
                     else float("nan"),
                     "metric": float(np.mean(mc[i][sm])) if sm.any()
                     else float("nan"),
                     "n_batches": int(cohort.n_steps[i])}
                w = float(cohort.weights[i])
            else:                                   # ragged client → oracle
                params_k, grads_k, m = CL.local_train(
                    step_fn, base, bc, masks, gate, opt,
                    _local_batches(train, parts, fc, rnd, cid), device)
                delta_k = PL.delta_tree(params_k, bc)
                w = float(len(parts[cid]))
            lm = None
            if strategy.uses_masks():
                lm = strategy.local_masks(
                    rnd, params_k["adapters"],
                    (grads_k or {}).get("adapters"), n_rank_units)
                local_masks.append(lm)
            enc = pipe.encode(PL.ClientUpdate(int(cid), delta_k, weight=w,
                                              votes=lm,
                                              n_steps=m["n_batches"]),
                              masks_np)
            up += enc.nbytes
            encoded.append(enc)
            results.append((w, m))
            csp.end(n_steps=m["n_batches"], up_bytes=enc.nbytes,
                    loss=m["loss"])

        # ---- aggregation: the on-device FedAvg unless a side path runs ---
        protocol_s = 0.0
        if private:
            # secagg / DP: masked field aggregation with dropout recovery
            trainable, masks, masks_np, agg = SV._private_round(
                strategy, bc, encoded, sel, masks, masks_np, fc, rnd,
                history, accountant, pipe, device)
            up = agg.up_bytes + sum(e.nbytes for e in encoded)
            down += agg.down_bytes
            protocol_s = agg.time_s
        elif results:
            if pipe.codec is None and cohort is not None \
                    and not cohort.fallback:
                # identity wire: the on-device FedAvg equals the pipeline's
                # delta-space mean (Σŵ(bc+Δ) = bc + ΣŵΔ)
                trainable = avg
            else:
                trainable = pipe.aggregate(bc, encoded, rnd=rnd)
            trainable, masks, masks_np = SV._arbitrate(
                strategy, trainable, local_masks, masks, masks_np, rnd,
                device)
        SV.record_ranks(history, rnd, masks_np, local_masks)

        # ---- simulated wall clock (barrier = slowest surviving client) --
        enc_of = {e.cid: e for e in encoded}
        costs = []
        for k, cid in enumerate(sel):
            if drops[k]:
                continue
            cid = int(cid)
            costs.append(pipe.client_time(
                cid, down_per, enc_of[cid].nbytes,
                _compute_s(cid, fc, enc_of[cid].n_steps, slows[k])))
        SV.stamp_costs(rsp, costs)
        history.add_sim((max(costs) if costs else 0.0) + protocol_s)

        live = int(MK.count_true(masks_np)) if masks_np else n_rank_units
        n_dead = len(PR.dead_modules(masks_np)) if masks_np else 0
        loss = (float(np.mean([r[1]["loss"] for r in results]))
                if results else float("nan"))
        log = SV.RoundLog(rnd, int(down), int(up), live,
                          dead_modules=n_dead,
                          trainable_params=PR.count_trainable(trainable),
                          loss=loss, sim_time_s=history["sim_time_s"])
        if (rnd + 1) % fc.eval_every == 0 or rnd == fc.rounds - 1:
            log.acc = SV.evaluate(model, base, trainable, masks, test, fc,
                                  device)
            history["acc"].append((rnd, log.acc))
        history.end_round(rsp, log, down, up)
        if on_round:
            on_round(rnd, log)

    return SV.finish(history, base, trainable, masks_np, t0, device, fc,
                     accountant)


# ---------------------------------------------------------------------------
# async: FedBuff-style buffered aggregation on a simulated event clock
# ---------------------------------------------------------------------------

def run_async(model, strategy, parts, train, test, fc,
              on_round: Callable | None = None, device=None,
              params=None) -> dict:
    device = resolve_device(device)
    base, trainable, masks, masks_np, n_rank_units, opt, rng = \
        SV._init_run(model, strategy, fc, device, params)
    step_fn = CL.make_train_step(model, opt, fc.task)
    pipe = PL.UploadPipeline(fc, strategy)
    ev_rng = _event_rng(fc)

    history = OBS.RunRecorder("async", fc, extra_keys=("events",))
    t0 = time.perf_counter()

    s1_rounds = (strategy.stage1_rounds(fc.rounds)
                 if hasattr(strategy, "stage1_rounds") else 0)
    if s1_rounds:
        base, trainable = SV._run_stage1(model, strategy, base, trainable,
                                         parts, train, fc, opt, rng, history,
                                         device)

    buffer_k = fc.buffer_k or min(fc.clients_per_round, len(parts))
    concurrency = fc.async_concurrency or 2 * buffer_k
    version = s1_rounds                   # server model version = agg round
    heap: list = []                       # (finish_t, seq, cid, dropped)
    stash: dict = {}                      # seq -> dispatch snapshot
    buffer: list = []                     # pending (enc, params, grads, m)
    seq_no = 0
    pend_down = pend_up = 0

    def dispatch(now: float):
        nonlocal seq_no, pend_down
        cid = int(rng.integers(len(parts)))
        dropped = bool(ev_rng.random() < fc.dropout)
        slow = (fc.straggler_slow if ev_rng.random() < fc.straggler else 1.0)
        # per-client DeltaChannel: a stale client's broadcast stream is
        # delta-coded against *its own* last reconstruction
        bc, down = pipe.broadcast(trainable, masks_np, endpoint=cid)
        pend_down += down
        n_b = _n_local_batches(len(parts[cid]), fc)
        link = T.link_for(device_of(cid))
        # upload size is only known post-encode; model it as symmetric
        finish_t = (now + link.transfer_s(down)
                    + _compute_s(cid, fc, n_b, slow) + link.transfer_s(down))
        gate = strategy.optimizer_gate(bc, masks_np)
        if not dropped:
            stash[seq_no] = (bc, masks, masks_np, gate, version)
        heapq.heappush(heap, (finish_t, seq_no, cid, dropped))
        history.async_event(now, "dispatch", cid=cid, version=version,
                            dropped=dropped)
        seq_no += 1

    for _ in range(concurrency):
        dispatch(0.0)

    agg = version
    max_events = (fc.rounds - s1_rounds) * buffer_k * 50 + 1000
    n_events = 0
    while agg < fc.rounds and heap and n_events < max_events:
        n_events += 1
        now, sq, cid, dropped = heapq.heappop(heap)
        if dropped:
            dispatch(now)
            continue
        bc, d_masks, d_masks_np, gate, d_version = stash.pop(sq)
        # the dispatch number stands in the batch stream's round slot, as
        # in the reference
        params_k, grads_k, m = CL.local_train(
            step_fn, base, bc, d_masks, gate, opt,
            _local_batches(train, parts, fc, sq, cid), device)
        staleness = version - d_version
        w = len(parts[cid]) * (1.0 + staleness) ** -fc.staleness_alpha
        upd = PL.ClientUpdate(cid, PL.delta_tree(params_k, bc), weight=w,
                              n_steps=m["n_batches"],
                              staleness=float(staleness))
        enc = pipe.encode(upd, d_masks_np)
        pend_up += enc.nbytes
        buffer.append((enc, params_k, grads_k, m))
        history.async_event(now, "update", cid=cid, version=d_version)
        dispatch(now)

        if len(buffer) >= buffer_k:
            # ---- staleness-weighted buffered aggregation -----------------
            # (deltas were encoded against per-dispatch masks; averaging in
            # tree space keeps stale and fresh contributions aligned)
            rsp = history.begin_round(agg)
            trainable = pipe.aggregate(trainable, [b[0] for b in buffer],
                                       rnd=agg)
            local_masks = []
            if strategy.uses_masks():
                for _, pk, gk, _ in buffer:
                    local_masks.append(strategy.local_masks(
                        agg, pk["adapters"], (gk or {}).get("adapters"),
                        n_rank_units))
            trainable, masks, masks_np = SV._arbitrate(
                strategy, trainable, local_masks, masks, masks_np, agg,
                device)
            SV.record_ranks(history, agg, masks_np, local_masks)
            live = (int(MK.count_true(masks_np)) if masks_np
                    else n_rank_units)
            n_dead = len(PR.dead_modules(masks_np)) if masks_np else 0
            history.set_sim(now)
            log = SV.RoundLog(
                agg, int(pend_down), int(pend_up), live,
                dead_modules=n_dead,
                trainable_params=PR.count_trainable(trainable),
                loss=float(np.mean([b[3]["loss"] for b in buffer])),
                sim_time_s=now,
                staleness=float(np.mean([b[0].staleness for b in buffer])))
            b_down, b_up = pend_down, pend_up
            pend_down = pend_up = 0
            if (agg + 1) % fc.eval_every == 0 or agg == fc.rounds - 1:
                log.acc = SV.evaluate(model, base, trainable, masks, test,
                                      fc, device)
                history["acc"].append((agg, log.acc))
            history.end_round(rsp, log, b_down, b_up)
            if on_round:
                on_round(agg, log)
            buffer.clear()
            version += 1
            agg += 1

    # in-flight broadcasts were transmitted even if never aggregated
    history.inflight_comm(pend_down, pend_up)
    return SV.finish(history, base, trainable, masks_np, t0, device, fc)
