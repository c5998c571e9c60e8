"""Fused multi-round cohort training (reference: ``repro/fedsim/fused.py``).

The eager cohort runner (``fedsim/runner.py``) goes back to the host after
every round to feed the upload pipeline.  On the *fast path* — identity
codec, no privacy, no ragged clients, no per-round mask pruning — none of
that host work changes the params trajectory: the on-device FedAvg already
equals the pipeline's delta-space mean, byte accounting is shape-only, and
client selection, dropout and straggler draws are host RNG streams that can
be drawn ahead.  So rounds run in blocks of up to K:

  - one cohort round (C clients × T local steps, then the weighted FedAvg
    with the ``wtot > 0`` guard, into the carry) is captured once per run as
    a CUDA graph and replayed once per round of a block; the carry and the
    batch, step-mask and weight buffers are static tensors, refilled with
    ``copy_`` from the block's inputs, which cross to the card in one copy;
  - selection and the dropout/straggler draws are made on the host ahead,
    consuming ``rng``/``ev_rng`` in exactly the eager order;
  - nothing in a block reads the device: the block's (K, C, T) losses come
    back in one copy after it, and the byte, clock and eval bookkeeping is
    replayed from them in the eager runner's float order.

Blocks never cross an eval boundary (eval reads the carry).  The captured
round bakes in the schedule and Adam's bias corrections of local steps
1..T: right because every round starts its optimizer anew at step 0
(``cohort.make_local_phase`` asserts it).  The wrappers count their launches
when the round is captured, not when it is replayed: the history's
``graph`` entry holds the launches of one capture and the replay count.  On
the CPU the same round body runs eagerly.

Tracing (``repro_torch.obs``): each block runs inside one ``dispatch``
span (its first round as ``rnd``, its shape signature as ``sig``); the
capture records a ``graph_capture`` compile span under it; the block is
then replayed into the recorder as the eager runner records it — round
and client spans, the exact bytes and clock — as the reference's
``fused.py`` does.

``run_cohort`` routes here when ``fc.fuse_rounds > 1`` and ``eligible``
says the config has no per-round host work; otherwise it runs eagerly.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch import kernels as K
from repro_torch import obs as OBS
from repro_torch.core import pruning as PR
from repro_torch.federated import server as SV
from repro_torch.fedsim import cohort as CH
from repro_torch.fedsim import pipeline as PL
from repro_torch.pytree import leaves, tree_map


def eligible(fc, strategy, parts) -> tuple[bool, str]:
    """Can this config run the fused fast path?  → (ok, reason-if-not).

    Anything that needs host work *between* rounds disqualifies: codecs and
    privacy touch the per-client wire, rank-mask strategies re-prune the
    trainable structure, SLoRA's stage 1 precedes the main loop, ragged
    (sub-batch) clients route through the sequential oracle, and re-bucketing
    intentionally varies the rectangle shape per round.
    """
    if fc.codec != "identity":
        return False, f"codec {fc.codec!r} encodes per-client wires on host"
    if fc.secagg != "off":
        return False, "secagg runs a host-side masked-sum protocol"
    if fc.dp_clip > 0 or fc.dp_noise_multiplier > 0:
        return False, "DP clips/noises per-client wires on host"
    if strategy.uses_masks():
        return False, f"strategy {strategy.name!r} re-prunes rank masks " \
                      "every round"
    if getattr(strategy, "stage1_rounds", None) is not None \
            and strategy.stage1_rounds(fc.rounds) > 0:
        return False, f"strategy {strategy.name!r} runs host-side stage-1 " \
                      "rounds"
    if fc.rebucket:
        return False, "re-bucketing varies the cohort rectangle per round"
    small = [i for i, p in enumerate(parts) if len(p) < fc.batch_size]
    if small:
        return False, f"{len(small)} sub-batch clients need the " \
                      "sequential fallback"
    return True, ""


def _block_rounds(rnd: int, k: int, fc) -> list[int]:
    """Rounds [rnd, ...] of the next block: at most k, never crossing an
    eval boundary (eval round r satisfies (r+1) % eval_every == 0) or the
    end of the run — eval needs the carry."""
    ev_r = fc.eval_every * (-(-(rnd + 1) // fc.eval_every)) - 1
    return list(range(rnd, min(rnd + k - 1, ev_r, fc.rounds - 1) + 1))


class CohortRound:
    """One cohort round on static buffers: ``run()`` trains the clients in
    ``batches``/``smask`` from the carry and writes the weighted FedAvg back
    into the carry (kept where every weight is 0), returning the (C, T)
    losses.  On the card the first ``run`` captures the round as a CUDA graph
    (after a warm-up on a side stream, with the carry put back) and every
    ``run`` replays it; on the CPU ``run`` is the eager body."""

    def __init__(self, model, opt, base, carry, masks, gate, batches: dict,
                 smask: torch.Tensor, weights: torch.Tensor,
                 task: str = "cls"):
        self.local_phase = CH.make_local_phase(model, opt, task)
        self.base, self.carry, self.masks, self.gate = base, carry, masks, gate
        self.batches, self.smask, self.weights = batches, smask, weights
        self.graph = None
        self.losses = None
        self.captures = 0
        self.replays = 0
        self.capture_launches: dict[str, int] = {}

    def body(self) -> torch.Tensor:
        stacked = CH.stack_params(self.carry, self.smask.shape[0])
        params_c, _, losses, _ = self.local_phase(
            self.base, stacked, self.masks, self.gate, self.batches,
            self.smask)
        new = CH.cohort_avg(params_c, self.weights, carry=self.carry)
        for dst, src in zip(leaves(self.carry), leaves(new)):
            dst.copy_(src)
        return losses

    def run(self) -> torch.Tensor:
        if self.smask.device.type != "cuda":
            return self.body()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.replays += 1
        return self.losses

    def _capture(self) -> None:
        saved = [t.clone() for t in leaves(self.carry)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):           # autograd's warm-up
            for _ in range(2):
                self.body()
        torch.cuda.current_stream().wait_stream(side)
        for dst, src in zip(leaves(self.carry), saved):
            dst.copy_(src)
        before = K.launch_counts()
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):      # raises if capture fails
            self.losses = self.body()
        self.capture_launches = {k: v - before[k]
                                 for k, v in K.launch_counts().items()}
        self.captures += 1
        from repro_torch.obs import profile as PROF
        PROF.compile_span("graph_capture", time.perf_counter() - t0,
                          launches=dict(self.capture_launches))


def run_fused(model, strategy, parts, train, test, fc,
              on_round: Callable | None = None, device=None,
              params=None) -> dict:
    """Fused twin of ``runner.run_cohort`` — same RNG streams, same history,
    rounds in blocks of ``fc.fuse_rounds``.  Callers have checked
    ``eligible`` (no codec/privacy/mask/ragged host work exists)."""
    from repro_torch.fedsim.runner import _compute_s, _event_rng

    base, trainable, masks, masks_np, n_rank_units, opt, rng = \
        SV._init_run(model, strategy, fc, device, params)
    cpr = min(fc.clients_per_round, len(parts))
    k_max = max(1, int(fc.fuse_rounds))

    pipe = PL.UploadPipeline(fc, strategy)
    ev_rng = _event_rng(fc)
    history = OBS.RunRecorder("cohort", fc,
                              extra_keys=("secagg_rounds", "dp_eps"))
    t0 = time.perf_counter()

    gate = strategy.optimizer_gate(trainable, masks_np)
    # shape-only byte accounting (identity codec): constant across rounds
    up_per = strategy.comm_up(trainable, masks_np)
    # the carry is the run's own: the caller's weights are never written
    trainable = tree_map(torch.clone, trainable)
    rounder = None

    rnd = 0
    while rnd < fc.rounds:
        block = _block_rounds(rnd, k_max, fc)

        # ---- host precompute: selection + event draws in eager RNG order --
        sels, dropss, slowss, cohorts = [], [], [], []
        for r in block:
            sel = rng.choice(len(parts), size=cpr, replace=False)
            drops = ev_rng.random(len(sel)) < fc.dropout
            slows = np.where(ev_rng.random(len(sel)) < fc.straggler,
                             fc.straggler_slow, 1.0)
            active = [int(c) for c, d in zip(sel, drops) if not d]
            sels.append(sel)
            dropss.append(drops)
            slowss.append(slows)
            cohorts.append(CH.build_cohort(train, parts, active, fc, r, cpr))

        tmpl = next((c for c in cohorts if c is not None), None)
        if tmpl is not None:
            # an all-dropped round runs on the template's batches with every
            # step masked and weight 0: the guard keeps the carry
            dead_m = np.zeros_like(tmpl.step_mask)
            dead_w = np.zeros_like(tmpl.weights)
            rows = [(c.batches, c.step_mask, c.weights) if c is not None
                    else (tmpl.batches, dead_m, dead_w) for c in cohorts]
            bst, sms, wts = CH.device_inputs(       # one copy each
                {k: np.stack([b[k] for b, _, _ in rows])
                 for k in tmpl.batches},
                np.stack([m for _, m, _ in rows]),
                np.stack([w for _, _, w in rows]), device)
            if rounder is None:
                rounder = CohortRound(
                    model, opt, base, trainable, masks, gate,
                    {k: torch.empty_like(v[0]) for k, v in bst.items()},
                    torch.empty_like(sms[0]), torch.empty_like(wts[0]),
                    fc.task)
            tr = OBS.get_tracer()
            dsp = tr.begin("cohort_dispatch", kind="dispatch",
                           fused=len(block), rnd=block[0])
            if tr.enabled:
                from repro_torch.obs import profile as PROF
                dsp.set(sig=PROF.shape_signature(trainable, bst, sms, wts))
            lbuf = []
            with OBS.annotate("cohort_dispatch"):
                for j in range(len(block)):
                    for k, v in bst.items():
                        rounder.batches[k].copy_(v[j])
                    rounder.smask.copy_(sms[j])
                    rounder.weights.copy_(wts[j])
                    lbuf.append(rounder.run().clone())
            dsp.end()
            # ONE device→host copy for the whole block's losses
            lc = torch.stack(lbuf).float().cpu().numpy()

        # ---- replay the block into the recorder (eager span/float order) --
        met = OBS.get_metrics()
        for j, r in enumerate(block):
            rsp = history.begin_round(r)
            _, down_per = pipe.broadcast(trainable, masks_np)
            down = down_per * len(sels[j])
            cohort = cohorts[j]
            up = 0
            losses = []
            if cohort is not None:
                for i, cid in enumerate(cohort.cids):
                    csp = history.begin_client(cid)
                    loss_i = float(np.mean(lc[j][i][cohort.step_mask[i]]))
                    losses.append(loss_i)
                    up += up_per
                    if met.enabled:
                        met.counter("pipeline.up_bytes", codec=fc.codec,
                                    stage="stage2").inc(int(up_per))
                        met.counter("pipeline.updates", codec=fc.codec,
                                    stage="stage2").inc()
                    csp.end(n_steps=int(cohort.n_steps[i]),
                            up_bytes=int(up_per), loss=loss_i)
            costs = []
            if cohort is not None:
                idx_of = {cid: i for i, cid in enumerate(cohort.cids)}
                for k, cid in enumerate(sels[j]):
                    if dropss[j][k]:
                        continue
                    cid = int(cid)
                    costs.append(pipe.client_time(
                        cid, down_per, up_per,
                        _compute_s(cid, fc,
                                   int(cohort.n_steps[idx_of[cid]]),
                                   slowss[j][k])))
            SV.stamp_costs(rsp, costs)
            history.add_sim(max(costs) if costs else 0.0)

            loss = float(np.mean(losses)) if losses else float("nan")
            log = SV.RoundLog(r, int(down), int(up), n_rank_units,
                              dead_modules=0,
                              trainable_params=PR.count_trainable(trainable),
                              loss=loss, sim_time_s=history["sim_time_s"])
            if (r + 1) % fc.eval_every == 0 or r == fc.rounds - 1:
                # blocks end on eval rounds, so the carry here is exactly
                # round r's post-aggregation params
                log.acc = SV.evaluate(model, base, trainable, masks, test,
                                      fc, device)
                history["acc"].append((r, log.acc))
            history.end_round(rsp, log, down, up)
            if on_round:
                on_round(r, log)

        rnd = block[-1] + 1

    if rounder is not None and rounder.captures:
        history["graph"] = {"captures": rounder.captures,
                            "replays": rounder.replays,
                            "launches_per_capture": rounder.capture_launches}
    return SV.finish(history, base, trainable, masks_np, t0, device, fc)
