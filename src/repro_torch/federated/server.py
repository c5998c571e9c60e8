"""Federated server loop (reference: ``repro/federated/server.py``; paper
Algorithm 1), the sequential oracle (``runner="seq"``).  ``FedConfig.runner``
routes the same run through ``repro_torch.fedsim``: ``"cohort"`` trains
each round's clients together, one forward over the whole cohort per local
step (``fuse_rounds > 1`` replays the round as a CUDA graph), and
``"async"`` runs FedBuff-style buffered aggregation on a simulated event
clock (``fedsim/runner.py``).

Client selection → CommPru'd broadcast → local training on each selected
client in turn → delta-space aggregation → FedArb mask arbitration → RankDet
module gating, with byte-exact communication accounting and the simulated
wall clock of the reference per round.  The model runs on the card (or on
the CPU when the caller passes ``device="cpu"``); the rank allocation, the
wire and the averaging run on the host in numpy, as in the reference.

Every upload is a ``fedsim.pipeline.ClientUpdate`` routed through the
shared delta pipeline: flatten → DP clip → codec (identity / int8 / topk /
signsgd / powersgd) → error feedback → byte accounting → link pricing →
aggregate.  Broadcasts ride the same codecs as delta-coded streams.

Privacy (``repro_torch.secagg``): ``FedConfig.secagg="mask"`` routes the
same encoded delta wires through simulated Bonawitz secure aggregation —
the server sees only the field aggregate of weighted deltas and the summed
one-hot rank votes (aggregate-only arbitration) — and
``dp_clip``/``dp_noise_multiplier`` add client-level DP-FedAvg with a
per-round ε trajectory in the history.  Field-exact codecs (signsgd)
compose with both.  SLoRA's stage 1 (sparse full fine-tuning of the base
before LoRA) takes the same codecs and the same private branch.

The seq runner has no dropouts (the fedsim runners draw them).  Every
runner's history is a ``repro_torch.obs.RunRecorder``: the dict with the
reference's keys, whose round, client, secagg and ε bookkeeping also
emits the reference's trace spans and events when tracing is on
(``obs.configure``); off, it is just the dict.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import obs as OBS
from repro_torch.core import comm as COMM
from repro_torch.core import masks as MK
from repro_torch.core import pruning as PR
from repro_torch.data.synthetic import Dataset, batches
from repro_torch.device import resolve_device
from repro_torch.federated import client as CL
from repro_torch.federated import devices as DV
from repro_torch.fedsim import pipeline as PL
from repro_torch.fedsim import transport as T
from repro_torch.fedsim.cohort import client_batch_rng
from repro_torch.optim import adam, linear_decay
from repro_torch.pytree import tree_map
from repro_torch.secagg import dp as DP
from repro_torch.secagg import protocol as SA


@dataclasses.dataclass
class FedConfig:
    rounds: int = 30
    clients_per_round: int = 5
    local_epochs: int = 1
    batch_size: int = 8
    lr: float = 2e-3
    seed: int = 0
    task: str = "cls"
    eval_every: int = 5
    max_local_batches: int = 8          # caps emulation cost per client
    eval_batches: int = 16
    # ---- fedsim (cohort / async runners, transport) ------------------------
    runner: str = "seq"                 # seq | cohort | async
    fuse_rounds: int = 1                # cohort: K rounds per block, each a
                                        # replay of one captured round (1 ≡
                                        # eager; >1 needs the fast path, else
                                        # falls back — fedsim/fused.py)
    opt_state_dtype: str = "float32"    # adam moment storage:
                                        # float32 | bfloat16 | int8
    rebucket: bool = False              # cohort: per-round pow-2 step-axis
                                        # re-bucketing (skewed partitions)
    codec: str = "identity"      # identity | int8 | topk | signsgd | powersgd
    powersgd_rank: int = 2              # q for the powersgd codec
    dropout: float = 0.0                # P(selected client never reports)
    straggler: float = 0.0              # P(client is a straggler this round)
    straggler_slow: float = 4.0         # straggler compute-time multiplier
    buffer_k: int = 0                   # async: aggregate every K arrivals
    async_concurrency: int = 0          # async: in-flight clients (0 → 2K)
    staleness_alpha: float = 0.5        # async: weight = n·(1+s)^-alpha
    event_seed: int = 0                 # dropout/straggler/event-time stream
    device_profile: str = "distilbert"  # federated/devices.py profile
    # ---- privacy (repro_torch.secagg: masked aggregation + client-level DP)
    secagg: str = "off"                 # off | mask (Bonawitz-style pairwise)
    secagg_threshold: float = 2.0 / 3.0  # Shamir threshold frac of the cohort
    secagg_bits: int = 32               # field modulus 2^bits
    secagg_frac_bits: int = 16          # fixed-point fractional bits
    secagg_clip: float = 8.0            # per-element clip at field encode
    dp_clip: float = 0.0                # client delta L2 clip (0 → DP off)
    dp_noise_multiplier: float = 0.0    # z: server noise std = z·clip on sum
    dp_delta: float = 1e-5              # δ for the RDP accountant's ε(δ)


@dataclasses.dataclass
class RoundLog:
    rnd: int
    down_bytes: int
    up_bytes: int
    live_ranks: int
    dead_modules: int
    trainable_params: int
    loss: float
    acc: float = float("nan")
    sim_time_s: float = 0.0             # simulated wall clock
    staleness: float = 0.0              # mean update staleness (async runner)


def validate_privacy_config(fc: FedConfig) -> None:
    """Fail loudly — and *before* any training — on privacy-knob
    combinations the simulation cannot honor."""
    if fc.secagg not in ("off", "mask"):
        raise ValueError(f"unknown secagg mode {fc.secagg!r} (off|mask)")
    if fc.codec not in T.FIELD_EXACT and (fc.secagg != "off"
                                          or fc.dp_clip > 0
                                          or fc.dp_noise_multiplier > 0):
        raise ValueError(
            "privacy modes need a field-exact codec — one whose decoded "
            "delta never exceeds the DP clip norm and encodes faithfully "
            "into the fixed-point field (signSGD's sign+scale wire "
            "contracts the L2 norm per block; int8/topk/powersgd do not "
            f"qualify).  Use --codec {'|'.join(T.FIELD_EXACT)}")
    if fc.runner == "async" and (fc.secagg != "off" or fc.dp_clip > 0
                                 or fc.dp_noise_multiplier > 0):
        raise ValueError("secagg/DP for the async/FedBuff runner is not "
                         "simulated; use runner seq|cohort")
    if fc.dp_noise_multiplier > 0 and fc.dp_clip <= 0:
        raise ValueError("--dp-noise-multiplier requires --dp-clip > 0")
    if fc.secagg != "off":
        spec = SA.field_spec(fc)        # raises on bad bits/frac_bits combos
        spec.check_headroom(fc.clients_per_round)
        if fc.secagg_clip < 1.0:
            raise ValueError("secagg_clip must be ≥ 1 (weights and one-hot "
                             "votes encode as field elements of magnitude 1)")
        if fc.dp_clip > fc.secagg_clip:
            raise ValueError("dp_clip must be ≤ secagg_clip: an L2-clipped "
                             "delta element may reach dp_clip and would be "
                             "silently saturated by the field encode")


def validate_config(fc: FedConfig) -> None:
    """Raise, before any work, on what the reference refuses: privacy-knob
    combinations (``validate_privacy_config``) and unknown runners."""
    validate_privacy_config(fc)
    if fc.runner not in ("seq", "cohort", "async"):
        raise ValueError(f"unknown runner {fc.runner!r} (seq|cohort|async)")


def fedavg(trees: list[Any], weights: list[float]) -> Any:
    """Weighted mean of same-structured trees of tensors, in f32."""
    w = np.asarray(weights, np.float64)
    w = (w / w.sum()).astype(np.float32)

    def avg(*leaves):
        acc = leaves[0].float() * float(w[0])
        for wi, leaf in zip(w[1:], leaves[1:]):
            acc = acc + leaf.float() * float(wi)
        return acc.to(leaves[0].dtype)

    return tree_map(avg, *trees)


def evaluate(model, base, trainable, masks, test: Dataset, fc: FedConfig,
             device) -> float:
    """cls → accuracy over the eval batches (batch order from seed 0); lm →
    the mean of the batches' mean next-token NLL, the targets taken from
    each batch's token stream (tokens ``[:, :-1]``, targets ``[:, 1:]``)."""
    ev = CL.make_eval_step(model, fc.task)
    rng = np.random.default_rng(0)
    total, vals = 0, []
    # eval-kind span: obs.profile buckets a compile under it apart from
    # the round loop's
    esp = OBS.get_tracer().begin("evaluate", kind="eval", task=fc.task)
    for i, batch in enumerate(batches(test, fc.batch_size, rng)):
        if i >= fc.eval_batches:
            break
        if fc.task == "cls":
            vals.append(ev(base, trainable, masks,
                           CL.device_batch(batch, device)))
            total += len(batch["labels"])
        else:
            toks = batch["tokens"]
            vals.append(ev(base, trainable, masks, CL.device_batch(
                {"tokens": toks[:, :-1], "targets": toks[:, 1:]}, device)))
    # device scalars accumulate without blocking; one transfer here
    vals = torch.stack(vals).tolist() if vals else []
    esp.end(n_batches=len(vals))
    if fc.task == "cls":
        return sum(vals) / max(total, 1)
    return float(np.mean(vals)) if vals else float("nan")


def _to_device(masks_np, device):
    return tree_map(lambda m: torch.as_tensor(m, device=device), masks_np)


def _init_run(model, strategy, fc: FedConfig, device, params=None):
    """Common run state: params, masks, optimizer, selection stream.

    ``params=(base, trainable)`` starts from given weights (the parity
    tests pass the reference's ``jax.random`` init through
    ``repro_torch.bridge``); without it the weights are drawn from
    ``fc.seed`` on ``device``."""
    if params is None:
        base, trainable = model.init(fc.seed, device)
    else:
        base, trainable = (tree_map(lambda t: t.to(device), p)
                           for p in params)
    base, trainable = strategy.post_init(model, base, trainable)
    masks = model.init_masks(device) if strategy.uses_masks() else None
    masks_np = MK.to_np(masks) if masks else None
    n_rank_units = MK.total_ranks(masks_np) if masks_np else 0
    total_steps = fc.rounds * fc.max_local_batches * fc.local_epochs
    opt = adam(linear_decay(fc.lr, total_steps),
               state_dtype=fc.opt_state_dtype)
    rng = np.random.default_rng(fc.seed)
    return base, trainable, masks, masks_np, n_rank_units, opt, rng


def _arbitrate(strategy, trainable, local_masks, masks, masks_np, rnd,
               device):
    """FedArb + RankDet after aggregation → (trainable, masks, masks_np)."""
    if strategy.uses_masks():
        masks_np = strategy.arbitrate(rnd, local_masks, masks_np)
        masks = _to_device(masks_np, device)
        trainable = dict(trainable,
                         adapters=COMM.prune_tree(trainable["adapters"],
                                                  masks_np))
    return trainable, masks, masks_np


def _arbitrate_votes(strategy, trainable, vote_sums, n_reporting, masks,
                     masks_np, rnd, device):
    """Aggregate-only FedArb: the secagg server sees vote *sums*, never a
    client's mask (``core.arbitration.arbitrate_from_votes``)."""
    if strategy.uses_masks():
        masks_np = strategy.arbitrate_votes(rnd, vote_sums, n_reporting,
                                            masks_np)
        masks = _to_device(masks_np, device)
        trainable = dict(trainable,
                         adapters=COMM.prune_tree(trainable["adapters"],
                                                  masks_np))
    return trainable, masks, masks_np


def _private_round(strategy, bc, encoded, sel, masks, masks_np, fc, rnd,
                   history, accountant, pipe, device):
    """Shared secagg/DP aggregation step (seq oracle, cohort runner and
    SLoRA stage 1):
    routes the pipeline's encoded delta wires through
    ``secagg.protocol.aggregate_round``, arbitrates from vote sums, and
    records protocol accounting + the ε trajectory in the history."""
    agg = pipe.aggregate_private(bc, encoded, sel, masks_np, rnd)
    trainable, masks, masks_np = _arbitrate_votes(
        strategy, agg.trainable, agg.vote_sums, agg.n_reporting, masks,
        masks_np, rnd, device)
    if agg.secagg is not None:
        history.record_secagg({
            "rnd": rnd,
            "phases": {k: dataclasses.asdict(v)
                       for k, v in agg.secagg.phases.items()},
            "recovery_bytes": agg.secagg.recovery_bytes,
            "n_dropped": len(agg.secagg.dropped),
            "n_clipped": agg.n_clipped,
            "aborted": agg.aborted})
    if accountant is not None and not agg.aborted:
        # an aborted round never decodes (or noises) an aggregate, so no
        # privacy is spent — ε only grows on actual releases
        accountant.step()
        history.record_eps(rnd, accountant.epsilon(fc.dp_delta))
    return trainable, masks, masks_np, agg


def make_accountant(fc: FedConfig, n_clients: int):
    """Subsampled-Gaussian RDP accountant for the run's (z, q), or None."""
    if fc.dp_noise_multiplier <= 0:
        return None
    q = min(fc.clients_per_round / max(n_clients, 1), 1.0)
    return DP.RDPAccountant(fc.dp_noise_multiplier, q)


def _run_stage1(model, strategy, base, trainable, parts, train, fc, opt,
                rng, history, device, accountant=None):
    """SLoRA stage 1: sparse full-FT rounds before LoRA
    (``baselines.SLoRA``).  Draws the client selection from ``rng`` like the
    main rounds.  Each client fine-tunes the base (and the LoRA tree, which
    is thrown away, as in the reference) from fresh Adam states for
    ``max_local_batches`` batches; the base deltas ride the pipeline on the
    sparse-gate wire: DP-clipped, codec'd with error feedback, byte-counted
    and priced as stage 2's, and through secagg/DP when privacy is on.
    Returns (the initial base, the LoRA tree initialized from the SVD of the
    base's accumulated delta)."""
    s1_rounds = strategy.stage1_rounds(fc.rounds)
    masks = model.init_masks(device) if strategy.uses_masks() else None
    base0 = base
    s1_gate = strategy.sparse_gate(base, fc.seed)
    s1_step = CL.make_train_step(model, opt, fc.task, train_base=True)
    s1_update = CL.make_base_update_step(opt)
    pipe = PL.UploadPipeline(
        fc, strategy=None,
        flatten=lambda d, m: PL.flatten_gate(d, s1_gate),
        unflatten=lambda w, like, m: PL.unflatten_gate(w, like, s1_gate),
        stage="stage1")
    private = SA.wants_private(fc)
    s1_stats = history.setdefault(
        "stage1", {"rounds": 0, "up_bytes": 0, "n_clipped": 0})
    for rnd in range(s1_rounds):
        rsp = history.begin_round(rnd, phase="stage1")
        sel = rng.choice(len(parts), size=min(fc.clients_per_round,
                                              len(parts)), replace=False)
        down_per = strategy.stage1_comm_bytes(base)
        down = down_per * len(sel)
        encoded = []
        for cid in sel:
            idx = parts[cid]
            cd = Dataset(train.tokens[idx], train.labels[idx])
            bk, opt_b = base, opt.init(base)
            opt_t, params_k = opt.init(trainable), trainable
            gen = _take(batches(cd, fc.batch_size,
                                client_batch_rng(fc.seed, rnd, cid)),
                        fc.max_local_batches)
            n_b = 0
            for bt in gen:
                params_k, opt_t, _, gb, _, _ = s1_step(
                    bk, params_k, opt_t, masks, None,
                    CL.device_batch(bt, device))
                bk, opt_b = s1_update(bk, opt_b, gb, s1_gate)
                n_b += 1
            delta = tree_map(lambda a, b: a.float() - b.float(), bk, base)
            encoded.append(pipe.encode(PL.ClientUpdate(
                int(cid), delta, weight=float(len(idx)), n_steps=n_b), None))
        protocol_s = 0.0
        if private:
            base, _, _, agg = _private_round(
                strategy, base, encoded, sel, None, None, fc, rnd, history,
                accountant, pipe, device)
            up = agg.up_bytes + sum(e.nbytes for e in encoded)
            down += agg.down_bytes
            protocol_s = agg.time_s
        else:
            base = pipe.aggregate(base, encoded, rnd=rnd)
            up = sum(e.nbytes for e in encoded)
        s1_stats["rounds"] += 1
        s1_stats["up_bytes"] += up
        s1_stats["n_clipped"] += sum(int(e.clipped) for e in encoded)
        enc_of = {e.cid: e for e in encoded}
        costs = [pipe.client_time(
            cid, down_per, enc_of[int(cid)].nbytes,
            DV.compute_s(int(cid), fc.device_profile,
                         enc_of[int(cid)].n_steps)) for cid in sel]
        history.add_sim((max(costs) if costs else 0.0) + protocol_s)
        log = RoundLog(rnd, int(down), int(up), live_ranks=0,
                       dead_modules=0,
                       trainable_params=PR.count_trainable(base),
                       loss=float("nan"), sim_time_s=history["sim_time_s"])
        history.end_round(rsp, log, down, up)
    # convert the sparse delta into the LoRA init, reset the base
    trainable = strategy.svd_init_from_delta(model, base0, base, trainable)
    return base0, trainable


def run_federated(model, strategy, parts: list[np.ndarray], train: Dataset,
                  test: Dataset, fc: FedConfig,
                  on_round: Callable | None = None, device=None,
                  params=None) -> dict:
    """Returns the history dict: ``rounds`` (RoundLogs), ``acc``
    [(round, acc)], ``comm_gb`` (summed per round in round order),
    ``sim_time_s``, ``final_acc``, ``wall_s``, ``base``, ``trainable`` and
    ``masks`` (numpy); ``secagg_rounds`` (one entry per secagg round:
    phase bytes and times, recovery bytes, dropped and clipped counts) and
    ``dp_eps`` [(round, ε)]; with DP noise also ``dp``; for SLoRA also
    ``stage1`` (rounds, up_bytes, n_clipped), whose rounds lead
    ``rounds``.  The async runner's history has ``events`` in place of
    ``secagg_rounds`` and ``dp_eps``; the fused cohort's also ``graph``
    (``fedsim/fused.py``)."""
    validate_config(fc)
    device = resolve_device(device)
    if fc.runner != "seq":
        from repro_torch.fedsim import runner as FR  # lazy: it imports us
        return FR.run(model, strategy, parts, train, test, fc, on_round,
                      device=device, params=params)
    base, trainable, masks, masks_np, n_rank_units, opt, rng = \
        _init_run(model, strategy, fc, device, params)
    step_fn = CL.make_train_step(model, opt, fc.task)
    pipe = PL.UploadPipeline(fc, strategy)
    private = SA.wants_private(fc)
    accountant = make_accountant(fc, len(parts))

    history = OBS.RunRecorder("seq", fc,
                              extra_keys=("secagg_rounds", "dp_eps"))
    t0 = time.perf_counter()

    # SLoRA stage 1: sparse full-FT rounds before LoRA (baselines.SLoRA)
    s1_rounds = (strategy.stage1_rounds(fc.rounds)
                 if hasattr(strategy, "stage1_rounds") else 0)
    if s1_rounds:
        base, trainable = _run_stage1(model, strategy, base, trainable,
                                      parts, train, fc, opt, rng, history,
                                      device, accountant)

    for rnd in range(s1_rounds, fc.rounds):
        rsp = history.begin_round(rnd)
        sel = rng.choice(len(parts), size=min(fc.clients_per_round,
                                              len(parts)), replace=False)
        # ---- CommPru'd broadcast (delta-coded when a codec is on) --------
        if masks_np is not None:
            trainable = dict(trainable,
                             adapters=COMM.prune_tree(trainable["adapters"],
                                                      masks_np))
        bc, down_per = pipe.broadcast(trainable, masks_np)
        down = down_per * len(sel)
        gate = strategy.optimizer_gate(bc, masks_np)

        results, local_masks, encoded = [], [], []
        for cid in sel:
            csp = history.begin_client(int(cid))
            idx = parts[cid]
            client_data = Dataset(train.tokens[idx], train.labels[idx])
            gen = batches(client_data, fc.batch_size,
                          client_batch_rng(fc.seed, rnd, cid),
                          epochs=fc.local_epochs)
            gen = _take(gen, fc.max_local_batches * fc.local_epochs)
            params_k, grads_k, m = CL.local_train(
                step_fn, base, bc, masks, gate, opt, gen, device)
            lm = None
            if strategy.uses_masks():
                lm = strategy.local_masks(rnd, params_k["adapters"],
                                          (grads_k or {}).get("adapters"),
                                          n_rank_units)
                local_masks.append(lm)
            # upload pruned by the *current* global mask (Alg. 1 line 28),
            # as a delta through the shared pipeline stages
            upd = PL.ClientUpdate(int(cid), PL.delta_tree(params_k, bc),
                                  weight=float(len(idx)), votes=lm,
                                  n_steps=m["n_batches"])
            enc = pipe.encode(upd, masks_np)
            encoded.append(enc)
            results.append((int(cid), m))
            csp.end(n_steps=m["n_batches"], up_bytes=enc.nbytes,
                    loss=m["loss"])

        if private:
            # ---- secagg / DP: the server only sees the field aggregate ---
            trainable, masks, masks_np, agg = _private_round(
                strategy, bc, encoded, sel, masks, masks_np, fc, rnd,
                history, accountant, pipe, device)
            up = agg.up_bytes + sum(e.nbytes for e in encoded)
            down += agg.down_bytes
            protocol_s = agg.time_s
        else:
            # ---- delta-space FedAvg, then FedArb + RankDet ---------------
            trainable = pipe.aggregate(bc, encoded, rnd=rnd)
            up = sum(e.nbytes for e in encoded)
            trainable, masks, masks_np = _arbitrate(
                strategy, trainable, local_masks, masks, masks_np, rnd,
                device)
            protocol_s = 0.0
        record_ranks(history, rnd, masks_np, local_masks)

        # ---- simulated wall clock: bytes through per-device links --------
        enc_of = {e.cid: e for e in encoded}
        costs = [pipe.client_time(
            int(cid), down_per, enc_of[int(cid)].nbytes,
            DV.compute_s(int(cid), fc.device_profile,
                         enc_of[int(cid)].n_steps)) for cid in sel]
        stamp_costs(rsp, costs)
        history.add_sim((max(costs) if costs else 0.0) + protocol_s)

        live = int(MK.count_true(masks_np)) if masks_np else n_rank_units
        n_dead = len(PR.dead_modules(masks_np)) if masks_np else 0
        log = RoundLog(rnd, int(down), int(up), live, dead_modules=n_dead,
                       trainable_params=PR.count_trainable(trainable),
                       loss=float(np.mean([r[1]["loss"] for r in results])),
                       sim_time_s=history["sim_time_s"])
        if (rnd + 1) % fc.eval_every == 0 or rnd == fc.rounds - 1:
            log.acc = evaluate(model, base, trainable, masks, test, fc,
                               device)
            history["acc"].append((rnd, log.acc))
        history.end_round(rsp, log, down, up)
        if on_round:
            on_round(rnd, log)

    return finish(history, base, trainable, masks_np, t0, device, fc,
                  accountant)


def record_ranks(history, rnd: int, masks_np, local_masks) -> None:
    """The round's arbitrated rank allocation → a ``rank_alloc`` trace
    event (nothing while tracing is off)."""
    if OBS.get_tracer().enabled and masks_np:
        history.record_ranks(rnd, masks_np,
                             votes=MK.vote_fractions(local_masks))


def stamp_costs(rsp, costs: list[float]) -> None:
    """The slowest and the median client time on the round span (the
    health monitor's straggler detector reads them)."""
    if costs:
        sc = sorted(costs)
        rsp.set(cost_max=float(sc[-1]), cost_med=float(sc[len(sc) // 2]))


def finish(history, base, trainable, masks_np, t0: float, device,
           fc: FedConfig, accountant=None):
    """The run's closing keys: ``final_acc``, ``dp`` (with an accountant),
    ``wall_s`` (after the card has finished), the final weights and masks;
    then the run span ends."""
    logs = history["rounds"]
    history["final_acc"] = logs[-1].acc if logs else float("nan")
    if accountant is not None:
        history["dp"] = {"epsilon": accountant.epsilon(fc.dp_delta),
                         "delta": fc.dp_delta,
                         "noise_multiplier": fc.dp_noise_multiplier,
                         "clip": fc.dp_clip}
    if device.type == "cuda":
        torch.cuda.synchronize(device)          # stop the clock honestly
    history["wall_s"] = time.perf_counter() - t0
    history["base"] = base
    history["trainable"] = trainable
    history["masks"] = masks_np
    history.finish()
    return history


def _take(gen, n):
    for i, x in enumerate(gen):
        if i >= n:
            return
        yield x
