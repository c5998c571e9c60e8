"""The 4-phase secure-aggregation round + the runner-facing aggregate path
(reference: ``repro/secagg/protocol.py``; host numpy, as in the reference).

``run_round`` simulates Bonawitz-style secure aggregation over one cohort
with exact byte/latency accounting per phase, routed through
``fedsim.transport.Link``:

  advertise   every participant uploads 2 public keys; the server broadcasts
              the full key directory,
  share       every participant deals Shamir shares of its self-mask seed
              and pairwise secret key through the server,
  masked      survivors upload the field-encoded, double-masked CommPru wire
              (dropouts happen *after* shares are dealt, so their pairwise
              masks are baked into every survivor's input),
  unmask      the server broadcasts the survivor set; survivors answer with
              the shares they hold — self-mask shares for survivors, pairwise
              key shares for dropouts — and the server reconstructs and
              removes the orphaned masks (dropout *recovery*, not exclusion).

Rank heterogeneity: FedARA clients agree on the round's global mask before
phase 2 (``agree_length`` pads every wire to the cohort maximum), because a
client whose local vector is shorter than its peers' would otherwise leak its
surviving rank count through the payload size — and the modular sum needs
aligned shapes anyway.

``aggregate_round`` is what the delta pipeline calls
(``fedsim.pipeline.UploadPipeline.aggregate_private``): it takes the
pipeline's *encoded* client updates — delta wires that already passed the
shared flatten → clip → codec → error-feedback stages — weights them (+ the
client's weight and its one-hot rank votes as trailing field elements), runs
the protocol, applies client-level DP noise (dp.py), and returns the new
global trainable plus the secagg-summed vote vector for aggregate-only
arbitration (``core.arbitration.arbitrate_from_votes``).  Field-exact codecs
(signSGD's sign+scale wire) therefore compose with privacy: the field sums
the codec's decoded deltas, and the pipeline snaps EF residuals to the field
grid so client state never diverges from the masked aggregate.

The masks come from numpy's ``default_rng`` streams (masking.py) and the DP
noise too, so every field element and every noise draw is the reference's
bit for bit.  The new global trainable goes back onto the device of the
broadcast state.  With tracing on, each protocol round records the
reference's ``secagg`` span with its four ``secagg-phase`` children and
the per-phase byte counters (``_emit_secagg_trace``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from repro_torch import obs as OBS
from repro_torch.core import importance as IMP
from repro_torch.core import masks as MK
from repro_torch.fedsim import transport as T
from repro_torch.fedsim.pipeline import apply_delta
from repro_torch.secagg import dp as DP
from repro_torch.secagg import masking as MSK
from repro_torch.secagg.field import FieldSpec, sum_encoded

PHASES = ("advertise", "share", "masked", "unmask")


@dataclasses.dataclass(frozen=True)
class SecAggConfig:
    threshold_frac: float = 2.0 / 3.0
    field: FieldSpec = dataclasses.field(default_factory=FieldSpec)
    key_bytes: int = MSK.KEY_BYTES
    share_bytes: int = MSK.SHARE_BYTES


@dataclasses.dataclass
class PhaseCost:
    down: int = 0               # total server→client bytes, this phase
    up: int = 0                 # total client→server bytes, this phase
    time_s: float = 0.0         # barrier time (slowest participant)


@dataclasses.dataclass
class SecAggRound:
    sum_vec: np.ndarray | None        # decoded f32 survivor-sum (None: abort)
    field_sum: np.ndarray | None      # raw field aggregate (exactness tests)
    participants: list[int]
    survivors: list[int]
    dropped: list[int]
    threshold: int
    phases: dict[str, PhaseCost]
    recovery_bytes: int
    aborted: bool = False

    @property
    def down_bytes(self) -> int:
        return sum(p.down for p in self.phases.values())

    @property
    def up_bytes(self) -> int:
        return sum(p.up for p in self.phases.values())

    @property
    def time_s(self) -> float:
        return sum(p.time_s for p in self.phases.values())


def agree_length(wires: dict[int, np.ndarray]) -> int:
    """Rank agreement: the cohort's common wire length (max, zero-padded)."""
    return max((w.size for w in wires.values()), default=0)


def _pad(w: np.ndarray, n: int) -> np.ndarray:
    return w if w.size == n else np.pad(np.asarray(w, np.float32),
                                        (0, n - w.size))


def _phase(participants, link_of, down_per: Callable[[int], int],
           up_per: Callable[[int], int]) -> PhaseCost:
    """Account one synchronous phase: bytes summed, time = slowest client."""
    cost = PhaseCost()
    for cid in participants:
        d, u = down_per(cid), up_per(cid)
        cost.down += d
        cost.up += u
        link = link_of(cid)
        cost.time_s = max(cost.time_s,
                          link.transfer_s(d) + link.transfer_s(u))
    return cost


def run_round(wires: dict[int, np.ndarray], participants: list[int],
              dropped: list[int], cfg: SecAggConfig, round_seed: int,
              link_of: Callable[[int], T.Link] | None = None) -> SecAggRound:
    """One secure-aggregation round over f32 wires (survivors only in
    ``wires``; ``dropped`` fail after the share phase, before upload)."""
    link_of = link_of or (lambda cid: T.Link())
    participants = sorted(int(c) for c in participants)
    dropped = sorted(set(int(c) for c in dropped) & set(participants))
    survivors = [c for c in participants if c not in dropped]
    if set(wires) != set(survivors):
        raise ValueError("wires must cover exactly the surviving clients")
    n = len(participants)
    spec = cfg.field
    spec.check_headroom(max(n, 1))
    t = MSK.threshold_for(n, cfg.threshold_frac)
    shamir = MSK.ShamirSpec(n=max(n, 1), threshold=t,
                            share_bytes=cfg.share_bytes)
    L = agree_length(wires)

    phases: dict[str, PhaseCost] = {}
    # -- phase 0: advertise keys (everyone is still alive) -------------------
    phases["advertise"] = _phase(
        participants, link_of,
        down_per=lambda c: n * 2 * cfg.key_bytes + T.HEADER_BYTES,
        up_per=lambda c: 2 * cfg.key_bytes + T.HEADER_BYTES)
    # -- phase 1: deal Shamir shares through the server ----------------------
    per_deal = shamir.deal_bytes_per_client()
    phases["share"] = _phase(
        participants, link_of,
        down_per=lambda c: per_deal + T.HEADER_BYTES,   # receives n−1 pairs
        up_per=lambda c: per_deal + T.HEADER_BYTES)
    # -- phase 2: masked input (survivors only) ------------------------------
    masked_up = spec.wire_bytes(L) + T.HEADER_BYTES
    phases["masked"] = _phase(
        survivors, link_of, down_per=lambda c: 0,
        up_per=lambda c: masked_up)
    # -- phase 3: unmask (survivor bitmap down, held shares up) --------------
    n_drop = len(dropped)
    unmask_up = shamir.unmask_bytes_per_survivor(len(survivors), n_drop) \
        + T.HEADER_BYTES
    phases["unmask"] = _phase(
        survivors, link_of,
        down_per=lambda c: (n + 7) // 8 + T.HEADER_BYTES,
        up_per=lambda c: unmask_up)
    recovery = shamir.recovery_bytes(len(survivors), n_drop)

    if not survivors or not shamir.can_reconstruct(len(survivors)):
        return SecAggRound(None, None, participants, survivors, dropped, t,
                           phases, recovery, aborted=True)

    # -- the actual modular aggregation -------------------------------------
    masked = [MSK.mask_input(spec.encode(_pad(wires[c], L)), round_seed, c,
                             participants, spec)
              for c in survivors]
    agg = sum_encoded(masked, spec)
    # survivors' self masks come off via their reconstructed seeds…
    for c in survivors:
        agg = spec.sub(agg, MSK.self_mask(round_seed, c, L, spec))
    # …and dropped clients' pairwise masks are re-expanded and cancelled
    for d in dropped:
        for c in survivors:
            m = MSK.pair_mask(round_seed, c, d, L, spec)
            agg = spec.sub(agg, m) if c < d else spec.add(agg, m)
    return SecAggRound(spec.decode_sum(agg), agg, participants, survivors,
                       dropped, t, phases, recovery)


# ---------------------------------------------------------------------------
# Runner-facing private aggregation (secagg and/or client-level DP)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PrivateAggregate:
    trainable: Any                     # new global trainable tree
    vote_sums: np.ndarray | None       # summed one-hot rank votes (flat)
    n_reporting: int
    secagg: SecAggRound | None         # None when running DP without secagg
    up_bytes: int                      # client→server total (all phases)
    down_bytes: int                    # server→client protocol overhead
    time_s: float                      # protocol barrier time
    n_clipped: int = 0                 # clients whose delta hit dp_clip
    noise_std: float = 0.0             # per-element std added to the sum
    aborted: bool = False


def _emit_secagg_trace(sa: SecAggRound, rnd: int) -> None:
    """One ``secagg`` span with four ``secagg-phase`` children + per-phase
    byte counters — the trace-side mirror of the history's secagg_rounds
    entries (same PhaseCost ints, so summarize reconstructs them exactly)."""
    tr = OBS.get_tracer()
    if not tr.enabled:
        return
    with tr.span("secagg", kind="secagg", rnd=int(rnd),
                 participants=len(sa.participants),
                 survivors=len(sa.survivors),
                 n_dropped=len(sa.dropped),
                 recovery_bytes=int(sa.recovery_bytes),
                 aborted=sa.aborted):
        for name in PHASES:
            pc = sa.phases[name]
            tr.begin(name, kind="secagg-phase", down=int(pc.down),
                     up=int(pc.up), time_s=pc.time_s).end()
    m = tr.metrics
    for name in PHASES:
        pc = sa.phases[name]
        m.counter("secagg.phase_bytes", phase=name,
                  dir="down").inc(int(pc.down))
        m.counter("secagg.phase_bytes", phase=name, dir="up").inc(int(pc.up))
    m.counter("secagg.recovery_bytes").inc(int(sa.recovery_bytes))
    if sa.aborted:
        m.counter("secagg.aborted_rounds").inc()


def wants_private(fc) -> bool:
    return (getattr(fc, "secagg", "off") != "off"
            or getattr(fc, "dp_clip", 0.0) > 0
            or getattr(fc, "dp_noise_multiplier", 0.0) > 0)


def field_spec(fc) -> FieldSpec:
    return FieldSpec(bits=fc.secagg_bits, frac_bits=fc.secagg_frac_bits,
                     clip=fc.secagg_clip)


def round_seed(fc, rnd: int) -> int:
    return fc.seed * 100_003 + rnd


def aggregate_round(bc: Any, uploads: list[Any],
                    participants: list[int], masks_np: Any, fc, rnd: int,
                    link_of: Callable[[int], T.Link] | None = None,
                    unflatten: Callable | None = None) -> PrivateAggregate:
    """Privacy-preserving FedAvg over *encoded* client deltas; ``bc`` is a
    tree of tensors and so is the returned ``trainable`` (on ``bc``'s device).

    ``uploads`` holds surviving clients as ``fedsim.pipeline.EncodedUpdate``s
    (attrs: cid, wire — the post-clip post-codec decoded delta wire —,
    weight, votes, clipped); ``participants`` is everyone selected this round
    (the extras are the dropouts whose masks need recovery).  Clipping
    already happened in the pipeline's shared clip stage; this function only
    counts it.  ``unflatten`` maps the averaged wire back onto ``bc`` (the
    pipeline passes its own — the CommPru trainable wire for stage 2, the
    sparse-gate base wire for SLoRA stage 1).  The server learns only the
    field aggregate: Σ w·Δ, Σ w, and the summed rank votes.
    """
    if fc.dp_noise_multiplier > 0 and fc.dp_clip <= 0:
        raise ValueError("dp_noise_multiplier > 0 requires dp_clip > 0")
    dp_on = fc.dp_clip > 0
    use_field = fc.secagg != "off"
    if unflatten is None:
        unflatten = T.unflatten_update

    wires, votes = {}, {}
    n_clipped = sum(int(u.clipped) for u in uploads)
    has_votes = any(u.votes is not None for u in uploads)
    for u in uploads:
        wires[u.cid] = np.asarray(u.wire, np.float32)
        if has_votes:
            vflat, _ = IMP.flat_concat(MK.to_np(u.votes))
            votes[u.cid] = vflat.astype(np.float32)

    # uniform weights under DP (bounded per-client sensitivity; element
    # magnitudes are safe because validation pins dp_clip ≤ field clip);
    # otherwise mean-normalized data-size weights (Σw_norm ≈ n keeps the
    # fixed-point ratio well-conditioned), rescaled down together if any
    # *weighted wire element* (or the weight tail element itself) would hit
    # the per-element field clip — a common normalizer cancels in the
    # decoded Σw·Δ / Σw ratio, so the result stays plain weighted FedAvg,
    # never silently element-clipped
    if dp_on:
        w_norm = {cid: 1.0 for cid in wires}
    else:
        sel_w = {int(u.cid): float(u.weight) for u in uploads}
        mean_w = (float(np.mean(list(sel_w.values()))) or 1.0) \
            if sel_w else 1.0
        w_norm = {cid: w / mean_w for cid, w in sel_w.items()}
        peak = max((w_norm[cid]
                    * max(float(np.abs(w).max()) if w.size else 0.0, 1.0)
                    for cid, w in wires.items()), default=0.0)
        over = peak / field_spec(fc).clip
        if over > 1.0:
            w_norm = {cid: w / over for cid, w in w_norm.items()}
    L = agree_length(wires)
    payloads = {}
    for cid, w in wires.items():
        wi = w_norm[cid]
        tail = [np.float32([wi])]
        if has_votes:
            tail.append(votes[cid])
        payloads[cid] = np.concatenate([_pad(w, L) * np.float32(wi)] + tail)

    dropped = [int(c) for c in participants if int(c) not in wires]
    sa = None
    if use_field:
        cfg = SecAggConfig(threshold_frac=fc.secagg_threshold,
                           field=field_spec(fc))
        sa = run_round(payloads, [int(c) for c in participants], dropped,
                       cfg, round_seed(fc, rnd), link_of)
        _emit_secagg_trace(sa, rnd)
        if sa.aborted:
            return PrivateAggregate(bc, None, 0, sa, sa.up_bytes,
                                    sa.down_bytes, sa.time_s, aborted=True)
        sum_vec = sa.sum_vec
    else:
        sum_vec = np.sum([payloads[c] for c in sorted(payloads)], axis=0,
                         dtype=np.float64).astype(np.float32) \
            if payloads else None
        if sum_vec is None:
            return PrivateAggregate(bc, None, 0, None, 0, 0, 0.0,
                                    aborted=True)

    sum_wire, sum_w = sum_vec[:L].copy(), float(sum_vec[L])
    vote_sums = np.rint(sum_vec[L + 1:]) if has_votes else None
    n_rep = len(wires)

    noise_std = 0.0
    if fc.dp_noise_multiplier > 0:
        rng = np.random.default_rng([fc.seed & 0x7FFFFFFF, 0xD9, rnd])
        sum_wire += DP.gaussian_sum_noise(L, fc.dp_clip,
                                          fc.dp_noise_multiplier, rng)
        noise_std = fc.dp_noise_multiplier * fc.dp_clip

    avg = sum_wire / max(sum_w, 1e-9)
    trainable = apply_delta(bc, unflatten(avg, bc, masks_np))
    return PrivateAggregate(
        trainable, vote_sums, n_rep, sa,
        up_bytes=sa.up_bytes if sa else 0,
        down_bytes=sa.down_bytes if sa else 0,
        time_s=sa.time_s if sa else 0.0,
        n_clipped=n_clipped, noise_std=noise_std)
