"""Delta-space upload pipeline (reference: ``repro/fedsim/pipeline.py``): the
one wire path for every producer.

    flatten → (+EF residual) → DP clip → codec → field snap → (−EF residual)
            → byte accounting → link pricing → aggregate | aggregate_private

Every client upload is a ``ClientUpdate`` (delta tree + weight + rank
votes).  By default the wire is the CommPru trainable wire: it keeps the
surviving ranks only, so a masked rank's delta arrives as zero; with the
identity codec, delta-space FedAvg equals param-space FedAvg exactly.

Stage notes (as in the reference):
  - The DP clip sits *inside* the error-feedback loop: the residual is folded
    in before clipping, so the transmitted signal (not just the fresh delta)
    respects the L2 sensitivity bound.
  - ``field snap``: when secure aggregation is on, the residual is computed
    against the *field-quantized* decode — the exact vector the masked sum
    will aggregate — so EF state never diverges from what the server applies.
  - Downlink broadcasts are delta-coded too (``DeltaChannel``): each endpoint
    holds the receiver's reconstruction and ships ``codec(target − ref)``,
    re-projecting the reference through the current rank masks when CommPru
    pruning shrinks the wire.
  - Aggregation is delta-space weighted FedAvg applied to the broadcast state
    (``aggregate``), or the secagg/DP field path (``aggregate_private`` →
    ``secagg.protocol.aggregate_round``); both consume the same encoded wires.

The wires, the codecs, the EF residuals, the field and the averaging live on
the host in float32 numpy, as in the reference; each crossing between the
card and the host is one copy of the whole tree.  SLoRA's stage 1 builds its
pipeline with ``strategy=None`` and the sparse-gate pair
:func:`flatten_gate` / :func:`unflatten_gate`: its base deltas stay on the
device and only the gate's support (about 5% of the base) crosses to the
host and back.  With tracing on (``repro_torch.obs``) the stages emit the
reference's ``broadcast`` / ``aggregate`` / ``aggregate_private`` spans,
the per-update ``encode`` and per-aggregation ``drift`` events, and the
byte, update, clip and error-feedback metrics, labelled by codec and stage
(``stage1`` for SLoRA's sparse wire) — all from the host numpy the wire
already holds, so tracing adds no copy from the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import obs as OBS
from repro_torch.federated import devices as DV
from repro_torch.fedsim import transport as T
from repro_torch.pytree import flatten_with_keys, tree_map, unflatten_keys
from repro_torch.secagg import dp as DP


@dataclasses.dataclass
class ClientUpdate:
    """What a producer hands the pipeline: one client's round contribution."""
    cid: int
    delta: Any                      # f32 delta tree (global-state structure)
    weight: float                   # aggregation weight (data size)
    votes: Any | None = None        # local rank-mask tree (FedArb votes)
    n_steps: int = 0                # local batches run (compute pricing)
    staleness: float = 0.0          # async: server versions behind


@dataclasses.dataclass
class EncodedUpdate:
    """A ClientUpdate after the wire stages: what the server aggregates."""
    cid: int
    wire: np.ndarray                # decoded (post-codec, post-snap) wire
    delta: Any                      # the decoded delta *tree* (same content)
    nbytes: int                     # exact upload bytes (0 under secagg —
                                    # the protocol phases price the upload)
    weight: float
    votes: Any | None = None
    clipped: bool = False           # DP clip engaged for this client
    norm: float = 0.0               # pre-clip L2 of the transmitted signal
    n_steps: int = 0
    staleness: float = 0.0


def to_host(tree: Any) -> Any:
    """Tree of tensors → tree of f32 numpy arrays, in one device→host copy."""
    items = flatten_with_keys(tree)
    if not items:
        return tree
    flat = torch.cat([t.detach().float().reshape(-1) for _, t in items])
    flat = flat.cpu().numpy()
    out, off = [], 0
    for keys, t in items:
        n = t.numel()
        out.append((keys, flat[off:off + n].reshape(tuple(t.shape))))
        off += n
    return unflatten_keys(out, tree)


def to_device(tree: Any, like: Any) -> Any:
    """Host (or device) f32 tree → f32 tensors shaped as ``like``'s leaves,
    on its device, in one host→device copy."""
    items = flatten_with_keys(like)
    src = dict(flatten_with_keys(tree))
    flat = torch.cat([torch.as_tensor(src[k], dtype=torch.float32)
                      .reshape(-1) for k, _ in items])
    flat = flat.to(items[0][1].device)
    out, off = [], 0
    for keys, p in items:
        n = p.numel()
        out.append((keys, flat[off:off + n].view(p.shape)))
        off += n
    return unflatten_keys(out, like)


def delta_tree(params: Any, ref: Any) -> Any:
    """f32 delta between two structurally equal trees of tensors, on the
    host (the f32 subtraction runs on the device, then one copy)."""
    return to_host(tree_map(lambda a, b: a.float() - b.float(), params, ref))


def apply_delta(global_tree: Any, delta: Any) -> Any:
    """global + delta, accumulated in f32, cast back to the global dtypes;
    a host delta crosses to the device in one copy, a device delta stays
    there."""
    return tree_map(lambda p, d: (p.float() + d).to(p.dtype), global_tree,
                    to_device(delta, global_tree))


def _sq_norm(x: np.ndarray) -> float:
    """‖x‖² in f64 by numpy's own loop, not a BLAS dot: OpenBLAS's threads
    spin after a product and slow torch's next multi-threaded host op (the
    ``torch.cat`` of ``to_device``) by tens of milliseconds."""
    x = np.asarray(x).reshape(-1)
    return float(np.einsum("i,i->", x, x, dtype=np.float64))


def make_fc_codec(fc) -> T.Codec | None:
    """FedConfig → codec instance (None for the identity f32 wire)."""
    if fc.codec == "identity":
        return None
    kw = {"rank": fc.powersgd_rank} if fc.codec == "powersgd" else {}
    return T.make_codec(fc.codec, **kw)


# ---------------------------------------------------------------------------
# SLoRA stage-1 wire: the sparse-gate support, not the whole base
# ---------------------------------------------------------------------------

def flatten_gate(delta: Any, gate: Any) -> np.ndarray:
    """Base-delta tree → f32 wire of the sparse-gate support, gathered on
    the delta's device and copied to the host in one piece.  The gate is
    server-seeded, so indices never travel; frozen leaves (scalar-0 gates
    on non-float dtypes) contribute nothing."""
    gates = dict(flatten_with_keys(gate))
    parts = [d.detach().float().reshape(-1)[gates[k].reshape(-1) != 0]
             for k, d in flatten_with_keys(delta) if gates[k].ndim]
    if not parts:
        return np.zeros((0,), np.float32)
    return torch.cat(parts).cpu().numpy()


def unflatten_gate(wire: np.ndarray, like: Any, gate: Any) -> Any:
    """Inverse of :func:`flatten_gate`: f32 tensors shaped as ``like``'s on
    its device, zero off the gate's support."""
    gates = dict(flatten_with_keys(gate))
    items = flatten_with_keys(like)
    dev = torch.as_tensor(wire).to(items[0][1].device) if items else None
    out, off = [], 0
    for keys, leaf in items:
        buf = torch.zeros(tuple(leaf.shape), dtype=torch.float32,
                          device=leaf.device)
        g = gates[keys]
        if g.ndim:
            sel = g != 0
            n = int(sel.sum())
            buf[sel] = dev[off:off + n]
            off += n
        out.append((keys, buf))
    return unflatten_keys(out, like)


# ---------------------------------------------------------------------------
# Downlink: delta-coded broadcast channel
# ---------------------------------------------------------------------------

class DeltaChannel:
    """One broadcast endpoint's delta-coded stream state.

    The endpoint holds ``ref`` — the receiver's current reconstruction, as a
    host f32 tree.  ``send(target)`` transmits ``codec(target − ref)`` and
    advances both sides' ``ref`` by the decoded delta.  The reference
    accumulation *is* the error feedback: whatever a lossy codec failed to
    transmit stays in ``target − ref`` and is retried next send.  When
    CommPru pruning changes the wire length, the reference *tree* is
    re-flattened through the new masks, so the pruned ranks drop out of both
    sides consistently.  With no codec the channel is a pass-through priced
    by the caller.  The receiver's reconstruction goes back to ``target``'s
    device and dtypes.
    """

    def __init__(self, codec, flatten, unflatten, key):
        self.codec, self.key = codec, key
        self.flatten, self.unflatten = flatten, unflatten
        self._ref: Any | None = None

    def send(self, target: Any, masks_np: Any | None) -> tuple[Any, int]:
        """→ (receiver's reconstruction tree, payload bytes excl. masks)."""
        if self.codec is None:
            return target, 0          # caller prices the f32 wire (CommPru)
        wire_t = self.flatten(to_host(target), masks_np)
        ref_w = (self.flatten(self._ref, masks_np)
                 if self._ref is not None else np.zeros_like(wire_t))
        if ref_w.shape != wire_t.shape:       # structure changed: resync
            ref_w = np.zeros_like(wire_t)
        x = wire_t - ref_w
        payload, nbytes = self.codec.encode(x, key=self.key)
        dec = self.codec.decode(payload, x.size)
        self._ref = self.unflatten(ref_w + dec, target, masks_np)
        bc = tree_map(lambda d, p: d.to(p.dtype),
                      to_device(self._ref, target), target)
        return bc, nbytes


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

class UploadPipeline:
    """flatten → clip → codec(+EF) → field snap → bytes → links → aggregate.

    One instance per run; per-endpoint state (EF residuals, PowerSGD warm
    factors, broadcast channels) is keyed by client id / endpoint name.
    ``fc`` is validated as the server validates it.  With a ``strategy``
    the identity codec's bytes are its ``comm_up``/``comm_down`` and the
    wire the CommPru wire; with ``strategy=None`` and the
    ``flatten``/``unflatten`` hooks (SLoRA stage 1) they are the wire's f32
    values, the length header and the mask bitfield.  ``stage`` labels the
    metrics: ``stage2`` (the adapters' rounds) or ``stage1`` (SLoRA's)."""

    def __init__(self, fc, strategy=None, flatten=None, unflatten=None,
                 stage: str = "stage2"):
        from repro_torch.federated.server import validate_config
        from repro_torch.secagg import protocol as SA
        validate_config(fc)
        self.fc = fc
        self.strategy = strategy
        self.stage = stage
        self.codec = make_fc_codec(fc)
        self.flatten = flatten or T.flatten_update
        self.unflatten = unflatten or T.unflatten_update
        self._resid: dict[Any, np.ndarray] = {}
        self._down: dict[Any, DeltaChannel] = {}
        self.field_spec = SA.field_spec(fc) if fc.secagg != "off" else None

    # ---- downlink ----------------------------------------------------------

    def broadcast(self, trainable: Any, masks_np: Any | None,
                  endpoint: Any = "down") -> tuple[Any, int]:
        """Server→client broadcast through the endpoint's DeltaChannel.
        Returns (what the client reconstructs, per-client down bytes).

        The seq runner uses one shared ``"down"`` endpoint: the downlink is
        modeled as a *multicast* delta stream every client follows, so a
        client first selected in round r is assumed caught up on rounds
        0..r−1 for free (as in the reference)."""
        psp = OBS.get_tracer().begin("broadcast", kind="pipeline",
                                     endpoint=str(endpoint))
        ch = self._down.get(endpoint)
        if ch is None:
            ch = self._down[endpoint] = DeltaChannel(
                self.codec, self.flatten, self.unflatten, ("down", endpoint))
        bc, nbytes = ch.send(trainable, masks_np)
        if self.codec is None:
            if self.strategy is not None:
                total = self.strategy.comm_down(trainable, masks_np)
            else:
                wire = self.flatten(trainable, masks_np)
                total = wire.size * 4 + T.HEADER_BYTES \
                    + T.mask_wire_bytes(masks_np)
        else:
            total = nbytes + T.mask_wire_bytes(masks_np)
        m = OBS.get_metrics()
        if m.enabled:
            m.counter("pipeline.down_bytes", codec=self.fc.codec,
                      stage=self.stage).inc(int(total))
        psp.end(nbytes=int(total))
        return bc, total

    # ---- uplink ------------------------------------------------------------

    def encode(self, upd: ClientUpdate, masks_np: Any | None
               ) -> EncodedUpdate:
        """Run one ClientUpdate through the wire stages."""
        fc = self.fc
        x = self.flatten(upd.delta, masks_np)
        r = self._resid.get(upd.cid) if self.codec is not None else None
        if r is not None and r.shape == x.shape:
            x = x + r
        norm = float(np.linalg.norm(x))
        clipped = False
        if fc.dp_clip > 0:
            x, norm = DP.clip_to_norm(x, fc.dp_clip)
            clipped = norm > fc.dp_clip
        if self.codec is not None:
            payload, nbytes = self.codec.encode(x, key=upd.cid)
            dec = self.codec.decode(payload, x.size)
            if self.field_spec is not None:
                # residual against the field-quantized decode — exactly what
                # the masked sum aggregates — so EF never fights the field
                dec = self.field_spec.decode_sum(self.field_spec.encode(dec))
            self._resid[upd.cid] = x - dec
            nbytes += T.mask_wire_bytes(masks_np)
        else:
            dec = x
            if self.strategy is not None:
                nbytes = self.strategy.comm_up(upd.delta, masks_np)
            else:
                nbytes = dec.size * 4 + T.HEADER_BYTES \
                    + T.mask_wire_bytes(masks_np)
        if fc.secagg != "off":
            nbytes = 0        # the protocol's masked phase prices the upload
        m = OBS.get_metrics()
        if m.enabled:
            m.counter("pipeline.up_bytes", codec=fc.codec,
                      stage=self.stage).inc(int(nbytes))
            m.counter("pipeline.updates", codec=fc.codec,
                      stage=self.stage).inc()
            if clipped:
                m.counter("dp.clip_events", stage=self.stage).inc()
            ef_norm = 0.0
            if self.codec is not None:
                ef_norm = float(np.sqrt(_sq_norm(self._resid[upd.cid])))
                m.histogram("pipeline.ef_residual_norm",
                            codec=fc.codec).observe(ef_norm)
            # per-update encode event: the EF-residual stream the health
            # monitor watches for codec blowup (plus clip/byte forensics)
            OBS.get_tracer().event(
                "encode", cid=int(upd.cid), norm=float(norm),
                ef_norm=ef_norm, clipped=bool(clipped),
                nbytes=int(nbytes), stage=self.stage)
        return EncodedUpdate(
            cid=upd.cid, wire=dec,
            delta=self.unflatten(dec, upd.delta, masks_np), nbytes=nbytes,
            weight=upd.weight, votes=upd.votes, clipped=clipped, norm=norm,
            n_steps=upd.n_steps, staleness=upd.staleness)

    # ---- link pricing ------------------------------------------------------

    def client_time(self, cid: int, down_bytes: int, up_bytes: int,
                    compute_s: float) -> float:
        """One client's simulated round time: compute + one round-trip
        transfer of its down+up payloads over its device class's link."""
        return compute_s + self.link_of(cid).transfer_s(down_bytes + up_bytes)

    @staticmethod
    def link_of(cid: int) -> T.Link:
        return T.link_for(DV.device_of(int(cid)))

    # ---- aggregation -------------------------------------------------------

    def _emit_drift(self, encoded: list[EncodedUpdate],
                    rnd: int | None = None) -> None:
        """Client-drift dispersion of this aggregation's decoded wires:
        ``1 − mean pairwise cosine`` over unit-normalized wires, computed as
        ``(‖Σu‖² − n) / (n(n−1))`` — one O(n·d) pass, no pairwise matrix
        (the health monitor alerts when it crosses its threshold).  The
        reference stacks the wires in f64 first; this sums them one at a
        time into one f64 buffer, the same quantity at a third of the host
        time on a full-width wire."""
        tr = OBS.get_tracer()
        if not tr.enabled or len(encoded) < 2:
            return
        flat = [np.asarray(e.wire).reshape(-1) for e in encoded]
        if len({w.size for w in flat}) != 1:
            return      # async buffers can mix mask vintages → wire lengths
        s = np.zeros(flat[0].size, np.float64)
        u = np.empty_like(s)
        n = 0
        for w in flat:
            nrm = np.sqrt(_sq_norm(w))
            if nrm > 0:
                np.multiply(w, 1.0 / nrm, out=u, dtype=np.float64)
                s += u
                n += 1
        if n < 2:
            return
        mean_cos = (_sq_norm(s) - n) / (n * (n - 1))
        tr.event("drift", rnd=rnd, n=int(n), mean_cos=mean_cos,
                 dispersion=1.0 - mean_cos)
        tr.metrics.histogram("pipeline.drift_dispersion").observe(
            1.0 - mean_cos)

    def aggregate(self, global_tree: Any, encoded: list[EncodedUpdate],
                  rnd: int | None = None) -> Any:
        """Plain weighted delta-space FedAvg applied to the broadcast state.
        With the identity codec this equals param-space FedAvg exactly:
        Σŵ·(bc+Δᵢ) = bc + Σŵ·Δᵢ."""
        if not encoded:
            return global_tree
        psp = OBS.get_tracer().begin("aggregate", kind="pipeline",
                                     n_updates=len(encoded))
        self._emit_drift(encoded, rnd)
        w = np.asarray([e.weight for e in encoded], np.float64)
        w = (w / w.sum()).astype(np.float32)
        flats = [flatten_with_keys(e.delta) for e in encoded]
        avg = []
        for j, (keys, leaf) in enumerate(flats[0]):
            acc = leaf * w[0]
            for wi, fl in zip(w[1:], flats[1:]):
                acc = acc + fl[j][1] * wi
            avg.append((keys, acc))
        out = apply_delta(global_tree, unflatten_keys(avg, global_tree))
        psp.end()
        return out

    def aggregate_private(self, bc: Any, encoded: list[EncodedUpdate],
                          participants, masks_np: Any | None, rnd: int):
        """secagg/DP aggregation of the same encoded wires (field sums,
        dropout recovery, vote sums, noise) — secagg.protocol owns it."""
        from repro_torch.secagg import protocol as SA
        psp = OBS.get_tracer().begin("aggregate_private", kind="pipeline",
                                     n_updates=len(encoded))
        self._emit_drift(encoded, int(rnd))
        out = SA.aggregate_round(bc, encoded,
                                 [int(c) for c in participants], masks_np,
                                 self.fc, rnd, link_of=self.link_of,
                                 unflatten=self.unflatten)
        psp.end(up_bytes=int(out.up_bytes), down_bytes=int(out.down_bytes),
                aborted=out.aborted)
        return out
