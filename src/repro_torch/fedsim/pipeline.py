"""Delta-space upload pipeline (reference: ``repro/fedsim/pipeline.py``),
the slice with no codec, no error feedback, no DP clip and no secure
aggregation:

    flatten → byte accounting → link pricing → aggregate

Every client upload is a ``ClientUpdate`` (delta tree + weight).  By default
the wire is the CommPru trainable wire: it keeps the surviving ranks only,
so a masked rank's delta arrives as zero; with the identity codec,
delta-space FedAvg equals param-space FedAvg exactly.  Those deltas and the
average live on the host in float32, as in the reference; each crossing
between the card and the host is one copy of the whole tree.

SLoRA's stage 1 builds its pipeline with ``strategy=None`` and the
sparse-gate pair :func:`flatten_gate` / :func:`unflatten_gate`: its base
deltas stay on the device and only the gate's support (about 5% of the
base) crosses to the host and back.  Codecs, EF, the DP clip and the field
snap raise here rather than pass through (ROADMAP.md queue 1 items 9 and
10).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.federated import devices as DV
from repro_torch.fedsim import transport as T
from repro_torch.pytree import flatten_with_keys, tree_map, unflatten_keys


@dataclasses.dataclass
class ClientUpdate:
    """What a producer hands the pipeline: one client's round contribution."""
    cid: int
    delta: Any                      # f32 delta tree (global-state structure)
    weight: float                   # aggregation weight (data size)
    n_steps: int = 0                # local batches run (compute pricing)


@dataclasses.dataclass
class EncodedUpdate:
    """A ClientUpdate after the wire stages: what the server aggregates."""
    cid: int
    delta: Any                      # the f32 wire as a delta tree
    nbytes: int                     # exact upload bytes
    weight: float
    n_steps: int = 0


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
    return unflatten_keys(out)


def delta_tree(params: Any, ref: Any) -> Any:
    """f32 delta between two structurally equal trees of tensors, on the
    host (the f32 subtraction runs on the device, then one copy)."""
    return to_host(tree_map(lambda a, b: a.float() - b.float(), params, ref))


def apply_delta(global_tree: Any, delta: Any) -> Any:
    """global + delta, accumulated in f32, cast back to the global dtypes;
    a host delta crosses to the device in one copy, a device delta stays
    there."""
    items = flatten_with_keys(global_tree)
    dflat = dict(flatten_with_keys(delta))
    flat = torch.cat([torch.as_tensor(dflat[k], dtype=torch.float32)
                      .reshape(-1) for k, _ in items])
    dev = flat.to(items[0][1].device)
    out, off = [], 0
    for keys, p in items:
        n = p.numel()
        d = dev[off:off + n].view(p.shape)
        out.append((keys, (p.float() + d).to(p.dtype)))
        off += n
    return unflatten_keys(out)


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
    return unflatten_keys(out)


class UploadPipeline:
    """flatten → bytes → links → aggregate, for the identity codec.

    ``fc`` is validated as the server validates it, so a codec, secure
    aggregation or DP raise here rather than pass through.  With a
    ``strategy`` the bytes are its ``comm_up`` and the wire the CommPru
    wire; with ``strategy=None`` and the ``flatten``/``unflatten`` hooks
    (SLoRA stage 1) the bytes are the wire's f32 values, the length header
    and the mask bitfield."""

    def __init__(self, fc, strategy=None, flatten=None, unflatten=None):
        from repro_torch.federated.server import validate_config
        validate_config(fc)
        self.fc = fc
        self.strategy = strategy
        self.flatten = flatten or T.flatten_update
        self.unflatten = unflatten or T.unflatten_update

    # ---- downlink ----------------------------------------------------------

    def broadcast(self, trainable: Any, masks_np: Any | None
                  ) -> tuple[Any, int]:
        """Server→client broadcast: (what the client holds, per-client down
        bytes).  With no codec the client holds the server's tree."""
        return trainable, self.strategy.comm_down(trainable, masks_np)

    # ---- uplink ------------------------------------------------------------

    def encode(self, upd: ClientUpdate, masks_np: Any | None
               ) -> EncodedUpdate:
        """One ClientUpdate through the wire stages."""
        wire = self.flatten(upd.delta, masks_np)
        if self.strategy is not None:
            nbytes = self.strategy.comm_up(upd.delta, masks_np)
        else:
            nbytes = wire.size * 4 + T.HEADER_BYTES \
                + T.mask_wire_bytes(masks_np)
        return EncodedUpdate(
            cid=upd.cid, delta=self.unflatten(wire, upd.delta, masks_np),
            nbytes=nbytes, weight=upd.weight, n_steps=upd.n_steps)

    # ---- link pricing ------------------------------------------------------

    def client_time(self, cid: int, down_bytes: int, up_bytes: int,
                    compute_s: float) -> float:
        """One client's simulated round time: compute + one round-trip
        transfer of its down+up payloads over its device class's link."""
        return compute_s + T.link_for(DV.device_of(int(cid))).transfer_s(
            down_bytes + up_bytes)

    # ---- aggregation -------------------------------------------------------

    def aggregate(self, global_tree: Any, encoded: list[EncodedUpdate]
                  ) -> Any:
        """Weighted delta-space FedAvg applied to the broadcast state."""
        if not encoded:
            return global_tree
        w = np.asarray([e.weight for e in encoded], np.float64)
        w = (w / w.sum()).astype(np.float32)
        flats = [flatten_with_keys(e.delta) for e in encoded]
        avg = []
        for j, (keys, leaf) in enumerate(flats[0]):
            acc = leaf * w[0]
            for wi, fl in zip(w[1:], flats[1:]):
                acc = acc + fl[j][1] * wi
            avg.append((keys, acc))
        return apply_delta(global_tree, unflatten_keys(avg))
