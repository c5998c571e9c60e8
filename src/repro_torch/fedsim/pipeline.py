"""Delta-space upload pipeline (reference: ``repro/fedsim/pipeline.py``),
the slice with no codec, no error feedback, no DP clip and no secure
aggregation:

    flatten (CommPru wire) → byte accounting → link pricing → aggregate

Every client upload is a ``ClientUpdate`` (delta tree + weight).
The wire keeps the surviving ranks only, so a masked rank's delta arrives as
zero; with the identity codec, delta-space FedAvg equals param-space FedAvg
exactly.  Deltas and the average live on the host in float32, as in the
reference; each crossing between the card and the host is one copy of the
whole tree.  Codecs, EF, the DP clip and the field snap raise here rather
than pass through (ROADMAP.md queue 1 items 9 and 10).
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
    the delta crosses to the device in one copy."""
    items = flatten_with_keys(global_tree)
    dflat = dict(flatten_with_keys(delta))
    host = np.concatenate([np.asarray(dflat[k], np.float32).reshape(-1)
                           for k, _ in items])
    dev = torch.from_numpy(host).to(items[0][1].device)
    out, off = [], 0
    for keys, p in items:
        n = p.numel()
        d = dev[off:off + n].view(p.shape)
        out.append((keys, (p.float() + d).to(p.dtype)))
        off += n
    return unflatten_keys(out)


class UploadPipeline:
    """flatten → bytes → links → aggregate, for the identity codec.

    ``fc`` is validated as the server validates it, so a codec, secure
    aggregation or DP raise here rather than pass through."""

    def __init__(self, fc, strategy):
        from repro_torch.federated.server import validate_config
        validate_config(fc)
        self.fc = fc
        self.strategy = strategy

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
        wire = T.flatten_update(upd.delta, masks_np)
        return EncodedUpdate(
            cid=upd.cid, delta=T.unflatten_update(wire, upd.delta, masks_np),
            nbytes=self.strategy.comm_up(upd.delta, masks_np),
            weight=upd.weight, n_steps=upd.n_steps)

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
            acc = np.asarray(leaf, np.float32) * w[0]
            for wi, fl in zip(w[1:], flats[1:]):
                acc = acc + np.asarray(fl[j][1], np.float32) * wi
            avg.append((keys, acc))
        return apply_delta(global_tree, unflatten_keys(avg))
