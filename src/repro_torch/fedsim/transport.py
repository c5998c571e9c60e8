"""Transport of the federated wire (reference: ``repro/fedsim/transport.py``,
its identity-codec slice): the update (de)flattening over the CommPru f32
wire, the mask bitfield and the per-device-class link model.  The codecs
(the reference maps ``identity`` to no codec at all) and error feedback
are not ported yet (ROADMAP.md queue 1 item 9).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core import comm as COMM
from repro_torch.core import importance as IMP
from repro_torch.core import masks as MK
from repro_torch.federated import devices as DV
from repro_torch.pytree import flatten_with_keys, unflatten_keys

HEADER_BYTES = 4          # uint32 payload length prefix on every message


def _rest(tree: Any) -> dict:
    return {k: v for k, v in tree.items() if k != "adapters"}


def flatten_update(trainable: Any, masks_np: Any | None) -> np.ndarray:
    """Trainable tree → f32 wire: CommPru-packed adapters ++ the other leaves
    (the classifier head) in tree order."""
    ad = COMM.pack(trainable.get("adapters", {}), masks_np)
    rest = [IMP.to_np(x).ravel() for _, x in flatten_with_keys(
        _rest(trainable))]
    return np.concatenate([ad] + rest) if rest else ad


def unflatten_update(wire: np.ndarray, like: Any, masks_np: Any | None) -> Any:
    """Inverse of :func:`flatten_update`; masked adapter ranks come back as
    zeros.  Leaves are f32 numpy."""
    n_ad = COMM.count_params(like.get("adapters", {}), masks_np)
    out = {"adapters": COMM.unpack(wire[:n_ad], like.get("adapters", {}),
                                   masks_np)}
    items, off = [], n_ad
    for keys, leaf in flatten_with_keys(_rest(like)):
        n = int(np.prod(tuple(leaf.shape)))
        items.append((keys, wire[off:off + n].reshape(tuple(leaf.shape))
                      .astype(np.float32)))
        off += n
    if items:
        out.update(unflatten_keys(items))
    return out


def mask_wire_bytes(masks_np: Any | None) -> int:
    """Rank masks travel as a bitfield alongside every message."""
    return (MK.total_ranks(masks_np) + 7) // 8 if masks_np else 0


@dataclasses.dataclass(frozen=True)
class Link:
    bandwidth_bps: float = DV.BANDWIDTH
    latency_s: float = 0.0

    def transfer_s(self, nbytes: int) -> float:
        return self.latency_s + nbytes / self.bandwidth_bps


# Device-class links: the paper's 1 MB/s is the RPi5 cellular baseline; the
# Orin classes get progressively better radios (and lower RTT).
DEVICE_LINKS = {
    "rpi5": Link(DV.BANDWIDTH, 0.080),
    "orin_nano": Link(4 * DV.BANDWIDTH, 0.040),
    "agx_orin": Link(10 * DV.BANDWIDTH, 0.020),
}


def link_for(device: str) -> Link:
    return DEVICE_LINKS.get(device, Link())
