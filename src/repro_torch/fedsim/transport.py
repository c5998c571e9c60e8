"""Quantized transport stack (reference: ``repro/fedsim/transport.py``).

CommPru (core/comm.py) decides *which* parameters travel — the surviving-rank
wire vector.  This module decides *how* they travel: a pluggable ``Codec``
layered on the CommPru wire format (identity f32, blockwise int8 with
per-block scales, top-k sparsification, 1-bit signSGD, low-rank PowerSGD),
an ``ErrorFeedback`` wrapper with per-endpoint residual memory (Seide et al.
2014 / FedPAQ-style compensation), and a per-device-class bandwidth/latency
``Link`` model.

Codecs act on *delta* wires — what a client's local training changed, never
the raw parameters (fedsim/pipeline.py owns the delta framing).  Stateful
codecs (PowerSGD's warm-started Q) key their per-endpoint state on the same
``key`` the ``ErrorFeedback`` wrapper uses, so every endpoint's stream is
independent and deterministic.

All codecs keep byte-exact accounting: ``encode`` returns the true payload
size (values + scales/indices/factors + a 4-byte length header).  The codecs
are host numpy, as in the reference, so their payloads equal the
reference's bit for bit: PowerSGD's initial Q is a numpy ``default_rng``
draw and its QR runs in f64 numpy, which torch cannot reproduce.  The wire
of a FedARA client at DistilBERT's full width is about 1M floats.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Protocol

import numpy as np
import torch

from repro_torch.core import comm as COMM
from repro_torch.core import importance as IMP
from repro_torch.core import masks as MK
from repro_torch.federated import devices as DV
from repro_torch.pytree import flatten_with_keys, tree_map, unflatten_keys

HEADER_BYTES = 4          # uint32 payload length prefix on every message


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------

class Codec(Protocol):
    name: str
    field_exact: bool   # decoded wire composes with secagg's fixed-point sum

    def encode(self, wire: np.ndarray, key: Any = None) -> tuple[Any, int]:
        """wire (f32 vector) → (payload, exact wire bytes incl. header).
        ``key`` identifies the endpoint for codecs with per-endpoint state
        (PowerSGD's warm-started Q); stateless codecs ignore it."""
        ...

    def decode(self, payload: Any, size: int) -> np.ndarray:
        """payload → f32 vector of ``size`` (lossy codecs reconstruct)."""
        ...


@dataclasses.dataclass
class Identity:
    """f32 pass-through — the CommPru baseline wire."""
    name: str = "identity"
    field_exact = True

    def encode(self, wire, key=None):
        w = np.asarray(wire, np.float32)
        return w, w.size * 4 + HEADER_BYTES

    def decode(self, payload, size):
        return np.asarray(payload, np.float32)[:size]


@dataclasses.dataclass
class Int8Block:
    """Symmetric blockwise int8: per-block f32 absmax scale (QSGD-adjacent).

    4× fewer payload bytes than f32 plus ``4·n_blocks`` scale bytes; the
    per-element error is bounded by ``scale/2 = absmax/254`` per block.
    """
    block: int = 256
    name: str = "int8"
    field_exact = False

    def encode(self, wire, key=None):
        w = np.asarray(wire, np.float32)
        n = w.size
        if n == 0:
            return (np.zeros((0,), np.int8), np.zeros((0,), np.float32)), \
                HEADER_BYTES
        nb = -(-n // self.block)
        pad = np.zeros(nb * self.block, np.float32)
        pad[:n] = w
        blocks = pad.reshape(nb, self.block)
        scale = np.abs(blocks).max(axis=1) / 127.0
        scale[scale == 0.0] = 1.0
        q = np.clip(np.round(blocks / scale[:, None]), -127, 127).astype(np.int8)
        return (q, scale.astype(np.float32)), n + 4 * nb + HEADER_BYTES

    def decode(self, payload, size):
        q, scale = payload
        if q.size == 0:
            return np.zeros((size,), np.float32)
        deq = (q.astype(np.float32) * scale[:, None]).reshape(-1)
        return deq[:size]


@dataclasses.dataclass
class TopK:
    """Magnitude top-k sparsification: int32 indices + f32 values."""
    frac: float = 0.1
    name: str = "topk"
    field_exact = False

    def encode(self, wire, key=None):
        w = np.asarray(wire, np.float32)
        n = w.size
        k = min(n, max(1, int(round(n * self.frac)))) if n else 0
        if k == 0:
            return (np.zeros((0,), np.int32), np.zeros((0,), np.float32)), \
                HEADER_BYTES
        idx = np.argpartition(-np.abs(w), k - 1)[:k].astype(np.int32)
        idx.sort()
        return (idx, w[idx]), k * 8 + HEADER_BYTES

    def decode(self, payload, size):
        idx, vals = payload
        out = np.zeros((size,), np.float32)
        out[idx] = vals
        return out


@dataclasses.dataclass
class SignSGD:
    """1-bit sign quantization with a per-block f32 scale (signSGD, Bernstein
    et al. '18; the 1-bit-SGD wire of Seide et al. '14).

    ``scale_b = mean|x_b|`` minimizes ``‖x_b − s·sign(x_b)‖₂`` per block, so
    the decoded wire takes only the values ``±scale_b`` — and per-block
    Cauchy–Schwarz gives ``‖dec_b‖₂ = scale_b·√n_b ≤ ‖x_b‖₂``: decoding never
    *increases* the L2 norm, so a DP clip applied before encoding still
    bounds the transmitted sensitivity, and the sign+scale wire is exactly
    representable in the secagg fixed-point field (``field_exact``).  Wire
    cost: ``⌈n/8⌉`` sign bits + ``4·⌈n/block⌉`` scales + header.  Aggregation
    here stays sum/mean-compatible (the reference has no majority-vote
    server mode either).
    """
    block: int = 256
    name: str = "signsgd"
    field_exact = True

    def encode(self, wire, key=None):
        w = np.asarray(wire, np.float32)
        n = w.size
        if n == 0:
            return (np.zeros((0,), np.uint8), np.zeros((0,), np.float32)), \
                HEADER_BYTES
        nb = -(-n // self.block)
        pad = np.zeros(nb * self.block, np.float32)
        pad[:n] = w
        blocks = pad.reshape(nb, self.block)
        # scale from the real (unpadded) elements only — the tail block's
        # zero padding must not dilute its mean |x|
        counts = np.full(nb, self.block, np.int64)
        counts[-1] = n - (nb - 1) * self.block
        scale = (np.abs(blocks).sum(axis=1) / counts).astype(np.float32)
        bits = np.packbits(blocks >= 0.0, axis=None)
        return (bits, scale), (n + 7) // 8 + 4 * nb + HEADER_BYTES

    def decode(self, payload, size):
        bits, scale = payload
        if scale.size == 0:
            return np.zeros((size,), np.float32)
        signs = np.unpackbits(bits)[:scale.size * self.block]
        signs = np.where(signs > 0, 1.0, -1.0).astype(np.float32)
        dec = signs.reshape(scale.size, self.block) * scale[:, None]
        return dec.reshape(-1)[:size]


@dataclasses.dataclass
class PowerSGD:
    """Rank-q low-rank compression of the delta wire (Vogels et al. '19),
    single-matrix variant: the flat wire reshapes to an ``m×k`` matrix
    (``m = ⌈√n⌉``, zero-padded), one subspace iteration against a warm-started
    per-endpoint ``Q``, and both factors travel: ``P (m×q)`` orthonormalized
    plus ``Q_new = MᵀP (k×q)`` → ``4·q·(m+k)`` payload bytes + header.

    The warm ``Q`` is keyed on the same endpoint key the ``ErrorFeedback``
    wrapper uses, initialized from a deterministic seeded Gaussian, and reset
    whenever the wire length changes (CommPru pruning shrinks the vector
    between rounds).  Decode is the orthogonal projection ``P Pᵀ M``
    (contracts the Frobenius norm), and the error feedback residual carries
    what the subspace missed — power iterations across rounds converge the
    warm ``Q`` onto the delta stream's principal subspace.
    """
    rank: int = 2
    name: str = "powersgd"
    field_exact = False
    _q: dict = dataclasses.field(default_factory=dict, repr=False)

    def encode(self, wire, key=None):
        w = np.asarray(wire, np.float32)
        n = w.size
        if n == 0:
            return (np.zeros((0, 0), np.float32),
                    np.zeros((0, 0), np.float32)), HEADER_BYTES
        m = int(np.ceil(np.sqrt(n)))
        k = -(-n // m)
        q = max(1, min(self.rank, m, k))
        M = np.zeros(m * k, np.float32)
        M[:n] = w
        M = M.reshape(m, k)
        Q = self._q.get(key)
        if Q is None or Q.shape != (k, q):
            Q = np.random.default_rng([k, q]).standard_normal(
                (k, q)).astype(np.float32)
        P = _orthonormalize(M @ Q)
        Q = M.T @ P
        self._q[key] = Q
        return (P, Q), 4 * q * (m + k) + HEADER_BYTES

    def decode(self, payload, size):
        P, Q = payload
        if P.size == 0:
            return np.zeros((size,), np.float32)
        return (P @ Q.T).reshape(-1)[:size].astype(np.float32)


def _orthonormalize(P: np.ndarray) -> np.ndarray:
    """Thin-QR orthonormal basis of P's columns (rank-deficient safe)."""
    Qm, _ = np.linalg.qr(P.astype(np.float64))
    return Qm.astype(np.float32)


_CODECS = {"identity": Identity, "int8": Int8Block, "topk": TopK,
           "signsgd": SignSGD, "powersgd": PowerSGD}

# Codecs whose decoded wire composes with the secagg fixed-point field and
# preserves a pre-encode DP clip bound (see validate_privacy_config) —
# derived from each codec's field_exact flag, the single source of truth.
FIELD_EXACT = tuple(n for n, c in _CODECS.items() if c.field_exact)


def make_codec(name: str, **kw) -> Codec:
    if name not in _CODECS:
        raise ValueError(f"unknown codec {name!r} (have {sorted(_CODECS)})")
    return _CODECS[name](**kw)


class ErrorFeedback:
    """Per-endpoint residual memory around a lossy codec.

    ``roundtrip(key, wire)`` encodes ``wire + residual[key]``, decodes it, and
    stores the new quantization error — so the *cumulative* transmitted signal
    tracks the cumulative true signal with bounded (non-accumulating) error.
    Residuals reset automatically when the wire length changes (CommPru mask
    pruning shrinks the surviving-rank vector between rounds).

    fedsim/pipeline.py runs its own stage chain (residual in → DP clip →
    codec → field snap → residual out) for federated uploads; this wrapper
    stays as the minimal standalone form for tests and ad-hoc use.
    """

    def __init__(self, codec: Codec):
        self.codec = codec
        self._resid: dict[Any, np.ndarray] = {}

    def roundtrip(self, key, wire: np.ndarray) -> tuple[np.ndarray, int]:
        w = np.asarray(wire, np.float32)
        r = self._resid.get(key)
        x = w + r if r is not None and r.shape == w.shape else w
        # ``key`` here is the endpoint id, not a PRNG key
        payload, nbytes = self.codec.encode(x, key=key)  # lint: disable=RL1
        dec = self.codec.decode(payload, x.size)
        self._resid[key] = x - dec
        return dec, nbytes


# ---------------------------------------------------------------------------
# Update (de)flattening — the full upload/broadcast payload, not just adapters
# ---------------------------------------------------------------------------

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
        out.update(unflatten_keys(items, _rest(like)))
    return out


def mask_wire_bytes(masks_np: Any | None) -> int:
    """Rank masks travel as a bitfield alongside every message."""
    return (MK.total_ranks(masks_np) + 7) // 8 if masks_np else 0


def cast_like(dec: Any, like: Any) -> Any:
    """Decoded f32 tree → tensors with the reference tree's leaf dtypes, on
    its leaves' devices."""
    return tree_map(lambda d, x: torch.as_tensor(d, dtype=x.dtype,
                                                 device=x.device), dec, like)


# ---------------------------------------------------------------------------
# Link model
# ---------------------------------------------------------------------------

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
