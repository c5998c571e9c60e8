"""Adapter registry: per-tenant FedARA adapter trees, normalized for serving
(reference: ``repro/serving/registry.py``).

At registration every tenant's tree is made bucket-homogeneous:

  - rank axes are zero-padded up to the tenant's rank bucket (smallest
    configured bucket ≥ r_t) with masks extended by False — a masked rank is
    exactly free (CommPru), so padding is semantically free;
  - the tenant scaling is folded into the diagonal E (into B for pure-LoRA
    adapters), so heterogeneous α/r_t tenants share the engine's one
    scaling constant;
  - memory accounting (bytes of the padded trees) drives LRU eviction with
    pinning and engine-held refcounts.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch.pytree import tensor_bytes


class RegistryFullError(RuntimeError):
    """Capacity exceeded and nothing is evictable (all pinned / in use)."""


def bucket_for(rank: int, bucket_sizes: tuple[int, ...]) -> int:
    """Smallest configured bucket ≥ rank (rank itself past the largest)."""
    for b in bucket_sizes:
        if b >= rank:
            return b
    return rank


def _pad_axis(arr: torch.Tensor, axis: int, new: int) -> torch.Tensor:
    old = arr.shape[axis]
    if old == new:
        return arr
    axis = axis % arr.ndim
    pad = [0, 0] * (arr.ndim - 1 - axis) + [0, new - old]
    return F.pad(arr, pad)


def pad_adapters(ad_tree: Any, mask_tree: Any, bucket: int, ratio: float):
    """Pad every BEA/LoRA module to ``bucket`` ranks and fold the scaling
    ratio; returns (padded_adapters, padded_masks).

    Module dicts are {"A": (r, K), "B": (N, r)[, "E": (r,)]}; the mask leaf
    at the same path is (r,).
    """
    if isinstance(ad_tree, dict) and "A" in ad_tree and "B" in ad_tree:
        out = {"A": _pad_axis(ad_tree["A"], -2, bucket)}
        if "E" in ad_tree:
            out["B"] = _pad_axis(ad_tree["B"], -1, bucket)
            out["E"] = _pad_axis(ad_tree["E"] * ratio, -1, bucket)
        else:                               # pure LoRA: fold ratio into B
            out["B"] = _pad_axis(ad_tree["B"] * ratio, -1, bucket)
        if mask_tree is None:
            raise ValueError("BEA/LoRA module without a rank mask")
        pm = _pad_axis(mask_tree.to(torch.bool), -1, bucket)
        return out, pm
    if isinstance(ad_tree, dict):
        if "down" in ad_tree:
            raise NotImplementedError(
                "bottleneck adapters are not rank-bucketable; serve BEA/LoRA")
        ads, msks = {}, {}
        for k, v in ad_tree.items():
            sub_m = mask_tree.get(k) if isinstance(mask_tree, dict) else None
            ads[k], msks[k] = pad_adapters(v, sub_m, bucket, ratio)
        return ads, msks
    if isinstance(ad_tree, list):
        pairs = [pad_adapters(v, mask_tree[i] if mask_tree else None,
                              bucket, ratio) for i, v in enumerate(ad_tree)]
        return [a for a, _ in pairs], [m for _, m in pairs]
    raise ValueError(f"unexpected adapter leaf {type(ad_tree)!r}")


@dataclasses.dataclass
class AdapterEntry:
    adapter_id: str
    serial: int                   # monotone — cache keys survive re-register
    rank: int                     # tenant's live rank
    bucket: int                   # padded rank bucket
    adapters: Any                 # padded {"dec": ...} adapter tree
    masks: Any                    # padded mask tree
    nbytes: int
    pinned: bool = False
    refcount: int = 0
    hits: int = 0

    @property
    def evictable(self) -> bool:
        return not self.pinned and self.refcount == 0


class AdapterRegistry:
    """LRU adapter store keyed by adapter_id.

    ``serving_scaling`` is the engine model's α/max(r, 1) constant; tenant
    adapters registered with their own (alpha, rank) are refolded against it.
    """

    def __init__(self, serving_scaling: float,
                 bucket_sizes: tuple[int, ...] = (4, 8, 16, 32, 64),
                 capacity_bytes: int | None = None,
                 max_entries: int | None = None,
                 loader: Callable[[str], dict] | None = None):
        if serving_scaling <= 0:
            raise ValueError("serving_scaling must be positive")
        self.serving_scaling = float(serving_scaling)
        self.bucket_sizes = tuple(sorted(bucket_sizes))
        self.capacity_bytes = capacity_bytes
        self.max_entries = max_entries
        self.loader = loader
        self._entries: OrderedDict[str, AdapterEntry] = OrderedDict()
        self._serial = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # ---- core ------------------------------------------------------------

    def register(self, adapter_id: str, trainable: Any, masks: Any, *,
                 rank: int | None = None, alpha: float | None = None,
                 scaling: float | None = None, pin: bool = False
                 ) -> AdapterEntry:
        """Normalize + admit one tenant's adapters.

        ``trainable`` is a Model trainable tree ({"adapters": ...}) or a bare
        adapter tree; ``scaling`` overrides the tenant α/r (default: α=16
        convention via ``alpha`` and the tree's own rank).
        """
        ad = trainable.get("adapters", trainable) if isinstance(
            trainable, dict) else trainable
        if rank is None:
            rank = _infer_rank(ad)
        if scaling is None:
            scaling = (16.0 if alpha is None else alpha) / max(rank, 1)
        bucket = bucket_for(rank, self.bucket_sizes)
        ratio = scaling / self.serving_scaling
        padded, pmasks = pad_adapters(ad, masks, bucket, ratio)
        self._serial += 1
        entry = AdapterEntry(
            adapter_id=adapter_id, serial=self._serial, rank=rank,
            bucket=bucket, adapters=padded, masks=pmasks,
            nbytes=tensor_bytes(padded) + tensor_bytes(pmasks), pinned=pin)
        old = self._entries.pop(adapter_id, None)
        if old is not None:
            entry.refcount = old.refcount     # live requests keep their hold
            entry.pinned = pin or old.pinned  # re-register never drops a pin
        self._entries[adapter_id] = entry
        try:
            self._evict_to_fit(exclude=adapter_id)
        except RegistryFullError:
            # atomic failure: refuse the new entry, restore the old one
            del self._entries[adapter_id]
            if old is not None:
                self._entries[adapter_id] = old
            raise
        return entry

    def get(self, adapter_id: str) -> AdapterEntry:
        """LRU-touching lookup; falls back to ``loader`` on a miss."""
        entry = self._entries.get(adapter_id)
        if entry is None:
            self.misses += 1
            if self.loader is None:
                raise KeyError(adapter_id)
            spec = self.loader(adapter_id)
            entry = self.register(adapter_id, **spec)
        else:
            self.hits += 1
            entry.hits += 1
            self._entries.move_to_end(adapter_id)
        return entry

    def acquire(self, adapter_id: str) -> AdapterEntry:
        """get() + refcount hold, so live adapters are never evicted."""
        entry = self.get(adapter_id)
        entry.refcount += 1
        return entry

    def release(self, adapter_id: str) -> None:
        entry = self._entries[adapter_id]
        if entry.refcount <= 0:
            raise RuntimeError(f"release() without acquire(): {adapter_id}")
        entry.refcount -= 1

    # ---- eviction / pinning ----------------------------------------------

    def pin(self, adapter_id: str) -> None:
        self._entries[adapter_id].pinned = True

    def unpin(self, adapter_id: str) -> None:
        self._entries[adapter_id].pinned = False

    def evict(self, adapter_id: str) -> None:
        entry = self._entries.get(adapter_id)
        if entry is None:
            return
        if not entry.evictable:
            raise RegistryFullError(
                f"{adapter_id} is pinned or held by live requests")
        del self._entries[adapter_id]
        self.evictions += 1

    def _evict_to_fit(self, exclude: str | None = None) -> None:
        def over(n_entries, n_bytes):
            if self.max_entries is not None and n_entries > self.max_entries:
                return True
            return self.capacity_bytes is not None and \
                n_bytes > self.capacity_bytes

        # feasibility first (atomicity): would evicting every evictable
        # entry suffice?  If not, raise before touching anything.
        keep = [v for k, v in self._entries.items()
                if not v.evictable or k == exclude]
        if over(len(keep), sum(v.nbytes for v in keep)):
            raise RegistryFullError(
                "registry over capacity and every entry is pinned or "
                "attached to a live request")
        while over(len(self._entries), self.host_bytes):
            victim = next(k for k, v in self._entries.items()
                          if v.evictable and k != exclude)
            del self._entries[victim]
            self.evictions += 1

    # ---- introspection ----------------------------------------------------

    def __contains__(self, adapter_id: str) -> bool:
        return adapter_id in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def ids(self) -> list[str]:
        return list(self._entries)

    def live_serials(self) -> set[int]:
        return {e.serial for e in self._entries.values()}

    @property
    def host_bytes(self) -> int:
        """Bytes of the resident padded trees (on whatever device they
        live)."""
        return sum(e.nbytes for e in self._entries.values())

    def stats(self) -> dict:
        return {"entries": len(self._entries),
                "host_bytes": self.host_bytes,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "buckets": sorted({e.bucket
                                   for e in self._entries.values()})}


def _infer_rank(ad_tree: Any) -> int | None:
    """Live rank = rank axis of any A leaf (uniform across modules)."""
    if isinstance(ad_tree, dict) and "A" in ad_tree:
        return ad_tree["A"].shape[-2]
    children = (ad_tree.values() if isinstance(ad_tree, dict)
                else ad_tree if isinstance(ad_tree, list) else ())
    for v in children:
        r = _infer_rank(v)
        if r is not None:
            return r
    return None
