"""CommPru (reference: ``repro/core/comm.py``; paper §IV-B3): mask-pruned
parameter transmission and byte-exact accounting.

A rank's triplet for a module with dims (d_in, d_out) costs
``d_in + d_out (+1 for E)`` parameters, times the experts for a per-expert
module (A (E, r, d_in), B (E, d_out, r), E (E, r)).  Masks travel as
booleans (1 bit each) and are counted.  ``pack``/``unpack`` give the wire
format (surviving ranks only, in tree order; a per-expert rank's rows
expert by expert); ``prune_tree`` zeroes masked ranks in place of sending
them.  The port's modules are per layer, never stacked, so every mask is
(r,), a per-expert module's shared by its experts.  The codecs that travel on this wire (blockwise int8, top-k,
signSGD, PowerSGD) are in ``fedsim/transport.py``; the reference's
per-tensor ``pack_int8``, which only its tests call, is not ported.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import importance as IMP
from repro_torch.core import masks as MK
from repro_torch.pytree import child


def iter_modules(adapters: Any, masks: Any, path=""):
    """(dotted path, module, its mask or None) in tree order."""
    if IMP.is_module(adapters):
        yield path, adapters, masks
        return
    items = (sorted(adapters.items()) if isinstance(adapters, dict)
             else enumerate(adapters) if isinstance(adapters, list) else ())
    for k, v in items:
        yield from iter_modules(v, child(masks, k),
                                f"{path}.{k}" if path else str(k))


def module_rank_params(mod: dict) -> int:
    """Parameters per surviving (rank, expert) unit: d_in + d_out [+1]."""
    return mod["A"].shape[-1] + mod["B"].shape[-2] + (1 if "E" in mod else 0)


def n_experts_of(mod: dict) -> int:
    """The experts a module's (r,) mask spans: 1 unless A is (E, r, d_in)."""
    return int(np.prod(tuple(mod["A"].shape[:-2])))


def count_params(adapters: Any, masks: Any | None = None) -> int:
    """Total parameters that CommPru would transmit."""
    total = 0
    for _, mod, msk in iter_modules(adapters, masks or {}):
        r = mod["A"].shape[-2]
        live = r if msk is None else int(np.asarray(msk, bool).sum())
        total += module_rank_params(mod) * n_experts_of(mod) * live
    return total


def bytes_down(adapters: Any, masks: Any | None, dtype_bytes: int = 4,
               extra_params: int = 0) -> int:
    """Server → client: pruned adapters + the global mask."""
    n = count_params(adapters, masks) + extra_params
    mask_bits = MK.total_ranks(masks) if masks else 0
    return n * dtype_bytes + (mask_bits + 7) // 8


def bytes_up(adapters: Any, masks: Any | None, dtype_bytes: int = 4,
             extra_params: int = 0) -> int:
    """Client → server: pruned adapters + the local mask."""
    return bytes_down(adapters, masks, dtype_bytes, extra_params)


def prune_tree(adapters: Any, masks: Any | None):
    """Zero all masked-out ranks (transmission-equivalent state).  Returns
    new tensors; the input tree is not written."""
    if masks is None:
        return adapters

    def prune_module(mod, msk):
        # (r,) broadcasts over a per-expert module's leading expert axis
        m = torch.as_tensor(np.asarray(msk, bool), device=mod["A"].device)
        out = dict(mod)
        out["A"] = mod["A"] * m[:, None].to(mod["A"].dtype)
        out["B"] = mod["B"] * m[None, :].to(mod["B"].dtype)
        if "E" in mod:
            out["E"] = mod["E"] * m.to(mod["E"].dtype)
        return out

    def walk(ad, msk):
        if IMP.is_module(ad):
            return prune_module(ad, msk) if msk is not None else ad
        if isinstance(ad, dict):
            return {k: walk(v, child(msk, k)) for k, v in ad.items()}
        if isinstance(ad, list):
            return [walk(v, child(msk, i)) for i, v in enumerate(ad)]
        return ad

    return walk(adapters, masks)


def pack(adapters: Any, masks: Any | None) -> np.ndarray:
    """Wire format: per module, the surviving ranks' rows of A, then their
    columns of B, then their entries of E (a per-expert module: rank-major,
    each rank's experts in order), modules in tree order."""
    parts = []
    for _, mod, msk in iter_modules(adapters, masks or {}):
        a, b = IMP.to_np(mod["A"]), IMP.to_np(mod["B"])
        sel = (np.ones(a.shape[-2], bool) if msk is None
               else np.asarray(msk, bool))
        parts += [np.moveaxis(a[..., sel, :], -2, 0).reshape(-1),
                  np.moveaxis(b[..., sel], -1, 0).reshape(-1)]
        if "E" in mod:
            parts.append(np.moveaxis(IMP.to_np(mod["E"])[..., sel], -1,
                                     0).reshape(-1))
    if not parts:
        return np.zeros((0,), np.float32)
    return np.concatenate(parts)


def unpack(wire: np.ndarray, adapters_like: Any, masks: Any | None) -> Any:
    """Inverse of :func:`pack`: masked ranks come back as zeros (numpy)."""
    off = 0

    def take(n):
        nonlocal off
        v = wire[off:off + n]
        off += n
        return v

    def walk(ad, msk):
        if IMP.is_module(ad):
            a = np.zeros(tuple(ad["A"].shape), np.float32)
            b = np.zeros(tuple(ad["B"].shape), np.float32)
            sel = (np.ones(a.shape[-2], bool) if msk is None
                   else np.asarray(msk, bool))
            n, lead = int(sel.sum()), a.shape[:-2]
            a[..., sel, :] = np.moveaxis(take(n * a[..., 0, :].size).reshape(
                (n,) + lead + a.shape[-1:]), 0, -2)
            b[..., sel] = np.moveaxis(take(n * b[..., 0].size).reshape(
                (n,) + lead + b.shape[-2:-1]), 0, -1)
            out = {"A": a, "B": b}
            if "E" in ad:
                e = np.zeros(tuple(ad["E"].shape), np.float32)
                e[..., sel] = np.moveaxis(take(n * e[..., 0].size).reshape(
                    (n,) + lead), 0, -1)
                out["E"] = e
            return out
        if isinstance(ad, dict):
            return {k: walk(ad[k], child(msk, k)) for k in sorted(ad)}
        if isinstance(ad, list):
            return [walk(v, child(msk, i)) for i, v in enumerate(ad)]
        return ad

    return walk(adapters_like, masks)
