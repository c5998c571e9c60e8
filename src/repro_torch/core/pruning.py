"""RankDet / rank-based module pruning (reference: ``repro/core/pruning.py``;
paper §IV-C).

Monitors per-module surviving rank counts each round; when a module's rank
hits zero the whole SVD module becomes non-trainable through a 0/1 gate
multiplied into the optimizer's updates.  Dead ranks are masked in the
forward pass and get zero gradients anyway; the gate only stops the
optimizer from moving them.  ``module_rank_summary`` is the payload of the
trace's ``rank_alloc`` events (``obs.record``); ``adapter_flops_per_token``
counts the live adapter math, per-expert modules times their experts.
Structural pruning of the trainable tree is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.comm import iter_modules, n_experts_of
from repro_torch.core.importance import is_module
from repro_torch.pytree import child, leaves


def trainable_gate(adapters: Any, masks: Any) -> Any:
    """Tree of 0-dim f32 gates aligned with ``adapters`` leaves: 0 for every
    leaf of a module whose mask is all False, else 1."""
    def walk(ad, msk):
        if is_module(ad):
            alive = msk is None or bool(np.asarray(msk, bool).any())
            return {k: torch.tensor(float(alive), device=v.device)
                    for k, v in ad.items()}
        if isinstance(ad, dict):
            return {k: walk(v, child(msk, k)) for k, v in ad.items()}
        if isinstance(ad, list):
            return [walk(v, child(msk, i)) for i, v in enumerate(ad)]
        return torch.ones((), device=ad.device)

    return walk(adapters, masks)


def dead_modules(masks: Any) -> list[str]:
    """Dotted paths of modules whose every rank is pruned."""
    out = []

    def walk(msk, path):
        if isinstance(msk, (dict, list)):
            items = msk.items() if isinstance(msk, dict) else enumerate(msk)
            for k, v in items:
                walk(v, f"{path}.{k}" if path else str(k))
            return
        if not np.asarray(msk, bool).any():
            out.append(path)

    walk(masks, "")
    return out


def module_rank_summary(masks: Any) -> dict[str, dict[str, int]]:
    """Per-module live/total rank counts: ``{"a.b.c": {"live", "total"}}``,
    paths as in :func:`dead_modules` (``live == 0`` iff the module is in
    ``dead_modules(masks)``)."""
    out: dict[str, dict[str, int]] = {}

    def walk(msk, path):
        if isinstance(msk, (dict, list)):
            items = msk.items() if isinstance(msk, dict) else enumerate(msk)
            for k, v in items:
                walk(v, f"{path}.{k}" if path else str(k))
            return
        m = np.asarray(msk, bool)
        out[path] = {"live": int(m.sum()), "total": int(m.size)}

    walk(masks, "")
    return out


def count_trainable(tree: Any) -> int:
    return sum(int(np.prod(tuple(x.shape))) for x in leaves(tree))


def adapter_flops_per_token(adapters: Any, masks: Any | None) -> int:
    """Forward FLOPs a token of the live adapter math: 2·r_live·(d_in +
    d_out) a module, times the experts of a per-expert one."""
    total = 0
    for _, mod, msk in iter_modules(adapters, masks or {}):
        d_in, d_out = mod["A"].shape[-1], mod["B"].shape[-2]
        live = (mod["A"].shape[-2] if msk is None
                else int(np.asarray(msk, bool).sum()))
        total += 2 * (d_in + d_out) * n_experts_of(mod) * live
    return total
