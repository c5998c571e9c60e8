"""MaskGen (reference: ``repro/core/masks.py``; paper §IV-B1): local rank
masks from triplet importance.

Each client sorts *all* triplets across modules and marks the global top-b(t)
as True.  Masks mirror the adapter tree at the module level, leaf shape (r,)
bool — the structure ``Model.init_masks()`` produces.  Mask trees here are
host numpy; ``to_np`` brings a tree of tensors across.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import importance as IMP


def generate_local_masks(scores: Any, budget: int) -> Any:
    """Top-``budget`` triplets across the whole model → boolean mask tree."""
    flat, layout = IMP.flat_concat(scores)
    n = flat.size
    if n == 0:
        return {}
    k = int(np.clip(budget, 0, n))
    mask = np.zeros(n, dtype=bool)
    if k > 0:
        idx = np.argpartition(-flat, k - 1)[:k]
        mask[idx] = True
    return IMP.unflatten(mask, layout, scores)


def topk_margin(scores: Any, budget: int) -> float:
    """Gap between the last kept and the first dropped score at ``budget``:
    how far apart two runs' scores may drift before their masks differ."""
    flat, _ = IMP.flat_concat(scores)
    k = int(np.clip(budget, 0, flat.size))
    if k in (0, flat.size):
        return float("inf")
    s = np.sort(flat)[::-1]
    return float(s[k - 1] - s[k])


def to_np(tree: Any) -> Any:
    """Mask tree of tensors or arrays → numpy, dtypes kept."""
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_np(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def vote_fractions(local_masks: list) -> dict[str, float]:
    """Per-module mean voted-rank fraction across a cohort's local masks
    (``{"a.b.c": frac}``, dotted paths as in ``pruning.dead_modules``): the
    importance the trace stamps on ``rank_alloc`` events."""
    acc: dict[str, list[float]] = {}

    def walk(msk, path):
        if isinstance(msk, (dict, list)):
            items = msk.items() if isinstance(msk, dict) else enumerate(msk)
            for k, v in items:
                walk(v, f"{path}.{k}" if path else str(k))
            return
        m = np.asarray(msk, bool)
        acc.setdefault(path, []).append(float(m.mean()) if m.size else 0.0)

    for lm in local_masks:
        if lm:
            walk(lm, "")
    return {p: float(np.mean(v)) for p, v in acc.items()}


def count_true(masks: Any) -> int:
    flat, _ = IMP.flat_concat(to_np(masks))
    return int(flat.sum())


def total_ranks(masks: Any) -> int:
    flat, _ = IMP.flat_concat(to_np(masks))
    return int(flat.size)
