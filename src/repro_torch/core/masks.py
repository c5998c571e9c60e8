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
    return IMP.unflatten(mask, layout)


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


def count_true(masks: Any) -> int:
    flat, _ = IMP.flat_concat(to_np(masks))
    return int(flat.sum())


def total_ranks(masks: Any) -> int:
    flat, _ = IMP.flat_concat(to_np(masks))
    return int(flat.size)
