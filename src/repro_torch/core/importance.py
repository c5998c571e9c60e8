"""Triplet importance scores (reference: ``repro/core/importance.py``;
paper Eq. 14, Table I).

For module n, rank i the triplet is (E_i, B[:,i], A[i,:]) and

    I_{n,i} = I(E_i) + mean_j I(B_{j,i}) + mean_j I(A_{i,j})

with four leaf scores:
    Mag          I(w) = |w|                       (the paper's default)
    Grad         I(w) = |∂ℓ/∂w|
    Mixed        I(w) = |w · ∂ℓ/∂w|
    Sensitivity  AdaLoRA-style EMA of |w·g| (≈1.3× compute, Table I)

Scores are computed on the host in numpy, per round, over the adapter tree
(per-layer modules in lists: the port keeps no stacked layers).  Per-expert
adapters average over the expert axis, because the rank mask belongs to the
insertion position (layer, component), not to individual experts.  Tensors
are pulled to the host once each; Mag never reads the gradients.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.pytree import child, flatten_with_keys, unflatten_keys

MAG, GRAD, MIXED, SENSITIVITY = "mag", "grad", "mixed", "sensitivity"


def to_np(x) -> np.ndarray:
    """Tensor or array → f32 numpy on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def is_module(x) -> bool:
    return isinstance(x, dict) and "A" in x and "B" in x


def _leaf_score(w, g, method: str):
    if method == MAG:
        return np.abs(w)
    if method == GRAD:
        return np.abs(g)
    if method in (MIXED, SENSITIVITY):
        return np.abs(w * g)
    raise ValueError(method)


def _module_score(mod: dict, grads: dict | None, method: str) -> np.ndarray:
    """(r,) score of one module's rank triplets; a per-expert module (A of
    shape (E, r, d_in)) scores (E, r), averaged over its experts."""
    def pair(name):
        w = to_np(mod[name])
        if method == MAG or not grads:
            return w, np.zeros_like(w)
        return w, to_np(grads[name])

    a, ga = pair("A")
    b, gb = pair("B")
    score = _leaf_score(a, ga, method).mean(-1) \
        + _leaf_score(b, gb, method).mean(-2)
    if "E" in mod:
        e, ge = pair("E")
        score = score + _leaf_score(e, ge, method)
    if mod["A"].ndim == 3:
        score = score.mean(-2)
    return score


def score_tree(adapters: Any, grads: Any | None, method: str = MAG,
               ema_state: Any | None = None, ema_beta: float = 0.85):
    """Mask-structured tree of importance scores.

    Returns (scores, new_ema_state).  ``ema_state`` is used only by the
    Sensitivity method (AdaLoRA's smoothed sensitivity).
    """
    def walk(ad, gr, ema):
        if is_module(ad):
            s = _module_score(ad, gr, method)
            if method == SENSITIVITY:
                prev = ema if isinstance(ema, np.ndarray) else np.zeros_like(s)
                s = ema_beta * prev + (1 - ema_beta) * s
            return s
        if isinstance(ad, dict):
            out = {k: walk(v, child(gr, k), child(ema, k)) for k, v in ad.items()}
            return {k: v for k, v in out.items() if v is not None} or None
        if isinstance(ad, list):
            return [walk(v, child(gr, i), child(ema, i)) for i, v in enumerate(ad)]
        return None

    scores = walk(adapters, grads, ema_state) or {}
    if method == SENSITIVITY:
        return scores, scores
    return scores, ema_state


def flat_concat(score_tree_: Any) -> tuple[np.ndarray, list[tuple]]:
    """Flatten a mask-structured tree → (flat vector, [(keys, shape)]), in
    the reference's leaf order (dict keys sorted, layers in order)."""
    items = flatten_with_keys(score_tree_)
    vecs, layout = [], []
    for keys, leaf in items:
        arr = to_np(leaf) if not isinstance(leaf, np.ndarray) else leaf
        vecs.append(arr.reshape(-1))
        layout.append((keys, arr.shape))
    if not vecs:
        return np.zeros((0,), np.float32), []
    return np.concatenate(vecs), layout


def unflatten(flat: np.ndarray, layout: list[tuple], like: Any = None
              ) -> Any:
    """Inverse of :func:`flat_concat` (``like``: the flattened tree, for
    the lengths of its lists; see ``pytree.unflatten_keys``)."""
    items, off = [], 0
    for keys, shape in layout:
        n = int(np.prod(shape)) if shape else 1
        items.append((keys, flat[off:off + n].reshape(shape)))
        off += n
    return unflatten_keys(items, like)
