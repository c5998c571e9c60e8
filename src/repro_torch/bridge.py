"""Carry JAX weights across to the port (no reference module; the port's
counterpart of ``repro/pytree.py``'s ``fold_in`` seeding, which torch cannot
reproduce).

Input trees are the JAX package's ``base``, ``trainable`` and ``masks`` trees
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, tree)``).  A JAX
model built with ``unroll=False`` stacks its repeated period under
``dec.body.p<j>`` with a leading repeat axis and unrolls what is left after
the last whole period under ``dec.tail.t<i>`` (``repro/models/lm.py``,
``repro/models/plan.py``: Gemma3's ``(5 × local, attn) × 4 + 2 × local`` is a
period of six repeated four times and a tail of two); an unrolled one keeps
every layer under ``dec.tail.t<i>``.  Both become the port's per-layer list
``dec.layers[i]`` in the reference's order, so layer ``i`` keeps its kind;
every leaf of a layer (Gemma's post-block norms ``pn1``/``pn2`` too) crosses
as it is.  An MoE layer's ``moe.{router,w1,w2,w3}`` weights and its
per-expert adapters keep their expert axis, which the stacked trees carry
second (layer, expert, ...): taking layer ``i`` leaves (expert, ...); its
masks, (layer, r) stacked, become one (r,) per (layer, component).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def to_tensor(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """numpy → torch, bf16 included: ``np.asarray`` of a JAX bf16 array has
    the ml_dtypes bfloat16 dtype, which ``torch.from_numpy`` refuses, so it
    crosses as its 16-bit pattern."""
    arr = np.array(arr, order="C")          # writable copy: JAX's are not
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _index_numeric(keys, prefix: str) -> list[str]:
    return sorted((k for k in keys if k.startswith(prefix)),
                  key=lambda k: int(k[len(prefix):]))


def _take(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]


def _layers(plan_tree: dict) -> list:
    """{body: {p<j>: stacked}, tail: {t<i>: ...}} → per-layer list, in the
    order the JAX plan runs them (repeat-major over the period, then tail)."""
    layers = []
    body = plan_tree.get("body") or {}
    periods = _index_numeric(body, "p")
    if periods:
        first = body[periods[0]]
        while isinstance(first, dict):
            first = next(iter(first.values()))
        for rep in range(first.shape[0]):
            for pj in periods:
                layers.append(_take(body[pj], rep))
    tail = plan_tree.get("tail") or {}
    for ti in _index_numeric(tail, "t"):
        layers.append(tail[ti])
    return layers


def bridge_tree(tree: Any, device="cpu") -> Any:
    """Convert one JAX numpy tree to the port's layout and tensors."""
    if isinstance(tree, dict):
        if "body" in tree or "tail" in tree:
            return {"layers": [bridge_tree(layer, device)
                               for layer in _layers(tree)]}
        return {k: bridge_tree(v, device) for k, v in tree.items()}
    return to_tensor(np.asarray(tree), device)


def from_jax(base: dict, trainable: dict | None, masks: dict | None,
             device="cpu") -> tuple:
    """(base, trainable, masks) numpy trees → the port's tensor trees."""
    conv = [bridge_tree(t, device) if t is not None else None
            for t in (base, trainable, masks)]
    return tuple(conv)
