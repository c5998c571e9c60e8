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

A model with a shared block (Zamba2's ``shared_attn``) has no entry at a
shared position in ``body`` or ``tail``: the reference keeps the block's
one tree under ``dec.shared``.  Only the layer pattern says where those
positions are, so such a tree crosses with ``pattern`` (the decoder's
``cfg.layer_pattern``; ``build_plan`` gives the stacked layout): the
shared position gets an empty ``dec.layers[i]``, ``shared`` crosses once to
``dec.shared``, and a tree whose entries do not fit the pattern raises.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.plan import SHARED, Plan, build_plan


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


def _layers(plan_tree: dict, pattern=None) -> list:
    """{body: {p<j>: stacked}, tail: {t<i>: ...}} → per-layer list, in the
    order the JAX plan runs them (repeat-major over the period, then tail).
    With ``pattern``, an empty entry at each shared position, the keys
    checked against the pattern's plan."""
    if pattern is not None:
        return _pattern_layers(plan_tree, tuple(pattern))
    if "shared" in plan_tree:
        raise ValueError("a tree with a shared block needs the layer "
                         "pattern to bridge (from_jax(..., pattern=))")
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


def _leading(tree: Any) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _pattern_layers(plan_tree: dict, pattern: tuple) -> list:
    """:func:`_layers` for a known layer pattern: the reference stacks
    ``build_plan(pattern)`` under ``body`` (``unroll=False``) or keeps every
    layer ``i`` under ``tail.t<i>`` (``unroll=True``, or a pattern with no
    period), with no key at a shared position.  The keys and the stacked
    repeats must be the plan's, so the list has the pattern's length."""
    body = plan_tree.get("body") or {}
    tail = plan_tree.get("tail") or {}
    plan = build_plan(pattern) if body else Plan((), 0, pattern)
    want_body = {f"p{j}" for j, k in enumerate(plan.period) if k != SHARED}
    want_tail = {f"t{i}" for i, k in enumerate(plan.tail) if k != SHARED}
    if set(body) != want_body or set(tail) != want_tail or (
            "shared" in plan_tree) != (SHARED in pattern):
        raise ValueError(
            f"the tree does not fit the pattern's plan {plan}: body "
            f"{sorted(body)}, tail {sorted(tail)}, shared "
            f"{'shared' in plan_tree}")
    reps = {pj: _leading(v) for pj, v in body.items()}
    if any(n != plan.repeats for n in reps.values()):
        raise ValueError(f"stacked repeats {reps}, the pattern's plan has "
                         f"{plan.repeats}")
    layers = [{} if kind == SHARED else _take(body[f"p{j}"], rep)
              for rep in range(plan.repeats)
              for j, kind in enumerate(plan.period)]
    return layers + [{} if kind == SHARED else tail[f"t{i}"]
                     for i, kind in enumerate(plan.tail)]


def relayout(tree: Any, pattern=None) -> Any:
    """The port's layout of one JAX tree, leaves as they are: each plan
    tree (``{body, tail, shared}``) becomes ``{"layers": [...]}`` plus
    ``"shared"``.  ``pattern`` is the decoder's (``dec``); an encoder's
    stack (``enc``) has one kind and no shared block."""
    if isinstance(tree, dict):
        if "body" in tree or "tail" in tree or "shared" in tree:
            out = {"layers": [relayout(layer) for layer in _layers(tree,
                                                                   pattern)]}
            if "shared" in tree:
                out["shared"] = relayout(tree["shared"])
            return out
        return {k: relayout(v, None if k == "enc" else pattern)
                for k, v in tree.items()}
    return tree


def bridge_tree(tree: Any, device="cpu", pattern=None) -> Any:
    """Convert one JAX numpy tree to the port's layout and tensors
    (``pattern``: as :func:`relayout`'s)."""
    return _tensors(relayout(tree, pattern), device)


def _tensors(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v, device) for v in tree]
    return to_tensor(np.asarray(tree), device)


def from_jax(base: dict, trainable: dict | None, masks: dict | None,
             device="cpu", pattern=None) -> tuple:
    """(base, trainable, masks) numpy trees → the port's tensor trees.
    ``pattern``: the decoder's layer pattern, which a model with a shared
    block needs (see the module's note)."""
    conv = [bridge_tree(t, device, pattern) if t is not None else None
            for t in (base, trainable, masks)]
    return tuple(conv)
