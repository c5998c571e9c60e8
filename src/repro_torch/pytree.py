"""Parameter metadata trees (reference: ``repro/pytree.py``).

A tree is nested ``dict``s and ``list``s whose leaves are :class:`ParamMeta`
(the declaration) or tensors (the materialization).  ``materialize`` uses the
same init kinds and scales as the JAX package, but draws from a
``torch.Generator`` seeded per leaf path, so the values differ from JAX's
``fold_in`` stream: parity tests carry JAX weights across with
:mod:`repro_torch.bridge` instead.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Callable

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    """Declarative description of a single parameter tensor."""

    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"            # normal | zeros | ones | scaled_normal | uniform
    scale: float = 1.0
    fan_in: int = 0                 # 0 → shape[-2] (2D convention)

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def is_meta(x) -> bool:
    return isinstance(x, ParamMeta)


def tree_map(fn: Callable, tree: Tree, *rest: Tree,
             is_leaf: Callable | None = None) -> Tree:
    """Map ``fn`` over the leaves of one or more same-structured trees.
    ``None`` subtrees stay ``None``."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def flatten_with_paths(tree: Tree, is_leaf: Callable | None = None
                       ) -> list[tuple[str, Any]]:
    """[(path_str, leaf)] in deterministic order: dict keys sorted (as
    ``jax.tree_util`` orders them), list entries by index."""
    out: list[tuple[str, Any]] = []

    def walk(prefix: str, node):
        if node is None:
            return
        if is_leaf is not None and is_leaf(node):
            out.append((prefix, node))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}.{k}" if prefix else str(k), node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}.{i}" if prefix else str(i), v)
        else:
            out.append((prefix, node))

    walk("", tree)
    return out


def child(tree: Tree, key) -> Any:
    """``tree[key]`` for a dict key or list index, None where it is absent
    (walking a mask or grad tree beside the adapter tree)."""
    if isinstance(tree, dict):
        return tree.get(key)
    if isinstance(tree, list) and isinstance(key, int) and key < len(tree):
        return tree[key]
    return None


def flatten_with_keys(tree: Tree, is_leaf: Callable | None = None
                      ) -> list[tuple[tuple, Any]]:
    """[(keys, leaf)] in :func:`flatten_with_paths` order, each path as a
    tuple of dict keys (str) and list indices (int), so that
    :func:`unflatten_keys` can rebuild dicts and lists alike."""
    out: list[tuple[tuple, Any]] = []

    def walk(keys: tuple, node):
        if node is None:
            return
        if is_leaf is not None and is_leaf(node):
            out.append((keys, node))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(keys + (k,), node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(keys + (i,), v)
        else:
            out.append((keys, node))

    walk((), tree)
    return out


def unflatten_keys(items, like: Tree = None) -> Tree:
    """Inverse of :func:`flatten_with_keys`: int keys make lists, str keys
    dicts.  A list entry with no leaves (a shared block's empty slot in
    ``dec.layers``) comes back as ``{}``; the leaves cannot say how many
    such entries end a list, so ``like`` (a tree of the same structure)
    gives each list its length."""
    root: dict = {}
    for keys, leaf in items:
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf

    def listify(node, like):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v, child(like, k)) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            n = max(max(out) + 1, len(like) if isinstance(like, (list, tuple))
                    else 0)
            return [out.get(i, {}) for i in range(n)]
        return out

    return listify(root, like)


def leaves(tree: Tree, is_leaf: Callable | None = None) -> list:
    return [v for _, v in flatten_with_paths(tree, is_leaf)]


def _leaf_seed(seed: int, path: str) -> int:
    digest = hashlib.sha256(path.encode()).digest()
    return (seed * 0x9E3779B1 + int.from_bytes(digest[:4], "little")) % (1 << 63)


def _materialize_leaf(meta: ParamMeta, seed: int, device) -> torch.Tensor:
    if meta.init == "zeros":
        return torch.zeros(meta.shape, dtype=meta.dtype, device=device)
    if meta.init == "ones":
        return torch.ones(meta.shape, dtype=meta.dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if meta.init in ("normal", "scaled_normal"):
        z = torch.randn(meta.shape, generator=gen, dtype=torch.float32,
                        device=device)
        if meta.init == "normal":
            fan_in = meta.fan_in or (
                meta.shape[-2] if len(meta.shape) >= 2
                else max(meta.shape[-1], 1))
            std = meta.scale / math.sqrt(fan_in)
        else:
            std = meta.scale
        return (std * z).to(meta.dtype)
    if meta.init == "uniform":
        u = torch.rand(meta.shape, generator=gen, dtype=torch.float32,
                       device=device)
        return (meta.scale * (2.0 * u - 1.0)).to(meta.dtype)
    raise ValueError(f"unknown init {meta.init!r}")


def materialize(meta_tree: Tree, seed: int, device) -> Tree:
    """Instantiate every ParamMeta leaf directly on ``device``, each from its
    own generator seeded by ``seed`` and the leaf's path."""
    device = torch.device(device)

    def walk(prefix: str, node):
        if node is None:
            return None
        if is_meta(node):
            return _materialize_leaf(node, _leaf_seed(seed, prefix), device)
        if isinstance(node, dict):
            return {k: walk(f"{prefix}.{k}" if prefix else str(k), v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(f"{prefix}.{i}" if prefix else str(i), v)
                    for i, v in enumerate(node)]
        raise TypeError(f"unexpected meta-tree node {type(node)!r}")

    return walk("", meta_tree)


def tree_bytes(meta_tree: Tree) -> int:
    return sum(m.size * m.dtype.itemsize
               for m in leaves(meta_tree, is_leaf=is_meta))


def tensor_bytes(tree: Tree) -> int:
    """Bytes held by the tensors of a materialized tree."""
    return sum(t.numel() * t.element_size() for t in leaves(tree))
