"""Functional Adam (reference: ``repro/optim/optimizers.py:adam``).

Same API as the reference: ``opt.init(params) -> state``,
``opt.update(grads, state, params) -> (updates, state)`` over trees of
tensors.  The step counter is a host integer in the state, so the schedule
and the bias corrections are worked out on the host in float32, as the
reference's f32 arithmetic gives them, and no step reads the device.

``state_dtype`` picks the moments' storage; the arithmetic is always f32.
``int8`` packs the momentum as ``{"q", "scale"}`` leaves with an absmax
scale per tensor and keeps the variance in bf16, as the reference does.
The cohort runner stacks its clients' trees on a leading axis
(``init(params, clients=True)``): there "per tensor" means per client, as
the reference's ``vmap`` over clients gives it, so the scale has one entry
per client and reduces over every axis but the leading one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.pytree import leaves, tree_map

_QKEYS = frozenset({"q", "scale"})


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def is_qleaf(x) -> bool:
    """An int8 moment: ``{"q": int8 tensor, "scale": f32 tensor}``."""
    return isinstance(x, dict) and set(x) == _QKEYS


def _qmap(f, packed, *trees):
    return tree_map(f, packed, *trees, is_leaf=is_qleaf)


def _absmax(x: torch.Tensor, clients: bool) -> torch.Tensor:
    """|x|'s max over the whole tensor, or per leading entry."""
    if not clients:
        return x.abs().max()
    return x.abs().reshape(x.shape[0], -1).amax(1)


def _moment_codec(state_dtype: str):
    """(store, load) for one moment tensor: f32 compute ↔ packed storage.
    ``store(x, clients)`` takes the scale per leading entry when
    ``clients``; ``load`` reads the scale's shape back."""
    if state_dtype == "float32":
        return (lambda x, clients: x), (lambda x: x)
    if state_dtype == "bfloat16":
        return (lambda x, clients: x.to(torch.bfloat16)), \
               (lambda x: x.float())
    if state_dtype == "int8":
        def store(x, clients):
            scale = torch.clamp(_absmax(x, clients), min=1e-30) / 127.0
            s = scale.reshape(scale.shape + (1,) * (x.ndim - scale.ndim))
            q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
            return {"q": q, "scale": scale}

        def load(x):
            s = x["scale"]
            return x["q"].float() * s.reshape(
                s.shape + (1,) * (x["q"].ndim - s.ndim))
        return store, load
    raise ValueError(f"unknown optimizer state_dtype {state_dtype!r} "
                     "(float32|bfloat16|int8)")


def state_nbytes(state) -> int:
    """Bytes held by an optimizer state tree: the moments as stored (an
    int8 moment's q and scale, not its f32 view) plus 4 for the step
    counter, the reference's int32 scalar (a host integer here)."""
    return 4 + sum(t.numel() * t.element_size()
                   for t in leaves({"mu": state["mu"], "nu": state["nu"]}))


def adam(lr: float | Callable, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, state_dtype: str = "float32") -> Optimizer:
    """Adam with bias correction: ``u = -lr_t·(m/c1)/(sqrt(v/c2)+eps)``."""
    lr_fn = lr if callable(lr) else (lambda _: np.float32(lr))
    f32 = np.float32
    store_mu, load_mu = _moment_codec(state_dtype)
    store_nu, load_nu = _moment_codec(
        "bfloat16" if state_dtype == "int8" else state_dtype)

    def init(params, clients: bool = False):
        def zeros(store):
            return lambda p: store(torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), clients)
        return {"step": 0, "mu": tree_map(zeros(store_mu), params),
                "nu": tree_map(zeros(store_nu), params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = float(lr_fn(step))

        def per_client(m):      # a per-client scale has one entry a client
            return is_qleaf(m) and m["scale"].ndim == 1

        mu = _qmap(lambda m, g: store_mu(
            b1 * load_mu(m) + (1 - b1) * g.float(), per_client(m)),
            state["mu"], grads)
        nu = _qmap(lambda v, g: store_nu(
            b2 * load_nu(v) + (1 - b2) * g.float().square(), per_client(v)),
            state["nu"], grads)
        c1 = float(f32(1) - f32(b1) ** f32(step))
        c2 = float(f32(1) - f32(b2) ** f32(step))

        def u(m, v, p=None):
            upd = -lr_t * (load_mu(m) / c1) / ((load_nu(v) / c2).sqrt() + eps)
            return upd if p is None else upd.to(p.dtype)

        upd = (_qmap(u, mu, nu) if params is None
               else _qmap(u, mu, nu, params))
        return upd, {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init, update)
