"""Client-side local training (reference: ``repro/federated/client.py``).

One step function per (model, optimizer), shared by every client: autograd
over the trainable tree (and, for SLoRA's stage 1, over the base as well),
the optimizer's update × the 0/1 gate, then ``p + u``.  The step runs
eagerly; the losses stay on the device and are pulled once after a client's
loop.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.optim import Optimizer
from repro_torch.pytree import tree_map


def device_batch(batch: dict, device) -> dict:
    """A numpy batch on ``device``, token ids and labels as int64."""
    return {k: torch.as_tensor(v, device=device).long()
            for k, v in batch.items()}


def make_train_step(model, opt: Optimizer, task: str = "cls",
                    train_base: bool = False, clients: bool = False):
    """→ step(base, params, opt_state, masks, gate, batch) over
    ``model.cls_loss`` (``task="cls"``) or ``model.lm_loss`` (any other
    task, as in the reference), returning
    (params', opt_state', grads, base_grads, loss, metric), the reference's
    layout.  ``base_grads`` is None unless ``train_base``: then autograd runs
    over the base and the trainable tree together (SLoRA's stage 1) and the
    base is left for :func:`make_base_update_step` to move.  ``clients``:
    params, opt_state and the batch carry C clients on a leading axis (the
    cohort's local step), and loss and metric are (C,)."""

    loss_fn = model.cls_loss if task == "cls" else model.lm_loss

    def step(base, params, opt_state, masks, gate, batch):
        flat: list = []

        def leaf(t):
            flat.append(t.detach().requires_grad_(True))
            return flat[-1]

        req = tree_map(leaf, params)
        n_params = len(flat)
        req_base = tree_map(leaf, base) if train_base else base
        total, (loss, metric) = loss_fn(req_base, req, masks, batch, clients)
        got = torch.autograd.grad(total, flat) if flat else ()
        it = iter(got[:n_params])
        grads = tree_map(lambda _: next(it), req)
        gb = None
        if train_base:
            it = iter(got[n_params:])
            gb = tree_map(lambda _: next(it), req_base)
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params)
            if gate is not None:
                updates = tree_map(lambda u, g: u * g.to(u.dtype), updates,
                                   gate)
            params = tree_map(lambda p, u: p + u.to(p.dtype), params,
                              updates)
        return params, opt_state, grads, gb, loss.detach(), metric.detach()

    return step


def make_base_update_step(opt: Optimizer):
    """→ step(base, opt_state, grads, gate): the sparse full-FT update of
    the base (SLoRA stage 1), the optimizer's update × the 0/1 gate."""

    @torch.no_grad()
    def step(base, opt_state, grads, gate):
        updates, opt_state = opt.update(grads, opt_state, base)
        if gate is not None:
            updates = tree_map(lambda u, g: u * g.to(u.dtype), updates, gate)
        base = tree_map(lambda p, u: p + u.to(p.dtype), base, updates)
        return base, opt_state

    return step


def make_eval_step(model, task: str = "cls"):
    """→ eval(base, params, masks, batch), a device scalar: the correct
    predictions in the batch (``task="cls"``), else the batch's mean
    next-token NLL at ``batch["targets"]``."""

    @torch.no_grad()
    def step(base, params, masks, batch):
        logits = model.forward(base, params, masks, batch)
        if task == "cls":
            return (logits.argmax(-1) == batch["labels"]).float().sum()
        logp = torch.log_softmax(logits.float(), -1)
        return -logp.gather(-1, batch["targets"][..., None])[..., 0].mean()

    return step


def local_train(step_fn, base, trainable, masks, gate, opt, data_batches,
                device) -> tuple[Any, Any, dict]:
    """Run local epochs.  Returns (trainable', last_grads, metrics).  The
    optimizer state is made anew for each call, as in the reference."""
    opt_state = opt.init(trainable)
    params = trainable
    losses, metrics = [], []
    grads = None
    for batch in data_batches:
        params, opt_state, grads, _, loss, metric = step_fn(
            base, params, opt_state, masks, gate,
            device_batch(batch, device))
        losses.append(loss)
        metrics.append(metric)
    if losses:          # one device→host transfer after the loop
        losses, metrics = torch.stack(
            [torch.stack(losses), torch.stack(metrics)]).tolist()
    return params, grads, {
        "loss": float(np.mean(losses)) if losses else float("nan"),
        "metric": float(np.mean(metrics)) if metrics else float("nan"),
        "n_batches": len(losses)}
