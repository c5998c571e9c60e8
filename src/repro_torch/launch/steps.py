"""Train / prefill / decode steps (reference: ``repro/launch/steps.py``).

The same factories serve ``launch/train.py`` and any caller that trains
or serves one model outside the federated runtime.  The reference's
sharding helpers wait for a multi-card mesh (ROADMAP.md queue 1 item 14).
"""

from __future__ import annotations

import torch

from repro_torch.federated import client as CL
from repro_torch.optim import Optimizer


def make_train_step(model, opt: Optimizer, task: str = "lm"):
    """→ train_step(base, trainable, opt_state, masks, batch) →
    (trainable', opt_state', metrics).  Gradients only with respect to the
    PEFT trainables; the base is frozen.  ``metrics``: {"loss", "metric"}
    as device scalars (the LM's metric is its router term, 0 for dense
    models; the classifier's its accuracy)."""
    step = CL.make_train_step(model, opt, task)

    def train_step(base, trainable, opt_state, masks, batch):
        trainable, opt_state, _, _, loss, metric = step(
            base, trainable, opt_state, masks, None, batch)
        return trainable, opt_state, {"loss": loss, "metric": metric}

    return train_step


def make_prefill_step(model):
    """→ prefill(base, trainable, masks, batch, cache) → (last-position
    logits (B, V), cache'), for the decoder-only models the port serves."""
    def prefill(base, trainable, masks, batch, cache):
        return model.prefill(base, trainable, masks, batch["tokens"], cache)
    return prefill


def make_decode_step(model):
    """→ decode(base, trainable, masks, token, cache) → (greedy next token
    (B, 1), cache'), ``token["tokens"]`` (B, 1)."""
    @torch.no_grad()
    def decode(base, trainable, masks, token, cache):
        logits, new_cache = model.decode_step(base, trainable, masks,
                                              token["tokens"], cache)
        return logits.argmax(-1)[:, None], new_cache
    return decode
