"""Top-k MoE feed-forward block (reference: ``repro/models/moe.py``), the
single-device path (``moe_apply`` → ``_moe_local`` with every expert
local).  The reference's expert-parallel paths (``shard_map`` over a mesh,
the token-replicated decode) wait for a multi-card DeviceMesh (ROADMAP.md
queue 1 item 14).

The paper's adapters attach per expert (A/B/E carry the expert axis) and to
the router; a (layer, component) rank mask is shared by all experts of that
component: mask granularity is the insertion position, as in the paper.

Routing: an f32 softmax over the router's logits, top-k (ties to the lower
expert, as ``jax.lax.top_k``), the k weights renormalised, the
Switch-style aux loss ``E · Σ_e f_e · p̄_e``, and capacity-bounded slots
assigned in flat (token-major, k-minor) order, overflow dropped.  The
expert FFN is batched products over the experts (the reference's einsums;
no Pallas kernel).  The combine is deterministic: each token gathers its
kept slots in the reference's order (ascending slot, so by expert) and sums
them in x's dtype, where the reference scatter-adds (``.at[gidx].add``,
atomics on a card); the dispatch's backward sums the same way.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import adapters as AD
from repro_torch.models import mlp as MLP
from repro_torch.pytree import ParamMeta


def moe_meta(cfg) -> dict:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    m = {
        "router": {"w": ParamMeta((d, e), torch.float32, init="normal")},
        "w1": {"w": ParamMeta((e, d, f), cfg.pdtype, init="normal")},
        "w2": {"w": ParamMeta((e, f, d), cfg.pdtype, init="normal",
                              scale=0.05)},
    }
    if cfg.glu:
        m["w3"] = {"w": ParamMeta((e, d, f), cfg.pdtype, init="normal")}
    return m


def moe_adapter_meta(cfg, kind: str) -> dict:
    """Per-expert adapters on w1/w3/w2 and one on the router at rank
    min(r, E) (present when the router or w1 is a target)."""
    out = {}
    if "router" in cfg.adapter_targets or "w1" in cfg.adapter_targets:
        r = AD.adapter_meta(kind, cfg.d_model, cfg.n_experts,
                            min(cfg.adapter_rank, cfg.n_experts))
        if r is not None:
            out["router"] = r
    for name, (di, do) in (("w1", (cfg.d_model, cfg.d_ff)),
                           ("w3", (cfg.d_model, cfg.d_ff)),
                           ("w2", (cfg.d_ff, cfg.d_model))):
        if name == "w3" and not cfg.glu:
            continue
        if name in cfg.adapter_targets:
            ad = AD.adapter_meta(kind, di, do, cfg.adapter_rank,
                                 n_experts=cfg.n_experts)
            if ad is not None:
                out[name] = ad
    return out


def _capacity(t_local: int, cfg) -> int:
    c = int(math.ceil(t_local * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)


def _expert_ffn(w, ad, masks, xe, cfg):
    """xe: (E, C, D) → (E, C, D); per-expert adapters."""
    scaling = cfg.adapter_alpha / max(cfg.adapter_rank, 1)
    masks = masks or {}
    cd = xe.dtype
    h = torch.bmm(xe, w["w1"]["w"].to(cd))
    h = AD.apply_adapter(h, xe, ad.get("w1"), masks.get("w1"), scaling)
    h = MLP.activation(h, cfg)
    if cfg.glu:
        g = torch.bmm(xe, w["w3"]["w"].to(cd))
        g = AD.apply_adapter(g, xe, ad.get("w3"), masks.get("w3"), scaling)
        h = h * g
    y = torch.bmm(h, w["w2"]["w"].to(cd))
    return AD.apply_adapter(y, h, ad.get("w2"), masks.get("w2"), scaling)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, descending,
    equal values in ascending index order (a stable sort)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _route_and_dispatch(xf, w, ad, masks, cfg, route=None):
    """Router + capacity-bounded dispatch to the experts.

    xf: (T, D).  Returns (xe (E, C, D), gidx (E·C,), gw (E·C,) f32, valid
    (E·C,) in xf's dtype, aux, slots (T, k): each token's kept slot indices
    ascending, E·C where a choice was dropped, top_ids (T, k)).
    ``route`` (T, k) replaces the top-k choice (their weights still come
    from this router's probabilities): a caller comparing two runs routes
    the second as the first routed."""
    scaling = cfg.adapter_alpha / max(cfg.adapter_rank, 1)
    t, d = xf.shape
    k, n_e = cfg.top_k, cfg.n_experts

    logits = xf @ w["router"]["w"].to(xf.dtype)
    logits = AD.apply_adapter(logits, xf, ad.get("router"),
                              (masks or {}).get("router"), scaling)
    probs = torch.softmax(logits.float(), dim=-1)                  # (T, E)
    if route is None:
        top_vals, top_ids = _top_k(probs, k)                       # (T, k)
    else:
        top_ids = route
        top_vals = probs.gather(-1, top_ids)
    top_vals = top_vals / top_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    # Load-balance auxiliary loss (Switch-style): E · Σ_e f_e · p̄_e.
    # The choices sorted by expert, stably (flat token-major, k-minor order
    # kept within an expert): each expert's count and each choice's slot,
    # the number of earlier choices of its expert, as the reference's
    # one-hot cumsum over the flat axis gives them (that scan over T·k rows
    # costs a card ~6 ms a layer; bincount and one_hot wait on the device)
    flat_ids = top_ids.reshape(-1)                                 # (T*k,)
    by_expert, order = torch.sort(flat_ids, stable=True)
    start = torch.searchsorted(
        by_expert, torch.arange(n_e + 1, device=xf.device))
    frac = start.diff().float() / (t * k)
    aux = n_e * torch.sum(frac * probs.mean(0))

    c = _capacity(t, cfg)
    flat_w = top_vals.reshape(-1)
    arange = torch.arange(t * k, device=xf.device)
    tok_of = arange // k
    pos = torch.empty_like(flat_ids).scatter_(
        0, order, arange - start[by_expert])
    keep = pos < c
    dump = n_e * c
    dest = torch.where(keep, flat_ids * c + pos, dump)

    # every slot below ``dump`` is written at most once; what lands in the
    # dump slot is cut off
    gidx = torch.zeros(dump + 1, dtype=torch.long, device=xf.device
                       ).scatter(0, dest, tok_of)[:dump]
    gw = torch.zeros(dump + 1, dtype=torch.float32, device=xf.device
                     ).scatter(0, dest, torch.where(keep, flat_w, 0.0))[:dump]
    valid = (gw > 0).to(xf.dtype)
    # a slot counts where its weight is > 0, as ``valid`` says
    slots = torch.where(keep & (flat_w > 0), dest, dump).reshape(t, k)
    slots = slots.sort(-1).values
    xe = _Dispatch.apply(xf, gidx, valid, slots).reshape(n_e, c, d)
    return xe, gidx, gw, valid, aux, slots, top_ids


def _combine(rows: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """rows (N, D), slots (T, k) into rows, N for none → (T, D): each
    token's rows summed in slot order, in rows' dtype."""
    pad = torch.cat([rows, rows.new_zeros(1, rows.shape[-1])])
    g = pad[slots]                                                 # (T, k, D)
    y = g[:, 0]
    for j in range(1, slots.shape[1]):
        y = y + g[:, j]
    return y


class _Dispatch(torch.autograd.Function):
    """``xf[gidx] · valid``, whose backward sums each token's kept slots
    with :func:`_combine` (no scatter-add)."""

    @staticmethod
    def forward(ctx, xf, gidx, valid, slots):
        ctx.save_for_backward(slots)
        return xf[gidx] * valid[:, None]

    @staticmethod
    def backward(ctx, g):
        (slots,) = ctx.saved_tensors
        return _combine(g, slots), None, None, None


def moe_apply(p, x, cfg, ad=None, masks=None, *, route=None, record=None):
    """x (B, S, D) → (y (B, S, D), aux).  ``route`` (B·S, k): the experts
    each token takes, in place of the router's top-k (see
    :func:`_route_and_dispatch`).  ``record``: a list that gets this
    layer's {"top_ids" (B·S, k), "dropped": choices over capacity}."""
    ad = ad or {}
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    xe, gidx, gw, valid, aux, slots, top_ids = _route_and_dispatch(
        xf, p, ad, masks, cfg, route)
    ye = _expert_ffn(p, ad, masks, xe, cfg)
    ye = ye.reshape(-1, d) * (gw.to(x.dtype) * valid)[:, None]
    y = _combine(ye, slots)
    if record is not None:
        record.append({"top_ids": top_ids.detach(),
                       "dropped": (slots == gidx.numel()).sum().detach()})
    return y.reshape(b, s, d), aux
