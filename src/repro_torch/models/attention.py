"""GQA attention (reference: ``repro/models/attention.py``): training
(causal or bidirectional, RoPE'd or not, a sliding window on ``local``
layers and a tanh soft-cap where the config has them, differentiable) and
prefill through the flash kernel, cross-attention to an encoder's output
(its k/v kept in the cross-attention cache at prefill and read from it in
decode), and a batched decode against the KV cache in which every row
carries its own position and its own adapter.

Serving a windowed or soft-capped config (the sliding-window ring-buffer
cache) is not ported yet (ROADMAP.md queue 1 item 13).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import adapters as AD
from repro_torch.kernels.flash_attention import FlashAttention, mha_flash
from repro_torch.models import layers as L
from repro_torch.pytree import ParamMeta

NEG_INF = -2.3819763e38          # bf16-safe large negative


# ------------------------------------------------------------------ meta ----

def attn_meta(cfg, cross: bool = False) -> dict:
    """q/k/v/o weights; a cross-attention's carry no QKV bias."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    m = {
        "wq": {"w": ParamMeta((d, h, hd), cfg.pdtype, init="normal", fan_in=d)},
        "wk": {"w": ParamMeta((d, kv, hd), cfg.pdtype, init="normal", fan_in=d)},
        "wv": {"w": ParamMeta((d, kv, hd), cfg.pdtype, init="normal", fan_in=d)},
        "wo": {"w": ParamMeta((h, hd, d), cfg.pdtype, init="normal",
                              scale=0.05, fan_in=h * hd)},
    }
    if cfg.qkv_bias and not cross:
        m["wq"]["b"] = ParamMeta((h, hd), cfg.pdtype, init="zeros")
        m["wk"]["b"] = ParamMeta((kv, hd), cfg.pdtype, init="zeros")
        m["wv"]["b"] = ParamMeta((kv, hd), cfg.pdtype, init="zeros")
    return m


def attn_adapter_meta(cfg, kind: str) -> dict:
    """Adapters for q/k/v/o as 2D maps over the fused head dims."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dims = {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
            "wo": (h * hd, d)}
    out = {}
    for name, (di, do) in dims.items():
        if name in cfg.adapter_targets:
            ad = AD.adapter_meta(kind, di, do, cfg.adapter_rank)
            if ad is not None:
                out[name] = ad
    return out


def cache_meta(cfg, batch: int, seq: int) -> dict:
    kvd = cfg.cdtype                     # bf16 in production, f32 in smokes
    shape = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": ParamMeta(shape, kvd, init="zeros"),
            "v": ParamMeta(shape, kvd, init="zeros")}


def cross_cache_meta(cfg, batch: int, src_len: int) -> dict:
    """The encoder's projected k/v for a cross-attention, ``src_len``
    positions (reference ``:326``)."""
    return cache_meta(cfg, batch, src_len)


# ------------------------------------------------------------- projection ---

def _proj(p: dict, x, ad, mask, scaling, **kw):
    """x (..., d) @ w (d, H, hd) -> (..., H, hd): one adapted linear on the
    fused (d, H·hd) view of W, plus the bias."""
    w = p["w"]
    d, h, hd = w.shape
    b = p.get("b")
    y = L.linear(x, w.reshape(d, h * hd), None if b is None else b.reshape(-1),
                 ad, mask, scaling, **kw)
    return y.reshape(x.shape[:-1] + (h, hd))


def _out_proj(p: dict, o, ad, mask, scaling, **kw):
    """o (..., H, hd) @ wo (H, hd, d) -> (..., d) on the fused (H·hd, d)
    view."""
    w = p["w"]
    h, hd, d = w.shape
    return L.linear(o.reshape(o.shape[:-2] + (h * hd,)), w.reshape(h * hd, d),
                    None, ad, mask, scaling, **kw)


# ----------------------------------------------------------- core softmax ---

def _direct(q, k, v, mask, scale, softcap):
    """q: (B, Sq, KV, G, hd), k/v: (B, Sk, KV, hd), mask broadcastable to
    (B, KV, G, Sq, Sk) → (B, Sq, KV, G, hd)."""
    s = torch.einsum("bqkgh,bskh->bkgqs", q, k).float() * scale
    s = L.softcap(s, softcap)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", p, v)


# ------------------------------------------------------------- public ops ---

def attention(p: dict, x, cfg, *, mode: str, ad=None, masks=None, cache=None,
              idx=None, rows=None, pos=None, use_kernel: bool = False,
              clients: bool = False, causal: bool = True, kv_x=None,
              window: int = 0, cross: bool = False):
    """Attention.  Returns (out, new_cache).

    ``mode="train"``: x (B, S, d) from position 0 (RoPE'd at ``0..S-1``
    where the config rotates); every position attends to every position
    (``causal`` false, an encoder's) or to those up to its own; no cache.
    With ``clients``, x is (C, B, S, d) and ``ad`` holds C clients'
    adapters: the projections are grouped over clients and the attention
    core folds (C·B) into its batch.  ``window`` > 0 (a ``local`` block's
    ``cfg.sliding_window``): a causal query at i sees keys j with
    i − window < j ≤ i; scores are soft-capped by ``cfg.attn_softcap``
    (0: none), both in training only.
    ``mode="prefill"``: x (B, S, d) from position 0; k and v are written
    into ``[:S]`` of a zero copy of ``cache`` ({"k", "v"}: (B, T, KV, hd));
    without a cache (an encoder's) nothing is kept.
    ``mode="decode"``: x (M, 1, d); row ``i`` sits at position ``pos[i]`` in
    cache row ``rows[i]``; its new k/v are written there in place and it
    attends to cache positions ``<= pos[i]``.  ``idx`` selects each row's
    adapter from rank-bucket stacks in ``ad``.

    ``cross`` (or ``kv_x`` given): cross-attention, no RoPE and no mask.
    In training and prefill the keys and values are ``kv_x`` (B, Sk, d)
    (an encoder's output) projected, and prefill returns them as the new
    ``cache`` (the cross-attention cache, :func:`cross_cache_meta`); in
    decode only q and o are projected and k/v are read from ``cache`` rows
    ``rows``.
    """
    # serving refuses windowed configs at Model._require_servable
    assert mode == "train" or not window, mode
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}: the port has train, prefill and "
                         f"decode")
    cross = cross or kv_x is not None
    if not causal and not cross and mode == "decode":
        raise NotImplementedError(
            "bidirectional self-attention in decode: an encoder runs once, "
            "in train or prefill mode")
    scaling = cfg.adapter_alpha / max(cfg.adapter_rank, 1)
    masks = masks or {}
    ad = ad or {}
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    window = window if causal else 0          # the reference's rule
    lead, sq = x.shape[:-2], x.shape[-2]
    b = math.prod(lead)
    use_rope = cfg.pos_emb == "rope" and not cross
    kw = dict(idx=idx, use_kernel=use_kernel, clients=clients)

    q = _proj(p["wq"], x, ad.get("wq"), masks.get("wq"), scaling,
              **kw).reshape(b, sq, -1, hd)
    new_cache = None

    if cross and mode == "decode":
        # the encoder's k/v, projected once at prefill
        ck, cv = cache["k"][rows].to(x.dtype), cache["v"][rows].to(x.dtype)
        every = torch.ones((1, 1, 1, 1, ck.shape[1]), dtype=torch.bool,
                           device=x.device)
        o = _direct(q.reshape(b, sq, kv, g, hd), ck, cv, every, scale,
                    cfg.attn_softcap)
        new_cache = cache
    elif mode == "decode":
        k, v = (_proj(p[n], x, ad.get(n), masks.get(n), scaling, **kw)
                .reshape(b, sq, -1, hd) for n in ("wk", "wv"))
        positions = pos[:, None]                              # (M, 1)
        if use_rope:
            q = L.rope(q, positions, cfg.rope_theta)
            k = L.rope(k, positions, cfg.rope_theta)
        ck, cv = cache["k"], cache["v"]
        ck[rows, pos] = k[:, 0].to(ck.dtype)
        cv[rows, pos] = v[:, 0].to(cv.dtype)
        t = ck.shape[1]
        valid = torch.arange(t, device=x.device)[None, :] <= pos[:, None]
        o = _direct(q.reshape(b, sq, kv, g, hd), ck[rows].to(x.dtype),
                    cv[rows].to(x.dtype), valid[:, None, None, None, :],
                    scale, cfg.attn_softcap)
        new_cache = cache
    else:                                              # train / prefill
        src = kv_x if cross else x
        sk = src.shape[-2]
        k, v = (_proj(p[n], src, ad.get(n), masks.get(n), scaling, **kw)
                .reshape(b, sk, -1, hd) for n in ("wk", "wv"))
        causal = causal and not cross
        if use_rope:
            positions = torch.arange(sq, device=x.device)[None, :]
            q = L.rope(q, positions, cfg.rope_theta)
            k = L.rope(k, positions, cfg.rope_theta)
        if use_kernel:
            o = (FlashAttention.apply(q, k, v, causal, window,
                                      cfg.attn_softcap) if mode == "train"
                 else mha_flash(q, k, v, causal=causal))
        else:
            qpos = torch.arange(sq, device=x.device)
            kpos = torch.arange(sk, device=x.device)
            m = (kpos[None, :] <= qpos[:, None]) if causal else torch.ones(
                (sq, sk), dtype=torch.bool, device=x.device)
            if window:
                m = m & (kpos[None, :] > qpos[:, None] - window)
            o = _direct(q.reshape(b, sq, kv, g, hd), k, v,
                        m[None, None, None], scale, cfg.attn_softcap)
        if mode == "prefill" and cache is not None:
            if cross:            # the whole cross cache is the encoder's
                new_cache = {"k": k.to(cache["k"].dtype),
                             "v": v.to(cache["v"].dtype)}
            else:
                ck = torch.zeros_like(cache["k"])
                cv = torch.zeros_like(cache["v"])
                ck[:, :sq] = k.to(ck.dtype)
                cv[:, :sq] = v.to(cv.dtype)
                new_cache = {"k": ck, "v": cv}

    o = o.reshape(lead + (sq, h, hd))
    out = _out_proj(p["wo"], o, ad.get("wo"), masks.get("wo"), scaling, **kw)
    return out, new_cache
