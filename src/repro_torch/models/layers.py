"""Shared layer primitives: norms, embeddings, RoPE, adapted dense
(reference: ``repro/models/layers.py``)."""

from __future__ import annotations

import math

import torch

from repro_torch.core import adapters as A
from repro_torch.kernels import ops
from repro_torch.pytree import ParamMeta


# ---------------------------------------------------------------- norms ----

def norm_meta(cfg, dim: int | None = None) -> dict:
    if cfg.norm not in ("rmsnorm", "layernorm"):
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")
    d = dim or cfg.d_model
    m = {"scale": ParamMeta((d,), torch.float32,
                            init="zeros" if cfg.rms_offset else "ones")}
    if cfg.norm == "layernorm":
        m["bias"] = ParamMeta((d,), torch.float32, init="zeros")
    return m


def norm_apply(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """RMSNorm or LayerNorm in f32 with eps 1e-6 (not torch's 1e-5), cast
    back to x's dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).pow(2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
        return (y * p["scale"] + p["bias"]).to(x.dtype)
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + 1e-6)
    scale = (1.0 + p["scale"]) if cfg.rms_offset else p["scale"]
    return (y * scale).to(x.dtype)


# ----------------------------------------------------------- embeddings ----

def embed_meta(cfg) -> dict:
    if cfg.pos_emb not in ("rope", "none", "learned"):
        raise NotImplementedError(f"pos_emb {cfg.pos_emb!r} is not ported yet")
    m = {"tok": ParamMeta((cfg.vocab_size, cfg.d_model), cfg.pdtype,
                          init="scaled_normal", scale=0.25)}
    if cfg.pos_emb == "learned":
        m["pos"] = ParamMeta((min(cfg.max_position, 1 << 16), cfg.d_model),
                             cfg.pdtype, init="scaled_normal", scale=0.02)
    return m


def embed_apply(p: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Token embeddings, then learned positions ``0..S-1`` where the config
    has them (tokens: (..., S))."""
    x = p["tok"][tokens].to(cfg.cdtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.cdtype)
    if cfg.pos_emb == "learned":
        x = x + p["pos"][:tokens.shape[-1]].to(cfg.cdtype)
    return x


# ------------------------------------------------------------------ rope ----

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split RoPE.  x: (..., S, H, hd); positions: broadcastable to
    (..., S).  Frequencies exp(-ln θ·i/half) and the rotation in f32."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., None].float() * freqs            # (..., S, half)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:2 * half].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if 2 * half != hd:                       # odd head_dim tail passes through
        out = torch.cat([out, x[..., 2 * half:].float()], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- dense ----

def dense_meta(cfg, d_in: int, d_out: int, *, bias: bool = False,
               out_scale: float = 1.0) -> dict:
    m = {"w": ParamMeta((d_in, d_out), cfg.pdtype, init="normal",
                        scale=out_scale)}
    if bias:
        m["b"] = ParamMeta((d_out,), cfg.pdtype, init="zeros")
    return m


def linear(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None,
           ad: dict | None, mask, scaling: float, *, idx=None,
           use_kernel: bool = False, clients: bool = False) -> torch.Tensor:
    """x (..., K) @ w (K, N) [+ bias] with the module's adapter.

    ``idx=None``: ``ad`` is one adapter {A (r, K), B (N, r), E (r,)}.
    ``idx`` (M,): ``ad`` holds rank-bucket stacks {A (G, r, K), …} and row
    ``i`` of x (M, 1, K) uses adapter ``idx[i]`` (the batched decode).
    ``clients``: x is (C, ..., K) and ``ad`` holds C clients' adapters
    {A (C, r, K), …} on the shared mask (the cohort's local phase).
    ``use_kernel`` routes the adapted product through the kernel wrappers;
    otherwise it is the JAX package's einsum form.
    """
    cd = x.dtype
    if ad is None or (idx is None and not use_kernel and not clients):
        y = x @ w.to(cd)
        if bias is not None:
            y = y + bias.to(cd)
        return A.apply_adapter(y, x, ad, mask, scaling)
    # LoRA modules have no E; a missing mask keeps every rank (one mask for
    # all of a cohort's clients)
    e = ad["E"] if "E" in ad else torch.ones(
        ad["A"].shape[:-1], dtype=torch.float32, device=x.device)
    m = mask if mask is not None else torch.ones(
        e.shape[-1:] if clients else e.shape, dtype=torch.bool,
        device=x.device)
    if clients:
        y = ops.adapted_dense_grouped(x, w, ad["A"], ad["B"], e, m, scaling,
                                      use_kernel=use_kernel)
    elif idx is None:
        y = ops.adapted_dense(x, w, ad["A"], ad["B"], e, m, scaling,
                              use_kernel=True)
    else:
        y = ops.adapted_dense_multi(x.reshape(-1, x.shape[-1]), w, ad["A"],
                                    ad["B"], e, m, idx, scaling,
                                    use_kernel=use_kernel)
        y = y.reshape(x.shape[:-1] + (w.shape[1],))
    if bias is not None:
        y = y + bias.to(cd)
    return y


def dense_apply(p: dict, x: torch.Tensor, ad: dict | None = None,
                mask: torch.Tensor | None = None, scaling: float = 1.0, *,
                idx=None, use_kernel: bool = False,
                clients: bool = False) -> torch.Tensor:
    return linear(x, p["w"], p.get("b"), ad, mask, scaling, idx=idx,
                  use_kernel=use_kernel, clients=clients)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)
