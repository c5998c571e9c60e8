"""Plain PyTorch versions of every kernel (reference: ``repro/kernels/ref.py``).

The CPU tests use them, the kernel wrappers take them for CPU tensors, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.  Nothing
on the card's main path calls them.
"""

from __future__ import annotations

import torch

NEG_INF = -2.3819763e38


def bea_adapter_ref(x, a, b, e, mask, scaling: float):
    """The adapter term alone: scaling·((x Aᵀ) ⊙ (e⊙mask)) Bᵀ, in x's dtype.
    The training backward of the fused kernel differentiates this."""
    cd = x.dtype
    u = x @ a.to(cd).T
    u = u * (e * mask.to(e.dtype)).to(cd)
    return scaling * (u @ b.to(cd).T)


def bea_dense_ref(x, w, a, b, e, mask, scaling: float):
    """y = x@W + scaling·((x Aᵀ) ⊙ (e⊙mask)) Bᵀ, in x's dtype.

    x: (M, K); w: (K, N); a: (r, K); b: (N, r); e, mask: (r,).
    """
    return x @ w.to(x.dtype) + bea_adapter_ref(x, a, b, e, mask, scaling)


def bea_adapter_grouped_ref(x, a, b, e, mask, scaling: float):
    """:func:`bea_adapter_ref` with a leading client axis on x (C, M, K), a
    (C, r, K), b (C, N, r) and e (C, r); the mask (r,) is shared."""
    cd = x.dtype
    u = x @ a.to(cd).transpose(-1, -2)
    u = u * (e * mask.to(e.dtype)).to(cd)[:, None, :]
    return scaling * (u @ b.to(cd).transpose(-1, -2))


def bea_dense_grouped_ref(x, w, a, b, e, mask, scaling: float):
    """The client-grouped masked-BEA linear: client c's rows x[c] (M, K)
    through :func:`bea_dense_ref` with adapter (a[c], b[c], e[c]), the base
    w (K, N) and the mask (r,) shared → (C, M, N)."""
    return x @ w.to(x.dtype) + bea_adapter_grouped_ref(x, a, b, e, mask,
                                                       scaling)


def lora_dense_ref(x, w, a, b, mask, scaling: float):
    """y = x@W + scaling·((x Aᵀ) ⊙ mask) Bᵀ, the LoRA form (no E), in x's
    dtype.  The LoRA baselines run through the fused kernel with E = 1."""
    cd = x.dtype
    u = (x @ a.to(cd).T) * mask.to(cd)
    return x @ w.to(cd) + scaling * (u @ b.to(cd).T)


def bea_batched_ref(x, w, a_stack, b_stack, e_stack, m_stack, idx,
                    scaling: float):
    """Sequential per-request reference for the multi-tenant batched kernel:
    row ``i`` goes through :func:`bea_dense_ref` with adapter ``idx[i]``.

    x: (M, K); w: (K, N); a_stack: (G, r, K); b_stack: (G, N, r);
    e_stack/m_stack: (G, r); idx: (M,) int in [0, G).
    """
    rows = []
    for i, g in enumerate(idx.tolist()):
        rows.append(bea_dense_ref(x[i:i + 1], w, a_stack[g], b_stack[g],
                                  e_stack[g], m_stack[g], scaling))
    if not rows:
        return x.new_zeros((0, w.shape[1]))
    return torch.cat(rows, dim=0)


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                        scale=None):
    """q/k/v: (B, S, H, hd) MHA (no GQA grouping in the kernel oracle)."""
    _, sq, _, hd = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    s_ = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if softcap:
        s_ = softcap * torch.tanh(s_ / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        m &= kpos <= qpos
    if window:
        m &= kpos > qpos - window
    s_ = torch.where(m[None, None], s_, torch.full_like(s_, NEG_INF))
    p = torch.softmax(s_, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
