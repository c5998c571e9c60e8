"""PEFT adapter structures (reference: ``repro/core/adapters.py``), the BEA
and LoRA forms:

    ΔW = (α/r) · B · E · A        (BEA, Eq. 2 of the paper)

with ``E`` diagonal and zero at init; rank masking multiplies the diagonal,
so a masked rank contributes nothing (CommPru).  Per-expert adapters (an
MoE layer's) carry a leading expert axis on A, B and E and share one (r,)
mask across the experts.  The bottleneck adapters of
the FedAdapter-H/P baselines sit here too: ``down → gelu → up`` plus the
skip, applied to a block's sub-layer output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.pytree import ParamMeta

BEA = "bea"            # the paper: B·E·A truncated-SVD adaptation
LORA = "lora"          # FedLoRA baseline: B·A, B zero-init
FFA = "ffa"            # FFA-LoRA: B·A with A frozen
NONE = "none"


def adapter_meta(kind: str, d_in: int, d_out: int, rank: int,
                 n_experts: int = 0, dtype=torch.float32,
                 orthogonal_a: bool = False) -> dict | None:
    """Meta tree for one adapted linear: A (r, d_in), B (d_out, r)[, E (r,)],
    each with a leading (n_experts,) when ``n_experts > 0``."""
    if kind == NONE or rank <= 0:
        return None
    lead = (n_experts,) if n_experts else ()
    a_init = "uniform" if orthogonal_a else "scaled_normal"
    meta = {
        "A": ParamMeta(lead + (rank, d_in), dtype, init=a_init,
                       scale=1.0 / (d_in ** 0.5)),
        "B": ParamMeta(lead + (d_out, rank), dtype,
                       init="zeros" if kind in (LORA, FFA) else "scaled_normal",
                       scale=1.0 / (d_out ** 0.5)),
    }
    if kind == BEA:
        meta["E"] = ParamMeta(lead + (rank,), dtype, init="zeros")
    return meta


def apply_adapter(y: torch.Tensor, x: torch.Tensor, ad: dict | None,
                  mask: torch.Tensor | None, scaling: float) -> torch.Tensor:
    """``y + (α/r)·((x Aᵀ) ⊙ (e⊙m)) Bᵀ`` (BEA) or the LoRA analogue.

    x: (..., d_in), y: (..., d_out).  Per-expert adapters (A (E, r, d_in),
    B (E, d_out, r), E (E, r)) take x (E, ..., d_in) and y (E, ..., d_out),
    expert ``e``'s rows through expert ``e``'s adapter, with the (r,) mask
    shared by every expert.
    """
    if ad is None:
        return y
    a, b = ad["A"], ad["B"]
    cd = y.dtype
    if a.ndim == 2:                                   # plain linear
        u = x @ a.to(cd).T
    else:                                             # per-expert
        u = torch.einsum("e...i,eri->e...r", x, a.to(cd))
    if "E" in ad:
        e = ad["E"]
        em = (e if mask is None else e * mask.to(e.dtype)).to(cd)
        if em.ndim == 2:                              # per-expert (E, r)
            em = em.reshape(em.shape[:1] + (1,) * (u.ndim - 2) + em.shape[1:])
        u = u * em
    elif mask is not None:
        u = u * mask.to(cd)
    if b.ndim == 2:
        dy = u @ b.to(cd).T
    else:                                             # (E, d_out, r)
        dy = torch.einsum("e...r,eor->e...o", u, b.to(cd))
    return y + scaling * dy



# Bottleneck adapters (FedAdapter-h / FedAdapter-p baselines) ----------------

def bottleneck_meta(d_model: int, size: int, dtype=torch.float32) -> dict:
    """Houlsby/Pfeiffer-style bottleneck adapter: down → gelu → up + skip.
    ``up`` and both biases start at zero, so the adapter is the identity."""
    return {
        "down": ParamMeta((d_model, size), dtype, init="normal"),
        "up": ParamMeta((size, d_model), dtype, init="zeros"),
        "bd": ParamMeta((size,), dtype, init="zeros"),
        "bu": ParamMeta((d_model,), dtype, init="zeros"),
    }


def apply_bottleneck(x: torch.Tensor, ad: dict,
                     clients: bool = False) -> torch.Tensor:
    """``x + gelu(x·down + bd)·up + bu`` in x's dtype (jax.nn.gelu's tanh
    form).  ``clients``: x is (C, ..., d) and each client has its own
    adapter (leaves with a leading C), applied by batched products."""
    cd = x.dtype
    if clients:
        xc = x.reshape(x.shape[0], -1, x.shape[-1])
        h = F.gelu(xc @ ad["down"].to(cd) + ad["bd"].to(cd)[:, None],
                   approximate="tanh")
        out = xc + h @ ad["up"].to(cd) + ad["bu"].to(cd)[:, None]
        return out.reshape(x.shape)
    h = F.gelu(x @ ad["down"].to(cd) + ad["bd"].to(cd), approximate="tanh")
    return x + h @ ad["up"].to(cd) + ad["bu"].to(cd)
