"""PEFT adapter structures (reference: ``repro/core/adapters.py``), the
non-expert BEA and LoRA forms:

    ΔW = (α/r) · B · E · A        (BEA, Eq. 2 of the paper)

with ``E`` diagonal and zero at init; rank masking multiplies the diagonal,
so a masked rank contributes nothing (CommPru).  The bottleneck adapters of
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
                 dtype=torch.float32, orthogonal_a: bool = False
                 ) -> dict | None:
    """Meta tree for one adapted linear: A (r, d_in), B (d_out, r)[, E (r,)]."""
    if kind == NONE or rank <= 0:
        return None
    a_init = "uniform" if orthogonal_a else "scaled_normal"
    meta = {
        "A": ParamMeta((rank, d_in), dtype, init=a_init,
                       scale=1.0 / (d_in ** 0.5)),
        "B": ParamMeta((d_out, rank), dtype,
                       init="zeros" if kind in (LORA, FFA) else "scaled_normal",
                       scale=1.0 / (d_out ** 0.5)),
    }
    if kind == BEA:
        meta["E"] = ParamMeta((rank,), dtype, init="zeros")
    return meta


def apply_adapter(y: torch.Tensor, x: torch.Tensor, ad: dict | None,
                  mask: torch.Tensor | None, scaling: float) -> torch.Tensor:
    """``y + (α/r)·((x Aᵀ) ⊙ (e⊙m)) Bᵀ`` (BEA) or the LoRA analogue.

    x: (..., d_in), y: (..., d_out).
    """
    if ad is None:
        return y
    cd = y.dtype
    u = x @ ad["A"].to(cd).T
    if "E" in ad:
        e = ad["E"]
        em = e if mask is None else e * mask.to(e.dtype)
        u = u * em.to(cd)
    elif mask is not None:
        u = u * mask.to(cd)
    return y + scaling * (u @ ad["B"].to(cd).T)



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
