"""Dispatch around the kernels (reference: ``repro/kernels/ops.py``).

``use_kernel=True`` routes to the kernel wrappers — the CUDA kernel for a
CUDA tensor, its plain version for a CPU tensor.  ``use_kernel=False`` is
the unfused PyTorch form on any device: the CPU tests and ``chip_smoke.py``
use it to run the whole path without the kernels.
"""

from __future__ import annotations

import torch

from repro_torch.core.adapters import apply_adapter
from repro_torch.kernels.bea_batched import bea_batched
from repro_torch.kernels.bea_fused import BeaDense, BeaDenseGrouped
from repro_torch.kernels.ref import bea_dense_grouped_ref


def adapted_dense(x, w, a, b, e, mask, scaling: float,
                  use_kernel: bool = False):
    """x: (..., K) @ w (K, N) with the masked-BEA epilogue; leading dims are
    flattened into M for the kernel.  A and B are cast to x's dtype, as
    ``core/adapters.py:apply_adapter`` casts them.  The kernel call is
    differentiable in x, A, B and E (:class:`BeaDense`)."""
    cd = x.dtype
    if not use_kernel:
        return apply_adapter(x @ w.to(cd), x, {"A": a, "B": b, "E": e}, mask,
                             scaling)
    lead = x.shape[:-1]
    xm = x.reshape(-1, x.shape[-1]).contiguous()
    ym = BeaDense.apply(xm, w, a.to(cd), b.to(cd), e.float(), mask.bool(),
                        scaling)
    return ym.reshape(lead + (w.shape[1],))


def adapted_dense_grouped(x, w, a, b, e, mask, scaling: float,
                          use_kernel: bool = False):
    """C clients' x: (C, ..., K) @ the shared w (K, N), each client with
    its own adapter — a (C, r, K), b (C, N, r), e (C, r) — and the shared
    mask (r,); the inner dims are flattened into each client's M.  The
    kernel call is differentiable in x, A, B and E
    (:class:`BeaDenseGrouped`)."""
    cd = x.dtype
    xm = x.reshape(x.shape[0], -1, x.shape[-1])
    if use_kernel:
        ym = BeaDenseGrouped.apply(xm.contiguous(), w, a.to(cd), b.to(cd),
                                   e.float(), mask.bool(), scaling)
    else:
        ym = bea_dense_grouped_ref(xm, w, a, b, e, mask, scaling)
    return ym.reshape(x.shape[:-1] + (w.shape[1],))


def adapted_dense_multi(x, w, a_stack, b_stack, e_stack, m_stack, idx,
                        scaling: float, use_kernel: bool = False):
    """Multi-tenant x: (M, K) @ w (K, N) — row i uses adapter ``idx[i]``.

    a_stack: (G, r, K); b_stack: (G, N, r); e_stack/m_stack: (G, r).
    """
    cd = x.dtype
    if use_kernel:
        return bea_batched(x.contiguous(), w, a_stack.to(cd), b_stack.to(cd),
                           e_stack.float(), m_stack.bool(),
                           idx.to(torch.int32), scaling)
    g = a_stack.shape[0]
    if g == 0 or a_stack.shape[1] == 0:
        return x @ w.to(cd)
    y = x @ w.to(cd)
    onehot = (idx[:, None] == torch.arange(g, device=x.device)[None, :]).to(cd)
    u = torch.einsum("mk,grk->mgr", x, a_stack.to(cd))
    em = (e_stack * m_stack.to(e_stack.dtype)).to(cd)
    t = u * em[None] * onehot[:, :, None]
    return y + scaling * torch.einsum("mgr,gnr->mn", t, b_stack.to(cd))
