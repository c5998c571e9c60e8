"""Rank-bucketed multi-tenant masked-BEA linear (reference:
``repro/kernels/bea_batched.py``): row ``i`` attaches adapter ``g = idx[i]``
of G adapters stacked at one bucket rank r,

    y[i] = x[i]·W + s·((x[i]·A_gᵀ) ⊙ (e_g⊙m_g))·B_gᵀ.

On a CUDA tensor :func:`bea_batched` launches the hand-written Hopper kernel
in ``csrc/bea_batched.cu`` (design notes there) or raises; on a CPU tensor
it computes the plain version,
:func:`repro_torch.kernels.ref.bea_batched_ref`.  G = 0 or r = 0 (a fully
pruned bucket) short-circuits to x·W outside the kernel, as the JAX wrapper
does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._scratch import workspace
from repro_torch.kernels.bea_fused import DTYPE_CODE, MAX_RANK, check_operands
from repro_torch.kernels.ref import bea_batched_ref


@functools.cache
def _launcher():
    lib = _build.load("bea_batched")
    fn = lib.bea_batched_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ws = lib.bea_batched_workspace_bytes
    ws.argtypes = [ctypes.c_int] * 4
    ws.restype = ctypes.c_longlong
    return fn, functools.cache(ws)


def bea_batched(x, w, a_stack, b_stack, e_stack, m_stack, idx,
                scaling: float = 1.0):
    """x: (M, K); w: (K, N); a_stack: (G, r, K); b_stack: (G, N, r) — one
    dtype, float32 or bfloat16; e_stack: (G, r) float32; m_stack: (G, r)
    bool; idx: (M,) int32 in [0, G).  Returns (M, N) in x's dtype."""
    g = a_stack.shape[0]
    r = a_stack.shape[1] if g else 0
    if g == 0 or r == 0:                    # fully-pruned bucket: dense only
        return x @ w.to(x.dtype)
    if x.device.type == "cpu":
        return bea_batched_ref(x, w, a_stack, b_stack, e_stack, m_stack, idx,
                               scaling)
    if x.device.type != "cuda":
        raise ValueError(f"bea_batched: unsupported device {x.device}")
    m, k = x.shape
    n = w.shape[1]
    if w.shape != (k, n) or a_stack.shape != (g, r, k) \
            or b_stack.shape != (g, n, r) or e_stack.shape != (g, r) \
            or m_stack.shape != (g, r) or idx.shape != (m,):
        raise ValueError(
            f"bea_batched: shapes x{tuple(x.shape)} w{tuple(w.shape)} "
            f"a{tuple(a_stack.shape)} b{tuple(b_stack.shape)} "
            f"e{tuple(e_stack.shape)} m{tuple(m_stack.shape)} "
            f"idx{tuple(idx.shape)} do not agree")
    if r > MAX_RANK:
        raise ValueError(f"bea_batched: rank {r} > {MAX_RANK}")
    check_operands("bea_batched", x,
                   {"x": x, "w": w, "a_stack": a_stack, "b_stack": b_stack},
                   e_stack, m_stack, x.device)
    if idx.dtype != torch.int32 or idx.device != x.device \
            or not idx.is_contiguous():
        raise TypeError("bea_batched: idx must be a contiguous int32 tensor "
                        f"on {x.device}")
    launch, ws_bytes = _launcher()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    nbytes = ws_bytes(m, k, n, r)
    ws = workspace(nbytes, x.device)
    rc = launch(x.data_ptr(), w.data_ptr(), a_stack.data_ptr(),
                b_stack.data_ptr(), e_stack.data_ptr(), m_stack.data_ptr(),
                idx.data_ptr(), out.data_ptr(), ws.data_ptr(), ws.numel(),
                m, k, n, g, r, float(scaling), DTYPE_CODE[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "bea_batched")
    bea_batched.launches += 1
    return out


bea_batched.launches = 0
