"""Fused masked-BEA adapted linear (reference: ``repro/kernels/bea_fused.py``):

    y = x·W + s·((x·Aᵀ) ⊙ (e⊙m))·Bᵀ

On a CUDA tensor :func:`bea_dense` launches the hand-written Hopper kernel in
``csrc/bea_fused.cu`` (design notes there) or raises; on a CPU tensor it
computes the plain version, :func:`repro_torch.kernels.ref.bea_dense_ref`.
The kernel masks its own ragged edges, so nothing is padded on the host.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bea_dense_ref

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_RANK = 64


@functools.cache
def _launcher():
    fn = _build.load("bea_fused").bea_dense_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check_operands(name: str, x, mats, e, mask, device) -> None:
    """Raise on anything the adapter kernels do not take."""
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    for label, t in mats.items():
        if t.device != device:
            raise ValueError(f"{name}: {label} on {t.device}, x on {device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: {label} is {t.dtype}, x is {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    for label, t, dt in (("e", e, torch.float32), ("mask", mask, torch.bool)):
        if t.device != device or t.dtype != dt or not t.is_contiguous():
            raise TypeError(f"{name}: {label} must be a contiguous {dt} "
                            f"tensor on {device}")


def bea_dense(x, w, a, b, e, mask, scaling: float = 1.0):
    """x: (M, K); w: (K, N); a: (r, K); b: (N, r) — one dtype, float32 or
    bfloat16; e: (r,) float32; mask: (r,) bool.  Returns (M, N) in x's dtype.
    """
    if x.device.type == "cpu":
        return bea_dense_ref(x, w, a, b, e, mask, scaling)
    if x.device.type != "cuda":
        raise ValueError(f"bea_dense: unsupported device {x.device}")
    m, k = x.shape
    n, r = w.shape[1], a.shape[0]
    if w.shape != (k, n) or a.shape != (r, k) or b.shape != (n, r) \
            or e.shape != (r,) or mask.shape != (r,):
        raise ValueError(
            f"bea_dense: shapes x{tuple(x.shape)} w{tuple(w.shape)} "
            f"a{tuple(a.shape)} b{tuple(b.shape)} e{tuple(e.shape)} "
            f"mask{tuple(mask.shape)} do not agree")
    if r > MAX_RANK:
        raise ValueError(f"bea_dense: rank {r} > {MAX_RANK}")
    check_operands("bea_dense", x, {"x": x, "w": w, "a": a, "b": b}, e, mask,
                   x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = _launcher()(x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
                     e.data_ptr(), mask.data_ptr(), out.data_ptr(), m, k, n, r,
                     float(scaling), DTYPE_CODE[x.dtype],
                     torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "bea_dense")
    bea_dense.launches += 1
    return out


bea_dense.launches = 0
