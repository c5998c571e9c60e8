"""Flash attention forward (reference: ``repro/kernels/flash_attention.py``):
causal / sliding-window / soft-capped online-softmax attention, GQA-aware
without materializing repeated KV heads.

On CUDA tensors both wrappers launch the hand-written Hopper kernel in
``csrc/flash_attention.cu`` (design notes there) or raise; on CPU tensors
they compute the plain version,
:func:`repro_torch.kernels.ref.flash_attention_ref`, on repeated kv heads.
Unlike the TPU kernel, sequence lengths need not divide any block: the
kernel masks ragged tails itself.

:class:`FlashAttention` makes :func:`mha_flash` differentiable for training:
the kernel forward, and as backward the autograd of the recomputed plain
version (the JAX package has no backward kernel; ``jax.grad`` goes through
the jnp attention, ``repro/models/attention.py:_direct``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bea_fused import DTYPE_CODE
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128)


@functools.cache
def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, o, qs, ks, vs, os_, *, b, h, sq, sk, hd, group, causal,
            window, softcap, scale):
    """q/o viewed as (b, h, s, hd) and k/v as (b, h // group, s, hd), each by
    its (batch, head, seq) element strides."""
    for label, t in (("q", q), ("k", k), ("v", v)):
        if t.device != o.device or t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {label} must be {q.dtype} on "
                            f"{o.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {label} needs a contiguous "
                             f"head dim")
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if group < 1 or h % group:
        raise ValueError(f"flash_attention: {h} heads not divisible by "
                         f"group {group}")
    scale = hd ** -0.5 if scale is None else scale
    rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     b, h, sq, sk, hd, *qs, *ks, *vs, *os_, group,
                     float(scale), int(bool(causal)), int(window),
                     float(softcap), DTYPE_CODE[q.dtype],
                     torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return o


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float | None = None,
                    group: int = 1):
    """q: (BH, Sq, hd); k/v: (BH // group, Sk, hd) → (BH, Sq, hd).

    ``group`` = GQA group size; query head ``i`` reads kv head ``i // group``.
    """
    bh, sq, hd = q.shape
    sk = k.shape[1]
    if q.device.type == "cpu":
        kr = k.repeat_interleave(group, dim=0)
        vr = v.repeat_interleave(group, dim=0)
        out = flash_attention_ref(q.transpose(0, 1)[None], kr.transpose(0, 1)[None],
                                  vr.transpose(0, 1)[None], causal=causal,
                                  window=window, softcap=softcap, scale=scale)
        return out[0].transpose(0, 1)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if k.shape != (bh // group, sk, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} group {group}")
    o = torch.empty_like(q, memory_format=torch.contiguous_format)

    def st(t):                      # (BH, S, hd) as (1, BH, S, hd)
        return (0, t.stride(0), t.stride(1))

    return _launch(q, k, v, o, st(q), st(k), st(v), st(o), b=1, h=bh, sq=sq,
                   sk=sk, hd=hd, group=group, causal=causal, window=window,
                   softcap=softcap, scale=scale)


def mha_flash(q, k, v, *, causal: bool = True, window: int = 0,
              softcap: float = 0.0, scale: float | None = None):
    """(B, Sq, H, hd) queries over (B, Sk, KVH, hd) keys/values → (B, Sq, H,
    hd); Sk may differ from Sq (cross-attention; causal masks key j > query
    i).  The kernel reads this layout through its strides: nothing is
    transposed or repeated."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    group = h // kvh if kvh else 0
    if q.device.type == "cpu":
        return flash_attention_ref(q, k.repeat_interleave(group, dim=2),
                                   v.repeat_interleave(group, dim=2),
                                   causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"mha_flash: unsupported device {q.device}")
    sk = k.shape[1]
    if k.shape != (b, sk, kvh, hd) or v.shape != k.shape or group * kvh != h:
        raise ValueError(f"mha_flash: q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    o = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)

    def st(t):                      # (B, S, H, hd) as (B, H, S, hd)
        return (t.stride(0), t.stride(2), t.stride(1))

    return _launch(q, k, v, o, st(q), st(k), st(v), st(o), b=b, h=h, sq=sq,
                   sk=sk, hd=hd, group=group, causal=causal, window=window,
                   softcap=softcap, scale=scale)


flash_attention.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable :func:`mha_flash` without window or soft-cap: q (B, Sq,
    H, hd), k/v (B, Sk, KVH, hd) — causal GQA self-attention (bf16 or f32),
    bidirectional self-attention, or cross-attention with Sq ≠ Sk.  The
    backward recomputes the scores with :func:`flash_attention_ref` on the
    kv heads repeated ``H // KVH`` times and differentiates them, so the
    kv grads sum over each group; Sq·Sk scores per head live only inside
    the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return mha_flash(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        group = q.shape[2] // k.shape[2]
        leaves = [t.detach().requires_grad_(n)
                  for t, n in zip((q, k, v), ctx.needs_input_grad[:3])]
        want = [t for t in leaves if t.requires_grad]
        if not want:
            return None, None, None, None
        with torch.enable_grad():
            o = flash_attention_ref(
                leaves[0], leaves[1].repeat_interleave(group, dim=2),
                leaves[2].repeat_interleave(group, dim=2), causal=ctx.causal)
            got = iter(torch.autograd.grad(o, want, g))
        return tuple(next(got) if t.requires_grad else None
                     for t in leaves) + (None,)
