"""Flash attention forward (reference: ``repro/kernels/flash_attention.py``):
causal / sliding-window / soft-capped online-softmax attention, GQA-aware
without materializing repeated KV heads.

On CUDA tensors both wrappers launch the hand-written Hopper kernel in
``csrc/flash_attention.cu`` (design notes there) or raise; on CPU tensors
they compute the plain version,
:func:`repro_torch.kernels.ref.flash_attention_ref`, on repeated kv heads.
Unlike the TPU kernel, sequence lengths need not divide any block: the
kernel masks ragged tails itself.  :func:`plan` picks the body a call runs:
``mma_kernel`` (bf16, ``mma.sync``) or ``tf32_kernel`` (f32), or for bf16
at training rows ``wgmma_kernel`` (``wgmma`` fed by TMA).

:class:`FlashAttention` makes :func:`mha_flash` differentiable for training:
the kernel forward, and as backward the autograd of the recomputed plain
version (the JAX package has no backward kernel; ``jax.grad`` goes through
the jnp attention, ``repro/models/attention.py:_direct``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bea_fused import DTYPE_CODE, SMS
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)
# float32 (tf32_kernel) is built up to 128: a 256-wide f32 tile does not fit
# its shared memory (ROADMAP.md queue 2 item 1); 36 (MiniCPM-2B's SMOKE) runs
# on a tile padded to 40 inside the kernel, nothing padded here
F32_HEAD_DIMS = (16, 32, 36, 64, 128)

# The bf16 wgmma body (csrc/flash_attention.cu:wgmma_kernel): query tiles of
# 64 rows per consumer warpgroup, 64-key K/V tiles, one block per SM walking
# the tiles.  TMA needs 16-byte aligned bases and strides.  The rules come
# from a sweep on an H100 (chip_smoke.py phase 11, PERF.md §6): from 32
# query rows (the shortest timed) up it beats mma_kernel at every shape
# timed, serving prefill included.  Its loads are bound by L2's bandwidth (each K/V tile is read
# once per query tile), so the widest query tile wins, 4 warpgroups (256
# rows) at head dim 64, as long as its tiles still fill WGMMA_FILL of the
# SMs; with fewer tiles (one sequence) narrower ones keep more SMs busy.
# At head dim 256 (Gemma) a consumer's O accumulator takes 128 registers a
# thread, so only two consumers fit (the register split in the .cu file).
WGMMA_HEAD_DIMS = (64, 128, 256)
WGMMA_MIN_SQ = 32             # query rows from which wgmma beats mma_kernel
WGMMA_CONSUMERS = {64: (4, 3, 2), 128: (2,), 256: (2,)}   # widest first: the built instances
WGMMA_FILL = 0.8


class Plan(NamedTuple):
    """The body of one call: ``kernel`` "mma" (``mma_kernel`` in bf16,
    ``tf32_kernel`` in f32) or "wgmma"; for wgmma its consumer warpgroups
    (64 query rows each) and its grid (``blocks`` walking the tiles)."""
    kernel: str
    consumers: int = 0
    blocks: int = 0

    @property
    def code(self) -> int:
        """The launcher's ``body`` argument."""
        if self.kernel != "wgmma":
            return 0
        return self.consumers | self.blocks << 8


def _tiles(b: int, h: int, sq: int, consumers: int) -> int:
    return b * h * -(-sq // (64 * consumers))


def wgmma_plan(b: int, h: int, sq: int, hd: int,
               consumers: int | None = None) -> Plan:
    """The wgmma body's plan: the most consumer warpgroups whose query tile
    is no taller than the sequence and whose tiles fill WGMMA_FILL of the
    SMs (or ``consumers``: the chip's sweep compares them), on one block
    per SM walking the tiles (no more blocks than tiles)."""
    wide = WGMMA_CONSUMERS[hd]
    if consumers is None:
        consumers = next((c for c in wide if 64 * c <= sq and _tiles(
            b, h, sq, c) >= WGMMA_FILL * SMS), wide[-1])
    if consumers not in wide:
        raise ValueError(f"flash_attention: no wgmma instance for head dim "
                         f"{hd} with {consumers} consumers")
    return Plan("wgmma", consumers, min(_tiles(b, h, sq, consumers), SMS))


def _require_built(dtype: torch.dtype, hd: int) -> None:
    if hd not in (F32_HEAD_DIMS if dtype == torch.float32 else HEAD_DIMS):
        raise ValueError(f"flash_attention: head dim {hd} is not built for "
                         f"{dtype} (bf16 {HEAD_DIMS}, f32 {F32_HEAD_DIMS}); "
                         f"see ROADMAP.md queue 2 item 1")


@functools.lru_cache(maxsize=1024)
def plan(dtype: torch.dtype, b: int, h: int, sq: int, sk: int, hd: int,
         aligned: bool = True) -> Plan:
    """The body for a call of ``b`` sequences of ``sq`` queries over ``sk``
    keys, ``h`` query heads of ``hd``: bf16 at head dims 64, 128 and 256
    with at least WGMMA_MIN_SQ query rows and operands TMA can load
    (``aligned``: 16-byte bases and strides) takes :func:`wgmma_plan`;
    every other call (f32, head dims 16 and 32, shorter or strided bf16
    calls) the mma.sync bodies.  A head dim no body is built for raises
    ``ValueError``.  Memoized: a forward asks for the same shape in every
    layer."""
    _require_built(dtype, hd)
    if (dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS and aligned
            and sq >= WGMMA_MIN_SQ and sk > 0):
        return wgmma_plan(b, h, sq, hd)
    return Plan("mma")


def tma_aligned(*views) -> bool:
    """Whether (tensor, (batch, head, seq) element strides) views all start
    on 16 bytes and step by multiples of 16 bytes."""
    return all(t.data_ptr() % 16 == 0
               and all(x * t.element_size() % 16 == 0 for x in st)
               for t, st in views)


@functools.cache
def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, o, qs, ks, vs, os_, *, b, h, sq, sk, hd, group, causal,
            window, softcap, scale, body=None):
    """q/o viewed as (b, h, s, hd) and k/v as (b, h // group, s, hd), each by
    its (batch, head, seq) element strides, under :func:`plan` (or the
    ``body`` plan given)."""
    for label, t in (("q", q), ("k", k), ("v", v)):
        if t.device != o.device or t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {label} must be {q.dtype} on "
                            f"{o.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {label} needs a contiguous "
                             f"head dim")
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype}")
    _require_built(q.dtype, hd)
    if group < 1 or h % group:
        raise ValueError(f"flash_attention: {h} heads not divisible by "
                         f"group {group}")
    scale = hd ** -0.5 if scale is None else scale
    if body is None:
        body = plan(q.dtype, b, h, sq, sk, hd, tma_aligned(
            (q, qs), (k, ks), (v, vs), (o, os_)))
    rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     b, h, sq, sk, hd, *qs, *ks, *vs, *os_, group,
                     float(scale), int(bool(causal)), int(window),
                     float(softcap), DTYPE_CODE[q.dtype], body.code,
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
              softcap: float = 0.0, scale: float | None = None,
              body: Plan | None = None):
    """(B, Sq, H, hd) queries over (B, Sk, KVH, hd) keys/values → (B, Sq, H,
    hd); Sk may differ from Sq (cross-attention; causal masks key j > query
    i).  The kernel reads this layout through its strides: nothing is
    transposed or repeated.  ``body`` forces a :class:`Plan` on CUDA (the
    chip's sweep compares them); by default :func:`plan` picks it."""
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
                   softcap=softcap, scale=scale, body=body)


flash_attention.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable :func:`mha_flash`: q (B, Sq, H, hd), k/v (B, Sk, KVH,
    hd) — causal GQA self-attention (bf16 or f32), with a sliding
    ``window`` and a tanh ``softcap`` where the config has them (Gemma),
    bidirectional self-attention, or cross-attention with Sq ≠ Sk.  The
    backward recomputes the scores with :func:`flash_attention_ref` (same
    window and soft-cap) on the kv heads repeated ``H // KVH`` times and
    differentiates them, so the kv grads sum over each group; Sq·Sk scores
    per head live only inside the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window=0, softcap=0.0):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window, ctx.softcap = causal, window, softcap
        return mha_flash(q, k, v, causal=causal, window=window,
                         softcap=softcap)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        group = q.shape[2] // k.shape[2]
        leaves = [t.detach().requires_grad_(n)
                  for t, n in zip((q, k, v), ctx.needs_input_grad[:3])]
        want = [t for t in leaves if t.requires_grad]
        if not want:
            return None, None, None, None, None, None
        with torch.enable_grad():
            o = flash_attention_ref(
                leaves[0], leaves[1].repeat_interleave(group, dim=2),
                leaves[2].repeat_interleave(group, dim=2), causal=ctx.causal,
                window=ctx.window, softcap=ctx.softcap)
            got = iter(torch.autograd.grad(o, want, g))
        return tuple(next(got) if t.requires_grad else None
                     for t in leaves) + (None, None, None)
