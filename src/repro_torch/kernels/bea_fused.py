"""Fused masked-BEA adapted linear (reference: ``repro/kernels/bea_fused.py``):

    y = x·W + s·((x·Aᵀ) ⊙ (e⊙m))·Bᵀ

On a CUDA tensor :func:`bea_dense` launches the hand-written Hopper kernel in
``csrc/bea_fused.cu`` (design notes there) or raises; on a CPU tensor it
computes the plain version, :func:`repro_torch.kernels.ref.bea_dense_ref`.
The kernel masks its own ragged edges, so nothing is padded on the host.
Both types run on the tensor cores (bfloat16 on ``mma.sync`` at serving
rows and ``wgmma`` at training rows, float32 as 3xTF32) under the plan
:func:`plan` computes here for the call.

:class:`BeaDense` makes the call differentiable for training: its forward is
:func:`bea_dense` (the kernel on the card), its backward plain PyTorch, as
the JAX package takes the gradient of the jnp form with ``jax.grad``
(``repro/core/adapters.py:apply_adapter``) and has no backward kernel.

:func:`bea_dense_grouped` (and :class:`BeaDenseGrouped`) is the float32
instance grouped over clients, the cohort runner's: C clients' x, A, B and E
on one shared W and rank mask in one launch, the counterpart of the
reference cohort's ``vmap`` of the same function over a leading client axis
(``repro/fedsim/cohort.py:173-174``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._scratch import workspace
from repro_torch.kernels.ref import (bea_adapter_grouped_ref,
                                    bea_adapter_ref, bea_dense_grouped_ref,
                                    bea_dense_ref)

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_RANK = 64

SMS = 132                  # streaming multiprocessors of an H100 SXM
TARGET_BLOCKS = 2 * SMS    # what a plan aims for: two blocks per SM
MAX_SPLITS = 20            # K-splits the reduce kernel sums at most


class Tiling(NamedTuple):
    """One kernel instance's tile shapes: K per pipeline stage, the
    (block_m, block_n) output tiles from largest to smallest, the K-steps a
    slice keeps while tiles can shrink (128 of K for both), and the most
    K-splits taken to reach TARGET_BLOCKS.  f32 takes at most 2: its
    partials are M·N floats per split, each written and read once more,
    and at the training shapes (M = 1024) a smaller tile with fewer splits
    times better on the card than a larger one with more."""
    block_k: int
    tiles: tuple[tuple[int, int], ...]
    min_steps: int
    fill_splits: int


TILINGS = {
    torch.bfloat16: Tiling(64, ((64, 64), (32, 64), (16, 64), (16, 32)), 2,
                           MAX_SPLITS),
    torch.float32: Tiling(32, ((128, 64), (64, 64), (64, 32)), 4, 2)}
# The f32 128-row tile keeps its x·W and x·Aᵀ accumulators in registers,
# each k-step's three MMAs summed apart first (mma.cuh); past rank 16 (u
# padded to 32 or 64 columns) that no longer fits in 255 registers and
# spills, so larger ranks take the 64-row tiles.
F32_WIDE_MAX_RANK = 16


class Plan(NamedTuple):
    """How the kernel tiles one (M, K, N) call: a block_m × block_n output
    tile and ``splits`` K-slices of ``k_slice`` each (the last one may be
    shorter, none is empty), on a grid of ``blocks`` blocks.  ``kernel`` is
    the instance: "mma" (``mma_kernel`` for bf16, ``tf32_kernel`` for f32:
    one block per tile and slice) or "wgmma" (bf16 at training rows: its
    blocks walk the tiles and slices)."""
    block_m: int
    block_n: int
    splits: int
    k_slice: int
    blocks: int
    kernel: str = "mma"

    def workspace_bytes(self, m: int, n: int, r: int, clients: int = 1
                        ) -> int:
        """f32 partials of x·W (M × N) and of u (M × r) per split and
        client; a single split stores directly and needs none."""
        return 4 * self.splits * clients * m * (n + r) \
            if self.splits > 1 else 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# The client-grouped f32 instance's tiling: 64×64 tiles (three blocks fit an
# SM) and K-slices of at most 48 K-steps (1536 of K).  The single call's
# rule, applied to C clients' row tiles, takes 128×64 tiles and one split
# at C = 3, M = 1024: a 288-block grid of which two blocks fit an SM, so a
# second, nearly empty wave runs the last 24, each over the whole of K.
# The rule was chosen from a sweep of the f32 tiles and split counts on an
# H100 at DistilBERT's linears (C = 2–4); chip_smoke.py phase 9 times it.
GROUPED_TILE = (64, 64)
GROUPED_MAX_STEPS = 48


# The bf16 wgmma instance (csrc/bea_fused.cu:wgmma_kernel): 128-row tiles
# of these widths, 64-deep K-steps.  TMA needs K and N (the x, A and W row
# pitches) to be multiples of 8 bf16 values.  The rules below come from a
# sweep on an H100 (chip_smoke.py phase 11, PERF.md §6): at M = 512 every
# Qwen2 linear already ran faster on it than under the mma.sync plan.  A
# call of few tiles (at most a quarter of the SMs) splits K into slices of
# about WGMMA_SLICE_STEPS K-steps, toward one block per SM: more blocks, and
# shorter sums in the tensor cores, whose accumulation truncates, added in
# f32 by the reduce kernel.  That is mma_kernel's plan for wk/wv at 4096
# rows (three slices of 5 K-steps), and it gives its bits: left whole, the
# 14 K-steps ran in 0.6 of the time but moved a training step's gradient
# cosine to f32 below phase 11's gate (PERF.md §6).
WGMMA_BLOCK_M = 128
WGMMA_BLOCK_NS = (256, 224, 128)
WGMMA_WIDE_MAX_RANK = 16   # ranks the 224- and 256-column tiles are built for
WGMMA_ALIGN = 8
WGMMA_MIN_M = 512          # rows from which wgmma beats the mma.sync plan
WGMMA_SLICE_STEPS = 5      # K-steps of a slice when a call splits K
WGMMA_PERSISTENT = True    # one block per SM walking the tiles


def wgmma_plan(m: int, k: int, n: int, rank: int = 0,
               splits: int | None = None,
               persistent: bool = WGMMA_PERSISTENT) -> Plan:
    """The wgmma instance's plan for an adapter of ``rank``: the column
    tile whose waves over the card cost least (each wave as long as its
    tile is wide; on a tie the wider tile; past rank WGMMA_WIDE_MAX_RANK
    only 128 columns, the one width built for the larger rank buckets), K
    whole unless the tiles fill at most a quarter of the SMs, then split
    into slices of about WGMMA_SLICE_STEPS K-steps within one wave, and a
    grid of one block per SM walking the tiles (``persistent``) or one
    block per tile.  ``splits`` forces a split count (the chip's sweep
    compares them)."""
    block_k = TILINGS[torch.bfloat16].block_k
    mt = _cdiv(m, WGMMA_BLOCK_M)
    widths = WGMMA_BLOCK_NS if rank <= WGMMA_WIDE_MAX_RANK else (128,)
    bn = min(widths, key=lambda w: (_cdiv(mt * _cdiv(n, w), SMS) * w, -w))
    tiles = mt * _cdiv(n, bn)
    steps = _cdiv(k, block_k)
    if splits is None:
        splits = 1
        if tiles <= SMS // 4:
            splits = max(1, min(SMS // tiles, _cdiv(steps, WGMMA_SLICE_STEPS),
                                MAX_SPLITS))
    per = _cdiv(steps, splits)
    splits = _cdiv(steps, per)                  # no empty slice
    work = tiles * splits
    return Plan(WGMMA_BLOCK_M, bn, splits, per * block_k,
                min(work, SMS) if persistent else work, "wgmma")


@functools.lru_cache(maxsize=4096)
def plan(m: int, k: int, n: int, dtype: torch.dtype = torch.bfloat16,
         clients: int = 1, rank: int = 0, aligned: bool = True) -> Plan:
    """The kernel's tiling for an (M, K) @ (K, N) call in ``dtype`` with
    an adapter of ``rank``, or for ``clients > 1`` such f32 calls grouped
    in one launch (the grouped rule above, its blocks every client's row
    tiles).  A bf16 call of one client with rows enough for 128-row tiles
    to fill the card and operands TMA can load (K and N multiples of 8;
    ``aligned``: x, w and a start on 16-byte boundaries) gets
    :func:`wgmma_plan`; every other call the mma.sync / 3xTF32 plan
    (:func:`mma_plan`).  Memoized: a training step asks for the same few
    shapes every call, and the rule costs microseconds of Python each time
    (chip_smoke.py phase 11's host costs)."""
    if (dtype == torch.bfloat16 and clients == 1 and aligned
            and m >= WGMMA_MIN_M and k > 0 and k % WGMMA_ALIGN == 0
            and n % WGMMA_ALIGN == 0):
        return wgmma_plan(m, k, n, rank)
    return mma_plan(m, k, n, dtype, clients, rank)


def mma_plan(m: int, k: int, n: int, dtype: torch.dtype = torch.bfloat16,
             clients: int = 1, rank: int = 0) -> Plan:
    """The ``mma_kernel`` / ``tf32_kernel`` plan.

    Fill the card first (each block's K-loop is latency-bound, so blocks in
    flight, not tile size, set the pace): take the largest tile that M
    does not leave mostly empty (block_m < 2·M) and split K toward
    TARGET_BLOCKS, into at most ``fill_splits`` slices of at least
    ``min_steps`` K-steps each; if that falls short, try the next smaller
    tile.  If no tile reaches the
    target, take the plan with the most blocks, and if that is under one
    block per SM, cut its slices shorter, down to one K-step, until it is
    not."""
    block_k, tiles, min_steps, fill_splits = TILINGS[dtype]
    if dtype == torch.float32 and rank > F32_WIDE_MAX_RANK:
        tiles = tuple(t for t in tiles if t[0] < 128)
    steps = max(1, _cdiv(k, block_k))

    def make(bm, bn, splits):
        per = _cdiv(steps, splits)              # K-steps per slice
        s = _cdiv(steps, per)                   # no empty slice
        return Plan(bm, bn, s, per * block_k,
                    clients * _cdiv(m, bm) * _cdiv(n, bn) * s)

    if clients > 1:
        if dtype != torch.float32:
            raise ValueError("the grouped instance is float32")
        return make(*GROUPED_TILE, _cdiv(steps, GROUPED_MAX_STEPS))

    smallest = min(bm for bm, _ in tiles)
    start = next(i for i, (bm, _) in enumerate(tiles)
                 if bm < 2 * m or bm == smallest)
    tried = []
    for bm, bn in tiles[start:]:
        n_tiles = _cdiv(m, bm) * _cdiv(n, bn)
        want = 1 if n_tiles >= TARGET_BLOCKS else _cdiv(TARGET_BLOCKS, n_tiles)
        p = make(bm, bn, min(want, max(1, steps // min_steps), fill_splits))
        if p.blocks >= TARGET_BLOCKS:
            return p
        tried.append(p)
    p = max(tried, key=lambda c: c.blocks)
    per = _cdiv(steps, p.splits)
    while p.blocks < SMS and per > 1 and _cdiv(steps, per - 1) <= MAX_SPLITS:
        per -= 1
        p = make(p.block_m, p.block_n, _cdiv(steps, per))
    return p


@functools.cache
def _launcher():
    fn = _build.load("bea_fused").bea_dense_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_longlong] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _grouped_launcher():
    fn = _build.load("bea_fused").bea_dense_grouped_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
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
    aligned = (x.data_ptr() | w.data_ptr() | a.data_ptr()) % 16 == 0
    out = run_plan(plan(m, k, n, x.dtype, rank=r, aligned=aligned),
                   x, w, a, b, e, mask, scaling)
    bea_dense.launches += 1
    return out


def run_plan(p: Plan, x, w, a, b, e, mask, scaling: float = 1.0):
    """One launch of ``p`` on checked CUDA operands (:func:`bea_dense`'s
    body; ``chip_smoke.py`` times plans through it, uncounted)."""
    m, k = x.shape
    n, r = w.shape[1], a.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    nbytes = p.workspace_bytes(m, n, r)
    ws = workspace(nbytes, x.device) if nbytes else None
    rc = _launcher()(x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
                     e.data_ptr(), mask.data_ptr(), out.data_ptr(), m, k, n, r,
                     float(scaling), DTYPE_CODE[x.dtype],
                     None if ws is None else ws.data_ptr(), nbytes,
                     p.block_m, p.block_n, p.splits, p.k_slice,
                     p.blocks if p.kernel == "wgmma" else 0,
                     torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "bea_dense")
    return out


bea_dense.launches = 0


class BeaDense(torch.autograd.Function):
    """Differentiable :func:`bea_dense`.

    Backward: ``dX = dY·Wᵀ`` plus the autograd of the recomputed adapter term
    (:func:`~repro_torch.kernels.ref.bea_adapter_ref`), which gives
    ``g = dY·B``, ``dX += s·(g⊙em)·A``, ``dA = s·(g⊙em)ᵀ·X``,
    ``dB = s·dYᵀ·(u⊙em)`` and ``dE = s·Σ_rows(u⊙g)⊙m`` through the same ops,
    so the grads equal the autograd of :func:`bea_dense_ref` bit for bit.
    Recomputing ``u = x·Aᵀ`` costs M·K·r, a rank's worth of the product.
    Where W needs a gradient (SLoRA's full fine-tuning stage), ``dW = Xᵀ·dY``
    is one plain product, as the JAX package takes it under ``jax.grad``
    outside any kernel; the forward stays the kernel.
    """

    @staticmethod
    def forward(ctx, x, w, a, b, e, mask, scaling):
        ctx.save_for_backward(x, w, a, b, e, mask)
        ctx.scaling = scaling
        return bea_dense(x.contiguous(), w.contiguous(), a.contiguous(),
                         b.contiguous(), e.contiguous(), mask.contiguous(),
                         scaling)

    @staticmethod
    def backward(ctx, g):
        x, w, a, b, e, mask = ctx.saved_tensors
        needs = ctx.needs_input_grad
        leaves = {i: t.detach().requires_grad_(needs[i])
                  for i, t in ((0, x), (2, a), (3, b), (4, e))}
        want = [i for i, t in leaves.items() if t.requires_grad]
        out = [None] * 7
        if want:
            with torch.enable_grad():
                term = bea_adapter_ref(leaves[0], leaves[2], leaves[3],
                                       leaves[4], mask, ctx.scaling)
                got = torch.autograd.grad(term, [leaves[i] for i in want], g)
            out_ = dict(zip(want, got))
            out = [out_.get(i) for i in range(7)]
        if needs[0]:
            out[0] = g.mm(w.to(g.dtype).t()) + out[0]
        if needs[1]:
            out[1] = x.t().mm(g).to(w.dtype)
        return tuple(out)


def bea_dense_grouped(x, w, a, b, e, mask, scaling: float = 1.0):
    """C clients' adapted linears on one base in one launch: x (C, M, K);
    w (K, N) shared; a (C, r, K); b (C, N, r); e (C, r) — float32; mask
    (r,) bool, shared.  Returns (C, M, N): client c's slice is
    ``bea_dense(x[c], w, a[c], b[c], e[c], mask)``."""
    if x.device.type == "cpu":
        return bea_dense_grouped_ref(x, w, a, b, e, mask, scaling)
    if x.device.type != "cuda":
        raise ValueError(f"bea_dense_grouped: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"bea_dense_grouped: the grouped instance is float32, "
                        f"got {x.dtype}")
    c, m, k = x.shape
    n, r = w.shape[1], a.shape[1]
    if w.shape != (k, n) or a.shape != (c, r, k) or b.shape != (c, n, r) \
            or e.shape != (c, r) or mask.shape != (r,):
        raise ValueError(
            f"bea_dense_grouped: shapes x{tuple(x.shape)} w{tuple(w.shape)} "
            f"a{tuple(a.shape)} b{tuple(b.shape)} e{tuple(e.shape)} "
            f"mask{tuple(mask.shape)} do not agree")
    if r > MAX_RANK:
        raise ValueError(f"bea_dense_grouped: rank {r} > {MAX_RANK}")
    check_operands("bea_dense_grouped", x, {"x": x, "w": w, "a": a, "b": b},
                   e, mask, x.device)
    out = torch.empty((c, m, n), dtype=x.dtype, device=x.device)
    p = plan(m, k, n, x.dtype, clients=c, rank=r)
    nbytes = p.workspace_bytes(m, n, r, clients=c)
    ws = workspace(nbytes, x.device) if nbytes else None
    rc = _grouped_launcher()(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), e.data_ptr(),
        mask.data_ptr(), out.data_ptr(), c, m, k, n, r, float(scaling),
        None if ws is None else ws.data_ptr(), nbytes, p.block_m, p.block_n,
        p.splits, p.k_slice, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "bea_dense_grouped")
    bea_dense_grouped.launches += 1
    return out


bea_dense_grouped.launches = 0


class BeaDenseGrouped(torch.autograd.Function):
    """Differentiable :func:`bea_dense_grouped`, the backward plain PyTorch
    as :class:`BeaDense`'s: ``dX = dY·Wᵀ`` as one product over all C·M rows
    plus the autograd of the recomputed batched adapter term
    (:func:`~repro_torch.kernels.ref.bea_adapter_grouped_ref`), which gives
    each client's dX term and dA, dB and dE from its own rows only; ``dW``,
    where W needs one, is one product over all rows."""

    @staticmethod
    def forward(ctx, x, w, a, b, e, mask, scaling):
        ctx.save_for_backward(x, w, a, b, e, mask)
        ctx.scaling = scaling
        return bea_dense_grouped(x.contiguous(), w.contiguous(),
                                 a.contiguous(), b.contiguous(),
                                 e.contiguous(), mask.contiguous(), scaling)

    @staticmethod
    def backward(ctx, g):
        x, w, a, b, e, mask = ctx.saved_tensors
        needs = ctx.needs_input_grad
        leaves = {i: t.detach().requires_grad_(needs[i])
                  for i, t in ((0, x), (2, a), (3, b), (4, e))}
        want = [i for i, t in leaves.items() if t.requires_grad]
        out = [None] * 7
        if want:
            with torch.enable_grad():
                term = bea_adapter_grouped_ref(leaves[0], leaves[2],
                                               leaves[3], leaves[4], mask,
                                               ctx.scaling)
                got = torch.autograd.grad(term, [leaves[i] for i in want], g)
            out_ = dict(zip(want, got))
            out = [out_.get(i) for i in range(7)]
        g2 = g.reshape(-1, g.shape[-1])
        if needs[0]:
            out[0] = g2.mm(w.to(g.dtype).t()).view(x.shape) + out[0]
        if needs[1]:
            out[1] = x.reshape(-1, x.shape[-1]).t().mm(g2).to(w.dtype)
        return tuple(out)
