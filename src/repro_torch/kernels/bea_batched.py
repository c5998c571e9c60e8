"""Rank-bucketed multi-tenant masked-BEA linear (reference:
``repro/kernels/bea_batched.py``): row ``i`` attaches adapter ``g = idx[i]``
of G adapters stacked at one bucket rank r,

    y[i] = x[i]·W + s·((x[i]·A_gᵀ) ⊙ (e_g⊙m_g))·B_gᵀ.

On a CUDA tensor :func:`bea_batched` launches the hand-written Hopper kernel
in ``csrc/bea_batched.cu`` (design notes there) or raises; on a CPU tensor
it computes the plain version,
:func:`repro_torch.kernels.ref.bea_batched_ref`.  G = 0 or r = 0 (a fully
pruned bucket) short-circuits to x·W outside the kernel, as the JAX wrapper
does.  Each type runs one launch per call, with no workspace: bfloat16
on the tensor cores under :func:`plan`, float32 on the CUDA cores under
:func:`f32_plan`; both sum their K-splits inside a thread-block cluster.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bea_fused import DTYPE_CODE, MAX_RANK, check_operands
from repro_torch.kernels.ref import bea_batched_ref

SMS = 132                   # streaming multiprocessors of an H100 SXM
TARGET_BLOCKS = 2 * SMS     # what a plan aims for: two blocks per SM
BLOCK_K = 64                # K per pipeline stage of the bf16 kernel
BLOCK_NS = (64, 32, 16)     # column-tile widths, widest first
# ring depth by (rows held, column-tile width): about 32 KB of W per block in
# flight; 3 stages for 64-row, 64-column tiles, so that a wide linear's
# blocks still fit the card in one wave
STAGES = {(8, 64): 4, (8, 32): 6, (8, 16): 8,
          (64, 64): 3, (64, 32): 6, (64, 16): 8}
MAX_CLUSTER = 8             # K-splits of one tile: a portable cluster
M_TILE = 64                 # rows one block holds; more rows take grid z
MAX_STACKED_RANKS = 64      # G·r up to this rides the MMA; above, gathered
PAD = 8                     # bf16 elements of padding per shared row
SMEM_LIMIT = 232_448        # dynamic shared memory a block may use


class Plan(NamedTuple):
    """How a kernel covers one call: column tiles of ``block_n`` ×
    ``splits`` K-slices of ``k_slice`` (the last may be shorter, none is
    empty) × chunks of rows (up to 64 in bf16, ``m_pad`` in f32),
    ``blocks`` in all; the splits of one tile form a thread-block cluster
    that sums them in shared memory."""
    block_n: int
    splits: int
    k_slice: int
    stages: int
    blocks: int
    m_pad: int
    u_tiles: int        # 16-row tiles of the stacked A staged; 0: gathered
    smem_bytes: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def m_pad(m: int) -> int:
    """Rows the block's x tile holds: 8 for a decode group of up to 8 rows,
    else 64 (the 8-row fragments past M are neither loaded nor multiplied)."""
    return 8 if m <= 8 else M_TILE


def u_tiles(gr: int) -> int:
    """16-row tiles the kernel stages for a stack of G·r ranks: 1 or 4 (the
    tiles past G·r are neither loaded nor multiplied), or 0 when the stack
    is gathered row by row instead."""
    if gr > MAX_STACKED_RANKS:
        return 0
    return 1 if gr <= 16 else 4


def smem_bytes(mp: int, u_tiles: int, block_n: int, stages: int,
               splits: int, r: int) -> int:
    """The kernel's dynamic shared memory (``csrc/bea_batched.cu:Tile``): a
    staged stack's B rows of the tile and e⊙mask; what the cluster pushes
    here (every split's u of each row's adapter and partial of the owned
    columns, f32); the cp.async ring (x, W and stacked-A tiles per stage)
    or, reusing it, the block's own f32 u and rounded u⊙em.  At 64 rows the
    pushed areas reuse the ring too."""
    ldk = BLOCK_K + PAD
    stage = mp * ldk + BLOCK_K * (block_n + PAD) + 16 * u_tiles * ldk
    ring = 2 * stage * stages
    local = 4 * (16 * u_tiles * mp + mp * MAX_RANK)
    rec = _cdiv(4 * (splits * mp * r + splits * _cdiv(block_n, splits) * mp),
                16) * 16
    pre = 16 * u_tiles * (2 * block_n + 4)
    if mp == 8:
        return pre + rec + max(ring, local)
    return pre + max(ring, local + rec)


def _tiling(k: int, n: int, block_k, target) -> tuple[int, int, int, int]:
    """(blocks, block_n, splits, K-steps a split) of the widest column tile
    in BLOCK_NS that reaches one block per SM when its K-steps of
    ``block_k(block_n)`` rows are split toward ``target(tiles)`` ways, at
    most MAX_CLUSTER (a portable cluster); if none does, the tiling with
    the most blocks.  K and N alone decide it."""
    tried = []
    for bn in BLOCK_NS:
        steps = max(1, _cdiv(k, block_k(bn)))
        tiles = _cdiv(n, bn)
        want = max(1, min(MAX_CLUSTER, steps, target(tiles)))
        per = _cdiv(steps, want)
        splits = _cdiv(steps, per)
        tried.append((tiles * splits, bn, splits, per))
        if tiles * splits >= SMS:
            return tried[-1]
    return max(tried, key=lambda t: t[0])


@functools.lru_cache(maxsize=4096)
def plan(m: int, k: int, n: int, g: int, r: int) -> Plan:
    """The bf16 kernel's plan for an (M, K) @ (K, N) call over G adapters
    of rank r.

    The tiling depends on K and N only, never on M or the adapters, so a
    row's arithmetic is the same whatever rows are batched with it.  Take
    the widest column tile that reaches one block per SM when its K-steps
    are split toward TARGET_BLOCKS, at most MAX_CLUSTER ways (a portable
    cluster); if none does, the plan with the most blocks.  On the path
    that leaves Qwen2-0.5B's wk/wv (896 × 128) at 56 blocks of 16 columns
    × 2 K-steps: 8 column tiles × 7 splits, since 14 K-steps do not split
    8 ways and a wider cluster may not co-schedule.  Those 56 blocks issue
    all 229 KB of W at once, so more blocks would add cluster barriers, not
    bytes in flight.  M sets the row padding; G·r ≤ MAX_STACKED_RANKS puts
    the stacked A on the tensor cores (``u_tiles`` 16-row tiles), a larger
    stack gathers each row's adapter instead.  The ring keeps at most
    STAGES[m_pad, block_n] stages, no more than the slice has K-steps."""
    blocks, bn, splits, per = _tiling(
        k, n, lambda bn: BLOCK_K, lambda tiles: _cdiv(TARGET_BLOCKS, tiles))
    mp = m_pad(m)
    ut = u_tiles(g * r)
    stages = min(STAGES[mp, bn], per)
    return Plan(bn, splits, per * BLOCK_K, stages,
                blocks * max(1, _cdiv(m, M_TILE)), mp, ut,
                smem_bytes(mp, ut, bn, stages, splits, r))


F32_THREADS = 256           # threads of a float32 block
F32_W_STAGE = 2048          # floats of W a float32 stage holds: 8 KB
F32_STAGES = {0: 8, 1: 8, 4: 4}   # float32 ring depth by u_tiles
# the most float32 blocks a plan aims for: one wave of clusters (BART's fc1
# runs in two waves at 288 and 384 blocks: chip_smoke.py's "plan against
# other waves" line, PERF.md §6)
F32_WAVE_BLOCKS = 192


def f32_block_k(block_n: int) -> int:
    """K-rows of a float32 stage: 8 KB of W whatever the tile's width."""
    return F32_W_STAGE // block_n


def f32_m_pad(m: int) -> int:
    """Rows a float32 chunk holds: 4 for up to 4 rows (BART's decode), else
    8; more rows take further chunks of 8."""
    return 4 if m <= 4 else 8


def f32_smem_bytes(mp: int, u_tiles: int, block_n: int, stages: int,
                   splits: int, r: int) -> int:
    """The float32 kernel's dynamic shared memory (``csrc/bea_batched.cu:
    FTile``): the owned columns' B rows of a staged stack and e⊙mask; what
    the cluster pushes here (every split's u of each row's adapter and
    partial of the owned columns); the cp.async ring (W, x K-major and the
    stacked A rows per stage) or, reusing it, the warps' partials of x·W
    and of u and the rows' u⊙em.  All f32, each area a whole number of
    16-byte words."""
    bk, ap = f32_block_k(block_n), 16 * u_tiles
    cols = _cdiv(block_n, splits)
    pre = _cdiv(ap * (cols + 1), 4) * 4
    rec = _cdiv(splits * mp * (r + cols), 4) * 4
    ring = stages * (bk * block_n + bk * mp + ap * (bk + 4))
    groups = F32_THREADS // ap if ap >= 32 else F32_THREADS // 32
    local = (F32_THREADS // 32) * mp * block_n + groups * mp * ap \
        + mp * MAX_RANK
    return 4 * (pre + rec + max(ring, local))


@functools.lru_cache(maxsize=4096)
def f32_plan(m: int, k: int, n: int, g: int, r: int) -> Plan:
    """The float32 kernel's plan for an (M, K) @ (K, N) call over G
    adapters of rank r: the widest column tile that reaches one block per
    SM when its K-steps are split toward F32_WAVE_BLOCKS blocks (one wave
    of clusters), at most MAX_CLUSTER ways; if none does, the plan with
    the most blocks.  A stage of a tile ``block_n`` wide is
    f32_block_k(block_n) K-rows (8 KB of W).  Every BART-base decode
    linear reaches one block per SM: 768² takes 24 tiles of 32 × 6 splits
    of 128 rows (144 blocks), fc1 48 tiles of 64 × 4 of 192 (192), fc2 24
    tiles of 32 × 8 of 384 (192).  The tiling
    depends on K and N only; M sets the row chunk (``m_pad``), G·r the
    stacked-A tiles (``u_tiles``, 0: gathered) and with them the ring's
    depth (``stages``, F32_STAGES[u_tiles], no more than the slice has
    K-steps)."""
    blocks, bn, splits, per = _tiling(
        k, n, f32_block_k, lambda tiles: F32_WAVE_BLOCKS // tiles)
    mp = f32_m_pad(m)
    ut = u_tiles(g * r)
    stages = min(F32_STAGES[ut], per)
    return Plan(bn, splits, per * f32_block_k(bn), stages,
                blocks * max(1, _cdiv(m, mp)), mp, ut,
                f32_smem_bytes(mp, ut, bn, stages, splits, r))


@functools.cache
def _launcher():
    fn = _build.load("bea_batched").bea_batched_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


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
    p = (plan if x.dtype == torch.bfloat16 else f32_plan)(m, k, n, g, r)
    out = run_plan(p, x, w, a_stack, b_stack, e_stack, m_stack, idx, scaling)
    bea_batched.launches += 1
    return out


def run_plan(p: Plan, x, w, a_stack, b_stack, e_stack, m_stack, idx,
             scaling: float = 1.0):
    """One launch of ``p`` on checked CUDA operands (:func:`bea_batched`'s
    body; ``chip_smoke.py`` times plans through it, uncounted)."""
    m, k = x.shape
    n = w.shape[1]
    g, r = a_stack.shape[:2]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = _launcher()(x.data_ptr(), w.data_ptr(), a_stack.data_ptr(),
                     b_stack.data_ptr(), e_stack.data_ptr(),
                     m_stack.data_ptr(), idx.data_ptr(), out.data_ptr(),
                     m, k, n, g, r, float(scaling), DTYPE_CODE[x.dtype],
                     p.block_n, p.splits, p.k_slice,
                     torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "bea_batched")
    return out


bea_batched.launches = 0
