#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero and prints
no result line:

  1. card      torch / CUDA versions, the card's name and power limit;
  2. build     nvcc builds the three kernels from src/repro_torch/csrc/;
               ptxas registers and spills, and the tensor-core instructions
               (HMMA for mma.sync, HGMMA for wgmma; TF32 the HMMAs of the
               f32 instances), the FFMAs and all instructions of each
               kernel function in the SASS: no library may have no
               tensor-core instruction, every f32 tensor-core instance
               (tf32_kernel) must run TF32 HMMAs, every instance of the
               bf16 wgmma_kernel HGMMAs, every f32 bea_batched instance
               (fma_kernel) FFMAs and no HMMA, and no bf16 instance of
               bea_batched, no fma_kernel, no wgmma_kernel and no f32
               instance may spill (nor may ptxas serialize the
               wgmma_kernel's wgmma or ignore its setmaxnreg);
  3. kernels   each CUDA kernel against its plain PyTorch version on the card
               at the serving path's shapes (bf16 and f32, ragged shapes,
               every rank bucket, window and soft-cap included; bea_batched
               at every path linear for 1 to 64 rows over 1, 2 and 6
               tenants, a row served alone equal to the batched row), and
               at phase 11's LM training shapes (bf16 bea_dense on its
               wgmma instance at every Qwen2 linear: 4096 rows at ranks 1,
               4, 8 and 64, 512, 4000 and 4097 rows, fully masked; K, N or
               x not 16-byte aligned on mma_kernel; bf16 causal GQA flash
               on its wgmma body at 8 × 512, S = 500 / 513, non-causal,
               Sq ≠ Sk, window with soft-cap, head dim 128, bit for bit
               mma_kernel's without a soft-cap, and a strided view on
               mma_kernel, each printing its plan; Gemma's: bf16
               bea_dense at each Gemma2-2B and Gemma3-1B linear (4096
               rows), flash at head dim 256 on wgmma_kernel<256, 2>
               (Gemma2's call, a binding window with soft-cap 50, Gemma3's
               local and global calls, bit for bit mma_kernel<256> without
               a soft-cap) and on mma_kernel<256> (20 query rows, a
               strided view); Zamba2-1.2B's: bf16 bea_dense at its five
               linear shapes (in_proj's N = 8384 leaves a ragged last
               column tile), its shared block's MHA flash call (window 4096,
               which does not bind at 512) and its SMOKE's f32 flash at
               head dim 32 under a binding window of 16; f32 flash at
               BART's: causal, non-causal, cross-attention with Sq ≠ Sk,
               ragged); the
               tensor-core kernels (bf16, and f32 bea_dense and flash)
               called twice and replayed from a CUDA graph must give the
               same bits; then times beside the
               roofline bound and a library call: bea_dense per linear
               (with its tiling plan) and per layer at M = 64 and 128,
               bea_batched per linear (with its plan, and x @ w alone) and
               per layer at M = 1, 4, 8 and 64; then the static-batch
               loop's and InternVL2-1B's cases (``legacy_kernels``): bf16
               bea_dense at InternVL2's 7 linears at 6,144, 1,536 and 384
               rows, bf16 causal GQA flash (14 q / 2 kv heads of 64) at 8 ×
               768, 4 × 384 and 4 × 356, the f32 bea_batched (fma_kernel,
               one launch) at BART-base's decode linears (M = 4, G = 1, r =
               12, its plan printed, its bias against float64 within
               F32_BIAS_TOL, no scratch buffer drawn), each against plain,
               repeatable, graph-safe and timed;
  4. serve     full-width Qwen2-0.5B (24 layers, random weights from a seed)
               serves 8 requests through 4 slots with two tenants at ranks 4
               and 8; every kernel's launch counter must rise in this run;
     profile   torch.profiler over a short serving run and over a decode
               loop: the card's idle share, host vs device ms per step;
  5. path      4 rows over 2 tenants of one rank bucket: full-width prefills
               + 3 batched decode steps through the kernels and through the
               plain versions on the same weights, with the adapters' share
               of the logits shown to exceed the tolerance;
 5b. legacy    the static-batch loop (``launch/serve.py``'s
               ``legacy_static_batch``, the serving path of vision and
               encoder-decoder models) at full width: InternVL2-1B (bf16,
               4 requests of 256 patch rows + 128 tokens) and BART-base
               (f32, 4 requests of 128 tokens over a 256-token source), 16
               new tokens each, through the kernels (the counts zeroed
               just before, read just after) and, teacher-forced on their
               tokens, through the plain versions on the same weights:
               prefill's and every decode step's logits within BF16_TOL /
               F32_TOL per row, the adapters' share at least twice that,
               exactly 168 / 48 bea_batched launches a decode step and no
               flash; prefill and a decode step timed (CUDA events, host
               wall, profiler), the decode step's profile holding exactly
               one bea_batched kernel function a call (mma_kernel / f32
               fma_kernel) and its share of the busy time;
  6. train     full-width DistilBERT-base (6 layers, random weights from a
               seed), the training path: the f32 ``bea_dense`` and
               non-causal flash instances at its shapes against their plain
               versions, and their times beside the bound (3xTF32, and the
               CUDA cores' as well), the plain version and a library call;
               one training step (8 × 128
               tokens) through the kernels and through the plain versions
               (loss, every grad, launches per forward); then a 3-round
               FedARA run over 10 clients, through the kernels (the counts
               zeroed just before it and read just after) and through the
               plain versions from the same weights, which must agree per
               round in bytes, live ranks and dead modules exactly and in
               loss, with every forward of the kernel run (training steps
               and eval batches, counted per round) launching both kernels
               once per layer; its peak memory alone (the serving engine
               freed first); one step timed on the card, on the host clock
               and under the profiler;
  7. baselines full-width BERT-base (6 of its 12 layers, random weights
               from a seed),
               the paper's baselines: FedLoRA, FedAdapter-H/P, SLoRA (one
               stage-1 round of sparse full fine-tuning, its base trained
               through ``bea_dense``, then 2 LoRA rounds), FeDeRA, FFA-LoRA,
               FFA-LoRA-dr and FedSVD, each 2 rounds of 2 clients × 2 local
               steps of 8 × 128 tokens, run through the kernels (the counts
               zeroed just before, read just after) and through the plain
               versions from the same weights: per round bytes, trainable
               counts and the simulated clock equal, losses within the
               phase-6 tolerance, final accuracy within one eval sample,
               SLoRA's stage-1 stats equal; per forward 72 ``bea_dense``
               (0 for FedAdapter-H/P, whose base linears carry no adapter)
               and 12 flash launches; FFA-LoRA's A bitwise frozen; FeDeRA's
               W' + s·(B·A)ᵀ within 1e-3 / 1e-4 of W; one stage-1 step
               kernels vs plain (loss and every base grad, phase 6's step
               gates); a FedLoRA step and a stage-1 step timed on the card,
               on the host clock and under the profiler; the phase's peak
               memory;
  8. wire      full-width DistilBERT-base over the compressed and private
               wire, phase 6's data and partition with 3 clients a round
               and 3 rounds: FedARA under PowerSGD (rank 2), int8 and
               top-k, then under signSGD with secure aggregation, the DP
               clip (1/200 of the smallest update norm those three runs
               show, so every update clips) and noise (z = 1), then
               SLoRA with signSGD and the clip (half that norm) in both
               stages (its plain run inits LoRA from the kernel run's
               stage-1 aggregate, and the two aggregates are compared entry
               by entry: see ``WIRE_RUNS``); each through
               the kernels (the counts zeroed just before, read just after)
               and through the plain versions from the same weights: per
               round bytes, live ranks, dead modules and the simulated
               clock equal, every secagg round's entry, the ε trajectory,
               the clip flags and SLoRA's stage-1 stats equal, losses
               within the phase-6 tolerance, final accuracy within one
               eval sample; every upload's bytes its codec's formula at its
               wire length; every secagg round's masked field sum decodes
               to the plain field sum of the same payloads, bit for bit;
               the host seconds of each wire stage per round;
  9. fedsim    full-width DistilBERT-base through the cohort, async and
               fused runners, phase 6's data (and, for the fused runs, an
               IID split of it: the fused path takes no client smaller
               than a batch): (a) the client-grouped f32 ``bea_dense``
               against its plain version at a layer's 6 linears (C = 3 of
               1024 rows, 3 of 800, 1 of 1024; a mask with ranks off),
               repeatable and graph-safe, timed per layer beside its bound,
               its plain version, the library form over the C·M rows and C
               separate calls; (b) one cohort step of 3 clients, kernels vs
               the plain cohort step and vs 3 single-client steps; (c) a
               3-round FedARA cohort run (3 clients × 4 steps) through the
               kernels (the counts zeroed just before, read just after: the
               grouped instance once per adapted linear of every cohort
               forward) vs plain, and vs the seq runner; (d) FedLoRA with
               dropout and stragglers stretches the clock; (e) two async
               runs give the same events and losses bit for bit, with some
               staleness; (f) 8 fused FedLoRA rounds (blocks of 4 replays
               of one captured round) vs the eager cohort; (g) bf16 and
               int8 Adam moments vs f32, and ``state_nbytes``; (h) round
               walls under seq, cohort and fused, the profiler's busy time,
               launches and idle share of a seq step, a cohort step and a
               graph replay of a round, the phase's peak memory;
 10. obs       ``repro_torch.obs`` over full-width runs, phase 9's model,
               data and partitions: (a) the reference's trace-parity
               setting (FedARA cohort, 3 clients × 4 steps, 3 rounds,
               signSGD under secure aggregation, dropout 0.3) traced to a
               JSONL with the live plane up (the counts zeroed just before,
               read just after) and untraced, both under the sync debug
               mode: ``check`` clean, ``summarize`` equal to the history
               exactly (bytes, clock, secagg phase and recovery bytes,
               final accuracy), the rank trajectory the history's, the live
               monitor's alerts the offline scan's and none that says the
               run is broken, a ``memory`` event per round within the
               allocator's peak, no kernel build, traced and untraced
               histories equal bit for bit, at most one more synchronizing
               operation traced (the close's pull), ``/metrics`` and
               ``/healthz`` served; (b) FedLoRA eager and fused (8 rounds,
               blocks of 4) traced: one ``graph_capture`` span, in round
               0's block, summaries equal; (c) phase 4's serving run
               traced: a step span per step, finite p50 ≤ p95 ≤ p99
               latencies, the scheduler and token counters; (d) round walls
               untraced and traced, in turns;
 11. lm        causal-LM fine-tuning (``launch/train.py`` over
               ``Model.lm_loss``) at full width: (a) Qwen2-0.5B in bf16
               (RoPE, causal GQA flash) at 8 × 512 tokens, and InternVL2-1B
               in bf16 at 8 × 512 behind 256 patch rows, (b) BART-base in
               f32 (encoder, causal decoder, cross-attention) at 8 × 256,
               (c) Gemma2-2B in bf16 (head dim 256, window 4096, soft-caps
               50 and 30, post-block norms, GeGLU) at 8 × 512 and Gemma3-1B
               in bf16 (head dim 256, window 512 on 22 of 26 layers) at 4 ×
               1024, Granite-3.0-1B-A400M (MoE) at 8 × 512, MiniCPM-2B
               (40 layers, MHA 36 / 36 heads), Mamba2-780M (48 SSD
               layers, no attention) and Zamba2-1.2B (32 SSD layers, one
               shared attention block at 6 positions) in bf16 at 8 × 512:
               each one step through the kernels and through the plain
               versions from the same weights (loss and every adapter
               grad; exactly 168 / 24 (Qwen2, InternVL2), 96 / 18, 182 /
               26, 182 / 26, 96 /
               24, 280 / 40, 96 / 0 and 106 / 6 ``bea_dense`` / flash
               launches per forward; BART's encoder 128 tokens longer than
               its decoder; InternVL2's, MiniCPM's, Mamba2's and Zamba2's
               bf16 grads held to the f32 step no farther than their plain bf16 step's own distance allows,
               and at the perturbed state once more in f32, kernels vs
               plain),
               the step timed and profiled (device, host, busy, idle,
               tokens/s, peak memory), then ``train.py``'s ``main`` for 20
               steps through the kernels (the counts zeroed just before,
               read just after) and the same loop through the plain
               versions, each step within 1e-2 (bf16) or 1e-3 (f32) of
               plain, each run's held-out loss below its initial
               adapters' and its last 5 steps' mean below its first 5's;
               then one SMOKE step each of Kimi-K2, MiniCPM-2B (f32 flash
               at head dim 36), Mamba2-780M and Zamba2-1.2B (window 16
               binding) at phase 6's f32 gates;
               Mamba2-780M's ``ssd_chunked`` at one full-width layer (S =
               512, chunk 256, 48 heads of 64, state 128, f32) finite and
               within 1e-4 of a float64 sequential recurrence;
               (d) the LM kernel instances (bf16 ``bea_dense`` at M = 4096
               for a Qwen2, a Gemma2, a Gemma3, a Granite, a MiniCPM and a
               Mamba2 layer and Zamba2's 9 linears, MiniCPM's and Zamba2's
               MHA flash calls, f32 flash at head
               dim 36, bf16 causal GQA
               flash at B = 8, S = 512, flash at head dim 256 at Gemma2's
               and Gemma3's local and global calls and at 20 query rows on
               mma_kernel<256>, f32 cross flash at Sq = 256 over Sk = 384)
               timed beside the bound, the plain version and the library
               call (for flash: SDPA, and under a soft-cap or a binding
               window ``flex_attention`` compiled by ``torch.compile``,
               checked against the kernel), each bea_dense linear with its
               plan's kernel and tile, the flash call with its plan and
               share of bound; the
               sweep behind bea_dense's wgmma plan
               rule (M = 512, 1024, 4096: the plan, the mma.sync plan, one
               block per tile, K split 1, 2 and 4, addmm) and behind
               flash's (B = 1 and 8, S = 32 to 512: the plan, the wgmma
               plan, mma_kernel, SDPA; at S = 512 2, 3 and 4 consumer
               warpgroups walking or one block per tile, 128-key tiles,
               the kv heads repeated); the host µs of
               a bea_dense call and of its backward against the plain
               path's; their checks against the plain versions (ragged Sq
               ≠ Sk included) run with phase 3's;
 12. summary   the ``kernels`` line (each row with its training-path
               numbers under ``train``, phase 5b's launches and phase 3's
               InternVL2 / BART timings under ``legacy`` (bea_batched's
               f32 instance there), phase 7's launches under
               ``baselines``, phase 8's under ``wire``, phase 9's under
               ``fedsim``, phase 10's under ``obs`` and phase 11's launches
               and timings under ``lm``; the grouped instance a row of its
               own, and so the head-dim-256 and head-dim-36 flash
               instances), the nvidia-smi line, then the last line
               ``{"ok": true, "device": {...}}``.

Without CUDA, or without the rest of the repository beside it, it exits
with a non-zero code before printing any result.
"""

from __future__ import annotations

import gc
import json
import math
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent

PEAK_BYTES_S = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet
# dense peaks, NVIDIA data sheet: bf16 tensor cores; f32 as 3xTF32 (three
# TF32 MMAs per product, 495 TFLOP/s each); f32 FMAs on the CUDA cores
PEAK_FLOP_S = {"bfloat16": 989e12, "float32": 495e12 / 3,
               "cuda_core_f32": 67e12}
OPS_BOUND = {"bfloat16": "operations", "float32": "3xtf32 operations",
             "cuda_core_f32": "operations"}
BF16_TOL = 2e-2              # kernel vs plain, relative to max |plain|, bf16 inputs
F32_TOL = 1e-4               # the same in float32 (summation order only)
F32_BIAS_TOL = 1e-6          # f32 output's relative bias against float64
# the f32 bea_batched's instances: 4- or 8-row chunks × stacked-A tiles
# 0 / 1 / 4 × column tiles 64 / 32 / 16
F32_BATCHED_INSTANCES = 18
PATH_TOL = 3e-2              # whole-path logits, see phase 5
E_SCALE = 10.0               # phase 5 tenants' E over make_tenants' draw
ADAPTER_SHARE_MIN = 2 * PATH_TOL   # adapters' least share of the logits
DECODE_STEPS = 10            # decode steps in the profiled decode loop
SEED = 0
DEV = "cuda"
# Gemma2-2B's and Gemma3-1B's linears (K, N): q, k/v, o, gate/up, down
GEMMA_KN = [(2304, 2048), (2304, 1024), (2048, 2304), (2304, 9216),
            (9216, 2304), (1152, 1024), (1152, 256), (1024, 1152),
            (1152, 6912), (6912, 1152)]
# Granite-3.0-1B-A400M's adapted attention linears (K, N); its expert FFN
# and router are batched products, not bea_dense
GRANITE_KN = {"wq": (1024, 1024), "wk": (1024, 512), "wv": (1024, 512),
              "wo": (1024, 1024)}
# MiniCPM-2B's adapted linears (K, N): q/k/v/o (MHA: all 2304 wide),
# gate/up, down; Mamba2-780M's in_proj (N = 2·3072 + 2·128 + 48 = 6448,
# not a multiple of wgmma_kernel's 128-column tile) and out_proj
MINICPM_KN = [(2304, 2304), (2304, 5760), (5760, 2304)]
MAMBA2_KN = {"in_proj": (1536, 6448), "out_proj": (3072, 1536)}
# Zamba2-1.2B's adapted linears (K, N): a mamba layer's in_proj (N = 2·4096
# + 2·64 + 64 = 8384, 64 past a multiple of 128 or 256: a ragged last
# column tile) and out_proj;
# the shared block's q/k/v/o (MHA: all 2048 wide), gate/up and down
ZAMBA2_KN = {"in_proj": (2048, 8384), "out_proj": (4096, 2048),
             "wq/wk/wv/wo": (2048, 2048), "w1/w3": (2048, 8192),
             "w2": (8192, 2048)}
# f32 flash at head dim 36 (MiniCPM-2B's SMOKE, 4 heads; tf32_kernel on a
# tile padded to 40): (B, Sq, Sk, q heads, kv heads, causal)
HD36_FLASH = [(8, 512, 512, 4, 4, True),       # the SMOKE step's call
              (2, 128, 128, 4, 4, False),
              (2, 96, 160, 4, 4, False),        # Sq != Sk
              (2, 100, 100, 4, 4, True),        # a ragged last tile
              (2, 128, 128, 4, 2, True),        # GQA 4/2
              (1, 20, 20, 4, 4, True)]          # under 32 query rows
# flash at head dim 256, causal, bf16: (B, S, q heads, kv heads, window, cap)
GEMMA_FLASH = [(8, 512, 8, 4, 4096, 50.0),     # Gemma2-2B's training call
               (2, 1024, 8, 4, 256, 50.0),     # a window that binds, cap 50
               (4, 1024, 4, 1, 512, 0.0),      # Gemma3-1B's local layers
               (4, 1024, 4, 1, 0, 0.0),        # Gemma3-1B's global layers
               (1, 20, 4, 1, 16, 50.0)]        # short: mma_kernel<256>
# InternVL2-1B (the static-batch loop and its LM step): bea_dense rows (a
# training step's 8 × (512 + 256), a prefill's 4 × (128 + 256) and one
# request's 128 + 256) and its causal GQA flash calls (B, S: the training
# call, the prefill call, a prefill of 100-token prompts)
INTERNVL2_ROWS = (6144, 1536, 384)
INTERNVL2_FLASH = [(8, 768), (4, 384), (4, 356)]
# BART-base's decode linears (K, N) through the f32 bea_batched (M = 4 rows
# of one adapter, r = 12): self q/k/v/o and cross q/o, fc1, fc2; one
# decoder layer's 8 in order
BART_DECODE_KN = {"q/k/v/o": (768, 768), "fc1": (768, 3072),
                  "fc2": (3072, 768)}
BART_DECODE_LAYER = [(768, 768)] * 6 + [(768, 3072), (3072, 768)]
STARTED = None               # main()'s start on the host clock


def emit(obj) -> None:
    """One JSON line; a phase's line carries the seconds since the start."""
    if STARTED is not None and "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - STARTED}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def time_ms(torch, fn, iters: int = 20, warmup: int = 3,
            graph: bool = True) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, from CUDA events.

    With ``graph`` the calls are captured once into a CUDA graph and the
    graph is replayed, so the host's launch overhead drops out and the
    number is the card's own time; without it (for code that syncs with the
    host, like the per-row plain batched version) the eager loop is timed,
    host overhead included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        g.replay()
        torch.cuda.synchronize()
        run = g.replay
    else:
        run = fn
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """The least time of the work on the card: bytes over the memory rate
    or flops over ``dtype``'s peak, whichever is longer, and which."""
    tb = nbytes / PEAK_BYTES_S * 1e3
    tf = flops / PEAK_FLOP_S[dtype] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, OPS_BOUND[dtype])


def f32_bounds(nbytes: float, flops: float) -> dict:
    """The f32 bound as 3xTF32 (the kernels' arithmetic) and, beside it, as
    f32 FMAs on the CUDA cores."""
    b_ms, b_by = bound_ms(nbytes, flops, "float32")
    return {"bound_ms": b_ms, "bound_by": b_by,
            "bound_cuda_core_ms": bound_ms(nbytes, flops, "cuda_core_f32")[0]}


def short_name(mangled: str, demangle: str | None) -> str:
    """``tf32_kernel<64, 64, 16>`` for a mangled kernel name: the demangled
    name without its return type, namespace and parameter list."""
    out = subprocess.run([demangle, mangled], capture_output=True, text=True,
                         timeout=60).stdout.strip() if demangle else ""
    if not out or out == mangled:
        return mangled
    out = re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::|"
                 r"\((?:int|unsigned int|bool)\)", "", out)   # <(int)64>
    depth = 0
    for i, c in enumerate(out):                 # cut at the parameter list
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0:
            return out[:i]
    return out


def sass_counts(build) -> dict:
    """Per kernel function of each built library: its HMMA (mma.sync),
    HGMMA (wgmma), TF32 HMMA and FFMA (f32 FMAs on the CUDA cores)
    instructions and all its instructions, from ``cuobjdump
    --dump-sass``."""
    tool = str(Path(build.nvcc_path()).with_name("cuobjdump"))
    filt = Path(build.nvcc_path()).with_name("cu++filt")
    filt = str(filt) if filt.is_file() else None
    counts = {}
    for name in build.SOURCES:
        out = subprocess.run([tool, "--dump-sass", str(build.target(name))],
                             capture_output=True, text=True, timeout=300,
                             check=True).stdout
        funcs, cur = {}, None
        for ln in out.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                cur = funcs.setdefault(short_name(m.group(1), filt), {
                    "HMMA": 0, "HGMMA": 0, "TF32": 0, "FFMA": 0,
                    "instructions": 0})
                continue
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                          ln)
            if cur is None or not m:
                continue
            op = m.group(1)
            cur["instructions"] += 1
            base = op.split(".")[0]
            if base in ("HMMA", "HGMMA"):
                cur[base] += 1
                cur["TF32"] += ".TF32" in op
            cur["FFMA"] += base == "FFMA"
        counts[name] = funcs
    return counts


def spills(log: str, kind: str) -> dict:
    """Spill bytes (stores + loads) of every kernel instance whose mangled
    name holds ``kind`` (``mma_kernel`` for bf16, ``tf32_kernel`` or
    ``fma_kernel`` for f32) in a ``ptxas -v`` log, by mangled name."""
    found, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", ln)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and entry and kind in entry:
            found[entry] = int(m.group(1)) + int(m.group(2))
    return found


def rel_err(got, want) -> tuple[float, float]:
    err = (got.float() - want.float()).abs().max().item()
    scale = max(want.float().abs().max().item(), 1e-30)
    return err, err / scale


# --------------------------------------------------------------- phase 3 ----

def check_kernels(torch, cfg):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.bea_batched import bea_batched
    from repro_torch.kernels.bea_batched import plan as bplan
    from repro_torch.kernels.bea_fused import bea_dense, plan
    from repro_torch.kernels.flash_attention import mha_flash
    from repro_torch.kernels.flash_attention import Plan as FPlan
    from repro_torch.kernels.flash_attention import plan as fplan
    from repro_torch.kernels.flash_attention import tma_aligned

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def mask(*shape):
        return torch.rand(shape, generator=gen, device=dev) > 0.3

    d, f = cfg.d_model, cfg.d_ff
    kv_d = cfg.n_kv_heads * cfg.head_dim
    layer_kn = {"wq": (d, d), "wk": (d, kv_d), "wv": (d, kv_d), "wo": (d, d),
                "w1": (d, f), "w3": (d, f), "w2": (f, d)}
    worst = {}

    def record(name, err, rel, tol):
        if rel > tol:
            raise AssertionError(f"{name}: relative error {rel} > {tol}")
        w = worst.setdefault(name, [0.0, 0.0])
        w[0], w[1] = max(w[0], err), max(w[1], rel)

    # ---- bea_dense ---------------------------------------------------------
    def dense_operands(m, k, n, r, dt):
        x, w = rnd(m, k, dtype=dt), rnd(k, n, scale=k ** -0.5, dtype=dt)
        a, b = rnd(r, k, scale=k ** -0.5, dtype=dt), rnd(n, r, dtype=dt)
        e, mk = rnd(r), mask(r)
        mk[0] = True                    # at least one live rank
        return x, w, a, b, e, mk

    def dense_case(m, k, n, r, dt):
        ops = dense_operands(m, k, n, r, dt)
        got = bea_dense(*ops, 2.0)
        want = ref.bea_dense_ref(*(t.float() if t.dtype == dt else t
                                   for t in ops), 2.0)
        tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        err, rel = rel_err(got, want)
        record("bea_dense", err, rel, tol)
        return err, rel, tol

    # bf16 runs on the tensor cores under the host plan: every path linear
    # at the prefill chunk sizes, a ragged chunk and one row, every bucket
    for k, n in sorted(set(layer_kn.values())):
        errs = [dense_case(m, k, n, r, torch.bfloat16)
                for m in (128, 64, 100, 1) for r in (1, 4, 8, 64)]
        emit({"phase": "kernels", "kernel": "bea_dense", "dtype": "bfloat16",
              "k": k, "n": n, "m": [128, 64, 100, 1], "r": [1, 4, 8, 64],
              "plans": {m: plan(m, k, n)._asdict() for m in (128, 64, 100, 1)},
              "max_abs_err": max(e[0] for e in errs),
              "rel_err": max(e[1] for e in errs), "tol": BF16_TOL})
    for m, k, n, r, dt in [(33, 48, 65, 3, torch.float32),
                           (100, 96, 80, 8, torch.float32),
                           (128, d, f, 8, torch.float32),
                           (1, 30, 5, 1, torch.float32),
                           (33, 48, 65, 3, torch.bfloat16),
                           (1, 30, 5, 1, torch.bfloat16),
                           (7, d, d, 64, torch.bfloat16)]:
        err, rel, tol = dense_case(m, k, n, r, dt)
        emit({"phase": "kernels", "kernel": "bea_dense", "m": m, "k": k,
              "n": n, "r": r, "dtype": str(dt).split(".")[1],
              "max_abs_err": err, "rel_err": rel, "tol": tol})
    x, w = rnd(64, d, dtype=torch.bfloat16), rnd(d, d, dtype=torch.bfloat16)
    a, b = rnd(8, d, dtype=torch.bfloat16), rnd(d, 8, dtype=torch.bfloat16)
    got = bea_dense(x, w, a, b, rnd(8), torch.zeros(8, dtype=torch.bool,
                                                    device=dev), 3.0)
    err, rel = rel_err(got, x.float() @ w.float())
    record("bea_dense", err, rel, BF16_TOL)
    emit({"phase": "kernels", "kernel": "bea_dense", "case": "fully masked",
          "max_abs_err": err, "rel_err": rel, "tol": BF16_TOL})
    # LM training (phase 11): a Qwen2 step's 8 × 512 rows, every linear,
    # on the wgmma instance: every rank bucket, ragged and short row counts,
    # fully masked (x·W alone), then shapes it must leave to mma_kernel
    for k, n in sorted(set(layer_kn.values())):
        for m, r in [(4096, 1), (4096, 4), (4096, 8), (4096, 64), (512, 8),
                     (4000, 8), (4097, 8)]:
            p = plan(m, k, n, rank=r)
            if p.kernel != "wgmma":
                raise AssertionError(f"bea_dense {m}x{k}x{n}: plan {p}")
            err, rel, tol = dense_case(m, k, n, r, torch.bfloat16)
            emit({"phase": "kernels", "kernel": "bea_dense", "m": m, "k": k,
                  "n": n, "r": r, "dtype": "bfloat16", "plan": p._asdict(),
                  "max_abs_err": err, "rel_err": rel, "tol": tol})
        x, w, a, b, e, _ = dense_operands(4096, k, n, 8, torch.bfloat16)
        got = bea_dense(x, w, a, b, e, torch.zeros(8, dtype=torch.bool,
                                                   device=dev), 3.0)
        err, rel = rel_err(got, x.float() @ w.float())
        record("bea_dense", err, rel, BF16_TOL)
        emit({"phase": "kernels", "kernel": "bea_dense", "m": 4096, "k": k,
              "n": n, "case": "fully masked, wgmma", "max_abs_err": err,
              "rel_err": rel, "tol": BF16_TOL})
    # Gemma2-2B's and Gemma3-1B's linears at 4096 rows (8 × 512 and 4 ×
    # 1024 tokens) on the wgmma instance
    for k, n in GEMMA_KN:
        p = plan(4096, k, n, rank=8)
        if p.kernel != "wgmma":
            raise AssertionError(f"bea_dense 4096x{k}x{n}: plan {p}")
        errs = [dense_case(4096, k, n, r, torch.bfloat16) for r in (1, 8)]
        emit({"phase": "kernels", "kernel": "bea_dense", "m": 4096, "k": k,
              "n": n, "r": [1, 8], "dtype": "bfloat16", "case": "Gemma",
              "plan": p._asdict(), "max_abs_err": max(e[0] for e in errs),
              "rel_err": max(e[1] for e in errs), "tol": BF16_TOL})
    # Granite-3.0-1B-A400M's attention linears at 4096 rows (8 × 512
    # tokens), r = 8, on the wgmma instance
    for name, (k, n) in GRANITE_KN.items():
        p = plan(4096, k, n, rank=8)
        if p.kernel != "wgmma":
            raise AssertionError(f"bea_dense 4096x{k}x{n}: plan {p}")
        err, rel, tol = dense_case(4096, k, n, 8, torch.bfloat16)
        emit({"phase": "kernels", "kernel": "bea_dense", "m": 4096, "k": k,
              "n": n, "r": 8, "dtype": "bfloat16", "case": f"Granite {name}",
              "plan": p._asdict(), "max_abs_err": err, "rel_err": rel,
              "tol": tol})
    # MiniCPM-2B's and Mamba2-780M's linears at 4096 rows (8 × 512
    # tokens) on the wgmma instance, ranks 1 and 8 (Mamba2's in_proj ends
    # in a 48-column tile), and Mamba2 SMOKE's f32 linears (4 × 48 rows)
    for (k, n), case in ([(kn, "MiniCPM") for kn in MINICPM_KN]
                         + [(kn, f"Mamba2 {name}")
                            for name, kn in MAMBA2_KN.items()]):
        p = plan(4096, k, n, rank=8)
        if p.kernel != "wgmma":
            raise AssertionError(f"bea_dense 4096x{k}x{n}: plan {p}")
        errs = [dense_case(4096, k, n, r, torch.bfloat16) for r in (1, 8)]
        emit({"phase": "kernels", "kernel": "bea_dense", "m": 4096, "k": k,
              "n": n, "r": [1, 8], "dtype": "bfloat16", "case": case,
              "plan": p._asdict(), "max_abs_err": max(e[0] for e in errs),
              "rel_err": max(e[1] for e in errs), "tol": BF16_TOL})
    # Zamba2-1.2B's linears at 4096 rows (8 × 512 tokens) on the wgmma
    # instance, ranks 1 and 8 (in_proj's last column tile is ragged)
    for name, (k, n) in ZAMBA2_KN.items():
        p = plan(4096, k, n, rank=8)
        if p.kernel != "wgmma":
            raise AssertionError(f"bea_dense 4096x{k}x{n}: plan {p}")
        errs = [dense_case(4096, k, n, r, torch.bfloat16) for r in (1, 8)]
        emit({"phase": "kernels", "kernel": "bea_dense", "m": 4096, "k": k,
              "n": n, "r": [1, 8], "dtype": "bfloat16",
              "case": f"Zamba2 {name}", "plan": p._asdict(),
              "max_abs_err": max(e[0] for e in errs),
              "rel_err": max(e[1] for e in errs), "tol": BF16_TOL})
    for m, k, n in ((192, 128, 552), (192, 256, 128)):
        err, rel, tol = dense_case(m, k, n, 4, torch.float32)
        emit({"phase": "kernels", "kernel": "bea_dense", "m": m, "k": k,
              "n": n, "r": 4, "dtype": "float32", "case": "Mamba2 SMOKE",
              "max_abs_err": err, "rel_err": rel, "tol": tol})
    for m, k, n, shift in [(4096, 900, 896, 0), (4096, 896, 900, 0),
                           (4096, 896, 896, 1)]:
        x, w, a, b, e, mk = dense_operands(m, k, n, 8, torch.bfloat16)
        if shift:               # x one element past a 16-byte boundary
            x = torch.empty(m * k + 8, dtype=x.dtype, device=dev)[
                shift:shift + m * k].view(m, k).copy_(x)
        p = plan(m, k, n, rank=8, aligned=x.data_ptr() % 16 == 0)
        if p.kernel != "mma":
            raise AssertionError(f"bea_dense {m}x{k}x{n}+{shift}: plan {p}")
        got = bea_dense(x, w, a, b, e, mk, 2.0)
        err, rel = rel_err(got, ref.bea_dense_ref(
            x.float(), w.float(), a.float(), b.float(), e, mk, 2.0))
        record("bea_dense", err, rel, BF16_TOL)
        emit({"phase": "kernels", "kernel": "bea_dense", "m": m, "k": k,
              "n": n, "r": 8, "x_offset_elems": shift,
              "case": "not TMA-aligned: mma_kernel", "plan": p._asdict(),
              "max_abs_err": err, "rel_err": rel, "tol": BF16_TOL})

    # ---- bea_batched -------------------------------------------------------
    bcases = [(m, k, n, g, r, torch.bfloat16) for (k, n) in
              set(layer_kn.values()) for (m, g, r) in ((4, 2, 8), (3, 1, 4))]
    bcases += [(13, d, f, 3, 8, torch.bfloat16), (1, d, d, 1, 64, torch.bfloat16),
               (8, 16, 8, 2, 4, torch.float32), (33, 48, 65, 4, 8, torch.float32),
               (5, 24, 40, 6, 8, torch.float32), (12, 30, 20, 3, 4, torch.float32)]
    for m, k, n, g, r, dt in bcases:
        x, w = rnd(m, k, dtype=dt), rnd(k, n, scale=k ** -0.5, dtype=dt)
        a, b = rnd(g, r, k, scale=k ** -0.5, dtype=dt), rnd(g, n, r, dtype=dt)
        e, mk = rnd(g, r), mask(g, r)
        if g >= 2:
            mk[1] = False                               # a fully pruned tenant
        idx = torch.randint(0, g, (m,), generator=gen, device=dev,
                            dtype=torch.int32)
        got = bea_batched(x, w, a, b, e, mk, idx, 1.5)
        want = ref.bea_batched_ref(x.float(), w.float(), a.float(), b.float(),
                                   e, mk, idx, 1.5)
        tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        err, rel = rel_err(got, want)
        record("bea_batched", err, rel, tol)
        emit({"phase": "kernels", "kernel": "bea_batched", "m": m, "k": k,
              "n": n, "g": g, "r": r, "dtype": str(dt).split(".")[1],
              "max_abs_err": err, "rel_err": rel, "tol": tol})
    # bf16 in one launch under the host plan: every path linear, every row
    # count up to 64, 1, 2 and 6 tenants at ranks 1 to 64 (G·r past 64
    # gathers each row's adapter); rows served alone equal batched rows
    def batched_operands(m, k, n, g, r, dt):
        x, w = rnd(m, k, dtype=dt), rnd(k, n, scale=k ** -0.5, dtype=dt)
        a, b = rnd(g, r, k, scale=k ** -0.5, dtype=dt), rnd(g, n, r, dtype=dt)
        e, mk = rnd(g, r), mask(g, r)
        mk[:, 0] = True
        idx = torch.randint(0, g, (m,), generator=gen, device=dev,
                            dtype=torch.int32)
        return x, w, a, b, e, mk, idx

    ms, grs = (1, 4, 8, 13, 64), [(g, r) for g in (1, 2, 6)
                                  for r in (1, 4, 8, 64)]
    for k, n in sorted(set(layer_kn.values())):
        errs, solo_equal = [], True
        for m in ms:
            for g, r in grs:
                ops = batched_operands(m, k, n, g, r, torch.bfloat16)
                got = bea_batched(*ops, 1.5)
                want = ref.bea_batched_ref(*(t.float() if t.dtype ==
                                             torch.bfloat16 else t
                                             for t in ops), 1.5)
                err, rel = rel_err(got, want)
                record("bea_batched", err, rel, BF16_TOL)
                errs.append((err, rel))
                i = m - 1
                solo = bea_batched(ops[0][i:i + 1].contiguous(), *ops[1:6],
                                   ops[6][i:i + 1].contiguous(), 1.5)
                solo_equal &= bool(torch.equal(solo, got[i:i + 1]))
        emit({"phase": "kernels", "kernel": "bea_batched", "dtype": "bfloat16",
              "k": k, "n": n, "m": list(ms), "g_r": grs,
              "plans": {m: bplan(m, k, n, 2, 8)._asdict() for m in ms},
              "max_abs_err": max(e[0] for e in errs),
              "rel_err": max(e[1] for e in errs), "tol": BF16_TOL,
              "solo_row_equals_batched_row": solo_equal})
        if not solo_equal:
            raise AssertionError(f"bea_batched {k}x{n}: a row served alone "
                                 f"differs from the same row in a batch")
    x, w, a, b, e, mk, _ = batched_operands(6, d, d, 3, 8, torch.bfloat16)
    stray = torch.tensor([0, -1, 3, 2, 7, 1], dtype=torch.int32, device=dev)
    got = bea_batched(x, w, a, b, e, mk, stray, 2.0)
    keep = torch.tensor([1, 2, 4], device=dev)
    err, rel = rel_err(got[keep], (x.float() @ w.float())[keep])
    record("bea_batched", err, rel, BF16_TOL)
    emit({"phase": "kernels", "kernel": "bea_batched",
          "case": "idx outside [0, G) gets no adapter", "max_abs_err": err,
          "rel_err": rel, "tol": BF16_TOL})
    x, w = rnd(5, d, dtype=torch.bfloat16), rnd(d, 128, dtype=torch.bfloat16)
    zero = bea_batched(x, w, rnd(2, 0, d, dtype=torch.bfloat16),
                       rnd(2, 128, 0, dtype=torch.bfloat16), rnd(2, 0),
                       mask(2, 0), torch.zeros(5, dtype=torch.int32,
                                               device=dev))
    err, rel = rel_err(zero, x.float() @ w.float())
    record("bea_batched", err, rel, BF16_TOL)
    a, b = rnd(2, 8, d, dtype=torch.bfloat16), rnd(2, 128, 8, dtype=torch.bfloat16)
    pruned = bea_batched(x, w, a, b, rnd(2, 8), torch.zeros(
        2, 8, dtype=torch.bool, device=dev), torch.tensor(
        [0, 1, 1, 0, 1], dtype=torch.int32, device=dev), 3.0)
    err2, rel2 = rel_err(pruned, x.float() @ w.float())
    record("bea_batched", err2, rel2, BF16_TOL)
    emit({"phase": "kernels", "kernel": "bea_batched",
          "case": "rank-0 bucket / fully masked rows",
          "max_abs_err": max(err, err2), "rel_err": max(rel, rel2),
          "tol": BF16_TOL})

    # ---- flash -------------------------------------------------------------
    fcases = [(2, 128, 4, 4, 32, True, 0, 0.0), (2, 128, 4, 2, 32, True, 0, 0.0),
              (1, 256, 4, 1, 64, True, 32, 0.0), (2, 128, 4, 4, 32, False, 0, 0.0),
              (2, 128, 8, 2, 32, True, 0, 50.0), (1, 384, 6, 3, 16, True, 128, 30.0)]
    # the f32 (3xTF32) and bf16 tensor-core bodies on the same cases,
    # window and soft-cap included
    fcases = [c + (dt,) for c in fcases
              for dt in (torch.float32, torch.bfloat16)]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    fcases += [(1, s, h, kvh, hd, True, 0, 0.0, dt) for s in (128, 64, 100, 37)
               for dt in (torch.bfloat16, torch.float32)]
    fcases += [(2, 130, h, kvh, hd, True, 48, 0.0, dt)
               for dt in (torch.float32, torch.bfloat16)]
    fcases += [(1, 128, h, kvh, hd, True, 0, 30.0, torch.bfloat16),
               (1, 100, h, kvh, hd, True, 32, 20.0, torch.bfloat16),
               (1, 300, 4, 2, 128, True, 0, 0.0, torch.bfloat16),
               (2, 200, 8, 2, 128, False, 64, 20.0, torch.bfloat16)]
    fcases = [c[:2] + (c[1],) + c[2:] for c in fcases]      # Sk = Sq
    # LM training (phase 11): Qwen2's causal GQA call at 8 × 512, on the
    # wgmma body, with ragged S = 500 and 513, non-causal, Sq ≠ Sk both
    # ways, window 128 with soft-cap 30 and head dim 128; BART-base's 12
    # heads of 64 in f32: encoder, causal decoder, cross-attention (Sq = 256
    # over Sk = 384) and ragged Sq ≠ Sk
    bh = 12
    fcases += [(8, 512, 512, h, kvh, hd, True, 0, 0.0, torch.bfloat16),
               (2, 500, 500, h, kvh, hd, True, 0, 0.0, torch.bfloat16),
               (2, 513, 513, h, kvh, hd, True, 0, 0.0, torch.bfloat16),
               (2, 512, 512, h, kvh, hd, False, 0, 0.0, torch.bfloat16),
               (2, 384, 640, h, kvh, hd, True, 0, 0.0, torch.bfloat16),
               (2, 384, 640, h, kvh, hd, False, 0, 0.0, torch.bfloat16),
               (2, 640, 384, h, kvh, hd, True, 0, 0.0, torch.bfloat16),
               (2, 512, 512, h, kvh, hd, True, 128, 30.0, torch.bfloat16),
               (2, 512, 512, 8, 2, 128, True, 0, 0.0, torch.bfloat16),
               (2, 65, 129, 4, 2, 64, False, 0, 0.0, torch.bfloat16)]
    fcases += [(b_, sq, sk, bh, bh, 64, causal, 0, 0.0, torch.float32)
               for b_, sq, sk, causal in ((8, 256, 256, True),
                                          (8, 256, 256, False),
                                          (8, 256, 384, False),
                                          (2, 100, 37, False),
                                          (2, 37, 300, False),
                                          (2, 200, 129, False),
                                          (2, 256, 1000, False))]
    # Gemma at head dim 256 (bf16): Gemma2's call (8 × 512, 8 q / 4 kv
    # heads, window 4096, cap 50), a binding window with its cap, Gemma3's
    # local (window 512) and global calls at 4 × 1024 (4 q / 1 kv head),
    # and 20 query rows for mma_kernel<256>
    fcases += [(b_, s_, s_, h_, kv_, 256, True, w_, cap_, torch.bfloat16)
               for b_, s_, h_, kv_, w_, cap_ in GEMMA_FLASH]
    fcases += [(2, 512, 512, h, kvh, hd, True, 0, 0.0, torch.bfloat16,
                "strided"),         # 136-byte rows, no TMA: mma_kernel
               (2, 512, 512, 8, 4, 256, True, 256, 50.0, torch.bfloat16,
                "strided")]         # 520-byte rows: mma_kernel<256>
    # Granite-3.0-1B-A400M's training call: 8 × 512, 16 q / 8 kv heads of
    # 64, causal, on the wgmma body
    gr = get_config("granite_moe_1b_a400m")
    fcases += [(8, 512, 512, gr.n_heads, gr.n_kv_heads, gr.head_dim, True, 0,
                0.0, torch.bfloat16)]
    # MiniCPM-2B's training call (8 × 512, 36 q over 36 kv heads of 64:
    # group 1 on the wgmma body), then f32 at head dim 36
    mc = get_config("minicpm_2b")
    fcases += [(8, 512, 512, mc.n_heads, mc.n_kv_heads, mc.head_dim, True, 0,
                0.0, torch.bfloat16)]
    fcases += [(b_, sq, sk, h_, kv_, 36, causal, 0, 0.0, torch.float32)
               for b_, sq, sk, h_, kv_, causal in HD36_FLASH]
    # Zamba2-1.2B's shared block at 8 × 512: 32 q over 32 kv heads of 64,
    # causal, window 4096 (it cannot bind), on the wgmma body; its SMOKE's
    # f32 call at head dim 32, where the window of 16 binds
    zc = get_config("zamba2_1p2b")
    zs = get_config("zamba2_1p2b", smoke=True)
    fcases += [(8, 512, 512, zc.n_heads, zc.n_kv_heads, zc.head_dim, True,
                zc.sliding_window, 0.0, torch.bfloat16),
               (8, 512, 512, zs.n_heads, zs.n_kv_heads, zs.head_dim, True,
                zs.sliding_window, 0.0, torch.float32)]
    wg_repeat = {}
    for b_, s, sk, h_, kv_, hd_, causal, window, cap, dt, *view in fcases:
        if view:                    # q, k, v views with rows of hd + 4
            q, k, v = (rnd(b_, n, m, hd_ + 4, dtype=dt)[..., :hd_]
                       for n, m in ((s, h_), (sk, kv_), (sk, kv_)))
        else:
            q = rnd(b_, s, h_, hd_, dtype=dt)
            k, v = (rnd(b_, sk, kv_, hd_, dtype=dt) for _ in range(2))
        p = fplan(dt, b_, h_, s, sk, hd_, tma_aligned(
            *((t, (t.stride(0), t.stride(2), t.stride(1))) for t in (q, k, v))))
        if view and p.kernel != "mma":
            raise AssertionError(f"flash strided view: plan {p}")
        got = mha_flash(q, k, v, causal=causal, window=window, softcap=cap)
        same_as_mma = None      # the wgmma body gives mma_kernel's bits
        if p.kernel == "wgmma" and not cap:
            same_as_mma = bool(torch.equal(got, mha_flash(
                q, k, v, causal=causal, window=window, body=FPlan("mma"))))
        g_ = h_ // kv_
        want = ref.flash_attention_ref(
            q.float(), k.float().repeat_interleave(g_, 2),
            v.float().repeat_interleave(g_, 2), causal=causal, window=window,
            softcap=cap)
        tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        err, rel = rel_err(got, want)
        record("flash_attention", err, rel, tol)
        if hd_ == 256:
            record("flash_attention_hd256", err, rel, tol)
        if hd_ == 36:
            record("flash_attention_hd36", err, rel, tol)
        emit({"phase": "kernels", "kernel": "flash_attention", "b": b_,
              "s": s, "sk": sk, "h": h_, "kv": kv_, "hd": hd_,
              "causal": causal, "window": window, "softcap": cap,
              "dtype": str(dt).split(".")[1], "view": view[0] if view
              else "contiguous", "plan": p._asdict(),
              "equal_to_mma_kernel": same_as_mma, "max_abs_err": err,
              "rel_err": rel, "tol": tol})
        if same_as_mma is False:
            raise AssertionError(f"flash {b_}x{s}x{sk}: the wgmma body's "
                                 f"bits differ from mma_kernel's")
        if p.kernel == "wgmma":
            wg_repeat[f"flash_attention wgmma {b_}x{s}x{sk} h{h_}/{kv_} "
                      f"hd{hd_} causal={causal} w{window} cap{cap}"] = (
                repeatable(torch, lambda q=q, k=k, v=v, c=causal, w=window,
                           cap=cap: mha_flash(q, k, v, causal=c, window=w,
                                              softcap=cap)))
        if (b_, s, sk, dt) == (8, 256, 384, torch.float32):
            cross = (q, k, v)
        if (b_, s, hd_) == (8, 512, 36):
            hd36 = (q, k, v)

    # ---- the tensor-core kernels are repeatable and graph-safe -------------
    repeat = {}
    for k, n in sorted(set(layer_kn.values())):
        ops = dense_operands(128, k, n, 8, torch.bfloat16)
        repeat[f"bea_dense {k}x{n}"] = repeatable(
            torch, lambda ops=ops: bea_dense(*ops, 2.0))
    for k, n in sorted(set(layer_kn.values())):
        for m in (4, 64):
            ops = batched_operands(m, k, n, 2, 8, torch.bfloat16)
            repeat[f"bea_batched {m}x{k}x{n}"] = repeatable(
                torch, lambda ops=ops: bea_batched(*ops, 1.5))
    for k, n in sorted(set(layer_kn.values())):   # f32: split and unsplit
        ops = dense_operands(1024, k, n, 12, torch.float32)
        repeat[f"bea_dense f32 1024x{k}x{n}"] = repeatable(
            torch, lambda ops=ops: bea_dense(*ops, 2.0))
    for dt in (torch.bfloat16, torch.float32):
        q = rnd(1, 128, h, hd, dtype=dt)
        k, v = (rnd(1, 128, kvh, hd, dtype=dt) for _ in range(2))
        repeat[f"flash_attention {str(dt).split('.')[1]}"] = repeatable(
            torch, lambda q=q, k=k, v=v: mha_flash(q, k, v, causal=True))
    for k, n in sorted(set(layer_kn.values())):   # the wgmma instance
        ops = dense_operands(4096, k, n, 8, torch.bfloat16)
        repeat[f"bea_dense bf16 4096x{k}x{n}"] = repeatable(
            torch, lambda ops=ops: bea_dense(*ops, 2.0))
    repeat["flash_attention f32 cross 256x384"] = repeatable(
        torch, lambda: mha_flash(*cross, causal=False))
    repeat["flash_attention f32 hd36 8x512"] = repeatable(
        torch, lambda: mha_flash(*hd36, causal=True))
    ops = dense_operands(4096, *MAMBA2_KN["in_proj"], 8, torch.bfloat16)
    repeat["bea_dense bf16 4096x1536x6448"] = repeatable(
        torch, lambda: bea_dense(*ops, 2.0))
    for k, n in ZAMBA2_KN.values():
        zops = dense_operands(4096, k, n, 8, torch.bfloat16)
        repeat[f"bea_dense bf16 4096x{k}x{n}"] = repeatable(
            torch, lambda zops=zops: bea_dense(*zops, 2.0))
    repeat.update(wg_repeat)
    q = rnd(1, 20, 4, 256, dtype=torch.bfloat16)
    k, v = (rnd(1, 20, 1, 256, dtype=torch.bfloat16) for _ in range(2))
    repeat["flash_attention mma_kernel<256> 1x20 w16 cap50"] = repeatable(
        torch, lambda: mha_flash(q, k, v, causal=True, window=16,
                                 softcap=50.0))
    emit({"phase": "kernels", "check": "two calls bitwise equal, CUDA-graph "
          "replay equal to the eager call", "results": repeat})
    bad = [name for name, ok in repeat.items() if not all(ok.values())]
    if bad:
        raise AssertionError(f"not repeatable or not graph-safe: {bad}")
    torch.cuda.synchronize()
    return worst


def repeatable(torch, fn) -> dict:
    """Whether two eager calls of ``fn`` are bitwise equal, and whether a
    CUDA-graph capture of it, replayed, gives the same bits again."""
    first, again = fn(), fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    return {"eager": bool(torch.equal(first, again)),
            "graph": bool(torch.equal(captured, first))}


# ------------------------------------------------------------ timing --------

def dense_bounds(m: int, r: int, shapes, dtype: str) -> dict:
    """The bound of ``bea_dense`` over ``shapes`` [(K, N)] at M rows and
    rank r: bytes (x, W, A, B, E, mask read and y written once) against
    flops; f32's as 3xTF32 with the CUDA cores' beside it."""
    es = 2 if dtype == "bfloat16" else 4
    nbytes = sum(es * (m * k + k * n + r * k + n * r + m * n) + 5 * r
                 for k, n in shapes)
    flops = sum(2 * m * k * n + 2 * m * r * (k + n) for k, n in shapes)
    if dtype == "bfloat16":
        return dict(zip(("bound_ms", "bound_by"),
                        bound_ms(nbytes, flops, dtype)))
    return f32_bounds(nbytes, flops)


def time_dense_layer(torch, layers, xs, s: float, names, shape: str):
    """``bea_dense`` over one layer's adapted linears: ``layers`` holds a
    few layers' [(w, a, b, e, mask)] per linear, cycled so that their
    weights exceed the 50 MB L2 as the real path's do, ``xs`` the input
    rows by K.  Each linear named in ``names`` [(name, index)] alone under
    its plan, and the whole layer, beside the plain version, the ``addmm``
    library form and the bound → (per layer, per linear)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bea_fused import bea_dense, plan

    kns = [tuple(w.shape) for w, *_ in layers[0]]
    x0 = next(iter(xs.values()))
    m, r, dt = x0.shape[0], layers[0][0][1].shape[0], x0.dtype
    dname = str(dt).split(".")[1]

    def lib_dense(x, w, a, b, e, mk):
        return torch.addmm(x @ w, (x @ a.T) * (e * mk).to(x.dtype), b.T,
                           alpha=s)

    def run(fn, js=range(len(kns))):
        def go():
            for layer in layers:
                for j in js:
                    w, a, b, e, mk = layer[j]
                    fn(xs[w.shape[0]], w, a, b, e, mk)
        return go

    n = len(layers)
    per_linear = {}
    for name, j in names:
        k, nn = kns[j]
        p = plan(m, k, nn, dt, rank=r)
        per_linear[name] = {
            "k": k, "n": nn, "kernel": p.kernel, "tile": [p.block_m, p.block_n],
            "splits": p.splits, "k_slice": p.k_slice, "blocks": p.blocks,
            "ms": time_ms(torch, run(lambda *t: bea_dense(*t, s), [j])) / n,
            "library_ms": time_ms(torch, run(lib_dense, [j])) / n,
            **dense_bounds(m, r, [(k, nn)], dname)}
    layer_t = {
        "ms": time_ms(torch, run(lambda *t: bea_dense(*t, s))) / n,
        "plain_ms": time_ms(torch, run(
            lambda *t: ref.bea_dense_ref(*t, s))) / n,
        "library_ms": time_ms(torch, run(lib_dense)) / n,
        **dense_bounds(m, r, kns, dname), "shape": shape}
    return layer_t, per_linear


def time_kernels(torch, cfg):
    """Main-path timings.  The adapter kernels are timed over one layer's 7
    adapted linears (wq wk wv wo w1 w3 w2), cycling 4 layers' distinct
    weights (~120 MB, more than the 50 MB L2) as the real path does; flash
    over one prefill call."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bea_batched import bea_batched
    from repro_torch.kernels.bea_batched import plan as bplan
    from repro_torch.kernels.flash_attention import mha_flash
    from repro_torch.kernels.flash_attention import plan as fplan

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    d, f = cfg.d_model, cfg.d_ff
    kv_d = cfg.n_kv_heads * cfg.head_dim
    kns = [(d, d), (d, kv_d), (d, kv_d), (d, d), (d, f), (d, f), (f, d)]
    n_layers, r, s = 4, 8, 2.0
    out = {}

    # ---- bea_dense: prefill chunks of 128 and 64 tokens, rank 8 -----------
    layers = [[(rnd(k, n, scale=k ** -0.5), rnd(r, k, scale=k ** -0.5),
                rnd(n, r), rnd(r, dtype=torch.float32),
                torch.ones(r, dtype=torch.bool, device=dev)) for k, n in kns]
              for _ in range(n_layers)]
    for m in (64, 128):
        layer_t, per_linear = time_dense_layer(
            torch, layers, {k: rnd(m, k) for k in (d, f)}, s,
            (("wq/wo", 0), ("wk/wv", 1), ("w1/w3", 4), ("w2", 6)),
            f"7 linears of one layer, M={m}, r=8, bf16")
        emit({"phase": "timing", "kernel": "bea_dense", "m": m, "r": r,
              "per_layer": layer_t, "per_linear": per_linear})
    out["bea_dense"] = layer_t                  # M = 128, the kernels line

    # ---- bea_batched: decode groups of 1, 4, 8 and 64 rows over 2 tenants,
    # rank 8 (4 rows is the serving run's group, the kernels line) ----------
    g = 2
    blayers = [[(rnd(k, n, scale=k ** -0.5), rnd(g, r, k, scale=k ** -0.5),
                 rnd(g, n, r), rnd(g, r, dtype=torch.float32),
                 torch.ones(g, r, dtype=torch.bool, device=dev))
                for k, n in kns] for _ in range(n_layers)]

    def lib_multi(*t):
        return ops.adapted_dense_multi(*t, s)

    def dense_only(x, w, *_):
        return x @ w

    for m in (1, 4, 8, 64):
        bxs = {k: rnd(m, k) for k in (d, f)}
        idx = (torch.arange(m, device=dev) % g).to(torch.int32)

        def brun(fn, js=range(len(kns)), bxs=bxs, idx=idx):
            def go():
                for layer in blayers:
                    for j in js:
                        w, a, b, e, mk = layer[j]
                        fn(bxs[w.shape[0]], w, a, b, e, mk, idx)
            return go

        def batched_bound(shapes, m=m):
            nbytes = sum(2 * (m * k + k * n + g * r * (k + n) + m * n)
                         + 5 * g * r + 4 * m for k, n in shapes)
            flops = sum(2 * m * k * n + 2 * m * r * (k + n) for k, n in shapes)
            return bound_ms(nbytes, flops, "bfloat16")

        # one linear at a time under its plan, beside the torch-ops form on
        # that linear alone (library), x @ w alone (the dense part only, not
        # the same function) and its bound
        per_linear = {}
        for name, j in (("wq/wo", 0), ("wk/wv", 1), ("w1/w3", 4), ("w2", 6)):
            k, n = kns[j]
            p = bplan(m, k, n, g, r)
            per_linear[name] = {
                "k": k, "n": n, "block_n": p.block_n, "splits": p.splits,
                "k_slice": p.k_slice, "stages": p.stages, "blocks": p.blocks,
                "ms": time_ms(torch, brun(lambda *t: bea_batched(*t, s), [j]))
                / n_layers,
                "library_ms": time_ms(torch, brun(lib_multi, [j])) / n_layers,
                "dense_ms": time_ms(torch, brun(dense_only, [j])) / n_layers,
                "bound_ms": batched_bound([(k, n)])[0]}
        b_ms, b_by = batched_bound(kns)
        layer_t = {
            "ms": time_ms(torch, brun(lambda *t: bea_batched(*t, s)))
            / n_layers,
            "library_ms": time_ms(torch, brun(lib_multi)) / n_layers,
            "dense_ms": time_ms(torch, brun(dense_only)) / n_layers,
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"7 linears of one layer, M={m} rows, G=2, r=8, bf16"}
        if m == 4:
            layer_t["plain_ms"] = time_ms(torch, brun(
                lambda *t: ref.bea_batched_ref(*t, s)), iters=5,
                graph=False) / n_layers
            out["bea_batched"] = layer_t
        emit({"phase": "timing", "kernel": "bea_batched", "m": m, "g": g,
              "r": r, "per_layer": layer_t, "per_linear": per_linear})

    # ---- flash: one prefill chunk of 64 and of 128 tokens -----------------
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    grp = h // kvh
    for sq in (64, 128):
        q, k, v = rnd(1, sq, h, hd), rnd(1, sq, kvh, hd), rnd(1, sq, kvh, hd)
        kr, vr = k.repeat_interleave(grp, 2), v.repeat_interleave(grp, 2)
        qt = q.transpose(1, 2).contiguous()
        krt = kr.transpose(1, 2).contiguous()
        vrt = vr.transpose(1, 2).contiguous()

        def lib(qt=qt, krt=krt, vrt=vrt):   # GQA by repeated heads, untimed
            return F.scaled_dot_product_attention(qt, krt, vrt, is_causal=True)
        pairs = sq * (sq + 1) // 2
        nbytes = 2 * (2 * sq * h * hd + 2 * sq * kvh * hd)
        flops = 4 * hd * pairs * h
        b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
        def per_call(fn, n=cfg.n_layers):
            # one graph holds a prefill's n_layers calls, so that replaying
            # it does not time the host's graph launch instead of the call
            return time_ms(torch, lambda: [fn() for _ in range(n)]) / n

        flash_t = {
            "ms": per_call(lambda: mha_flash(q, k, v, causal=True)),
            "plan": fplan(bf, 1, h, sq, sq, hd)._asdict(),
            "plain_ms": per_call(lambda: ref.flash_attention_ref(
                q, kr, vr, causal=True)),
            "library_ms": per_call(lib),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"one prefill call (mean of {cfg.n_layers} in one "
                     f"graph), B=1, S={sq}, 14 q / 2 kv heads of 64, bf16"}
        emit({"phase": "timing", "kernel": "flash_attention", **flash_t})
    out["flash_attention"] = flash_t            # S = 128, the kernels line
    return out


def f32_tiling(m, k, n, g, r, block_n, splits):
    """The f32 ``bea_batched`` plan for a call, but with column tiles of
    ``block_n`` and K split toward ``splits`` ways in place of
    ``f32_plan``'s rule (its other fields as ``f32_plan`` sets them)."""
    import importlib

    BB = importlib.import_module("repro_torch.kernels.bea_batched")
    bk = BB.f32_block_k(block_n)
    per = -(-max(1, -(-k // bk)) // splits)
    sp = -(-max(1, -(-k // bk)) // per)
    mp, ut = BB.f32_m_pad(m), BB.u_tiles(g * r)
    stages = min(BB.F32_STAGES[ut], per)
    return BB.Plan(block_n, sp, per * bk, stages,
                   -(-n // block_n) * sp * -(-m // mp), mp, ut,
                   BB.f32_smem_bytes(mp, ut, block_n, stages, sp, r))


def legacy_kernels(torch):
    """Phase 3's cases of the static-batch loop and of InternVL2-1B's LM
    step, each against its plain version, repeatable and graph-safe,
    printing its plan, then timed beside its bound, the plain version and a
    library call: bf16 ``bea_dense`` at InternVL2's 7 linears (r = 8) at
    INTERNVL2_ROWS; bf16 causal GQA flash (14 q over 2 kv heads of 64) at
    INTERNVL2_FLASH; the f32 ``bea_batched`` (``fma_kernel``, one launch
    a call under ``f32_plan``) at BART-base's decode linears, M = 4, G =
    1, r = 12, its bias against float64 within F32_BIAS_TOL and no scratch
    buffer drawn, its library call ``x @ w`` plus the adapter by torch
    ops.  BART's prefill shapes in the
    loop (f32 ``bea_dense`` at 1,024 and 512 rows, flash over its encoder,
    decoder and cross-attention) are checked, not timed: phases 6 and 11
    time those instances.  → (worst errors by kernel,
    the timings by kernel)."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import _scratch
    from repro_torch.kernels.bea_batched import (bea_batched, f32_plan,
                                                 run_plan)
    from repro_torch.kernels.bea_fused import bea_dense, plan
    from repro_torch.kernels.flash_attention import mha_flash
    from repro_torch.kernels.flash_attention import plan as fplan

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 30)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def mask(*shape):
        mk = torch.rand(shape, generator=gen, device=dev) > 0.3
        mk[..., 0] = True
        return mk

    worst, repeat, times = {}, {}, {}

    def record(name, err, rel, tol):
        if rel > tol:
            raise AssertionError(f"{name}: relative error {rel} > {tol}")
        w = worst.setdefault(name, [0.0, 0.0])
        w[0], w[1] = max(w[0], err), max(w[1], rel)

    ic = get_config("internvl2_1b")
    d, f = ic.d_model, ic.d_ff
    kv_d = ic.n_kv_heads * ic.head_dim
    kns = [(d, d), (d, kv_d), (d, kv_d), (d, d), (d, f), (d, f), (f, d)]
    r, s = 8, 2.0

    # ---- bea_dense, bf16, InternVL2's linears --------------------------
    for m in INTERNVL2_ROWS:
        errs, plans = [], {}
        for k, n in sorted(set(kns)):
            ops = (rnd(m, k, dtype=bf), rnd(k, n, scale=k ** -0.5, dtype=bf),
                   rnd(r, k, scale=k ** -0.5, dtype=bf), rnd(n, r, dtype=bf),
                   rnd(r), mask(r))
            got = bea_dense(*ops, s)
            want = ref.bea_dense_ref(*(t.float() if t.dtype == bf else t
                                       for t in ops), s)
            err, rel = rel_err(got, want)
            record("bea_dense", err, rel, BF16_TOL)
            errs.append((err, rel))
            plans[f"{k}x{n}"] = plan(m, k, n, rank=r)._asdict()
            repeat[f"bea_dense bf16 {m}x{k}x{n}"] = repeatable(
                torch, lambda ops=ops: bea_dense(*ops, s))
        emit({"phase": "kernels", "kernel": "bea_dense", "dtype": "bfloat16",
              "case": "InternVL2-1B", "m": m, "r": r, "plans": plans,
              "max_abs_err": max(e[0] for e in errs),
              "rel_err": max(e[1] for e in errs), "tol": BF16_TOL})
    layers = [[(rnd(k, n, scale=k ** -0.5, dtype=bf),
                rnd(r, k, scale=k ** -0.5, dtype=bf), rnd(n, r, dtype=bf),
                rnd(r), torch.ones(r, dtype=torch.bool, device=dev))
               for k, n in kns] for _ in range(4)]
    dense_t = {}
    for m in INTERNVL2_ROWS[:2]:
        layer_t, per_linear = time_dense_layer(
            torch, layers, {k: rnd(m, k, dtype=bf) for k in (d, f)}, s,
            (("wq/wo", 0), ("wk/wv", 1), ("w1/w3", 4), ("w2", 6)),
            f"7 linears of one InternVL2-1B layer, M={m}, r=8, bf16")
        dense_t[m] = {**layer_t, "per_linear": per_linear}
        emit({"phase": "timing", "kernel": "bea_dense", "case": "InternVL2-1B",
              "m": m, "r": r, "per_layer": layer_t,
              "per_linear": per_linear, "nvidia_smi": nvidia_smi()})
    times["bea_dense"] = {f"internvl2_m{m}": t for m, t in dense_t.items()}
    del layers

    # ---- flash, bf16, InternVL2's causal GQA calls --------------------
    h, kvh, hd = ic.n_heads, ic.n_kv_heads, ic.head_dim
    grp = h // kvh
    flash_t = {}
    for b_, sq in INTERNVL2_FLASH:
        q = rnd(b_, sq, h, hd, dtype=bf)
        k, v = (rnd(b_, sq, kvh, hd, dtype=bf) for _ in range(2))
        kr, vr = k.repeat_interleave(grp, 2), v.repeat_interleave(grp, 2)
        p = fplan(bf, b_, h, sq, sq, hd)
        got = mha_flash(q, k, v, causal=True)
        err, rel = rel_err(got, ref.flash_attention_ref(
            q.float(), kr.float(), vr.float(), causal=True))
        record("flash_attention", err, rel, BF16_TOL)
        emit({"phase": "kernels", "kernel": "flash_attention",
              "case": "InternVL2-1B", "b": b_, "s": sq, "h": h, "kv": kvh,
              "hd": hd, "causal": True, "dtype": "bfloat16",
              "plan": p._asdict(), "max_abs_err": err, "rel_err": rel,
              "tol": BF16_TOL})
        repeat[f"flash_attention InternVL2 {b_}x{sq}"] = repeatable(
            torch, lambda q=q, k=k, v=v: mha_flash(q, k, v, causal=True))
        qt, krt, vrt = (t.transpose(1, 2).contiguous() for t in (q, kr, vr))

        def per_call(fn, n=ic.n_layers):
            # one graph holds a forward's calls, so that a replay does not
            # time the host's graph launch instead of the call
            return time_ms(torch, lambda: [fn() for _ in range(n)]) / n

        b_ms, b_by = flash_bound(b_, sq, sq, h, kvh, hd, True, 0)
        ms = per_call(lambda: mha_flash(q, k, v, causal=True))
        flash_t[f"{b_}x{sq}"] = row = {
            "ms": ms, "plan": p._asdict(),
            "plain_ms": per_call(lambda: ref.flash_attention_ref(
                q, kr, vr, causal=True), n=4),
            "library_ms": per_call(lambda: F.scaled_dot_product_attention(
                qt, krt, vrt, is_causal=True)),
            "library": "sdpa (kv heads repeated, untimed)",
            "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms,
            "shape": f"B={b_}, S={sq}, 14 q / 2 kv heads of 64, causal, bf16"}
        emit({"phase": "timing", "kernel": "flash_attention",
              "case": "InternVL2-1B", **row, "nvidia_smi": nvidia_smi()})
    times["flash_attention"] = {f"internvl2_{k}": v for k, v in
                                flash_t.items()}

    # ---- BART-base's prefill in the loop, f32: bea_dense at the encoder's
    # 4 × 256 and the decoder's 4 × 128 rows (r = 12), flash over the
    # encoder (non-causal), the decoder (causal) and cross 128 over 256 ----
    rb = 12
    for m in (1024, 512):
        errs = []
        for k, n in BART_DECODE_KN.values():
            ops = (rnd(m, k), rnd(k, n, scale=k ** -0.5),
                   rnd(rb, k, scale=k ** -0.5), rnd(n, rb), rnd(rb),
                   mask(rb))
            err, rel = rel_err(bea_dense(*ops, s),
                               ref.bea_dense_ref(*ops, s))
            record("bea_dense", err, rel, F32_TOL)
            errs.append((err, rel))
        emit({"phase": "kernels", "kernel": "bea_dense", "dtype": "float32",
              "case": "BART-base prefill", "m": m, "r": rb,
              "kn": list(BART_DECODE_KN.values()),
              "max_abs_err": max(e[0] for e in errs),
              "rel_err": max(e[1] for e in errs), "tol": F32_TOL})
    for b_, sq, sk, causal in ((4, 256, 256, False), (4, 128, 128, True),
                               (4, 128, 256, False)):
        q = rnd(b_, sq, 12, 64)
        k, v = (rnd(b_, sk, 12, 64) for _ in range(2))
        err, rel = rel_err(mha_flash(q, k, v, causal=causal),
                           ref.flash_attention_ref(q, k, v, causal=causal))
        record("flash_attention", err, rel, F32_TOL)
        emit({"phase": "kernels", "kernel": "flash_attention",
              "case": "BART-base prefill", "b": b_, "s": sq, "sk": sk,
              "h": 12, "kv": 12, "hd": 64, "causal": causal,
              "dtype": "float32",
              "plan": fplan(torch.float32, b_, 12, sq, sk, 64)._asdict(),
              "max_abs_err": err, "rel_err": rel, "tol": F32_TOL})
        repeat[f"flash_attention f32 BART {b_}x{sq}x{sk}"] = repeatable(
            torch, lambda q=q, k=k, v=v, c=causal: mha_flash(q, k, v,
                                                             causal=c))

    # ---- bea_batched, f32, BART-base's decode linears ---------------------
    m, g = 4, 1
    idx = torch.zeros(m, dtype=torch.int32, device=dev)

    def batched_ops(k, n):
        return (rnd(m, k), rnd(k, n, scale=k ** -0.5),
                rnd(g, rb, k, scale=k ** -0.5), rnd(g, n, rb), rnd(g, rb),
                mask(g, rb), idx)

    def lib(x, w, a, b, e, mk, _idx):       # x @ w plus the adapter, G = 1
        return torch.addmm(x @ w, (x @ a[0].T) * (e[0] * mk[0]), b[0].T,
                           alpha=s)

    def batched_bound(shapes):
        nbytes = sum(4 * (m * k + k * n + g * rb * (k + n) + m * n)
                     + 5 * g * rb + 4 * m for k, n in shapes)
        flops = sum(2 * m * k * n + 2 * m * rb * (k + n) for k, n in shapes)
        return f32_bounds(nbytes, flops)

    per_linear, biased = {}, []
    for name, (k, n) in BART_DECODE_KN.items():
        ops = batched_ops(k, n)
        before = dict(_scratch._BUFFERS)
        got = bea_batched(*ops, s)
        drew = _scratch._BUFFERS.keys() != before.keys() or any(
            _scratch._BUFFERS[key] is not buf for key, buf in before.items())
        err, rel = rel_err(got, ref.bea_batched_ref(*ops, s))
        for kname in ("bea_batched", "bea_batched_f32"):
            record(kname, err, rel, F32_TOL)
        # a sum that shrinks or grows as a whole compounds over the layers
        # and the decode steps (as for the f32 bea_dense, phase 6)
        t = ref.bea_batched_ref(*(v.double() for v in ops[:5]), *ops[5:], s)
        bias = ((got.double() * t).sum() / (t * t).sum() - 1.0).item()
        if abs(bias) > F32_BIAS_TOL:
            biased.append((name, bias))
        if drew:
            raise AssertionError(f"f32 bea_batched {k}x{n} drew a scratch "
                                 f"buffer")
        repeat[f"bea_batched f32 {m}x{k}x{n} r{rb}"] = repeatable(
            torch, lambda ops=ops: bea_batched(*ops, s))
        per_linear[name] = {
            "k": k, "n": n, "plan": f32_plan(m, k, n, g, rb)._asdict(),
            "max_abs_err": err, "rel_err": rel, "tol": F32_TOL,
            "bias_vs_f64": bias, "bias_tol": F32_BIAS_TOL,
            "ms": time_ms(torch, lambda ops=ops: bea_batched(*ops, s)),
            "plain_ms": time_ms(torch, lambda ops=ops: ref.bea_batched_ref(
                *ops, s), iters=5, graph=False),
            "library_ms": time_ms(torch, lambda ops=ops: lib(*ops)),
            **batched_bound([(k, n)])}
        emit({"phase": "kernels", "kernel": "bea_batched", "dtype": "float32",
              "case": f"BART-base decode {name}", "m": m, "g": g, "r": rb,
              **per_linear[name]})
    # the plan against the two-wave tilings behind F32_WAVE_BLOCKS (fc1 at
    # 288 and 384 blocks) and 768² at 96 blocks, weights cycled past the
    # 50 MB L2 as the decode reads them
    waves = []
    for name, bn, sp in (("fc1", 64, 6), ("fc1", 64, 8), ("q/k/v/o", 32, 4)):
        k, n = BART_DECODE_KN[name]
        copies = [batched_ops(k, n) for _ in range(-(-60_000_000
                                                     // (4 * k * n)))]
        for p in (f32_plan(m, k, n, g, rb), f32_tiling(m, k, n, g, rb, bn,
                                                       sp)):
            waves.append({"linear": name, "block_n": p.block_n,
                          "splits": p.splits, "blocks": p.blocks,
                          "plan": p == f32_plan(m, k, n, g, rb),
                          "ms": time_ms(torch, lambda p=p: [
                              run_plan(p, *o, s) for o in copies])
                          / len(copies)})
        del copies
    emit({"phase": "timing", "timing": "f32 bea_batched plan against other "
          "waves", "m": m, "g": g, "r": rb, "rows": waves,
          "nvidia_smi": nvidia_smi()})
    # one decoder layer's 8 linears, cycling 4 layers' weights (~133 MB,
    # more than the 50 MB L2) as the decode does
    blayers = [[batched_ops(k, n)[1:] for k, n in BART_DECODE_LAYER]
               for _ in range(4)]
    bxs = {k: rnd(m, k) for k in (768, 3072)}

    def brun(fn):
        def go():
            for layer in blayers:
                for w, *rest in layer:
                    fn(bxs[w.shape[0]], w, *rest)
        return go

    layer_t = {
        "ms": time_ms(torch, brun(lambda *t: bea_batched(*t, s))) / 4,
        "plain_ms": time_ms(torch, brun(lambda *t: ref.bea_batched_ref(
            *t, s)), iters=5, graph=False) / 4,
        "library_ms": time_ms(torch, brun(lib)) / 4,
        **batched_bound(BART_DECODE_LAYER),
        "shape": "8 decode linears of one BART-base decoder layer (self "
                 "q/k/v/o, cross q/o, fc1, fc2), M=4 rows, G=1, r=12, f32"}
    times["bea_batched"] = {"f32_bart_decode": {**layer_t,
                                                "per_linear": per_linear,
                                                "plan_waves": waves}}
    emit({"phase": "timing", "kernel": "bea_batched", "dtype": "float32",
          "per_layer": layer_t, "nvidia_smi": nvidia_smi()})
    if biased:
        raise AssertionError(f"f32 bea_batched biased against float64 by "
                             f"more than {F32_BIAS_TOL}: {biased}")
    emit({"phase": "kernels", "check": "InternVL2 / BART cases: two calls "
          "bitwise equal, CUDA-graph replay equal to the eager call",
          "results": repeat})
    bad = [name for name, ok in repeat.items() if not all(ok.values())]
    if bad:
        raise AssertionError(f"not repeatable or not graph-safe: {bad}")
    return worst, times


# --------------------------------------------------------------- phases -----

def serve(torch, cfg):
    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.launch.serve import build_engine, serve_requests
    from repro_torch.pytree import tree_map

    torch.cuda.reset_peak_memory_stats()
    n_req, slots, gen_n = 8, 4, 16
    rng = np.random.default_rng(SEED)
    lens = rng.integers(100, 201, n_req)
    max_seq = int(lens.max()) + gen_n
    t0 = time.perf_counter()
    engine = build_engine(cfg, n_slots=slots, max_seq=max_seq, n_tenants=2,
                          seed=SEED, device=DEV)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    tenants = engine.registry.ids()
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    aids = [tenants[i % len(tenants)] for i in range(n_req)]

    K.reset_launches()
    t0 = time.perf_counter()
    reqs = serve_requests(engine, prompts, aids, gen_n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    for r in reqs:
        if r.state != "finished" or len(r.out) != gen_n:
            raise AssertionError(f"request {r.rid}: {r.state}, "
                                 f"{len(r.out)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"request {r.rid}: token out of range")
    missing = [k for k in ("bea_dense", "bea_batched", "flash_attention")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    st = engine.stats()
    n_tok = sum(len(r.out) for r in reqs)

    # prefill of one 128-token chunk, device-synchronized
    entry = engine.registry.get(tenants[1])
    stacks, smasks = engine._stacked([entry])
    ads = {"adapters": tree_map(lambda t: t[0], stacks)}
    msk = tree_map(lambda t: t[0], smasks)
    toks = torch.as_tensor(prompts[0][:128], device=DEV)[None]
    cache = engine.model.init_cache(1, max_seq, DEV)

    def pre():
        engine.model.prefill(engine.base, ads, msk, toks, cache)

    prefill_ms = time_ms(torch, pre, iters=5, warmup=2, graph=False)
    prefill_dev_ms = time_ms(torch, pre, iters=5, warmup=1)
    emit({"phase": "serve", "model": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "requests": n_req, "slots": slots,
          "prompt_lens": lens.tolist(), "new_tokens": gen_n,
          "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
          "engine_steps": st["steps"], "prefill_calls": st["prefill_calls"],
          "decode_calls": st["decode_calls"],
          "decode_ms_per_group_step": 1e3 * st["decode_s"]
          / max(st["decode_calls"], 1),
          "prefill_ms_128_tokens": prefill_ms,
          "prefill_device_ms_128_tokens": prefill_dev_ms,
          "build_engine_s": t_build,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches, "first_request_tokens": reqs[0].out})
    return engine, launches, prompts


def profile_serving(torch, cfg, engine, prompts):
    """Device busy share of a short serving run, from torch.profiler: the
    summed duration of every kernel on the card over the host wall time of
    the run (one stream, so kernels do not overlap).  The profiler's own
    cost inflates the wall time, so the share is a lower bound.

    Then the same for decode alone: DECODE_STEPS batched decode steps of 4
    rows of one tenant against a fresh cache, so the host time and the
    device time of one decode step can be read side by side."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import stack_adapters

    tenants = engine.registry.ids()
    for i in range(4):
        engine.submit(tenants[i % 2], prompts[i][:100], 4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps0, calls0 = engine.steps, engine.decode_calls
        engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = device_kernels(prof)
    busy_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    emit({"phase": "profile", "requests": 4, "prompt_len": 100,
          "new_tokens": 4, "engine_steps": engine.steps - steps0,
          "decode_calls": engine.decode_calls - calls0, "wall_s": wall,
          "device_busy_s": busy_us / 1e6,
          "device_idle_share": 1.0 - busy_us / 1e6 / wall,
          "top_kernels": [{"name": e.key[:60], "calls": e.count,
                           "device_ms": e.self_device_time_total / 1e3}
                          for e in top]})

    model, n_rows = engine.model, 4
    entry = engine.registry.get(tenants[1])
    stacks, smasks = stack_adapters([entry.adapters], [entry.masks],
                                    cfg.cdtype)
    cache = model.init_cache(n_rows, DECODE_STEPS + 1, DEV)
    idx = torch.zeros(n_rows, dtype=torch.int32, device=DEV)
    rows = torch.arange(n_rows, device=DEV)
    toks = torch.as_tensor([int(p[0]) for p in prompts[:n_rows]], device=DEV)

    def decode_loop(toks):
        cache["pos"].zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DECODE_STEPS):
            logits = model.decode_rows(engine.base, stacks, smasks, idx, toks,
                                       cache, rows)
            toks = logits.argmax(-1)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    decode_loop(toks)                                   # warm-up
    plain_wall = decode_loop(toks)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = decode_loop(toks)
    kern = device_kernels(prof)
    busy_us = sum(e.self_device_time_total for e in kern)
    emit({"phase": "profile", "decode_rows": n_rows, "tenants": 1,
          "decode_steps": DECODE_STEPS,
          "wall_ms_per_step": 1e3 * plain_wall / DECODE_STEPS,
          "profiled_wall_ms_per_step": 1e3 * wall / DECODE_STEPS,
          "device_busy_ms_per_step": busy_us / 1e3 / DECODE_STEPS,
          "kernel_launches_per_step": sum(e.count for e in kern)
          / DECODE_STEPS,
          "device_idle_share": 1.0 - busy_us / 1e6 / wall})


def row_rel(got, want) -> float:
    """Largest over rows of max |got − want| / max |want| within the row."""
    err = (got.float() - want.float()).abs().amax(-1)
    return (err / want.float().abs().amax(-1).clamp_min(1e-30)).max().item()


def scale_e(tree, f: float):
    if isinstance(tree, dict):
        return {k: v * f if k == "E" else scale_e(v, f)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [scale_e(v, f) for v in tree]
    return tree


def whole_path(torch, cfg, engine):
    """Kernels vs plain on the same weights, through the multi-tenant decode:
    two rank-8 tenants share one bucket stack and four rows alternate
    between them (idx = [0, 1, 0, 1]).  Each row is prefilled with its own
    ragged prompt and tenant, then all four rows take 3 greedy decode steps
    together in one ``decode_rows`` call per step (the kernel path's tokens
    fed to both).

    Tolerance PATH_TOL on max |Δlogit| / max |logit| per row: bf16 keeps 8
    mantissa bits (relative step 2^-8 ≈ 3.9e-3); the kernels accumulate in
    f32 and round once per output while the plain path rounds every
    intermediate to bf16, so across 24 layers the two differ by several bf16
    steps, but not by an order of magnitude more.

    The check must be able to fail: the tenants' E is drawn E_SCALE times
    larger than ``make_tenants`` draws it, and the adapters' own share of
    the logits — the same prefills with every rank masked off, against the
    real ones — must be at least ADAPTER_SHARE_MIN in every row.  A kernel
    that dropped the adapter term, or gathered another row's tenant, would
    then miss the plain logits by more than PATH_TOL."""
    import numpy as np

    from repro_torch.launch.serve import make_tenants
    from repro_torch.models import Model
    from repro_torch.pytree import tree_map
    from repro_torch.serving.engine import stack_adapters

    model, plain = engine.model, Model(cfg, peft="bea", use_kernels=False)
    r = cfg.adapter_rank
    specs = make_tenants(model, cfg, 2, ranks=[r], seed=SEED + 1, device=DEV)
    entries = [engine.register_adapter(f"path{i}",
                                       scale_e(s["trainable"], E_SCALE),
                                       s["masks"], rank=r,
                                       alpha=cfg.adapter_alpha)
               for i, s in enumerate(specs.values())]
    stacks, smasks = stack_adapters([e.adapters for e in entries],
                                    [e.masks for e in entries], cfg.cdtype)
    lens, max_seq = (100, 77, 128, 61), 136
    idx = torch.tensor([0, 1, 0, 1], dtype=torch.int32, device=DEV)
    rows = torch.arange(len(lens), device=DEV)
    rng = np.random.default_rng(SEED + 2)
    prompts = [torch.as_tensor(rng.integers(0, cfg.vocab_size, n),
                               device=DEV)[None] for n in lens]

    def prefill_rows(m, masks):
        cache = m.init_cache(len(lens), max_seq, DEV)
        out = []
        for i, toks in enumerate(prompts):
            g = int(idx[i])
            lg, c1 = m.prefill(engine.base,
                               {"adapters": tree_map(lambda t: t[g], stacks)},
                               tree_map(lambda t: t[g], masks), toks,
                               m.init_cache(1, max_seq, DEV))
            for dst, src in zip(cache["dec"]["layers"], c1["dec"]["layers"]):
                dst["k"][i] = src["k"][0]
                dst["v"][i] = src["v"][0]
            cache["pos"][i] = toks.shape[1]
            out.append(lg[0])
        return torch.stack(out), cache

    lk, ck = prefill_rows(model, smasks)
    lp, cp = prefill_rows(plain, smasks)
    bare, _ = prefill_rows(model, tree_map(torch.zeros_like, smasks))
    err = (lk - bare).abs().amax(-1) / lk.abs().amax(-1)
    share = err.min().item()
    rels, agree = [], []
    for step in range(4):
        if not bool(torch.isfinite(lk).all()) \
                or lk.shape != (len(lens), cfg.vocab_size):
            raise AssertionError(f"step {step}: non-finite or misshapen logits")
        rels.append(row_rel(lk, lp))
        agree.append(bool((lk.argmax(-1) == lp.argmax(-1)).all()))
        if step == 3:
            break
        nxt = lk.argmax(-1)
        lk = model.decode_rows(engine.base, stacks, smasks, idx, nxt, ck, rows)
        lp = plain.decode_rows(engine.base, stacks, smasks, idx, nxt, cp, rows)
    torch.cuda.synchronize()
    worst = max(rels)
    emit({"phase": "path", "rows": len(lens), "tenants": 2,
          "idx": idx.tolist(), "prompt_lens": list(lens), "decode_steps": 3,
          "max_rel_diff_per_step": rels, "argmax_agree": agree,
          "tol": PATH_TOL, "e_scale": E_SCALE,
          "adapter_share_min": share,
          "adapter_share_required": ADAPTER_SHARE_MIN})
    if worst > PATH_TOL:
        raise AssertionError(f"whole path: kernels vs plain {worst} > "
                             f"{PATH_TOL}")
    if share < ADAPTER_SHARE_MIN:
        raise AssertionError(f"whole path: the adapters move the logits by "
                             f"{share} < {ADAPTER_SHARE_MIN}, too little for "
                             f"the check to see a dropped adapter")


# ------------------------------------------------ phase 5b: legacy serve --

LEGACY_REQUESTS = 4           # the static-batch loop's batch
LEGACY_PROMPT = 128           # prompt tokens (BART's source: twice that)
LEGACY_GEN = 16               # new tokens a request
# exactly this many bea_batched launches a decode step: 7 a layer × 24
# (InternVL2-1B); self q/k/v/o, cross q/o, fc1, fc2 × 6 decoder layers
# (BART-base: the cross k/v are read from the cache, not projected)
LEGACY_DECODE_LAUNCHES = {"internvl2_1b": 168, "bart": 48}
# and a prefill's: bea_dense per adapted linear, flash per attention call
# (BART: 6 encoder layers' 6 and 1, 6 decoder layers' 10 and 2)
LEGACY_PREFILL_LAUNCHES = {
    "internvl2_1b": {"bea_dense": 168, "flash_attention": 24},
    "bart": {"bea_dense": 96, "flash_attention": 18}}


def legacy_serve(torch, own: frozenset):
    """Phase 5b: the static-batch loop (``launch/serve.py``'s
    ``legacy_static_batch``, the serving path of encoder-decoder and
    vision models) at full width: InternVL2-1B in bf16 (4 requests of 256
    patch embeddings and 128 prompt tokens) and BART-base in f32 (4
    requests of 128 prompt tokens over a 256-token source), 16 new tokens
    each.  Each model runs once through the kernels (the counts zeroed just
    before, read just after) and once through the plain versions on the same
    weights, teacher-forced on the kernel run's tokens.  The tenant's E is
    drawn as phase 5's (``make_tenants`` × E_SCALE), with its top rank
    pruned.  Gates: prefill's and every decode step's logits within
    BF16_TOL / F32_TOL of plain, per row; the adapters' share of the
    logits (the same run with every rank masked off) at least twice that;
    prefill launches LEGACY_PREFILL_LAUNCHES, each decode step exactly
    LEGACY_DECODE_LAUNCHES ``bea_batched`` and no flash, and in the
    profile of a decode step exactly that many calls of the type's
    ``bea_batched`` kernel function and no other of ``own`` (the port's
    kernel functions, from phase 2's SASS); finite logits of the
    vocabulary's width.  Prefill ms and decode ms a step are timed on
    CUDA events, on the host wall and under the profiler.  Returns each
    kernel's launches in the two kernel runs, and the launches by model."""
    import argparse
    import contextlib
    import io

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (legacy_static_batch, make_tenants,
                                          static_batch_inputs)
    from repro_torch.models import Model
    from repro_torch.pytree import tree_map

    args = argparse.Namespace(batch=LEGACY_REQUESTS, prompt_len=LEGACY_PROMPT,
                              gen=LEGACY_GEN, device=DEV)
    total, by_model = {}, {}
    for arch in ("internvl2_1b", "bart"):
        cfg = get_config(arch)
        bf16 = cfg.cdtype == torch.bfloat16
        tol = BF16_TOL if bf16 else F32_TOL
        model = Model(cfg, peft="bea")
        base = model.init(SEED, DEV)[0]
        spec = make_tenants(model, cfg, 1, ranks=[cfg.adapter_rank],
                            seed=SEED + 1, device=DEV)["client0"]
        tr, masks = scale_e(spec["trainable"], E_SCALE), spec["masks"]
        params = (base, tr, masks)
        torch.cuda.reset_peak_memory_stats()
        with contextlib.redirect_stdout(io.StringIO()):
            K.reset_launches()
            kern = legacy_static_batch(cfg, args, params=params)
            torch.cuda.synchronize()
            launches = K.launch_counts()
            plain = legacy_static_batch(cfg, args, params=params,
                                        use_kernels=False,
                                        force=kern["tokens"])
            bare = legacy_static_batch(
                cfg, args, params=(base, tr, tree_map(torch.zeros_like,
                                                      masks)),
                force=kern["tokens"])
        peak = torch.cuda.max_memory_allocated()
        rels = [row_rel(a, b) for a, b in zip(kern["logits"],
                                              plain["logits"])]
        share = min(((a - b).float().abs().amax(-1)
                     / a.float().abs().amax(-1)).min().item()
                    for a, b in zip(kern["logits"], bare["logits"]))
        agree = [bool((a.argmax(-1) == b.argmax(-1)).all())
                 for a, b in zip(kern["logits"], plain["logits"])]
        finite = all(bool(torch.isfinite(t).all())
                     and t.shape == (LEGACY_REQUESTS, cfg.vocab_size)
                     for t in kern["logits"])
        steps = LEGACY_GEN - 1
        want = {**LEGACY_PREFILL_LAUNCHES[arch],
                "bea_batched": LEGACY_DECODE_LAUNCHES[arch] * steps}

        # timings: a prefill on a fresh cache, and one decode step from the
        # prefilled cache (its position reset each call)
        batch = static_batch_inputs(cfg, LEGACY_REQUESTS, LEGACY_PROMPT, DEV)
        n_prefix = cfg.n_prefix_embeds if cfg.modality == "vision" else 0
        src = 2 * LEGACY_PROMPT if cfg.is_encoder_decoder else 0
        t_max = n_prefix + LEGACY_PROMPT + LEGACY_GEN
        filled = {}

        def prefill():
            cache = model.init_cache(LEGACY_REQUESTS, t_max, DEV,
                                     src_len=src)
            with torch.no_grad():
                filled["cache"] = model.prefill(base, tr, masks, batch,
                                                cache)[1]

        tok = kern["tokens"][:, :1]

        def decode():
            cache = filled["cache"]
            cache["pos"].fill_(n_prefix + LEGACY_PROMPT)
            with torch.no_grad():
                model.decode_step(base, tr, masks, tok, cache)

        pre_t = profile_step(torch, prefill, n_steps=3, top=6)
        K.reset_launches()
        decode()
        torch.cuda.synchronize()
        one_step = K.launch_counts()
        # the decode step's bea_batched kernel: mma_kernel (bf16; no other
        # library launches in a decode step) or fma_kernel (f32)
        dec_t = profile_step(torch, decode, n_steps=5, top=6,
                             match="mma_kernel" if bf16 else "fma_kernel",
                             own=own)
        out = {"phase": "legacy", "model": cfg.name,
               "dtype": str(cfg.cdtype).split(".")[1],
               "requests": LEGACY_REQUESTS, "prefix_rows": n_prefix,
               "prompt_tokens": LEGACY_PROMPT, "source_tokens": src,
               "new_tokens": LEGACY_GEN, "cache_positions": t_max,
               "tokens_first_request": kern["tokens"][0].tolist(),
               "max_rel_diff_per_step": rels, "argmax_agree": agree,
               "tol": tol, "e_scale": E_SCALE, "adapter_share_min": share,
               "adapter_share_required": 2 * tol,
               "launches": launches, "expected_launches": want,
               "one_decode_step_launches": one_step,
               "loop_prefill_host_ms": 1e3 * kern["prefill_s"],
               "loop_decode_host_ms_per_token":
                   1e3 * kern["decode_s"] / steps,
               "prefill": pre_t, "decode_step": dec_t,
               "decode_tokens_per_s": LEGACY_REQUESTS
               / (dec_t["step_host_wall_ms"] / 1e3),
               "peak_mem_bytes": peak, "nvidia_smi": nvidia_smi()}
        emit(out)
        if not finite:
            raise AssertionError(f"{cfg.name} loop: non-finite or misshapen "
                                 f"logits")
        if max(rels) > tol:
            raise AssertionError(f"{cfg.name} loop: kernels vs plain "
                                 f"{max(rels)} > {tol}")
        if share < 2 * tol:
            raise AssertionError(f"{cfg.name} loop: the adapters move the "
                                 f"logits by {share} < {2 * tol}")
        if any(launches[k] != n for k, n in want.items()) \
                or one_step["bea_batched"] != LEGACY_DECODE_LAUNCHES[arch] \
                or one_step["flash_attention"] or one_step["bea_dense"]:
            raise AssertionError(f"{cfg.name} loop launched {launches} "
                                 f"(one decode step {one_step}), expected "
                                 f"{want}")
        # one kernel function a bea_batched call and no other of the port's
        # kernels in the step: no second pass (a reduce or an epilogue)
        if dec_t["matched"]["own_functions_ran"] != {
                dec_t["matched"]["name"]: LEGACY_DECODE_LAUNCHES[arch]}:
            raise AssertionError(f"{cfg.name} decode step: the profile shows "
                                 f"{dec_t['matched']}, not one kernel for "
                                 f"each of {LEGACY_DECODE_LAUNCHES[arch]} "
                                 f"bea_batched calls and nothing else of "
                                 f"the port's")
        by_model[arch] = launches
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        del model, base, tr, masks, params, kern, plain, bare, filled
        gc.collect()
        torch.cuda.empty_cache()
    return total, by_model


# ---------------------------------------------------------- phase 6: train --

TRAIN_STEP_TOL = 1e-5        # loss, kernels vs plain, one full-width step
TRAIN_GRAD_TOL = 1e-3        # each grad vs its largest |plain| value
TRAIN_LOSS_RTOL = 1e-3       # per-round losses of the two federated runs


def check_train_kernels(torch, cfg):
    """The f32 instances at the training path's shapes against their plain
    versions: ``bea_dense`` for every adapted linear of a DistilBERT-base
    layer (BART-base's (K, N) too), r = 12 with one rank masked and a
    fully masked adapter, at M = 256 and 1024 rows (8 × 32 and 8 × 128
    tokens) and at BART's phase-11 rows, M = 2048 (8 × 256, where the
    plan splits K over 128-row tiles) and 3072 (the step check's encoder,
    8 × 384); non-causal flash at B = 8, S = 32, 100 and 128 and BART's
    cross-attention, Sq = 256 over Sk = 384, 12 heads of 64; each output's
    bias against float64 within F32_BIAS_TOL; at M = 1024, 2048 and 3072
    and at S = 128, two calls bitwise equal and a CUDA-graph replay equal
    to the eager call."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bea_fused import bea_dense, plan
    from repro_torch.kernels.flash_attention import mha_flash

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    d, f, r = cfg.d_model, cfg.d_ff, cfg.adapter_rank
    s = cfg.adapter_alpha / r
    worst = {}

    def record(name, err, rel):
        if rel > F32_TOL:
            raise AssertionError(f"{name} f32: relative error {rel} > "
                                 f"{F32_TOL}")
        w = worst.setdefault(name, [0.0, 0.0])
        w[0], w[1] = max(w[0], err), max(w[1], rel)
        return err, rel

    repeat, biased = {}, []
    for m in (256, 1024, 2048, 3072):
        for k, n in ((d, d), (d, f), (f, d)):
            x, w = rnd(m, k), rnd(k, n, scale=k ** -0.5)
            a, b, e = rnd(r, k, scale=k ** -0.5), rnd(n, r), rnd(r)
            mk = torch.ones(r, dtype=torch.bool, device=dev)
            mk[r // 2] = False
            err, rel = record("bea_dense", *rel_err(
                bea_dense(x, w, a, b, e, mk, s),
                ref.bea_dense_ref(x, w, a, b, e, mk, s)))
            err0, rel0 = record("bea_dense", *rel_err(
                bea_dense(x, w, a, b, e, torch.zeros_like(mk), s), x @ w))
            # a sum that shrinks or grows as a whole (the tensor cores'
            # truncating accumulation did, by 1.9e-5 at K = 3072) stays
            # within F32_TOL of each value but compounds over layers
            y, t = bea_dense(x, w, a, b, e, mk, s).double(), ref.bea_dense_ref(
                *(v.double() for v in (x, w, a, b, e)), mk, s)
            bias = ((y * t).sum() / (t * t).sum() - 1.0).item()
            emit({"phase": "train", "kernel": "bea_dense", "dtype": "float32",
                  "m": m, "k": k, "n": n, "r": r, "masked_rank": r // 2,
                  "plan": plan(m, k, n, torch.float32)._asdict(),
                  "max_abs_err": err, "rel_err": rel,
                  "fully_masked_rel_err": rel0, "tol": F32_TOL,
                  "bias_vs_f64": bias, "bias_tol": F32_BIAS_TOL})
            if abs(bias) > F32_BIAS_TOL:
                biased.append((f"bea_dense {m}x{k}x{n}", bias))
            if m >= 1024:
                repeat[f"bea_dense {m}x{k}x{n}"] = repeatable(
                    torch, lambda ops=(x, w, a, b, e, mk): bea_dense(*ops, s))
    h, hd = cfg.n_heads, cfg.head_dim
    for sq, sk in ((32, 32), (100, 100), (256, 384), (128, 128)):
        q, k, v = rnd(8, sq, h, hd), rnd(8, sk, h, hd), rnd(8, sk, h, hd)
        got = mha_flash(q, k, v, causal=False)
        err, rel = record("flash_attention", *rel_err(
            got, ref.flash_attention_ref(q, k, v, causal=False)))
        t = ref.flash_attention_ref(q.double(), k.double(), v.double(),
                                    causal=False)
        bias = ((got.double() * t).sum() / (t * t).sum() - 1.0).item()
        emit({"phase": "train", "kernel": "flash_attention",
              "dtype": "float32", "causal": False, "b": 8, "s": sq, "sk": sk,
              "h": h, "hd": hd, "max_abs_err": err, "rel_err": rel,
              "tol": F32_TOL, "bias_vs_f64": bias, "bias_tol": F32_BIAS_TOL})
        if abs(bias) > F32_BIAS_TOL:
            biased.append((f"flash {sq}x{sk}", bias))
    if biased:
        raise AssertionError(f"f32 outputs biased against float64 by more "
                             f"than {F32_BIAS_TOL}: {biased}")
    repeat["flash_attention"] = repeatable(
        torch, lambda: mha_flash(q, k, v, causal=False))
    emit({"phase": "train", "check": "two calls bitwise equal, CUDA-graph "
          "replay equal to the eager call", "results": repeat})
    bad = [name for name, ok in repeat.items() if not all(ok.values())]
    if bad:
        raise AssertionError(f"not repeatable or not graph-safe: {bad}")
    torch.cuda.synchronize()
    return worst


def time_train_kernels(torch, cfg):
    """f32 times at the training shapes: ``bea_dense`` per linear and per
    layer's 6 linears at M = 1024 (8 × 128 tokens), r = 12, cycling 2
    layers' weights (57 MB, more than the 50 MB L2); non-causal flash per
    call at B = 8, S = 128 (the mean of a forward's 6 calls in one graph)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import mha_flash

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    d, f, r, m = cfg.d_model, cfg.d_ff, cfg.adapter_rank, 1024
    s = cfg.adapter_alpha / r
    kns = [(d, d)] * 4 + [(d, f), (f, d)]
    layers = [[(rnd(k, n, scale=k ** -0.5), rnd(r, k, scale=k ** -0.5),
                rnd(n, r), rnd(r), torch.ones(r, dtype=torch.bool,
                                              device=dev)) for k, n in kns]
              for _ in range(2)]
    dense_t, per_linear = time_dense_layer(
        torch, layers, {k: rnd(m, k) for k in (d, f)}, s,
        (("wq/wk/wv/wo", 0), ("w1", 4), ("w2", 5)),
        f"6 linears of one layer, M={m}, r={r}, f32")
    emit({"phase": "train", "timing": "bea_dense", "m": m, "r": r,
          "per_layer": dense_t, "per_linear": per_linear})

    h, hd, b_, sq = cfg.n_heads, cfg.head_dim, 8, 128
    q, k, v = rnd(b_, sq, h, hd), rnd(b_, sq, h, hd), rnd(b_, sq, h, hd)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    nbytes = 4 * 4 * b_ * sq * h * hd
    flops = 4 * hd * sq * sq * h * b_

    def per_call(fn, n=cfg.n_layers):
        return time_ms(torch, lambda: [fn() for _ in range(n)]) / n

    flash_t = {
        "ms": per_call(lambda: mha_flash(q, k, v, causal=False)),
        "plain_ms": per_call(lambda: ref.flash_attention_ref(
            q, k, v, causal=False)),
        "library_ms": per_call(lambda: F.scaled_dot_product_attention(
            qt, kt, vt)),
        **f32_bounds(nbytes, flops),
        "shape": f"one call (mean of {cfg.n_layers} in one graph), B={b_}, "
                 f"S={sq}, {h} heads of {hd}, non-causal, f32"}
    emit({"phase": "train", "timing": "flash_attention", **flash_t})
    return {"bea_dense": dense_t, "flash_attention": flash_t}


def train_step_check(torch, cfg, peft: str = "bea",
                     train_base: bool = False):
    """One full-width training step (8 × 128 tokens) through the kernels and
    through the plain versions on the same weights and batch: the loss
    within TRAIN_STEP_TOL relative, every trainable grad (and with
    ``train_base``, SLoRA's stage 1, every base grad) within TRAIN_GRAD_TOL
    of its largest |plain| value, and the forward launching ``bea_dense``
    once per adapted linear and flash once per layer."""
    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.models import Model
    from repro_torch.pytree import flatten_with_paths, tree_map

    kern = Model(cfg, peft=peft)
    plain = Model(cfg, peft=peft, use_kernels=False)
    base, tr = kern.init(SEED, DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 5)
    # E (B for LoRA) off its zero init, so the adapter term and its grads
    # are not zero
    tr = tree_map(lambda t: t + 0.1 * torch.randn(
        t.shape, generator=gen, device=DEV), tr)
    masks = None
    if peft == "bea":
        masks = kern.init_masks(DEV)
        masks["dec"]["layers"][0]["attn"]["wq"][3] = False
        masks["dec"]["layers"][-1]["mlp"]["w2"][:] = False
    rng = np.random.default_rng(SEED + 5)
    batch = {"tokens": torch.as_tensor(rng.integers(
                 0, cfg.vocab_size, (8, 128)), device=DEV),
             "labels": torch.as_tensor(rng.integers(0, cfg.n_classes, 8),
                                       device=DEV)}

    def step(model):
        flat = []

        def leaf(t):
            flat.append(t.detach().requires_grad_(True))
            return flat[-1]

        req = {"trainable": tree_map(leaf, tr),
               "base": tree_map(leaf, base) if train_base else base}
        K.reset_launches()
        loss, _ = model.cls_loss(req["base"], req["trainable"], masks, batch)
        fwd = K.launch_counts()
        got = iter(torch.autograd.grad(loss, flat))
        grads = tree_map(lambda _: next(got),
                         req if train_base else req["trainable"])
        bwd = {k: v - fwd[k] for k, v in K.launch_counts().items()}
        return loss.item(), grads, fwd, bwd

    lk, gk, fk, bk = step(kern)
    lp, gp, fp, _ = step(plain)
    loss_rel = abs(lk - lp) / abs(lp)
    worst_path, worst = "", 0.0
    for (path, a), (_, b) in zip(flatten_with_paths(gk),
                                 flatten_with_paths(gp)):
        rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        if rel > worst:
            worst_path, worst = path, rel
    n_lin = 6 * cfg.n_layers
    emit({"phase": "baselines" if train_base else "train",
          "check": "one full-width step, kernels vs plain"
          + (", base trained (SLoRA stage 1)" if train_base else ""),
          "model": cfg.name, "peft": peft, "grads_compared":
          len(flatten_with_paths(gk)),
          "loss_kernels": lk, "loss_plain": lp, "loss_rel_diff": loss_rel,
          "loss_tol": TRAIN_STEP_TOL, "worst_grad_rel": worst,
          "worst_grad_leaf": worst_path, "grad_tol": TRAIN_GRAD_TOL,
          "forward_launches": fk, "backward_launches": bk,
          "plain_launches": fp})
    if loss_rel > TRAIN_STEP_TOL:
        raise AssertionError(f"train step: loss differs by {loss_rel}")
    if worst > TRAIN_GRAD_TOL:
        raise AssertionError(f"train step: grad {worst_path} differs by "
                             f"{worst}")
    if fk["bea_dense"] != n_lin or fk["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"train step forward launched {fk}, expected "
                             f"{n_lin} bea_dense and {cfg.n_layers} flash")
    if any(fp.values()):
        raise AssertionError(f"the plain step launched kernels: {fp}")


def federated(torch, cfg):
    """The FedARA run at full width, twice from the same initial weights:
    through the kernels (the main path: counts zeroed just before it, read
    just after) and through the plain versions.  Rounds must agree in bytes,
    live ranks and dead modules exactly and in loss within TRAIN_LOSS_RTOL;
    then one training step is timed on the card and on the host clock and
    profiled."""
    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.core.fedara import FedARA
    from repro_torch.data.synthetic import batches, make_classification
    from repro_torch.federated import client as CL
    from repro_torch.federated.partition import dirichlet_partition
    from repro_torch.federated.server import FedConfig, run_federated
    from repro_torch.models import Model
    from repro_torch.optim import adam, linear_decay
    from repro_torch.pytree import tree_map

    train = make_classification(600, cfg.n_classes, cfg.vocab_size, 128,
                                seed=1)
    test = make_classification(200, cfg.n_classes, cfg.vocab_size, 128,
                               seed=2)
    parts = dirichlet_partition(train.labels, 10, alpha=0.1, seed=0)
    fc = FedConfig(rounds=3, clients_per_round=2, batch_size=8,
                   max_local_batches=4, eval_every=3, eval_batches=4)
    kern = Model(cfg, peft="bea")
    params = kern.init(SEED, DEV)
    n_ranks = 6 * cfg.n_layers * cfg.adapter_rank

    def run(model):
        """One run → (history, per-round wall s, per-round [training steps,
        eval batches]), the steps counted as the forwards that ran with and
        without grad."""
        strat = FedARA(total_rounds=3, warmup_rounds=1,
                       final_rounds_frac=0.34)
        stamps, fwds = [time.perf_counter()], [[0, 0]]
        fwd = model._forward

        def forward(*a, **kw):
            fwds[-1][0 if torch.is_grad_enabled() else 1] += 1
            return fwd(*a, **kw)

        def on_round(*_):
            stamps.append(time.perf_counter())
            fwds.append([0, 0])

        model._forward = forward
        h = run_federated(model, strat, parts, train, test, fc,
                          on_round=on_round, device=DEV, params=params)
        return h, [b - a for a, b in zip(stamps, stamps[1:])], fwds[:-1]

    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    hk, round_s, fwds = run(kern)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hp, plain_round_s, plain_fwds = run(
        Model(cfg, peft="bea", use_kernels=False))
    if fwds != plain_fwds:
        raise AssertionError(f"forwards per round: kernels {fwds} vs plain "
                             f"{plain_fwds}")
    n_fwd = sum(map(sum, fwds))
    per_fwd = {"bea_dense": 6 * cfg.n_layers, "flash_attention": cfg.n_layers}
    for k, n in per_fwd.items():
        if launches[k] != n * n_fwd:
            raise AssertionError(f"{k}: {launches[k]} launches in the run's "
                                 f"{n_fwd} forwards, not {n} each")
    rounds = []
    for a, b in zip(hk["rounds"], hp["rounds"]):
        rounds.append({"rnd": a.rnd, "down_bytes": a.down_bytes,
                       "up_bytes": a.up_bytes, "live_ranks": a.live_ranks,
                       "dead_modules": a.dead_modules, "loss": a.loss,
                       "plain_loss": b.loss, "acc": a.acc,
                       "plain_acc": b.acc, "sim_time_s": a.sim_time_s,
                       "train_steps": fwds[a.rnd][0],
                       "eval_batches": fwds[a.rnd][1],
                       "wall_s": round_s[a.rnd]})
        same = (a.down_bytes, a.up_bytes, a.live_ranks, a.dead_modules) == \
            (b.down_bytes, b.up_bytes, b.live_ranks, b.dead_modules)
        if not same or abs(a.loss - b.loss) > TRAIN_LOSS_RTOL * abs(b.loss):
            raise AssertionError(f"federated round {a.rnd}: kernels {a} vs "
                                 f"plain {b}")
    n_eval = fc.eval_batches * fc.batch_size
    if hk["rounds"][-1].live_ranks >= n_ranks:
        raise AssertionError("FedARA pruned no rank by the last round")
    if abs(hk["final_acc"] - hp["final_acc"]) > 1 / n_eval + 1e-12:
        raise AssertionError(f"final accuracy {hk['final_acc']} vs plain "
                             f"{hp['final_acc']}")

    # one training step of the kernel run's shape, outside the run
    base, trainable = params
    masks = tree_map(lambda m: torch.as_tensor(m, device=DEV), hk["masks"])
    gate = FedARA(total_rounds=3).optimizer_gate(trainable, hk["masks"])
    opt = adam(linear_decay(fc.lr, 12))
    step = CL.make_train_step(kern, opt)
    batch = CL.device_batch(
        next(batches(train, 8, np.random.default_rng(0))), DEV)
    state = opt.init(trainable)
    out = {"phase": "train", "model": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "clients": len(parts),
           "clients_per_round": fc.clients_per_round,
           "local_steps": fc.max_local_batches, "batch": [8, 128],
           "rounds": rounds, "final_acc": hk["final_acc"],
           "plain_final_acc": hp["final_acc"], "round_wall_s": round_s,
           "plain_round_wall_s": plain_round_s, "wall_s": hk["wall_s"],
           "plain_wall_s": hp["wall_s"], "comm_gb": hk["comm_gb"],
           "launches_federated_run": launches, "forwards": n_fwd,
           "launches_per_forward": {k: launches[k] / n_fwd for k in per_fwd},
           "peak_mem_bytes": peak,
           **profile_step(torch, lambda: step(base, trainable, state, masks,
                                               gate, batch))}
    emit(out)
    return launches, out["launches_per_forward"], \
        [r["up_bytes"] // fc.clients_per_round for r in rounds]


class KernelTotal(NamedTuple):
    key: str
    count: int
    self_device_time_total: float       # µs


def device_kernels(prof) -> list:
    """Each kernel (and copy) the profiler saw on the card: its calls and
    device µs, summed from the profiler's raw Kineto events, the events
    that ``key_averages()``'s CUDA entries total, without building its
    event tree: that took phase 4 about two minutes of host time for a
    7-second serving run."""
    from torch.autograd import DeviceType

    tot = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            c = tot.setdefault(e.name(), [0, 0.0])
            c[0] += 1
            c[1] += e.duration_ns() / 1e3
    return [KernelTotal(k, n, us) for k, (n, us) in tot.items()]


def kernel_function(name: str) -> str:
    """A profiled kernel's function name without its return type, the
    anonymous namespace, template arguments and parameters:
    ``fma_kernel`` for ``void (anonymous namespace)::fma_kernel<4, 1,
    32>(...)``, as ``short_name`` cuts the library's SASS names."""
    return re.split(r"[<(]", re.sub(r"^void |\(anonymous namespace\)::", "",
                                    name), maxsplit=1)[0]


def profile_step(torch, one, n_steps: int = 5, top: int = 10,
                 match: str | None = None,
                 own: frozenset = frozenset()) -> dict:
    """``one()`` (a training step) after two warm-up calls: its device time
    between two CUDA events, its host wall time, and the profiler's busy
    time, launches, idle share and ``top`` kernels, each per step; with
    ``match``, the calls, device ms and share of the busy time of the
    kernels of that function name (:func:`kernel_function`), their distinct
    names, and the calls a step of each function in ``own`` (the port's
    kernel functions) that ran."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        one()
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    for _ in range(n_steps):
        one()
    ev1.record()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            one()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kern_ev = device_kernels(prof)
    busy_us = sum(e.self_device_time_total for e in kern_ev)
    hot = sorted(kern_ev, key=lambda e: -e.self_device_time_total)[:top]
    out = {}
    if match is not None:
        hit = [e for e in kern_ev if kernel_function(e.key) == match]
        ran = {}
        for e in kern_ev:
            if kernel_function(e.key) in own:
                f = kernel_function(e.key)
                ran[f] = ran.get(f, 0) + e.count / n_steps
        out = {"matched": {
            "name": match, "calls": sum(e.count for e in hit) / n_steps,
            "device_ms": sum(e.self_device_time_total for e in hit)
            / 1e3 / n_steps,
            "share_of_busy": sum(e.self_device_time_total for e in hit)
            / max(busy_us, 1e-9),
            "functions": sorted({e.key[:80] for e in hit}),
            "own_functions_ran": ran}}
    return {**out, "step_device_ms_events": ev0.elapsed_time(ev1) / n_steps,
            "step_host_wall_ms": host_ms,
            "step_device_busy_ms": busy_us / 1e3 / n_steps,
            "step_device_kernel_launches": sum(e.count for e in kern_ev)
            / n_steps,
            "step_device_idle_share": 1.0 - busy_us / 1e6 / prof_wall,
            "step_top_kernels": [{"name": e.key[:60],
                                  "calls": e.count / n_steps,
                                  "device_ms": e.self_device_time_total
                                  / 1e3 / n_steps} for e in hot]}


def train(torch, cfg):
    """Phase 6: the training path (full-width DistilBERT-base in ``main``).
    Returns the kernels' training rows and the FedARA run's per-client
    upload bytes per round (the identity wire, for phase 8)."""
    worst = check_train_kernels(torch, cfg)
    times = time_train_kernels(torch, cfg)
    train_step_check(torch, cfg)
    launches, per_fwd, identity_up = federated(torch, cfg)
    return {k: {**times[k], "launches": launches[k],
                "launches_per_forward": per_fwd[k],
                "max_abs_err": worst[k][0], "max_rel_err": worst[k][1]}
            for k in ("bea_dense", "flash_attention")}, identity_up


# ------------------------------------------------------ phase 7: baselines --

BASELINE_LAYERS = 6          # phase 7's depth, of BERT-base's 12
BASELINES = ("fedlora", "fedadapter_h", "fedadapter_p", "slora", "federa",
             "ffa_lora", "ffa_lora_dr", "fedsvd")
FEDERA_RTOL, FEDERA_ATOL = 1e-3, 1e-4    # W' + s·(B·A)ᵀ against W, as
                                         # tests/test_system.py checks it


def baseline_run(torch, cfg, name, data, params, use_kernels: bool):
    """One federated run of baseline ``name`` from ``params`` → (history,
    record): forwards with and without grad per round, the post_init
    output, and host-clock marks at the end of post_init, at the SVD init
    that ends SLoRA's stage 1, and at every main round."""
    from repro_torch.federated import baselines as BL
    from repro_torch.federated.server import run_federated
    from repro_torch.models import Model

    fc = data["fc"][name]
    strat = BL.all_strategies(fc.rounds)[name]
    model = Model(cfg.with_(adapter_rank=strat.init_rank(cfg)),
                  peft=strat.peft, use_kernels=use_kernels)
    rec = {"fwds": [[0, 0]], "marks": {}, "round_marks": []}
    fwd, post = model._forward, strat.post_init

    def forward(*a, **kw):
        rec["fwds"][-1][0 if torch.is_grad_enabled() else 1] += 1
        return fwd(*a, **kw)

    def post_init(*a):
        rec["post_init"] = post(*a)
        rec["marks"]["post_init"] = time.perf_counter()
        return rec["post_init"]

    def on_round(*_):
        rec["round_marks"].append(time.perf_counter())
        rec["fwds"].append([0, 0])

    model._forward, strat.post_init = forward, post_init
    if hasattr(strat, "svd_init_from_delta"):
        svd = strat.svd_init_from_delta

        def svd_init(*a):
            rec["marks"]["stage1"] = time.perf_counter()
            out = svd(*a)
            rec["marks"]["svd_init"] = time.perf_counter()
            _, base0, base1, _ = a      # for svd_init_gap, kept on the
            rec["svd_init"] = {         # host: off the phase's peak memory
                p: tuple(t.cpu() for t in (
                    BL._find_base_weight(base1, p).float()
                    - BL._find_base_weight(base0, p).float(), m["A"],
                    m["B"]))
                for p, m in BL._iter_adapter_modules(out["adapters"])}
            return out

        strat.svd_init_from_delta = svd_init
    rec["marks"]["start"] = time.perf_counter()
    h = run_federated(model, strat, data["parts"], data["train"],
                      data["test"], fc, on_round=on_round, device=DEV,
                      params=params)
    torch.cuda.synchronize()
    rec["fwds"] = rec["fwds"][:-1]
    return h, rec


def svd_init_gap(torch, rk, rp) -> dict:
    """How far SLoRA's SVD init of the kernel run lies from the plain run's,
    and why: per adapted module, the stage-1 delta's gap (largest, and the
    share of entries off by more than 1e-3 of the largest plain value), the
    spectral gap σ_r − σ_{r+1} of the plain delta beside the gap's 2-norm
    (Davis–Kahan: sin θ ≲ ‖E‖₂ / (σ_r − σ_{r+1})), the sine of the largest
    angle between the two left singular subspaces (A's rows are
    u_i·√σ_i up to one scale), and the gap of the rank-r product B·A.
    Reported, not gated: the losses' gate stands in ``baseline_checks``."""
    rows = []
    for path, got in rk["svd_init"].items():
        dk, ak, bk, dp, ap, bp = (t.to(DEV) for t in
                                  got + rp["svd_init"][path])
        e, r = dk - dp, ak.shape[0]
        top = dp.abs().max()
        sv = torch.linalg.svdvals(dp)
        qk = torch.nn.functional.normalize(ak, dim=1)
        qp = torch.nn.functional.normalize(ap, dim=1)
        cos = torch.linalg.svdvals(qk @ qp.T).min().clamp(max=1.0)
        pk, pp = bk @ ak, bp @ ap
        e2 = torch.linalg.matrix_norm(e, ord=2)
        gap = sv[r - 1] - sv[r] if sv.numel() > r else sv[r - 1]
        rows.append({"path": path,
                     "delta_gap": (e.abs().max() / top).item(),
                     "delta_share_off": ((e.abs() > 1e-3 * top).float()
                                         .mean().item()),
                     "e2_over_spectral_gap": (e2 / gap).item(),
                     "spectral_gap_of_s1": (gap / sv[0]).item(),
                     "sin_theta": (1 - cos * cos).clamp(min=0).sqrt().item(),
                     "product_gap": ((pk - pp).abs().max()
                                     / pp.abs().max()).item()})

    def med(k):
        return sorted(r[k] for r in rows)[len(rows) // 2]

    worst = max(rows, key=lambda r: r["product_gap"])
    return {"modules": len(rows),
            **{f"max_{k}": max(r[k] for r in rows) for k in
               ("delta_gap", "delta_share_off", "e2_over_spectral_gap",
                "sin_theta", "product_gap")},
            **{f"median_{k}": med(k) for k in
               ("delta_gap", "delta_share_off", "e2_over_spectral_gap",
                "spectral_gap_of_s1", "sin_theta", "product_gap")},
            "worst_product_gap_module": worst}


def baseline_checks(torch, cfg, name, params, hk, rk, hp, rp, launches,
                    plain_launches, fc) -> dict:
    """The gates of one baseline's kernel and plain runs (module docstring,
    phase 7); returns the strategy's line."""
    from repro_torch.federated import baselines as BL
    from repro_torch.models.blocks import BOTTLENECK_KINDS

    if rk["fwds"] != rp["fwds"]:
        raise AssertionError(f"{name}: forwards per round {rk['fwds']} vs "
                             f"plain {rp['fwds']}")
    n_fwd = sum(map(sum, rk["fwds"]))
    peft = BL.all_strategies()[name].peft
    per_fwd = {"bea_dense": 0 if peft in BOTTLENECK_KINDS
               else 6 * cfg.n_layers, "flash_attention": cfg.n_layers}
    for k, n in per_fwd.items():
        if launches[k] != n * n_fwd:
            raise AssertionError(f"{name}: {launches[k]} {k} launches in "
                                 f"{n_fwd} forwards, not {n} each")
    if any(plain_launches.values()):
        raise AssertionError(f"{name}: the plain run launched kernels: "
                             f"{plain_launches}")
    rounds = []
    for a, b in zip(hk["rounds"], hp["rounds"]):
        rounds.append({"rnd": a.rnd, "down_bytes": a.down_bytes,
                       "up_bytes": a.up_bytes,
                       "trainable_params": a.trainable_params,
                       "loss": a.loss, "plain_loss": b.loss, "acc": a.acc,
                       "plain_acc": b.acc, "sim_time_s": a.sim_time_s})
        same = (a.rnd, a.down_bytes, a.up_bytes, a.live_ranks,
                a.dead_modules, a.trainable_params, a.sim_time_s) == \
            (b.rnd, b.down_bytes, b.up_bytes, b.live_ranks, b.dead_modules,
             b.trainable_params, b.sim_time_s)
        if a.rnd < (hp.get("stage1") or {}).get("rounds", 0):
            loss_ok = math.isnan(a.loss) and math.isnan(b.loss)
        else:
            loss_ok = math.isfinite(a.loss) and math.isfinite(b.loss) \
                and abs(a.loss - b.loss) <= TRAIN_LOSS_RTOL * abs(b.loss)
        if not same or not loss_ok:
            raise AssertionError(f"{name} round {a.rnd}: kernels {a} vs "
                                 f"plain {b}")
    n_eval = fc.eval_batches * fc.batch_size
    if len(hk["rounds"]) != fc.rounds or hk["comm_gb"] != hp["comm_gb"] \
            or hk.get("stage1") != hp.get("stage1") \
            or abs(hk["final_acc"] - hp["final_acc"]) > 1 / n_eval + 1e-12 \
            or not math.isfinite(hk["final_acc"]):
        raise AssertionError(
            f"{name}: rounds {len(hk['rounds'])}, comm_gb {hk['comm_gb']} "
            f"vs {hp['comm_gb']}, stage1 {hk.get('stage1')} vs "
            f"{hp.get('stage1')}, final acc {hk['final_acc']} vs "
            f"{hp['final_acc']}")
    extra = {}
    _, tr0 = rk["post_init"]
    if name.startswith("ffa_lora"):
        # A is frozen: every A of the run bitwise its post_init value
        mods = list(BL._iter_adapter_modules(tr0["adapters"]))
        after = dict(BL._iter_adapter_modules(hk["trainable"]["adapters"]))
        changed = [p for p, m in mods if not torch.equal(m["A"],
                                                         after[p]["A"])]
        if changed or not mods:
            raise AssertionError(f"{name}: A moved in {changed}")
        extra["frozen_a_modules"] = len(mods)
    if name == "federa":
        base0, (base1, _) = params[0], rk["post_init"]
        s = cfg.adapter_alpha / cfg.adapter_rank
        worst = 0.0
        for path, m in BL._iter_adapter_modules(tr0["adapters"]):
            w0 = BL._find_base_weight(base0, path)
            w1 = BL._find_base_weight(base1, path)
            err = (w1 + s * (m["A"].T @ m["B"].T) - w0).abs()
            worst = max(worst, (err / (FEDERA_ATOL + FEDERA_RTOL
                                       * w0.abs())).max().item())
        if worst > 1.0:
            raise AssertionError(f"federa: W' + s·(B·A)ᵀ misses W by "
                                 f"{worst} × the tolerance")
        extra["residual_worst_of_tol"] = worst
    if name == "slora":
        extra["svd_init_gap"] = svd_init_gap(torch, rk, rp)

    def walls(rec):
        m = rec["marks"]
        t = m.get("svd_init", m["post_init"])
        out = {"post_init_s": m["post_init"] - m["start"]}
        if "stage1" in m:
            out["stage1_s"] = m["stage1"] - m["post_init"]
            out["svd_init_s"] = m["svd_init"] - m["stage1"]
        out["round_wall_s"] = [b - a for a, b in
                               zip([t] + rec["round_marks"],
                                   rec["round_marks"])]
        return out

    return {"phase": "baselines", "strategy": name, "peft": peft,
            "rounds": rounds, "forwards": rk["fwds"],
            "launches": launches, "launches_per_forward":
            {k: launches[k] / n_fwd for k in per_fwd},
            "comm_gb": hk["comm_gb"],
            "comm_bytes": sum(r["down_bytes"] + r["up_bytes"]
                              for r in rounds),
            "stage1": hk.get("stage1"), "final_acc": hk["final_acc"],
            "plain_final_acc": hp["final_acc"], "wall_s": hk["wall_s"],
            "plain_wall_s": hp["wall_s"], "host_s_kernel_run": walls(rk),
            "host_s_plain_run": walls(rp), **extra}


def baselines(torch, cfg):
    """Phase 7: every baseline (module docstring) on ``cfg`` (full-width
    BERT-base at BASELINE_LAYERS layers in ``main``), each run through the
    kernels (counts zeroed just before, read just after) and through the
    plain versions from the same seed-0 weights; one SLoRA stage-1 step
    kernels vs plain; a FedLoRA step and a stage-1 step timed and
    profiled; the phase's peak memory.
    Returns the kernel runs' launches summed and per forward by strategy."""
    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.data.synthetic import batches, make_classification
    from repro_torch.federated import client as CL
    from repro_torch.federated.baselines import SLoRA, all_strategies
    from repro_torch.federated.partition import dirichlet_partition
    from repro_torch.federated.server import FedConfig
    from repro_torch.models import Model
    from repro_torch.optim import adam, linear_decay

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    train = make_classification(600, cfg.n_classes, cfg.vocab_size, 128,
                                seed=1)
    test = make_classification(200, cfg.n_classes, cfg.vocab_size, 128,
                               seed=2)

    def fc_for(name):
        rounds = 3 if name == "slora" else 2     # SLoRA: 1 stage-1 round
        return FedConfig(rounds=rounds, clients_per_round=2, batch_size=8,
                         max_local_batches=2, eval_every=rounds,
                         eval_batches=2, device_profile="bert")

    data = {"train": train, "test": test,
            "parts": dirichlet_partition(train.labels, 10, alpha=0.1,
                                         seed=0),
            "fc": {name: fc_for(name) for name in BASELINES}}
    totals = dict.fromkeys(K.launch_counts(), 0)
    per_forward = {}
    for name in BASELINES:
        strat = all_strategies()[name]
        params = Model(cfg.with_(adapter_rank=strat.init_rank(cfg)),
                       peft=strat.peft).init(SEED, DEV)
        K.reset_launches()
        hk, rk = baseline_run(torch, cfg, name, data, params, True)
        launches = K.launch_counts()
        K.reset_launches()
        hp, rp = baseline_run(torch, cfg, name, data, params, False)
        line = baseline_checks(torch, cfg, name, params, hk, rk, hp, rp,
                               launches, K.launch_counts(),
                               data["fc"][name])
        emit(line)
        for k in totals:
            totals[k] += launches[k]
        per_forward[name] = line["launches_per_forward"]
        del hk, hp, rk, rp, params
        gc.collect()
    for k in ("bea_dense", "flash_attention"):
        if not totals[k]:
            raise AssertionError(f"phase 7 launched no {k}")

    train_step_check(torch, cfg, peft="lora", train_base=True)

    # a FedLoRA step and a stage-1 step (full fine-tuning + the gated base
    # update), timed and profiled outside the runs
    model = Model(cfg, peft="lora")
    base, tr = model.init(SEED, DEV)
    opt = adam(linear_decay(2e-3, 12))
    batch = CL.device_batch(
        next(batches(train, 8, np.random.default_rng(0))), DEV)
    step = CL.make_train_step(model, opt)
    s1_step = CL.make_train_step(model, opt, train_base=True)
    s1_update = CL.make_base_update_step(opt)
    gate = SLoRA().sparse_gate(base, SEED)
    st, st_b = opt.init(tr), opt.init(base)

    def stage1():
        _, _, _, gb, _, _ = s1_step(base, tr, st, None, None, batch)
        return s1_update(base, st_b, gb, gate)

    steps = {"fedlora": profile_step(
                 torch, lambda: step(base, tr, st, None, None, batch)),
             "slora_stage1": profile_step(torch, stage1)}
    emit({"phase": "baselines", "model": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "batch": [8, 128], "steps": steps,
          "launches_all_runs": totals,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "phase_seconds": time.perf_counter() - t0})
    return totals, per_forward


# ----------------------------------------------------------- phase 8: wire --

# Phase 8's runs, in order: the three unclipped codec runs first, since the
# DP clip C of the last two is a fraction (``clip_of_min_norm``) of the
# smallest update norm they show, so that every update clips.  The noise's
# std is z·C on every element of the summed wire (about 1M floats) against a
# clipped signal of norm C.  Measured on an NVIDIA H100 80GB HBM3 at 700 W:
# at C = half that norm (about 1.1) the z = 1 noise took both runs' losses
# to 8.2-8.7 and they parted, so run (a) clips at 1/200.  SLoRA's run (e) has no noise and clips at half the norm (its
# stage-1 uploads, about 5.4, clip too).  Its two runs cannot start stage 2
# from their own inits: signSGD turns each near-zero entry of the stage-1
# delta whose sign the two runs' rounding flips into a ±(block mean |x|)
# gap, and the rank-12 SVD of a sign-coded delta (a nearly flat spectrum)
# turns those into another subspace: unclipped, round 1's losses were 5.51
# and 5.26.  So the plain run takes the kernel run's stage-1 aggregate for
# its SVD init, and the two aggregates are compared entry by entry
WIRE_RUNS = {
    "b_powersgd": ("fedara", {"codec": "powersgd", "powersgd_rank": 2}),
    "c_int8": ("fedara", {"codec": "int8"}),
    "d_topk": ("fedara", {"codec": "topk"}),
    "a_signsgd_secagg_dp": ("fedara", {"codec": "signsgd", "secagg": "mask",
                                       "dp_noise_multiplier": 1.0,
                                       "clip_of_min_norm": 0.005}),
    "e_slora_signsgd_dp": ("slora", {"codec": "signsgd",
                                     "clip_of_min_norm": 0.5}),
}


def codec_bytes(codec: str, n: int, rank: int = 2) -> int:
    """A client's upload payload for an ``n``-float wire (header included,
    mask bitfield not): the codecs' byte formulas."""
    if codec == "signsgd":
        return -(-n // 8) + 4 * -(-n // 256) + 4
    if codec == "int8":
        return n + 4 * -(-n // 256) + 4
    if codec == "topk":
        return 8 * min(n, max(1, int(round(0.1 * n)))) + 4
    if codec == "powersgd":
        m = int(math.ceil(math.sqrt(n)))
        k = -(-n // m)
        return 4 * max(1, min(rank, m, k)) * (m + k) + 4
    raise ValueError(codec)


class WireProbe:
    """Times the host stages of each round of one run (broadcast, the
    device→host delta, encode, aggregate or aggregate_private), records
    every upload's wire length, bytes, pre-clip norm and clip flag, and
    checks every secure-aggregation round's field sum: the masked inputs'
    sum must decode to the plain field sum of the same payloads, bit for
    bit.  ``next_round`` (the run's ``on_round``, and SLoRA's SVD init after
    stage 1) closes a round's record."""

    STAGES = ("broadcast", "delta_tree", "encode", "aggregate",
              "aggregate_private")

    def __init__(self):
        self.rounds, self.marks = [], [time.perf_counter()]
        self.field_checks = []
        self._open()

    def _open(self):
        self.cur = {**{f"{s}_s": 0.0 for s in self.STAGES}, "uploads": []}

    def next_round(self, *_):
        self.marks.append(time.perf_counter())
        self.cur["wall_s"] = self.marks[-1] - self.marks[-2]
        self.rounds.append(self.cur)
        self._open()

    def _timed(self, stage, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.cur[f"{stage}_s"] += time.perf_counter() - t0
            if stage == "encode":
                self.cur["uploads"].append(
                    {"cid": out.cid, "n": int(out.wire.size),
                     "nbytes": out.nbytes, "norm": out.norm,
                     "clipped": out.clipped})
            return out
        return call

    def _run_round(self, fn):
        import numpy as np

        from repro_torch.secagg import protocol as SA
        from repro_torch.secagg.field import sum_encoded

        def call(wires, participants, dropped, cfg, seed, link_of=None):
            sa = fn(wires, participants, dropped, cfg, seed, link_of)
            L, spec = SA.agree_length(wires), cfg.field
            plain = sum_encoded([spec.encode(SA._pad(wires[c], L))
                                 for c in sa.survivors], spec)
            exact = sa.field_sum is not None and \
                np.array_equal(sa.field_sum, plain) and \
                np.array_equal(sa.sum_vec, spec.decode_sum(plain))
            fsum = np.sum([SA._pad(wires[c], L) for c in sa.survivors],
                          axis=0, dtype=np.float64)
            self.field_checks.append({
                "length": L, "survivors": len(sa.survivors),
                "bit_exact": bool(exact),
                "max_abs_from_float_sum": float(np.abs(
                    sa.sum_vec - fsum).max()) if exact else None,
                "resolution": spec.resolution})
            return sa
        return call

    def __enter__(self):
        from repro_torch.fedsim import pipeline as PL
        from repro_torch.secagg import protocol as SA

        self._saved = [(PL.UploadPipeline, s, getattr(PL.UploadPipeline, s))
                       for s in self.STAGES if s != "delta_tree"]
        self._saved += [(PL, "delta_tree", PL.delta_tree),
                        (SA, "run_round", SA.run_round)]
        for owner, name, fn in self._saved:
            setattr(owner, name, self._run_round(fn) if name == "run_round"
                    else self._timed(name, fn))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def wire_run(torch, cfg, strat_name, kw, data, params, use_kernels: bool,
             stage1_base=None):
    """One full-width run of phase 8 → (history, probe, forwards with and
    without grad per round, config).  For SLoRA the probe keeps the base
    that stage 1 aggregated (``probe.stage1_base``); with ``stage1_base``
    the SVD init takes that one instead of the run's own."""
    from repro_torch.core.fedara import FedARA
    from repro_torch.federated.baselines import SLoRA
    from repro_torch.federated.server import FedConfig, run_federated
    from repro_torch.models import Model

    strat = (FedARA(total_rounds=3, warmup_rounds=1, final_rounds_frac=0.34)
             if strat_name == "fedara" else SLoRA())
    model = Model(cfg.with_(adapter_rank=strat.init_rank(cfg)),
                  peft=strat.peft, use_kernels=use_kernels)
    fc = FedConfig(rounds=3, clients_per_round=3, batch_size=8,
                   max_local_batches=4, eval_every=3, eval_batches=4, **kw)
    fwds = [[0, 0]]
    fwd = model._forward

    def forward(*a, **k):
        fwds[-1][0 if torch.is_grad_enabled() else 1] += 1
        return fwd(*a, **k)

    with WireProbe() as probe:
        def next_round(*a):
            probe.next_round()
            fwds.append([0, 0])

        if strat_name == "slora":           # stage 1 ends at the SVD init
            svd = strat.svd_init_from_delta

            def svd_init(model_, base0, base1, trainable):
                next_round()
                probe.stage1_base = base1
                return svd(model_, base0, base1 if stage1_base is None
                           else stage1_base, trainable)

            strat.svd_init_from_delta = svd_init
        model._forward = forward
        h = run_federated(model, strat, data["parts"], data["train"],
                          data["test"], fc, on_round=next_round, device=DEV,
                          params=params)
        torch.cuda.synchronize()
    return h, probe, fwds[:-1], fc


def wire_checks(torch, cfg, name, strat_name, kw, fc, hk, pk, fk, hp, pp,
                fp, launches, plain_launches, identity_up) -> dict:
    """Phase 8's gates between one setting's kernel and plain runs; returns
    its line, whose ``errors`` lists every gate that failed."""
    from repro_torch.secagg.field import FieldSpec

    errors = []

    if fk != fp:
        errors.append(f"{name}: forwards per round {fk} vs plain {fp}")
    n_fwd = sum(map(sum, fk))
    per_fwd = {"bea_dense": 6 * cfg.n_layers, "flash_attention": cfg.n_layers}
    for k, n in per_fwd.items():
        if launches[k] != n * n_fwd:
            errors.append(f"{name}: {launches[k]} {k} launches in "
                          f"{n_fwd} forwards, not {n} each")
    if any(plain_launches.values()):
        errors.append(f"{name}: the plain run launched kernels: "
                      f"{plain_launches}")
    s1 = (hp.get("stage1") or {}).get("rounds", 0)
    for a, b in zip(hk["rounds"], hp["rounds"]):
        same = (a.rnd, a.down_bytes, a.up_bytes, a.live_ranks,
                a.dead_modules, a.trainable_params, a.sim_time_s) == \
            (b.rnd, b.down_bytes, b.up_bytes, b.live_ranks, b.dead_modules,
             b.trainable_params, b.sim_time_s)
        if a.rnd < s1:
            loss_ok = math.isnan(a.loss) and math.isnan(b.loss)
        else:
            loss_ok = math.isfinite(a.loss) and math.isfinite(b.loss) \
                and abs(a.loss - b.loss) <= TRAIN_LOSS_RTOL * abs(b.loss)
        if not same or not loss_ok:
            errors.append(f"{name} round {a.rnd}: kernels {a} vs "
                          f"plain {b}")
    clips = [[u["clipped"] for u in r["uploads"]] for r in pk.rounds]
    n_eval = fc.eval_batches * fc.batch_size
    if len(hk["rounds"]) != fc.rounds or hk["comm_gb"] != hp["comm_gb"] \
            or hk.get("stage1") != hp.get("stage1") \
            or hk["secagg_rounds"] != hp["secagg_rounds"] \
            or hk["dp_eps"] != hp["dp_eps"] or hk.get("dp") != hp.get("dp") \
            or clips != [[u["clipped"] for u in r["uploads"]]
                         for r in pp.rounds] \
            or abs(hk["final_acc"] - hp["final_acc"]) > 1 / n_eval + 1e-12 \
            or not math.isfinite(hk["final_acc"]):
        errors.append(
            f"{name}: comm_gb {hk['comm_gb']} vs {hp['comm_gb']}, stage1 "
            f"{hk.get('stage1')} vs {hp.get('stage1')}, secagg "
            f"{hk['secagg_rounds']} vs {hp['secagg_rounds']}, eps "
            f"{hk['dp_eps']} vs {hp['dp_eps']}, clipped {clips}, final acc "
            f"{hk['final_acc']} vs {hp['final_acc']}")
    for r in hk["secagg_rounds"]:
        if r["recovery_bytes"] or r["n_dropped"] or r["aborted"]:
            errors.append(f"{name}: secagg round {r}")
    secagg = kw.get("secagg") == "mask"
    eps = [e for _, e in hk["dp_eps"]]
    if secagg:
        if [r["n_clipped"] for r in hk["secagg_rounds"]] != \
                [fc.clients_per_round] * fc.rounds or \
                len(eps) != fc.rounds or \
                not all(0 < a < b for a, b in zip(eps, eps[1:])):
            errors.append(f"{name}: clipped / ε per round "
                          f"{hk['secagg_rounds']} {hk['dp_eps']}")
        checks = pk.field_checks + pp.field_checks
        if len(checks) != 2 * fc.rounds or \
                not all(c["bit_exact"] for c in checks):
            errors.append(f"{name}: field sums {checks}")
    # every upload's bytes are its codec's formula at its wire length; under
    # secagg the masked phase prices the wire as field elements instead
    n_ranks = 6 * cfg.n_layers * cfg.adapter_rank
    mask_bytes = (n_ranks + 7) // 8 if strat_name == "fedara" else 0
    rows = []
    for i, (r, log) in enumerate(zip(pk.rounds, hk["rounds"])):
        n = r["uploads"][0]["n"]
        want = 0 if secagg else codec_bytes(kw["codec"], n,
                                            kw.get("powersgd_rank", 2)) \
            + mask_bytes
        if any(u["nbytes"] != want or u["n"] != n for u in r["uploads"]):
            errors.append(f"{name} round {i}: uploads {r['uploads']} "
                          f"vs {want} bytes each")
        row = {"rnd": log.rnd, "wire_floats": n,
               "up_bytes_per_client": log.up_bytes // fc.clients_per_round,
               "identity_bytes_per_client": 4 * n + mask_bytes,
               "down_bytes": log.down_bytes, "up_bytes": log.up_bytes,
               "live_ranks": log.live_ranks, "loss": log.loss,
               "plain_loss": hp["rounds"][i].loss,
               "norms": [u["norm"] for u in r["uploads"]],
               "clipped": sum(u["clipped"] for u in r["uploads"]),
               "wall_s": r["wall_s"], "plain_wall_s": pp.rounds[i]["wall_s"],
               **{f"{s}_s": r[f"{s}_s"] for s in WireProbe.STAGES}}
        if secagg:
            ph = hk["secagg_rounds"][i]["phases"]
            L = n + 1 + n_ranks          # wire, weight, one-hot votes
            if ph["masked"]["up"] != fc.clients_per_round * (
                    FieldSpec().wire_bytes(L) + 4):
                errors.append(f"{name}: masked bytes {ph}")
            row["secagg_phase_bytes"] = {k: v["down"] + v["up"]
                                         for k, v in ph.items()}
        if strat_name == "fedara":
            row["phase6_identity_bytes_per_client"] = identity_up[i]
        rows.append(row)
    return {"phase": "wire", "run": name, "strategy": strat_name,
            "config": kw,
            "rounds": rows, "stage1": hk.get("stage1"),
            "dp_eps": hk["dp_eps"], "dp": hk.get("dp"),
            "field_checks": pk.field_checks,
            "forwards": fk, "launches": launches,
            "launches_per_forward": {k: launches[k] / n_fwd
                                     for k in per_fwd},
            "final_acc": hk["final_acc"], "plain_final_acc": hp["final_acc"],
            "comm_gb": hk["comm_gb"], "wall_s": hk["wall_s"],
            "plain_wall_s": hp["wall_s"], "errors": errors}


def stage1_gap(torch, base0, bk, bp) -> dict:
    """Where the two runs' stage-1 aggregates differ, over the entries that
    stage 1 moved: how many differ at all (a block's signSGD scale rounds
    apart), by more than 1e-3 of the largest delta (a client's sign flipped)
    and in sign, and the largest difference over the largest delta."""
    from repro_torch.pytree import leaves

    dk = torch.cat([(k.float() - b.float()).reshape(-1) for k, b in
                    zip(leaves(bk), leaves(base0))])
    dp = torch.cat([(p.float() - b.float()).reshape(-1) for p, b in
                    zip(leaves(bp), leaves(base0))])
    scale = dk.abs().max().item()
    diff = (dk - dp).abs()
    return {"moved": int((dk != 0).sum()), "differ": int((diff > 0).sum()),
            "differ_over_1e-3": int((diff > 1e-3 * scale).sum()),
            "sign_differs": int((dk * dp < 0).sum()),
            "max_diff_of_max_delta": diff.max().item() / scale}


def wire(torch, cfg, identity_up):
    """Phase 8: FedARA (and SLoRA) on ``cfg`` (full-width DistilBERT-base in
    ``main``) over the compressed and private wire, phase 6's data and
    partition with 3 clients a round: PowerSGD, int8 and top-k unclipped,
    then signSGD under secure aggregation with the DP clip and noise, and
    SLoRA with signSGD and the clip in both stages.  Each setting runs
    through the kernels (counts zeroed just before, read just after) and
    through the plain versions from the same weights; ``identity_up`` is
    phase 6's per-client upload bytes per round.  Returns the kernel runs'
    launches summed and per forward by run."""
    from repro_torch import kernels as K
    from repro_torch.data.synthetic import make_classification
    from repro_torch.federated.partition import dirichlet_partition
    from repro_torch.models import Model
    from repro_torch.secagg.field import FieldSpec

    t0 = time.perf_counter()
    train_ = make_classification(600, cfg.n_classes, cfg.vocab_size, 128,
                                 seed=1)
    test = make_classification(200, cfg.n_classes, cfg.vocab_size, 128,
                               seed=2)
    data = {"train": train_, "test": test,
            "parts": dirichlet_partition(train_.labels, 10, alpha=0.1,
                                         seed=0)}
    totals = dict.fromkeys(K.launch_counts(), 0)
    per_forward, min_norm, clips = {}, math.inf, {}
    for name, (strat_name, kw) in WIRE_RUNS.items():
        kw = dict(kw)
        if "clip_of_min_norm" in kw:
            kw["dp_clip"] = clips[name] = min(float(
                f"{kw.pop('clip_of_min_norm') * min_norm:.2g}"),
                FieldSpec().clip)
        params = Model(cfg, peft="bea" if strat_name == "fedara"
                       else "lora").init(SEED, DEV)
        K.reset_launches()
        hk, pk, fk, fc = wire_run(torch, cfg, strat_name, kw, data, params,
                                  True)
        launches = K.launch_counts()
        K.reset_launches()
        # SLoRA's plain run inits LoRA from the kernel run's stage-1
        # aggregate: see WIRE_RUNS for why the two runs' own inits part
        hp, pp, fp, _ = wire_run(torch, cfg, strat_name, kw, data, params,
                                 False, getattr(pk, "stage1_base", None))
        line = wire_checks(torch, cfg, name, strat_name, kw, fc, hk, pk, fk,
                           hp, pp, fp, launches, K.launch_counts(),
                           identity_up)
        if strat_name == "slora":
            line["stage1_aggregate_gap"] = stage1_gap(
                torch, params[0], pk.stage1_base, pp.stage1_base)
        norms = [u["norm"] for r in pk.rounds for u in r["uploads"]]
        if "dp_clip" not in kw:
            min_norm = min([min_norm] + norms)
        line["unclipped_min_norm"] = min_norm
        emit(line)
        if line["errors"]:
            raise AssertionError(f"phase 8, {name}: {line['errors']}")
        for k in totals:
            totals[k] += launches[k]
        per_forward[name] = line["launches_per_forward"]
        del hk, hp, pk, pp, params
        gc.collect()
    emit({"phase": "wire", "model": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "clients": 10, "clients_per_round": 3,
          "dp_clip": clips, "unclipped_min_norm": min_norm,
          "launches_all_runs": totals,
          "phase_seconds": time.perf_counter() - t0})
    return totals, per_forward


# --------------------------------------------------------- phase 9: fedsim --
# The cohort, async and fused runners at full DistilBERT-base width, phase
# 6's data (10 clients of make_classification(600, 20, 30522, 128), 8 × 128
# tokens a batch, rank 12, f32).  The fused runs (f, g, h) split the data
# IID, because the fused path takes no client smaller than one batch and
# phase 6's Dirichlet(0.1) split has one of 5 samples.

COHORT_RTOL = 2e-4           # cohort vs seq, rtol and atol (the reference's
                             # tests/test_fedsim.py:64)
FUSED_RTOL = 1e-6            # fused vs eager cohort, per-round losses
MOMENT_RTOL = {"bfloat16": 0.05, "int8": 0.15}   # tests/test_fused.py:284
FEDSIM_KW = dict(clients_per_round=3, batch_size=8, max_local_batches=4,
                 eval_batches=4)


def grouped_operands(torch, gen, c, m, k, n, r):
    """C clients' distinct x, A, B and E on one W, and a mask with every
    fourth rank off."""
    dev = torch.device(DEV)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    mask = torch.ones(r, dtype=torch.bool, device=dev)
    mask[::4] = False
    return (rnd(c, m, k), rnd(k, n, scale=k ** -0.5),
            rnd(c, r, k, scale=k ** -0.5), rnd(c, n, r), rnd(c, r), mask)


def check_grouped_kernel(torch, cfg):
    """(a) The client-grouped f32 ``bea_dense`` against its plain version
    at a layer's 6 linears: C = 3 clients of M = 1024 rows, of 800 (ragged)
    and one client of 1024; two calls bitwise equal and a CUDA-graph replay
    equal to them at C = 3, M = 1024.  Returns the worst (abs, rel) error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bea_fused import bea_dense_grouped, plan

    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 9)
    d, f, r = cfg.d_model, cfg.d_ff, cfg.adapter_rank
    s = cfg.adapter_alpha / r
    worst, repeat = [0.0, 0.0], {}
    for c, m in ((3, 1024), (3, 800), (1, 1024)):
        for j, (k, n) in enumerate([(d, d)] * 4 + [(d, f), (f, d)]):
            ops = grouped_operands(torch, gen, c, m, k, n, r)
            err, rel = rel_err(bea_dense_grouped(*ops, s),
                               ref.bea_dense_grouped_ref(*ops, s))
            worst[0], worst[1] = max(worst[0], err), max(worst[1], rel)
            if rel > F32_TOL:
                raise AssertionError(f"bea_dense_grouped C={c} M={m} "
                                     f"{k}x{n}: relative error {rel}")
            if j >= 3:
                emit({"phase": "fedsim", "kernel": "bea_dense_grouped",
                      "clients": c, "m": m, "k": k, "n": n, "r": r,
                      "masked_ranks": int((~ops[-1]).sum()),
                      "plan": plan(m, k, n, torch.float32,
                                   clients=c)._asdict(),
                      "max_abs_err": err, "rel_err": rel, "tol": F32_TOL})
            if c == 3 and m == 1024 and j >= 3:
                repeat[f"C=3 M=1024 {k}x{n}"] = repeatable(
                    torch, lambda ops=ops: bea_dense_grouped(*ops, s))
    emit({"phase": "fedsim", "check": "grouped: two calls bitwise equal, "
          "CUDA-graph replay equal to the eager call", "results": repeat})
    bad = [name for name, ok in repeat.items() if not all(ok.values())]
    if bad:
        raise AssertionError(f"grouped not repeatable or not graph-safe: "
                             f"{bad}")
    return worst


def time_grouped_kernel(torch, cfg):
    """(a) Times per layer (6 linears) at C = 3 clients of M = 1024 rows,
    r = 12, cycling 2 layers' weights: the grouped kernel, its plain
    version, the library form over the C·M rows (one x·W product, the
    adapter term by batched products) and C separate single-client
    ``bea_dense`` calls, beside the bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bea_fused import (bea_dense, bea_dense_grouped,
                                               plan)

    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 10)
    d, f, r, c, m = cfg.d_model, cfg.d_ff, cfg.adapter_rank, 3, 1024
    s = cfg.adapter_alpha / r
    kns = [(d, d)] * 4 + [(d, f), (f, d)]
    layers = [[grouped_operands(torch, gen, c, m, k, n, r) for k, n in kns]
              for _ in range(2)]

    def lib(x, w, a, b, e, mk):
        y = (x.reshape(-1, x.shape[-1]) @ w).view(c, m, -1)
        u = torch.bmm(x, a.transpose(1, 2)) * (e * mk)[:, None]
        return torch.baddbmm(y, u, b.transpose(1, 2), alpha=s)

    def separate(x, w, a, b, e, mk):
        for i in range(c):
            bea_dense(x[i], w, a[i], b[i], e[i], mk, s)

    def run(fn):
        def go():
            for layer in layers:
                for ops in layer:
                    fn(*ops)
        return go

    nbytes = sum(4 * (k * n + c * (m * k + m * n + r * k + n * r + r))
                 for k, n in kns)
    flops = sum(2 * c * m * (k * n + r * k + n * r) for k, n in kns)
    per_linear = {}
    for name, j in (("wq/wk/wv/wo", 0), ("w1", 4), ("w2", 5)):
        k, n = kns[j]
        p = plan(m, k, n, torch.float32, clients=c)
        one = [[layer[j]] for layer in layers]
        per_linear[name] = {
            "k": k, "n": n, "tile": [p.block_m, p.block_n],
            "splits": p.splits, "k_slice": p.k_slice, "blocks": p.blocks,
            "ms": time_ms(torch, lambda: [bea_dense_grouped(*ops[0], s)
                                          for ops in one]) / 2,
            "separate_calls_ms": time_ms(torch, lambda: [
                separate(*ops[0]) for ops in one]) / 2}
    out = {"ms": time_ms(torch, run(lambda *t: bea_dense_grouped(*t, s))) / 2,
           "plain_ms": time_ms(torch, run(
               lambda *t: ref.bea_dense_grouped_ref(*t, s))) / 2,
           "library_ms": time_ms(torch, run(lib)) / 2,
           "separate_calls_ms": time_ms(torch, run(separate)) / 2,
           **f32_bounds(nbytes, flops),
           "shape": f"6 linears of one layer, C={c} clients of M={m}, "
                    f"r={r}, f32"}
    emit({"phase": "fedsim", "timing": "bea_dense_grouped", **out,
          "per_linear": per_linear})
    return out


def cohort_step_check(torch, cfg):
    """(b) One cohort step of 3 clients (8 × 128 tokens each) through the
    kernels against the plain cohort step and against each client's own
    single-client step through the kernels, from the same weights: losses
    within TRAIN_STEP_TOL, every grad within TRAIN_GRAD_TOL of its largest
    plain value; the cohort forward launches the grouped instance once per
    adapted linear and flash once per layer."""
    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.models import Model
    from repro_torch.pytree import leaves, tree_map

    c = 3
    kern = Model(cfg, peft="bea")
    plain = Model(cfg, peft="bea", use_kernels=False)
    base, tr = kern.init(SEED, DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 11)
    stacked = tree_map(lambda t: t[None] + 0.1 * torch.randn(
        (c,) + tuple(t.shape), generator=gen, device=DEV), tr)
    masks = kern.init_masks(DEV)
    masks["dec"]["layers"][0]["attn"]["wq"][3] = False
    masks["dec"]["layers"][-1]["mlp"]["w2"][:] = False
    rng = np.random.default_rng(SEED + 11)
    batch = {"tokens": torch.as_tensor(rng.integers(
                 0, cfg.vocab_size, (c, 8, 128)), device=DEV),
             "labels": torch.as_tensor(rng.integers(0, cfg.n_classes,
                                                    (c, 8)), device=DEV)}

    def step(model, params, b, clients):
        req = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                       params)
        K.reset_launches()
        total, (loss, _) = model.cls_loss(base, req, masks, b, clients)
        fwd = K.launch_counts()
        grads = torch.autograd.grad(total, leaves(req))
        return loss.detach(), grads, fwd

    lk, gk, fk = step(kern, stacked, batch, True)
    lp, gp, fp = step(plain, stacked, batch, True)
    singles = [step(kern, tree_map(lambda t: t[i], stacked),
                    {k: v[i] for k, v in batch.items()}, False)
               for i in range(c)]
    ls = torch.stack([s_[0] for s_ in singles])
    gs = [torch.stack([s_[1][j] for s_ in singles]) for j in range(len(gk))]

    def worst(got, want):
        return max((a - b).abs().max().item()
                   / max(b.abs().max().item(), 1e-30)
                   for a, b in zip(got, want))

    res = {"vs_plain_cohort": {
               "loss_rel_diff": ((lk - lp).abs() / lp.abs()).max().item(),
               "worst_grad_rel": worst(gk, gp)},
           "vs_single_client_steps": {
               "loss_rel_diff": ((lk - ls).abs() / ls.abs()).max().item(),
               "worst_grad_rel": worst(gk, gs)}}
    n_lin = 6 * cfg.n_layers
    emit({"phase": "fedsim", "check": "one cohort step of 3 clients, "
          "kernels vs the plain cohort step and vs 3 single-client steps",
          "losses": lk.tolist(), **res, "loss_tol": TRAIN_STEP_TOL,
          "grad_tol": TRAIN_GRAD_TOL, "grads_compared": len(gk),
          "forward_launches": fk, "plain_launches": fp})
    for name, r in res.items():
        if r["loss_rel_diff"] > TRAIN_STEP_TOL \
                or r["worst_grad_rel"] > TRAIN_GRAD_TOL:
            raise AssertionError(f"cohort step {name}: {r}")
    if fk["bea_dense_grouped"] != n_lin or fk["bea_dense"] \
            or fk["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"cohort forward launched {fk}, expected "
                             f"{n_lin} grouped and {cfg.n_layers} flash")
    if any(fp.values()):
        raise AssertionError(f"the plain cohort step launched {fp}")


def fedsim_run(torch, cfg, data, params, strat_name, use_kernels=True,
               parts=None, **kw):
    """One full-width run → (history, forwards per round as [cohort,
    single-client], host wall stamps at each round's end)."""
    from repro_torch.core.fedara import FedARA
    from repro_torch.federated.baselines import FedLoRA
    from repro_torch.federated.server import FedConfig, run_federated
    from repro_torch.models import Model

    rounds = kw.pop("rounds", 3)
    strat = (FedARA(total_rounds=rounds, warmup_rounds=1,
                    final_rounds_frac=0.34)
             if strat_name == "fedara" else FedLoRA())
    model = Model(cfg, peft=strat.peft, use_kernels=use_kernels)
    fc = FedConfig(rounds=rounds, eval_every=kw.pop("eval_every", rounds),
                   **FEDSIM_KW, **kw)
    fwds, stamps = [[0, 0]], [time.perf_counter()]
    fwd = model._forward

    def forward(*a, **k):
        fwds[-1][0 if k.get("clients", a[4] if len(a) > 4 else False)
                 else 1] += 1
        return fwd(*a, **k)

    def on_round(*_):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        fwds.append([0, 0])

    model._forward = forward
    h = run_federated(model, strat, data["parts"] if parts is None else parts,
                      data["train"], data["test"], fc, on_round=on_round,
                      device=DEV, params=params)
    torch.cuda.synchronize()
    return h, fwds[:-1], stamps


def same_rounds(ha, hb, loss_rtol, loss_atol=0.0) -> str:
    """'' when bytes, live ranks, dead modules, masks and the clock are
    equal and the losses within the tolerances, else what differs."""
    import numpy as np

    for a, b in zip(ha["rounds"], hb["rounds"]):
        if (a.down_bytes, a.up_bytes, a.live_ranks, a.dead_modules) != \
                (b.down_bytes, b.up_bytes, b.live_ranks, b.dead_modules):
            return f"round {a.rnd}: {a} vs {b}"
        if a.sim_time_s != b.sim_time_s:
            return f"round {a.rnd}: clock {a.sim_time_s} vs {b.sim_time_s}"
        if not abs(a.loss - b.loss) <= loss_atol + loss_rtol * abs(b.loss):
            return f"round {a.rnd}: loss {a.loss} vs {b.loss}"
    if len(ha["rounds"]) != len(hb["rounds"]):
        return "round counts differ"
    ma, mb = ha["masks"], hb["masks"]
    if (ma is None) != (mb is None):
        return "masks differ"
    if ma is not None:
        from repro_torch.pytree import leaves
        if not all(np.array_equal(x, y) for x, y in zip(leaves(ma),
                                                          leaves(mb))):
            return "masks differ"
    return ""


def fedsim_runs(torch, cfg, data, iid):
    """(c)–(g): the whole runs and their gates; returns the FedARA cohort
    run's launches (the slice's main path) and the fused runs for (h)."""
    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.models import Model
    from repro_torch.optim import adam, state_nbytes
    from repro_torch.pytree import leaves, tree_map

    n_lin = 6 * cfg.n_layers
    bea = Model(cfg, peft="bea").init(SEED, DEV)
    lora = Model(cfg, peft="lora").init(SEED, DEV)
    out, errors = {}, []

    # (c) FedARA cohort: kernels (the main path: counts zeroed just before,
    # read just after) vs plain, and vs seq through the kernels
    K.reset_launches()
    hk, fk, sk = fedsim_run(torch, cfg, data, bea, "fedara", runner="cohort")
    launches = K.launch_counts()
    hp, _, _ = fedsim_run(torch, cfg, data, bea, "fedara", False,
                          runner="cohort")
    hs, _, ss = fedsim_run(torch, cfg, data, bea, "fedara", runner="seq")
    n_coh = sum(f[0] for f in fk)
    n_one = sum(f[1] for f in fk)
    want = {"bea_dense_grouped": n_lin * n_coh, "bea_dense": n_lin * n_one,
            "flash_attention": cfg.n_layers * (n_coh + n_one)}
    if any(launches[k] != v for k, v in want.items()):
        errors.append(f"(c) launches {launches}, expected {want}")
    for name, e in (("kernels vs plain", same_rounds(hk, hp,
                                                     TRAIN_LOSS_RTOL)),
                    ("cohort vs seq", same_rounds(hk, hs, COHORT_RTOL,
                                                  COHORT_RTOL))):
        if e:
            errors.append(f"(c) {name}: {e}")
    if hk["rounds"][-1].live_ranks >= n_lin * cfg.adapter_rank:
        errors.append("(c) FedARA pruned no rank")
    out["c"] = {"rounds": [{"rnd": a.rnd, "up_bytes": a.up_bytes,
                            "live_ranks": a.live_ranks,
                            "dead_modules": a.dead_modules, "loss": a.loss,
                            "plain_loss": b.loss, "seq_loss": s_.loss,
                            "sim_time_s": a.sim_time_s}
                           for a, b, s_ in zip(hk["rounds"], hp["rounds"],
                                               hs["rounds"])],
                "forwards_cohort_single": fk, "launches": launches,
                "cohort_round_wall_s": np.diff(sk).tolist(),
                "seq_round_wall_s": np.diff(ss).tolist()}
    del hp, hs

    # (d) stragglers and dropout stretch the clock
    hd, _, _ = fedsim_run(torch, cfg, data, lora, "fedlora", runner="cohort",
                          dropout=0.3, straggler=0.5, event_seed=3)
    h0, _, _ = fedsim_run(torch, cfg, data, lora, "fedlora", runner="cohort")
    if not hd["sim_time_s"] > h0["sim_time_s"]:
        errors.append(f"(d) clock {hd['sim_time_s']} !> {h0['sim_time_s']}")
    out["d"] = {"sim_time_s": hd["sim_time_s"],
                "no_stragglers_sim_time_s": h0["sim_time_s"],
                "losses": [a.loss for a in hd["rounds"]]}

    # (e) async, twice: the same events and losses bit for bit
    kw = dict(runner="async", buffer_k=2, straggler=0.3, event_seed=7)
    ha, _, _ = fedsim_run(torch, cfg, data, lora, "fedlora", **kw)
    hb, _, _ = fedsim_run(torch, cfg, data, lora, "fedlora", **kw)
    la, lb = [a.loss for a in ha["rounds"]], [a.loss for a in hb["rounds"]]
    if ha["events"] != hb["events"] or la != lb:
        errors.append("(e) two async runs differ")
    if not any(a.staleness > 0 for a in ha["rounds"]):
        errors.append("(e) no round shows staleness")
    out["e"] = {"events": len(ha["events"]), "losses": la,
                "staleness": [a.staleness for a in ha["rounds"]],
                "sim_time_s": ha["sim_time_s"], "comm_gb": ha["comm_gb"]}

    # (f) fused (4-round blocks of captured rounds) vs the eager cohort
    kw = dict(runner="cohort", rounds=8, eval_every=4, parts=iid)
    K.reset_launches()
    he, fe, se = fedsim_run(torch, cfg, data, lora, "fedlora", **kw)
    eager_launches = K.launch_counts()
    K.reset_launches()
    hf, ff, sf = fedsim_run(torch, cfg, data, lora, "fedlora",
                            fuse_rounds=4, **kw)
    counted = K.launch_counts()
    g = hf.get("graph", {})
    if g.get("captures") != 1:
        errors.append(f"(f) {g.get('captures')} captures, not 1")
    fused_launches = {k: v - g["launches_per_capture"][k]
                      + g["replays"] * g["launches_per_capture"][k]
                      for k, v in counted.items()} if g else counted
    e = same_rounds(hf, he, FUSED_RTOL)
    if e or hf["comm_gb"] != he["comm_gb"] \
            or hf["sim_time_s"] != he["sim_time_s"]:
        errors.append(f"(f) fused vs eager: {e or 'comm_gb or clock'}")
    out["f"] = {"losses": [a.loss for a in hf["rounds"]],
                "eager_losses": [a.loss for a in he["rounds"]],
                "bitwise_equal": [a.loss for a in hf["rounds"]]
                == [a.loss for a in he["rounds"]],
                "graph": g, "launches": fused_launches,
                "eager_launches": eager_launches}

    # (g) bf16 and int8 moments in (f)'s config for 4 rounds, vs f32
    kw = dict(kw, rounds=4, fuse_rounds=4)
    h32, _, _ = fedsim_run(torch, cfg, data, lora, "fedlora", **kw)
    out["g"] = {"float32": [a.loss for a in h32["rounds"]]}
    for dt, rtol in MOMENT_RTOL.items():
        hq, _, _ = fedsim_run(torch, cfg, data, lora, "fedlora",
                              opt_state_dtype=dt, **kw)
        lq = [a.loss for a in hq["rounds"]]
        out["g"][dt] = lq
        if not all(math.isfinite(x) and abs(x - y) <= rtol * abs(y)
                   for x, y in zip(lq, out["g"]["float32"])):
            errors.append(f"(g) {dt} losses {lq} vs f32 "
                          f"{out['g']['float32']}")
        if hq["comm_gb"] != h32["comm_gb"] \
                or hq["sim_time_s"] != h32["sim_time_s"]:
            errors.append(f"(g) {dt}: bytes or clock differ")
    tr = lora[1]
    n_par, n_leaf, c = sum(t.numel() for t in leaves(tr)), len(leaves(tr)), 3
    stacked = tree_map(lambda t: t[None].expand((c,) + tuple(t.shape)), tr)
    formula = {"float32": 4 + 2 * 4 * c * n_par,
               "bfloat16": 4 + 2 * 2 * c * n_par,
               "int8": 4 + c * n_par + 4 * c * n_leaf + 2 * c * n_par}
    got = {dt: state_nbytes(adam(1e-3, state_dtype=dt).init(
        stacked, clients=True)) for dt in formula}
    if got != formula:
        errors.append(f"(g) state_nbytes {got} != {formula}")
    out["g"]["state_nbytes_3_clients"] = got

    out["walls"] = {"cohort": se, "fused": sf}
    out["fused_forwards"] = ff
    return launches, out, errors


def fedsim_measure(torch, cfg, data, iid, walls):
    """(h) Round walls of FedLoRA (3 clients × 4 steps, 8 rounds, eval every
    4) under seq, cohort and fused: the wall of rounds 4–7 (one eval among
    them, capture and warm-up behind) over 4; the profiler's busy time,
    launches and idle share of one seq step, one cohort step and one graph
    replay of a round; the phase's peak memory."""
    import numpy as np

    from repro_torch.data.synthetic import batches
    from repro_torch.federated import client as CL
    from repro_torch.federated.baselines import FedLoRA
    from repro_torch.federated.server import FedConfig, _init_run
    from repro_torch.fedsim import cohort as CH
    from repro_torch.fedsim.fused import CohortRound
    from repro_torch.models import Model
    from repro_torch.pytree import tree_map

    lora = Model(cfg, peft="lora").init(SEED, DEV)
    _, _, ss = fedsim_run(torch, cfg, data, lora, "fedlora", runner="seq",
                          rounds=8, eval_every=4, parts=iid)
    walls = {"seq": ss, **walls}
    round_wall = {k: (v[8] - v[4]) / 4 for k, v in walls.items()}

    model = Model(cfg, peft="lora")
    fc = FedConfig(rounds=8, **FEDSIM_KW)
    base, tr, _, _, _, opt, _ = _init_run(model, FedLoRA(), fc, DEV, lora)
    rng = np.random.default_rng(0)
    one = next(batches(data["train"], 8, rng))
    seq_batch = CL.device_batch(one, DEV)
    coh = {k: torch.as_tensor(np.stack([v] * 3), device=DEV).long()
           for k, v in one.items()}
    stacked = CH.stack_params(tr, 3)
    seq_step = CL.make_train_step(model, opt)
    coh_step = CL.make_train_step(model, opt, clients=True)
    st1, st3 = opt.init(tr), opt.init(stacked, clients=True)
    cohort = CH.build_cohort(data["train"], iid, [0, 1, 2], fc, 0, 3)
    bst, sms, wts = CH.device_inputs(cohort.batches, cohort.step_mask,
                                     cohort.weights, DEV)
    rd = CohortRound(model, opt, base, tree_map(torch.clone, tr), None, None,
                     bst, sms, wts)
    rd.run()                                   # capture
    prof = {"seq_step": profile_step(torch, lambda: seq_step(
                base, tr, st1, None, None, seq_batch)),
            "cohort_step": profile_step(torch, lambda: coh_step(
                base, stacked, st3, None, None, coh)),
            "graph_replay_of_a_round": profile_step(torch, rd.run)}
    per_round = {"seq": 12 * prof["seq_step"]["step_device_kernel_launches"],
                 "cohort": 4 * prof["cohort_step"][
                     "step_device_kernel_launches"],
                 "fused": prof["graph_replay_of_a_round"][
                     "step_device_kernel_launches"]}
    return {"round_wall_s": round_wall,
            "round_stamps_s": {k: np.diff(v).tolist()
                               for k, v in walls.items()},
            "device_launches_per_round": per_round, "profile": prof}


def fedsim(torch, cfg):
    """Phase 9 (full-width DistilBERT-base in ``main``).  Returns the
    ``kernels`` line's grouped row, phase 9's launches per kernel, and its
    data and IID split (phase 10 reuses them)."""
    from repro_torch.data.synthetic import make_classification
    from repro_torch.federated.partition import (dirichlet_partition,
                                                 iid_partition)

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    worst = check_grouped_kernel(torch, cfg)
    times = time_grouped_kernel(torch, cfg)
    cohort_step_check(torch, cfg)
    train = make_classification(600, cfg.n_classes, cfg.vocab_size, 128,
                                seed=1)
    test = make_classification(200, cfg.n_classes, cfg.vocab_size, 128,
                               seed=2)
    data = {"train": train, "test": test,
            "parts": dirichlet_partition(train.labels, 10, alpha=0.1,
                                         seed=0)}
    iid = iid_partition(train.labels, 10, seed=0)
    launches, runs, errors = fedsim_runs(torch, cfg, data, iid)
    walls = runs.pop("walls")
    measured = fedsim_measure(torch, cfg, data, iid, walls)
    emit({"phase": "fedsim", "model": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "clients": 10, **FEDSIM_KW, **runs,
          **measured, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "seconds": time.perf_counter() - t0, "errors": errors})
    if errors:
        raise AssertionError(f"phase 9: {errors}")
    for k in ("bea_dense_grouped", "flash_attention"):
        if not launches[k]:
            raise AssertionError(f"phase 9 launched no {k}")
    row = {**times, "launches": launches["bea_dense_grouped"],
           "max_abs_err": worst[0], "max_rel_err": worst[1]}
    return row, launches, runs["f"]["launches"], data, iid


# ------------------------------------------------------------ phase 10: obs --
# repro_torch.obs over full-width runs on the card, phase 9's model, data and
# partitions: (a) the reference's trace-parity acceptance setting (FedARA
# cohort, signSGD under secure aggregation, dropout 0.3, its event seed 3 and
# Shamir threshold 0.5, so round 0 loses 2 of 3 clients and aborts) traced
# with the live plane up, and untraced, both under the sync debug mode;
# (b) FedLoRA eager and fused (blocks of 4) on the IID split, traced; (c)
# phase 4's serving run, traced; (d) round walls traced vs untraced.

OBS_SECAGG_KW = dict(runner="cohort", codec="signsgd", secagg="mask",
                     dropout=0.3, event_seed=3, secagg_threshold=0.5)
OBS_REQUIRED = ["run", "round", "client", "pipeline", "secagg",
                "secagg-phase"]
# alerts that say a run is broken; the others (rank_collapse: RankDet pruned
# a module; client_drift: near-orthogonal client wires, as sign-coded and
# non-IID ones are; dropout_skew / secagg_abort: the setting's dropouts) are
# the detectors reading this setting, and are reported
OBS_BROKEN = ("nan_loss", "loss_divergence", "ef_blowup")
SYNC_WARNING = "synchronizing CUDA operation"


def obs_history_key(h) -> dict:
    """Everything of a history that two runs of one config must share bit
    for bit: per-round logs (losses, bytes, ranks, clock), totals, secagg
    entries, final masks."""
    import dataclasses

    import numpy as np

    from repro_torch.pytree import leaves
    return {"rounds": [dataclasses.astuple(lg) for lg in h["rounds"]],
            "acc": h["acc"], "comm_gb": h["comm_gb"],
            "sim_time_s": h["sim_time_s"], "final_acc": h["final_acc"],
            "secagg_rounds": h.get("secagg_rounds"),
            "masks": [np.asarray(m).tobytes()
                      for m in leaves(h["masks"] or {})]}


def obs_accounting(s: dict, h: dict | None = None) -> dict:
    """The summary's accounting, or (with ``h``) the history's in the same
    keys: what summarize must reconstruct exactly."""
    keys = ("n_rounds", "comm_gb", "sim_time_s", "down_bytes", "up_bytes",
            "final_acc")
    if h is None:
        return {k: s.get(k) for k in keys}
    return {"n_rounds": len(h["rounds"]), "comm_gb": h["comm_gb"],
            "sim_time_s": h["sim_time_s"],
            "down_bytes": sum(lg.down_bytes for lg in h["rounds"]),
            "up_bytes": sum(lg.up_bytes for lg in h["rounds"]),
            "final_acc": h["final_acc"]}


def counted_syncs(torch, fn):
    """(fn(), the synchronizing CUDA operations it made) under the sync
    debug mode, every warning recorded (the default filter shows one per
    line)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum(SYNC_WARNING in str(w.message) for w in caught)


def obs_checks(events, h, torch, errors, tag, required=("run", "round")):
    """The gates every traced run shares: check clean, summarize equals the
    history exactly, no alert that says the run is broken and the live
    monitor's alerts equal the offline scan's, a memory event per round with
    0 < peak <= the allocator's peak, no kernel build in the trace.  Returns
    the summary and the alerts by type."""
    from repro_torch import obs
    from repro_torch.obs import health as H
    from repro_torch.obs import profile as P

    probs = obs.check(events, require_kinds=list(required))
    if probs:
        errors.append(f"{tag}: check {probs[:3]}")
    s = obs.summarize(events)
    if obs_accounting(s) != obs_accounting(s, h):
        errors.append(f"{tag}: summarize {obs_accounting(s)} != history "
                      f"{obs_accounting(s, h)}")
    scan, emb = H.scan(events), H.embedded_alerts(events)
    if json.dumps(scan, sort_keys=True) != json.dumps(emb, sort_keys=True):
        errors.append(f"{tag}: live alerts {emb} != scan {scan}")
    broken = [a for a in scan if a["alert"] in OBS_BROKEN]
    if broken:
        errors.append(f"{tag}: alerts {broken}")
    mems = [e for e in events if e.get("name") == "memory"]
    peak = torch.cuda.max_memory_allocated()
    if len(mems) != len(h["rounds"]) or not all(
            0 < d["peak_bytes_in_use"] <= peak
            for e in mems for d in e["attrs"]["devices"].values()):
        errors.append(f"{tag}: {len(mems)} memory events for "
                      f"{len(h['rounds'])} rounds, or a peak out of (0, "
                      f"{peak}]")
    if P.compile_stats(events)["by_stage"].get("nvcc"):
        errors.append(f"{tag}: a kernel was built inside the trace")
    by_type: dict = {}
    for a in scan:
        by_type[a["alert"]] = by_type.get(a["alert"], 0) + 1
    return s, by_type


def obs_secagg(torch, cfg, data, bea, errors):
    """(a) The acceptance setting traced (the kernels' counts zeroed just
    before, read just after) with the live plane up, and untraced; both
    under the sync debug mode."""
    import urllib.request

    from repro_torch import kernels as K
    from repro_torch import obs

    out_dir = ROOT / "results"             # git-ignored
    out_dir.mkdir(exist_ok=True)
    path = out_dir / "obs_secagg.jsonl"
    scraped = {}

    def traced():
        obs.configure(str(path), meta=obs.provenance({"cmd": "chip_smoke"}))
        live = obs.serve_live(port=0)
        try:
            h, _, _ = fedsim_run(torch, cfg, data, bea, "fedara",
                                 **OBS_SECAGG_KW)
            for ep in ("metrics", "healthz"):
                with urllib.request.urlopen(f"{live.url}/{ep}",
                                            timeout=10) as r:
                    scraped[ep] = r.read().decode()
            obs.close()
        finally:
            live.stop()
            obs.disable()
        return h

    untraced = lambda: fedsim_run(torch, cfg, data, bea, "fedara",  # noqa
                                  **OBS_SECAGG_KW)[0]
    K.reset_launches()
    ht, syncs_t = counted_syncs(torch, traced)
    launches = K.launch_counts()
    hu, syncs_u = counted_syncs(torch, untraced)
    events = obs.read_jsonl(str(path))
    s, alerts = obs_checks(events, ht, torch, errors, "(a)", OBS_REQUIRED)
    if obs_history_key(ht) != obs_history_key(hu):
        errors.append("(a) traced and untraced histories differ")
    if syncs_t > syncs_u + 1:
        errors.append(f"(a) {syncs_t} syncs traced, {syncs_u} untraced")
    for k in ("bea_dense_grouped", "flash_attention"):
        if not launches[k]:
            errors.append(f"(a) launched no {k}")
    want = {}
    for r in ht["secagg_rounds"]:
        for name, pc in r["phases"].items():
            w = want.setdefault(name, {"down": 0, "up": 0})
            w["down"] += pc["down"]
            w["up"] += pc["up"]
    sa = s.get("secagg", {})
    if (sa.get("phase_bytes"), sa.get("rounds"), sa.get("recovery_bytes")) \
            != (want, len(ht["secagg_rounds"]),
                sum(r["recovery_bytes"] for r in ht["secagg_rounds"])):
        errors.append(f"(a) secagg {sa} != history")
    traj = obs.rank_trajectory(events)
    if traj["live"] != {lg.rnd: lg.live_ranks for lg in ht["rounds"]}:
        errors.append(f"(a) rank trajectory {traj['live']}")
    fams = parse_exposition(scraped["metrics"])
    if not any(lb.get("codec") == "signsgd"
               for _, lb, _ in fams.get("pipeline_up_bytes", [])):
        errors.append("(a) /metrics has no pipeline_up_bytes{codec=signsgd}")
    if "progress" not in json.loads(scraped["healthz"]):
        errors.append("(a) /healthz has no progress")
    n = len(ht["rounds"])
    return {"rounds": n, "events": len(events),
            "events_per_round": len(events) / n,
            "jsonl_bytes_per_round": path.stat().st_size / n,
            "spans": s["spans"], "alerts": alerts,
            "secagg": sa, "ranks": s.get("ranks"),
            "memory_peak_bytes": [
                d["peak_bytes_in_use"] for e in events
                if e.get("name") == "memory"
                for d in e["attrs"]["devices"].values()],
            "sync_warnings": {"traced": syncs_t, "untraced": syncs_u},
            "metrics_families": len(fams), "launches": launches}


def parse_exposition(text: str) -> dict:
    """Prometheus text v0.0.4 → {family: [(name, labels, value)]}; raises
    on a malformed line."""
    sample = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{([^}]*)\})? (\S+)$")
    fams: dict = {}
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            fams[line.split()[2]] = []
            continue
        m = sample.match(line)
        if not m:
            raise AssertionError(f"bad exposition line {line!r}")
        name = m.group(1)
        fam = next((name[:-len(x)] for x in ("_sum", "_count")
                    if name.endswith(x) and name[:-len(x)] in fams), name)
        labels = dict(re.findall(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"',
                                 m.group(2) or ""))
        fams.setdefault(fam, []).append((name, labels, float(m.group(3))))
    return fams


def obs_fused(torch, cfg, data, iid, lora, errors):
    """(b) FedLoRA over 8 rounds (eval every 4) eager and in fused blocks of
    4, traced: one graph capture, in round 0's block; both summaries equal
    each other's and their histories' accounting exactly."""
    from repro_torch import obs
    from repro_torch.obs import profile as P

    kw = dict(runner="cohort", rounds=8, eval_every=4, parts=iid)
    runs = {}
    for name, extra in (("eager", {}), ("fused", {"fuse_rounds": 4})):
        try:
            obs.configure(None)
            h, _, _ = fedsim_run(torch, cfg, data, lora, "fedlora", **kw,
                                 **extra)
            runs[name] = (h, obs.close())
        finally:
            obs.disable()
    summaries = {n: obs_checks(ev, h, torch, errors, f"(b) {n}",
                               ("run", "round", "client", "dispatch"))
                 for n, (h, ev) in runs.items()}
    hf, ev = runs["fused"]
    if obs_accounting(summaries["fused"][0]) != \
            obs_accounting(summaries["eager"][0]):
        errors.append("(b) fused and eager summaries differ")
    caps = [e for e in ev if e.get("kind") == "compile"]
    parents = {e["id"]: e for e in ev if e.get("type") == "span"}
    cs = P.compile_stats(ev)
    if [e["name"] for e in caps] != ["graph_capture"] \
            or parents[caps[0]["parent"]]["attrs"].get("rnd") != 0 \
            or cs["after_first_round"] != 0 or cs["by_round"] != {0: 1}:
        errors.append(f"(b) compile spans {caps}, stats {cs}")
    return {"capture_s": caps[0]["dur"] if caps else None,
            "capture_launches": caps[0]["attrs"].get("launches")
            if caps else None,
            "compile_stats": cs,
            "alerts": {n: s[1] for n, s in summaries.items()},
            "events": {n: len(e) for n, (_, e) in runs.items()}}


def obs_serving(torch, errors):
    """(c) Phase 4's serving run (full-width Qwen2-0.5B, 8 requests, 4
    slots, two tenants) traced; the counts zeroed just before, read just
    after."""
    import numpy as np

    from repro_torch import kernels as K
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine, serve_requests

    cfg = get_config("qwen2_0p5b")
    n_req, slots, gen_n = 8, 4, 16
    rng = np.random.default_rng(SEED)
    lens = rng.integers(100, 201, n_req)
    engine = build_engine(cfg, n_slots=slots, max_seq=int(lens.max()) + gen_n,
                          n_tenants=2, seed=SEED, device=DEV)
    tenants = engine.registry.ids()
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    aids = [tenants[i % len(tenants)] for i in range(n_req)]
    K.reset_launches()
    try:
        obs.configure(None)
        reqs = serve_requests(engine, prompts, aids, gen_n)
        torch.cuda.synchronize()
        events = obs.close()
    finally:
        obs.disable()
    launches = K.launch_counts()
    st = engine.stats()
    met = {e["name"]: e["value"] for e in events
           if e.get("type") == "metric" and not e["labels"]}
    steps = [e for e in events if e.get("name") == "engine.step"]
    n_gen = sum(len(r.out) for r in reqs)
    fed = int(lens.sum()) + n_gen - n_req      # tokens the model was fed
    lat = st["latency"]
    if len(steps) != st["steps"]:
        errors.append(f"(c) {len(steps)} step spans, {st['steps']} steps")
    if not all(math.isfinite(v[q]) for v in lat.values()
               for q in ("p50", "p95", "p99")) or not all(
            v["p50"] <= v["p95"] <= v["p99"] for v in lat.values()):
        errors.append(f"(c) latency {lat}")
    if met.get("sched.admits") != n_req or n_gen != n_req * gen_n \
            or met.get("serve.prefill_tokens", 0) \
            + met.get("serve.decode_tokens", 0) != fed:
        errors.append(f"(c) counters {met}, {n_gen} generated, {fed} fed")
    for k in ("bea_dense", "bea_batched", "flash_attention"):
        if not launches[k]:
            errors.append(f"(c) launched no {k}")
    del engine
    return {"steps": st["steps"], "latency": lat,
            "prefill_tokens": met.get("serve.prefill_tokens"),
            "decode_tokens": met.get("serve.decode_tokens"),
            "generated": n_gen, "admits": met.get("sched.admits"),
            "events": len(events), "launches": launches}


def obs_walls(torch, cfg, data, iid, bea, lora):
    """(d) Round walls untraced and traced, in turns (untraced, traced,
    traced, untraced): the seq FedARA run (3 rounds; median of rounds 1-2)
    and the fused FedLoRA run (8 rounds in blocks of 4; the second block
    over 4)."""
    import statistics

    import numpy as np

    from repro_torch import obs

    def seq(traced):
        try:
            if traced:
                obs.configure(None)
            _, _, st = fedsim_run(torch, cfg, data, bea, "fedara",
                                  runner="seq")
            n = len(obs.close()) if traced else 0
        finally:
            obs.disable()
        return np.diff(st)[1:].tolist(), n / 3

    def fused(traced):
        try:
            if traced:
                obs.configure(None)
            _, _, st = fedsim_run(torch, cfg, data, lora, "fedlora",
                                  runner="cohort", rounds=8, eval_every=4,
                                  parts=iid, fuse_rounds=4)
            n = len(obs.close()) if traced else 0
        finally:
            obs.disable()
        return [(st[8] - st[4]) / 4], n / 8

    out = {}
    for name, fn in (("seq_fedara", seq), ("fused_fedlora", fused)):
        walls = {False: [], True: []}
        per_round = []
        for traced in (False, True, True, False):
            w, n = fn(traced)
            walls[traced] += w
            if traced:
                per_round.append(n)
        med_u, med_t = (statistics.median(walls[t]) for t in (False, True))
        out[name] = {"untraced_s": walls[False], "traced_s": walls[True],
                     "median_untraced_s": med_u, "median_traced_s": med_t,
                     "overhead": med_t / med_u - 1,
                     "events_per_round": per_round}
    return out


def obs_phase(torch, cfg, data, iid):
    """Phase 10 (full-width DistilBERT-base in ``main``); returns each
    kernel's launches in the traced runs of (a) and (c)."""
    from repro_torch.models import Model

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    bea = Model(cfg, peft="bea").init(SEED, DEV)
    lora = Model(cfg, peft="lora").init(SEED, DEV)
    errors = []
    a = obs_secagg(torch, cfg, data, bea, errors)
    b = obs_fused(torch, cfg, data, iid, lora, errors)
    walls = obs_walls(torch, cfg, data, iid, bea, lora)
    del bea, lora
    gc.collect()
    c = obs_serving(torch, errors)
    emit({"phase": "obs", "model": cfg.name, "layers": cfg.n_layers,
          "secagg_run": a, "fused_run": b, "serving": c, "round_walls": walls,
          "nvidia_smi": nvidia_smi(), "seconds": time.perf_counter() - t0,
          "errors": errors})
    if errors:
        raise AssertionError(f"phase 10: {errors}")
    return {k: a["launches"][k] + c["launches"][k] for k in a["launches"]}


# ------------------------------------------------------------- phase 11: lm --
# Causal-LM fine-tuning, ``launch/train.py`` over ``Model.lm_loss``, at full
# width: (a) Qwen2-0.5B in bf16 (RoPE, causal GQA flash over 14 query and 2
# kv heads, BEA rank 8 on all 7 linears) at 8 × 512 tokens; (b) BART-base in
# f32 (6 encoder and 6 decoder layers, cross-attention, rank 12) at 8 × 256.
# The bf16 step is held to a looser gate than f32's: its kernel and plain
# paths round products and attention probabilities to bf16 at different
# places, so the loss is held within 1e-2 relative and each adapter grad by
# its direction (cosine to plain) rather than element by element; both are
# also held against an f32 plain step from the same weights (the truth).
# The step starts from the trainable init with E drawn off zero, as
# training leaves it after a few steps.  Measured on an NVIDIA H100 80GB
# HBM3 at 700 W: with A and B also moved by 0.1·N(0, 1) (3× their init
# scale, phase 6's perturbation) the bf16 noise of both paths grows with
# the adapter term: layer 0's w1.E then has cosine 0.9907 (kernels) and
# 0.9869 (plain) to the f32 truth, and 0.983 to each other; from this
# phase's weights (E alone off zero) the worst leaves have 0.9977, 0.9974
# and 0.9966.
# (c) Gemma2-2B (26 layers alternating local and global, window 4096,
# attention soft-cap 50, final soft-cap 30) at 8 × 512 and Gemma3-1B (22
# local layers with window 512, 4 global) at 4 × 1024, both bf16 with head
# dim 256, under Qwen2's gates: at 512 tokens Gemma2's window never masks,
# at 1024 Gemma3's binds on its local layers.
# (e) Granite-3.0-1B-A400M (24 MoE layers: 32 experts top-8 of d_ff 512,
# capacity factor 1.5; attention 16 q over 8 kv heads of 64) at 8 × 512,
# bf16, under Qwen2's gates.  Its attention linears and attention run
# through the kernels; its router and expert FFN are batched products in
# both paths.  Routing is discontinuous: bf16 rounding before the router
# flips near-tied top-k choices between the kernel and the plain step, so
# the plain and f32 comparison steps route as the kernel step routed
# (``lm_loss(..., route=)``), and the share of choices that flip under
# each path's own routing is printed beside the tokens dropped per layer.
# (f) Kimi-K2's SMOKE (2 MoE layers, f32) at 8 × 512: one step under phase
# 6's f32 gates; its full width (~2 TB of bf16) fits no card.
# (g) Zamba2-1.2B (32 Mamba2 layers and one shared attention block at 6
# positions, window 4096, GeGLU) at 8 × 512, bf16: the shared block's
# params, adapters and masks are one tree (``dec.shared``), its adapter
# grads the sum over the occurrences; its SMOKE (f32, window 16 binding)
# at 8 × 512 too.

LM_STEPS = 20
# InternVL2-1B's batches also carry n_prefix_embeds (256) patch rows
LM_RUNS = {"qwen2_0p5b": {"batch": 8, "seq": 512},
           "internvl2_1b": {"batch": 8, "seq": 512},
           "bart": {"batch": 8, "seq": 256},
           "gemma2_2b": {"batch": 8, "seq": 512},
           "gemma3_1b": {"batch": 4, "seq": 1024},
           "granite_moe_1b_a400m": {"batch": 8, "seq": 512},
           "minicpm_2b": {"batch": 8, "seq": 512},
           "mamba2_780m": {"batch": 8, "seq": 512},
           "zamba2_1p2b": {"batch": 8, "seq": 512}}
LM_SMOKE_RUNS = {"kimi_k2_1t_a32b": {"batch": 8, "seq": 512},
                 "minicpm_2b": {"batch": 8, "seq": 512},
                 "mamba2_780m": {"batch": 8, "seq": 512},
                 "zamba2_1p2b": {"batch": 8, "seq": 512}}
# launches per forward: bea_dense once per adapted linear (7 a layer; BART
# 6 an encoder layer, 10 a decoder layer; an MoE layer's 4 attention
# linears; a Mamba2 layer's in_proj and out_proj; Zamba2's 32 mamba layers
# 2 each and its shared block 7 at each of its 6 occurrences: 64 + 42),
# flash once per attention (BART: encoder, decoder self and cross; none in
# Mamba2; Zamba2 one per shared occurrence); a SMOKE run's under its
# arch's name with "_smoke" (Zamba2's: 2 mamba layers and 2 occurrences)
LM_PER_FORWARD = {"qwen2_0p5b": {"bea_dense": 168, "flash_attention": 24},
                  "internvl2_1b": {"bea_dense": 168, "flash_attention": 24},
                  "bart": {"bea_dense": 96, "flash_attention": 18},
                  "gemma2_2b": {"bea_dense": 182, "flash_attention": 26},
                  "gemma3_1b": {"bea_dense": 182, "flash_attention": 26},
                  "granite_moe_1b_a400m": {"bea_dense": 96,
                                           "flash_attention": 24},
                  "minicpm_2b": {"bea_dense": 280, "flash_attention": 40},
                  "mamba2_780m": {"bea_dense": 96, "flash_attention": 0},
                  "zamba2_1p2b": {"bea_dense": 106, "flash_attention": 6},
                  "kimi_k2_1t_a32b_smoke": {"bea_dense": 8,
                                            "flash_attention": 2},
                  "minicpm_2b_smoke": {"bea_dense": 14, "flash_attention": 2},
                  "mamba2_780m_smoke": {"bea_dense": 4, "flash_attention": 0},
                  "zamba2_1p2b_smoke": {"bea_dense": 18,
                                        "flash_attention": 2}}
LM_BF16_LOSS_RTOL = 1e-2     # bf16 step loss, kernels vs plain, relative
LM_BF16_GRAD_COS = 0.99      # bf16: each adapter grad's cosine to f32 / plain
# MiniCPM-2B (40 layers) and Mamba2-780M (48 layers): their plain bf16
# steps are themselves farther than LM_BF16_GRAD_COS from the f32 step at
# phase 6's perturbation (measured on one H100: worst leaves 0.975 and
# 0.20, both an E, a sum over 4,096 tokens that cancels), and at E off
# zero Mamba2's kernel and plain steps are 0.988 apart while each is at
# least 0.9949 from f32: bf16 rounding, not the kernels, sets how close a
# step of these models can come.  Their kernel step is held to the f32
# step at min(LM_BF16_GRAD_COS, the plain bf16 step's cosine to it less
# LM_BF16_COS_SLACK) at both states, and at the perturbed state once more
# in f32, kernels against plain at phase 6's gates.  Zamba2-1.2B (38
# layers, 32 of them SSD) is such a model too: at phase 6's perturbation
# its plain bf16 step's worst leaf (an E) is 0.798 from the f32 step
# (measured on one H100), while at E off zero both its steps hold 0.996.
# InternVL2-1B too (24 layers over 768 rows, 256 of them patch rows): at
# phase 6's perturbation its plain bf16 step's worst leaf (an E) is 0.977
# from the f32 step and its kernel step's 0.988 (measured on one H100
# 80GB HBM3 at 700 W), while at E off zero both hold 0.998
LM_BF16_TRUTH_ONLY = ("minicpm_2b", "mamba2_780m", "zamba2_1p2b",
                      "internvl2_1b")
LM_BF16_COS_SLACK = 0.005
LM_ENC_EXTRA = 128           # BART step check: encoder tokens beyond S


def attn_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs an attention call scores: query i sees key j
    ≤ i when causal and j > i − window under a window."""
    n = 0
    for i in range(sq):
        hi = min(i + 1, sk) if causal else sk
        lo = max(0, i - window + 1) if window else 0
        n += max(hi - lo, 0)
    return n


def flash_bound(b, sq, sk, h, kvh, hd, causal, window) -> tuple:
    """Bound of a bf16 flash call: q and o (b·sq·h·hd), k and v
    (b·sk·kvh·hd) moved once, against 4·hd flops per scored pair and
    head."""
    return bound_ms(2 * b * hd * (2 * sq * h + 2 * sk * kvh),
                    4 * hd * h * b * attn_pairs(sq, sk, causal, window),
                    "bfloat16")


def time_lm_kernels(torch, cfgs):
    """(d) Times of the LM instances beside the bound, the plain version
    and the library call: bf16 ``bea_dense`` over one layer's 7 linears of
    Qwen2, Gemma2 and Gemma3 and Granite's 4 attention linears at M = 4096
    (8 × 512, 8 × 512, 4 × 1024 and 8 × 512 tokens), r = 8, cycling 4
    layers' weights (more than the 50 MB L2), and per linear under its
    plan; bf16 causal flash at each model's training call (Qwen2's and
    Granite's GQA at B = 8, S = 512; at head dim 256 Gemma2's
    with cap 50, Gemma3's local with window 512 and global), each also
    forced onto mma_kernel, and mma_kernel<256> at the 20 query rows its
    plan gives it; f32 cross flash at B = 8, Sq = 256 over Sk = 384, 12
    heads (each flash time the mean of a forward's calls in one graph).
    A flash row's library call is SDPA (kv heads repeated; a boolean band
    mask for a window that binds) and, under a soft-cap or a binding
    window, ``flex_attention`` compiled by ``torch.compile`` (tanh
    ``score_mod``, causal/window ``block_mask``, GQA), the faster as
    ``library_ms``; with a cap, SDPA without it beside them."""
    import torch.nn.functional as F
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import Plan, mha_flash
    from repro_torch.kernels.flash_attention import plan as fplan

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 12)
    bf = torch.bfloat16
    flex = torch.compile(flex_attention, dynamic=False)

    def rnd(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def per_call(fn, n=8):
        return time_ms(torch, lambda: [fn() for _ in range(n)]) / n

    out = {"bea_dense": {}, "flash_attention": {}}
    for arch, tag in (("qwen2_0p5b", "bf16_m4096"),
                      ("gemma2_2b", "bf16_m4096_gemma2"),
                      ("gemma3_1b", "bf16_m4096_gemma3"),
                      ("granite_moe_1b_a400m", "bf16_m4096_granite"),
                      ("minicpm_2b", "bf16_m4096_minicpm"),
                      ("mamba2_780m", "bf16_m4096_mamba2"),
                      ("zamba2_1p2b", "bf16_m4096_zamba2")):
        cfg, kw = cfgs[arch], LM_RUNS[arch]
        d, f, r, m = cfg.d_model, cfg.d_ff, cfg.adapter_rank, 4096
        qd, kv_d = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        kns = [(d, qd), (d, kv_d), (d, kv_d), (qd, d), (d, f), (d, f), (f, d)]
        names = ((("wq/wo", 0),) if qd == d else (("wq", 0), ("wo", 3))) + (
            ("wk/wv", 1), ("w1/w3", 4), ("w2", 6))
        if cfg.n_experts:           # the expert FFN is no bea_dense
            kns, names = kns[:4], names[:-2]
        if cfg.family in ("ssm", "hybrid"):     # in_proj and out_proj
            di, n_, h_ = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
            ssm = [(d, 2 * di + 2 * n_ + h_), (di, d)]
            if cfg.family == "ssm":
                kns, names = ssm, (("in_proj", 0), ("out_proj", 1))
            else:       # a mamba layer's and the shared block's
                kns, names = kns + ssm, names + (("in_proj", 7),
                                                 ("out_proj", 8))
        what = f"{len(kns)} linears of one {cfg.name} layer"
        if cfg.family == "hybrid":
            what = (f"9 linears of {cfg.name}: one mamba layer's 2 and one "
                    f"shared-block occurrence's 7")
        layers = [[(rnd(k, n, scale=k ** -0.5), rnd(r, k, scale=k ** -0.5),
                    rnd(n, r), rnd(r, dtype=torch.float32),
                    torch.ones(r, dtype=torch.bool, device=dev))
                   for k, n in kns] for _ in range(4)]
        dense_t, per_linear = time_dense_layer(
            torch, layers, {k: rnd(m, k) for k in dict.fromkeys(
                k for k, _ in kns)},
            2.0, names, f"{what}, M={m} ({kw['batch']} x {kw['seq']} "
            f"tokens), r={r}, bf16")
        dense_t["share_of_bound"] = dense_t["bound_ms"] / dense_t["ms"]
        emit({"phase": "lm", "timing": "bea_dense", "model": cfg.name,
              "m": m, "r": r, "per_layer": dense_t, "per_linear": per_linear})
        out["bea_dense"][tag] = {**dense_t, "per_linear": per_linear}
        del layers

    def flash_call_row(cfg, b_, sq, window, cap):
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        grp = h // kvh
        q, k, v = rnd(b_, sq, h, hd), rnd(b_, sq, kvh, hd), rnd(b_, sq, kvh, hd)
        kr, vr = k.repeat_interleave(grp, 2), v.repeat_interleave(grp, 2)
        qt, kt, vt, krt, vrt = (t.transpose(1, 2).contiguous()
                                for t in (q, k, v, kr, vr))
        binds = 0 < window < sq
        pos = torch.arange(sq, device=dev)
        band = (pos[None, :] <= pos[:, None]) & (
            pos[None, :] > pos[:, None] - window if binds else True)

        def sdpa():
            if binds:
                return F.scaled_dot_product_attention(qt, krt, vrt,
                                                      attn_mask=band)
            return F.scaled_dot_product_attention(qt, krt, vrt, is_causal=True)

        p = fplan(bf, b_, h, sq, sq, hd)
        got = mha_flash(q, k, v, causal=True, window=window, softcap=cap)
        # the timed call is held against the plain version on its inputs
        err, rel = rel_err(got, ref.flash_attention_ref(
            q.float(), kr.float(), vr.float(), causal=True, window=window,
            softcap=cap))
        if not rel <= BF16_TOL:
            raise AssertionError(f"flash disagrees with the plain version at "
                                 f"{cfg.name}'s call: {err}, {rel}")
        row = {"max_abs_err": err, "rel_err": rel, "tol": BF16_TOL,
               "ms": per_call(lambda: mha_flash(q, k, v, causal=True,
                                                window=window, softcap=cap)),
               "plain_ms": per_call(lambda: ref.flash_attention_ref(
                   q, kr, vr, causal=True, window=window, softcap=cap)),
               **dict(zip(("bound_ms", "bound_by"), flash_bound(
                   b_, sq, sq, h, kvh, hd, True, window))),
               "pairs": attn_pairs(sq, sq, True, window),
               "plan": p._asdict(),
               "shape": f"{cfg.name}: B={b_}, S={sq}, {h} q / {kvh} kv heads "
                        f"of {hd}, causal, window {window}, soft-cap {cap}, "
                        f"bf16 (mean of 8 calls in one graph)"}
        lib = {}
        if cap:
            row["sdpa_without_cap_ms"] = per_call(sdpa)
        else:
            lib["sdpa"] = per_call(sdpa)
        if cap or binds:
            def mask_mod(b, hh, qi, kj):
                keep = kj <= qi
                return keep & (kj > qi - window) if window else keep

            def score_mod(sc, b, hh, qi, kj):
                return cap * torch.tanh(sc / cap)

            bmask = create_block_mask(mask_mod, None, None, sq, sq, device=dev)

            def flex_call():
                return flex(qt, kt, vt, score_mod=score_mod if cap else None,
                            block_mask=bmask, enable_gqa=True)

            # the yardstick computes the same function: held like the kernel
            err, rel = rel_err(flex_call().transpose(1, 2), got)
            row["flex_attention_rel_err"] = rel
            if not rel <= BF16_TOL:
                raise AssertionError(f"flex_attention disagrees with flash at "
                                     f"{row['shape']}: {err}, {rel}")
            lib["flex_attention"] = per_call(flex_call)
        row.update({f"{n}_ms": t for n, t in lib.items()})
        row["library"] = min(lib, key=lib.get)
        row["library_ms"] = lib[row["library"]]
        if p.kernel == "wgmma":
            row["mma_kernel_ms"] = per_call(lambda: mha_flash(
                q, k, v, causal=True, window=window, softcap=cap,
                body=Plan("mma")))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        return row

    q2, g2, g3, gr, mc, z2 = (cfgs[a] for a in (
        "qwen2_0p5b", "gemma2_2b", "gemma3_1b", "granite_moe_1b_a400m",
        "minicpm_2b", "zamba2_1p2b"))
    calls = {"bf16_causal_gqa": (q2, 8, 512, 0, 0.0),
             "bf16_causal_gqa_granite": (gr, 8, 512, 0, 0.0),
             "bf16_causal_mha_minicpm": (mc, 8, 512, 0, 0.0),
             # the shared block's call: window 4096 over 512 tokens
             "bf16_causal_mha_zamba2": (z2, 8, 512, z2.sliding_window, 0.0),
             "bf16_hd256_gemma2": (g2, 8, 512, g2.sliding_window,
                                   g2.attn_softcap),
             "bf16_hd256_gemma3_local": (g3, 4, 1024, g3.sliding_window, 0.0),
             "bf16_hd256_gemma3_global": (g3, 4, 1024, 0, 0.0),
             "bf16_hd256_short": (g3, 1, 20, 16, 50.0)}
    for tag, call in calls.items():
        row = flash_call_row(*call)
        emit({"phase": "lm", "timing": "flash_attention", "instance": tag,
              **row, "nvidia_smi": nvidia_smi()})
        out["flash_attention"][tag] = row
    # f32 cross flash, BART's decoder over a longer encoder output
    bcfg = cfgs["bart"]
    h, hd, b_, sq, sk = bcfg.n_heads, bcfg.head_dim, 8, 256, 384
    q = rnd(b_, sq, h, hd, dtype=torch.float32)
    k, v = (rnd(b_, sk, h, hd, dtype=torch.float32) for _ in range(2))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    cross_t = {
        "ms": per_call(lambda: mha_flash(q, k, v, causal=False), 6),
        "plain_ms": per_call(lambda: ref.flash_attention_ref(
            q, k, v, causal=False), 6),
        "library_ms": per_call(lambda: F.scaled_dot_product_attention(
            qt, kt, vt), 6),
        **f32_bounds(4 * b_ * h * hd * (2 * sq + 2 * sk),
                     4 * hd * sq * sk * h * b_),
        "shape": f"one cross-attention call (mean of 6 in one graph), "
                 f"B={b_}, Sq={sq} over Sk={sk}, {h} heads of {hd}, f32"}
    emit({"phase": "lm", "timing": "flash_attention", "instance": "cross",
          **cross_t})
    out["flash_attention"]["f32_cross"] = cross_t
    # f32 at head dim 36: MiniCPM-2B SMOKE's causal MHA call at 8 × 512
    (b_, sq, _, h, _, _), hd = HD36_FLASH[0], 36
    q, k, v = (rnd(b_, sq, h, hd, dtype=torch.float32) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    err, rel = rel_err(mha_flash(q, k, v, causal=True),
                       ref.flash_attention_ref(q, k, v, causal=True))
    if not rel <= F32_TOL:
        raise AssertionError(f"f32 flash at head dim 36 disagrees with the "
                             f"plain version: {err}, {rel}")
    hd36_t = {
        "max_abs_err": err, "rel_err": rel, "tol": F32_TOL,
        "ms": per_call(lambda: mha_flash(q, k, v, causal=True), 6),
        "plain_ms": per_call(lambda: ref.flash_attention_ref(
            q, k, v, causal=True), 6),
        "library_ms": per_call(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 6),
        **f32_bounds(4 * b_ * h * hd * 4 * sq,
                     4 * hd * h * b_ * attn_pairs(sq, sq, True, 0)),
        "plan": fplan(torch.float32, b_, h, sq, sq, hd)._asdict(),
        "shape": f"MiniCPM-2B SMOKE's call (mean of 6 in one graph), B={b_}, "
                 f"S={sq}, {h} q / {h} kv heads of {hd}, causal, f32 "
                 f"(tf32_kernel on a tile of 40)"}
    hd36_t["share_of_bound"] = hd36_t["bound_ms"] / hd36_t["ms"]
    emit({"phase": "lm", "timing": "flash_attention", "instance": "f32_hd36",
          **hd36_t, "nvidia_smi": nvidia_smi()})
    out["flash_attention"]["f32_hd36"] = hd36_t
    return out


SSD_TOL = 1e-4               # f32 chunked SSD vs float64 recurrence, of max |y|


def ssd_check(torch) -> dict:
    """Mamba2-780M's SSD (``models/ssm.py:ssd_chunked``) at one full-width
    layer's shape, B = 1, S = 512, chunk 256, 48 heads of 64, state 128,
    at the reference's init (a = −e, dt a softplus): in f32 it must be
    finite and within SSD_TOL of the largest |y| of a float64 sequential
    recurrence (the reference's decode formula, repro/models/ssm.py:
    171-176); the same inputs rounded to bf16 (the bf16 model's x, B and C)
    are printed, not gated (c·b rounds to bf16 before the f32 sums).  Then
    the plain SSD is timed at the training step's 8 × 512 (no TPU kernel
    stands behind it: its share of a Mamba2 step)."""
    from repro_torch.models.ssm import ssd_chunked

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 14)
    h, p, n, s, chunk = 48, 64, 128, 512, 256

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def inputs(b_):
        return (rnd(b_, s, h, p), torch.nn.functional.softplus(rnd(b_, s, h)),
                -torch.full((h,), math.e, device=dev),
                rnd(b_, s, n, scale=n ** -0.5), rnd(b_, s, n, scale=n ** -0.5))

    x, dt, a, b, c = inputs(1)
    xd, dtd, ad, bd, cd = (t.double() for t in (x, dt, a, b, c))
    state = torch.zeros(1, h, p, n, dtype=torch.float64, device=dev)
    ys = []
    for t in range(s):
        state = (torch.exp(dtd[:, t] * ad)[..., None, None] * state
                 + (dtd[:, t, :, None] * xd[:, t])[..., None]
                 * bd[:, t, None, None, :])
        ys.append(torch.einsum("bn,bhpn->bhp", cd[:, t], state))
    want = torch.stack(ys, 1)
    scale = want.abs().max().item()
    y, hfin = ssd_chunked(x, dt, a, b, c, chunk)
    err = (y.double() - want).abs().max().item()
    state_err = (hfin.double() - state).abs().max().item() / max(
        state.abs().max().item(), 1e-30)
    bf = torch.bfloat16
    yb, _ = ssd_chunked(x.to(bf), dt, a, b.to(bf), c.to(bf), chunk)
    bf16_rel = (yb.double() - want).abs().max().item() / scale
    x8, dt8, a8, b8, c8 = inputs(8)
    x8, b8, c8 = x8.to(bf), b8.to(bf), c8.to(bf)
    out = {"phase": "lm", "check": "ssd_chunked at one Mamba2-780M layer vs a "
           "float64 recurrence", "shape": f"B=1, S={s}, chunk {chunk}, {h} "
           f"heads of {p}, state {n}, a = -e", "finite": bool(
               torch.isfinite(y).all()),
           "max_abs_err": err, "rel_err": err / scale, "tol": SSD_TOL,
           "state_rel_err": state_err, "bf16_inputs_rel_err": bf16_rel,
           "ms_train_call": time_ms(torch, lambda: ssd_chunked(
               x8, dt8, a8, b8, c8, chunk)),
           "train_call": f"B=8, S={s}, bf16 x/B/C, one layer's forward"}
    emit(out)
    if not out["finite"] or not err <= SSD_TOL * scale or \
            not state_err <= SSD_TOL:
        raise AssertionError(f"ssd_chunked against the float64 recurrence: "
                             f"{out}")
    return out


def time_dense_plans(torch, qcfg) -> dict:
    """The sweep behind ``kernels/bea_fused.py``'s wgmma plan rule: each of
    Qwen2's four linear shapes at M = 512, 1024 and 4096 rows, r = 8
    (cycling 4 layers' weights), under the plan the wrapper takes, the
    mma.sync plan, the wgmma plan on one block per tile instead of a
    persistent grid, the wgmma plan with K whole and split in 2 and 4, and
    the ``addmm`` form; ms per call."""
    from repro_torch.kernels import bea_fused as BF

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 14)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    d, f, r = qcfg.d_model, qcfg.d_ff, qcfg.adapter_rank
    kv_d = qcfg.n_kv_heads * qcfg.head_dim
    rows = []
    for name, (k, n) in (("wq/wo", (d, d)), ("wk/wv", (d, kv_d)),
                         ("w1/w3", (d, f)), ("w2", (f, d))):
        layers = [(rnd(k, n, scale=k ** -0.5), rnd(r, k, scale=k ** -0.5),
                   rnd(n, r), rnd(r, dtype=torch.float32),
                   torch.ones(r, dtype=torch.bool, device=dev))
                  for _ in range(4)]
        for m in (512, 1024, 4096):
            x = rnd(m, k)

            def run(fn):
                def go():
                    for layer in layers:
                        fn(x, *layer)
                return go

            plans = {"plan": BF.plan(m, k, n, rank=r),
                     "mma": BF.mma_plan(m, k, n, rank=r),
                     "wgmma_one_tile_per_block": BF.wgmma_plan(
                         m, k, n, r, persistent=False),
                     **{f"wgmma_splits_{s}": BF.wgmma_plan(m, k, n, r,
                                                           splits=s)
                        for s in (1, 2, 4)}}
            row = {"linear": name, "m": m, "k": k, "n": n}
            for tag, p in plans.items():
                row[tag] = {"ms": time_ms(torch, run(
                    lambda *t, p=p: BF.run_plan(p, *t, 2.0))) / len(layers),
                    "plan": list(p)}
            row["library_ms"] = time_ms(torch, run(
                lambda x, w, a, b, e, mk: torch.addmm(
                    x @ w, (x @ a.T) * (e * mk).to(bf), b.T, alpha=2.0))
            ) / len(layers)
            rows.append(row)
        del layers
    out = {"phase": "lm", "timing": "bea_dense plan sweep", "r": r,
           "rows": rows, "nvidia_smi": nvidia_smi()}
    emit(out)
    return out


def time_flash_plans(torch, qcfg) -> dict:
    """The sweep behind ``kernels/flash_attention.py``'s plan: Qwen2's
    causal GQA call (14 q / 2 kv heads of 64, bf16) at B = 1 and 8 over S
    = 32 to 512, under the plan the wrapper takes, the wgmma plan and
    mma_kernel, beside SDPA; at B = 8 and 1, S = 512, the wgmma forms the
    plan chooses among (2, 3 or 4 consumer warpgroups), and the plan's form
    with the kv heads repeated (group 1: no K/V tile shared in L2 by the
    query heads of a group); ms per call."""
    import importlib

    import torch.nn.functional as F

    # the module (the package exports the wrapper under the module's name)
    FA = importlib.import_module("repro_torch.kernels.flash_attention")

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 15)
    h, kvh, hd = qcfg.n_heads, qcfg.n_kv_heads, qcfg.head_dim
    grp = h // kvh

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def per_call(fn, n=8):
        return time_ms(torch, lambda: [fn() for _ in range(n)]) / n

    rows = []
    for b_ in (8, 1):
        for sq in (32, 64, 128, 256, 384, 512):
            q, k, v = rnd(b_, sq, h, hd), rnd(b_, sq, kvh, hd), rnd(b_, sq, kvh, hd)
            qt, krt, vrt = (t.transpose(1, 2).contiguous() for t in (
                q, k.repeat_interleave(grp, 2), v.repeat_interleave(grp, 2)))
            p = FA.plan(torch.bfloat16, b_, h, sq, sq, hd)
            forms = {"plan": p, "mma": FA.Plan("mma")}
            wg = hd in FA.WGMMA_HEAD_DIMS
            if wg:              # below WGMMA_MIN_SQ too: the threshold's data
                forms["wgmma_plan"] = FA.wgmma_plan(b_, h, sq, hd)
            if wg and sq == 512:
                forms.update({f"wgmma_{nc}x64": FA.wgmma_plan(
                    b_, h, sq, hd, consumers=nc) for nc in (2, 3, 4)})
            row = {"b": b_, "s": sq, "plan": p._asdict()}
            for tag, f in forms.items():
                row[f"{tag}_ms"] = per_call(
                    lambda f=f: FA.mha_flash(q, k, v, causal=True, body=f))
            row["library_ms"] = per_call(lambda: F.scaled_dot_product_attention(
                qt, krt, vrt, is_causal=True))
            if sq == 512:
                kr, vr = (t.repeat_interleave(grp, 2).contiguous() for t in (k, v))
                row["plan_group_1_ms"] = per_call(
                    lambda: FA.mha_flash(q, kr, vr, causal=True))
            rows.append(row)
    out = {"phase": "lm", "timing": "flash_attention plan sweep",
           "shape": f"{h} q / {kvh} kv heads of {hd}, causal, bf16",
           "rows": rows, "nvidia_smi": nvidia_smi()}
    emit(out)
    return out


def dense_rounding(torch, qcfg) -> dict:
    """How near each Qwen2 linear's bf16 output (M = 4096, r = 8) comes to
    the same function in float64 (u⊙e⊙m rounded to bf16 as the kernels
    round it), under the plan and with K whole, and for x·W alone from
    cuBLAS: the share of outputs that are not the float64 value rounded to
    bf16, and the mean error along the sign of the value over the mean
    |value| (negative: the tensor cores' truncating accumulation)."""
    from repro_torch.kernels import bea_fused as BF

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 16)
    bf = torch.bfloat16
    d, f, r, m = qcfg.d_model, qcfg.d_ff, qcfg.adapter_rank, 4096
    kv_d = qcfg.n_kv_heads * qcfg.head_dim
    rows = []
    for name, (k, n) in (("wq/wo", (d, d)), ("wk/wv", (d, kv_d)),
                         ("w1/w3", (d, f)), ("w2", (f, d))):
        x = torch.randn(m, k, generator=gen, device=dev).to(bf)
        w = (torch.randn(k, n, generator=gen, device=dev) * k ** -0.5).to(bf)
        a = (torch.randn(r, k, generator=gen, device=dev) * k ** -0.5).to(bf)
        b = (torch.randn(n, r, generator=gen, device=dev) * 0.1).to(bf)
        e = torch.randn(r, generator=gen, device=dev)
        mk = torch.ones(r, dtype=torch.bool, device=dev)
        xd, wd, ad, bd = (t.double() for t in (x, w, a, b))
        ub = ((xd @ ad.T) * (e * mk).double()).to(bf).double()
        want = xd @ wd + 2.0 * (ub @ bd.T)
        rn, scale = want.to(bf).double(), want.abs().mean().item()

        def stats(got, want=want, rn=rn, scale=scale):
            err = got.double() - want
            return {"not_rounded_share": (got.double() != rn).double()
                    .mean().item(),
                    "signed_bias": ((err * want.sign()).mean() / scale)
                    .item()}

        p = BF.plan(m, k, n, rank=r)
        row = {"linear": name, "plan": list(p),
               "plan_stats": stats(BF.run_plan(p, x, w, a, b, e, mk, 2.0)),
               "k_whole": stats(BF.run_plan(BF.wgmma_plan(m, k, n, r,
                                                          splits=1),
                                            x, w, a, b, e, mk, 2.0))}
        xw = xd @ wd
        row["cublas_xw"] = stats(x @ w, xw, xw.to(bf).double(),
                                 xw.abs().mean().item())
        rows.append(row)
    out = {"phase": "lm", "check": "bf16 bea_dense against float64",
           "m": m, "r": r, "rows": rows, "nvidia_smi": nvidia_smi()}
    emit(out)
    return out


def host_us_per_call(torch, fn, calls: int) -> float:
    """Host µs per ``fn()`` over ``calls`` calls queued without a sync,
    after three warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / calls


def batched_host_costs(torch) -> dict:
    """Host µs per ``bea_batched`` call at a decode step's shapes, M = 4:
    f32 at BART-base's fc1 (K = 768, N = 3072, G = 1, r = 12) and bf16 at
    Qwen2-0.5B's wq (K = N = 896, G = 2, r = 8): its plan (as written and
    memoized), ``check_operands``, ``run_plan`` (the output, ctypes and
    the cluster launch), the whole wrapper, and ``x @ w`` (one library
    launch through torch) beside them.  A package without ``run_plan``
    (one before the f32 body took a plan) gets the wrapper's and the
    matmul's times only.  Also runs alone, for a parent tree on
    ``PYTHONPATH``: ``python3 -c 'import chip_smoke, torch;
    chip_smoke.batched_host_costs(torch)'``."""
    import importlib

    from repro_torch.kernels.bea_fused import check_operands

    BB = importlib.import_module("repro_torch.kernels.bea_batched")
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 31)
    out = {"package": BB.__file__}
    for dtype, (k, n, g, r) in ((torch.float32, (768, 3072, 1, 12)),
                                (torch.bfloat16, (896, 896, 2, 8))):
        m = 4

        def rnd(*shape, dt=dtype):
            return torch.randn(shape, generator=gen, device=dev).to(dt)

        ops = (rnd(m, k), rnd(k, n), rnd(g, r, k), rnd(g, n, r),
               rnd(g, r, dt=torch.float32),
               torch.ones(g, r, dtype=torch.bool, device=dev),
               torch.arange(m, dtype=torch.int32, device=dev) % g)
        row = {"shape": f"M={m}, K={k}, N={n}, G={g}, r={r}",
               "bea_batched_us": host_us_per_call(
                   torch, lambda: BB.bea_batched(*ops, 2.0), 200),
               "matmul_us": host_us_per_call(
                   torch, lambda: ops[0] @ ops[1], 200)}
        if hasattr(BB, "run_plan"):
            pf = BB.plan if dtype == torch.bfloat16 else BB.f32_plan
            raw = getattr(pf, "__wrapped__", pf)
            p = pf(m, k, n, g, r)
            row.update({
                "plan": list(p),
                "plan_us": host_us_per_call(
                    torch, lambda: raw(m, k, n, g, r), 1000),
                "plan_memoized_us": host_us_per_call(
                    torch, lambda: pf(m, k, n, g, r), 1000),
                "check_operands_us": host_us_per_call(
                    torch, lambda: check_operands(
                        "bea_batched", ops[0],
                        dict(zip(("x", "w", "a_stack", "b_stack"), ops[:4])),
                        ops[4], ops[5], ops[0].device), 1000),
                "run_plan_us": host_us_per_call(
                    torch, lambda: BB.run_plan(p, *ops, 2.0), 200)})
        out[str(dtype).split(".")[1]] = row
    emit({"phase": "kernels", "timing": "host us per bea_batched call",
          **out, "nvidia_smi": nvidia_smi()})
    return out


def lm_host_costs(torch, qcfg) -> dict:
    """Host µs per call of the bf16 ``bea_dense`` path on its wgmma
    instance against the plain path's, at wq's shape with 1024 rows (M =
    1024, K = N = 896, r = 8: the card's work per call stays well under the
    host's, so the host wall is the host's cost; the host's work does not
    depend on M): ``plan`` (as written and memoized), ``check_operands``,
    ``run_plan`` (the output, the TMA maps, ctypes and the launch), the
    whole wrapper, the plain ``bea_dense_ref``; then a ``BeaDense`` forward
    and backward (its nested autograd) against the autograd of
    ``bea_dense_ref``, x, A, B and E needing grads as in a training step.
    Host wall over calls queued without a sync."""
    from repro_torch.kernels import bea_fused as BF
    from repro_torch.kernels import ref

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 15)
    bf = torch.bfloat16
    m, k, n, r = 1024, qcfg.d_model, qcfg.d_model, qcfg.adapter_rank
    x = torch.randn(m, k, generator=gen, device=dev).to(bf)
    w = (torch.randn(k, n, generator=gen, device=dev) * k ** -0.5).to(bf)
    a = (torch.randn(r, k, generator=gen, device=dev) * k ** -0.5).to(bf)
    b = torch.randn(n, r, generator=gen, device=dev).to(bf)
    e = torch.randn(r, generator=gen, device=dev)
    mk = torch.ones(r, dtype=torch.bool, device=dev)
    g = torch.randn(m, n, generator=gen, device=dev).to(bf)

    def host_us(fn, calls):
        return host_us_per_call(torch, fn, calls)

    p = BF.plan(m, k, n, bf, rank=r)
    raw_plan = getattr(BF.plan, "__wrapped__", BF.plan)
    leaves = [t.detach().requires_grad_(True) for t in (x, a, b, e)]

    def fwd_bwd(fn):
        def go():
            xl, al, bl, el = leaves
            y = fn(xl, w, al, bl, el, mk, 2.0)
            torch.autograd.grad(y, leaves, g)
        return go

    out = {"shape": f"M={m}, K={k}, N={n}, r={r}, bf16", "plan": list(p),
           "plan_us": host_us(lambda: raw_plan(m, k, n, bf, rank=r), 1000),
           "plan_memoized_us": host_us(
               lambda: BF.plan(m, k, n, bf, rank=r), 1000),
           "check_operands_us": host_us(lambda: BF.check_operands(
               "bea_dense", x, {"x": x, "w": w, "a": a, "b": b}, e, mk,
               x.device), 1000),
           "run_plan_us": host_us(
               lambda: BF.run_plan(p, x, w, a, b, e, mk, 2.0), 50),
           "bea_dense_us": host_us(
               lambda: BF.bea_dense(x, w, a, b, e, mk, 2.0), 50),
           "plain_forward_us": host_us(
               lambda: ref.bea_dense_ref(x, w, a, b, e, mk, 2.0), 50),
           "kernel_forward_backward_us": host_us(
               fwd_bwd(BF.BeaDense.apply), 20),
           "plain_forward_backward_us": host_us(
               fwd_bwd(ref.bea_dense_ref), 20)}
    out["kernel_backward_us"] = (out["kernel_forward_backward_us"]
                                 - out["bea_dense_us"])
    out["plain_backward_us"] = (out["plain_forward_backward_us"]
                                - out["plain_forward_us"])
    emit({"phase": "lm", "timing": "host us per bea_dense call", **out,
          "nvidia_smi": nvidia_smi()})
    return out


def grad_gap(torch, a, b) -> tuple[float, float]:
    """(max |a − b| over max |b|, cosine of a and b) of two grads; two zero
    grads are equal (cosine 1)."""
    a, b = a.float().flatten(), b.float().flatten()
    na, nb = a.norm().item(), b.norm().item()
    rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
    if na == 0.0 and nb == 0.0:
        return 0.0, 1.0
    return rel, (a @ b).item() / max(na * nb, 1e-30)


def lm_step_check(torch, arch, cfg, batch: int, seq: int,
                  init: str = "E") -> dict:
    """One full-width ``lm_loss`` step through the kernels and through the
    plain versions on the same weights and batch (BART's encoder reading
    LM_ENC_EXTRA more tokens than its decoder, so cross-attention runs with
    Sq ≠ Sk; a vision model's batch also carrying its patch embeddings,
    normal × 0.1), from the trainable init with E off zero (``init="E"``) or
    with every trainable perturbed as phase 6 does (``init="all"``): the
    loss and every adapter grad against plain (f32: phase 6's gates; bf16:
    LM_BF16_LOSS_RTOL, and each grad's cosine at least LM_BF16_GRAD_COS to
    an f32 plain step on the same weights, and at ``init="E"`` to the bf16
    plain step too; for LM_BF16_TRUTH_ONLY's models each grad's cosine to
    the f32 step at least the plain bf16 step's own, less a slack, or
    LM_BF16_GRAD_COS if that is lower), the launches per forward exactly
    LM_PER_FORWARD[arch]
    (``arch`` a SMOKE run's name with "_smoke").  The masks turn off one
    rank of the first layer's wq (a first mamba layer's in_proj) and the
    whole of the last layer's w2 (a last mamba layer's out_proj), and one
    rank of a shared block's wq (its empty slots in ``dec.layers``
    skipped).  At ``init="E"`` it also counts the operations of one training step
    that wait on the card.  An MoE model's plain and f32 steps route as
    its kernel step routed (``lm_loss(..., route=)``); each path's own
    routing is then read in a forward without grads: the share of (token,
    choice) pairs whose expert differs from the kernel step's, per layer,
    and the choices dropped over capacity, per layer.  The loss and the
    router aux are printed apart.
    At ``init="E"`` the step is then timed and profiled."""
    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.launch import steps as ST
    from repro_torch.models import Model
    from repro_torch.optim import adam, linear_decay
    from repro_torch.pytree import flatten_with_paths, tree_map

    kern, plain = Model(cfg), Model(cfg, use_kernels=False)
    base, tr = kern.init(SEED, DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 13)
    if init == "E":
        # E off its zero init, so the adapter term and its grads are not
        # zero
        tr = tree_map(lambda m: {**m, "E": m["E"] + 0.1 * torch.randn(
            m["E"].shape, generator=gen, device=DEV)}, tr,
            is_leaf=lambda x: isinstance(x, dict) and "E" in x)
    else:                   # A, B and E, as phase 6's step check does
        tr = tree_map(lambda t: t + 0.1 * torch.randn(
            t.shape, generator=gen, device=DEV).to(t.dtype), tr)
    masks = kern.init_masks(DEV)
    own = [m for m in masks["dec"]["layers"] if m]    # not a shared slot
    first, last = own[0], own[-1]
    if "ssm" in first:
        first["ssm"]["in_proj"][3] = False
    else:
        first["attn"]["wq"][3] = False
    if "ssm" in last:
        last["ssm"]["out_proj"][:] = False
    else:
        last["moe" if cfg.n_experts else "mlp"]["w2"][:] = False
    if "shared" in masks["dec"]:
        masks["dec"]["shared"]["attn"]["wq"][3] = False
    rng = np.random.default_rng(SEED + 13)
    b = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, seq)),
                            device=DEV) for k in ("tokens", "targets")}
    b["targets"][0, :seq // 8] = -1
    if cfg.is_encoder_decoder:
        b["enc_tokens"] = torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (batch, seq + LM_ENC_EXTRA)), device=DEV)
    if cfg.modality == "vision":        # normal × 0.1, as the archs' smoke
        b["prefix_embeds"] = (0.1 * torch.randn(
            (batch, cfg.n_prefix_embeds, cfg.d_model), generator=gen,
            device=DEV)).to(cfg.cdtype)

    moe = bool(cfg.n_experts)
    routes = []                 # the kernel step's routing (MoE)

    def step(model, bs=base):
        flat = []

        def leaf(t):
            flat.append(t.detach().requires_grad_(True))
            return flat[-1]

        req = tree_map(leaf, tr)
        kw = {}
        if moe:
            kw = ({"route": [r["top_ids"] for r in routes]} if routes
                  else {"record": routes})
        K.reset_launches()
        total, (loss, aux) = model.lm_loss(bs, req, masks, b, **kw)
        fwd = K.launch_counts()
        got = iter(torch.autograd.grad(total, flat))
        return (total.item(), tree_map(lambda _: next(got), req), fwd,
                (loss.item(), aux.item()))

    def own_routing(model, bs=base):
        """Each MoE layer's choices as ``model`` routes alone, against the
        kernel step's: the share that differ, the choices dropped."""
        rec = []
        with torch.no_grad():
            total = model.lm_loss(bs, tr, masks, b, record=rec)[0].item()
        flips = [(~(r["top_ids"][:, :, None] == k["top_ids"][:, None, :])
                  .any(-1)).float().mean().item()
                 for r, k in zip(rec, routes)]
        return {"loss": total, "flip_share_per_layer": flips,
                "flip_share": sum(flips) / len(flips),
                "dropped_per_layer": [int(r["dropped"]) for r in rec]}

    def worst_gap(ga, gb):
        """(worst max-relative gap, worst cosine, the leaf of the worst
        by the gate's measure) of two grad trees."""
        w_rel, w_cos, w_path = 0.0, 1.0, ""
        for (path, a), (_, g) in zip(flatten_with_paths(ga),
                                     flatten_with_paths(gb)):
            rel, cos = grad_gap(torch, a, g)
            if (cos < w_cos) if bf16 else (rel > w_rel):
                w_path = path
            w_rel, w_cos = max(w_rel, rel), min(w_cos, cos)
        return w_rel, w_cos, w_path

    bf16 = cfg.cdtype == torch.bfloat16
    lk, gk, fk, (lmk, auxk) = step(kern)
    lp, gp, fp, (lmp, auxp) = step(plain)
    routing = {}
    if moe:
        routing = {"routing": {
            "compared": "plain and f32 steps routed as the kernel step",
            "choices_per_layer": routes[0]["top_ids"].numel(),
            "kernels_dropped_per_layer": [int(r["dropped"]) for r in routes],
            "plain_bf16_own": own_routing(plain)}}
    loss_rel = abs(lk - lp) / abs(lp)
    worst_rel, worst_cos, worst_path = worst_gap(gk, gp)
    truth = {}
    if bf16:        # both paths against an f32 plain step, same weights
        f32 = Model(cfg.with_(param_dtype="float32",
                              compute_dtype="float32"), use_kernels=False)
        base32 = tree_map(lambda t: t.float(), base)
        lt, gt, _, _ = step(f32, base32)
        if moe:
            routing["routing"]["f32_own"] = own_routing(f32, base32)
        del base32
        truth = {"loss_f32": lt,
                 "kernels_vs_f32": dict(zip(("worst_grad_rel",
                                             "worst_grad_cos", "leaf"),
                                            worst_gap(gk, gt))),
                 "plain_vs_f32": dict(zip(("worst_grad_rel",
                                           "worst_grad_cos", "leaf"),
                                          worst_gap(gp, gt)))}
        del gt
    want = LM_PER_FORWARD[arch]
    truth_only = bf16 and arch in LM_BF16_TRUTH_ONLY
    cos_floor = LM_BF16_GRAD_COS
    if truth_only:
        cos_floor = min(LM_BF16_GRAD_COS, truth["plain_vs_f32"][
            "worst_grad_cos"] - LM_BF16_COS_SLACK)
    if truth_only:
        gate = (f"cos >= {cos_floor} to f32 (min of {LM_BF16_GRAD_COS} and "
                f"the plain step's cosine to f32 less {LM_BF16_COS_SLACK})")
    elif bf16:
        gate = (f"cos >= {LM_BF16_GRAD_COS} to f32"
                + (" and to plain" if init == "E" else ""))
    else:
        gate = f"rel <= {TRAIN_GRAD_TOL}"
    out = {"phase": "lm", "check": "one full-width lm_loss step, kernels vs "
           "plain", "model": cfg.name, "dtype": str(cfg.cdtype).split(".")[1],
           "init": "E off zero" if init == "E" else
           "A, B and E perturbed (phase 6's)",
           "batch": [batch, seq], "enc_len": seq + LM_ENC_EXTRA
           if cfg.is_encoder_decoder else None,
           "grads_compared": len(flatten_with_paths(gk)),
           "loss_kernels": lk, "loss_plain": lp, "loss_rel_diff": loss_rel,
           **({"lm_loss_kernels": lmk, "aux_kernels": auxk,
               "lm_loss_plain": lmp, "aux_plain": auxp,
               "router_aux_coef": cfg.router_aux_coef, **routing}
              if moe else {}),
           "loss_tol": LM_BF16_LOSS_RTOL if bf16 else TRAIN_STEP_TOL,
           "worst_grad_rel": worst_rel, "worst_grad_cos": worst_cos,
           "worst_grad_leaf": worst_path,
           "grad_gate": gate,
           "forward_launches": fk, "plain_launches": fp,
           "expected_per_forward": want, **truth}
    del gk, gp
    gc.collect()
    if init == "E":
        opt = adam(linear_decay(2e-3, LM_STEPS))
        state = opt.init(tr)
        one = ST.make_train_step(kern, opt, task="lm")
        # operations that wait on the card in one step (the routing is
        # written to make none)
        out["step_sync_ops"] = counted_syncs(
            torch, lambda: one(base, tr, state, masks, b))[1]
        torch.cuda.reset_peak_memory_stats()
        prof = profile_step(torch, lambda: one(base, tr, state, masks, b),
                            n_steps=2, top=15)
        out.update(prof)
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        out["tokens_per_s"] = batch * seq / (prof["step_host_wall_ms"] / 1e3)
    out["nvidia_smi"] = nvidia_smi()
    emit(out)
    if loss_rel > (LM_BF16_LOSS_RTOL if bf16 else TRAIN_STEP_TOL):
        raise AssertionError(f"{cfg.name} lm step: loss differs by "
                             f"{loss_rel}")
    if (init == "E" and not truth_only and worst_cos < LM_BF16_GRAD_COS) \
            if bf16 else (worst_rel > TRAIN_GRAD_TOL):
        raise AssertionError(f"{cfg.name} lm step: grad {worst_path} differs "
                             f"(rel {worst_rel}, cos {worst_cos})")
    if truth and truth["kernels_vs_f32"]["worst_grad_cos"] < cos_floor:
        raise AssertionError(f"{cfg.name} lm step: kernel grads against the "
                             f"f32 step: {truth['kernels_vs_f32']}")
    if any(fk[k] != n for k, n in want.items()) or fk["bea_batched"] \
            or fk["bea_dense_grouped"]:
        raise AssertionError(f"{cfg.name} lm step forward launched {fk}, "
                             f"expected {want}")
    if any(fp.values()):
        raise AssertionError(f"the plain step launched kernels: {fp}")
    return out


def lm_train_runs(torch, arch, cfg, batch: int, seq: int) -> dict:
    """``launch/train.py`` at full width for LM_STEPS steps through the
    kernels (its ``main``, the user's entry point: the counts zeroed just
    before it, read just after) and the same loop through the plain
    versions.  Every forward launches LM_PER_FORWARD; each step's loss
    within LM_BF16_LOSS_RTOL (bf16) or TRAIN_LOSS_RTOL (f32, phase 6's
    gate for two runs) of plain.  Both runs must have trained: the loss on
    a held-out batch (unseen rows of the same Markov chain:
    ``make_lm_stream`` at seed 0 drawn one batch longer, its last rows)
    falls from the initial adapters to the trained ones, and the mean of
    the last 5 steps' losses is below that of the first 5.  Each step draws
    a new batch, so the last step's own loss carries the batches' spread:
    whether it is below the first step's is printed, not gated (Qwen2 at
    the reference's lr 2e-3 moves less in 20 steps than that spread)."""
    import contextlib
    import io

    from repro_torch import kernels as K
    from repro_torch.data.synthetic import make_lm_stream
    from repro_torch.launch import train as TR
    from repro_torch.models import Model
    from repro_torch.pytree import materialize

    argv = ["--arch", arch, "--full", "--steps", str(LM_STEPS), "--batch",
            str(batch), "--seq", str(seq)]
    logs = {}
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rk = TR.main(argv)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    logs["kernels"] = buf.getvalue().splitlines()
    gc.collect()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rp = TR.run(cfg, steps=LM_STEPS, batch=batch, seq=seq, device=DEV,
                    use_kernels=False)
    logs["plain"] = buf.getvalue().splitlines()
    want = {k: n * LM_STEPS for k, n in LM_PER_FORWARD[arch].items()}
    lk, lp = rk["losses"], rp["losses"]
    held = make_lm_stream((LM_STEPS + 1) * batch, cfg.vocab_size, seq,
                          seed=0)
    hb = {k: torch.as_tensor(held[k][-batch:], device=DEV).long()
          for k in ("tokens", "targets")}
    if cfg.is_encoder_decoder:
        hb["enc_tokens"] = hb["tokens"]
    if cfg.modality == "vision":        # train.py's zero patches
        hb["prefix_embeds"] = torch.zeros(
            batch, cfg.n_prefix_embeds, cfg.d_model, dtype=cfg.cdtype,
            device=DEV)
    tr0 = materialize(Model(cfg).trainable_meta(), 0, DEV)   # run's init
    held_out = {}
    with torch.no_grad():
        for tag, r in (("kernels", rk), ("plain", rp)):
            model = Model(cfg, use_kernels=tag == "kernels")
            held_out[tag] = {
                t: model.lm_loss(r["base"], tr_, r["masks"], hb)[0].item()
                for t, tr_ in (("before", tr0), ("after", r["trainable"]))}
    del tr0
    mean5 = {tag: {"first": sum(ls[:5]) / 5, "last": sum(ls[-5:]) / 5}
             for tag, ls in (("kernels", lk), ("plain", lp))}
    bf16 = cfg.cdtype == torch.bfloat16
    rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    rel_tol = LM_BF16_LOSS_RTOL if bf16 else TRAIN_LOSS_RTOL
    out = {"phase": "lm", "run": "launch/train.py", "argv": argv,
           "model": cfg.name, "losses_kernels": lk, "losses_plain": lp,
           **({"aux_kernels": rk["aux"], "aux_plain": rp["aux"]}
              if cfg.n_experts else {}),
           "held_out_loss": held_out, "mean_of_5_steps": mean5,
           "last_step_below_first": {"kernels": lk[-1] < lk[0],
                                      "plain": lp[-1] < lp[0]},
           "max_loss_rel_diff": rel, "loss_rel_tol": rel_tol,
           "wall_s": rk["wall_s"], "plain_wall_s": rp["wall_s"],
           "tokens_per_s": LM_STEPS * batch * seq / rk["wall_s"],
           "plain_tokens_per_s": LM_STEPS * batch * seq / rp["wall_s"],
           "launches": launches, "expected_launches": want,
           "peak_mem_bytes": peak, "progress": logs,
           "nvidia_smi": nvidia_smi()}
    emit(out)
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"{cfg.name} train.py launched {launches}, "
                             f"expected {want}")
    if not rel <= rel_tol:
        raise AssertionError(f"{cfg.name} train.py: a step's loss differs "
                             f"from plain by {rel} > {rel_tol}")
    for tag, ls in (("kernels", lk), ("plain", lp)):
        if not all(map(math.isfinite, ls)):
            raise AssertionError(f"{cfg.name} train.py ({tag}): a loss is "
                                 f"not finite: {ls}")
        if not held_out[tag]["after"] < held_out[tag]["before"]:
            raise AssertionError(f"{cfg.name} train.py ({tag}): held-out "
                                 f"loss did not fall: {held_out[tag]}")
        if not mean5[tag]["last"] < mean5[tag]["first"]:
            raise AssertionError(f"{cfg.name} train.py ({tag}): the last 5 "
                                 f"steps' mean loss is not below the first "
                                 f"5's: {mean5[tag]}")
    return out


def lm_phase(torch):
    """Phase 11: full-width Qwen2-0.5B, InternVL2-1B, BART-base, Gemma2-2B,
    Gemma3-1B,
    Granite-3.0-1B-A400M, MiniCPM-2B, Mamba2-780M and Zamba2-1.2B LM
    fine-tuning, one SMOKE step each of Kimi-K2, MiniCPM-2B, Mamba2-780M
    and Zamba2-1.2B, and the full-width SSD's check.
    Returns each kernel's launches in the eight ``train.py`` kernel runs,
    the launches per forward as measured (the step check's forward, and
    the ``train.py`` run's launches over its steps), and (d)'s timings."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    cfgs = {arch: get_config(arch) for arch in LM_RUNS}
    qcfg = cfgs["qwen2_0p5b"]
    times = time_lm_kernels(torch, cfgs)
    times["ssd"] = ssd_check(torch)
    time_dense_plans(torch, qcfg)
    time_flash_plans(torch, qcfg)
    dense_rounding(torch, qcfg)
    times["bea_dense"]["host_us"] = lm_host_costs(torch, qcfg)
    gc.collect()
    launches, per_fwd, per_step, per_run = {}, {}, {}, {}
    for arch, cfg in cfgs.items():
        kw = LM_RUNS[arch]
        per_fwd[arch] = lm_step_check(torch, arch, cfg, **kw)[
            "forward_launches"]
        gc.collect()
        lm_step_check(torch, arch, cfg, **kw, init="all")
        gc.collect()
        if arch in LM_BF16_TRUTH_ONLY:  # the same state, decided in f32
            lm_step_check(torch, arch, cfg.with_(
                param_dtype="float32", compute_dtype="float32"), **kw,
                init="all")
            gc.collect()
        run = lm_train_runs(torch, arch, cfg, **kw)
        per_step[arch] = {k: n / LM_STEPS for k, n in run["launches"].items()}
        per_run[arch] = run["launches"]
        for k, n in run["launches"].items():
            launches[k] = launches.get(k, 0) + n
        gc.collect()
        torch.cuda.empty_cache()        # the next model's weights are larger
    for arch, kw in LM_SMOKE_RUNS.items():
        per_fwd[f"{arch}_smoke"] = lm_step_check(
            torch, f"{arch}_smoke", get_config(arch, smoke=True), **kw,
            init="all")["forward_launches"]
        gc.collect()
    emit({"phase": "lm", "seconds": time.perf_counter() - t0,
          "nvidia_smi": nvidia_smi()})
    return {"launches": launches, "times": times, "per_forward": per_fwd,
            "train_py_launches": per_run,
            "train_py_per_step": per_step}


def main() -> int:
    global STARTED
    STARTED = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "card", "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi})

    t0 = time.perf_counter()
    report = _build.build(ptxas_verbose=True)
    for lib in _build.SOURCES:
        _build.load(lib)
    sass = sass_counts(_build)
    logs = {n: r["log"] for n, r in report.items()}
    # ptxas's C75xx notes on wgmma (C7512, C7518: serialized) or setmaxnreg
    # (C7508: ignored) in the libraries with wgmma instances; any would undo
    # a wgmma instance's pipeline
    wgmma_warnings = [ln.strip() for lib in ("bea_fused", "flash_attention")
                      for ln in logs.get(lib, "").splitlines()
                      if "C75" in ln and ("wgmma" in ln or "setmaxnreg" in ln)]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(report),
          "ptxas": {n: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, log in logs.items()},
          "spill_bytes": {n: {**spills(log, "mma_kernel"),
                              **spills(log, "tf32_kernel"),
                              **spills(log, "wgmma_kernel"),
                              **spills(log, "fma_kernel")}
                          for n, log in logs.items()},
          "wgmma_warnings": wgmma_warnings,
          "sass_instructions": sass})
    for lib, funcs in sass.items():
        if sum(f["HMMA"] + f["HGMMA"] for f in funcs.values()) == 0:
            raise AssertionError(f"lib{lib}: no tensor-core instruction in "
                                 f"its SASS")
    for lib in ("bea_fused", "flash_attention"):
        wgmma = {k: f for k, f in sass[lib].items() if "wgmma_kernel" in k}
        if not wgmma or any(f["HGMMA"] == 0 for f in wgmma.values()):
            raise AssertionError(f"lib{lib}: a wgmma instance without "
                                 f"HGMMA: {wgmma}")
    if wgmma_warnings:
        raise AssertionError(f"ptxas serialized wgmma or ignored "
                             f"setmaxnreg: {wgmma_warnings}")
    for lib in ("bea_fused", "flash_attention"):
        f32 = {k: f for k, f in sass[lib].items() if "tf32_kernel" in k}
        if not f32 or any(f["TF32"] == 0 for f in f32.values()):
            raise AssertionError(f"lib{lib}: an f32 instance without TF32 "
                                 f"HMMA: {f32}")
    # the f32 bea_batched: exact f32 FMAs on the CUDA cores, every instance
    # (4- and 8-row chunks × stacked-A tilings × tile widths) built
    fma = {k: f for k, f in sass["bea_batched"].items() if "fma_kernel" in k}
    if len(fma) != F32_BATCHED_INSTANCES or any(
            f["FFMA"] == 0 or f["HMMA"] for f in fma.values()):
        raise AssertionError(f"libbea_batched: want {F32_BATCHED_INSTANCES} "
                             f"fma_kernel instances, each with FFMAs and no "
                             f"HMMA: {fma}")
    checked = [("bea_fused", "tf32_kernel"), ("bea_fused", "wgmma_kernel"),
               ("flash_attention", "tf32_kernel"),
               ("flash_attention", "wgmma_kernel"), ("bea_batched", "mma_kernel"),
               ("bea_batched", "fma_kernel")]
    spilled = {k: v for lib, kind in checked
               for k, v in spills(logs.get(lib, ""), kind).items() if v}
    if spilled:
        raise AssertionError(f"kernel instances spill: {spilled}")

    cfg = get_config("qwen2_0p5b")
    worst = check_kernels(torch, cfg)
    times = time_kernels(torch, cfg)
    lworst, ltimes = legacy_kernels(torch)
    batched_host_costs(torch)
    for k, (err, rel) in lworst.items():
        w = worst.setdefault(k, [0.0, 0.0])
        w[0], w[1] = max(w[0], err), max(w[1], rel)
    engine, launches, prompts = serve(torch, cfg)
    profile_serving(torch, cfg, engine, prompts)
    whole_path(torch, cfg, engine)
    del engine                          # phase 6 measures its own memory
    gc.collect()
    torch.cuda.empty_cache()
    legacy_launches, legacy_by_model = legacy_serve(
        torch, frozenset(f.split("<")[0] for funcs in sass.values()
                         for f in funcs))
    gc.collect()
    trained, identity_up = train(torch, get_config("distilbert"))
    gc.collect()
    # phase 7 at 6 of BERT-base's 12 layers (its widths are the published
    # ones): most of the phase is the host's numpy SVDs of SLoRA's and
    # FeDeRA's per-module inits, which grow with depth and with a slow host
    bert = get_config("bert")
    base_launches, base_per_fwd = baselines(torch, bert.with_(
        n_layers=BASELINE_LAYERS, layer_pattern=("attn",) * BASELINE_LAYERS))
    gc.collect()
    wire_launches, wire_per_fwd = wire(torch, get_config("distilbert"),
                                       identity_up)
    gc.collect()
    grouped, fedsim_launches, fused_launches, data, iid = fedsim(
        torch, get_config("distilbert"))
    gc.collect()
    obs_launches = obs_phase(torch, get_config("distilbert"), data, iid)
    gc.collect()
    lm = lm_phase(torch)

    src = {"bea_dense": ("src/repro_torch/csrc/bea_fused.cu",
                         "src/repro/kernels/bea_fused.py:33"),
           "bea_batched": ("src/repro_torch/csrc/bea_batched.cu",
                           "src/repro/kernels/bea_batched.py:41"),
           "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:33")}
    rows = []
    for kname, (source, replaces) in src.items():
        t = times[kname]
        rows.append({"name": kname, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[kname],
                     "max_abs_err": worst[kname][0],
                     "max_rel_err": worst[kname][1],
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"], "timed": t["shape"],
                     "train": trained.get(kname),
                     "baselines": {"launches": base_launches[kname],
                                   "launches_per_forward": {
                                       n: p.get(kname, 0) for n, p in
                                       base_per_fwd.items()}},
                     "wire": {"launches": wire_launches[kname],
                              "launches_per_forward": {
                                  n: p.get(kname, 0) for n, p in
                                  wire_per_fwd.items()}},
                     "fedsim": {"launches": fedsim_launches[kname],
                                "fused_launches": fused_launches[kname]},
                     "obs": {"launches": obs_launches[kname]},
                     "legacy": {"launches": legacy_launches[kname],
                                "by_model": {a: n[kname] for a, n in
                                             legacy_by_model.items()},
                                **({"f32_max_abs_err":
                                    worst["bea_batched_f32"][0],
                                    "f32_max_rel_err":
                                    worst["bea_batched_f32"][1]}
                                   if kname == "bea_batched" else {}),
                                **ltimes.get(kname, {})},
                     "lm": {"launches": lm["launches"][kname],
                            "launches_per_forward": {
                                a: p.get(kname, 0) for a, p in
                                lm["per_forward"].items()},
                            "train_py_launches_per_step": {
                                a: p.get(kname, 0) for a, p in
                                lm["train_py_per_step"].items()},
                            **lm["times"].get(kname, {})}})
    # the client-grouped f32 instance: its own row, from phase 9 (the
    # cohort runner's main path and its C = 3 timing)
    rows.append({"name": "bea_dense_grouped", "route": "cuda",
                 "source": src["bea_dense"][0],
                 "replaces": src["bea_dense"][1],
                 "launches": grouped["launches"],
                 "max_abs_err": grouped["max_abs_err"],
                 "max_rel_err": grouped["max_rel_err"],
                 "ms": grouped["ms"], "plain_ms": grouped["plain_ms"],
                 "bound_ms": grouped["bound_ms"],
                 "bound_by": grouped["bound_by"],
                 "library_ms": grouped["library_ms"],
                 "separate_calls_ms": grouped["separate_calls_ms"],
                 "timed": grouped["shape"],
                 "fedsim": {"launches": fedsim_launches["bea_dense_grouped"],
                            "fused_launches":
                                fused_launches["bea_dense_grouped"]},
                 "obs": {"launches": obs_launches["bea_dense_grouped"]},
                 "lm": {"launches": lm["launches"]["bea_dense_grouped"]}})
    # the f32 bea_batched (fma_kernel): its own row, from phase 3's BART
    # decode layer and phase 5b's BART run (launches: its 48 a decode step)
    f32b = ltimes["bea_batched"]["f32_bart_decode"]
    rows.append({"name": "bea_batched_f32", "route": "cuda",
                 "source": src["bea_batched"][0],
                 "replaces": src["bea_batched"][1],
                 "launches": legacy_by_model["bart"]["bea_batched"],
                 "max_abs_err": worst["bea_batched_f32"][0],
                 "max_rel_err": worst["bea_batched_f32"][1],
                 **{k: f32b[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
                 "bound_cuda_core_ms": f32b["bound_cuda_core_ms"],
                 "timed": f32b["shape"],
                 "per_linear": {k: {f: v[f] for f in ("ms", "library_ms",
                                                      "bound_ms", "plan")}
                                for k, v in f32b["per_linear"].items()}})
    # flash at head dim 256 (wgmma_kernel<256, 2>): its own row, from phase
    # 11's Gemma runs (launches: their train.py runs; times: Gemma2's call,
    # with Gemma3's and mma_kernel<256>'s beside it)
    g2 = lm["times"]["flash_attention"]["bf16_hd256_gemma2"]
    rows.append({"name": "flash_attention_hd256", "route": "cuda",
                 "source": src["flash_attention"][0],
                 "replaces": src["flash_attention"][1],
                 "launches": sum(lm["train_py_launches"][a]["flash_attention"]
                                 for a in ("gemma2_2b", "gemma3_1b")),
                 "max_abs_err": worst["flash_attention_hd256"][0],
                 "max_rel_err": worst["flash_attention_hd256"][1],
                 **{k: g2[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
                 "library": g2["library"],
                 "sdpa_without_cap_ms": g2["sdpa_without_cap_ms"],
                 "timed": g2["shape"],
                 "lm": {"launches_per_forward": {
                     a: lm["per_forward"][a]["flash_attention"]
                     for a in ("gemma2_2b", "gemma3_1b")},
                     **{k: v for k, v in lm["times"]["flash_attention"].items()
                        if "hd256" in k}}})
    # f32 flash at head dim 36 (tf32_kernel<40, 36>): its own row, from
    # phase 11's MiniCPM SMOKE step (launches: its forward; times: that
    # call at 8 × 512)
    h36 = lm["times"]["flash_attention"]["f32_hd36"]
    rows.append({"name": "flash_attention_hd36", "route": "cuda",
                 "source": src["flash_attention"][0],
                 "replaces": src["flash_attention"][1],
                 "launches": lm["per_forward"]["minicpm_2b_smoke"][
                     "flash_attention"],
                 "max_abs_err": worst["flash_attention_hd36"][0],
                 "max_rel_err": worst["flash_attention_hd36"][1],
                 **{k: h36[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
                 "library": "sdpa", "timed": h36["shape"],
                 "lm": {"launches_per_forward": {
                     "minicpm_2b_smoke": lm["per_forward"][
                         "minicpm_2b_smoke"]["flash_attention"]}}})
    for row in rows:
        if not all(math.isfinite(row[f]) for f in
                   ("ms", "plain_ms", "bound_ms")):
            raise AssertionError(f"{row['name']}: non-finite timing")
    emit({"kernels": rows})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:                   # any failed phase: no result line
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
