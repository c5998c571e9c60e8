// Flash attention forward for Hopper (sm_90a): online softmax with f32
// running max, denominator and accumulator; causal, sliding window, tanh
// soft-capping and GQA (kv head = h / group, read by index, never repeated).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:_kernel
// (through flash_attention and mha_flash).
//
// What bounds it on an H100: at the serving path's prefill (one sequence of
// 64..128 tokens, 14 query heads over 2 kv heads of 64, bf16) the work is
// tiny (≤ 30 MFLOP, ≤ 0.3 MB) and the grid is 14..28 blocks, so latency
// bounds it: the length of each block's dependent chain of loads, products
// and exponentials.  At the training path's (B = 8, S = 128, 12 heads of
// 64, f32, non-causal: 192 blocks) the floor is reading Q, K, V and writing
// O once, 12.6 MB, 0.0038 ms; its 0.8 GFLOP take 0.0024 ms as 3xTF32.  LM
// training adds Qwen2's causal GQA call in bf16 (B = 8, S = 512, 14 query
// over 2 kv heads: 16.8 MB, 0.0050 ms of bytes; 3.8 GFLOP, 0.0038 ms) and
// BART's f32 calls, among them cross-attention with Sq ≠ Sk (Sq = 256 over
// Sk = 384: 2.4 GFLOP, 0.0146 ms as 3xTF32).  The grid covers Sq; the key
// range, the loads and the score mask read Sk, so a cross-attention call is
// one more shape.
//
// bfloat16 from 32 query rows (wgmma_kernel; kernels/flash_attention.py:plan
// takes it for head dims 64, 128 and 256 when TMA can load the operands): at
// Qwen2's training call the compulsory bytes and operations are near
// (0.0050 and 0.0038 ms), and the exponentials cost as much: 16.5 M of
// them at the H100's 16 a clock per SM take about 0.004 ms.  Beyond that,
// every K/V tile goes from L2 to shared memory once per query tile that
// reads it: with 128-row query tiles 37 MB, more than twice the compulsory
// bytes, and a load-only diagnostic build was bound by L2's bandwidth
// (more pipeline stages did not help).  So the design (a) runs both
// products on wgmma fed by TMA, with branch-free masks, (b) widens the
// query tile to what the grid can fill, 4 consumer warpgroups of 64 rows
// each (256 rows: 40% fewer K/V bytes than 128), and (c) walks the tiles
// latest first on one block per SM, so the heavy causal tiles start first
// and the next tile's Q and K/V load while the last one's output leaves.
// Its softmax is mma_kernel's arithmetic operation for operation, and the
// products sum in mma_kernel's order, so without a soft-cap both bodies
// give the same bits (chip_smoke.py phase 3 checks it): a leaner exponent
// (one FMA and one ex2.approx a score) was faster in a diagnostic build but
// moved training's bf16 gradients at phase 11's perturbed state below
// their gate.
// mma_kernel took 0.0411 ms there; this body takes 0.0202 ms, 25% of the
// bound, and SDPA 0.0221 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py
// phase 11).  Not kept, slower on the card (PERF.md §6 has the times):
// a ping-pong of two consumer warpgroups over named barriers, 128-key
// tiles, and one block per tile; several query heads of a kv group in one
// block was not tried: at 7 heads a group the pairs do not divide, and the
// wider query tile gives the same reuse of each K/V tile.
//
// Head dim 256 (Gemma2-2B, Gemma3-1B; LM training at 8 × 512 and 4 × 1024
// tokens, sliding window and soft-cap) is wgmma_kernel<256, 2>: two
// consumer warpgroups, since a consumer's O accumulator is 128 registers
// a thread (the register split at WgFlash), and one Q buffer beside two
// K/V stages, since a 128-row Q tile and a 64-key K/V stage take 64 KB
// each.  With one Q buffer a block loads the next tile's Q only once this
// tile's output has left.  mma_kernel<256> keeps Q in shared memory.
//
// mma.sync bodies (mma_kernel: bfloat16 calls the plan leaves to it, head
// dims 16 and 32, fewer than 32 query rows, strided views; tf32_kernel:
// float32) run FlashAttention-2 style on the tensor cores.  One block per
// (BQ = 16·WARPS query rows, head, batch); each of its warps owns 16 query
// rows.  Q, K and V stay in their own type in shared memory (rows padded by
// 16 bytes, so ldmatrix is free of bank conflicts), loaded by 16-byte
// cp.async copies; the 64-key K/V tiles are double-buffered, the next tile
// in flight while the current one is used.  Each warp computes S = Q·Kᵀ
// from its Q fragments and K fragments by ldmatrix, applies scale,
// soft-cap and the masks in registers (no mask on a tile that none can
// touch; scores in base 2, so each exponential is one exp2), reduces the
// row max across the four lanes of a row with shuffles, and keeps the
// running max, sum and O accumulator in f32 registers.  At S = 64..128 four
// warps per block time best on the card (one or two do not help).
//
// bfloat16 (mma_kernel): mma.sync m16n8k16; the Q
// fragments stay in registers for the whole sweep up to hd 128 (at 256 they
// are loaded from shared memory per k-step); P is rounded to bf16 in
// registers and fed straight back as the A operand of P·V (V fragments by
// ldmatrix.trans), as the reference rounds P to V's type; the row sum uses
// the unrounded f32 P.
//
// float32, the training path's type (tf32_kernel, hd ≤ 128): 3xTF32 on
// mma.sync m16n8k8 (mma.cuh), as accurate as f32 FMAs (1×TF32 would miss the 1e-4
// tolerance).  Q is split into TF32 big and small fragments once and kept
// in registers for hd ≤ 32; from 64 on, beside the P·V sums' fresh
// accumulators, that would pass 255 registers, so Q stays in shared memory
// and is split per tile.  K and
// V fragments are split as they are loaded, once per k-step.  Head dim 36
// (MiniCPM-2B's SMOKE, 144-byte rows) runs on a tile of 40: each row loads
// nine 16-byte chunks and a zero-filled tenth, the contraction and P·V's
// output columns take five steps of 8, and only 36 columns are stored; the
// host passes the true head dim, so the scale stays 1/√36.  P·V takes P
// from the S accumulator without shuffles: lane (g, t) holds keys 2t and
// 2t+1 of each 8-key chunk, used as the A fragment's columns t and t+4, and
// B's rows t and t+4 are read from V's rows 2t and 2t+1 (scalar loads:
// ldmatrix cannot transpose 32-bit elements); the permutation of the keys
// cancels in the sum.  V's row pitch of hd + 4 floats puts lane (g, t)'s
// load on bank 8t + g, free of conflicts.
//
// All bodies: tiles wholly in the causal future or wholly behind the window are
// never visited; ragged Sq and Sk tails are masked in the loads, the scores
// and the store, so any length works.  Masked scores take NEG_INF =
// -2.3819763e38 and contribute exactly zero.  The output is acc / max(l,
// 1e-30).  The dynamic shared-memory limit is raised once per instance.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"
#include "tma_map.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BKV = 64;                 // keys per K/V tile
constexpr int WARPS = 4;                // each owns 16 query rows
constexpr int BQ = 16 * WARPS;
constexpr int THREADS = 32 * WARPS;
constexpr float NEG_INF = -2.3819763e38f;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {  // element strides of a (B, heads, S, hd) view, hd contiguous
  long long b, h, s;
};

template <typename T, int HD>
struct Flash {
  static constexpr int E = 16 / sizeof(T);      // elements per 16-byte chunk
  static constexpr int LD = HD + E;             // shared row pitch (elements)
  static constexpr int CHUNKS = HD / E;         // 16-byte chunks per row
  static constexpr int SMEM = (BQ + 4 * BKV) * LD * sizeof(T);  // Q, 2 × (K, V)
};

// The K/V tiles a block of query rows [q0, q0 + BQ) visits: those with a
// key ≤ its last row (causal) and > its first row − window (window).
struct KvRange {
  int kstart, ntiles;
};

__device__ __forceinline__ KvRange kv_range(int q0, int Sk, int causal, int window) {
  int kv_hi = Sk;
  if (causal) kv_hi = min(Sk, q0 + BQ);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  const int kstart = (kv_lo / BKV) * BKV;
  return {kstart, kv_hi > kstart ? (kv_hi - kstart + BKV - 1) / BKV : 0};
}

// The elements of the 16-byte chunk at column `col` that lie within a row
// of D real dims (a tile HD wide, HD ≥ D, is zero past D)
template <typename T, int HD, int D>
__device__ __forceinline__ int row_chunk(int col) {
  using F = Flash<T, HD>;
  if constexpr (D == HD) return F::E;
  return max(0, min(F::E, D - col));
}

// The block's BQ rows of Q (row stride `stride`, D dims) into a padded
// shared tile HD wide; rows ≥ `rows` and columns ≥ D are zero.
template <typename T, int HD, int D = HD>
__device__ __forceinline__ void load_q(T* dst, const T* src, long long stride,
                                       int rows, bool aligned, const T* dummy) {
  using F = Flash<T, HD>;
  for (int c = threadIdx.x; c < BQ * F::CHUNKS; c += THREADS) {
    const int row = c / F::CHUNKS, col = (c % F::CHUNKS) * F::E;
    tc::copy16(dst + row * F::LD + col, src + row * stride + col,
               row < rows ? row_chunk<T, HD, D>(col) : 0, aligned, dummy);
  }
}

// The K and V tiles of keys [k0, k0 + 64) into their slots, a thread's K
// and V chunks issued together (columns ≥ D zero, as load_q's)
template <typename T, int HD, int D = HD>
__device__ __forceinline__ void load_kv(T* kd, T* vd, const T* kp, const T* vp,
                                        const Strides& ks, const Strides& vs, int k0,
                                        int Sk, bool aligned, const T* k, const T* v) {
  using F = Flash<T, HD>;
  for (int c = threadIdx.x; c < BKV * F::CHUNKS; c += THREADS) {
    const int row = c / F::CHUNKS, col = (c % F::CHUNKS) * F::E;
    const int valid = k0 + row < Sk ? row_chunk<T, HD, D>(col) : 0;
    tc::copy16(kd + row * F::LD + col, kp + (k0 + row) * ks.s + col, valid, aligned, k);
    tc::copy16(vd + row * F::LD + col, vp + (k0 + row) * vs.s + col, valid, aligned, v);
  }
}

// One 16 × 64 score tile (this lane's C fragments: rows row0 and row0 + 8,
// keys k0 + 8·nb + t2 + {0, 1}) → probabilities: scale, soft-cap and mask
// in base 2, fold the tile into the running max m_r and this lane's share
// of the row sums l_r, and rescale the O accumulator.
template <int NO>
__device__ __forceinline__ void softmax_tile(float (&s)[BKV / 8][4], float (&m_r)[2],
                                             float (&l_r)[2], float (&oacc)[NO][4],
                                             float scale, float softcap, bool open,
                                             int row0, int k0, int t2, int Sk,
                                             int causal, int window) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int nb = 0; nb < BKV / 8; ++nb)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float val = s[nb][c] * scale;
      if (softcap > 0.f) val = softcap * tanhf(val / softcap);
      val *= LOG2E;                       // scores kept in base 2 for exp2
      if (!open) {
        const int qpos = row0 + 8 * (c >> 1), kpos = k0 + nb * 8 + t2 + (c & 1);
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        val = ok ? val : NEG_INF;
      }
      s[nb][c] = val;
      mx[c >> 1] = fmaxf(mx[c >> 1], val);
    }
  float corr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    const float m_new = fmaxf(m_r[hh], mx[hh]);
    corr[hh] = exp2f(m_r[hh] - m_new);
    m_r[hh] = m_new;
    l_r[hh] *= corr[hh];
  }
#pragma unroll
  for (int nb = 0; nb < BKV / 8; ++nb)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float sv = s[nb][c];
      const float p = sv == NEG_INF ? 0.f : exp2f(sv - m_r[c >> 1]);
      s[nb][c] = p;
      l_r[c >> 1] += p;
    }
#pragma unroll
  for (int d = 0; d < NO; ++d) {
    oacc[d][0] *= corr[0];
    oacc[d][1] *= corr[0];
    oacc[d][2] *= corr[1];
    oacc[d][3] *= corr[1];
  }
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// O = acc / l for this lane's two rows (the row sums reduced over the four
// lanes of a row), rows past Sq and columns past D (an even D) skipped
template <typename T, int HD, int D = HD>
__device__ __forceinline__ void store_rows(T* o, long long row_stride, const float (&oacc)[HD / 8][4],
                                           const float (&l_r)[2], int row0, int Sq, int t2) {
  static_assert(D % 2 == 0 && D <= HD, "paired stores");
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_r[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qpos = row0 + 8 * hh;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = o + qpos * row_stride;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      if (D == HD || d * 8 + t2 < D)
        store2(orow + d * 8 + t2, oacc[d][2 * hh] * inv, oacc[d][2 * hh + 1] * inv);
  }
}

// ------------------------------------------------ bfloat16: m16n8k16 -------

template <int HD>
__global__ void __launch_bounds__(THREADS)
mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Sk,
           Strides qs, Strides ks, Strides vs, Strides os, int group,
           float scale, int causal, int window, float softcap, bool aligned) {
  using F = Flash<bf16, HD>;
  constexpr int LD = F::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // BQ × LD
  bf16* Ks = Qs + BQ * LD;                         // 2 × BKV × LD
  bf16* Vs = Ks + 2 * BKV * LD;                    // 2 × BKV × LD

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, bb = blockIdx.z;
  const int hk = h / group;
  const bf16* qp = q + bb * qs.b + h * qs.h;
  const bf16* kp = k + bb * ks.b + hk * ks.h;
  const bf16* vp = v + bb * vs.b + hk * vs.h;
  const KvRange kv = kv_range(q0, Sk, causal, window);

  load_q<bf16, HD>(Qs, qp + q0 * qs.s, qs.s, Sq - q0, aligned, q);
  tc::cp_async_commit();
  auto load_slot = [&](int slot, int tile) {
    load_kv<bf16, HD>(Ks + slot * BKV * LD, Vs + slot * BKV * LD, kp, vp, ks, vs,
                      kv.kstart + tile * BKV, Sk, aligned, k, v);
  };
  if (kv.ntiles > 0) load_slot(0, 0);
  tc::cp_async_commit();
  tc::cp_async_wait<1>();                 // Q has landed
  __syncthreads();

  // this warp's 16 rows of Q as A fragments, k-step kk (16 dims): kept in
  // registers up to hd 128 (32 registers); at 256 they would take 64 beside
  // the O accumulator's 128, so Q stays in shared memory and each fragment
  // is loaded where it is used
  constexpr bool QREG = HD <= 128;
  auto q_frag = [&](int kk, uint32_t (&f)[4]) {
    tc::ldsm_x4(f, Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
  };
  uint32_t qf[QREG ? HD / 16 : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) q_frag(kk, qf[kk]);
  }

  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int row0 = q0 + warp * 16 + g;    // rows row0 and row0 + 8
  float oacc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) oacc[d][c] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};              // this lane's share of the row sums

  for (int t = 0; t < kv.ntiles; ++t) {
    if (t + 1 < kv.ntiles) load_slot((t + 1) & 1, t + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();               // tile t has landed
    __syncthreads();
    const bf16* Kt = Ks + (t & 1) * BKV * LD;
    const bf16* Vt = Vs + (t & 1) * BKV * LD;
    const int k0 = kv.kstart + t * BKV;

    float s[BKV / 8][4];
#pragma unroll
    for (int nb = 0; nb < BKV / 8; ++nb)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nb][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4];
      if constexpr (QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = qf[kk][i];
      } else {
        q_frag(kk, qa);
      }
#pragma unroll
      for (int nb = 0; nb < BKV / 8; nb += 2) {
        uint32_t kf[4];
        tc::ldsm_x4(kf, Kt + (nb * 8 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        tc::mma_bf16(s[nb], qa, kf[0], kf[1]);
        tc::mma_bf16(s[nb + 1], qa, kf[2], kf[3]);
      }
    }

    // a tile whose every key every row of the block may see needs no mask
    const bool open = k0 + BKV <= Sk && (!causal || k0 + BKV - 1 <= q0) &&
                      (window <= 0 || k0 > q0 + BQ - 1 - window);
    softmax_tile(s, m_r, l_r, oacc, scale, softcap, open, row0, k0, t2, Sk,
                 causal, window);

    // O += P·V, 16 keys at a time; P's C fragments are A fragments
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      const uint32_t pa[4] = {tc::pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              tc::pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              tc::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              tc::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int db = 0; db < HD / 8; db += 2) {
        uint32_t vf[4];
        tc::ldsm_x4_t(vf, Vt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                              db * 8 + (lane >> 4) * 8);
        tc::mma_bf16(oacc[db], pa, vf[0], vf[1]);
        tc::mma_bf16(oacc[db + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();                      // slot t & 1 is free for tile t + 2
  }
  tc::cp_async_wait<0>();
  store_rows<bf16, HD>(o + bb * os.b + h * os.h, os.s, oacc, l_r, row0, Sq, t2);
}

// ------------------------------------------ float32: 3xTF32 m16n8k8 --------

// minBlocks = 1 lets ptxas take up to 255 registers: without it, it keeps
// some instances at 128 and spills.  D is the call's head dim, HD the
// tile's: a head dim that is no multiple of 8 (MiniCPM's 36) runs on a tile
// padded to the next multiple, whose columns past D load as zeros (their
// products add nothing to Q·Kᵀ and give zero columns of O, not stored).
template <int HD, int D = HD>
__global__ void __launch_bounds__(THREADS, 1)
tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
            Strides qs, Strides ks, Strides vs, Strides os, int group,
            float scale, int causal, int window, float softcap, bool aligned) {
  using F = Flash<float, HD>;
  constexpr int LD = F::LD;
  // split Q fragments kept in registers up to HD = 32; at 64 they and the
  // P·V sums' fresh accumulators (mma.cuh) would pass 255 registers
  constexpr bool QREG = HD <= 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // BQ × LD
  float* Ks = Qs + BQ * LD;                         // 2 × BKV × LD
  float* Vs = Ks + 2 * BKV * LD;                    // 2 × BKV × LD

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, bb = blockIdx.z;
  const int hk = h / group;
  const float* qp = q + bb * qs.b + h * qs.h;
  const float* kp = k + bb * ks.b + hk * ks.h;
  const float* vp = v + bb * vs.b + hk * vs.h;
  const KvRange kv = kv_range(q0, Sk, causal, window);

  load_q<float, HD, D>(Qs, qp + q0 * qs.s, qs.s, Sq - q0, aligned, q);
  tc::cp_async_commit();
  auto load_slot = [&](int slot, int tile) {
    load_kv<float, HD, D>(Ks + slot * BKV * LD, Vs + slot * BKV * LD, kp, vp, ks, vs,
                       kv.kstart + tile * BKV, Sk, aligned, k, v);
  };
  if (kv.ntiles > 0) load_slot(0, 0);
  tc::cp_async_commit();
  tc::cp_async_wait<1>();                 // Q has landed
  __syncthreads();

  // this warp's 16 rows of Q, k-step kk (8 dims), split into TF32 parts
  auto q_split = [&](int kk, uint32_t (&big)[4], uint32_t (&small)[4]) {
    uint32_t raw[4];
    tc::ldsm_x4(raw, Qs + (warp * 16 + (lane & 15)) * LD + kk * 8 + (lane >> 4) * 4);
    tc::split_frag(raw, big, small);
  };
  constexpr int QK = QREG ? HD / 8 : 1;
  uint32_t qb[QK][4], qsm[QK][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) q_split(kk, qb[kk], qsm[kk]);
  }

  const int g = lane >> 2, t = lane & 3, t2 = 2 * t;
  const int row0 = q0 + warp * 16 + g;    // rows row0 and row0 + 8
  float oacc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) oacc[d][c] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};              // this lane's share of the row sums

  for (int it = 0; it < kv.ntiles; ++it) {
    if (it + 1 < kv.ntiles) load_slot((it + 1) & 1, it + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();               // tile it has landed
    __syncthreads();
    const float* Kt = Ks + (it & 1) * BKV * LD;
    const float* Vt = Vs + (it & 1) * BKV * LD;
    const int k0 = kv.kstart + it * BKV;

    float s[BKV / 8][4];
#pragma unroll
    for (int nb = 0; nb < BKV / 8; ++nb)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nb][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      uint32_t ab[4], as[4];
      if constexpr (QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) ab[i] = qb[kk][i], as[i] = qsm[kk][i];
      } else {
        q_split(kk, ab, as);
      }
#pragma unroll
      for (int nb = 0; nb < BKV / 8; nb += 2) {
        // keys 8·nb.. and 8·(nb+1).., dims 8·kk..+3 | +4..+7: B fragments
        uint32_t kf[4], kb[4], ksm[4];
        tc::ldsm_x4(kf, Kt + (nb * 8 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 8 +
                            ((lane >> 3) & 1) * 4);
        tc::split_frag(kf, kb, ksm);
        tc::mma_3xtf32_short(s[nb], ab, as, {kb[0], kb[1]}, {ksm[0], ksm[1]});
        tc::mma_3xtf32_short(s[nb + 1], ab, as, {kb[2], kb[3]}, {ksm[2], ksm[3]});
      }
    }

    const bool open = k0 + BKV <= Sk && (!causal || k0 + BKV - 1 <= q0) &&
                      (window <= 0 || k0 > q0 + BQ - 1 - window);
    softmax_tile(s, m_r, l_r, oacc, scale, softcap, open, row0, k0, t2, Sk,
                 causal, window);

    // O += P·V, 8 keys at a time: this lane's keys 2t, 2t+1 of the chunk
    // are A's columns t, t+4 and B's rows t, t+4
#pragma unroll
    for (int kc = 0; kc < BKV / 8; ++kc) {
      const uint32_t pr[4] = {__float_as_uint(s[kc][0]), __float_as_uint(s[kc][2]),
                              __float_as_uint(s[kc][1]), __float_as_uint(s[kc][3])};
      uint32_t pb[4], psm[4];
      tc::split_frag(pr, pb, psm);
      const float* vrow = Vt + (kc * 8 + t2) * LD + g;
#pragma unroll
      for (int db = 0; db < HD / 8; ++db) {
        const uint32_t vr[2] = {__float_as_uint(vrow[db * 8]),
                                __float_as_uint(vrow[LD + db * 8])};
        uint32_t vb[2], vsm[2];
        tc::split_frag(vr, vb, vsm);
        tc::mma_3xtf32(oacc[db], pb, psm, vb, vsm);
      }
    }
    __syncthreads();                      // slot it & 1 is free for tile it + 2
  }
  tc::cp_async_wait<0>();
  store_rows<float, HD, D>(o + bb * os.b + h * os.h, os.s, oacc, l_r, row0, Sq, t2);
}

// ------------------------- bfloat16 at training rows: wgmma fed by TMA ------

// tanh(x) = 1 − 2 / (2^(2x·log2 e) + 1), branch-free (±1 where the power
// overflows or vanishes): tanhf's branches, or a division's slow-path
// call, between a wgmma and its wait would make ptxas serialize the wgmma
__device__ __forceinline__ float tanh_exp2(float x) {
  return 1.f - __fdividef(2.f, exp2f(2.f * LOG2E * x) + 1.f);
}

// The wgmma body's online softmax over one tile of this lane's two rows
// (row0, row0 + 8) of the m64nN accumulator, s[4i + c] at key k0 + 8i + t2
// + (c & 1): probabilities into s, the running max m_r (base 2) and this
// lane's share of the row sums l_r updated, and the factor `corr` by which
// the O accumulator's rows must be rescaled.  Without a soft-cap it is
// mma_kernel's arithmetic operation for operation (softmax_tile: the same
// roundings, exp2f, the row sums in the same order), so both bodies give
// the same bits: training's bf16 gradients at a sensitive state moved by
// more than a gate's width when the exponent was folded into one FMA and
// ex2.approx.  The mask is branch-free (the keys row0 + 8h sees are k0 +
// t2 + e for e in [lo_h, lo_h + span_h), e = 8i + (c & 1) a constant once
// unrolled); a masked score takes NEG_INF, and a row still wholly masked
// takes bias 0, so its exponentials are exp2f(NEG_INF) = 0 as mma_kernel's
// select gives.  The soft-cap uses tanh_exp2 (inv_cap = 1 / softcap).
template <int NS>
__device__ __forceinline__ void softmax_rows(float (&s)[NS], float (&m_r)[2], float (&l_r)[2],
                                             float (&corr)[2], float scale, float softcap,
                                             float inv_cap, bool open, int row0, int k0,
                                             int t2, int Sk, int causal, int window) {
  float mx[2] = {NEG_INF, NEG_INF};
  if (open && softcap <= 0.f) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float val = s[i] * scale * LOG2E;
      s[i] = val;
      mx[(i & 3) >> 1] = fmaxf(mx[(i & 3) >> 1], val);
    }
  } else {
    int lo[2], span[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = row0 + 8 * h - k0 - t2;
      const int hi = min(open ? NS * 2 : Sk - k0 - t2, causal && !open ? q + 1 : NS * 2);
      lo[h] = window > 0 && !open ? max(q - window + 1, 0) : 0;
      span[h] = max(hi - lo[h], 0);
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int nb = i >> 2, cc = i & 3, h = cc >> 1;
      float val = s[i] * scale;
      if (softcap > 0.f) val = softcap * tanh_exp2(val * inv_cap);
      val *= LOG2E;
      const bool ok = static_cast<unsigned>(8 * nb + (cc & 1) - lo[h]) <
                      static_cast<unsigned>(span[h]);
      val = ok ? val : NEG_INF;
      s[i] = val;
      mx[h] = fmaxf(mx[h], val);
    }
  }
  float bias[2];                           // −(the row's max), 0 while all masked
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    const float m_new = fmaxf(m_r[hh], mx[hh]);
    corr[hh] = exp2f(m_r[hh] - m_new);
    m_r[hh] = m_new;
    l_r[hh] *= corr[hh];
    bias[hh] = m_new == NEG_INF ? 0.f : -m_new;
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int hh = (i & 3) >> 1;
    const float p = exp2f(s[i] + bias[hh]);
    s[i] = p;
    l_r[hh] += p;
  }
}

namespace fw {
constexpr int ROW = 128;             // bytes of a 64-wide bf16 box row (128-byte swizzle)
constexpr int SMEM_MAX = 232448;     // an H100 block's shared memory
constexpr int BAR_OUT = 1;           // named barriers of the consumer warpgroups (1..NC)
}  // namespace fw

// NC consumer warpgroups of 64 query rows each, and a producer warpgroup
template <int HD, int NC>
struct WgFlash {
  static constexpr int BM = 64 * NC;                   // query rows of a tile
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int CONSUMER_WARPS = 4 * NC;        // arrivals that free a K/V stage
  // registers: ptxas gives every thread LAUNCH_REGS (65536 over the block,
  // rounded down to 8); setmaxnreg then moves the producer's spare ones to
  // the consumers, which can take no more than it frees (else they wait
  // in setmaxnreg forever).  At NC = 2: 168 at launch, the producer keeps
  // 40 and frees 128 a thread, each consumer gains 64 (232).  A consumer
  // thread holds its O accumulator (64 rows × HD columns over 128 threads:
  // HD / 2 floats), a 64 × 64 score tile (32) and P as bf16 fragments
  // (16): at hd 256 that is 176 of the 232, the rest for the softmax's
  // masks, sums and addresses (chip_smoke.py phase 2 gates its spills).
  static constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
  static constexpr int PRODUCER_REGS = NC == 2 ? 40 : NC == 3 ? 32 : 24;
  static constexpr int CONSUMER_REGS = NC == 2 ? 232 : NC == 3 ? 160 : 112;
  static_assert((LAUNCH_REGS - PRODUCER_REGS) >= NC * (CONSUMER_REGS - LAUNCH_REGS),
                "setmaxnreg");
  static constexpr int HB = HD / 64;                   // 64-wide boxes across hd
  static constexpr int Q_BOX = BM * fw::ROW;
  static constexpr int Q_BYTES = HB * Q_BOX;
  static constexpr int KV_BOX = BKV * fw::ROW;
  static constexpr int KV_BYTES = HB * KV_BOX;         // one K or V tile
  // two Q tiles (the next tile's Q loads while this one's output leaves)
  // and a ring of three K/V stages where they fit, else fewer: at hd 256
  // a Q tile is 64 KB and a K/V stage 64 KB, so one Q tile and two stages
  // (193 KB of the 227)
  static constexpr int fixed(int q) { return 1024 + q * Q_BYTES + 16 * 8; }
  static constexpr int QBUF = fixed(2) + 2 * 2 * KV_BYTES <= fw::SMEM_MAX ? 2 : 1;
  // 1024 bytes of alignment slack, QBUF Q tiles, 16 barriers
  static constexpr int FIXED = fixed(QBUF);
  static constexpr int STAGES = FIXED + 3 * 2 * KV_BYTES <= fw::SMEM_MAX ? 3 : 2;
  static constexpr int SMEM = FIXED + STAGES * 2 * KV_BYTES;
  static_assert(HD % 64 == 0 && BKV % 64 == 0 && NC >= 2 && NC <= 4, "tile");
  static_assert(SMEM <= fw::SMEM_MAX, "shared memory");
};

// The keys rows [r0, r0 + rows) may see: [x, y)
__device__ __forceinline__ int2 key_span(int r0, int rows, int Sk, int causal, int window) {
  return make_int2(window > 0 ? max(0, r0 - window + 1) : 0, causal ? min(Sk, r0 + rows) : Sk);
}

// Tile t of the grid's walk: the BM-row query tiles latest first (under a
// causal mask the late tiles visit the most keys, so they start first and
// the light ones fill the last wave), then head, then batch; a kv group's
// query heads run side by side and share its K/V tiles in L2.
struct WgTile {
  int q0, h, b;
};

__device__ __forceinline__ WgTile wg_tile(int t, int H, int B, int nq, int BM) {
  return {(nq - 1 - t / (H * B)) * BM, t % H, (t / H) % B};
}

// One block walks the tiles blockIdx.x, + gridDim.x, ... (one block per
// tile when the grid covers them).  Warpgroup 0 is the producer: one thread
// loads each tile's Q (BM rows × hd, 128-byte swizzled boxes of 64 dims)
// into one of QBUF Q buffers, and its K and V tiles (BKV keys × hd; keys
// past Sk arrive as zeros) into a ring of STAGES stages, by TMA on
// full/empty mbarriers; K and V of a stage land on barriers of their own.
// Warpgroups 1..NC own rows 0..63, 64..127, ... of the tile: S = Q·Kᵀ by
// wgmma m64nBKVk16 (Q and K both K-major), the online softmax on the
// accumulator, then O += P·V by wgmma with P from registers (the
// accumulator rounded to bf16 as the reference rounds it) and V MN-major
// through the transpose bit.  Within a warpgroup, tile j's Q·Kᵀ is issued
// before tile j-1's P·V, and tile j's softmax runs while that P·V is in
// flight.  A warpgroup skips the tiles wholly outside its own rows' keys
// (its causal future, behind its window) and frees them unread.  The
// output, acc / max(l, 1e-30) rounded once, goes through the warpgroup's
// rows of the Q buffer and leaves by TMA stores that clip rows past Sq.
// Registers go to the consumers (setmaxnreg).
template <int HD, int NC>
__global__ void __launch_bounds__(WgFlash<HD, NC>::THREADS, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const __grid_constant__ CUtensorMap omap, int B, int H, int Sq, int Sk,
             int group, float scale, int causal, int window, float softcap,
             float inv_cap) {
  using T = WgFlash<HD, NC>;
  constexpr int S = T::STAGES, BM = T::BM;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* kv = smem + T::QBUF * T::Q_BYTES;     // stage s: K, then V
  uint64_t* qfull = reinterpret_cast<uint64_t*>(kv + S * 2 * T::KV_BYTES);
  uint64_t* qempty = qfull + 2;
  uint64_t* kfull = qempty + 2;
  uint64_t* vfull = kfull + S;
  uint64_t* empty = vfull + S;

  const int nq = (Sq + BM - 1) / BM, tiles = nq * H * B;
  if (threadIdx.x == 0) {
    for (int i = 0; i < T::QBUF; ++i) {
      tc::mbar_init(&qfull[i], 1);
      tc::mbar_init(&qempty[i], NC);                   // a leader of each consumer
    }
    for (int s = 0; s < S; ++s) {
      tc::mbar_init(&kfull[s], 1);
      tc::mbar_init(&vfull[s], 1);
      tc::mbar_init(&empty[s], T::CONSUMER_WARPS);
    }
    tc::mbar_init_fence();
  }
  __syncthreads();

  // the role as a warp-uniform value (a shuffle's result), so that the
  // compiler treats the two branches as uniform and keeps wgmma async
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {                      // ---- producer ----
    tc::setmaxnreg_dec<T::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x, i = 0; t < tiles; t += gridDim.x, ++i) {
        const WgTile c = wg_tile(t, H, B, nq, BM);
        const int hk = c.h / group, qb = i % T::QBUF;
        const int2 span = key_span(c.q0, BM, Sk, causal, window);
        const int kstart = span.x / BKV * BKV;
        const int n = span.y > kstart ? (span.y - kstart + BKV - 1) / BKV : 0;
        tc::mbar_wait(&qempty[qb], ((i / T::QBUF) & 1) ^ 1);
        tc::mbar_arrive_expect_tx(&qfull[qb], T::Q_BYTES);
#pragma unroll
        for (int hb = 0; hb < T::HB; ++hb)
          tc::tma_load_4d(smem + qb * T::Q_BYTES + hb * T::Q_BOX, &qmap, &qfull[qb], 64 * hb,
                          c.h, c.q0, c.b);
        for (int j = 0; j < n; ++j) {
          tc::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = kv + stage * 2 * T::KV_BYTES;
          const int k0 = kstart + j * BKV;
          tc::mbar_arrive_expect_tx(&kfull[stage], T::KV_BYTES);
#pragma unroll
          for (int hb = 0; hb < T::HB; ++hb)
            tc::tma_load_4d(st + hb * T::KV_BOX, &kmap, &kfull[stage], 64 * hb, hk, k0, c.b);
          tc::mbar_arrive_expect_tx(&vfull[stage], T::KV_BYTES);
#pragma unroll
          for (int hb = 0; hb < T::HB; ++hb)
            tc::tma_load_4d(st + T::KV_BYTES + hb * T::KV_BOX, &vmap, &vfull[stage], 64 * hb,
                            hk, k0, c.b);
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {                              // ---- consumers ----
    tc::setmaxnreg_inc<T::CONSUMER_REGS>();
    const int cw = role - 1;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t2 = (lane & 3) * 2;
    const bool leader = threadIdx.x % 128 == 0;      // of this warpgroup
    const uint32_t own = tc::smem_u32(smem) + cw * 64 * fw::ROW;   // its Q rows
    const uint32_t kv_addr = tc::smem_u32(kv);
    int stage = 0;
    uint32_t phase = 0;
    auto advance = [&] {
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    };
    // a tile this warpgroup does not read: wait until it has landed (so the
    // arrival cannot count toward the stage's previous use, nor free the
    // stage while a load into it is in flight), then free it
    auto pass = [&] {
      tc::mbar_wait(&kfull[stage], phase);
      tc::mbar_wait(&vfull[stage], phase);
      tc::mbar_arrive_if(&empty[stage], lane == 0);
      advance();
    };
    for (int t = blockIdx.x, i = 0; t < tiles; t += gridDim.x, ++i) {
      const WgTile c = wg_tile(t, H, B, nq, BM);
      const int2 span = key_span(c.q0, BM, Sk, causal, window);
      const int kstart = span.x / BKV * BKV;
      const int n = span.y > kstart ? (span.y - kstart + BKV - 1) / BKV : 0;
      const int w0 = c.q0 + 64 * cw;                  // this warpgroup's first row
      const int2 mine = key_span(w0, 64, Sk, causal, window);
      const int j0 = (mine.x - kstart) / BKV;
      int j1 = mine.y > kstart ? min(n, (mine.y - kstart + BKV - 1) / BKV) : 0;
      if (w0 >= Sq || j1 < j0) j1 = j0;
      const int row0 = w0 + warp * 16 + g;             // rows row0 and row0 + 8
      const int qb = i % T::QBUF;
      const uint32_t qa = own + qb * T::Q_BYTES;

      float o[HD / 2], s[BKV / 2], corr[2];
      uint32_t pf[BKV / 16][4];
#pragma unroll
      for (int d = 0; d < HD / 2; ++d) o[d] = 0.f;
      float m_r[2] = {NEG_INF, NEG_INF};
      float l_r[2] = {0.f, 0.f};                       // this lane's share of the row sums

      // S = Q·Kᵀ for the tile in stage `st` (a k16 step: +32 bytes in a
      // box row; every fourth, the next 64-dim box)
      auto qk = [&](int st) {
        const uint32_t ka = kv_addr + st * 2 * T::KV_BYTES;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          tc::wgmma_ss<0>(s,
                          tc::make_desc(qa + (kk / 4) * T::Q_BOX + (kk % 4) * 32, 16, 1024,
                                        tc::k128B),
                          tc::make_desc(ka + (kk / 4) * T::KV_BOX + (kk % 4) * 32, 16, 1024,
                                        tc::k128B),
                          kk > 0);
      };
      // O += P·V for the tile in stage `st`: V MN-major, 64-dim boxes
      // KV_BOX apart (LBO), 8-key groups 1 KB apart; a k16 step is 16 keys
      auto pv = [&](int st) {
        const uint64_t vd =
            tc::make_desc(kv_addr + st * 2 * T::KV_BYTES + T::KV_BYTES, T::KV_BOX, 1024,
                          tc::k128B);
#pragma unroll
        for (int kc = 0; kc < BKV / 16; ++kc) tc::wgmma_rs<1>(o, pf[kc], vd + 128 * kc, 1);
      };
      auto softmax = [&](int j) {
        const int k0 = kstart + j * BKV;
        // a tile whose every key all of this warpgroup's rows may see
        const bool open = k0 + BKV <= Sk && (!causal || k0 + BKV - 1 <= w0) &&
                          (window <= 0 || k0 > w0 + 63 - window);
        softmax_rows(s, m_r, l_r, corr, scale, softcap, inv_cap, open, row0, k0, t2, Sk,
                     causal, window);
      };
      // P rounded to bf16 and packed as k16 A fragments (keys 16kc..+15)
      auto pack = [&] {
#pragma unroll
        for (int kc = 0; kc < BKV / 16; ++kc)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            pf[kc][q] = tc::pack_bf16(s[8 * kc + 2 * q], s[8 * kc + 2 * q + 1]);
      };

      tc::mbar_wait(&qfull[qb], (i / T::QBUF) & 1);
      for (int j = 0; j < j0; ++j) pass();
      if (j1 > j0) {
        tc::mbar_wait(&kfull[stage], phase);
        tc::wgmma_fence();
        qk(stage);
        tc::wgmma_commit();
        tc::wgmma_wait<0>();
        tc::fence_regs(s);
        softmax(j0);                                   // o is zero: no rescale
        pack();
        int pstage = stage;
        uint32_t pphase = phase;
        advance();
        for (int j = j0 + 1; j < j1; ++j) {
          tc::mbar_wait(&kfull[stage], phase);
          tc::mbar_wait(&vfull[pstage], pphase);
          tc::wgmma_fence();
          qk(stage);
          tc::wgmma_commit();
          pv(pstage);
          tc::wgmma_commit();
          tc::wgmma_wait<1>();                         // S of tile j is in
          tc::fence_regs(s);
          softmax(j);
          tc::wgmma_wait<0>();                         // P·V of tile j - 1 is in
          tc::fence_regs(o);
          tc::fence_regs(pf);
          tc::mbar_arrive_if(&empty[pstage], lane == 0);
#pragma unroll
          for (int d = 0; d < HD / 8; ++d) {
            o[4 * d] *= corr[0];
            o[4 * d + 1] *= corr[0];
            o[4 * d + 2] *= corr[1];
            o[4 * d + 3] *= corr[1];
          }
          pack();
          pstage = stage;
          pphase = phase;
          advance();
        }
        tc::mbar_wait(&vfull[pstage], pphase);
        tc::wgmma_fence();
        pv(pstage);
        tc::wgmma_commit();
        tc::wgmma_wait<0>();
        tc::fence_regs(o);
        tc::mbar_arrive_if(&empty[pstage], lane == 0);
      }
      for (int j = j1; j < n; ++j) pass();

      // O = acc / l rounded to bf16 into this warpgroup's rows of the Q
      // buffer (128-byte swizzle: row r's 16-byte chunk q at q ^ (r % 8)),
      // stored by TMA; the buffer is the producer's again once read
      float inv[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float l = l_r[hh];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[hh] = 1.f / fmaxf(l, 1e-30f);
      }
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = warp * 16 + g + 8 * hh;
          tc::st_shared(qa + (d / 8) * T::Q_BOX + r * fw::ROW + (((d % 8) ^ (r & 7)) * 16) +
                            2 * t2,
                        tc::pack_bf16(o[4 * d + 2 * hh] * inv[hh], o[4 * d + 2 * hh + 1] * inv[hh]));
        }
      tc::fence_proxy_async();
      tc::named_bar_sync(fw::BAR_OUT + cw, 128);
#pragma unroll
      for (int hb = 0; hb < T::HB; ++hb)
        tc::tma_store_4d_if(&omap, qa + hb * T::Q_BOX, 64 * hb, c.h, w0, c.b, leader);
      tc::tma_store_wait_read_if<0>(leader);
      tc::mbar_arrive_if(&qempty[qb], leader);
    }
    tc::tma_store_wait_all_if(leader);
  }
}

// ------------------------------------------------------------ launch -------

template <typename T, int HD, auto Kernel>
int launch_body(const void* q, const void* k, const void* v, void* o, int B,
                int H, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                Strides os, int group, float scale, int causal, int window,
                float softcap, cudaStream_t stream) {
  using F = Flash<T, HD>;
  cudaError_t err = tc::ensure_smem_limit<Kernel>(F::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto chunked = [](const Strides& st) {
    return st.b % F::E == 0 && st.h % F::E == 0 && st.s % F::E == 0;
  };
  const bool aligned = tc::aligned16(q) && tc::aligned16(k) && tc::aligned16(v) &&
                       chunked(qs) && chunked(ks) && chunked(vs);
  // the paired stores need output rows aligned to two elements
  if (reinterpret_cast<uintptr_t>(o) % (2 * sizeof(T)) || os.b % 2 || os.h % 2 ||
      os.s % 2)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  Kernel<<<grid, THREADS, F::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, qs, ks, vs, os, group, scale, causal, window,
      softcap, aligned);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(bool bf16, const void* q, const void* k, const void* v, void* o,
           int B, int H, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
           Strides os, int group, float scale, int causal, int window,
           float softcap, cudaStream_t s) {
  return bf16 ? launch_body<__nv_bfloat16, HD, mma_kernel<HD>>(
                    q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, group, scale,
                    causal, window, softcap, s)
              : launch_body<float, HD, tf32_kernel<HD>>(
                    q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, group, scale,
                    causal, window, softcap, s);
}

int launch_hd(int hd, bool bf16, const void* q, const void* k, const void* v,
              void* o, int B, int H, int Sq, int Sk, Strides qs, Strides ks,
              Strides vs, Strides os, int group, float scale, int causal,
              int window, float softcap, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<16>(bf16, q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, group, scale, causal, window, softcap, s);
    case 32: return launch<32>(bf16, q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, group, scale, causal, window, softcap, s);
    case 64: return launch<64>(bf16, q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, group, scale, causal, window, softcap, s);
    case 128: return launch<128>(bf16, q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, group, scale, causal, window, softcap, s);
    // float32 only (MiniCPM-2B's SMOKE): nine 16-byte chunks a row on a tile
    // padded to 40, five k-steps of 8; bf16 at 36 is on no path
    case 36: return bf16 ? static_cast<int>(cudaErrorInvalidValue)
                         : launch_body<float, 40, tf32_kernel<40, 36>>(q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, group, scale, causal, window, softcap, s);
    // bfloat16 only: an f32 tile of 256 dims does not fit tf32_kernel's
    // shared memory (ROADMAP.md queue 2 item 1)
    case 256: return bf16 ? launch_body<__nv_bfloat16, 256, mma_kernel<256>>(q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, group, scale, causal, window, softcap, s)
                          : static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A (B, heads, S, hd) view as a 4-D TMA map over (hd, heads, S, B) of
// boxes of 64 dims × `rows` rows, 128-byte swizzled; S's bound zero-fills
// ragged loads and clips stores, so no tile reaches the next sequence.  A
// batch of one may have stride 0 (flash_attention's (BH, S, hd) form).
bool flash_map(CUtensorMap* map, const void* base, int B, int heads, int S, int hd,
               const Strides& st, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(B > 1 ? st.b : 8) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  return tc::bf16_tensor_map(map, base, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// the wgmma body on `blocks` blocks walking the tiles (no more than one a
// tile).  TMA takes 16-byte aligned bases and strides; the maps are encoded
// per call and passed by value, so a captured CUDA graph holds its own.
template <int HD, int NC>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int H,
                 int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os,
                 int group, float scale, int causal, int window, float softcap,
                 int blocks, cudaStream_t stream) {
  using T = WgFlash<HD, NC>;
  auto chunked = [](const Strides& st) { return st.b % 8 == 0 && st.h % 8 == 0 && st.s % 8 == 0; };
  if (Sk <= 0 || !tc::aligned16(q) || !tc::aligned16(k) || !tc::aligned16(v) ||
      !tc::aligned16(o) || !chunked(qs) || !chunked(ks) || !chunked(vs) || !chunked(os))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm, om;
  if (!flash_map(&qm, q, B, H, Sq, HD, qs, T::BM) ||
      !flash_map(&km, k, B, H / group, Sk, HD, ks, BKV) ||
      !flash_map(&vm, v, B, H / group, Sk, HD, vs, BKV) ||
      !flash_map(&om, o, B, H, Sq, HD, os, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = tc::ensure_smem_limit<wgmma_kernel<HD, NC>>(T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>((Sq + T::BM - 1) / T::BM) * H * B;
  if (blocks <= 0 || tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = blocks < tiles ? blocks : static_cast<int>(tiles);
  wgmma_kernel<HD, NC><<<grid, T::THREADS, T::SMEM, stream>>>(
      qm, km, vm, om, B, H, Sq, Sk, group, scale, causal, window, softcap,
      softcap > 0.f ? 1.f / softcap : 0.f);
  return static_cast<int>(cudaGetLastError());
}

// the built instances: (head dim, consumer warpgroups)
int launch_wgmma_hd(int hd, int nc, const void* q, const void* k, const void* v, void* o,
                    int B, int H, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                    Strides os, int group, float scale, int causal, int window,
                    float softcap, int blocks, cudaStream_t s) {
  switch (hd * 10 + nc) {
    case 642: return launch_wgmma<64, 2>(q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, group, scale, causal, window, softcap, blocks, s);
    case 643: return launch_wgmma<64, 3>(q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, group, scale, causal, window, softcap, blocks, s);
    case 644: return launch_wgmma<64, 4>(q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, group, scale, causal, window, softcap, blocks, s);
    case 1282: return launch_wgmma<128, 2>(q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, group, scale, causal, window, softcap, blocks, s);
    case 2562: return launch_wgmma<256, 2>(q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, group, scale, causal, window, softcap, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B, H, Sq, hd) and o likewise, k/v: (B, H / group, Sk, hd), each given
// by its element strides (batch, head, seq) with hd contiguous; dtype 0 =
// float32 (3xTF32 tensor cores), 1 = bfloat16 (tensor cores).  body picks
// the kernel (kernels/flash_attention.py:plan): 0 the mma.sync bodies
// (mma_kernel, tf32_kernel); else bfloat16's wgmma_kernel, its consumer
// warpgroups body & 15 and its grid body >> 8 blocks.
// Returns cudaGetLastError() (or the attribute call's error;
// cudaErrorInvalidValue for what the body does not take).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Sq, int Sk, int hd, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss, int group,
    float scale, int causal, int window, float softcap, int dtype, int body,
    void* stream) {
  if (B < 0 || H < 0 || Sq < 0 || Sk < 0 || group < 1 || H % group)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body != 0) {
    if (dtype != 1 || body < 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch_wgmma_hd(hd, body & 15, q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, group,
                           scale, causal, window, softcap, body >> 8, s);
  }
  return launch_hd(hd, dtype == 1, q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os,
                   group, scale, causal, window, softcap, s);
}
