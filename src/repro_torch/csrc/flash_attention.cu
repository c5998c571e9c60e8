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
// over 2 kv heads: 16.8 MB, 0.0050 ms of bytes) and BART's f32 calls, among
// them cross-attention with Sq ≠ Sk (Sq = 256 over Sk = 384: 2.4 GFLOP,
// 0.0146 ms as 3xTF32).  The grid covers Sq; the key range, the loads and
// the score mask read Sk, so a cross-attention call is one more shape.
//
// Both types run FlashAttention-2 style on the tensor cores.  One block per
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
// bfloat16, the serving path's type (mma_kernel): mma.sync m16n8k16; the Q
// fragments stay in registers for the whole sweep; P is rounded to bf16 in
// registers and fed straight back as the A operand of P·V (V fragments by
// ldmatrix.trans), as the reference rounds P to V's type; the row sum uses
// the unrounded f32 P.
//
// float32, the training path's type (tf32_kernel): 3xTF32 on mma.sync
// m16n8k8 (mma.cuh), as accurate as f32 FMAs (1×TF32 would miss the 1e-4
// tolerance).  Q is split into TF32 big and small fragments once and kept
// in registers for hd ≤ 64 (64 registers at 64); at hd = 128 that would be
// 128 registers, so Q stays in shared memory and is split per tile.  K and
// V fragments are split as they are loaded, once per k-step.  P·V takes P
// from the S accumulator without shuffles: lane (g, t) holds keys 2t and
// 2t+1 of each 8-key chunk, used as the A fragment's columns t and t+4, and
// B's rows t and t+4 are read from V's rows 2t and 2t+1 (scalar loads:
// ldmatrix cannot transpose 32-bit elements); the permutation of the keys
// cancels in the sum.  V's row pitch of hd + 4 floats puts lane (g, t)'s
// load on bank 8t + g, free of conflicts.
//
// Both: tiles wholly in the causal future or wholly behind the window are
// never visited; ragged Sq and Sk tails are masked in the loads, the scores
// and the store, so any length works.  Masked scores take NEG_INF =
// -2.3819763e38 and contribute exactly zero.  The output is acc / max(l,
// 1e-30).  The dynamic shared-memory limit is raised once per instance.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"

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

// The block's BQ rows of Q (row stride `stride`) into a padded shared
// tile; rows ≥ `rows` are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_q(T* dst, const T* src, long long stride,
                                       int rows, bool aligned, const T* dummy) {
  using F = Flash<T, HD>;
  for (int c = threadIdx.x; c < BQ * F::CHUNKS; c += THREADS) {
    const int row = c / F::CHUNKS, col = (c % F::CHUNKS) * F::E;
    tc::copy16(dst + row * F::LD + col, src + row * stride + col,
               row < rows ? F::E : 0, aligned, dummy);
  }
}

// The K and V tiles of keys [k0, k0 + 64) into their slots, a thread's K
// and V chunks issued together
template <typename T, int HD>
__device__ __forceinline__ void load_kv(T* kd, T* vd, const T* kp, const T* vp,
                                        const Strides& ks, const Strides& vs, int k0,
                                        int Sk, bool aligned, const T* k, const T* v) {
  using F = Flash<T, HD>;
  for (int c = threadIdx.x; c < BKV * F::CHUNKS; c += THREADS) {
    const int row = c / F::CHUNKS, col = (c % F::CHUNKS) * F::E;
    const int valid = k0 + row < Sk ? F::E : 0;
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
// lanes of a row), rows past Sq skipped
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* o, long long row_stride, const float (&oacc)[HD / 8][4],
                                           const float (&l_r)[2], int row0, int Sq, int t2) {
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

  uint32_t qf[HD / 16][4];                // this warp's 16 rows of Q
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    tc::ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);

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
#pragma unroll
      for (int nb = 0; nb < BKV / 8; nb += 2) {
        uint32_t kf[4];
        tc::ldsm_x4(kf, Kt + (nb * 8 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        tc::mma_bf16(s[nb], qf[kk], kf[0], kf[1]);
        tc::mma_bf16(s[nb + 1], qf[kk], kf[2], kf[3]);
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
// some instances at 128 and spills
template <int HD>
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

  load_q<float, HD>(Qs, qp + q0 * qs.s, qs.s, Sq - q0, aligned, q);
  tc::cp_async_commit();
  auto load_slot = [&](int slot, int tile) {
    load_kv<float, HD>(Ks + slot * BKV * LD, Vs + slot * BKV * LD, kp, vp, ks, vs,
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
  store_rows<float, HD>(o + bb * os.b + h * os.h, os.s, oacc, l_r, row0, Sq, t2);
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
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B, H, Sq, hd) and o likewise, k/v: (B, H / group, Sk, hd), each given
// by its element strides (batch, head, seq) with hd contiguous; dtype 0 =
// float32 (3xTF32 tensor cores), 1 = bfloat16 (tensor cores).  Returns
// cudaGetLastError() (or the attribute call's error).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Sq, int Sk, int hd, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss, int group,
    float scale, int causal, int window, float softcap, int dtype,
    void* stream) {
  if (B < 0 || H < 0 || Sq < 0 || Sk < 0 || group < 1 || H % group)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_hd(hd, dtype == 1, q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os,
                   group, scale, causal, window, softcap,
                   static_cast<cudaStream_t>(stream));
}
