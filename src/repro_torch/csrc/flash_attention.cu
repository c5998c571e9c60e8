// Flash attention forward for Hopper (sm_90a): online softmax with f32
// running max, denominator and accumulator; causal, sliding window, tanh
// soft-capping and GQA (kv head = h / group, read by index, never repeated).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:_kernel
// (through flash_attention and mha_flash).
//
// What bounds it on an H100: at the serving path's prefill (one sequence of
// 64..128 tokens, 14 query heads over 2 kv heads of 64) the work is tiny
// (≤ 30 MFLOP, ≤ 0.3 MB) and the grid is 14..28 blocks, so latency bounds
// it: the length of each block's dependent chain of loads, products and
// exponentials, not bytes or tensor-core flops.
//
// bfloat16, the serving path's type: FlashAttention-2 style on the tensor
// cores.  One block per (TC_BQ = 16·TC_WARPS query rows, head, batch);
// each of its warps owns 16 query rows.  Q, K and V stay bf16 in shared
// memory (rows padded by 16 bytes, so ldmatrix is free of bank conflicts),
// loaded by 16-byte cp.async copies; the 64-key K/V tiles are
// double-buffered, the next tile in flight while the current one is used.
// Each warp keeps its Q fragments in registers for the whole sweep and
// computes S = Q·Kᵀ with mma.sync m16n8k16 (K fragments by ldmatrix),
// applies scale, soft-cap and the masks in registers (no mask on a tile
// that none can touch; scores in base 2, so each exponential is one exp2),
// reduces the row max across the four lanes of a row with shuffles, and
// keeps the running max, sum and O accumulator in f32 registers.  At S =
// 64..128 four warps per block time best on the card (one or two do not
// help).  P is rounded to bf16 in registers and fed straight back
// as the A operand of P·V (V fragments by ldmatrix.trans), as the
// reference rounds P to V's type; the row sum uses the unrounded f32 P.
//
// float32 keeps the SIMT body of the first port as its own instance (K and
// V staged as f32, two threads per query row, CUDA-core FMAs): it is off
// the serving path, and the tensor cores (TF32, about 3 significant digits)
// cannot hold the f32 tolerance of 1e-4.
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

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 128;
constexpr float NEG_INF = -2.3819763e38f;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {  // element strides of a (B, heads, S, hd) view, hd contiguous
  long long b, h, s;
};

// ------------------------------------------------ float32: SIMT body ------

template <int HD>
constexpr int simt_smem_floats() {
  return BQ * (HD + 1) + BKV * (HD + 1) + BKV * HD + BQ * (BKV + 1);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
            Strides qs, Strides ks, Strides vs, Strides os, int group,
            float scale, int causal, int window, float softcap) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // BQ × (HD + 1)
  float* Ks = Qs + BQ * (HD + 1);         // BKV × (HD + 1)
  float* Vs = Ks + BKV * (HD + 1);        // BKV × HD
  float* Ss = Vs + BKV * HD;              // BQ × (BKV + 1)

  constexpr int DH = HD / 2;              // output dims owned by one thread
  constexpr int CH = BKV / 2;             // keys scored by one thread
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, bb = blockIdx.z;
  const int hk = h / group;
  const float* qp = q + bb * qs.b + h * qs.h;
  const float* kp = k + bb * ks.b + hk * ks.h;
  const float* vp = v + bb * vs.b + hk * vs.h;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int rr = i / HD, d = i % HD;
    Qs[rr * (HD + 1) + d] = (q0 + rr < Sq) ? qp[(q0 + rr) * qs.s + d] : 0.f;
  }

  const int row = tid >> 1, half = tid & 1;
  const int qpos = q0 + row;
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float m_i = NEG_INF, l_i = 0.f;

  int kv_hi = Sk;
  if (causal) kv_hi = min(Sk, q0 + BQ);              // keys ≤ last query row
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q0 - window + 1);   // keys > first row − window
  for (int k0 = (kv_lo / BKV) * BKV; k0 < kv_hi; k0 += BKV) {
    __syncthreads();                                  // last tile consumed
    for (int i = tid; i < BKV * HD; i += THREADS) {
      const int rr = i / HD, d = i % HD, kr = k0 + rr;
      const bool in = kr < Sk;
      Ks[rr * (HD + 1) + d] = in ? kp[kr * ks.s + d] : 0.f;
      Vs[rr * HD + d] = in ? vp[kr * vs.s + d] : 0.f;
    }
    __syncthreads();

    float mloc = NEG_INF;
    const float* qr = Qs + row * (HD + 1);
    float* sr = Ss + row * (BKV + 1);
    for (int c = 0; c < CH; ++c) {
      const int col = half * CH + c, kpos = k0 + col;
      const float* kr = Ks + col * (HD + 1);
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      bool ok = kpos < Sk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      s = ok ? s : NEG_INF;
      sr[col] = s;
      mloc = fmaxf(mloc, s);
    }
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    const float m_new = fmaxf(m_i, mloc);
    const float corr = expf(m_i - m_new);
    float lsum = 0.f;
    for (int c = 0; c < CH; ++c) {
      const int col = half * CH + c;
      const float s = sr[col];
      const float p = (s == NEG_INF) ? 0.f : expf(s - m_new);
      sr[col] = p;
      lsum += p;
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    l_i = l_i * corr + lsum;
    m_i = m_new;
    __syncwarp();                                     // partner's half of the row
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= corr;
    for (int c = 0; c < BKV; ++c) {
      const float p = sr[c];
      const float* vr = Vs + c * HD + half * DH;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
    }
  }

  if (qpos < Sq) {
    const float inv = 1.f / fmaxf(l_i, 1e-30f);
    float* orow = o + bb * os.b + h * os.h + qpos * os.s + half * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) orow[d] = acc[d] * inv;
  }
}

template <int HD>
int launch_simt(const void* q, const void* k, const void* v, void* o, int B,
                int H, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                Strides os, int group, float scale, int causal, int window,
                float softcap, cudaStream_t stream) {
  const int smem = simt_smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = tc::ensure_smem_limit<simt_kernel<HD>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  simt_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, qs, ks, vs,
      os, group, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------- bfloat16: tensor cores ------------

constexpr int TC_WARPS = 4;             // each owns 16 query rows
constexpr int TC_BQ = 16 * TC_WARPS;
constexpr int TC_THREADS = 32 * TC_WARPS;


template <int HD>
struct Flash {
  static constexpr int LD = HD + 8;       // shared row pitch (bf16 elements)
  static constexpr int CHUNKS = HD / 8;   // 16-byte chunks per row
  static constexpr int SMEM = (TC_BQ + 4 * BKV) * LD * 2;   // Q, 2 × (K, V)
};

template <int HD>
__global__ void __launch_bounds__(TC_THREADS)
mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Sk,
           Strides qs, Strides ks, Strides vs, Strides os, int group,
           float scale, int causal, int window, float softcap, bool aligned) {
  using F = Flash<HD>;
  constexpr int LD = F::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // TC_BQ × LD
  bf16* Ks = Qs + TC_BQ * LD;                      // 2 × BKV × LD
  bf16* Vs = Ks + 2 * BKV * LD;                    // 2 × BKV × LD

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * TC_BQ, h = blockIdx.y, bb = blockIdx.z;
  const int hk = h / group;
  const bf16* qp = q + bb * qs.b + h * qs.h;
  const bf16* kp = k + bb * ks.b + hk * ks.h;
  const bf16* vp = v + bb * vs.b + hk * vs.h;

  int kv_hi = Sk;
  if (causal) kv_hi = min(Sk, q0 + TC_BQ);           // keys ≤ last query row
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q0 - window + 1);   // keys > first row − window
  const int kstart = (kv_lo / BKV) * BKV;
  const int ntiles = kv_hi > kstart ? (kv_hi - kstart + BKV - 1) / BKV : 0;

  for (int c = tid; c < TC_BQ * F::CHUNKS; c += TC_THREADS) {
    const int row = c / F::CHUNKS, col = (c % F::CHUNKS) * 8;
    tc::copy8(Qs + row * LD + col, qp + (q0 + row) * qs.s + col,
              q0 + row < Sq ? 8 : 0, aligned, q);
  }
  tc::cp_async_commit();
  auto load_kv = [&](int slot, int tile) {
    const int k0 = kstart + tile * BKV;
    bf16* kd = Ks + slot * BKV * LD;
    bf16* vd = Vs + slot * BKV * LD;
    for (int c = tid; c < BKV * F::CHUNKS; c += TC_THREADS) {
      const int row = c / F::CHUNKS, col = (c % F::CHUNKS) * 8;
      const int valid = k0 + row < Sk ? 8 : 0;
      tc::copy8(kd + row * LD + col, kp + (k0 + row) * ks.s + col, valid, aligned, k);
      tc::copy8(vd + row * LD + col, vp + (k0 + row) * vs.s + col, valid, aligned, v);
    }
  };
  if (ntiles > 0) load_kv(0, 0);
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

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_kv((t + 1) & 1, t + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();               // tile t has landed
    __syncthreads();
    const bf16* Kt = Ks + (t & 1) * BKV * LD;
    const bf16* Vt = Vs + (t & 1) * BKV * LD;
    const int k0 = kstart + t * BKV;

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
                      (window <= 0 || k0 > q0 + TC_BQ - 1 - window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nb = 0; nb < BKV / 8; ++nb)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float val = s[nb][c] * scale;
        if (softcap > 0.f) val = softcap * tanhf(val / softcap);
        val *= LOG2E;                     // scores kept in base 2 for exp2
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
    for (int d = 0; d < HD / 8; ++d) {
      oacc[d][0] *= corr[0];
      oacc[d][1] *= corr[0];
      oacc[d][2] *= corr[1];
      oacc[d][3] *= corr[1];
    }

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

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_r[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qpos = row0 + 8 * hh;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    bf16* orow = o + bb * os.b + h * os.h + qpos * os.s;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8 + t2) =
          __floats2bfloat162_rn(oacc[d][2 * hh] * inv, oacc[d][2 * hh + 1] * inv);
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int H, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
               Strides os, int group, float scale, int causal, int window,
               float softcap, cudaStream_t stream) {
  cudaError_t err = tc::ensure_smem_limit<mma_kernel<HD>>(Flash<HD>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto strided8 = [](const Strides& st) {
    return st.b % 8 == 0 && st.h % 8 == 0 && st.s % 8 == 0;
  };
  const bool aligned = tc::aligned16(q) && tc::aligned16(k) && tc::aligned16(v) &&
                       strided8(qs) && strided8(ks) && strided8(vs);
  // the paired bf16 stores need 4-byte aligned output rows
  if (reinterpret_cast<uintptr_t>(o) % 4 || os.b % 2 || os.h % 2 || os.s % 2)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const dim3 grid((Sq + TC_BQ - 1) / TC_BQ, H, B);
  mma_kernel<HD><<<grid, TC_THREADS, Flash<HD>::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Sk, qs, ks, vs,
      os, group, scale, causal, window, softcap, aligned);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(bool bf16, const void* q, const void* k, const void* v, void* o,
           int B, int H, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
           Strides os, int group, float scale, int causal, int window,
           float softcap, cudaStream_t s) {
  return bf16 ? launch_mma<HD>(q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, group,
                               scale, causal, window, softcap, s)
              : launch_simt<HD>(q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, group,
                                scale, causal, window, softcap, s);
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
// float32 (SIMT body), 1 = bfloat16 (tensor cores).  Returns
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
