// Fused masked-BEA adapted linear for Hopper (sm_90a):
//
//     y = x·W + s·((x·Aᵀ) ⊙ (e⊙m))·Bᵀ
//
// Replaces the Pallas TPU kernel repro/kernels/bea_fused.py:_kernel (through
// bea_dense and the repro/kernels/ops.py:adapted_dense dispatch).
//
// What bounds it on an H100: at the serving path's prefill shapes (M = a
// 64..128-token chunk, K×N ∈ {896×896, 896×128, 896×4864, 4864×896}) the
// product does 2·M ≤ 256 flops per weight element, at most 128 per weight
// byte, under the ~295 flop/byte ridge of the bf16 tensor cores: the floor
// is reading W once from HBM, and at these sizes (0.2–8.7 MB per linear)
// launch and pipeline latency come close to it.  So the design aims to keep
// all 132 SMs loading W, and mma.sync is enough for the arithmetic.
//
// bfloat16, the serving path's type: tensor cores on a grid that fills the
// card.  The host (kernels/bea_fused.py:plan) picks a BM×BN output tile
// (64×64 down to 16×32 for small M) and splits K into slices of whole
// 64-wide K-steps until there are at least 132 blocks, keeping slices of
// ≥ 8 K-steps where it can and at most 16 splits.  A block of 4 warps
// streams its x, W and A tiles through a 3-stage cp.async ring in shared
// memory (rows padded by 16 bytes, so every ldmatrix is free of bank
// conflicts) and runs mma.sync m16n8k16 (bf16 in, f32 out): x fragments
// by ldmatrix, W fragments by ldmatrix.trans (W is k-major).  The rank
// accumulator u = x·Aᵀ rides along as extra MMA columns on the same x
// fragments (r padded to RP ∈ {16, 32, 64}).  With one split the block
// scales u by e⊙mask, rounds it to bf16 as the reference does, and adds
// s·(u⊙em)·Bᵀ from one more round of MMAs (its B tile and e⊙mask were
// loaded into registers at the start, so their latency hides behind the
// main loop) before the one store.  With several, each split writes f32
// partials of its tile (and, in the first column of tiles, of u) to a
// workspace the wrapper provides, and a second small kernel sums the
// splits in a fixed order, applies the adapter epilogue and stores: the
// same call gives bit-identical output every time, and the kernels
// allocate nothing, so they can be captured in a CUDA graph.
//
// float32 keeps the SIMT body of the first port as its own instance: one
// 256-thread block per 64×64 tile walks all of K with f32 FMAs.  It is off
// the serving path, and the tensor cores (TF32, about 3 significant digits)
// cannot hold the f32 tolerance of 1e-4.
//
// Both: ragged M, N, K and r are masked in the loads and the stores (rows
// that are not 16-byte aligned take plain loads instead of cp.async), r ≤ 64,
// launches go on the caller's stream and return cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ------------------------------------------------ float32: SIMT body ------

constexpr int SBM = 64;
constexpr int SBN = 64;
constexpr int SBK = 16;
constexpr int STHREADS = 256;

template <int R>
__global__ void __launch_bounds__(STHREADS)
simt_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ a, const float* __restrict__ b,
            const float* __restrict__ e, const uint8_t* __restrict__ mask,
            float* __restrict__ out, int M, int K, int N, int r, float scaling) {
  __shared__ float xs[SBK][SBM + 4];
  __shared__ float ws[SBK][SBN];
  __shared__ float as[SBK][R];
  __shared__ float us[SBM][R + 1];
  __shared__ float bs[R][SBN];

  constexpr int RU = R / 4;             // ranks of u owned by one thread
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int um = tid % SBM, ug = tid / SBM;
  const int m0 = blockIdx.y * SBM, n0 = blockIdx.x * SBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float u[RU];
#pragma unroll
  for (int j = 0; j < RU; ++j) u[j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += SBK) {
    for (int i = tid; i < SBM * SBK; i += STHREADS) {
      const int m = i / SBK, k = i % SBK, gm = m0 + m, gk = k0 + k;
      xs[k][m] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
    for (int i = tid; i < SBK * SBN; i += STHREADS) {
      const int k = i / SBN, n = i % SBN, gk = k0 + k, gn = n0 + n;
      ws[k][n] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0.f;
    }
    for (int i = tid; i < R * SBK; i += STHREADS) {
      const int j = i / SBK, k = i % SBK, gk = k0 + k;
      as[k][j] = (j < r && gk < K) ? a[(size_t)j * K + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SBK; ++k) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      const float xu = xs[k][um];
#pragma unroll
      for (int j = 0; j < RU; ++j) u[j] = fmaf(xu, as[k][ug * RU + j], u[j]);
    }
    __syncthreads();
  }

  // epilogue: u ⊙ (e⊙mask) in f32, then one (64 × R)·(R × 64) product
#pragma unroll
  for (int j = 0; j < RU; ++j) {
    const int jj = ug * RU + j;
    const float em = (jj < r) ? e[jj] * (mask[jj] ? 1.f : 0.f) : 0.f;
    us[um][jj] = u[j] * em;
  }
  for (int i = tid; i < R * SBN; i += STHREADS) {
    const int n = i / R, j = i % R, gn = n0 + n;
    bs[j][n] = (j < r && gn < N) ? b[(size_t)gn * r + j] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lm = ty * 4 + i, gm = m0 + lm;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ln = tx * 4 + j, gn = n0 + ln;
      float d = 0.f;
#pragma unroll 16
      for (int q = 0; q < R; ++q) d = fmaf(us[lm][q], bs[q][ln], d);
      if (gm < M && gn < N) out[(size_t)gm * N + gn] = acc[i][j] + scaling * d;
    }
  }
}

template <int R>
int launch_simt(const void* x, const void* w, const void* a, const void* b,
                const void* e, const void* mask, void* out, int M, int K,
                int N, int r, float scaling, cudaStream_t stream) {
  const dim3 grid(cdiv(N, SBN), cdiv(M, SBM));
  simt_kernel<R><<<grid, STHREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(e), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), M, K, N, r, scaling);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------- bfloat16: tensor cores ------------

constexpr int THREADS = 128;   // 4 warps
constexpr int BK = 64;         // K per pipeline stage
constexpr int STAGES = 3;
constexpr int PAD = 8;         // bf16 elements of padding per shared row
constexpr int LDK = BK + PAD;  // row pitch of the x and A tiles
constexpr int RMAX = 64;

template <int BM, int BN, int RP>
struct Tile {
  static constexpr int WM = BM >= 32 ? 2 : 1;   // warps along M
  static constexpr int WN = 4 / WM;             // warps along N
  static constexpr int WTM = BM / WM, WTN = BN / WN;
  static constexpr int MI = WTM / 16;           // m16 blocks per warp
  static constexpr int NI = WTN / 8;            // n8 blocks per warp
  static constexpr int U8 = RP / 8;             // n8 blocks of u
  static constexpr int UI = U8 >= WN ? U8 / WN : 1;   // of them per warp
  static constexpr int LDN = BN + PAD;          // row pitch of the W tile
  static constexpr int XC = BM * (BK / 8) / THREADS;   // 16-byte chunks of
  static constexpr int WC = BK * (BN / 8) / THREADS;   // x, W and A each
  static constexpr int AC = RP * (BK / 8) / THREADS;   // thread copies
  static constexpr int X_ELEMS = BM * LDK;
  static constexpr int W_ELEMS = BK * LDN;
  static constexpr int STAGE_ELEMS = X_ELEMS + W_ELEMS + RP * LDK;
  static constexpr int PIPE_BYTES = STAGES * STAGE_ELEMS * 2;
  static constexpr int LDR = RP + PAD;          // row pitch of u⊙em and B
  static constexpr int BPRE = RP * BN / THREADS;   // B values a thread fetches
  static constexpr int EPI_BYTES = (BM + BN) * LDR * 2;
  static constexpr int SMEM = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;
  static_assert(WTM % 16 == 0 && WTN % 8 == 0, "warp tile");
  static_assert(NI == 1 || NI % 2 == 0, "W fragments load in pairs");
};

template <int BM, int BN, int RP>
__global__ void __launch_bounds__(THREADS)
mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
           const bf16* __restrict__ a, const bf16* __restrict__ b,
           const float* __restrict__ e, const uint8_t* __restrict__ mask,
           bf16* __restrict__ out, float* __restrict__ part,
           float* __restrict__ upart, int M, int K, int N, int r,
           float scaling, int kslice, bool aligned) {
  using T = Tile<BM, BN, RP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, split = blockIdx.z;
  const int splits = gridDim.z;
  const int kb = split * kslice, ke = min(K, kb + kslice);
  const int nk = ke > kb ? cdiv(ke - kb, BK) : 0;
  // u is needed once per row: by every block when it stores directly, by
  // the first column of tiles when the splits go through the workspace
  const bool has_u = r > 0 && (splits == 1 || blockIdx.y == 0);
  const bool warp_u = has_u && wn * T::UI < T::U8;

  // a direct store's B tile and e⊙mask, loaded now into registers so that
  // their latency hides behind the main loop
  bf16 bpre[T::BPRE];
  float emr[T::UI][2];
#pragma unroll
  for (int i = 0; i < T::BPRE; ++i) {
    const int idx = tid + i * THREADS, n = idx / RP, j = idx % RP, gn = n0 + n;
    bpre[i] = (splits == 1 && j < r && gn < N) ? b[(size_t)gn * r + j]
                                               : __float2bfloat16(0.f);
  }
#pragma unroll
  for (int ui = 0; ui < T::UI; ++ui)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = (wn * T::UI + ui) * 8 + (lane & 3) * 2 + c;
      emr[ui][c] = (splits == 1 && j < r) ? e[j] * (mask[j] ? 1.f : 0.f) : 0.f;
    }

  float acc[T::MI][T::NI][4];
  float uacc[T::MI][T::UI][4];
#pragma unroll
  for (int i = 0; i < T::MI; ++i) {
#pragma unroll
    for (int j = 0; j < T::NI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
#pragma unroll
    for (int j = 0; j < T::UI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) uacc[i][j][c] = 0.f;
  }

  // Each thread copies the same chunks of every stage: 16 bytes of x, W
  // and A each.  Their places in the ring, their first sources and how much
  // of each row remains are fixed for the whole K-loop, so they are worked
  // out once here and a stage only adds its K offset.
  const bf16* xsrc[T::XC];
  const bf16* wsrc[T::WC];
  const bf16* asrc[T::AC];
  int xoff[T::XC], woff[T::WC], aoff[T::AC];
  int xleft[T::XC], wrow[T::WC], wlen[T::WC], aleft[T::AC];
#pragma unroll
  for (int q = 0; q < T::XC; ++q) {
    const int c = tid + q * THREADS, row = c / (BK / 8), col = (c % (BK / 8)) * 8;
    xoff[q] = row * LDK + col;
    xsrc[q] = x + (size_t)(m0 + row) * K + kb + col;
    xleft[q] = m0 + row < M ? ke - kb - col : 0;      // elements of the slice
  }
#pragma unroll
  for (int q = 0; q < T::WC; ++q) {
    const int c = tid + q * THREADS, row = c / (BN / 8), col = (c % (BN / 8)) * 8;
    woff[q] = row * T::LDN + col;
    wsrc[q] = w + (size_t)(kb + row) * N + n0 + col;
    wrow[q] = kb + row;
    wlen[q] = max(0, min(8, N - n0 - col));
  }
#pragma unroll
  for (int q = 0; q < T::AC; ++q) {
    const int c = tid + q * THREADS, row = c / (BK / 8), col = (c % (BK / 8)) * 8;
    aoff[q] = row * LDK + col;
    asrc[q] = a + (size_t)row * K + kb + col;
    aleft[q] = row < r ? ke - kb - col : 0;
  }

  auto load_stage = [&](int slot, int step) {
    bf16* xs = smem + slot * T::STAGE_ELEMS;
    bf16* ws = xs + T::X_ELEMS;
    bf16* as = ws + T::W_ELEMS;
    const int dk = step * BK;
#pragma unroll
    for (int q = 0; q < T::XC; ++q)
      tc::copy8(xs + xoff[q], xsrc[q] + dk, max(0, min(8, xleft[q] - dk)), aligned, x);
#pragma unroll
    for (int q = 0; q < T::WC; ++q)
      tc::copy8(ws + woff[q], wsrc[q] + (size_t)dk * N, wrow[q] + dk < ke ? wlen[q] : 0,
                aligned, w);
    if (has_u) {
#pragma unroll
      for (int q = 0; q < T::AC; ++q)
        tc::copy8(as + aoff[q], asrc[q] + dk, max(0, min(8, aleft[q] - dk)), aligned, a);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    tc::cp_async_commit();
  }

  for (int i = 0; i < nk; ++i) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();                    // stage i landed; stage i-1 consumed
    const int nxt = i + STAGES - 1;
    if (nxt < nk) load_stage(nxt % STAGES, nxt);
    tc::cp_async_commit();

    const bf16* xs = smem + (i % STAGES) * T::STAGE_ELEMS;
    const bf16* ws = xs + T::X_ELEMS;
    const bf16* as = ws + T::W_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[T::MI][4];
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
        tc::ldsm_x4(af[mi], xs + (wm * T::WTM + mi * 16 + (lane & 15)) * LDK +
                                kk + (lane >> 4) * 8);
      const bf16* wrow = ws + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * T::LDN +
                         wn * T::WTN;
      if constexpr (T::NI == 1) {
        uint32_t bfr[2];
        tc::ldsm_x2_t(bfr, wrow);
#pragma unroll
        for (int mi = 0; mi < T::MI; ++mi) tc::mma_bf16(acc[mi][0], af[mi], bfr[0], bfr[1]);
      } else {
#pragma unroll
        for (int ni = 0; ni < T::NI; ni += 2) {
          uint32_t bfr[4];
          tc::ldsm_x4_t(bfr, wrow + ni * 8 + (lane >> 4) * 8);
#pragma unroll
          for (int mi = 0; mi < T::MI; ++mi) {
            tc::mma_bf16(acc[mi][ni], af[mi], bfr[0], bfr[1]);
            tc::mma_bf16(acc[mi][ni + 1], af[mi], bfr[2], bfr[3]);
          }
        }
      }
      if (warp_u) {
#pragma unroll
        for (int ui = 0; ui < T::UI; ++ui) {
          uint32_t bu[2];
          tc::ldsm_x2(bu, as + ((wn * T::UI + ui) * 8 + (lane & 7)) * LDK + kk +
                              ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mi = 0; mi < T::MI; ++mi) tc::mma_bf16(uacc[mi][ui], af[mi], bu[0], bu[1]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();                      // the ring is free for the epilogue

  const int g = lane >> 2, t2 = (lane & 3) * 2;
  if (splits > 1) {                     // f32 partials for the reduce kernel
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + wm * T::WTM + mi * 16 + g + 8 * h;
        if (gm >= M) continue;
        float* prow = part + ((size_t)split * M + gm) * N;
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni) {
          const int gn = n0 + wn * T::WTN + ni * 8 + t2;
          if (gn + 1 < N && (N & 1) == 0) {
            *reinterpret_cast<float2*>(prow + gn) =
                make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
          } else {
            if (gn < N) prow[gn] = acc[mi][ni][2 * h];
            if (gn + 1 < N) prow[gn + 1] = acc[mi][ni][2 * h + 1];
          }
        }
        if (warp_u) {
          float* urow = upart + ((size_t)split * M + gm) * r;
#pragma unroll
          for (int ui = 0; ui < T::UI; ++ui) {
            const int j = (wn * T::UI + ui) * 8 + t2;
            if (j < r) urow[j] = uacc[mi][ui][2 * h];
            if (j + 1 < r) urow[j + 1] = uacc[mi][ui][2 * h + 1];
          }
        }
      }
    }
    return;
  }

  // one split: d = (u⊙em)·Bᵀ on the tensor cores, u⊙em rounded to bf16 as
  // the reference rounds it, from the B tile and em fetched at the start;
  // then y = acc + s·d and one store
  float d[T::MI][T::NI][4];
#pragma unroll
  for (int i = 0; i < T::MI; ++i)
#pragma unroll
    for (int j = 0; j < T::NI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) d[i][j][c] = 0.f;
  if (has_u) {
    bf16* us = smem;                    // BM × LDR: u⊙em
    bf16* bs = smem + BM * T::LDR;      // BN × LDR: B rows
    if (warp_u) {
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
        for (int ui = 0; ui < T::UI; ++ui)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int lm = wm * T::WTM + mi * 16 + g + 8 * h;
            const int j = (wn * T::UI + ui) * 8 + t2;
            *reinterpret_cast<__nv_bfloat162*>(us + lm * T::LDR + j) =
                __floats2bfloat162_rn(uacc[mi][ui][2 * h] * emr[ui][0],
                                      uacc[mi][ui][2 * h + 1] * emr[ui][1]);
          }
    }
#pragma unroll
    for (int i = 0; i < T::BPRE; ++i) {
      const int idx = tid + i * THREADS;
      bs[(idx / RP) * T::LDR + idx % RP] = bpre[i];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < RP; kk += 16) {
      uint32_t af[T::MI][4];
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
        tc::ldsm_x4(af[mi], us + (wm * T::WTM + mi * 16 + (lane & 15)) * T::LDR +
                                kk + (lane >> 4) * 8);
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        uint32_t bq[2];
        tc::ldsm_x2(bq, bs + (wn * T::WTN + ni * 8 + (lane & 7)) * T::LDR + kk +
                            ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < T::MI; ++mi) tc::mma_bf16(d[mi][ni], af[mi], bq[0], bq[1]);
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lm = wm * T::WTM + mi * 16 + g + 8 * h, gm = m0 + lm;
      if (gm >= M) continue;
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        const int gn = n0 + wn * T::WTN + ni * 8 + t2;
        const float y0 = acc[mi][ni][2 * h] + scaling * d[mi][ni][2 * h];
        const float y1 = acc[mi][ni][2 * h + 1] + scaling * d[mi][ni][2 * h + 1];
        bf16* orow = out + (size_t)gm * N;
        if (gn + 1 < N && (N & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + gn) = __floats2bfloat162_rn(y0, y1);
        } else {
          if (gn < N) orow[gn] = __float2bfloat16(y0);
          if (gn + 1 < N) orow[gn + 1] = __float2bfloat16(y1);
        }
      }
    }
  }
}

constexpr int RED_THREADS = 256;
constexpr int RED_COLS = 64;
constexpr int RED_ROWS = RED_THREADS / RED_COLS;

// sums the K-splits' f32 partials in split order, then y + s·(u⊙em)·Bᵀ with
// u⊙em rounded to bf16 as in the direct store.  The loops are unrolled so
// that a thread's loads are in flight together, not one after another.
__global__ void __launch_bounds__(RED_THREADS)
reduce_kernel(const float* __restrict__ part, const float* __restrict__ upart,
              const bf16* __restrict__ b, const float* __restrict__ e,
              const uint8_t* __restrict__ mask, bf16* __restrict__ out, int M,
              int N, int r, int splits, float scaling) {
  __shared__ float us[RED_ROWS][RMAX];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * RED_ROWS;
  const int lm = tid / RED_COLS, gm = m0 + lm;
  const int gn = blockIdx.x * RED_COLS + tid % RED_COLS;
  const bool live = gm < M && gn < N;
  float y = 0.f;
  if (live) {
#pragma unroll 8
    for (int s = 0; s < splits; ++s) y += part[((size_t)s * M + gm) * N + gn];
  }
  for (int i = tid; i < RED_ROWS * r; i += RED_THREADS) {
    const int um = i / r, j = i % r;
    float v = 0.f;
    if (m0 + um < M) {
#pragma unroll 8
      for (int s = 0; s < splits; ++s) v += upart[((size_t)s * M + m0 + um) * r + j];
      v *= e[j] * (mask[j] ? 1.f : 0.f);
    }
    us[um][j] = __bfloat162float(__float2bfloat16(v));
  }
  __syncthreads();
  if (!live) return;
  float d = 0.f;
  const bf16* brow = b + (size_t)gn * r;
#pragma unroll 8
  for (int j = 0; j < r; ++j) d = fmaf(us[lm][j], __bfloat162float(brow[j]), d);
  out[(size_t)gm * N + gn] = __float2bfloat16(y + scaling * d);
}

long long workspace_bytes(int M, int N, int r, int splits) {
  return splits > 1 ? 4LL * splits * M * ((long long)N + r) : 0;
}

template <int BM, int BN, int RP>
int launch_mma(const void* x, const void* w, const void* a, const void* b,
               const void* e, const void* mask, void* out, void* workspace,
               int M, int K, int N, int r, float scaling, int splits,
               int kslice, cudaStream_t stream) {
  using T = Tile<BM, BN, RP>;
  cudaError_t err = tc::ensure_smem_limit<mma_kernel<BM, BN, RP>>(T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned = K % 8 == 0 && N % 8 == 0 && tc::aligned16(x) &&
                       tc::aligned16(w) && tc::aligned16(a);
  float* part = static_cast<float*>(workspace);
  float* upart = splits > 1 ? part + (size_t)splits * M * N : nullptr;
  // m-tiles vary fastest, so the blocks that share a W tile run together
  // and all but the first find it in L2
  mma_kernel<BM, BN, RP><<<dim3(cdiv(M, BM), cdiv(N, BN), splits), THREADS,
                           T::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<const float*>(e), static_cast<const uint8_t*>(mask),
      static_cast<bf16*>(out), part, upart, M, K, N, r, scaling, kslice, aligned);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  reduce_kernel<<<dim3(cdiv(N, RED_COLS), cdiv(M, RED_ROWS)), RED_THREADS, 0, stream>>>(
      part, upart, static_cast<const bf16*>(b), static_cast<const float*>(e),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), M, N, r,
      splits, scaling);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN>
int launch_mma_rank(const void* x, const void* w, const void* a, const void* b,
                    const void* e, const void* mask, void* out, void* ws, int M,
                    int K, int N, int r, float scaling, int splits, int kslice,
                    cudaStream_t s) {
  if (r <= 16)
    return launch_mma<BM, BN, 16>(x, w, a, b, e, mask, out, ws, M, K, N, r, scaling, splits, kslice, s);
  if (r <= 32)
    return launch_mma<BM, BN, 32>(x, w, a, b, e, mask, out, ws, M, K, N, r, scaling, splits, kslice, s);
  return launch_mma<BM, BN, 64>(x, w, a, b, e, mask, out, ws, M, K, N, r, scaling, splits, kslice, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, a, b and out share it); e is
// float32 and mask is bool (one byte each).  The bfloat16 instance takes
// its tiling plan from the caller (kernels/bea_fused.py:plan): a block_m ×
// block_n output tile ∈ {64×64, 32×64, 16×64, 16×32} and `splits` K-slices
// of k_slice (a multiple of 64) each, none of them empty; with more than one
// split, `workspace` holds at least 4·splits·M·(N + r) bytes.  The float32
// instance ignores the plan and the workspace.  Returns cudaGetLastError().
extern "C" int bea_dense_launch(const void* x, const void* w, const void* a,
                                const void* b, const void* e, const void* mask,
                                void* out, int M, int K, int N, int r,
                                float scaling, int dtype, void* workspace,
                                long long workspace_size, int block_m,
                                int block_n, int splits, int k_slice,
                                void* stream) {
  if (M < 0 || K < 0 || N < 0 || r < 0 || r > RMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (r <= 16) return launch_simt<16>(x, w, a, b, e, mask, out, M, K, N, r, scaling, s);
    if (r <= 32) return launch_simt<32>(x, w, a, b, e, mask, out, M, K, N, r, scaling, s);
    return launch_simt<64>(x, w, a, b, e, mask, out, M, K, N, r, scaling, s);
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool slices_ok = splits >= 1 && splits <= 65535 && k_slice >= BK &&
                         block_n > 0 && cdiv(N, block_n) <= 65535 &&
                         k_slice % BK == 0 &&
                         (long long)splits * k_slice >= K &&
                         (long long)(splits - 1) * k_slice < (K > 0 ? K : 1);
  if (!slices_ok || workspace_size < workspace_bytes(M, N, r, splits) ||
      (splits > 1 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (block_m == 64 && block_n == 64)
    return launch_mma_rank<64, 64>(x, w, a, b, e, mask, out, workspace, M, K, N, r, scaling, splits, k_slice, s);
  if (block_m == 32 && block_n == 64)
    return launch_mma_rank<32, 64>(x, w, a, b, e, mask, out, workspace, M, K, N, r, scaling, splits, k_slice, s);
  if (block_m == 16 && block_n == 64)
    return launch_mma_rank<16, 64>(x, w, a, b, e, mask, out, workspace, M, K, N, r, scaling, splits, k_slice, s);
  if (block_m == 16 && block_n == 32)
    return launch_mma_rank<16, 32>(x, w, a, b, e, mask, out, workspace, M, K, N, r, scaling, splits, k_slice, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
