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
// bfloat16, the serving path's type (mma_kernel): tensor cores on a grid
// that fills the card.  The host (kernels/bea_fused.py:plan) picks a BM×BN
// output tile (64×64 down to 16×32 for small M) and splits K into slices
// of whole 64-wide K-steps toward 264 blocks (two per SM), keeping slices
// of ≥ 2 K-steps where it can and at most 20 splits.  A block of 4 warps
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
// bfloat16 at training rows (wgmma_kernel): at the LM path's rows
// (Qwen2-0.5B at 8 × 512 = 4096 tokens) the product does 2·M = 8192 flops
// per weight element, far over the ridge: operations bound it (one layer's
// 7 linears, 124 GFLOP, 0.125 ms at 989 TFLOP/s), and only wgmma reaches
// that rate.  mma_kernel's 64×64 tiles took 0.977 ms a layer there, 13% of
// the bound, twice the addmm form.  From M = 512 rows
// (K and N multiples of 8 and 16-byte aligned operands, TMA's terms) the
// plan takes wgmma_kernel: 128-row tiles of 256, 224 or 128 columns (the
// width whose waves over 132 SMs cost least: N = 896 in four 224-wide
// tiles is one wave of 128), a producer warp keeping a 4-stage ring of
// x, W and A tiles loading by TMA, two consumer warpgroups on wgmma.  The
// rank term u = x·Aᵀ is one more m64nRPk16 wgmma per k16 step on the same
// x tile (6% more tensor work at 256 columns, where mma_kernel spent 25%),
// and the epilogue is mma_kernel's arithmetic: u⊙em rounded to bf16, d =
// (u⊙em)·Bᵀ by wgmma with u as the register A operand, y = acc + s·d
// rounded once.  The output leaves through shared memory by TMA stores
// (stored from the accumulators 4 bytes a lane, it took 40 of w1's 98 µs).
// One block per SM walks the tiles (one block per tile timed the same to
// within 1–5%; walking, the producer loads a tile's first stages while the
// consumers store the last).  Few tiles (wk/wv, N = 128) split K as
// mma_kernel's plan did, with the same bits (see kernels/bea_fused.py).  A
// layer takes 0.254 ms, 49% of the bound, against addmm's 0.483 (NVIDIA
// H100 80GB HBM3, 700 W; chip_smoke.py phase 11).
//
// float32, the training path's type (tf32_kernel): at DistilBERT's shapes
// (M = 1024 tokens, K×N ∈ {768², 768×3072, 3072×768}, r = 12) the product
// does 2·M = 2048 flops per weight element, so operations bound it, not
// bytes.  1×TF32 tensor cores would miss the 1e-4 tolerance (3e-4 at K =
// 768); 3xTF32 (mma.cuh: each operand split into TF32 big and small parts,
// three MMAs into a fresh accumulator added to the running one on the CUDA
// cores, since the tensor cores' accumulation truncates) holds f32
// accuracy at 165 TFLOP/s against 67 on the CUDA cores.  The same plan, ring and epilogue as bf16, in f32: tiles 128×64,
// 64×64 and 64×32 (4 warps of 2×2), 32-float K-steps (128 bytes a row, as
// bf16's 64), a 3-stage cp.async ring.  x fragments come by ldmatrix (an
// 8×8 b16 matrix is 8 rows × 4 floats: .x4 is the m16n8k8 A fragment) and
// u's A fragments likewise (A's rows are k-contiguous); ldmatrix cannot
// transpose 32-bit elements, so W's fragments are scalar shared loads from
// rows of BN + 8 floats, where lane (g, t) reads bank 8t + g.  Each
// fragment is split once per k-step and serves every MMA of the warp.  With
// one split, s·u⊙em stays f32 (the f32 reference rounds nothing) and its
// product with the B tile (staged at the start in shared memory of its
// own) is added to the accumulators by 3xTF32 MMAs before the one store;
// with several, the f32 reduce kernel finishes as in bf16.
//
// float32 grouped over clients (bea_dense_grouped_launch): the cohort
// runner trains C clients' adapters on one frozen base in one forward, as
// the reference's cohort vmaps the masked-BEA function over a leading
// client axis.  The same tf32_kernel and reduce run C clients' row tiles in
// one grid (client · row tiles + row tile on blockIdx.x, the client on the
// reduce's blockIdx.z), each client with its own x, A, B, e, output and
// workspace slices and all of them with the one W and mask; the plan counts
// C times the row tiles.
//
// All: ragged M, N, K and r are masked in the loads and the stores (rows
// that are not 16-byte aligned take plain loads instead of cp.async; TMA
// fills and clips at the tensors' bounds in wgmma_kernel), r ≤ 64,
// launches go on the caller's stream and return cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"
#include "tma_map.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// A warp's f32 accumulator fragments (MI m16 × NI n8 blocks, lane (g, t2/2)
// holding rows g and g + 8, columns t2 and t2 + 1 of each) into row-major
// `dst` of N columns at rows row0.., columns col0..; rows ≥ M and columns
// ≥ N are skipped.
template <int MI, int NI>
__device__ __forceinline__ void store_f32_tile(const float (&acc)[MI][NI][4], float* dst,
                                               int M, int N, int row0, int col0,
                                               int g, int t2) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = row0 + mi * 16 + g + 8 * h;
      if (gm >= M) continue;
      float* prow = dst + (size_t)gm * N;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int gn = col0 + ni * 8 + t2;
        if (gn + 1 < N && (N & 1) == 0) {
          *reinterpret_cast<float2*>(prow + gn) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        } else {
          if (gn < N) prow[gn] = acc[mi][ni][2 * h];
          if (gn + 1 < N) prow[gn + 1] = acc[mi][ni][2 * h + 1];
        }
      }
    }
  }
}

// The same for the rank accumulator u: its columns j < r into `dst` of r
// columns, the warp's first u column at ucol0
template <int MI, int UI>
__device__ __forceinline__ void store_u_tile(const float (&uacc)[MI][UI][4], float* dst,
                                             int M, int r, int row0, int ucol0, int g,
                                             int t2) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = row0 + mi * 16 + g + 8 * h;
      if (gm >= M) continue;
      float* urow = dst + (size_t)gm * r;
#pragma unroll
      for (int ui = 0; ui < UI; ++ui) {
        const int j = ucol0 + ui * 8 + t2;
        if (j < r) urow[j] = uacc[mi][ui][2 * h];
        if (j + 1 < r) urow[j + 1] = uacc[mi][ui][2 * h + 1];
      }
    }
  }
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
      tc::copy16(xs + xoff[q], xsrc[q] + dk, max(0, min(8, xleft[q] - dk)), aligned, x);
#pragma unroll
    for (int q = 0; q < T::WC; ++q)
      tc::copy16(ws + woff[q], wsrc[q] + (size_t)dk * N, wrow[q] + dk < ke ? wlen[q] : 0,
                aligned, w);
    if (has_u) {
#pragma unroll
      for (int q = 0; q < T::AC; ++q)
        tc::copy16(as + aoff[q], asrc[q] + dk, max(0, min(8, aleft[q] - dk)), aligned, a);
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
    const int row0 = m0 + wm * T::WTM;
    store_f32_tile(acc, part + (size_t)split * M * N, M, N, row0, n0 + wn * T::WTN, g,
                   t2);
    if (warp_u)
      store_u_tile(uacc, upart + (size_t)split * M * r, M, r, row0, wn * T::UI * 8, g,
                   t2);
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

// ------------------------------------------ float32: 3xTF32 m16n8k8 --------

constexpr int F_BK = 32;           // K per pipeline stage (floats: 128 bytes a row)
constexpr int F_LDK = F_BK + 4;    // row pitch of the x and A tiles (floats)
constexpr int F_CH = F_BK / 4;     // 16-byte chunks per x or A row of a stage

template <int BM, int BN, int RP>
struct TileF {
  static constexpr int WM = 2, WN = 2;          // warps along M and N
  static constexpr int WTM = BM / WM, WTN = BN / WN;
  static constexpr int MI = WTM / 16;           // m16 blocks per warp
  static constexpr int NI = WTN / 8;            // n8 blocks per warp
  static constexpr int UI = RP / 8 / WN;        // n8 blocks of u per warp
  static constexpr int LDN = BN + 8;            // W pitch: lane (g, t) reads bank 8t + g
  // rows of x or A, and of W, that one pass of 16-byte copies covers, and
  // the copies of x, W and A a thread makes per stage
  static constexpr int XROWS = THREADS / F_CH, WROWS = THREADS / (BN / 4);
  static constexpr int XC = BM / XROWS, WC = F_BK / WROWS, AC = RP / XROWS;
  static constexpr int X_ELEMS = BM * F_LDK;
  static constexpr int W_ELEMS = F_BK * LDN;
  static constexpr int STAGE_ELEMS = X_ELEMS + W_ELEMS + RP * F_LDK;
  static constexpr int PIPE_BYTES = STAGES * STAGE_ELEMS * 4;
  static constexpr int LDR = RP + 4;            // row pitch of s·u⊙em and B
  static constexpr int BC = BN * (RP / 4) / THREADS;   // 16-byte copies of B
  static constexpr int U_BYTES = BM * LDR * 4;  // s·u⊙em, over the ring
  static constexpr int RING_BYTES = PIPE_BYTES > U_BYTES ? PIPE_BYTES : U_BYTES;
  static constexpr int SMEM = RING_BYTES + BN * LDR * 4;   // + B's own tile
  static_assert(RP >= 16 && UI >= 1 && XC >= 1 && WC >= 1 && AC >= 1 && BC >= 1,
                "tile");
};

// The client-grouped instance (the cohort runner's local phase) is this
// kernel with blockIdx.x = client · row tiles + row tile: client c's x, A,
// B, e, out and workspace slices sit c strides on from the first; W and the
// mask are shared, and since a client's row tiles run before the next
// client's, every client's blocks read the same W tiles from L2.  A tile
// never spans two clients, so each client's ragged row edge is masked as
// a single call's is.  One client (gridDim.x = row tiles) is the plain call.
template <int BM, int BN, int RP>
__global__ void __launch_bounds__(THREADS)
tf32_kernel(const float* __restrict__ x_, const float* __restrict__ w,
            const float* __restrict__ a_, const float* __restrict__ b_,
            const float* __restrict__ e_, const uint8_t* __restrict__ mask,
            float* __restrict__ out_, float* __restrict__ part,
            float* __restrict__ upart, int M, int K, int N, int r,
            float scaling, int kslice, bool aligned, bool b_aligned) {
  using T = TileF<BM, BN, RP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* bs = smem + T::RING_BYTES / 4;          // BN × LDR: B rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, t2 = 2 * t;
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int mtiles = cdiv(M, BM), clients = gridDim.x / mtiles;
  const int client = blockIdx.x / mtiles;
  const int m0 = (blockIdx.x - client * mtiles) * BM, n0 = blockIdx.y * BN;
  const int split = blockIdx.z, splits = gridDim.z;
  const float* x = x_ + (size_t)client * M * K;
  const float* a = a_ + (size_t)client * r * K;
  const float* b = b_ + (size_t)client * N * r;
  const float* e = e_ + (size_t)client * r;
  float* out = out_ + (size_t)client * M * N;
  const size_t slab = (size_t)split * clients + client;   // workspace slice
  const int kb = split * kslice, ke = min(K, kb + kslice);
  const int nk = ke > kb ? cdiv(ke - kb, F_BK) : 0;
  // u is needed once per row: by every block when it stores directly, by
  // the first column of tiles when the splits go through the workspace
  const bool has_u = r > 0 && (splits == 1 || blockIdx.y == 0);
  const bool direct = splits == 1 && r > 0;

  // Each thread copies the same 16-byte chunk column of every stage: x and
  // A rows xr + XROWS·q, W rows wr + WROWS·q; a stage only adds its K offset
  const int xr = tid / F_CH, xc = (tid % F_CH) * 4;
  const int wr = tid / (BN / 4), wc = (tid % (BN / 4)) * 4;
  const float* xsrc = x + (size_t)(m0 + xr) * K + kb + xc;
  const float* wsrc = w + (size_t)(kb + wr) * N + n0 + wc;
  const float* asrc = a + (size_t)xr * K + kb + xc;
  const int kleft = ke - kb - xc;               // of this chunk column's slice
  const int wlen = max(0, min(4, N - n0 - wc));

  auto load_stage = [&](int slot, int step) {
    float* xs = smem + slot * T::STAGE_ELEMS;
    float* ws = xs + T::X_ELEMS;
    float* as = ws + T::W_ELEMS;
    const int dk = step * F_BK, kv = max(0, min(4, kleft - dk));
#pragma unroll
    for (int q = 0; q < T::XC; ++q) {
      const int row = xr + q * T::XROWS;
      tc::copy16(xs + row * F_LDK + xc, xsrc + (size_t)q * T::XROWS * K + dk,
                 m0 + row < M ? kv : 0, aligned, x);
    }
#pragma unroll
    for (int q = 0; q < T::WC; ++q) {
      const int row = wr + q * T::WROWS;
      tc::copy16(ws + row * T::LDN + wc, wsrc + (size_t)(dk + q * T::WROWS) * N,
                 kb + dk + row < ke ? wlen : 0, aligned, w);
    }
    if (has_u) {
#pragma unroll
      for (int q = 0; q < T::AC; ++q) {
        const int row = xr + q * T::XROWS;
        tc::copy16(as + row * F_LDK + xc, asrc + (size_t)q * T::XROWS * K + dk,
                   row < r ? kv : 0, aligned, a);
      }
    }
  };

  // a direct store's B tile, in its own shared memory and in flight with
  // the first stage, and e⊙mask of this lane's u columns
  if (direct) {
#pragma unroll
    for (int q = 0; q < T::BC; ++q) {
      const int c = tid + q * THREADS, n = c / (RP / 4), j = (c % (RP / 4)) * 4;
      tc::copy16(bs + n * T::LDR + j, b + (size_t)(n0 + n) * r + j,
                 n0 + n < N ? max(0, min(4, r - j)) : 0, b_aligned, b);
    }
  }
  float emr[T::UI][2];
#pragma unroll
  for (int ui = 0; ui < T::UI; ++ui)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = (wn * T::UI + ui) * 8 + t2 + c;
      emr[ui][c] = (direct && j < r) ? scaling * e[j] * (mask[j] ? 1.f : 0.f) : 0.f;
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

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load_stage(st, st);
    tc::cp_async_commit();
  }

  for (int i = 0; i < nk; ++i) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();                    // stage i landed; stage i-1 consumed
    const int nxt = i + STAGES - 1;
    if (nxt < nk) load_stage(nxt % STAGES, nxt);
    tc::cp_async_commit();

    const float* xs = smem + (i % STAGES) * T::STAGE_ELEMS;
    const float* ws = xs + T::X_ELEMS;
    const float* as = ws + T::W_ELEMS;
#pragma unroll
    for (int kk = 0; kk < F_BK; kk += 8) {
      // x fragments by ldmatrix, split once for all of this warp's columns
      uint32_t xb[T::MI][4], xsm[T::MI][4];
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
        uint32_t raw[4];
        tc::ldsm_x4(raw, xs + (wm * T::WTM + mi * 16 + (lane & 15)) * F_LDK + kk +
                             (lane >> 4) * 4);
        tc::split_frag(raw, xb[mi], xsm[mi]);
      }
      // W fragments: W[kk + t][n + g] and W[kk + t + 4][n + g]
      const float* wk = ws + (kk + t) * T::LDN + wn * T::WTN + g;
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        const uint32_t raw[2] = {__float_as_uint(wk[ni * 8]),
                                 __float_as_uint(wk[4 * T::LDN + ni * 8])};
        uint32_t wb[2], wsm[2];
        tc::split_frag(raw, wb, wsm);
#pragma unroll
        for (int mi = 0; mi < T::MI; ++mi)
          tc::mma_3xtf32(acc[mi][ni], xb[mi], xsm[mi], wb, wsm);
      }
      if (has_u) {
#pragma unroll
        for (int ui = 0; ui < T::UI; ++ui) {
          uint32_t raw[2], ab[2], asm_[2];
          tc::ldsm_x2(raw, as + ((wn * T::UI + ui) * 8 + (lane & 7)) * F_LDK + kk +
                               ((lane >> 3) & 1) * 4);
          tc::split_frag(raw, ab, asm_);
#pragma unroll
          for (int mi = 0; mi < T::MI; ++mi)
            tc::mma_3xtf32(uacc[mi][ui], xb[mi], xsm[mi], ab, asm_);
        }
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();                      // the ring is free for the epilogue

  if (splits > 1) {                     // f32 partials for the reduce kernel
    const int row0 = m0 + wm * T::WTM;
    store_f32_tile(acc, part + slab * M * N, M, N, row0, n0 + wn * T::WTN, g, t2);
    if (has_u)
      store_u_tile(uacc, upart + slab * M * r, M, r, row0, wn * T::UI * 8, g, t2);
    return;
  }

  // one split: acc += (s·u⊙em)·Bᵀ, 3xTF32 from shared memory (no rounding
  // of u⊙em: the f32 reference has none), then one store
  if (direct) {
    float* us = smem;                   // BM × LDR
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int ui = 0; ui < T::UI; ++ui)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int lm = wm * T::WTM + mi * 16 + g + 8 * h;
          const int j = (wn * T::UI + ui) * 8 + t2;
          us[lm * T::LDR + j] = uacc[mi][ui][2 * h] * emr[ui][0];
          us[lm * T::LDR + j + 1] = uacc[mi][ui][2 * h + 1] * emr[ui][1];
        }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < RP; kk += 8) {
      uint32_t ub[T::MI][4], usm[T::MI][4];
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
        uint32_t raw[4];
        tc::ldsm_x4(raw, us + (wm * T::WTM + mi * 16 + (lane & 15)) * T::LDR + kk +
                             (lane >> 4) * 4);
        tc::split_frag(raw, ub[mi], usm[mi]);
      }
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        uint32_t raw[2], bb[2], bsm[2];
        tc::ldsm_x2(raw, bs + (wn * T::WTN + ni * 8 + (lane & 7)) * T::LDR + kk +
                             ((lane >> 3) & 1) * 4);
        tc::split_frag(raw, bb, bsm);
#pragma unroll
        for (int mi = 0; mi < T::MI; ++mi)
          tc::mma_3xtf32(acc[mi][ni], ub[mi], usm[mi], bb, bsm);
      }
    }
  }
  store_f32_tile(acc, out, M, N, m0 + wm * T::WTM, n0 + wn * T::WTN, g, t2);
}

// ------------------------------------------------ split-K reduce -----------

constexpr int RED_THREADS = 256;
constexpr int RED_COLS = 64;
constexpr int RED_ROWS = RED_THREADS / RED_COLS;

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// sums the K-splits' f32 partials in split order, then y + s·(u⊙em)·Bᵀ;
// for bf16, u⊙em is rounded to bf16 as in the direct store.  The loops are
// unrolled so that a thread's loads are in flight together, not one after
// another.  blockIdx.z is the client of a grouped call (the partials of
// split s, client c are slice s·clients + c of the workspace).
template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
reduce_kernel(const float* __restrict__ part, const float* __restrict__ upart,
              const T* __restrict__ b_, const float* __restrict__ e_,
              const uint8_t* __restrict__ mask, T* __restrict__ out_, int M,
              int N, int r, int splits, float scaling) {
  __shared__ float us[RED_ROWS][RMAX];
  const int tid = threadIdx.x;
  const int client = blockIdx.z, clients = gridDim.z;
  const T* b = b_ + (size_t)client * N * r;
  const float* e = e_ + (size_t)client * r;
  T* out = out_ + (size_t)client * M * N;
  const int m0 = blockIdx.y * RED_ROWS;
  const int lm = tid / RED_COLS, gm = m0 + lm;
  const int gn = blockIdx.x * RED_COLS + tid % RED_COLS;
  const bool live = gm < M && gn < N;
  float y = 0.f;
  if (live) {
#pragma unroll 8
    for (int s = 0; s < splits; ++s)
      y += part[(((size_t)s * clients + client) * M + gm) * N + gn];
  }
  for (int i = tid; i < RED_ROWS * r; i += RED_THREADS) {
    const int um = i / r, j = i % r;
    float v = 0.f;
    if (m0 + um < M) {
#pragma unroll 8
      for (int s = 0; s < splits; ++s)
        v += upart[(((size_t)s * clients + client) * M + m0 + um) * r + j];
      v *= e[j] * (mask[j] ? 1.f : 0.f);
    }
    us[um][j] = to_f32(static_cast<T>(v));
  }
  __syncthreads();
  if (!live) return;
  float d = 0.f;
  const T* brow = b + (size_t)gn * r;
#pragma unroll 8
  for (int j = 0; j < r; ++j) d = fmaf(us[lm][j], to_f32(brow[j]), d);
  store1(out + (size_t)gm * N + gn, y + scaling * d);
}

// ------------------------- bfloat16 at training rows: wgmma fed by TMA ------

namespace wg {
constexpr int BM = 128;              // tile rows: 64 for each consumer warpgroup
constexpr int BK = 64;               // K per stage: one 128-byte swizzled bf16 row
constexpr int THREADS = 384;         // a producer warpgroup and two consumers
constexpr int CONSUMERS = 256;
constexpr int CONSUMER_WARPS = 8;    // arrivals that free a stage
constexpr int BOX = BK * 64 * 2;     // a 64 × 64 bf16 TMA box of W (8 KB)
constexpr int SMEM_MAX = 232448;     // an H100 block's shared memory
constexpr int BAR_B = 1;             // named barrier of the consumers
constexpr int BAR_OUT = 2;           // and of each consumer warpgroup (2, 3)
constexpr int OUT_COLS = 32;         // an output chunk: 64 rows × 32 columns
constexpr int OUT_BYTES = 64 * OUT_COLS * 2;   // staged for a TMA store (4 KB)
}  // namespace wg

template <int BN, int RP>
struct WTile {
  static constexpr int NB = (BN + 63) / 64;            // 64-column W boxes
  static constexpr int X_BYTES = wg::BM * wg::BK * 2;  // 16 KB
  static constexpr int W_BYTES = NB * wg::BOX;
  static constexpr int A_BYTES = RP * wg::BK * 2;
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES + A_BYTES;
  static constexpr int B_BYTES = BN * RP * 2;          // the epilogue's B tile
  static constexpr int B_SBO = RP / 8 * 128;           // its 8-row groups' pitch
  static constexpr int OUT_BYTES = 2 * 2 * wg::OUT_BYTES;   // 2 per consumer
  // 1024 bytes of alignment slack, the output chunks, the B tile, e⊙mask
  // and the barriers
  static constexpr int FIXED = 1024 + OUT_BYTES + B_BYTES + RP * 4 + 2 * 4 * 8;
  static constexpr int STAGES = FIXED + 4 * STAGE_BYTES <= wg::SMEM_MAX ? 4 : 3;
  static constexpr int SMEM = FIXED + STAGES * STAGE_BYTES;
  static_assert(BN % 32 == 0 && BN <= 256 && RP % 16 == 0 && RP <= 64, "tile");
  static_assert(SMEM <= wg::SMEM_MAX, "shared memory");
};

// One block walks the tiles blockIdx.x, + gridDim.x, ...: tile t is row tile
// t % mtiles (rows fastest, so neighbouring blocks share a W tile in L2),
// then column tile, then K-split.  Warpgroup 0 is the producer: one thread
// keeps a ring of STAGES stages loading by TMA (x: 128 × 64, W: NB boxes of
// 64 k × 64 n, A: RP × 64; out-of-range rows and columns arrive as zeros),
// each stage on a full/empty mbarrier pair.  Warpgroups 1 and 2 own rows
// 0..63 and 64..127 of the tile: per 64-deep stage four k16 steps of
// wgmma m64nBNk16 (x K-major, W MN-major through the transpose bit: W is
// read as it lies, no transposed copy) and m64nRPk16 for u = x·Aᵀ on the
// same x descriptor, one group in flight, a stage freed once its group has
// retired.  Registers go to the consumers (setmaxnreg 232 / 40).
template <int BN, int RP>
__global__ void __launch_bounds__(wg::THREADS, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap wmap,
             const __grid_constant__ CUtensorMap amap,
             const __grid_constant__ CUtensorMap omap, const bf16* __restrict__ b,
             const float* __restrict__ e, const uint8_t* __restrict__ mask,
             float* __restrict__ part, float* __restrict__ upart, int M, int K,
             int N, int r, float scaling, int kslice, int splits) {
  using T = WTile<BN, RP>;
  constexpr int S = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ostage = smem + S * T::STAGE_BYTES;
  unsigned char* bt = ostage + T::OUT_BYTES;
  float* em = reinterpret_cast<float*>(bt + T::B_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(em + RP);
  uint64_t* empty = full + S;

  const int mtiles = cdiv(M, wg::BM), ntiles = cdiv(N, BN);
  const int tiles = mtiles * ntiles * splits;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], wg::CONSUMER_WARPS);
    }
    tc::mbar_init_fence();
  }
  __syncthreads();

  // the role as a warp-uniform value (a shuffle's result), so that the
  // compiler treats the two branches as uniform and keeps wgmma async
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {                      // ---- producer ----
    tc::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int mt = t % mtiles, nt = (t / mtiles) % ntiles, split = t / mtiles / ntiles;
        const int kb = split * kslice, nk = cdiv(min(K, kb + kslice) - kb, wg::BK);
        for (int i = 0; i < nk; ++i) {
          tc::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * T::STAGE_BYTES;
          const int k = kb + i * wg::BK;
          tc::mbar_arrive_expect_tx(&full[stage], T::STAGE_BYTES);
          tc::tma_load_2d(st, &xmap, &full[stage], k, mt * wg::BM);
#pragma unroll
          for (int j = 0; j < T::NB; ++j)
            tc::tma_load_2d(st + T::X_BYTES + j * wg::BOX, &wmap, &full[stage],
                            nt * BN + 64 * j, k);
          tc::tma_load_2d(st + T::X_BYTES + T::W_BYTES, &amap, &full[stage], k, 0);
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {                              // ---- consumers ----
    tc::setmaxnreg_inc<232>();
    const int cw = role - 1, ct = threadIdx.x - 128;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t2 = (lane & 3) * 2;
    if (ct < RP) em[ct] = ct < r ? e[ct] * (mask[ct] ? 1.f : 0.f) : 0.f;
    const uint32_t base = tc::smem_u32(smem), bt_addr = tc::smem_u32(bt);
    const bool leader = threadIdx.x % 128 == 0;      // of this warpgroup
    int stage = 0, chunks = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int mt = t % mtiles, nt = (t / mtiles) % ntiles, split = t / mtiles / ntiles;
      const int kb = split * kslice, nk = cdiv(min(K, kb + kslice) - kb, wg::BK);
      const int m0 = mt * wg::BM, n0 = nt * BN;
      // one split: this column tile's B rows (zero past r and N) as K-major
      // core matrices ((n, j) at (n/8)·B_SBO + (j/8)·128 + (n%8)·16 +
      // (j%8)·2 bytes), written once both warpgroups are done with the
      // last tile's, and handed to the async proxy that wgmma reads through
      tc::named_bar_sync(wg::BAR_B, wg::CONSUMERS);
      if (splits == 1) {
        for (int c = ct; c < BN * (RP / 8); c += wg::CONSUMERS) {
          const int n = c / (RP / 8), j0 = (c % (RP / 8)) * 8, gn = n0 + n;
          __align__(16) bf16 v[8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            v[q] = gn < N && j0 + q < r ? b[(size_t)gn * r + j0 + q] : __float2bfloat16(0.f);
          *reinterpret_cast<uint4*>(bt + (n / 8) * T::B_SBO + (j0 / 8) * 128 + (n % 8) * 16) =
              *reinterpret_cast<const uint4*>(v);
        }
        tc::fence_proxy_async();
      }

      float acc[BN / 2], uacc[RP / 2];
      for (int i = 0; i < nk; ++i) {
        tc::mbar_wait(&full[stage], phase);
        const uint32_t st = base + stage * T::STAGE_BYTES;
        const uint64_t xd = tc::make_desc(st + cw * 64 * 128, 16, 1024, tc::k128B);
        const uint64_t wd = tc::make_desc(st + T::X_BYTES, wg::BOX, 1024, tc::k128B);
        const uint64_t ad =
            tc::make_desc(st + T::X_BYTES + T::W_BYTES, 16, 1024, tc::k128B);
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < wg::BK / 16; ++kk) {
          const int acc_in = i > 0 || kk > 0;       // the first step overwrites
          tc::wgmma_ss<1>(acc, xd + 2 * kk, wd + 128 * kk, acc_in);   // +32 B; +16 k rows
          tc::wgmma_ss<0>(uacc, xd + 2 * kk, ad + 2 * kk, acc_in);
        }
        tc::wgmma_commit();
        tc::wgmma_wait<1>();                        // the stage before is read
        tc::mbar_arrive_if(&empty[(stage + S - 1) % S], i > 0 && lane == 0);
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      tc::wgmma_wait<0>();
      tc::mbar_arrive_if(&empty[(stage + S - 1) % S], lane == 0);

      const int row = m0 + cw * 64 + warp * 16 + g;  // and row + 8
      if (splits > 1) {                 // f32 partials for the reduce kernel
        float* p = part + (size_t)split * M * N;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int col = n0 + 8 * i + t2;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            tc::st_global_if(p + (size_t)(row + 8 * h) * N + col, acc[4 * i + 2 * h],
                             acc[4 * i + 2 * h + 1], row + 8 * h < M && col < N);
        }
        float* up = upart + (size_t)split * M * r;
#pragma unroll
        for (int i = 0; i < RP / 8; ++i) {
          const int j = 8 * i + t2;
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              tc::st_global_if(up + (size_t)(row + 8 * h) * r + j + q,
                               __float_as_uint(uacc[4 * i + 2 * h + q]),
                               nt == 0 && row + 8 * h < M && j + q < r);
        }
        continue;
      }

      // one split: u⊙em rounded to bf16 as the reference rounds it, packed
      // as wgmma A fragments (k16 step kk: u columns 16kk..16kk+15)
      uint32_t uf[RP / 16][4];
#pragma unroll
      for (int kk = 0; kk < RP / 16; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * (2 * kk + h), j = 8 * (2 * kk + h) + t2;
          const float e0 = em[j], e1 = em[j + 1];
          uf[kk][2 * h] = tc::pack_bf16(uacc[i] * e0, uacc[i + 1] * e1);
          uf[kk][2 * h + 1] = tc::pack_bf16(uacc[i + 2] * e0, uacc[i + 3] * e1);
        }
      tc::named_bar_sync(wg::BAR_B, wg::CONSUMERS);   // the B tile is written
      // d = (u⊙em)·Bᵀ in 32-column chunks, each in 16 f32 registers, then
      // y = acc + s·d rounded once into one of the warpgroup's two 64 × 32
      // staging boxes (64-byte swizzle: row r's 16-byte chunk q at q ^ (r/2
      // % 4), so the lanes' stores hit 32 banks) and stored by TMA in the
      // background (rows past M and columns past N are not written); a box
      // is refilled once the store two chunks back has read it
      const int lr = warp * 16 + g, sw = (lr >> 1) & 3, lane_at = lr * 64 + 2 * t2;
      const uint32_t own = tc::smem_u32(ostage) + cw * 2 * wg::OUT_BYTES;
#pragma unroll
      for (int c = 0; c < BN / 32; ++c) {
        float d[16];
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < RP / 16; ++kk)
          tc::wgmma_rs(d, uf[kk],
                       tc::make_desc(bt_addr + 4 * c * T::B_SBO + 256 * kk, 128,
                                     T::B_SBO, tc::kNone),
                       kk);                     // the first step overwrites
        tc::wgmma_commit();
        tc::wgmma_wait<0>();
        const uint32_t box = own + (chunks & 1) * wg::OUT_BYTES;
        tc::tma_store_wait_read_if<1>(leader);
        tc::named_bar_sync(wg::BAR_OUT + cw, 128);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 4 * (4 * c + q);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            tc::st_shared(box + lane_at + 8 * 64 * h + (q ^ sw) * 16,
                          tc::pack_bf16(acc[i + 2 * h] + scaling * d[4 * q + 2 * h],
                                        acc[i + 2 * h + 1] + scaling * d[4 * q + 2 * h + 1]));
        }
        tc::fence_proxy_async();
        tc::named_bar_sync(wg::BAR_OUT + cw, 128);
        tc::tma_store_2d_if(&omap, box, n0 + 32 * c, m0 + cw * 64, leader);
        ++chunks;
      }
    }
    tc::tma_store_wait_all_if(leader);
  }
}

// a row-major bf16 matrix (rows × cols) as a TMA map of box_cols ×
// box_rows boxes, 128-byte swizzled (64 columns: the operand tiles) or
// 64-byte (32 columns: the output chunks); false if the encoding fails
bool bf16_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
              int box_cols = 64) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  return tc::bf16_tensor_map(
      map, base, 2, dims, strides, box,
      box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

// the wgmma instance on `blocks` blocks, then with several K-splits the
// reduce.  The maps are encoded per call and passed by value, so a
// captured CUDA graph holds its own.  With r = 0 the A map is any valid one
// (x's): u is then never used.
template <int BN, int RP>
int launch_wgmma(const void* x, const void* w, const void* a, const void* b, const void* e,
                 const void* mask, void* out, void* workspace, int M, int K, int N, int r,
                 float scaling, int splits, int kslice, int blocks, cudaStream_t stream) {
  using T = WTile<BN, RP>;
  CUtensorMap xm, wm, am, om;
  if (!bf16_map(&xm, x, M, K, wg::BM) || !bf16_map(&wm, w, K, N, 64) ||
      !(r > 0 ? bf16_map(&am, a, r, K, RP) : bf16_map(&am, x, M, K, RP)) ||
      !bf16_map(&om, out, M, N, 64, wg::OUT_COLS))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = tc::ensure_smem_limit<wgmma_kernel<BN, RP>>(T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* part = static_cast<float*>(workspace);
  float* upart = splits > 1 ? part + (size_t)splits * M * N : nullptr;
  const bf16* bt = static_cast<const bf16*>(b);
  const float* ef = static_cast<const float*>(e);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  bf16* ot = static_cast<bf16*>(out);
  wgmma_kernel<BN, RP><<<blocks, wg::THREADS, T::SMEM, stream>>>(
      xm, wm, am, om, bt, ef, mk, part, upart, M, K, N, r, scaling, kslice, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  reduce_kernel<bf16><<<dim3(cdiv(N, RED_COLS), cdiv(M, RED_ROWS), 1), RED_THREADS, 0, stream>>>(
      part, upart, bt, ef, mk, ot, M, N, r, splits, scaling);
  return static_cast<int>(cudaGetLastError());
}

// tiles wider than 128 columns are built for ranks up to 16 only (the
// training path's; plan() gives larger ranks 128-column tiles)
template <int BN>
int launch_wgmma_rank(const void* x, const void* w, const void* a, const void* b,
                      const void* e, const void* mask, void* out, void* ws, int M, int K,
                      int N, int r, float scaling, int splits, int kslice, int blocks,
                      cudaStream_t s) {
  if (r <= 16)
    return launch_wgmma<BN, 16>(x, w, a, b, e, mask, out, ws, M, K, N, r, scaling, splits, kslice, blocks, s);
  if constexpr (BN == 128) {
    if (r <= 32)
      return launch_wgmma<BN, 32>(x, w, a, b, e, mask, out, ws, M, K, N, r, scaling, splits, kslice, blocks, s);
    return launch_wgmma<BN, 64>(x, w, a, b, e, mask, out, ws, M, K, N, r, scaling, splits, kslice, blocks, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

long long workspace_bytes(int C, int M, int N, int r, int splits) {
  return splits > 1 ? 4LL * splits * C * M * ((long long)N + r) : 0;
}

// the bf16 (mma_kernel) or f32 (tf32_kernel) instance for one tile, then,
// with several K-splits, the reduce; C > 1 (clients of a grouped call) is
// f32 only
template <typename T, int BM, int BN, int RP>
int launch_tile(const void* x, const void* w, const void* a, const void* b,
                const void* e, const void* mask, void* out, void* workspace,
                int C, int M, int K, int N, int r, float scaling, int splits,
                int kslice, cudaStream_t stream) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int E = 16 / sizeof(T);
  float* part = static_cast<float*>(workspace);
  float* upart = splits > 1 ? part + (size_t)splits * C * M * N : nullptr;
  const bool aligned = K % E == 0 && N % E == 0 && tc::aligned16(x) &&
                       tc::aligned16(w) && tc::aligned16(a);
  // m-tiles vary fastest, so the blocks that share a W tile run together
  // and all but the first find it in L2
  const dim3 grid(C * cdiv(M, BM), cdiv(N, BN), splits);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  const float* ef = static_cast<const float*>(e);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  T* ot = static_cast<T*>(out);
  cudaError_t err;
  if constexpr (F32) {
    err = tc::ensure_smem_limit<tf32_kernel<BM, BN, RP>>(TileF<BM, BN, RP>::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool b_aligned = r % 4 == 0 && tc::aligned16(b);
    tf32_kernel<BM, BN, RP><<<grid, THREADS, TileF<BM, BN, RP>::SMEM, stream>>>(
        xt, wt, at, bt, ef, mk, ot, part, upart, M, K, N, r, scaling, kslice,
        aligned, b_aligned);
  } else {
    if (C != 1) return static_cast<int>(cudaErrorInvalidValue);
    err = tc::ensure_smem_limit<mma_kernel<BM, BN, RP>>(Tile<BM, BN, RP>::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    mma_kernel<BM, BN, RP><<<grid, THREADS, Tile<BM, BN, RP>::SMEM, stream>>>(
        xt, wt, at, bt, ef, mk, ot, part, upart, M, K, N, r, scaling, kslice,
        aligned);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  reduce_kernel<T><<<dim3(cdiv(N, RED_COLS), cdiv(M, RED_ROWS), C), RED_THREADS, 0, stream>>>(
      part, upart, bt, ef, mk, ot, M, N, r, splits, scaling);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BM, int BN>
int launch_rank(const void* x, const void* w, const void* a, const void* b,
                const void* e, const void* mask, void* out, void* ws, int C,
                int M, int K, int N, int r, float scaling, int splits,
                int kslice, cudaStream_t s) {
  if (r <= 16)
    return launch_tile<T, BM, BN, 16>(x, w, a, b, e, mask, out, ws, C, M, K, N, r, scaling, splits, kslice, s);
  // the f32 128-row tile spills past rank 16 (plan() gives such ranks
  // 64-row tiles: F32_WIDE_MAX_RANK)
  if constexpr (std::is_same_v<T, float> && BM == 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (r <= 32)
      return launch_tile<T, BM, BN, 32>(x, w, a, b, e, mask, out, ws, C, M, K, N, r, scaling, splits, kslice, s);
    return launch_tile<T, BM, BN, 64>(x, w, a, b, e, mask, out, ws, C, M, K, N, r, scaling, splits, kslice, s);
  }
}

int launch(const void* x, const void* w, const void* a, const void* b,
           const void* e, const void* mask, void* out, int C, int M, int K,
           int N, int r, float scaling, int dtype, void* workspace,
           long long workspace_size, int block_m, int block_n, int splits,
           int k_slice, int wgmma_blocks, void* stream) {
  if (C < 1 || M < 0 || K < 0 || N < 0 || r < 0 || r > RMAX ||
      (dtype != 0 && dtype != 1) || (dtype == 1 && C != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int step = dtype == 1 ? BK : F_BK;
  const bool slices_ok = splits >= 1 && splits <= 65535 && k_slice >= step &&
                         block_n > 0 && cdiv(N, block_n) <= 65535 &&
                         C <= 65535 && k_slice % step == 0 &&
                         (long long)splits * k_slice >= K &&
                         (long long)(splits - 1) * k_slice < (K > 0 ? K : 1);
  if (!slices_ok || workspace_size < workspace_bytes(C, M, N, r, splits) ||
      (splits > 1 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = block_m * 1000 + block_n;
  if (wgmma_blocks > 0) {               // bf16 at training rows
    // TMA takes 16-byte aligned bases and row pitches (x and A rows of K,
    // W rows of N bf16 values)
    const bool tma_ok = dtype == 1 && K > 0 && K % 8 == 0 && N % 8 == 0 &&
                        tc::aligned16(x) && tc::aligned16(w) && tc::aligned16(out) &&
                        (r == 0 || tc::aligned16(a));
    if (!tma_ok || k_slice % wg::BK != 0) return static_cast<int>(cudaErrorInvalidValue);
    switch (tile) {
      case 128256: return launch_wgmma_rank<256>(x, w, a, b, e, mask, out, workspace, M, K, N, r, scaling, splits, k_slice, wgmma_blocks, s);
      case 128224: return launch_wgmma_rank<224>(x, w, a, b, e, mask, out, workspace, M, K, N, r, scaling, splits, k_slice, wgmma_blocks, s);
      case 128128: return launch_wgmma_rank<128>(x, w, a, b, e, mask, out, workspace, M, K, N, r, scaling, splits, k_slice, wgmma_blocks, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 0) {
    switch (tile) {
      case 128064: return launch_rank<float, 128, 64>(x, w, a, b, e, mask, out, workspace, C, M, K, N, r, scaling, splits, k_slice, s);
      case 64064: return launch_rank<float, 64, 64>(x, w, a, b, e, mask, out, workspace, C, M, K, N, r, scaling, splits, k_slice, s);
      case 64032: return launch_rank<float, 64, 32>(x, w, a, b, e, mask, out, workspace, C, M, K, N, r, scaling, splits, k_slice, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (tile) {
    case 64064: return launch_rank<bf16, 64, 64>(x, w, a, b, e, mask, out, workspace, 1, M, K, N, r, scaling, splits, k_slice, s);
    case 32064: return launch_rank<bf16, 32, 64>(x, w, a, b, e, mask, out, workspace, 1, M, K, N, r, scaling, splits, k_slice, s);
    case 16064: return launch_rank<bf16, 16, 64>(x, w, a, b, e, mask, out, workspace, 1, M, K, N, r, scaling, splits, k_slice, s);
    case 16032: return launch_rank<bf16, 16, 32>(x, w, a, b, e, mask, out, workspace, 1, M, K, N, r, scaling, splits, k_slice, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, a, b and out share it); e is
// float32 and mask is bool (one byte each).  The tiling plan comes from the
// caller (kernels/bea_fused.py:plan): a block_m × block_n output tile —
// bf16 ∈ {64×64, 32×64, 16×64, 16×32}, f32 ∈ {128×64, 64×64, 64×32}, or
// with wgmma_blocks > 0 the bf16 wgmma instance on that many blocks, tile
// 128 × {256, 224, 128} (K and N multiples of 8, x, w and a 16-byte
// aligned) — and `splits` K-slices of k_slice each (a multiple of the
// instance's K-step, 64 for bf16 and 32 for f32), none of them empty; with
// more than one split, `workspace` holds at least 4·splits·M·(N + r)
// bytes.  Returns cudaGetLastError().
extern "C" int bea_dense_launch(const void* x, const void* w, const void* a,
                                const void* b, const void* e, const void* mask,
                                void* out, int M, int K, int N, int r,
                                float scaling, int dtype, void* workspace,
                                long long workspace_size, int block_m,
                                int block_n, int splits, int k_slice,
                                int wgmma_blocks, void* stream) {
  return launch(x, w, a, b, e, mask, out, 1, M, K, N, r, scaling, dtype,
                workspace, workspace_size, block_m, block_n, splits, k_slice,
                wgmma_blocks, stream);
}

// The client-grouped f32 call: x (C, M, K), a (C, r, K), b (C, N, r), e
// (C, r) and out (C, M, N), each client's slice contiguous after the one
// before; w (K, N) and mask (r,) shared by every client.  The plan is the
// single call's, over C times the row tiles (kernels/bea_fused.py:plan with
// clients = C), and a split call's workspace holds at least
// 4·splits·C·M·(N + r) bytes.  Returns cudaGetLastError().
extern "C" int bea_dense_grouped_launch(const void* x, const void* w,
                                        const void* a, const void* b,
                                        const void* e, const void* mask,
                                        void* out, int C, int M, int K, int N,
                                        int r, float scaling, void* workspace,
                                        long long workspace_size, int block_m,
                                        int block_n, int splits, int k_slice,
                                        void* stream) {
  return launch(x, w, a, b, e, mask, out, C, M, K, N, r, scaling, 0,
                workspace, workspace_size, block_m, block_n, splits, k_slice,
                0, stream);
}
