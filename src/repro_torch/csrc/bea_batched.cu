// Rank-bucketed multi-tenant masked-BEA linear for Hopper (sm_90a):
//
//     y[i] = x[i]·W + s·((x[i]·A_gᵀ) ⊙ (e_g⊙m_g))·B_gᵀ,   g = idx[i]
//
// Replaces the Pallas TPU kernel repro/kernels/bea_batched.py:_kernel (line
// 41; through _bea_batched_call, bea_batched and the
// repro/kernels/ops.py:adapted_dense_multi dispatch).
//
// What bounds it on an H100: at decode a bucket group has M ≤ 8 rows (up to
// 64 with more slots), so the call does 2·M flops per weight element, far
// under the ~295 flop/byte ridge of the bf16 tensor cores: the floor is
// reading W once from HBM (3.35 TB/s), 0.07–2.6 µs per linear at the
// serving path's shapes, so launch and pipeline latency are the rest of
// the bill.
//
// bfloat16, the serving path's type: one launch per call, W streamed once.
//  1. One launch.  The grid is (K-splits, column tiles, 64-row chunks) and
//     the K-splits of one column tile form a thread-block cluster (at most
//     8, a portable size).  After its K-loop each block pushes, over
//     distributed shared memory, its f32 partial of each column to the
//     block of the cluster that owns that column, and its rows' u to every
//     block; after one cluster barrier each block sums what it received in
//     split order, applies the adapter epilogue to its columns and stores.
//     No workspace, no counters, no second kernel: the same call gives the
//     same bits every time and is graph-safe.  (At M ≤ 8 the pushed areas
//     lie beside the ring and the blocks arrive at the barrier's first half
//     when they start; at 64 rows they reuse the ring, once every block of
//     the cluster has left its K-loop.)
//  2. Bytes in flight.  x, W and the stacked A reach shared memory through
//     a ring of 16-byte cp.async copies whose slots are all in flight from
//     the start: 4 stages of 64 K-rows for 64-column tiles (3 at 64 rows),
//     6 for 32 and 8 for 16, up to 32 KB of W per block.  All M rows (up
//     to 64) sit in one block: W is read once per call whatever M is (once
//     per 64-row chunk above that).
//  3. Tensor cores, operands swapped.  mma.sync m16n8k16 computes
//     yᵀ = Wᵀ·xᵀ: 16 columns of W fill the 16-row side (ldmatrix.trans of
//     the k-major W tile) and 8 rows of x the 8-wide side (x is already the
//     "col" operand), so M = 1..8 costs one n8 fragment.  The stacked
//     A_all (G·r, K), K-contiguous, rides the same MMA as extra 16-row tiles
//     and gives u for every adapter of the group over the block's K-slice;
//     it is re-read by every column tile from L2, not HBM.  Where G·r > 64
//     the stack is not staged: each row's own adapter is gathered and u is
//     summed on the CUDA cores after the K-loop instead.  The epilogue picks
//     each row's u through idx, scales it by e⊙mask in f32, rounds it to
//     bf16 as the TPU kernel does before ·B_gᵀ, and adds s·u·B_gᵀ (r ≤ 64
//     FMAs an output, B and e⊙mask fetched into shared memory while W
//     streams) before the one store.  At M = 64 the products stay on the
//     tensor cores, so the call stays bound by bytes, not FMAs.
//  4. The plan is the host's (kernels/bea_batched.py:plan): column-tile
//     width 64, 32 or 16 and the K-splits (the cluster size), chosen from K
//     and N so that every path linear fills the card without 8-row slivers
//     of K; the ring keeps no more stages than the slice has K-steps.
//  5. Rows are independent: an output is summed by one warp over K in
//     order, then over the splits in order, and the plan does not depend on
//     M, so a row served alone equals the same row in a batch, bit for bit.
//     Rows whose idx lies outside [0, G) get no adapter, as the TPU kernel's
//     one-hot gives.  Ragged M, N, K and r are masked, and rows that are not
//     16-byte aligned (K or N not a multiple of 8, an offset pointer) take
//     plain loads instead of cp.async; nothing is padded on the host.
//
// float32 keeps the SIMT body of the first port as its own instance: a
// split-K kernel of scalar FMAs (K-splits from kernels/bea_batched.py:
// simt_plan, partials in a workspace the wrapper provides) and a second
// kernel that sums the splits and applies the adapter.  It is off the
// serving path, and the tensor cores (TF32) cannot hold the f32 tolerance.
//
// Both: G = 0 or r = 0 never reaches the kernel (the wrapper short-circuits
// to x·W as the JAX wrapper does); r ≤ 64; launches go on the caller's
// stream and return cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int RMAX = 64;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// the two halves of a cluster barrier: arrive (release) does not block,
// wait (acquire) returns once every block of the cluster has arrived
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ------------------------------------------------ float32: SIMT body ------

constexpr int MT = 8;              // rows per M-tile
constexpr int SBN = 64;            // columns per partial block, 2 per lane
constexpr int WARPS = 8;
constexpr int STHREADS = 32 * WARPS;
constexpr int KMAX = 512;          // most K rows one split stages
constexpr int EBN = STHREADS / MT; // columns per epilogue block

__global__ void __launch_bounds__(STHREADS)
partial_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ a, const int32_t* __restrict__ idx,
               float* __restrict__ part, float* __restrict__ upart, int M,
               int K, int N, int G, int r, int krange, bool w_aligned) {
  __shared__ float xs[MT][KMAX];
  __shared__ float red[WARPS][MT][SBN];
  __shared__ int gs[MT];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tile = blockIdx.x, split = blockIdx.y, m0 = blockIdx.z * MT;
  const int rows = min(MT, M - m0);
  const int k0 = split * krange;
  const int klen = max(0, min(K, k0 + krange) - k0);

  for (int i = tid; i < MT * krange; i += STHREADS) {
    const int m = i / krange, kk = i % krange;
    xs[m][kk] = (m < rows && kk < klen) ? x[(size_t)(m0 + m) * K + k0 + kk] : 0.f;
  }
  if (tid < MT) {
    const int g = (tid < rows) ? idx[m0 + tid] : -1;
    gs[tid] = (g >= 0 && g < G) ? g : -1;
  }
  __syncthreads();

  // x·W over this split: warp `warp` takes rows warp, warp + 8, …
  const int n = tile * SBN + 2 * lane;
  const bool pair = w_aligned && (n + 1 < N) && ((N & 1) == 0);
  float acc[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m][0] = acc[m][1] = 0.f;
#pragma unroll 4
  for (int kk = warp; kk < klen; kk += WARPS) {
    const float* wr = w + (size_t)(k0 + kk) * N;
    float w0 = 0.f, w1 = 0.f;
    if (pair) {
      const float2 v = *reinterpret_cast<const float2*>(wr + n);
      w0 = v.x;
      w1 = v.y;
    } else {
      if (n < N) w0 = wr[n];
      if (n + 1 < N) w1 = wr[n + 1];
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      acc[m][0] = fmaf(xs[m][kk], w0, acc[m][0]);
      acc[m][1] = fmaf(xs[m][kk], w1, acc[m][1]);
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    red[warp][m][2 * lane] = acc[m][0];
    red[warp][m][2 * lane + 1] = acc[m][1];
  }
  __syncthreads();
  for (int e = tid; e < MT * SBN; e += STHREADS) {
    const int m = e / SBN, c = e % SBN, gn = tile * SBN + c;
    if (m < rows && gn < N) {
      float s = 0.f;
#pragma unroll
      for (int ww = 0; ww < WARPS; ++ww) s += red[ww][m][c];
      part[((size_t)split * M + m0 + m) * N + gn] = s;
    }
  }

  // partial u = x·A_gᵀ over this split, once per split (first column tile)
  if (tile == 0) {
    for (int p = warp; p < rows * r; p += WARPS) {
      const int m = p / r, j = p % r, g = gs[m];
      float v = 0.f;
      if (g >= 0) {
        const float* ar = a + ((size_t)g * r + j) * K + k0;
        for (int kk = lane; kk < klen; kk += 32) v = fmaf(xs[m][kk], ar[kk], v);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) upart[((size_t)split * M + m0 + m) * r + j] = v;
    }
  }
}

__global__ void __launch_bounds__(STHREADS)
epilogue_kernel(const float* __restrict__ part, const float* __restrict__ upart,
                const float* __restrict__ b, const float* __restrict__ e,
                const uint8_t* __restrict__ mask, const int32_t* __restrict__ idx,
                float* __restrict__ out, int M, int N, int G, int r, int splits,
                float scaling) {
  __shared__ float us[MT][RMAX];
  __shared__ int gs[MT];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * MT, rows = min(MT, M - m0);
  if (tid < MT) {
    const int g = (tid < rows) ? idx[m0 + tid] : -1;
    gs[tid] = (g >= 0 && g < G) ? g : -1;
  }
  __syncthreads();
  for (int i = tid; i < MT * r; i += STHREADS) {
    const int m = i / r, j = i % r, g = gs[m];
    float v = 0.f;
    if (m < rows && g >= 0) {
      for (int s = 0; s < splits; ++s) v += upart[((size_t)s * M + m0 + m) * r + j];
      v *= e[(size_t)g * r + j] * (mask[(size_t)g * r + j] ? 1.f : 0.f);
    }
    us[m][j] = v;
  }
  __syncthreads();
  const int m = tid / EBN, gn = blockIdx.x * EBN + tid % EBN;
  if (m < rows && gn < N) {
    float y = 0.f;
    for (int s = 0; s < splits; ++s) y += part[((size_t)s * M + m0 + m) * N + gn];
    const int g = gs[m];
    float d = 0.f;
    if (g >= 0) {
      const float* br = b + ((size_t)g * N + gn) * r;
      for (int j = 0; j < r; ++j) d = fmaf(us[m][j], br[j], d);
    }
    out[(size_t)(m0 + m) * N + gn] = y + scaling * d;
  }
}

int launch_simt(const void* x, const void* w, const void* a, const void* b,
                const void* e, const void* mask, const void* idx, void* out,
                void* workspace, int M, int K, int N, int G, int r,
                float scaling, int splits, int krange, cudaStream_t stream) {
  float* part = static_cast<float*>(workspace);
  float* upart = part + (size_t)splits * M * N;
  const int mtiles = cdiv(M, MT);
  partial_kernel<<<dim3(cdiv(N, SBN), splits, mtiles), STHREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(a), static_cast<const int32_t*>(idx), part,
      upart, M, K, N, G, r, krange,
      reinterpret_cast<uintptr_t>(w) % (2 * sizeof(float)) == 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  epilogue_kernel<<<dim3(cdiv(N, EBN), mtiles), STHREADS, 0, stream>>>(
      part, upart, static_cast<const float*>(b), static_cast<const float*>(e),
      static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), M, N, G, r, splits, scaling);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------- bfloat16: tensor cores ------------

constexpr int THREADS = 128;   // 4 warps
constexpr int BK = 64;         // K per pipeline stage
constexpr int PAD = 8;         // bf16 elements of padding per shared row
constexpr int LDK = BK + PAD;  // row pitch of the x and stacked-A tiles
constexpr int MTILE = 64;      // rows one block holds
constexpr int MAX_STACKED = 64;   // G·r staged for the MMA; above, gathered
constexpr int MAX_CLUSTER = 8;

// MP rows of x (8 or 64: the fragments past M are skipped), UT 16-row
// tiles of the stacked A (1 or 4; 0: gathered), BN columns of W per block.
template <int MP, int UT, int BN>
struct Tile {
  // ring depth: about 32 KB of W per block in flight; 3 stages for 64-row,
  // 64-column tiles, whose x tile is as large as W's, so that a wide
  // linear's blocks still fit the card in one wave
  static constexpr int STAGES = BN == 64 ? (MP == 8 ? 4 : 3) : BN == 32 ? 6 : 8;
  static constexpr int NT = BN / 16;             // 16-column tiles of W
  static constexpr int RT = NT + UT;             // row tiles of yᵀ and uᵀ
  static constexpr int MF = MP / 8;              // 8-row fragments of x
  static constexpr int WC = MF < 2 ? MF : 2;     // warps along the rows of x
  static constexpr int WR = 4 / WC;              // warps along the row tiles
  static constexpr int RPW = (RT + WR - 1) / WR; // row tiles per warp
  static constexpr int FPW = MF / WC;            // x fragments per warp
  static constexpr int LDN = BN + PAD;           // row pitch of the W tile
  static constexpr int X_ELEMS = MP * LDK;
  static constexpr int W_ELEMS = BK * LDN;
  static constexpr int STAGE_ELEMS = X_ELEMS + W_ELEMS + UT * 16 * LDK;
  // ahead of the ring, a staged stack's B rows of this tile (bf16) and
  // e⊙mask (f32); the epilogue's f32 areas reuse the ring
  // (kernels/bea_batched.py:smem_bytes)
  static constexpr int PRE_BYTES = UT * 16 * (2 * BN + 4);
  // What the peers push here (every split's u of each row's adapter and
  // partial of the owned columns) lies apart from the ring when M ≤ 8, so
  // peers may push as soon as they finish; at 64 rows it would not fit
  // beside the ring and reuses it once every block has left its K-loop.
  static constexpr bool REC_APART = MP == 8;
  __host__ __device__ static int rec_bytes(int splits, int r) {
    return (4 * (splits * MP * r + splits * cdiv(BN, splits) * MP) + 15) / 16 * 16;
  }
  static int smem(int stages, int splits, int r) {
    const int ring = 2 * STAGE_ELEMS * stages;
    const int local = 4 * (UT * 16 * MP + MP * RMAX);
    const int rec = rec_bytes(splits, r);
    if (REC_APART) return PRE_BYTES + rec + (ring > local ? ring : local);
    return PRE_BYTES + (ring > local + rec ? ring : local + rec);
  }
  static int most_smem() {             // over every cluster size and rank
    int most = 0;
    for (int s = 1; s <= MAX_CLUSTER; ++s)
      most = smem(STAGES, s, RMAX) > most ? smem(STAGES, s, RMAX) : most;
    return most;
  }
};

// (a minimum of one block per SM lets ptxas keep every instance unspilled)
template <int MP, int UT, int BN>
__global__ void __launch_bounds__(THREADS, 1)
mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
           const bf16* __restrict__ a, const bf16* __restrict__ b,
           const float* __restrict__ e, const uint8_t* __restrict__ mask,
           const int32_t* __restrict__ idx, bf16* __restrict__ out, int M,
           int K, int N, int G, int r, float scaling, int kslice,
           bool aligned, bool b_aligned) {
  using T = Tile<MP, UT, BN>;
  extern __shared__ __align__(16) unsigned char smem_pre[];
  bf16* bsm = reinterpret_cast<bf16*>(smem_pre);                // G × BN × r
  float* emsm = reinterpret_cast<float*>(smem_pre + UT * 16 * 2 * BN);
  const int split = blockIdx.x, splits = gridDim.x;   // cluster rank, size
  unsigned char* rec_raw = smem_pre + T::PRE_BYTES;
  unsigned char* smem_raw = rec_raw + (T::REC_APART ? T::rec_bytes(splits, r) : 0);
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  __shared__ int gs[MP];
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp % T::WR, wc = warp / T::WR;
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * MTILE;
  const int rows = min(MP, M - m0);
  const int kb = split * kslice, ke = min(K, kb + kslice);
  const int nk = ke > kb ? cdiv(ke - kb, BK) : 0;
  const int gr = G * r;
  const int arows = UT ? min(UT * 16, cdiv(gr, 16) * 16) : 0;  // live tiles
  if (tid < MP) {
    const int g = tid < rows ? idx[m0 + tid] : -1;
    gs[tid] = (g >= 0 && g < G) ? g : -1;
  }
  if constexpr (T::REC_APART) cluster_arrive();   // started: peers may push
  // a staged stack's e⊙mask, fetched now and stored after the K-loop, so
  // that its latency hides behind the loads of W
  float em_pre = 0.f;
  if (UT > 0 && tid < gr) em_pre = e[tid] * (mask[tid] ? 1.f : 0.f);

  // Each thread copies the same chunks of every stage: their places in the
  // ring, their first sources and what limits them are fixed for the whole
  // K-loop, so they are worked out once here and a stage adds its offset.
  constexpr int XC = (MP * 8 + THREADS - 1) / THREADS;   // chunks of x,
  constexpr int WC = BK * BN / 8 / THREADS;              // W and the
  constexpr int AC = UT > 0 ? UT : 1;                    // stacked A
  const bf16* xsrc[XC];
  const bf16* wsrc[WC];
  const bf16* asrc[AC];
  int xoff[XC], xcol[XC], woff[WC], wrow[WC], wlen[WC], aoff[AC], acol[AC];
#pragma unroll
  for (int q = 0; q < XC; ++q) {
    const int c = q * THREADS + tid, row = c >> 3, col = (c & 7) * 8;
    xoff[q] = row * LDK + col;
    xcol[q] = c < MP * 8 && row < rows ? col : BK;       // BK: no copy
    xsrc[q] = x + (size_t)(m0 + row) * K + kb + col;
  }
#pragma unroll
  for (int q = 0; q < WC; ++q) {
    const int c = q * THREADS + tid, row = c / (BN / 8), col = (c % (BN / 8)) * 8;
    woff[q] = row * T::LDN + col;
    wrow[q] = row;
    wlen[q] = max(0, min(8, N - n0 - col));
    wsrc[q] = w + (size_t)(kb + row) * N + n0 + col;
  }
#pragma unroll
  for (int q = 0; q < AC; ++q) {
    const int c = q * THREADS + tid, row = c >> 3, col = (c & 7) * 8;
    aoff[q] = row * LDK + col;
    acol[q] = UT > 0 && row < gr ? col : BK;
    asrc[q] = a + (size_t)row * K + kb + col;
  }

  // one stage: x (M rows), W (64 × BN), stacked A (G·r rows); the bytes
  // past a ragged edge of K or N are zero-filled.  The rows of a live
  // fragment past M or G·r are not loaded: they only reach products that
  // are never read (an MMA output column depends on its own x row alone).
  auto load_stage = [&](int slot, int step) {
    bf16* xs = smem + slot * T::STAGE_ELEMS;
    bf16* ws = xs + T::X_ELEMS;
    bf16* as = ws + T::W_ELEMS;
    const int dk = step * BK, kv = min(BK, ke - kb - dk);
#pragma unroll
    for (int q = 0; q < XC; ++q)
      if (xcol[q] < BK)
        tc::copy16(xs + xoff[q], xsrc[q] + dk, max(0, min(8, kv - xcol[q])), aligned, x);
#pragma unroll
    for (int q = 0; q < WC; ++q)
      tc::copy16(ws + woff[q], wsrc[q] + (size_t)dk * N, wrow[q] < kv ? wlen[q] : 0,
                aligned, w);
#pragma unroll
    for (int q = 0; q < AC; ++q)
      if (acol[q] < BK)
        tc::copy16(as + aoff[q], asrc[q] + dk, max(0, min(8, kv - acol[q])), aligned, a);
  };

  float acc[T::RPW][T::FPW][4];
#pragma unroll
  for (int t = 0; t < T::RPW; ++t)
#pragma unroll
    for (int f = 0; f < T::FPW; ++f)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[t][f][c] = 0.f;

#pragma unroll
  for (int s = 0; s < T::STAGES; ++s) {
    if (s < nk) load_stage(s, s);
    if (UT > 0 && s == 0) {
      // with stage 0: every stacked adapter's B rows of this tile, one
      // contiguous run of BN·r values each
      const int run = BN * r, live = max(0, min(BN, N - n0)) * r;
      for (int c = tid * 8; c < G * run; c += THREADS * 8) {
        const int g = c / run, o = c % run;
        tc::copy16(bsm + c, b + ((size_t)g * N + n0) * r + o,
                  max(0, min(8, live - o)), b_aligned, b);
      }
    }
    tc::cp_async_commit();
  }
  // every slot of the ring is in flight from the start (a slice no longer
  // than the ring is read in one go); a slot is refilled once consumed
  for (int i = 0; i < nk; ++i) {
    tc::cp_async_wait<T::STAGES - 1>();
    __syncthreads();                    // stage i landed
    const bf16* xs = smem + (i % T::STAGES) * T::STAGE_ELEMS;
    const bf16* ws = xs + T::X_ELEMS;
    const bf16* as = ws + T::W_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t bx[T::FPW][2];
#pragma unroll
      for (int f = 0; f < T::FPW; ++f) {
        const int mi = wc + f * T::WC;
        if (mi * 8 < rows)
          tc::ldsm_x2(bx[f], xs + (mi * 8 + (lane & 7)) * LDK + kk +
                                 ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int t = 0; t < T::RPW; ++t) {
        const int rt = wr + t * T::WR;
        if (rt >= T::RT || (rt >= T::NT && (rt - T::NT) * 16 >= arows)) continue;
        uint32_t af[4];
        if (rt < T::NT)                 // Wᵀ: the k-major W tile, transposed
          tc::ldsm_x4_t(af, ws + (kk + (lane & 7) + ((lane >> 4) & 1) * 8) * T::LDN +
                                rt * 16 + ((lane >> 3) & 1) * 8);
        else                            // stacked A rows, K-contiguous
          tc::ldsm_x4(af, as + ((rt - T::NT) * 16 + (lane & 15)) * LDK + kk +
                              (lane >> 4) * 8);
#pragma unroll
        for (int f = 0; f < T::FPW; ++f)
          if ((wc + f * T::WC) * 8 < rows)
            tc::mma_bf16(acc[t][f], af, bx[f][0], bx[f][1]);
      }
    }
    const int nxt = i + T::STAGES;
    if (nxt < nk) {
      __syncthreads();                  // every warp is done with slot i
      load_stage(i % T::STAGES, nxt);
    }
    tc::cp_async_commit();
  }
  tc::cp_async_wait<0>();
  __syncthreads();                      // the ring is free for the epilogue
  if constexpr (!T::REC_APART) cluster_arrive();  // ... and may take pushes

  // f32 areas over the ring: u of every stacked rank and the cluster's
  // bf16-rounded u⊙em (this block's own); then, apart or over the ring,
  // what the peers push here: every split's u of each row's adapter, and
  // every split's partial of the columns this block owns
  const int cols = cdiv(BN, splits), c0 = split * cols;
  const int owned = max(0, min(BN, c0 + cols) - c0);
  float* uall = reinterpret_cast<float*>(smem_raw);    // UT·16 × MP
  float* tsel = uall + UT * 16 * MP;                   // MP × RMAX
  float* ru = T::REC_APART ? reinterpret_cast<float*>(rec_raw)
                           : tsel + MP * RMAX;         // splits × MP × r
  float* ry = ru + splits * MP * r;                    // splits × MP × cols
  const int gq = lane >> 2, t2 = (lane & 3) * 2;
  if constexpr (UT > 0) {
#pragma unroll
    for (int t = 0; t < T::RPW; ++t) {
      const int rt = wr + t * T::WR;
      if (rt < T::NT || rt >= T::RT) continue;
#pragma unroll
      for (int f = 0; f < T::FPW; ++f) {
        const int mi = wc + f * T::WC;
        if (mi * 8 >= rows) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* dst = uall + ((rt - T::NT) * 16 + gq + 8 * h) * MP + mi * 8 + t2;
          dst[0] = acc[t][f][2 * h];
          dst[1] = acc[t][f][2 * h + 1];
        }
      }
    }
    if (tid < gr) emsm[tid] = em_pre;
  }
  __syncthreads();
  cluster_wait();                       // every peer can take pushes

  // this split's u of each row's adapter, to every block of the cluster
  if constexpr (UT > 0) {
    for (int p = tid; p < rows * r; p += THREADS) {
      const int m = p / r, j = p % r, g = gs[m];
      const float v = g >= 0 ? uall[(g * r + j) * MP + m] : 0.f;
#pragma unroll
      for (int o = 0; o < MAX_CLUSTER; ++o)
        if (o < splits) cluster.map_shared_rank(ru, o)[(split * MP + m) * r + j] = v;
    }
  } else {
    // a stack too large to stage: each row's own adapter, gathered, on the
    // CUDA cores over the block's K-slice
    for (int p = warp; p < rows * r; p += THREADS / 32) {
      const int m = p / r, j = p % r, g = gs[m];
      float v = 0.f;
      if (g >= 0) {
        const bf16* ar = a + ((size_t)g * r + j) * K;
        const bf16* xr = x + (size_t)(m0 + m) * K;
        for (int k = kb + lane; k < ke; k += 32)
          v = fmaf(__bfloat162float(xr[k]), __bfloat162float(ar[k]), v);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane < splits) cluster.map_shared_rank(ru, lane)[(split * MP + m) * r + j] = v;
    }
  }
  // this split's partial of x·W, each column to the block that owns it
#pragma unroll
  for (int t = 0; t < T::RPW; ++t) {
    const int rt = wr + t * T::WR;
    if (rt >= T::NT) continue;
#pragma unroll
    for (int f = 0; f < T::FPW; ++f) {
      const int mi = wc + f * T::WC;
      if (mi * 8 >= rows) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int nl = rt * 16 + gq + 8 * h, o = nl / cols;
        float* dst = cluster.map_shared_rank(ry, o) +
                     (split * MP + mi * 8 + t2) * cols + nl - o * cols;
        dst[0] = acc[t][f][2 * h];
        dst[cols] = acc[t][f][2 * h + 1];
      }
    }
  }
  cluster.sync();                       // every push has landed

  // the splits are summed in split order, all from this block's memory;
  // the loops are unrolled so that a thread's loads are in flight together
  for (int p = tid; p < rows * r; p += THREADS) {
    const int m = p / r, j = p % r, g = gs[m];
    float v = 0.f;
    if (g >= 0) {
#pragma unroll
      for (int s = 0; s < MAX_CLUSTER; ++s)
        if (s < splits) v += ru[(s * MP + m) * r + j];
      v *= UT > 0 ? emsm[g * r + j] : e[g * r + j] * (mask[g * r + j] ? 1.f : 0.f);
    }
    tsel[m * RMAX + j] = __bfloat162float(__float2bfloat16(v));
  }
  __syncthreads();
  for (int p = tid; p < rows * owned; p += THREADS) {
    const int m = p / owned, c = p % owned, n = n0 + c0 + c;
    if (n >= N) continue;
    float y = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_CLUSTER; ++s)
      if (s < splits) y += ry[(s * MP + m) * cols + c];
    const int g = gs[m];
    float d = 0.f;
    if (g >= 0) {
      if constexpr (UT > 0) {
        const bf16* br = bsm + (g * BN + c0 + c) * r;
#pragma unroll 8
        for (int j = 0; j < r; ++j) d = fmaf(tsel[m * RMAX + j], __bfloat162float(br[j]), d);
      } else {
        const bf16* br = b + ((size_t)g * N + n) * r;
        for (int j = 0; j < r; ++j) d = fmaf(tsel[m * RMAX + j], __bfloat162float(br[j]), d);
      }
    }
    out[(size_t)(m0 + m) * N + n] = __float2bfloat16(y + scaling * d);
  }
}

template <int MP, int UT, int BN>
int launch_mma(const void* x, const void* w, const void* a, const void* b,
               const void* e, const void* mask, const void* idx, void* out,
               int M, int K, int N, int G, int r, float scaling, int splits,
               int kslice, cudaStream_t stream) {
  using T = Tile<MP, UT, BN>;
  cudaError_t err = tc::ensure_smem_limit<mma_kernel<MP, UT, BN>>(T::most_smem());
  if (err != cudaSuccess) return static_cast<int>(err);
  const int steps = kslice / BK;
  const bool aligned = K % 8 == 0 && N % 8 == 0 && tc::aligned16(x) &&
                       tc::aligned16(w) && tc::aligned16(a);
  const bool b_aligned = (long long)N * r % 8 == 0 && tc::aligned16(b);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, cdiv(N, BN), cdiv(M, MTILE));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = T::smem(steps < T::STAGES ? steps : T::STAGES, splits, r);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mma_kernel<MP, UT, BN>,
                           static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                           static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                           static_cast<const float*>(e), static_cast<const uint8_t*>(mask),
                           static_cast<const int32_t*>(idx), static_cast<bf16*>(out),
                           M, K, N, G, r, scaling, kslice, aligned, b_aligned);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int MP, int UT>
int launch_mma_bn(int block_n, const void* x, const void* w, const void* a,
                  const void* b, const void* e, const void* mask,
                  const void* idx, void* out, int M, int K, int N, int G,
                  int r, float scaling, int splits, int kslice, cudaStream_t s) {
  if (block_n == 64)
    return launch_mma<MP, UT, 64>(x, w, a, b, e, mask, idx, out, M, K, N, G, r, scaling, splits, kslice, s);
  if (block_n == 32)
    return launch_mma<MP, UT, 32>(x, w, a, b, e, mask, idx, out, M, K, N, G, r, scaling, splits, kslice, s);
  return launch_mma<MP, UT, 16>(x, w, a, b, e, mask, idx, out, M, K, N, G, r, scaling, splits, kslice, s);
}

template <int MP>
int launch_mma_ut(int block_n, const void* x, const void* w, const void* a,
                  const void* b, const void* e, const void* mask,
                  const void* idx, void* out, int M, int K, int N, int G,
                  int r, float scaling, int splits, int kslice, cudaStream_t s) {
  const int gr = G * r;
  if (gr > MAX_STACKED)
    return launch_mma_bn<MP, 0>(block_n, x, w, a, b, e, mask, idx, out, M, K, N, G, r, scaling, splits, kslice, s);
  if (gr <= 16)
    return launch_mma_bn<MP, 1>(block_n, x, w, a, b, e, mask, idx, out, M, K, N, G, r, scaling, splits, kslice, s);
  return launch_mma_bn<MP, 4>(block_n, x, w, a, b, e, mask, idx, out, M, K, N, G, r, scaling, splits, kslice, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, a, b and out share it); e is
// float32 (G, r), mask bool (G, r), idx int32 (M,).  The bfloat16 instance
// takes its plan from the caller (kernels/bea_batched.py:plan): column
// tiles of block_n ∈ {64, 32, 16} and `splits` ≤ 8 K-slices of k_slice (a
// multiple of 64) each, none of them empty; it needs no workspace.  The
// float32 instance takes `splits` slices of k_slice rows (a multiple of 8,
// at most 512; kernels/bea_batched.py:simt_plan), ignores block_n, and
// needs a workspace of 4·splits·M·(N + r) bytes.  Returns
// cudaGetLastError().
extern "C" int bea_batched_launch(const void* x, const void* w, const void* a,
                                  const void* b, const void* e,
                                  const void* mask, const void* idx, void* out,
                                  void* workspace, long long workspace_bytes,
                                  int M, int K, int N, int G, int r,
                                  float scaling, int dtype, int block_n,
                                  int splits, int k_slice, void* stream) {
  if (M < 0 || K < 0 || N < 0 || G < 1 || r < 1 || r > RMAX || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const bool covers = (long long)splits * k_slice >= K &&
                      (long long)(splits - 1) * k_slice < (K > 0 ? K : 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (!covers || k_slice < 8 || k_slice % 8 != 0 || k_slice > KMAX ||
        splits > 65535 || workspace == nullptr ||
        workspace_bytes < 4LL * splits * M * ((long long)N + r))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_simt(x, w, a, b, e, mask, idx, out, workspace, M, K, N, G,
                       r, scaling, splits, k_slice, s);
  }
  if (dtype != 1 || !covers || splits > MAX_CLUSTER || k_slice < BK ||
      k_slice % BK != 0 || (block_n != 64 && block_n != 32 && block_n != 16) ||
      cdiv(N, block_n) > 65535 || cdiv(M, MTILE) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 8)
    return launch_mma_ut<8>(block_n, x, w, a, b, e, mask, idx, out, M, K, N, G, r, scaling, splits, k_slice, s);
  return launch_mma_ut<MTILE>(block_n, x, w, a, b, e, mask, idx, out, M, K, N, G, r, scaling, splits, k_slice, s);
}
