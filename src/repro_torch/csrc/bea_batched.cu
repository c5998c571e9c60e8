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
// float32, the static-batch loop's decode of BART-base (M = 4 rows of one
// adapter at r = 12 through 8 linears a decoder layer): fma_kernel, one
// launch per call on the CUDA cores.
//  1. The same cluster structure as bf16: grid (K-splits, column tiles,
//     row chunks), the K-splits of one column tile a cluster of at most
//     8; after its K-loop each block pushes its f32 partial of each column
//     to the block that owns it and its rows' partial u to every block,
//     and after one cluster barrier the owners sum in split order, apply
//     the adapter and store once.  No workspace, no second kernel.
//  2. Exact f32 FMAs, not TF32.  At M ≤ 8 a call does at most 16 flops per
//     4-byte weight, 4 flop/B, under the CUDA cores' ridge of ~20 (67
//     TFLOP/s over 3.35 TB/s): bytes bound it, so 3xTF32 would buy nothing,
//     and sequential f32 FMAs leave no bias against float64.
//  3. Bytes in flight.  A stage is 8 KB of W (2048/BN K-rows, two 16-byte
//     cp.async a thread) with its rows of x (4-byte copies, transposed to
//     K-major so a thread reads a K-row's x as float4s) and of the stacked
//     A; the ring's 8 stages (4 with 64 stacked ranks) are all issued at
//     the start, which holds every BART linear's whole K-slice (48 KB of W
//     a block at fc2).  Each thread owns one column quad of the tile and
//     FMAs its K-rows into acc[MP][4]; the lanes and warps that share a
//     quad are summed after the loop in a fixed order.  A decode call is
//     short, so what a block does once bounds it as much as the bytes do:
//     the prologue's stage loop and the copy, push and epilogue loops stay
//     rolled (unrolled, an instance was about 4 times the code, run once
//     per block); the first cluster arrive is relaxed (it publishes
//     nothing); idx, e and mask are loaded before the copies are issued
//     and first used after the K-loop, so no warp waits on them first.
//  4. u on every block.  The stacked A_all (G·r ≤ 64 ranks, staged like W)
//     is multiplied on the same pass, a thread per stacked rank and group
//     of 4 K-rows, so every K-split block holds its slice's u of every
//     adapter and no column tile carries a tail; above 64 stacked ranks
//     each row's own adapter is gathered after the K-loop.  u⊙(e⊙m) stays
//     f32 before ·B_gᵀ (B is f32: the TPU kernel's cast is a no-op), and
//     the owned columns' B rows and e⊙m are fetched while W streams.
//  5. Rows come in chunks of MP = 4 (M ≤ 4) or 8: the decode batches that
//     reach this body hold a few rows, and at 8 rows the CUDA cores already
//     do 16 flop/B; more rows take further chunks, each re-reading W from
//     L2.  A row's FMAs and sums are the same in either instance and the
//     tiling (kernels/bea_batched.py:f32_plan) depends on K and N only, so
//     a row served alone equals the same row in a batch, bit for bit.
//  6. Rows whose idx lies outside [0, G) get no adapter; ragged M, N, K and
//     r are masked; W and A rows that are not 16-byte aligned (K or N not a
//     multiple of 4, an offset pointer) take four 4-byte copies instead.
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

// ------------------------------------------- float32: CUDA-core FMAs ------

constexpr int FTHREADS = 256;              // 8 warps
constexpr int FWARPS = FTHREADS / 32;
constexpr int F_MAX_ROWS = 8;              // rows a chunk holds at most

// 4 bytes global → shared; with src_bytes 0 the word is zeroed and not read
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(tc::smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// four floats global → shared, the first `valid` (0..4) real and the rest
// zero: one 16-byte cp.async where both addresses are 16-byte aligned,
// else four 4-byte ones; `dummy` is any valid global address
__device__ __forceinline__ void copy4f(float* dst, const float* src, int valid,
                                       bool aligned, const float* dummy) {
  if (aligned) {
    tc::cp_async16(dst, valid > 0 ? src : dummy, 4 * valid);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cp_async4(dst + i, i < valid ? src + i : dummy, i < valid ? 4 : 0);
  }
}

__host__ __device__ constexpr int align4(int v) { return (v + 3) / 4 * 4; }

// a cluster barrier's arrive without release semantics: the first arrive
// only says that the block has started (its shared memory may be written
// by peers), and publishes nothing, so it need not wait on a fence
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// x of one K-row, K-major in shared memory, as MP / 4 float4s
template <int MP>
__device__ __forceinline__ void load_x(float (&xv)[MP], const float* p) {
#pragma unroll
  for (int i = 0; i < MP / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    xv[4 * i] = v.x;
    xv[4 * i + 1] = v.y;
    xv[4 * i + 2] = v.z;
    xv[4 * i + 3] = v.w;
  }
}

struct FArgs {
  const float* x;
  const float* w;
  const float* a;
  const float* b;
  const float* e;
  const uint8_t* mask;
  const int32_t* idx;
  float* out;
  int M, K, N, G, r;
  float scaling;
  int splits, kslice;
};

// MP rows of x (4 or 8), UT 16-row tiles of the stacked A (1 or 4; 0:
// gathered), BN columns of W per block
template <int MP, int UT, int BN>
struct FTile {
  static constexpr int BK = 2048 / BN;       // K-rows a stage: 8 KB of W
  static constexpr int STAGES = UT == 4 ? 4 : 8;
  static constexpr int AP = 16 * UT;         // stacked-A rows staged
  static constexpr int LDA = BK + 4;         // row pitch of the A tile
  static constexpr int QW = BN / 4;          // column quads of W
  static constexpr int W_FLOATS = BK * BN;
  static constexpr int X_FLOATS = BK * MP;   // K-major: x[k][m]
  static constexpr int STAGE_FLOATS = W_FLOATS + X_FLOATS + AP * LDA;
  static constexpr int WQ = W_FLOATS / 4 / FTHREADS;      // W quads a thread
  static constexpr int AG = AP > 0 ? FTHREADS / AP : 1;   // 4-row K-groups a pass
  static constexpr int AQ = AP > 0 ? (BK / 4 + AG - 1) / AG : 0;   // passes
  static constexpr int NGA = AP >= 32 ? AG : FWARPS;      // u partials a rank
  // after the K-loop the ring holds each warp's partial of x·W, the
  // partials of u and the rows' u⊙em
  static constexpr int LOCAL_FLOATS = FWARPS * MP * BN + NGA * MP * AP + MP * RMAX;
  static_assert(WQ * 4 * FTHREADS == W_FLOATS, "a stage of W is two quads a thread");
  // ahead of the ring, the owned columns' B rows of every stacked adapter
  // and e⊙mask; then what the peers push here: every split's u of each
  // row's adapter and partial of the owned columns
  // (kernels/bea_batched.py:f32_smem_bytes)
  __host__ __device__ static int pre_floats(int splits) {
    return align4(AP * (cdiv(BN, splits) + 1));
  }
  __host__ __device__ static int rec_floats(int splits, int r) {
    return align4(splits * MP * (r + cdiv(BN, splits)));
  }
  static int smem(int stages, int splits, int r) {
    const int ring = STAGE_FLOATS * stages;
    return 4 * (pre_floats(splits) + rec_floats(splits, r) +
                (ring > LOCAL_FLOATS ? ring : LOCAL_FLOATS));
  }
  static int most_smem() {             // over every cluster size and rank
    int most = 0;
    for (int s = 1; s <= MAX_CLUSTER; ++s)
      most = smem(STAGES, s, RMAX) > most ? smem(STAGES, s, RMAX) : most;
    return most;
  }
};

template <int MP, int UT, int BN>
__global__ void __launch_bounds__(FTHREADS, 2)
fma_kernel(const FArgs p, bool aligned) {
  using T = FTile<MP, UT, BN>;
  const float* __restrict__ x = p.x;
  const float* __restrict__ w = p.w;
  const float* __restrict__ a = p.a;
  const float* __restrict__ b = p.b;
  const int K = p.K, N = p.N, G = p.G, r = p.r;
  extern __shared__ __align__(16) float fsm[];
  const int split = blockIdx.x, splits = gridDim.x;   // cluster rank, size
  const int cols = cdiv(BN, splits), c0 = split * cols;
  const int owned = max(0, min(BN, c0 + cols) - c0);  // columns stored here
  float* bsm = fsm;                                   // G × cols × r
  float* emsm = bsm + T::AP * cols;                   // G·r
  float* ru = fsm + T::pre_floats(splits);            // splits × MP × r
  float* ry = ru + splits * MP * r;                   // splits × MP × cols
  float* ring = ru + T::rec_floats(splits, r);
  __shared__ int gs[MP];
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * MP;
  const int rows = min(MP, p.M - m0);
  const int kb = split * p.kslice, ke = min(K, kb + p.kslice);
  const int nk = ke > kb ? cdiv(ke - kb, T::BK) : 0;
  const int gr = G * r;
  cluster_arrive_relaxed();             // started: peers may push

  // each row's adapter and a staged stack's e and mask: loaded now and
  // first used after the K-loop, so that no warp waits on them before its
  // copies are issued
  const int g_row = tid < MP && tid < rows ? p.idx[m0 + tid] : -1;
  float e_rank = 0.f;
  uint8_t m_rank = 0;
  if (UT > 0 && tid < gr) {
    e_rank = p.e[tid];
    m_rank = p.mask[tid];
  }

  // one stage: W (BK × BN), x (rows × BK, stored K-major) and the stacked
  // A (G·r × BK); the values past a ragged edge of K or N are zero-filled.
  // The rows of x past M and of the stack past G·r are not loaded: they
  // only reach sums that are never read.
  auto load_stage = [&](int slot, int step) {
    float* ws = ring + slot * T::STAGE_FLOATS;
    float* xs = ws + T::W_FLOATS;
    float* as = xs + T::X_FLOATS;
    const int k0 = kb + step * T::BK, kv = min(T::BK, ke - k0);
#pragma unroll
    for (int q = 0; q < T::WQ; ++q) {
      const int c = q * FTHREADS + tid, row = c / T::QW, col = (c % T::QW) * 4;
      copy4f(ws + row * BN + col, w + (size_t)(k0 + row) * N + n0 + col,
             row < kv ? max(0, min(4, N - n0 - col)) : 0, aligned, w);
    }
#pragma unroll 1
    for (int c = tid; c < rows * T::BK; c += FTHREADS) {
      const int m = c / T::BK, kk = c % T::BK;
      cp_async4(xs + kk * MP + m, kk < kv ? x + (size_t)(m0 + m) * K + k0 + kk : x,
                kk < kv ? 4 : 0);
    }
    if constexpr (UT > 0) {
#pragma unroll 1
      for (int c = tid; c < gr * (T::BK / 4); c += FTHREADS) {
        const int row = c / (T::BK / 4), col = (c % (T::BK / 4)) * 4;
        copy4f(as + row * T::LDA + col, a + (size_t)row * K + k0 + col,
               max(0, min(4, kv - col)), aligned, a);
      }
    }
  };

  float acc[MP][4], uacc[MP];
#pragma unroll
  for (int m = 0; m < MP; ++m) {
    uacc[m] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
  }
#pragma unroll 1
  for (int s = 0; s < T::STAGES; ++s) {
    if (s < nk) load_stage(s, s);
    if (UT > 0 && s == 0) {
      // with stage 0: every stacked adapter's B rows of the owned columns,
      // one run of live·r values each
      const int live = max(0, min(owned, N - n0 - c0)) * r, run = cols * r;
#pragma unroll 1
      for (int c = tid; c < G * live; c += FTHREADS)
        cp_async4(bsm + (c / live) * run + c % live,
                  b + ((size_t)(c / live) * N + n0 + c0) * r + c % live, 4);
    }
    tc::cp_async_commit();
  }
  // every slot of the ring is in flight from the start; a slot is refilled
  // once consumed.  A thread owns column quad qw of W (K-rows tid / QW,
  // + FTHREADS / QW) and stacked rank ar (4-row K-groups tid / AP, + AG).
  const int qw = tid % T::QW, ar = tid % (UT > 0 ? T::AP : 1);
  for (int i = 0; i < nk; ++i) {
    tc::cp_async_wait<T::STAGES - 1>();
    __syncthreads();                    // stage i landed
    const float* ws = ring + (i % T::STAGES) * T::STAGE_FLOATS;
    const float* xs = ws + T::W_FLOATS;
    const float* as = xs + T::X_FLOATS;
#pragma unroll
    for (int q = 0; q < T::WQ; ++q) {
      const int kk = tid / T::QW + q * (FTHREADS / T::QW);
      const float4 wv = *reinterpret_cast<const float4*>(ws + kk * BN + qw * 4);
      float xv[MP];
      load_x<MP>(xv, xs + kk * MP);
#pragma unroll
      for (int m = 0; m < MP; ++m) {
        acc[m][0] = fmaf(xv[m], wv.x, acc[m][0]);
        acc[m][1] = fmaf(xv[m], wv.y, acc[m][1]);
        acc[m][2] = fmaf(xv[m], wv.z, acc[m][2]);
        acc[m][3] = fmaf(xv[m], wv.w, acc[m][3]);
      }
    }
    if constexpr (UT > 0) {
#pragma unroll
      for (int q = 0; q < T::AQ; ++q) {
        const int kq = tid / T::AP + q * T::AG;
        if (kq < T::BK / 4) {
          const float4 av = *reinterpret_cast<const float4*>(as + ar * T::LDA + kq * 4);
          const float ak[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            float xv[MP];
            load_x<MP>(xv, xs + (kq * 4 + t) * MP);
#pragma unroll
            for (int m = 0; m < MP; ++m) uacc[m] = fmaf(xv[m], ak[t], uacc[m]);
          }
        }
      }
    }
    const int nxt = i + T::STAGES;
    if (nxt < nk) {
      __syncthreads();                  // every warp is done with slot i
      load_stage(i % T::STAGES, nxt);
    }
    tc::cp_async_commit();
  }
  if (tid < MP) gs[tid] = (g_row >= 0 && g_row < G) ? g_row : -1;
  tc::cp_async_wait<0>();
  __syncthreads();                      // the ring is free

  // the lanes of a warp that share a column quad (or a stacked rank) are
  // summed by a butterfly, which leaves the same bits on every lane; then
  // each warp's (or group's) sums go to the ring, to be added in order
  float* red = ring;                                  // FWARPS × MP × BN
  float* ured = red + FWARPS * MP * BN;               // NGA × MP × AP
  float* tsel = ured + T::NGA * MP * T::AP;           // MP × RMAX
#pragma unroll
  for (int off = T::QW; off < 32; off <<= 1)
#pragma unroll
    for (int m = 0; m < MP; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], off);
  if (lane < T::QW) {
#pragma unroll
    for (int m = 0; m < MP; ++m)
      *reinterpret_cast<float4*>(red + (warp * MP + m) * BN + qw * 4) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
  if constexpr (UT > 0) {
    if constexpr (T::AP < 32) {
#pragma unroll
      for (int off = T::AP; off < 32; off <<= 1)
#pragma unroll
        for (int m = 0; m < MP; ++m) uacc[m] += __shfl_xor_sync(0xffffffffu, uacc[m], off);
    }
    if (T::AP >= 32 || lane < T::AP) {
      const int grp = T::AP >= 32 ? tid / T::AP : warp;
#pragma unroll
      for (int m = 0; m < MP; ++m) ured[(grp * MP + m) * T::AP + ar] = uacc[m];
    }
    if (tid < gr) emsm[tid] = e_rank * (m_rank ? 1.f : 0.f);
  }
  __syncthreads();
  cluster_wait();                       // every peer can take pushes

  // this split's u of each row's adapter, to every block of the cluster
  if constexpr (UT > 0) {
#pragma unroll 1
    for (int q = tid; q < rows * r; q += FTHREADS) {
      const int m = q / r, j = q % r, g = gs[m];
      float v = 0.f;
      if (g >= 0) {
#pragma unroll
        for (int t = 0; t < T::NGA; ++t) v += ured[(t * MP + m) * T::AP + g * r + j];
      }
#pragma unroll
      for (int o = 0; o < MAX_CLUSTER; ++o)
        if (o < splits) cluster.map_shared_rank(ru, o)[(split * MP + m) * r + j] = v;
    }
  } else {
    // a stack too large to stage: each row's own adapter, gathered, over
    // the block's K-slice
    for (int q = warp; q < rows * r; q += FWARPS) {
      const int m = q / r, j = q % r, g = gs[m];
      float v = 0.f;
      if (g >= 0) {
        const float* arow = a + ((size_t)g * r + j) * K;
        const float* xrow = x + (size_t)(m0 + m) * K;
        for (int k = kb + lane; k < ke; k += 32) v = fmaf(xrow[k], arow[k], v);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane < splits) cluster.map_shared_rank(ru, lane)[(split * MP + m) * r + j] = v;
    }
  }
  // this split's partial of x·W, each column to the block that owns it
#pragma unroll 1
  for (int q = tid; q < rows * BN; q += FTHREADS) {
    const int m = q / BN, c = q % BN, o = c / cols;
    float y = 0.f;
#pragma unroll
    for (int t = 0; t < FWARPS; ++t) y += red[(t * MP + m) * BN + c];
    cluster.map_shared_rank(ry, o)[(split * MP + m) * cols + c - o * cols] = y;
  }
  cluster.sync();                       // every push has landed

  // the splits are summed in split order, all from this block's memory
  for (int q = tid; q < rows * r; q += FTHREADS) {
    const int m = q / r, j = q % r, g = gs[m];
    float v = 0.f;
    if (g >= 0) {
#pragma unroll
      for (int s = 0; s < MAX_CLUSTER; ++s)
        if (s < splits) v += ru[(s * MP + m) * r + j];
      v *= UT > 0 ? emsm[g * r + j] : p.e[g * r + j] * (p.mask[g * r + j] ? 1.f : 0.f);
    }
    tsel[m * RMAX + j] = v;
  }
  __syncthreads();
#pragma unroll 1
  for (int q = tid; q < rows * owned; q += FTHREADS) {
    const int m = q / owned, c = q % owned, n = n0 + c0 + c;
    if (n >= N) continue;
    float y = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_CLUSTER; ++s)
      if (s < splits) y += ry[(s * MP + m) * cols + c];
    const int g = gs[m];
    float d = 0.f;
    if (g >= 0) {
      if constexpr (UT > 0) {
        const float* br = bsm + (g * cols + c) * r;
#pragma unroll 8
        for (int j = 0; j < r; ++j) d = fmaf(tsel[m * RMAX + j], br[j], d);
      } else {
        const float* br = b + ((size_t)g * N + n) * r;
        for (int j = 0; j < r; ++j) d = fmaf(tsel[m * RMAX + j], br[j], d);
      }
    }
    p.out[(size_t)(m0 + m) * N + n] = fmaf(p.scaling, d, y);
  }
}

template <int MP, int UT, int BN>
int launch_fma(const FArgs& p, cudaStream_t stream) {
  using T = FTile<MP, UT, BN>;
  cudaError_t err = tc::ensure_smem_limit<fma_kernel<MP, UT, BN>>(T::most_smem());
  if (err != cudaSuccess) return static_cast<int>(err);
  const int steps = p.kslice / T::BK;
  const bool aligned = p.K % 4 == 0 && p.N % 4 == 0 && tc::aligned16(p.w) &&
                       tc::aligned16(p.a);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, cdiv(p.N, BN), cdiv(p.M, MP));
  cfg.blockDim = dim3(FTHREADS);
  cfg.dynamicSmemBytes = T::smem(steps < T::STAGES ? steps : T::STAGES, p.splits, p.r);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fma_kernel<MP, UT, BN>, p, aligned);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int MP, int UT>
int launch_fma_bn(int block_n, const FArgs& p, cudaStream_t s) {
  if (block_n == 64) return launch_fma<MP, UT, 64>(p, s);
  if (block_n == 32) return launch_fma<MP, UT, 32>(p, s);
  return launch_fma<MP, UT, 16>(p, s);
}

template <int MP>
int launch_fma_ut(int block_n, const FArgs& p, cudaStream_t s) {
  const int gr = p.G * p.r;
  if (gr > MAX_STACKED) return launch_fma_bn<MP, 0>(block_n, p, s);
  if (gr <= 16) return launch_fma_bn<MP, 1>(block_n, p, s);
  return launch_fma_bn<MP, 4>(block_n, p, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, a, b and out share it); e is
// float32 (G, r), mask bool (G, r), idx int32 (M,).  Each instance takes
// its plan from the caller: column tiles of block_n ∈ {64, 32, 16} and
// `splits` ≤ 8 K-slices of k_slice rows each, none of them empty, the
// splits of a tile one cluster; k_slice is a multiple of 64 for bfloat16
// (kernels/bea_batched.py:plan) and of 2048 / block_n for float32
// (kernels/bea_batched.py:f32_plan).  Neither needs a workspace.  Returns
// cudaGetLastError().
extern "C" int bea_batched_launch(const void* x, const void* w, const void* a,
                                  const void* b, const void* e,
                                  const void* mask, const void* idx, void* out,
                                  int M, int K, int N, int G, int r,
                                  float scaling, int dtype, int block_n,
                                  int splits, int k_slice, void* stream) {
  if (M < 0 || K < 0 || N < 0 || G < 1 || r < 1 || r > RMAX || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const bool covers = (long long)splits * k_slice >= K &&
                      (long long)(splits - 1) * k_slice < (K > 0 ? K : 1);
  const bool tiled = covers && splits <= MAX_CLUSTER &&
                     (block_n == 64 || block_n == 32 || block_n == 16) &&
                     cdiv(N, block_n) <= 65535;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int bk = tiled ? 2048 / block_n : 0;
    if (!tiled || k_slice < bk || k_slice % bk != 0 || cdiv(M, F_MAX_ROWS) > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    const FArgs p{static_cast<const float*>(x), static_cast<const float*>(w),
                  static_cast<const float*>(a), static_cast<const float*>(b),
                  static_cast<const float*>(e), static_cast<const uint8_t*>(mask),
                  static_cast<const int32_t*>(idx), static_cast<float*>(out),
                  M, K, N, G, r, scaling, splits, k_slice};
    return M <= 4 ? launch_fma_ut<4>(block_n, p, s) : launch_fma_ut<F_MAX_ROWS>(block_n, p, s);
  }
  if (dtype != 1 || !tiled || k_slice < BK || k_slice % BK != 0 ||
      cdiv(M, MTILE) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 8)
    return launch_mma_ut<8>(block_n, x, w, a, b, e, mask, idx, out, M, K, N, G, r, scaling, splits, k_slice, s);
  return launch_mma_ut<MTILE>(block_n, x, w, a, b, e, mask, idx, out, M, K, N, G, r, scaling, splits, k_slice, s);
}
