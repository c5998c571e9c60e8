// Rank-bucketed multi-tenant masked-BEA linear for Hopper (sm_90a):
//
//     y[i] = x[i]·W + s·((x[i]·A_gᵀ) ⊙ (e_g⊙m_g))·B_gᵀ,   g = idx[i]
//
// Replaces the Pallas TPU kernel repro/kernels/bea_batched.py:_kernel
// (through _bea_batched_call, bea_batched and the
// repro/kernels/ops.py:adapted_dense_multi dispatch).
//
// What bounds it on an H100: at decode a bucket group has M ≤ 8 rows, so
// the call does 2·M flops per weight element and is bound by reading W once
// from HBM (3.35 TB/s); at the path's shapes that is 0.1–2.6 µs per call,
// so launch latency is the other half of the bill.
//
// Design: all rows of a call share one M-tile (up to MT = 8 rows), so each
// W element crosses HBM once per launch, not once per row.  To keep enough
// loads in flight for a matrix as small as 896×128, K is split across
// blocks as well as N: the grid is (N/64 column tiles) × (K splits), sized
// to at least two blocks per SM.  In a block, each of 8 warps streams
// every 8th W row of the block's K-range, a lane reading two neighbouring
// columns (a warp reads 128 contiguous bytes of a bf16 row) and multiplying
// them against all M rows of x staged in shared memory; the warps' sums
// meet in shared memory and each split writes its f32 partial tile to a
// workspace the wrapper provides.  The blocks of the first column tile also
// gather each row's adapter through idx (the SGMV style, instead of the TPU
// kernel's one-hot over a widened rank accumulator) and write partial
// u[m][j] = x[m]·A_{g_m}[j] for their K-range.  A second, small kernel sums
// the splits, scales u by e⊙mask in f32 and adds s·u·B_gᵀ before the one
// store.  Every row's arithmetic is the same whatever the other rows are,
// so a batched row equals the row served alone.  Rows whose idx lies
// outside [0, G) get no adapter, as the TPU kernel's one-hot gives.  Ragged
// M, N, K and r are masked; G = 0 or r = 0 never reaches the kernel (the
// wrapper short-circuits to x·W as the JAX wrapper does).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MT = 8;              // rows per M-tile
constexpr int BN = 64;             // columns per partial block, 2 per lane
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int KMAX = 512;          // most K rows one split stages
constexpr int TARGET_BLOCKS = 264; // two per SM on 132 SMs
constexpr int EBN = THREADS / MT;  // columns per epilogue block
constexpr int RMAX = 64;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// two neighbouring elements p[0], p[1]; p is 2-element aligned
template <typename T> __device__ __forceinline__ void load2(const T* p, float& a, float& b);
template <> __device__ __forceinline__ void load2<float>(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
template <> __device__ __forceinline__ void load2<__nv_bfloat16>(const __nv_bfloat16* p,
                                                                float& a, float& b) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = v.x;
  b = v.y;
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

struct Plan {
  int splits;   // K splits
  int krange;   // K rows per split, a multiple of WARPS, ≤ KMAX
};

Plan plan(int K, int N) {
  const int tiles = cdiv(N, BN);
  int s = cdiv(K, KMAX);
  s = s > cdiv(TARGET_BLOCKS, tiles) ? s : cdiv(TARGET_BLOCKS, tiles);
  const int most = cdiv(K, WARPS);
  s = s < most ? s : most;
  s = s > 1 ? s : 1;
  const int kr = cdiv(cdiv(K > 0 ? K : 1, s), WARPS) * WARPS;
  return {cdiv(K > 0 ? K : 1, kr), kr};
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
partial_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ a, const int32_t* __restrict__ idx,
               float* __restrict__ part, float* __restrict__ upart, int M,
               int K, int N, int G, int r, int krange, bool w_aligned) {
  __shared__ float xs[MT][KMAX];
  __shared__ float red[WARPS][MT][BN];
  __shared__ int gs[MT];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tile = blockIdx.x, split = blockIdx.y, m0 = blockIdx.z * MT;
  const int rows = min(MT, M - m0);
  const int k0 = split * krange;
  const int klen = max(0, min(K, k0 + krange) - k0);

  for (int i = tid; i < MT * krange; i += THREADS) {
    const int m = i / krange, kk = i % krange;
    xs[m][kk] = (m < rows && kk < klen) ? to_f(x[(size_t)(m0 + m) * K + k0 + kk]) : 0.f;
  }
  if (tid < MT) {
    const int g = (tid < rows) ? idx[m0 + tid] : -1;
    gs[tid] = (g >= 0 && g < G) ? g : -1;
  }
  __syncthreads();

  // x·W over this split: warp `warp` takes rows warp, warp + 8, …
  const int n = tile * BN + 2 * lane;
  const bool pair = w_aligned && (n + 1 < N) && ((N & 1) == 0);
  float acc[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m][0] = acc[m][1] = 0.f;
#pragma unroll 4
  for (int kk = warp; kk < klen; kk += WARPS) {
    const T* wr = w + (size_t)(k0 + kk) * N;
    float w0 = 0.f, w1 = 0.f;
    if (pair) {
      load2(wr + n, w0, w1);
    } else {
      if (n < N) w0 = to_f(wr[n]);
      if (n + 1 < N) w1 = to_f(wr[n + 1]);
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
  for (int e = tid; e < MT * BN; e += THREADS) {
    const int m = e / BN, c = e % BN, gn = tile * BN + c;
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
        const T* ar = a + ((size_t)g * r + j) * K + k0;
        for (int kk = lane; kk < klen; kk += 32) v = fmaf(xs[m][kk], to_f(ar[kk]), v);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) upart[((size_t)split * M + m0 + m) * r + j] = v;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
epilogue_kernel(const float* __restrict__ part, const float* __restrict__ upart,
                const T* __restrict__ b, const float* __restrict__ e,
                const uint8_t* __restrict__ mask, const int32_t* __restrict__ idx,
                T* __restrict__ out, int M, int N, int G, int r, int splits,
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
  for (int i = tid; i < MT * r; i += THREADS) {
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
      const T* br = b + ((size_t)g * N + gn) * r;
      for (int j = 0; j < r; ++j) d = fmaf(us[m][j], to_f(br[j]), d);
    }
    out[(size_t)(m0 + m) * N + gn] = from_f<T>(y + scaling * d);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* a, const void* b,
           const void* e, const void* mask, const void* idx, void* out,
           void* workspace, int M, int K, int N, int G, int r, float scaling,
           cudaStream_t stream) {
  const Plan p = plan(K, N);
  float* part = static_cast<float*>(workspace);
  float* upart = part + (size_t)p.splits * M * N;
  const int mtiles = cdiv(M, MT);
  partial_kernel<T><<<dim3(cdiv(N, BN), p.splits, mtiles), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(a), static_cast<const int32_t*>(idx), part, upart,
      M, K, N, G, r, p.krange,
      reinterpret_cast<uintptr_t>(w) % (2 * sizeof(T)) == 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  epilogue_kernel<T><<<dim3(cdiv(N, EBN), mtiles), THREADS, 0, stream>>>(
      part, upart, static_cast<const T*>(b), static_cast<const float*>(e),
      static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(idx),
      static_cast<T*>(out), M, N, G, r, p.splits, scaling);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 workspace bytes a call of this shape needs: per K split, the (M, N)
// partial products and the (M, r) partial rank accumulators.
extern "C" long long bea_batched_workspace_bytes(int M, int K, int N, int r) {
  const Plan p = plan(K, N);
  return 4LL * p.splits * M * ((long long)N + r);
}

// dtype: 0 = float32, 1 = bfloat16 (x, w, a, b and out share it); e is
// float32 (G, r), mask bool (G, r), idx int32 (M,); workspace holds at
// least bea_batched_workspace_bytes(M, K, N, r).  Returns
// cudaGetLastError().
extern "C" int bea_batched_launch(const void* x, const void* w, const void* a,
                                  const void* b, const void* e,
                                  const void* mask, const void* idx, void* out,
                                  void* workspace, long long workspace_bytes,
                                  int M, int K, int N, int G, int r,
                                  float scaling, int dtype, void* stream) {
  if (M < 0 || K < 0 || N < 0 || G < 1 || r < 1 || r > RMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  if (workspace_bytes < bea_batched_workspace_bytes(M, K, N, r))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, a, b, e, mask, idx, out, workspace, M, K, N, G, r, scaling, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, a, b, e, mask, idx, out, workspace, M, K, N, G, r, scaling, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
