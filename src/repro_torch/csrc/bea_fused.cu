// Fused masked-BEA adapted linear for Hopper (sm_90a):
//
//     y = x·W + s·((x·Aᵀ) ⊙ (e⊙m))·Bᵀ
//
// Replaces the Pallas TPU kernel repro/kernels/bea_fused.py:_kernel (through
// bea_dense and the repro/kernels/ops.py:adapted_dense dispatch).
//
// What bounds it on an H100: at the serving path's prefill shapes (M = a
// 64..128-token chunk, K×N up to 896×4864 and 4864×896) the product does
// 2·M flops per weight byte pair, far below the ~295 flop/byte ridge of the
// bf16 tensor cores, so the floor is reading W once from HBM.  This first
// version is a plain SIMT kernel on the CUDA cores (f32 FMAs), and what
// bounds it first is its grid: at M = 128 the 64×64 tiles give 4 blocks
// for an N = 128 linear and 28 for N = 896 on 132 SMs, each block walking
// all of K (4864 for w2), so most SMs sit idle.  Split-K and smaller
// tiles for small M come next, then the tensor cores (wgmma), TMA loads
// and a persistent schedule.
//
// Design: one 256-thread block per 64×64 output tile, looping over K in
// 16-wide shared-memory tiles of x, W and A (converted to f32 on load).  Each
// thread keeps a 4×4 f32 tile of x·W and R/4 entries of the block's rank
// accumulator u = x·Aᵀ (64 × R, R ∈ {16, 32, 64} ≥ r) in registers, so the
// adapter costs no extra pass over x.  The epilogue multiplies u by
// em = e⊙mask in f32, applies (u⊙em)·Bᵀ once from shared memory and writes
// the tile once.  Every N-tile recomputes its rows' u, which costs R/64 of
// the main product's work — acceptable at serving ranks (4..8, R = 16).
// Ragged M, N, K and r are masked in the loads and the store; the kernel
// launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;

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

template <typename T, int R>
__global__ void __launch_bounds__(THREADS)
bea_dense_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ a, const T* __restrict__ b,
                 const float* __restrict__ e, const uint8_t* __restrict__ mask,
                 T* __restrict__ out, int M, int K, int N, int r, float scaling) {
  __shared__ float xs[BK][BM + 4];
  __shared__ float ws[BK][BN];
  __shared__ float as[BK][R];
  __shared__ float us[BM][R + 1];
  __shared__ float bs[R][BN];

  constexpr int RU = R / 4;             // ranks of u owned by one thread
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int um = tid % BM, ug = tid / BM;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float u[RU];
#pragma unroll
  for (int j = 0; j < RU; ++j) u[j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int m = i / BK, k = i % BK, gm = m0 + m, gk = k0 + k;
      xs[k][m] = (gm < M && gk < K) ? to_f(x[(size_t)gm * K + gk]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int k = i / BN, n = i % BN, gk = k0 + k, gn = n0 + n;
      ws[k][n] = (gk < K && gn < N) ? to_f(w[(size_t)gk * N + gn]) : 0.f;
    }
    for (int i = tid; i < R * BK; i += THREADS) {
      const int j = i / BK, k = i % BK, gk = k0 + k;
      as[k][j] = (j < r && gk < K) ? to_f(a[(size_t)j * K + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
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
  for (int i = tid; i < R * BN; i += THREADS) {
    const int n = i / R, j = i % R, gn = n0 + n;
    bs[j][n] = (j < r && gn < N) ? to_f(b[(size_t)gn * r + j]) : 0.f;
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
      if (gm < M && gn < N)
        out[(size_t)gm * N + gn] = from_f<T>(acc[i][j] + scaling * d);
    }
  }
}

template <typename T, int R>
int launch(const void* x, const void* w, const void* a, const void* b,
           const void* e, const void* mask, void* out, int M, int K, int N,
           int r, float scaling, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  bea_dense_kernel<T, R><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(e), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), M, K, N, r, scaling);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rank(const void* x, const void* w, const void* a, const void* b,
                const void* e, const void* mask, void* out, int M, int K,
                int N, int r, float scaling, cudaStream_t stream) {
  if (r <= 16) return launch<T, 16>(x, w, a, b, e, mask, out, M, K, N, r, scaling, stream);
  if (r <= 32) return launch<T, 32>(x, w, a, b, e, mask, out, M, K, N, r, scaling, stream);
  return launch<T, 64>(x, w, a, b, e, mask, out, M, K, N, r, scaling, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, a, b and out share it); e is
// float32 and mask is bool (one byte each).  Returns cudaGetLastError().
extern "C" int bea_dense_launch(const void* x, const void* w, const void* a,
                                const void* b, const void* e, const void* mask,
                                void* out, int M, int K, int N, int r,
                                float scaling, int dtype, void* stream) {
  if (M < 0 || K < 0 || N < 0 || r < 0 || r > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_rank<float>(x, w, a, b, e, mask, out, M, K, N, r, scaling, s);
  if (dtype == 1)
    return launch_rank<__nv_bfloat16>(x, w, a, b, e, mask, out, M, K, N, r, scaling, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
