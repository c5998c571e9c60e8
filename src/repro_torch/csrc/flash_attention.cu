// Flash attention forward for Hopper (sm_90a): online softmax with f32
// running max, denominator and accumulator; causal, sliding window, tanh
// soft-capping and GQA (kv head = h / group, read by index, never repeated).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:_kernel
// (through flash_attention and mha_flash).
//
// What bounds it on an H100: at the serving path's prefill (one sequence of
// 64..128 tokens, 14 query heads over 2 kv heads of 64) the work is tiny and
// the grid is 14..28 blocks, so latency and occupancy bound it rather than
// bytes or tensor-core flops.  Design: one 128-thread block per (64 query
// rows, head, batch); the block sweeps 64-key tiles of K and V staged in
// shared memory as f32.  Two threads share a query row: each scores half of
// the tile's keys, the pair combines its row max and sum with one shuffle,
// and each keeps half of the row's f32 output accumulator in registers.
// Scores never leave shared memory.  Tiles wholly in the causal future or
// wholly behind the window are never visited; ragged Sq and Sk tails are
// masked in the loads, the scores and the store, so any length works.
// Masked scores take NEG_INF = -2.3819763e38 and contribute exactly zero.
// The output is acc / max(l, 1e-30).  Tensor cores (wgmma), TMA and larger
// tiles for long prompts are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 128;
constexpr float NEG_INF = -2.3819763e38f;

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

struct Strides {  // element strides of a (B, heads, S, hd) view, hd contiguous
  long long b, h, s;
};

template <int HD>
constexpr int smem_floats() {
  return BQ * (HD + 1) + BKV * (HD + 1) + BKV * HD + BQ * (BKV + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
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
  const T* qp = q + bb * qs.b + h * qs.h;
  const T* kp = k + bb * ks.b + hk * ks.h;
  const T* vp = v + bb * vs.b + hk * vs.h;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int rr = i / HD, d = i % HD;
    Qs[rr * (HD + 1) + d] = (q0 + rr < Sq) ? to_f(qp[(q0 + rr) * qs.s + d]) : 0.f;
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
      Ks[rr * (HD + 1) + d] = in ? to_f(kp[kr * ks.s + d]) : 0.f;
      Vs[rr * HD + d] = in ? to_f(vp[kr * vs.s + d]) : 0.f;
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
    T* orow = o + bb * os.b + h * os.h + qpos * os.s + half * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) orow[d] = from_f<T>(acc[d] * inv);
  }
}

constexpr int MAX_DEVICES = 64;

// Raises the kernel instance's dynamic shared-memory limit once per device,
// not on every launch (the attribute persists for the process).
template <typename T, int HD>
cudaError_t ensure_smem_limit(int smem) {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os,
           int group, float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  const int smem = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = ensure_smem_limit<T, HD>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, qs, ks, vs, os,
      group, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int B, int H, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
              Strides os, int group, float scale, int causal, int window,
              float softcap, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, group, scale, causal, window, softcap, s);
    case 32: return launch<T, 32>(q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, group, scale, causal, window, softcap, s);
    case 64: return launch<T, 64>(q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, group, scale, causal, window, softcap, s);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, group, scale, causal, window, softcap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B, H, Sq, hd) and o likewise, k/v: (B, H / group, Sk, hd), each given
// by its element strides (batch, head, seq) with hd contiguous; dtype 0 =
// float32, 1 = bfloat16.  Returns cudaGetLastError() (or the attribute
// call's error).
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, group, scale, causal, window, softcap, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, group, scale, causal, window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
