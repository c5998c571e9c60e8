// PTX wrappers shared by the tensor-core kernels (sm_90a): 16-byte cp.async
// copies with zero fill, ldmatrix loads of 8×8 bf16 matrices from shared
// memory, the m16n8k16 bf16 mma.sync with f32 accumulators, and the one-time
// dynamic shared-memory limit of a kernel instance.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (lane = 4·g + t, g = 0..7,
// t = 0..3), as the kernels index them:
//   A (16×16, row-major):  a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                          a2 = A[g][2t+8..+9],   a3 = A[g+8][2t+8..+9];
//   B (16×8, "col"):       b0 = B[2t..2t+1][g],   b1 = B[2t+8..+9][g];
//   C (16×8, f32):         c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1].
// ldmatrix hands lane l row l/4, elements 2(l%4)..+1 of each 8×8 matrix;
// with .trans it hands the transpose, which turns a tile stored k-major
// (rows = k, the B operand's n contiguous) into B fragments.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared; the bytes past `src_bytes` (0..16) are zeroed
// and not read.  Both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Eight bf16 values from `src` to shared `dst`, the first `valid` of them
// real and the rest zero.  With `aligned` (16-byte aligned addresses) it is
// one cp.async; otherwise plain loads and stores, for ragged rows whose
// starts are not 16-byte aligned.  `dummy` is any valid global address,
// used when nothing is read.
__device__ __forceinline__ void copy8(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, int valid,
                                      bool aligned,
                                      const __nv_bfloat16* dummy) {
  if (aligned) {
    cp_async16(dst, valid > 0 ? src : dummy, valid > 0 ? 2 * valid : 0);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      dst[i] = i < valid ? src[i] : __float2bfloat16(0.f);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// .x2 forms: lanes 0..15 give the row addresses (the rest are ignored)
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c += a·b on the tensor cores: (16×16 bf16)·(16×8 bf16) → 16×8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 and packed, `lo` in the low half (the lower
// column of an A fragment register)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr int MAX_DEVICES = 64;

// Raises a kernel instance's dynamic shared-memory limit once per device,
// not on every launch (the attribute persists for the process).
template <auto Kernel>
cudaError_t ensure_smem_limit(int bytes) {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace tc
