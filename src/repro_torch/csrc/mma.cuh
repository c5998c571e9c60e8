// PTX wrappers shared by the tensor-core kernels (sm_90a): 16-byte cp.async
// copies with zero fill, ldmatrix loads of 8×8 b16 matrices from shared
// memory, the m16n8k16 bf16 and m16n8k8 tf32 mma.sync with f32
// accumulators, the 3xTF32 split of f32 operands, and the one-time dynamic
// shared-memory limit of a kernel instance.
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
//
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 (32-bit elements):
//   A (16×8):  a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4];
//   B (8×8):   b0 = B[t][g], b1 = B[t+4][g];   C as above.
// An 8×8 b16 matrix is 8 rows × 4 floats, so ldmatrix (not .trans) on f32
// data hands lane l float l%4 of row l/4: .x4 over a 16×8 f32 tile (rows
// 0-7 | 8-15 × floats 0-3 | 4-7) is exactly an A fragment, and .x2 over
// 8 rows of an n-major tile (n rows, k contiguous) a B fragment.
// .trans cannot transpose 32-bit elements: B fragments of a k-major f32
// tile come from scalar shared loads.
//
// 3xTF32: TF32 keeps 10 of f32's 23 mantissa bits, too few for a 1e-4
// tolerance on a 768-long dot product.  Each f32 operand v is split into
// big = tf32(v) and small = tf32(v − big), and a·b ≈ a_s·b_b + a_b·b_s +
// a_b·b_b (a_s·b_s, about 2^-22 of the product, is dropped): three MMAs
// give f32 accuracy at a third of the TF32 rate.  Each fragment is split
// once per k-step, not once per MMA.

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

// 16 bytes of T (eight bf16 or four f32 values) from `src` to shared `dst`,
// the first `valid` of them real and the rest zero.  With `aligned`
// (16-byte aligned addresses) it is one cp.async; otherwise plain loads and
// stores, for ragged rows whose starts are not 16-byte aligned.  `dummy` is
// any valid global address, used when nothing is read.
template <typename T>
__device__ __forceinline__ void copy16(T* dst, const T* src, int valid,
                                       bool aligned, const T* dummy) {
  constexpr int E = 16 / sizeof(T);
  if (aligned) {
    cp_async16(dst, valid > 0 ? src : dummy,
               valid > 0 ? static_cast<int>(sizeof(T)) * valid : 0);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) dst[i] = i < valid ? src[i] : static_cast<T>(0.f);
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

// big = v rounded to TF32 (to nearest, ties away from zero: add half a
// TF32 ulp to the bits and clear the 13 bits TF32 drops), small = v − big
// (exact in f32) truncated to TF32: CUTLASS's fast 3xTF32 split, four ALU
// instructions.  cvt.rna.tf32.f32 rounds big the same way but compiles to a
// longer sequence on sm_90 (NaN and overflow checks), and the splits are
// most of the kernels' non-MMA instructions.  Nothing reassociates f32
// arithmetic here (no fast-math), so v − big is computed as written.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big)) & 0xffffe000u;
}

// the big and small parts of N f32 values held as raw bits (a fragment)
template <int N>
__device__ __forceinline__ void split_frag(const uint32_t (&v)[N], uint32_t (&big)[N],
                                           uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(__uint_as_float(v[i]), big[i], small[i]);
}

// c += a·b on the tensor cores: (16×8 tf32)·(8×8 tf32) → 16×8 f32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a·b to f32 accuracy from split operands: small·big, big·small, then
// big·big (CUTLASS's order: the small terms are added before the big one
// can swamp them), summed in a fresh accumulator that is then added to c
// on the CUDA cores.  The tensor cores' own accumulation truncates: fed c
// directly, every MMA shrank |c| by up to an ulp, a bias that grows with
// K (−1.9e-5 relative over K = 3072, where f32 FMAs give 1e-9); added
// here, c is rounded to nearest once per k-step.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(p, a_small, b_big);
  mma_tf32(p, a_big, b_small);
  mma_tf32(p, a_big, b_big);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += p[i];
}

// c += a·b as above, the three MMAs fed c itself: for a sum that starts
// at zero and stays a few k-steps long (a head-dim dot product), where the
// truncation's bias is bounded by those few steps and the fresh
// accumulator's registers are better spent elsewhere
__device__ __forceinline__ void mma_3xtf32_short(float (&c)[4],
                                                 const uint32_t (&a_big)[4],
                                                 const uint32_t (&a_small)[4],
                                                 const uint32_t (&b_big)[2],
                                                 const uint32_t (&b_small)[2]) {
  mma_tf32(c, a_small, b_big);
  mma_tf32(c, a_big, b_small);
  mma_tf32(c, a_big, b_big);
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
