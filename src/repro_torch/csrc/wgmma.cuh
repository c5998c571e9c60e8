// PTX wrappers for Hopper's asynchronous path (sm_90a): TMA tile loads
// into shared memory that complete on an mbarrier (2-D and 4-D maps, built
// on the host by tma_map.cuh), and TMA stores, the mbarrier itself, the
// warpgroup matrix multiply (wgmma) on shared-memory descriptors, and the
// register handover between warpgroups (setmaxnreg).
//
// wgmma.mma_async m64nNk16 (bf16 in, f32 out) is run by a warpgroup of
// four warps.  Its f32 accumulator d[N/2] follows mma.sync's C layout per
// warp: warp w of the group holds rows 16w + g and 16w + g + 8 (lane =
// 4·g + t), d[4i + 0..1] at columns 8i + 2t..+1 of the first row and
// d[4i + 2..3] at the same columns of the second.  An A operand from
// registers (wgmma_rs) is mma.sync's m16n8k16 A fragment per warp, so an
// accumulator of 16 columns, rounded and packed in pairs, is one (flash
// attention's P·V feeds the probabilities of Q·Kᵀ back this way).
//
// A shared-memory operand is given by a 64-bit descriptor (make_desc): its
// start address, the leading and stride byte offsets and the swizzle.  The
// canonical layouts used here (CUTLASS's make_gmma_desc, in bytes):
//   K-major, 128-byte swizzle (a TMA box 64 bf16 wide): rows of 128 bytes,
//     8-row groups SBO = 1024 apart (LBO unused); a k16 step adds 32 bytes
//     to the start address;
//   MN-major, 128-byte swizzle (trans bit set): 64 MN-contiguous values per
//     128-byte row, one row per k; 8-k groups SBO = 1024 apart, 64-wide MN
//     chunks LBO apart (the box size); a k16 step adds 16 rows (2048 bytes);
//   K-major, no swizzle: 8 × 16-byte core matrices, LBO between the two
//     core matrices of a k16 step, SBO between 8-row groups.
// The 128-byte swizzled tiles must start on 1024-byte boundaries.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace tc {

enum Swizzle : uint64_t { kNone = 0, k128B = 1 };

__device__ __forceinline__ uint64_t make_desc(uint32_t smem_addr, uint32_t lbo,
                                              uint32_t sbo, Swizzle sw) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(sw) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups of this warp are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// generic-proxy shared stores made visible to the async proxy (wgmma, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// barrier `id` (1..15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- mbarrier --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// an arrival by the threads whose `pred` is set, without a branch (a branch
// around it would put divergent code between a wgmma and its wait)
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"(static_cast<int>(pred))
      : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// global stores under a predicate, without a branch (for the same reason)
__device__ __forceinline__ void st_global_if(void* p, uint32_t v, bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n@q st.global.b32 [%0], %1;\n}\n" ::"l"(p),
      "r"(v), "r"(static_cast<int>(pred))
      : "memory");
}

__device__ __forceinline__ void st_global_if(void* p, float x, float y, bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %3, 0;\n@q st.global.v2.f32 [%0], {%1, %2};\n}\n" ::"l"(p),
      "f"(x), "f"(y), "r"(static_cast<int>(pred))
      : "memory");
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed.  No timeout trap:
// a __trap() on this path made ptxas give the consumer warpgroups only the
// launch's 168 registers (setmaxnreg then no longer raised their budget),
// and the 256-column tile spilled.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ---------------------------------------------------------------------

// the box of a 2-D tensor map at (c0 innermost, c1) into shared `dst`; the
// bytes count toward `bar`'s transactions.  Out-of-range elements are zero.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// the same for a 4-D tensor map at (c0 innermost, c1, c2, c3)
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// the shared box at `src` into a 2-D tensor map's box at (c0, c1); rows and
// columns outside the tensor are not written.  Started by the threads whose
// `pred` is set, then committed as one bulk group.
__device__ __forceinline__ void tma_store_2d_if(const void* map, uint32_t src, int c0,
                                                int c1, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %4, 0;\n"
      "@p cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      "@p cp.async.bulk.commit_group;\n}\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(static_cast<int>(pred))
      : "memory");
}

// the same for a 4-D tensor map's box at (c0, c1, c2, c3)
__device__ __forceinline__ void tma_store_4d_if(const void* map, uint32_t src, int c0,
                                                int c1, int c2, int c3, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "@p cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      "@p cp.async.bulk.commit_group;\n}\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(static_cast<int>(pred))
      : "memory");
}

// wait (in the threads whose `pred` is set) until at most N of their bulk
// store groups still read shared memory
template <int N>
__device__ __forceinline__ void tma_store_wait_read_if(bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p cp.async.bulk.wait_group.read %0;\n}\n" ::"n"(N),
      "r"(static_cast<int>(pred))
      : "memory");
}

// ... until all of their bulk store groups are complete
__device__ __forceinline__ void tma_store_wait_all_if(bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
      "@p cp.async.bulk.wait_group 0;\n}\n" ::"r"(static_cast<int>(pred))
      : "memory");
}

// ---- wgmma -------------------------------------------------------------------
// d += A·B, m64nNk16: wgmma_ss takes A and B by descriptor, wgmma_rs takes
// A from registers (a k16 fragment) and B by descriptor; TB = 1: B is
// MN-major (the transpose bit).  scale_d = 0 ignores d's old value (d = A·B).
// The compiler does not know that d and A are in use until the group's
// wgmma_wait: fence_regs after the wait keeps it from reading d, or from
// reusing A's registers, any earlier.

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define TC_D8(i)                                                               \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, %131;\n}\n"
      : TC_D8(0), TC_D8(8), TC_D8(16), TC_D8(24), TC_D8(32), TC_D8(40), TC_D8(48),
        TC_D8(56), TC_D8(64), TC_D8(72), TC_D8(80), TC_D8(88), TC_D8(96),
        TC_D8(104), TC_D8(112), TC_D8(120)
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[112], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111}, "
      "%112, %113, p, 1, 1, 0, %115;\n}\n"
      : TC_D8(0), TC_D8(8), TC_D8(16), TC_D8(24), TC_D8(32), TC_D8(40), TC_D8(48),
        TC_D8(56), TC_D8(64), TC_D8(72), TC_D8(80), TC_D8(88), TC_D8(96), TC_D8(104)
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : TC_D8(0), TC_D8(8), TC_D8(16), TC_D8(24), TC_D8(32), TC_D8(40), TC_D8(48),
        TC_D8(56)
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : TC_D8(0), TC_D8(8), TC_D8(16), TC_D8(24)
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %19;\n}\n"
      : TC_D8(0), TC_D8(8)
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, %11;\n}\n"
      : TC_D8(0)
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : TC_D8(0), TC_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : TC_D8(0), TC_D8(8), TC_D8(16), TC_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : TC_D8(0), TC_D8(8), TC_D8(16), TC_D8(24), TC_D8(32), TC_D8(40), TC_D8(48),
        TC_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : TC_D8(0), TC_D8(8), TC_D8(16), TC_D8(24), TC_D8(32), TC_D8(40), TC_D8(48),
        TC_D8(56), TC_D8(64), TC_D8(72), TC_D8(80), TC_D8(88), TC_D8(96),
        TC_D8(104), TC_D8(112), TC_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

#undef TC_D8

}  // namespace tc
