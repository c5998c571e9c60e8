// Host side of TMA, shared by the kernels that load and store by tensor
// map: cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint at
// run time (a library then needs no -lcuda), and the bf16 maps built on it.
// A map is encoded per call and passed to the kernel by value (a
// __grid_constant__ parameter), so a captured CUDA graph holds its own.

#pragma once

#include <cuda.h>           // CUtensorMap and its enums (no driver link)
#include <cuda_runtime.h>

namespace tc {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a bf16 tensor of `rank` dims (`dims` innermost first, contiguous in the
// first; `strides` the byte strides of dims 1.., multiples of 16) as a TMA
// map of `box` boxes; elements outside the tensor load as zeros and are not
// stored.  False if the encoding fails.
inline bool bf16_tensor_map(CUtensorMap* map, const void* base, int rank,
                            const cuuint64_t* dims, const cuuint64_t* strides,
                            const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc
