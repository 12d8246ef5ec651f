// Host-side TMA tensor maps for the wgmma kernels (conv_sm90.cu, flash.cu,
// flash_bwd.cu and the wide pair): libcuda's encoders, found through the
// runtime's entry-point query (the libraries do not link libcuda), and the
// row-major map that every 2-D operand, residual and output of those
// kernels uses (bf16, f16 in a -DSM90_F16 build, or f32 for the backward's
// dq sums).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tmap {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                 cuuint32_t, cuuint32_t, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline void* cuda_entry_point(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  const cudaError_t e = cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t e = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q);
#endif
  return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? p : nullptr;
}

// the 16-bit element type of a build (sm90_gemm.cuh's elem)
#ifdef SM90_F16
constexpr CUtensorMapDataType kElemType = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
#else
constexpr CUtensorMapDataType kElemType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
#endif

// a row-major [rows, cols] matrix of the build's 16-bit elements, boxes of
// [box_rows, 64] with the 128-byte swizzle, rows past the end read as
// zeros and not written; with f32, a row-major f32 matrix in boxes of
// [box_rows, 32] (128 bytes a box row, the same swizzle)
inline bool make_map(CUtensorMap* map, const void* ptr, long long rows, long long cols,
                     int box_rows, bool f32 = false) {
  static const auto fn = reinterpret_cast<EncodeTiled>(cuda_entry_point("cuTensorMapEncodeTiled"));
  const int elem_bytes = f32 ? 4 : 2;
  const int box_cols = 128 / elem_bytes;
  if (!fn || reinterpret_cast<uintptr_t>(ptr) % 16 || cols % box_cols || rows <= 0) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : kElemType, 2,
            const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tmap
