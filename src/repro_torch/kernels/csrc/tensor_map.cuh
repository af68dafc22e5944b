// TMA tensor maps of row-major bf16 tensors, encoded on the host, for the
// kernels that load their tiles with TMA (fused_swiglu.cu, the grouped
// expert kernels).  The encoder, cuTensorMapEncodeTiled, is looked up at
// run time (cudaGetDriverEntryPoint), so no library links against libcuda.
// Every map reads boxes of 64 columns (128 bytes) in the 128-byte swizzled
// layout of hopper_common.cuh and fills what lies outside the tensor with
// zeros.
#pragma once

#include <cuda.h>   // CUtensorMap
#include <cuda_runtime.h>

namespace hopper {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// `rank` dims, innermost first: dims[0] = cols (contiguous), then the outer
// sizes; strides[i] is the byte stride of dims[i + 1]; box[0] = 64.
inline bool encode_bf16(CUtensorMap* map, const void* ptr, int rank,
                        const cuuint64_t* dims, const cuuint64_t* strides,
                        const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A matrix (rows, cols), read in boxes of box_rows rows x 64 columns.
inline bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                     int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return encode_bf16(map, ptr, 2, dims, strides, box);
}

// A stack of matrices (n, rows, cols), read in boxes of box_rows rows x 64
// columns of one matrix: a box never reaches into the next matrix.
inline bool make_map_3d(CUtensorMap* map, const void* ptr, int n, int rows,
                        int cols, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return encode_bf16(map, ptr, 3, dims, strides, box);
}

}  // namespace hopper
