// Host-side tensor maps for Hopper's tensor copies (cp.async.bulk.tensor),
// shared by K3's Gram kernel (stores) and K3's VJP (loads).
//
// A stack (q, n1, n2) of T, row-major, is described as a 3-D tensor
// {n2, n1, q} (innermost first) with a box of {box_cols, box_rows, 1}.
// cuTensorMapEncodeTiled is reached through cudaGetDriverEntryPoint, so the
// library needs no link against the driver.  Encoding needs n2 * sizeof(T)
// to be a multiple of 16 and a 16-byte aligned base; callers check both
// first and keep a path without tensor copies for the rest.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {
namespace tmap {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, or null.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// Whether the tensor copy can address the stack at `base` with rows of n2.
template <typename T>
inline bool addressable(const void* base, int n2) {
  return ((long long)n2 * sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(base) % 16 == 0;
}

// The map of the stack (q, n1, n2) at `base`, box {box_cols, box_rows, 1};
// false if it does not encode.
template <typename T>
bool encode_stack(CUtensorMap* map, const void* base, int q, int n1, int n2,
                  unsigned box_cols, unsigned box_rows,
                  CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const CUtensorMapDataType dt = sizeof(T) == 8
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t dims[3] = {(cuuint64_t)n2, (cuuint64_t)n1, (cuuint64_t)q};
  const cuuint64_t strides[2] = {(cuuint64_t)n2 * sizeof(T),
                                 (cuuint64_t)n1 * n2 * sizeof(T)};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, dt, 3, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Byte offset of element (r, c) of a tile of rows of `cols` elements of
// size `sz`, laid out as the 128-byte swizzle of the tensor copy writes and
// reads it: boxes of 128 bytes of columns, and within each 128-byte row the
// 16-byte chunk index XORed with the row's index within its group of
// eight.  The tile's base must be 1024-byte aligned.
__host__ __device__ constexpr int swizzled(int r, int c, int rows, int sz) {
  return (c * sz / 128) * rows * 128 + r * 128 +
         ((((c * sz) % 128 >> 4) ^ (r & 7)) << 4) + ((c * sz) & 15);
}

}  // namespace tmap
}  // namespace
