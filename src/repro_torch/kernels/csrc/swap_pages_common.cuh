// Shared pieces of the four KV swap kernels (gather, scatter and their INT8
// variants): dtypes, conversions and the per-head INT8 math.
//
// Every kernel runs one CTA per (page, layer), grid (n, L).  The page pool is
// (L, n_phys, page_size, H, hd) and the staging tensor (L, n, page_size, H,
// hd), both contiguous, so one page is page_size * H * hd contiguous
// elements.  A CTA reads its own page id from `ids` (what the TPU kernels got
// by scalar prefetch) and walks the page in 16-byte vectors, thread t on
// vectors t, t + kThreads, ...: neighbouring threads on neighbouring
// addresses.  The wrappers require `hd * sizeof(T)` to be a multiple of 16,
// so a vector never straddles two heads: vector v of a page belongs to head
// (v / (hd / kVec)) % H.
//
// The ids are trusted: every id must lie in [0, n_phys).  The engine builds
// them from the pool's block tables and pads with the sink page.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace swap {

constexpr int kThreads = 256;
constexpr int kMaxHeads = 256;        // H per page the INT8 kernels take

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);      // round to nearest even, as torch's cast
}

// The 16 / sizeof(T) int8 codes of one 16-byte vector of T move as one
// 8-byte (bf16) or 4-byte (f32) word.
template <typename T>
using CodeWord = typename std::conditional<sizeof(T) == 2, uint2, uint32_t>::type;

// Symmetric INT8 code of x at step `safe` (> 0): round half to even (rintf,
// as torch.round), then clip to +-127.  IEEE division, as the plain version.
__device__ __forceinline__ int8_t quantize(float x, float safe) {
  const float r = rintf(x / safe);
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.f), 127.f)));
}

}  // namespace swap
