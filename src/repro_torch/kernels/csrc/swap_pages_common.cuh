// Shared pieces of the four KV swap kernels (gather, scatter and their INT8
// variants): dtypes, conversions and the per-head INT8 math.
//
// The page pool is (L, n_phys, page_size, H, hd) and the staging tensor (L,
// n, page_size, H, hd), both contiguous, so one page is page_size * H * hd
// contiguous elements.  The gather runs one CTA of kThreads per (page,
// layer), grid (n, L): a CTA reads its own page id from `ids` (what the TPU
// kernels got by scalar prefetch) and walks the page in 16-byte vectors,
// thread t on vectors t, t + kThreads, ...: neighbouring threads on
// neighbouring addresses.  The INT8 gather's two-pass kernel walks a block
// of heads of the page the same way, a CTA per (page, head block).  The
// INT8 gather and the INT8 scatter run persistent CTAs that stage pages in
// shared memory by bulk copies (see their files).  The wrappers require
// `hd * sizeof(T)` to be a multiple of 16, so a vector never straddles two
// heads: vector v of a page belongs to head (v / (hd / kVec)) % H.
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

// Symmetric INT8 code of x at step `safe` (> 0): x / safe by IEEE division,
// as the plain version, rounded half to even (as torch.round) and clipped
// to +-127.  The clip comes first and the conversion rounds (F2I, to nearest
// even): the same code, since the bounds are integers and rounding is
// monotone, and a NaN quotient clips to -127 either way (fmaxf drops it);
// one instruction fewer than rintf, clip, convert.
__device__ __forceinline__ int8_t quantize(float x, float safe) {
  return static_cast<int8_t>(
      __float2int_rn(fminf(fmaxf(x / safe, -127.f), 127.f)));
}

}  // namespace swap
