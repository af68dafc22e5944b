// Chunked-prefill attention over a dense per-sequence KV cache, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `chunked_prefill_attention`
// (src/repro/kernels/chunked_prefill_attention.py:109, pallas_call at :144):
// a chunk of Sq queries at absolute positions q_offset + i attends to the
// cache (B, Skv, Hkv, hd); query i sees key j iff j <= q_offset + i and
// j < kv_len.  f32 online softmax with scale 1/sqrt(hd); query head h reads
// kv head h / (Hq / Hkv).  A row with no valid key stores 0; a row whose
// valid keys hold a NaN stores NaN (the engine's NaN guard reads it).
//
// This is the dense engine layout's attention: every round of the dense
// path runs it once per layer, at every chunk bucket, C = 1 included.
//
// The kernel reads key `pos` of sequence b at b * batch_stride + pos *
// row_stride, so it takes the engine's cache[:, :-1] view (batch stride
// (S+1)*Hkv*hd) as it is, never a copy.  Everything but where a key is read
// is the paged prefill kernel's, so on the same keys laid into pages it
// returns the paged kernel's output bit for bit.
//
// Bound on an H100: by chunk size, as the paged kernel -- bytes for a short
// chunk against a long prefix, tensor-core operations for a long chunk.
//   bf16: the tensor-core body of prefill_wgmma.cuh (what bounds it and
//     what the design does about it are set out there): one CTA per
//     (sequence, kv head, 64 packed (position, group head) rows), K/V
//     staged once per kv head as bf16 by cp.async in a three-tile ring,
//     S = Q K^T and O += P V on wgmma, P split into bf16 hi + lo halves
//     (output within ~2^-17 sum(p |v|) / l of the f32 product).
//   f32: the CUDA-core body of paged_attention_common.cuh, one CTA per
//     (sequence, query head, tile of kBlockQ queries), kTileK keys at a
//     time as f32 FMA.
// Both stop at the last tile any of the CTA's rows can see (the Pallas
// kernel's whole-tile skip), so the work stays O(prefix + chunk^2 / 2)
// whatever Skv is.
#include "dense_attention_common.cuh"
#include "prefill_wgmma.cuh"

#include <type_traits>

namespace paged {

constexpr int kBlockQ = 16;     // query rows per CTA (f32): the paged kernel's tile

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) chunked_prefill_kernel(
    const T* __restrict__ q,              // (B, Sq, Hq, HD)
    const T* __restrict__ k_cache,        // (B, Skv, Hkv, HD), strided
    const T* __restrict__ v_cache,        // same strides as k_cache
    const int* __restrict__ kv_lens,      // (B,)
    const int* __restrict__ q_offset,     // (B,)
    T* __restrict__ out,                  // (B, Sq, Hq, HD)
    int Sq, int Skv, int n_q_heads, int n_kv_heads, long long batch_stride,
    long long row_stride, float scale) {
  __shared__ float qs[kBlockQ][HD];
  __shared__ float ks[kTileK][HD + 1];    // +1: conflict-free column reads
  __shared__ float vs[kTileK][HD];
  __shared__ float p_s[kBlockQ][kTileK];
  __shared__ float alpha_s[kBlockQ];
  __shared__ float l_s[kBlockQ];

  const int q0 = blockIdx.x * kBlockQ, h = blockIdx.y, b = blockIdx.z;
  const int kv_head = h / (n_q_heads / n_kv_heads);
  const int rows = min(kBlockQ, Sq - q0);
  const int kv_len = min(__ldg(kv_lens + b), Skv);
  const int pos0 = __ldg(q_offset + b) + q0;       // position of row 0
  const int n_keys = max(0, min(kv_len, pos0 + rows));
  const DenseKV<T> kv =
      dense_kv(k_cache, v_cache, b, kv_head, HD, batch_stride, row_stride);
  auto row_offset = [&](int r) {
    return (((size_t)b * Sq + q0 + r) * n_q_heads + h) * HD;
  };

  load_q<T, HD, kBlockQ>(qs, scale, [&](int r) -> const T* {
    return r < rows ? q + row_offset(r) : nullptr;
  });

  constexpr int kOwned = kBlockQ / kWarps;
  constexpr int kAcc = kBlockQ / (kThreads / HD);
  float m[kOwned], l[kOwned], acc[kAcc];
#pragma unroll
  for (int i = 0; i < kOwned; ++i) { m[i] = kNegInf; l[i] = 0.f; }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int tile_start = 0; tile_start < n_keys; tile_start += kTileK) {
    __syncthreads();                      // previous tile's p @ V is done
    load_dense_kv_tile<T, HD>(ks, vs, kv, tile_start, n_keys);
    __syncthreads();
    attend_tile<HD, kBlockQ>(qs, ks, vs, p_s, alpha_s, m, l, acc,
                             [&](int r, int j) {
                               const int key = tile_start + j;
                               return r < rows && key <= pos0 + r &&
                                      key < kv_len;
                             });
  }
  finish_rows<T, HD, kBlockQ>(l, l_s, acc, [&](int r) -> T* {
    return r < rows ? out + row_offset(r) : nullptr;
  });
}

// bf16: the tensor-core body over keys read through the cache's strides.
template <int HD>
__global__ void __launch_bounds__(wg::kThreads) chunked_prefill_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_cache,
    const __nv_bfloat16* __restrict__ v_cache,
    const int* __restrict__ kv_lens, const int* __restrict__ q_offset,
    __nv_bfloat16* __restrict__ out, int Sq, int Skv, int n_q_heads,
    int n_kv_heads, long long batch_stride, long long row_stride,
    float scale_log2) {
  const int kv_head = blockIdx.y, b = blockIdx.z;
  const DenseKV<__nv_bfloat16> kv =
      dense_kv(k_cache, v_cache, b, kv_head, HD, batch_stride, row_stride);
  wg::prefill_rows<HD>(
      q, out, kv.k, kv.v, [&](int pos) { return (size_t)pos * kv.row_stride; },
      b, kv_head, blockIdx.x * wg::kRows, Sq, n_q_heads,
      n_q_heads / n_kv_heads, min(__ldg(kv_lens + b), Skv),
      __ldg(q_offset + b), scale_log2);
}

template <typename T>
cudaError_t launch_chunked_prefill(const void* q, const void* k_cache,
                                   const void* v_cache, const int* kv_lens,
                                   const int* q_offset, void* out, int B,
                                   int Sq, int Skv, int n_q_heads,
                                   int n_kv_heads, int hd,
                                   long long batch_stride,
                                   long long row_stride, float scale,
                                   cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int group = n_q_heads / n_kv_heads;
    const dim3 grid((Sq * group + wg::kRows - 1) / wg::kRows, n_kv_heads, B);
#define CHUNKED_PREFILL_LAUNCH(HD)                                          \
  {                                                                         \
    auto kernel = chunked_prefill_wgmma_kernel<HD>;                         \
    const cudaError_t attr =                                                \
        hopper::allow_smem(kernel, wg::Smem<HD>::kBytes);                   \
    if (attr != cudaSuccess) return attr;                                   \
    kernel<<<grid, wg::kThreads, wg::Smem<HD>::kBytes, stream>>>(           \
        static_cast<const T*>(q), static_cast<const T*>(k_cache),           \
        static_cast<const T*>(v_cache), kv_lens, q_offset,                  \
        static_cast<T*>(out), Sq, Skv, n_q_heads, n_kv_heads, batch_stride, \
        row_stride, scale * wg::kLog2e);                                    \
  }
    if (hd == 64) {
      CHUNKED_PREFILL_LAUNCH(64);
    } else if (hd == 128) {
      CHUNKED_PREFILL_LAUNCH(128);
    } else {
      return cudaErrorInvalidValue;
    }
#undef CHUNKED_PREFILL_LAUNCH
  } else {
    const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, n_q_heads, B);
#define CHUNKED_PREFILL_LAUNCH(HD)                                          \
  chunked_prefill_kernel<T, HD><<<grid, kThreads, 0, stream>>>(             \
      static_cast<const T*>(q), static_cast<const T*>(k_cache),             \
      static_cast<const T*>(v_cache), kv_lens, q_offset,                    \
      static_cast<T*>(out), Sq, Skv, n_q_heads, n_kv_heads, batch_stride,   \
      row_stride, scale)
    if (hd == 64) {
      CHUNKED_PREFILL_LAUNCH(64);
    } else if (hd == 128) {
      CHUNKED_PREFILL_LAUNCH(128);
    } else {
      return cudaErrorInvalidValue;
    }
#undef CHUNKED_PREFILL_LAUNCH
  }
  return cudaGetLastError();
}

}  // namespace paged

// C entry point, bound from Python with ctypes.  Strides are in elements;
// the K and V caches share them.  Returns the launch's cudaError_t (0 =
// launched).
extern "C" int chunked_prefill_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* kv_lens, const void* q_offset, void* out, int B, int Sq,
    int Skv, int n_q_heads, int n_kv_heads, int hd, long long batch_stride,
    long long row_stride, int dtype, float scale, void* stream) {
  using namespace paged;
  if (n_kv_heads <= 0 || n_q_heads % n_kv_heads != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || Sq == 0) return 0;
  const int* lens = static_cast<const int*>(kv_lens);
  const int* off = static_cast<const int*>(q_offset);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return (int)launch_chunked_prefill<float>(
          q, k_cache, v_cache, lens, off, out, B, Sq, Skv, n_q_heads,
          n_kv_heads, hd, batch_stride, row_stride, scale, s);
    case kBFloat16:
      return (int)launch_chunked_prefill<__nv_bfloat16>(
          q, k_cache, v_cache, lens, off, out, B, Sq, Skv, n_q_heads,
          n_kv_heads, hd, batch_stride, row_stride, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
