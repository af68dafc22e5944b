// Flash-decode attention over a dense per-sequence KV cache, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `decode_attention`
// (src/repro/kernels/decode_attention.py:88, pallas_call at :115): one query
// token per sequence, q (B, Hq, hd), against the cache (B, S, Hkv, hd);
// keys at positions >= kv_len are masked.  f32 online softmax with scale
// 1/sqrt(hd); a row with no valid key stores 0.  No model path calls it (the
// engine's dense rounds, C = 1 included, run chunked_prefill_attention, as
// the reference's do); it is ported as the reference exposes it, through
// ops.flash_decode_attention.
//
// Bound on an H100: bytes.  The function must read each sequence's live K
// and V once, 2 * kv_len * Hkv * hd * sizeof(T) bytes, for about one FLOP
// per byte.  Grid (Hkv, B), the paged decode kernel's: one CTA per
// (sequence, kv head) holds the whole query group, as the TPU kernel puts the
// group on the sublane axis, so each key row is read once per group, and
// the tile loop stops at kv_len, so nothing past it is read.  Only the K/V
// staging differs from the paged kernel (key `pos` at b * batch_stride + pos
// * row_stride); on the same keys laid into pages it returns the paged
// kernel's output bit for bit.  One CTA per (sequence, kv head) leaves a
// small batch of long sequences with few CTAs on 132 SMs (B = 4, Hkv = 8:
// 32); splitting the keys over CTAs and merging the partial softmaxes is
// later work.
#include "dense_attention_common.cuh"

namespace paged {

constexpr int kDecodeGroup = 8;   // query heads per kv head one CTA holds

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q,              // (B, Hq, HD)
    const T* __restrict__ k_cache,        // (B, S, Hkv, HD), strided
    const T* __restrict__ v_cache,        // same strides as k_cache
    const int* __restrict__ kv_lens,      // (B,)
    T* __restrict__ out,                  // (B, Hq, HD)
    int S, int n_q_heads, int n_kv_heads, long long batch_stride,
    long long row_stride, float scale) {
  __shared__ float qs[kDecodeGroup][HD];
  __shared__ float ks[kTileK][HD + 1];    // +1: conflict-free column reads
  __shared__ float vs[kTileK][HD];
  __shared__ float p_s[kDecodeGroup][kTileK];
  __shared__ float alpha_s[kDecodeGroup];
  __shared__ float l_s[kDecodeGroup];

  const int kv_head = blockIdx.x, b = blockIdx.y;
  const int group = n_q_heads / n_kv_heads;
  const int kv_len = min(__ldg(kv_lens + b), S);
  const size_t head0 = (size_t)b * n_q_heads + (size_t)kv_head * group;
  const DenseKV<T> kv =
      dense_kv(k_cache, v_cache, b, kv_head, HD, batch_stride, row_stride);

  load_q<T, HD, kDecodeGroup>(qs, scale, [&](int r) -> const T* {
    return r < group ? q + (head0 + r) * HD : nullptr;
  });

  constexpr int kOwned = kDecodeGroup / kWarps;
  constexpr int kAcc = kDecodeGroup / (kThreads / HD);
  float m[kOwned], l[kOwned], acc[kAcc];
#pragma unroll
  for (int i = 0; i < kOwned; ++i) { m[i] = kNegInf; l[i] = 0.f; }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int tile_start = 0; tile_start < kv_len; tile_start += kTileK) {
    __syncthreads();                      // previous tile's p @ V is done
    load_dense_kv_tile<T, HD>(ks, vs, kv, tile_start, kv_len);
    __syncthreads();
    attend_tile<HD, kDecodeGroup>(qs, ks, vs, p_s, alpha_s, m, l, acc,
                                  [&](int r, int j) {
                                    return r < group && tile_start + j < kv_len;
                                  });
  }
  finish_rows<T, HD, kDecodeGroup>(l, l_s, acc, [&](int r) -> T* {
    return r < group ? out + (head0 + r) * HD : nullptr;
  });
}

template <typename T>
cudaError_t launch_decode_dense(const void* q, const void* k_cache,
                                const void* v_cache, const int* kv_lens,
                                void* out, int B, int S, int n_q_heads,
                                int n_kv_heads, int hd, long long batch_stride,
                                long long row_stride, float scale,
                                cudaStream_t stream) {
  const dim3 grid(n_kv_heads, B);
#define DECODE_LAUNCH(HD)                                                   \
  decode_kernel<T, HD><<<grid, kThreads, 0, stream>>>(                      \
      static_cast<const T*>(q), static_cast<const T*>(k_cache),             \
      static_cast<const T*>(v_cache), kv_lens, static_cast<T*>(out), S,     \
      n_q_heads, n_kv_heads, batch_stride, row_stride, scale)
  if (hd == 64) {
    DECODE_LAUNCH(64);
  } else if (hd == 128) {
    DECODE_LAUNCH(128);
  } else {
    return cudaErrorInvalidValue;
  }
#undef DECODE_LAUNCH
  return cudaGetLastError();
}

}  // namespace paged

// C entry point, bound from Python with ctypes.  Strides are in elements;
// the K and V caches share them.  Returns the launch's cudaError_t (0 =
// launched).
extern "C" int decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const void* kv_lens,
                                void* out, int B, int S, int n_q_heads,
                                int n_kv_heads, int hd,
                                long long batch_stride, long long row_stride,
                                int dtype, float scale, void* stream) {
  using namespace paged;
  if (n_kv_heads <= 0 || n_q_heads % n_kv_heads != 0 ||
      n_q_heads / n_kv_heads > kDecodeGroup) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  const int* lens = static_cast<const int*>(kv_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return (int)launch_decode_dense<float>(
          q, k_cache, v_cache, lens, out, B, S, n_q_heads, n_kv_heads, hd,
          batch_stride, row_stride, scale, s);
    case kBFloat16:
      return (int)launch_decode_dense<__nv_bfloat16>(
          q, k_cache, v_cache, lens, out, B, S, n_q_heads, n_kv_heads, hd,
          batch_stride, row_stride, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
