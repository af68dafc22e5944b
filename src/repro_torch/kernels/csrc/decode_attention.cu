// Flash-decode attention over a dense per-sequence KV cache, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `decode_attention`
// (src/repro/kernels/decode_attention.py:88, pallas_call at :115): one query
// token per sequence, q (B, Hq, hd), against the cache (B, S, Hkv, hd); keys
// at positions >= kv_len are masked.  f32 online softmax with scale
// 1/sqrt(hd), any group; a row with no valid key stores 0.  No model path
// calls it (the engine's dense rounds, C = 1 included, run
// chunked_prefill_attention, as the reference's do); it is ported as the
// reference exposes it, through ops.flash_decode_attention.
//
// Bound on an H100: bytes at small groups -- each sequence's live K and V
// read once per kv head, 2 * kv_len * Hkv * hd * sizeof(T) bytes, for group
// FLOPs per bf16 byte.  The body is the paged decode kernels'
// (decode_splitk.cuh): keys split over CTAs of kSplitKeys (B = 4, Hkv = 8
// over a 32k cache runs 2,048 CTAs), up to 16 query heads of a kv head in
// one CTA (a larger group in several row blocks), K/V
// streamed in their dtype through a cp.async ring, bf16 on mma.sync,
// the splits merged in the same launch in a fixed order.  Only the
// key-to-row function differs from the paged kernel (key `pos` at b *
// batch_stride + pos * row_stride), and the split points depend only on the
// key index, so on the same keys laid into pages it returns the paged
// kernel's output bit for bit.
#include "decode_splitk.cuh"

namespace paged {

// Sequence b's keys in a dense cache whose batch and key strides are
// batch_stride and row_stride elements: key pos of kv head h at k_cache +
// b * batch_stride + pos * row_stride + h * hd (and so in v_cache).  The
// cache may be a strided view -- the engine's cache[:, :-1] drops each
// slot's sink row -- and the kernel never asks for a copy.
template <typename T>
struct DenseCache {
  const T* k_cache;
  const T* v_cache;
  const int* kv_lens;
  long long batch_stride, row_stride;
  int S, hd;

  __device__ int kv_len(int b) const { return min(__ldg(kv_lens + b), S); }
  __device__ const T* k(int b, int h) const {
    return k_cache + (size_t)b * batch_stride + (size_t)h * hd;
  }
  __device__ const T* v(int b, int h) const {
    return v_cache + (size_t)b * batch_stride + (size_t)h * hd;
  }
  struct Rows {
    size_t row_stride;
    __device__ size_t operator()(int pos) const {
      return (size_t)pos * row_stride;
    }
  };
  __device__ Rows rows(int, int, int, int*) const {
    return {(size_t)row_stride};
  }
};

}  // namespace paged

// C entry point, bound from Python with ctypes.  Strides are in elements;
// the K and V caches share them.  `part` is the split partials' f32 scratch
// and `tickets` a zeroed int32 buffer (both from the wrapper, sized for
// `n_splits`).  Returns the launch's cudaError_t (0 = launched).
extern "C" int decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const void* kv_lens,
                                void* out, void* part, void* tickets, int B,
                                int S, int n_q_heads, int n_kv_heads, int hd,
                                long long batch_stride, long long row_stride,
                                int n_splits, int dtype, float scale,
                                void* stream) {
  using namespace paged;
  const dec::Args a{q, out, static_cast<float*>(part),
                    static_cast<int*>(tickets), n_q_heads, 0, 0, n_splits,
                    0.f};
  const int* lens = static_cast<const int*>(kv_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: {
      const DenseCache<float> kv{static_cast<const float*>(k_cache),
                                 static_cast<const float*>(v_cache), lens,
                                 batch_stride, row_stride, S, hd};
      return (int)dec::launch_decode_splitk<float>(a, kv, B, n_kv_heads, hd,
                                                   S, scale, s);
    }
    case kBFloat16: {
      const DenseCache<__nv_bfloat16> kv{
          static_cast<const __nv_bfloat16*>(k_cache),
          static_cast<const __nv_bfloat16*>(v_cache), lens, batch_stride,
          row_stride, S, hd};
      return (int)dec::launch_decode_splitk<__nv_bfloat16>(
          a, kv, B, n_kv_heads, hd, S, scale, s);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
