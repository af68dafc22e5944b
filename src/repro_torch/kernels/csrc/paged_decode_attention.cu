// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_decode_attention`
// (src/repro/kernels/paged_decode_attention.py, pallas_call at :249): one
// query token per sequence against its K/V pages, keys at positions >= kv_len
// masked, f32 online softmax with scale 1/sqrt(hd), query head h reading kv
// head h / (Hq / Hkv).  A row with kv_len == 0 stores 0 (the Pallas kernel's
// safe_l).
//
// Grid (Hkv, B): one CTA per (sequence, kv head), holding the group's query
// heads as its rows, so each K/V page is read from device memory once per
// group.  The CTA walks keys 0 .. min(kv_len, max_pages * page_size) - 1,
// kTileK (two 16-token pages) at a time, through the block table.
//
// Bound on an H100: bytes.  The kernel must read each live sequence's K and V
// once, 2 * kv_len * Hkv * hd * sizeof(T) bytes per sequence, against
// 2 * kv_len * Hq * hd multiply-adds -- about one FLOP per byte, far below the
// ~295 FLOP/byte at which the tensor cores would bind.  So the design spends
// no effort on the dot products (f32 FMA on CUDA cores) and keeps the bytes
// minimal: 16-byte coalesced loads of whole head rows, no re-read across the
// group, and no read past kv_len.
#include "paged_attention_common.cuh"

namespace paged {

constexpr int kMaxGroup = 8;    // query heads per kv head held by one CTA

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q,              // (B, Hq, HD)
    const T* __restrict__ k_pages,        // (n_pages, page_size, Hkv, HD)
    const T* __restrict__ v_pages,
    const int* __restrict__ block_tables, // (B, max_pages)
    const int* __restrict__ kv_lens,      // (B,)
    T* __restrict__ out,                  // (B, Hq, HD)
    int n_q_heads, int n_kv_heads, int page_size, int max_pages, float scale) {
  __shared__ float qs[kMaxGroup][HD];
  __shared__ float ks[kTileK][HD + 1];    // +1: conflict-free column reads
  __shared__ float vs[kTileK][HD];
  __shared__ float p_s[kMaxGroup][kTileK];
  __shared__ float alpha_s[kMaxGroup];
  __shared__ float l_s[kMaxGroup];

  const int kv_head = blockIdx.x, b = blockIdx.y;
  const int group = n_q_heads / n_kv_heads;
  const int kv_len = min(__ldg(kv_lens + b), max_pages * page_size);
  const int* table_row = block_tables + (size_t)b * max_pages;
  const size_t head0 = (size_t)b * n_q_heads + (size_t)kv_head * group;

  load_q<T, HD, kMaxGroup>(qs, scale, [&](int r) -> const T* {
    return r < group ? q + (head0 + r) * HD : nullptr;
  });

  constexpr int kOwned = kMaxGroup / kWarps;
  constexpr int kAcc = kMaxGroup / (kThreads / HD);
  float m[kOwned], l[kOwned], acc[kAcc];
#pragma unroll
  for (int i = 0; i < kOwned; ++i) { m[i] = kNegInf; l[i] = 0.f; }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int tile_start = 0; tile_start < kv_len; tile_start += kTileK) {
    __syncthreads();                      // previous tile's p @ V is done
    load_kv_tile<T, HD>(ks, vs, k_pages, v_pages, table_row, tile_start,
                        kv_len, page_size, n_kv_heads, kv_head);
    __syncthreads();
    attend_tile<HD, kMaxGroup>(qs, ks, vs, p_s, alpha_s, m, l, acc,
                               [&](int r, int j) {
                                 return r < group && tile_start + j < kv_len;
                               });
  }
  finish_rows<T, HD, kMaxGroup>(l, l_s, acc, [&](int r) -> T* {
    return r < group ? out + (head0 + r) * HD : nullptr;
  });
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* block_tables, const int* kv_lens, void* out,
                   int B, int n_q_heads, int n_kv_heads, int hd, int page_size,
                   int max_pages, float scale, cudaStream_t stream) {
  const dim3 grid(n_kv_heads, B);
#define PAGED_DECODE_LAUNCH(HD)                                             \
  paged_decode_kernel<T, HD><<<grid, kThreads, 0, stream>>>(                \
      static_cast<const T*>(q), static_cast<const T*>(k_pages),             \
      static_cast<const T*>(v_pages), block_tables, kv_lens,                \
      static_cast<T*>(out), n_q_heads, n_kv_heads, page_size, max_pages, scale)
  if (hd == 64) {
    PAGED_DECODE_LAUNCH(64);
  } else if (hd == 128) {
    PAGED_DECODE_LAUNCH(128);
  } else {
    return cudaErrorInvalidValue;
  }
#undef PAGED_DECODE_LAUNCH
  return cudaGetLastError();
}

}  // namespace paged

// C entry point, bound from Python with ctypes.  Returns the launch's
// cudaError_t (0 = launched).
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* kv_lens, void* out, int B,
    int n_q_heads, int n_kv_heads, int hd, int page_size, int max_pages,
    int dtype, float scale, void* stream) {
  if (n_kv_heads <= 0 || n_q_heads % n_kv_heads != 0 ||
      n_q_heads / n_kv_heads > paged::kMaxGroup) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  const int* bt = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(kv_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case paged::kFloat32:
      return (int)paged::launch<float>(q, k_pages, v_pages, bt, lens, out, B,
                                       n_q_heads, n_kv_heads, hd, page_size,
                                       max_pages, scale, s);
    case paged::kBFloat16:
      return (int)paged::launch<__nv_bfloat16>(q, k_pages, v_pages, bt, lens,
                                               out, B, n_q_heads, n_kv_heads,
                                               hd, page_size, max_pages,
                                               scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
