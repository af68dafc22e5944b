// The paged flash-decode kernel, for the split and the fused KV layouts (see
// paged_decode_attention.cu for what it computes and how it is bound).  The
// C entry points live in paged_decode_attention.cu (split) and
// paged_decode_attention_fused.cu (fused).
#pragma once

#include "paged_attention_common.cuh"

namespace paged {

constexpr int kMaxGroup = 8;    // query heads per kv head held by one CTA

template <typename T, int HD, bool FUSED>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q,              // (B, Hq, HD)
    const T* __restrict__ k_pages,        // split: (n_pages, page_size, Hkv, HD)
    const T* __restrict__ v_pages,        // fused: k_pages (.., 2*Hkv, HD)
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
  const KVPool<T> pool =
      kv_pool<T, FUSED>(k_pages, v_pages, n_kv_heads, kv_head, HD);

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
    load_kv_tile<T, HD>(ks, vs, pool, table_row, tile_start, kv_len,
                        page_size);
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

template <typename T, bool FUSED>
cudaError_t launch_decode(const void* q, const void* k_pages,
                          const void* v_pages, const int* block_tables,
                          const int* kv_lens, void* out, int B, int n_q_heads,
                          int n_kv_heads, int hd, int page_size, int max_pages,
                          float scale, cudaStream_t stream) {
  const dim3 grid(n_kv_heads, B);
#define PAGED_DECODE_LAUNCH(HD)                                             \
  paged_decode_kernel<T, HD, FUSED><<<grid, kThreads, 0, stream>>>(         \
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

// Argument checks and the dtype switch shared by the two C entry points;
// returns the launch's cudaError_t (0 = launched).
template <bool FUSED>
int decode_entry(const void* q, const void* k_pages, const void* v_pages,
                 const void* block_tables, const void* kv_lens, void* out,
                 int B, int n_q_heads, int n_kv_heads, int hd, int page_size,
                 int max_pages, int dtype, float scale, void* stream) {
  if (n_kv_heads <= 0 || n_q_heads % n_kv_heads != 0 ||
      n_q_heads / n_kv_heads > kMaxGroup) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  const int* bt = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(kv_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return (int)launch_decode<float, FUSED>(
          q, k_pages, v_pages, bt, lens, out, B, n_q_heads, n_kv_heads, hd,
          page_size, max_pages, scale, s);
    case kBFloat16:
      return (int)launch_decode<__nv_bfloat16, FUSED>(
          q, k_pages, v_pages, bt, lens, out, B, n_q_heads, n_kv_heads, hd,
          page_size, max_pages, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace paged
