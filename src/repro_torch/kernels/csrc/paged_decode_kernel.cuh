// The paged decode kernels, for the split and the fused KV layouts (see
// paged_decode_attention.cu for what they compute and how they are bound):
// the split-K decode body of decode_splitk.cuh over keys read through the
// block table.  The C entry points live in paged_decode_attention.cu (split)
// and paged_decode_attention_fused.cu (fused).
#pragma once

#include "decode_splitk.cuh"

namespace paged {

// Where sequence b's keys live in a page pool: key pos at row pos %
// page_size of physical page block_tables[b][pos / page_size], kv head h's
// K and V rows where KVPool puts them (split pools: two pools; fused: the
// two halves of one contiguous 2 * hd run).  A CTA stages its split's table
// entries in shared memory first.
template <typename T, bool FUSED>
struct PagedKV {
  const T* k_pages;
  const T* v_pages;
  const int* block_tables;   // (B, max_pages)
  const int* kv_lens;        // (B,)
  int n_kv_heads, hd, page_size, max_pages;

  __device__ int kv_len(int b) const {
    return min(__ldg(kv_lens + b), max_pages * page_size);
  }
  __device__ KVPool<T> pool(int h) const {
    return kv_pool<T, FUSED>(k_pages, v_pages, n_kv_heads, h, hd);
  }
  __device__ const T* k(int, int h) const {
    const KVPool<T> p = pool(h);
    return p.k + p.k_head_off;
  }
  __device__ const T* v(int, int h) const {
    const KVPool<T> p = pool(h);
    return p.v + p.v_head_off;
  }
  // key pos at row pos % page_size of page table_s[pos / page_size - page0]
  struct Rows {
    const int* table_s;
    int page0, page_size;
    size_t row_stride;
    __device__ size_t operator()(int pos) const {
      const int page = table_s[pos / page_size - page0];
      return ((size_t)page * page_size + pos % page_size) * row_stride;
    }
  };
  // Stage sequence b's block-table entries of keys [key0, n_keys) in
  // table_s (at most kSplitKeys + 1 of them), so the K/V loads that follow
  // wait on no table read.
  __device__ Rows rows(int b, int key0, int n_keys, int* table_s) const {
    const int page0 = key0 / page_size;
    const int n = (n_keys - 1) / page_size - page0 + 1;
    const int* row = block_tables + (size_t)b * max_pages + page0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      table_s[i] = __ldg(row + i);
    }
    return {table_s, page0, page_size, pool(0).row_stride};
  }
};

// Argument checks, the dtype switch and the window (0: none) shared by the
// two C entry points; returns the launch's cudaError_t (0 = launched).
template <bool FUSED>
int decode_entry(const void* q, const void* k_pages, const void* v_pages,
                 const void* block_tables, const void* kv_lens, void* out,
                 void* part, void* tickets, int B, int n_q_heads,
                 int n_kv_heads, int hd, int page_size, int max_pages,
                 int n_splits, int dtype, int window, float scale,
                 void* stream) {
  if (page_size <= 0 || max_pages < 0 || window < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dec::Args a{q, out, static_cast<float*>(part),
                    static_cast<int*>(tickets), n_q_heads, 0, 0, n_splits,
                    0.f};
  const int* bt = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(kv_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int capacity = max_pages * page_size;
  auto run = [&](auto span) -> int {
    switch (dtype) {
      case kFloat32: {
        const PagedKV<float, FUSED> kv{static_cast<const float*>(k_pages),
                                       static_cast<const float*>(v_pages),
                                       bt, lens, n_kv_heads, hd, page_size,
                                       max_pages};
        return (int)dec::launch_decode_splitk<float>(
            a, kv, B, n_kv_heads, hd, capacity, scale, s, span);
      }
      case kBFloat16: {
        const PagedKV<__nv_bfloat16, FUSED> kv{
            static_cast<const __nv_bfloat16*>(k_pages),
            static_cast<const __nv_bfloat16*>(v_pages), bt, lens,
            n_kv_heads, hd, page_size, max_pages};
        return (int)dec::launch_decode_splitk<__nv_bfloat16>(
            a, kv, B, n_kv_heads, hd, capacity, scale, s, span);
      }
      default:
        return (int)cudaErrorInvalidValue;
    }
  };
  return window > 0 ? run(SlidingWindow{window}) : run(Causal{});
}

}  // namespace paged
