// The paged chunked-prefill kernels, for the split and the fused KV layouts
// (see paged_prefill_attention.cu for what they compute and how they are
// bound).  bf16 runs the tensor-core body of prefill_wgmma.cuh, one CTA per
// (sequence, kv head, 64 packed rows); f32 runs the CUDA-core body of
// paged_attention_common.cuh, one CTA per (sequence, query head, 16 rows).
// The C entry points live in paged_prefill_attention.cu (split) and
// paged_prefill_attention_fused.cu (fused).
#pragma once

#include "paged_attention_common.cuh"
#include "prefill_wgmma.cuh"

#include <type_traits>

namespace paged {

constexpr int kBlockQ = 16;     // query rows per CTA (f32)

template <typename T, int HD, bool FUSED, typename Span>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const T* __restrict__ q,              // (B, Sq, Hq, HD)
    const T* __restrict__ k_pages,        // split: (n_pages, page_size, Hkv, HD)
    const T* __restrict__ v_pages,        // fused: k_pages (.., 2*Hkv, HD)
    const int* __restrict__ block_tables, // (B, max_pages)
    const int* __restrict__ kv_lens,      // (B,)
    const int* __restrict__ q_offset,     // (B,)
    T* __restrict__ out,                  // (B, Sq, Hq, HD)
    int Sq, int n_q_heads, int n_kv_heads, int page_size, int max_pages,
    float scale, const Span span) {
  __shared__ float qs[kBlockQ][HD];
  __shared__ float ks[kTileK][HD + 1];    // +1: conflict-free column reads
  __shared__ float vs[kTileK][HD];
  __shared__ float p_s[kBlockQ][kTileK];
  __shared__ float alpha_s[kBlockQ];
  __shared__ float l_s[kBlockQ];

  const int q0 = blockIdx.x * kBlockQ, h = blockIdx.y, b = blockIdx.z;
  const int kv_head = h / (n_q_heads / n_kv_heads);
  const int rows = min(kBlockQ, Sq - q0);
  const int kv_len = min(__ldg(kv_lens + b), max_pages * page_size);
  const int pos0 = __ldg(q_offset + b) + q0;       // position of row 0
  // keys past the last row's causal bound or past kv_len are dead for every
  // row of this CTA: the tile loop stops before them
  const int n_keys = max(0, min(kv_len, pos0 + rows));
  const int* table_row = block_tables + (size_t)b * max_pages;
  const KVPool<T> pool =
      kv_pool<T, FUSED>(k_pages, v_pages, n_kv_heads, kv_head, HD);
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

  // tiles wholly below the first row's window are skipped
  const int first = Span::kWindowed ? span.lo(pos0) / kTileK * kTileK : 0;
  for (int tile_start = first; tile_start < n_keys; tile_start += kTileK) {
    __syncthreads();                      // previous tile's p @ V is done
    load_kv_tile<T, HD>(ks, vs, pool, table_row, tile_start, n_keys,
                        page_size);
    __syncthreads();
    attend_tile<HD, kBlockQ>(qs, ks, vs, p_s, alpha_s, m, l, acc,
                             [&](int r, int j) {
                               const int key = tile_start + j;
                               return r < rows && key <= pos0 + r &&
                                      key < kv_len &&
                                      (!Span::kWindowed ||
                                       key >= span.lo(pos0 + r));
                             });
  }
  finish_rows<T, HD, kBlockQ>(l, l_s, acc, [&](int r) -> T* {
    return r < rows ? out + row_offset(r) : nullptr;
  });
}

// bf16: the tensor-core body over keys read through the block table row.
template <int HD, bool FUSED, typename Span>
__global__ void __launch_bounds__(wg::kThreads) paged_prefill_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages,
    const int* __restrict__ block_tables, const int* __restrict__ kv_lens,
    const int* __restrict__ q_offset, __nv_bfloat16* __restrict__ out, int Sq,
    int n_q_heads, int n_kv_heads, int page_size, int max_pages,
    float scale_log2, const Span span) {
  const int kv_head = blockIdx.y, b = blockIdx.z;
  const int kv_len = min(__ldg(kv_lens + b), max_pages * page_size);
  const int* table_row = block_tables + (size_t)b * max_pages;
  const KVPool<__nv_bfloat16> pool = kv_pool<__nv_bfloat16, FUSED>(
      k_pages, v_pages, n_kv_heads, kv_head, HD);
  wg::prefill_rows<HD>(
      q, out, pool.k + pool.k_head_off, pool.v + pool.v_head_off,
      [&](int pos) {
        const int page = __ldg(table_row + pos / page_size);
        return ((size_t)page * page_size + pos % page_size) * pool.row_stride;
      },
      b, kv_head, blockIdx.x * wg::kRows, Sq, n_q_heads,
      n_q_heads / n_kv_heads, kv_len, __ldg(q_offset + b), scale_log2, span);
}

template <typename T, bool FUSED, typename Span>
cudaError_t launch_prefill(const void* q, const void* k_pages,
                           const void* v_pages, const int* block_tables,
                           const int* kv_lens, const int* q_offset, void* out,
                           int B, int Sq, int n_q_heads, int n_kv_heads,
                           int hd, int page_size, int max_pages, float scale,
                           cudaStream_t stream, Span span) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int group = n_q_heads / n_kv_heads;
    const dim3 grid((Sq * group + wg::kRows - 1) / wg::kRows, n_kv_heads, B);
#define PAGED_PREFILL_LAUNCH(HD)                                            \
  {                                                                         \
    auto kernel = paged_prefill_wgmma_kernel<HD, FUSED, Span>;              \
    const cudaError_t attr =                                                \
        hopper::allow_smem(kernel, wg::Smem<HD>::kBytes);                   \
    if (attr != cudaSuccess) return attr;                                   \
    kernel<<<grid, wg::kThreads, wg::Smem<HD>::kBytes, stream>>>(           \
        static_cast<const T*>(q), static_cast<const T*>(k_pages),           \
        static_cast<const T*>(v_pages), block_tables, kv_lens, q_offset,    \
        static_cast<T*>(out), Sq, n_q_heads, n_kv_heads, page_size,         \
        max_pages, scale * wg::kLog2e, span);                               \
  }
    if (hd == 64) {
      PAGED_PREFILL_LAUNCH(64);
    } else if (hd == 128) {
      PAGED_PREFILL_LAUNCH(128);
    } else {
      return cudaErrorInvalidValue;
    }
#undef PAGED_PREFILL_LAUNCH
  } else {
    const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, n_q_heads, B);
#define PAGED_PREFILL_LAUNCH(HD)                                            \
  paged_prefill_kernel<T, HD, FUSED, Span><<<grid, kThreads, 0, stream>>>(  \
      static_cast<const T*>(q), static_cast<const T*>(k_pages),             \
      static_cast<const T*>(v_pages), block_tables, kv_lens, q_offset,      \
      static_cast<T*>(out), Sq, n_q_heads, n_kv_heads, page_size,           \
      max_pages, scale, span)
    if (hd == 64) {
      PAGED_PREFILL_LAUNCH(64);
    } else if (hd == 128) {
      PAGED_PREFILL_LAUNCH(128);
    } else {
      return cudaErrorInvalidValue;
    }
#undef PAGED_PREFILL_LAUNCH
  }
  return cudaGetLastError();
}

// Argument checks, the dtype switch and the window (0: none) shared by the
// two C entry points; returns the launch's cudaError_t (0 = launched).
template <bool FUSED>
int prefill_entry(const void* q, const void* k_pages, const void* v_pages,
                  const void* block_tables, const void* kv_lens,
                  const void* q_offset, void* out, int B, int Sq,
                  int n_q_heads, int n_kv_heads, int hd, int page_size,
                  int max_pages, int dtype, int window, float scale,
                  void* stream) {
  if (n_kv_heads <= 0 || n_q_heads % n_kv_heads != 0 || window < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || Sq == 0) return 0;
  const int* bt = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(kv_lens);
  const int* off = static_cast<const int*>(q_offset);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto span) -> int {
    switch (dtype) {
      case kFloat32:
        return (int)launch_prefill<float, FUSED>(
            q, k_pages, v_pages, bt, lens, off, out, B, Sq, n_q_heads,
            n_kv_heads, hd, page_size, max_pages, scale, s, span);
      case kBFloat16:
        return (int)launch_prefill<__nv_bfloat16, FUSED>(
            q, k_pages, v_pages, bt, lens, off, out, B, Sq, n_q_heads,
            n_kv_heads, hd, page_size, max_pages, scale, s, span);
      default:
        return (int)cudaErrorInvalidValue;
    }
  };
  return window > 0 ? run(SlidingWindow{window}) : run(Causal{});
}

}  // namespace paged
