// Paged chunked-prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_prefill_attention`
// (src/repro/kernels/paged_prefill_attention.py, pallas_call at :213): a chunk
// of Sq queries at absolute positions q_offset + i attends to K/V gathered
// through the block table; query i sees key j iff j <= q_offset + i and
// j < kv_len.  f32 online softmax with scale 1/sqrt(hd); query head h reads
// kv head h / (Hq / Hkv).  A row with no valid key stores 0.
//
// Grid (ceil(Sq / kBlockQ), Hq, B): one CTA per (sequence, query head, tile of
// kBlockQ queries).  It walks kTileK keys at a time only while
// tile_start <= q_offset + last_row and tile_start < kv_len -- the Pallas
// kernel's whole-tile skip (paged_prefill_attention.py:85-88) -- so the work
// per sequence stays O(prefix + chunk^2 / 2) whatever the pool size.
//
// Bound on an H100: by chunk size.  Each query row does 4 * keys * hd FLOPs
// for 2 * keys * hd * sizeof(T) / group bytes of K/V that the function must
// read once, so the operations per byte grow with Sq: a 16-token chunk
// against a 512-token prefix is a few FLOPs per byte (bytes bound), a
// 256-token chunk a few hundred (operations bound against the 989 TFLOP/s
// tensor-core peak).  This first kernel runs its products as f32 FMA on CUDA
// cores (67 TFLOP/s) and re-reads each K/V tile once per query head and query
// tile (from L2 for the most part), so it sits well above both bounds at
// large chunks; moving the two products onto wgmma with TMA-staged pages is
// the next step.
#include "paged_attention_common.cuh"

namespace paged {

constexpr int kBlockQ = 16;     // query rows per CTA

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const T* __restrict__ q,              // (B, Sq, Hq, HD)
    const T* __restrict__ k_pages,        // (n_pages, page_size, Hkv, HD)
    const T* __restrict__ v_pages,
    const int* __restrict__ block_tables, // (B, max_pages)
    const int* __restrict__ kv_lens,      // (B,)
    const int* __restrict__ q_offset,     // (B,)
    T* __restrict__ out,                  // (B, Sq, Hq, HD)
    int Sq, int n_q_heads, int n_kv_heads, int page_size, int max_pages,
    float scale) {
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
    load_kv_tile<T, HD>(ks, vs, k_pages, v_pages, table_row, tile_start,
                        n_keys, page_size, n_kv_heads, kv_head);
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

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* block_tables, const int* kv_lens,
                   const int* q_offset, void* out, int B, int Sq,
                   int n_q_heads, int n_kv_heads, int hd, int page_size,
                   int max_pages, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, n_q_heads, B);
#define PAGED_PREFILL_LAUNCH(HD)                                            \
  paged_prefill_kernel<T, HD><<<grid, kThreads, 0, stream>>>(               \
      static_cast<const T*>(q), static_cast<const T*>(k_pages),             \
      static_cast<const T*>(v_pages), block_tables, kv_lens, q_offset,      \
      static_cast<T*>(out), Sq, n_q_heads, n_kv_heads, page_size,           \
      max_pages, scale)
  if (hd == 64) {
    PAGED_PREFILL_LAUNCH(64);
  } else if (hd == 128) {
    PAGED_PREFILL_LAUNCH(128);
  } else {
    return cudaErrorInvalidValue;
  }
#undef PAGED_PREFILL_LAUNCH
  return cudaGetLastError();
}

}  // namespace paged

// C entry point, bound from Python with ctypes.  Returns the launch's
// cudaError_t (0 = launched).
extern "C" int paged_prefill_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* kv_lens, const void* q_offset,
    void* out, int B, int Sq, int n_q_heads, int n_kv_heads, int hd,
    int page_size, int max_pages, int dtype, float scale, void* stream) {
  if (n_kv_heads <= 0 || n_q_heads % n_kv_heads != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || Sq == 0) return 0;
  const int* bt = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(kv_lens);
  const int* off = static_cast<const int*>(q_offset);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case paged::kFloat32:
      return (int)paged::launch<float>(q, k_pages, v_pages, bt, lens, off, out,
                                       B, Sq, n_q_heads, n_kv_heads, hd,
                                       page_size, max_pages, scale, s);
    case paged::kBFloat16:
      return (int)paged::launch<__nv_bfloat16>(
          q, k_pages, v_pages, bt, lens, off, out, B, Sq, n_q_heads,
          n_kv_heads, hd, page_size, max_pages, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
