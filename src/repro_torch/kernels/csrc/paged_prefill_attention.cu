// Paged chunked-prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_prefill_attention`
// (src/repro/kernels/paged_prefill_attention.py, pallas_call at :213): a chunk
// of Sq queries at absolute positions q_offset + i attends to K/V gathered
// through the block table; query i sees key j iff j <= q_offset + i and
// j < kv_len.  f32 online softmax with scale 1/sqrt(hd); query head h reads
// kv head h / (Hq / Hkv).  A row with no valid key stores 0.
//
// Bound on an H100: by chunk size.  Each query row does 4 * keys * hd FLOPs
// for 2 * keys * hd * sizeof(T) / group bytes of K/V that the function must
// read once, so the operations per byte grow with Sq: a 16-token chunk
// against a 512-token prefix is a few FLOPs per byte (bytes bound), a
// 256-token chunk a few hundred (operations bound against the 989 TFLOP/s
// tensor-core peak).
//   bf16: the tensor-core body of prefill_wgmma.cuh, which sets out the
//     design: one CTA per (sequence, kv head, 64 packed (position, group
//     head) rows), so a GQA group stages each K/V tile once; keys read one
//     by one through the block table row (the CTA reads it itself) by
//     cp.async into a three-tile bf16 ring; S = Q K^T and O += P V on
//     wgmma, P split into bf16 hi + lo halves, f32 online softmax.
//   f32: one CTA per (sequence, query head, tile of kBlockQ queries), the
//     CUDA-core body of paged_attention_common.cuh (f32 FMA).
// Both walk the keys only while tile_start <= q_offset + last_row and
// tile_start < kv_len -- the Pallas kernel's whole-tile skip
// (paged_prefill_attention.py:85-88) -- so the work per sequence stays
// O(prefix + chunk^2 / 2) whatever the pool size.
//
// The kernel itself is in paged_prefill_kernel.cuh, shared with the fused
// layout's entry point (paged_prefill_attention_fused.cu).
#include "paged_prefill_kernel.cuh"

// C entry point, bound from Python with ctypes.  `window` > 0 runs the
// SlidingWindow instantiation (query i over keys q_offset + i - window < j
// <= q_offset + i; tiles below every row's window are not read), 0 the
// Causal one.  Returns the launch's cudaError_t (0 = launched).
extern "C" int paged_prefill_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* kv_lens, const void* q_offset,
    void* out, int B, int Sq, int n_q_heads, int n_kv_heads, int hd,
    int page_size, int max_pages, int dtype, int window, float scale,
    void* stream) {
  return paged::prefill_entry<false>(q, k_pages, v_pages, block_tables,
                                     kv_lens, q_offset, out, B, Sq, n_q_heads,
                                     n_kv_heads, hd, page_size, max_pages,
                                     dtype, window, scale, stream);
}
