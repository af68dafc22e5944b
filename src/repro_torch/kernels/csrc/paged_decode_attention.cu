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
//
// The kernel itself is in paged_decode_kernel.cuh, shared with the fused
// layout's entry point (paged_decode_attention_fused.cu).
#include "paged_decode_kernel.cuh"

// C entry point, bound from Python with ctypes.  Returns the launch's
// cudaError_t (0 = launched).
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* kv_lens, void* out, int B,
    int n_q_heads, int n_kv_heads, int hd, int page_size, int max_pages,
    int dtype, float scale, void* stream) {
  return paged::decode_entry<false>(q, k_pages, v_pages, block_tables, kv_lens,
                                    out, B, n_q_heads, n_kv_heads, hd,
                                    page_size, max_pages, dtype, scale,
                                    stream);
}
