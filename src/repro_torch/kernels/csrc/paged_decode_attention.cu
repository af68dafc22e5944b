// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_decode_attention`
// (src/repro/kernels/paged_decode_attention.py:282, pallas_call at :249): one
// query token per sequence against its K/V pages, keys at positions >= kv_len
// masked, f32 online softmax with scale 1/sqrt(hd), query head h reading kv
// head h / (Hq / Hkv), any group.  A row with kv_len == 0 stores 0 (the
// Pallas kernel's safe_l).
//
// Bound on an H100: bytes at the groups the main path runs.  The kernel must
// read each live key's K and V once per kv head, 2 * kv_len * Hkv * hd *
// sizeof(T) bytes per sequence, against 4 * kv_len * Hq * hd FLOPs: group
// FLOPs per bf16 byte, far below the tensor cores' ~295 but, at group 48,
// above what f32 FMA on CUDA cores does per byte.  The body
// (decode_splitk.cuh) splits each sequence's keys over CTAs of kSplitKeys
// keys, holds up to 16 query heads of a kv head in one CTA so a page is
// read once per such row block (any group: a larger one takes several),
// streams K/V in their dtype through a cp.async ring, runs bf16 on
// mma.sync tensor cores (f32 on CUDA cores), and merges the splits in the same launch in a fixed order.
// Each CTA first stages its split's block-table entries in shared memory
// (so no K/V load waits on a table read), then reads keys one by one
// through them: 16-byte coalesced loads of whole head rows, nothing read
// past kv_len.
//
// The paged kernels are in paged_decode_kernel.cuh, shared with the fused
// layout's entry point (paged_decode_attention_fused.cu); the dense kernel
// (decode_attention.cu) runs the same body, so on the same keys all three
// return the same bits.
#include "paged_decode_kernel.cuh"

// C entry point, bound from Python with ctypes.  `part` is the split
// partials' f32 scratch and `tickets` a zeroed int32 buffer (both from the
// wrapper, which sizes them for `n_splits`); `window` > 0 runs the
// SlidingWindow instantiation (the last `window` keys only), 0 the Causal
// one.  Returns the launch's cudaError_t (0 = launched).
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* kv_lens, void* out, void* part,
    void* tickets, int B, int n_q_heads, int n_kv_heads, int hd,
    int page_size, int max_pages, int n_splits, int dtype, int window,
    float scale, void* stream) {
  return paged::decode_entry<false>(
      q, k_pages, v_pages, block_tables, kv_lens, out, part, tickets, B,
      n_q_heads, n_kv_heads, hd, page_size, max_pages, n_splits, dtype, window,
      scale, stream);
}
