// Paged flash-decode attention over the fused KV layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_decode_attention_fused`
// (src/repro/kernels/paged_decode_attention.py:303, pallas_call at :249): the
// split kernel's math (paged_decode_attention.cu) over one head-interleaved
// pool (n_pages, page_size, 2*Hkv, hd), K of kv head h at head 2h and V at
// 2h+1.
//
// The TPU kernel transposes the pool to (n_pages, Hkv, 2, ps, hd) so that one
// DMA per page fills a VMEM tile with K and V.  This kernel reads the pool as
// it is stored: each staged key's K_h and V_h are one contiguous 2*hd run
// (256 bytes in bf16 at hd 64), copied by neighbouring threads in 16-byte
// cp.async chunks into the K and V tiles of the split-K decode body
// (decode_splitk.cuh).  Everything after the staging is the split kernel's,
// so on fuse_pages(k, v) it returns exactly the split kernel's output on
// (k, v).
//
// Bound on an H100: bytes, as for the split kernel -- each live key's K and
// V read once per kv head, group FLOPs per bf16 byte; bf16 runs its
// products on mma.sync.
#include "paged_decode_kernel.cuh"

// C entry point, bound from Python with ctypes.  `n_kv_heads` is Hkv (the
// pool holds 2*Hkv head rows); `part`, `tickets` and `window` as for the
// split entry.  Returns the launch's cudaError_t.
extern "C" int paged_decode_attention_fused(
    const void* q, const void* kv_pages, const void* block_tables,
    const void* kv_lens, void* out, void* part, void* tickets, int B,
    int n_q_heads, int n_kv_heads, int hd, int page_size, int max_pages,
    int n_splits, int dtype, int window, float scale, void* stream) {
  return paged::decode_entry<true>(
      q, kv_pages, kv_pages, block_tables, kv_lens, out, part, tickets, B,
      n_q_heads, n_kv_heads, hd, page_size, max_pages, n_splits, dtype, window,
      scale, stream);
}
