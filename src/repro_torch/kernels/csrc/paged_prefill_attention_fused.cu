// Paged chunked-prefill attention over the fused KV layout, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `paged_prefill_attention_fused`
// (src/repro/kernels/paged_prefill_attention.py:274, pallas_call at :213):
// the split kernel's math (paged_prefill_attention.cu) over one
// head-interleaved pool (n_pages, page_size, 2*Hkv, hd), K of kv head h at
// head 2h and V at 2h+1.
//
// The TPU kernel transposes the pool to (n_pages, Hkv, 2, ps, hd) so that one
// DMA per page fills a VMEM tile with K and V.  This kernel reads the pool as
// it is stored: each staged key's K_h and V_h are one contiguous 2*hd run.
// Everything but where a key's K and V rows live (KVPool) is the split
// kernel's -- in bf16 the tensor-core body of prefill_wgmma.cuh, in f32 the
// CUDA-core body -- so on fuse_pages(k, v) it returns exactly the split
// kernel's output on (k, v).
//
// Bound on an H100: by chunk size, as for the split kernel -- bytes for short
// chunks, tensor-core operations for long ones.
#include "paged_prefill_kernel.cuh"

// C entry point, bound from Python with ctypes.  `n_kv_heads` is Hkv (the
// pool holds 2*Hkv head rows); `window` as for the split entry.  Returns
// the launch's cudaError_t.
extern "C" int paged_prefill_attention_fused(
    const void* q, const void* kv_pages, const void* block_tables,
    const void* kv_lens, const void* q_offset, void* out, int B, int Sq,
    int n_q_heads, int n_kv_heads, int hd, int page_size, int max_pages,
    int dtype, int window, float scale, void* stream) {
  return paged::prefill_entry<true>(q, kv_pages, kv_pages, block_tables,
                                    kv_lens, q_offset, out, B, Sq, n_q_heads,
                                    n_kv_heads, hd, page_size, max_pages,
                                    dtype, window, scale, stream);
}
