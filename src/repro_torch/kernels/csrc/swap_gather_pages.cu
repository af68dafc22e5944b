// KV page gather for Hopper (sm_90a): pages[:, ids] into one contiguous
// staging tensor, for swap-out preemption and the disaggregated handoff
// export.
//
// Replaces the TPU kernel `swap_gather_pages` (src/repro/kernels/swap.py:70,
// pallas_call at :84), whose grid step (layer, i) DMAs page ids[i] of one
// layer with the ids in SMEM by scalar prefetch.
//
// Bound on an H100: bytes.  It reads L * n pages and writes as many, no
// arithmetic at all: 2 * L * n * page_bytes over 3.35 TB/s.  The design keeps
// every byte moving in 16-byte vectors, neighbouring threads on neighbouring
// addresses, with one CTA per (page, layer) so a 32-page victim at full width
// puts 24 * 32 = 768 CTAs of 32 KiB each in flight.  The kernel is
// dtype-agnostic: it moves page_bytes per page, a multiple of 16.  Ids past
// the request's real pages point at the sink page; the caller drops those
// rows after the host copy.
#include "swap_pages_common.cuh"

namespace swap {

__global__ void __launch_bounds__(kThreads) gather_kernel(
    const uint4* __restrict__ pages,   // (L, n_phys, page_vecs)
    const int* __restrict__ ids,       // (n,)
    uint4* __restrict__ out,           // (L, n, page_vecs)
    int n_phys, int n, int page_vecs) {
  const int i = blockIdx.x, l = blockIdx.y;
  const int id = __ldg(ids + i);
  const uint4* src = pages + ((size_t)l * n_phys + id) * page_vecs;
  uint4* dst = out + ((size_t)l * n + i) * page_vecs;
  for (int v = threadIdx.x; v < page_vecs; v += kThreads) dst[v] = __ldg(src + v);
}

}  // namespace swap

extern "C" int swap_gather_pages(const void* pages, const void* ids, void* out,
                                 int L, int n_phys, int n, int page_bytes,
                                 void* stream) {
  if (page_bytes <= 0 || page_bytes % 16 != 0 || L > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (L == 0 || n == 0) return 0;
  swap::gather_kernel<<<dim3(n, L), swap::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(pages), static_cast<const int*>(ids),
      static_cast<uint4*>(out), n_phys, n, page_bytes / 16);
  return (int)cudaGetLastError();
}
