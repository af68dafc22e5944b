// KV page scatter for Hopper (sm_90a): pages[:, ids] = staged, in place, for
// swap-in, the partial (tail) swap-in and the disaggregated handoff import.
//
// Replaces the TPU kernel `swap_scatter_pages` (src/repro/kernels/swap.py:100,
// pallas_call at :113), whose grid step (layer, i) DMAs one staged page into
// page ids[i] of the donated (aliased) pool.  Here the pool is updated in
// place: PyTorch has no donation, and a second copy of the pool is what the
// aliasing avoided.
//
// Bound on an H100: bytes, 2 * L * n * page_bytes over 3.35 TB/s with no
// arithmetic.  The design mirrors the gather: one CTA per (page, layer),
// 16-byte vectors, neighbouring threads on neighbouring addresses.  Padded
// ids repeat the sink page, so several CTAs may write the sink at once; the
// race is harmless because the sink is never read, and no page outside ids
// is touched.
#include "swap_pages_common.cuh"

namespace swap {

__global__ void __launch_bounds__(kThreads) scatter_kernel(
    uint4* __restrict__ pages,         // (L, n_phys, page_vecs), in place
    const int* __restrict__ ids,       // (n,)
    const uint4* __restrict__ staged,  // (L, n, page_vecs)
    int n_phys, int n, int page_vecs) {
  const int i = blockIdx.x, l = blockIdx.y;
  const int id = __ldg(ids + i);
  const uint4* src = staged + ((size_t)l * n + i) * page_vecs;
  uint4* dst = pages + ((size_t)l * n_phys + id) * page_vecs;
  for (int v = threadIdx.x; v < page_vecs; v += kThreads) dst[v] = __ldg(src + v);
}

}  // namespace swap

extern "C" int swap_scatter_pages(void* pages, const void* ids,
                                  const void* staged, int L, int n_phys, int n,
                                  int page_bytes, void* stream) {
  if (page_bytes <= 0 || page_bytes % 16 != 0 || L > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (L == 0 || n == 0) return 0;
  swap::scatter_kernel<<<dim3(n, L), swap::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(pages), static_cast<const int*>(ids),
      static_cast<const uint4*>(staged), n_phys, n, page_bytes / 16);
  return (int)cudaGetLastError();
}
