// KV page scatter for Hopper (sm_90a): pages[:, ids] = staged, in place, for
// swap-in, the partial (tail) swap-in and the disaggregated handoff import.
//
// Replaces the TPU kernel `swap_scatter_pages` (src/repro/kernels/swap.py:100,
// pallas_call at :113), whose grid step (layer, i) DMAs one staged page into
// page ids[i] of the donated (aliased) pool.  Here the pool is updated in
// place: PyTorch has no donation, and a second copy of the pool is what the
// aliasing avoided.
//
// Bound on an H100: bytes, each distinct target page read once from
// `staged` and written once, over 3.35 TB/s, with no arithmetic.  The
// design:
// - No writes for repeated ids.  Item i does nothing when i + 1 < n and
//   ids[i + 1] == ids[i], so in a run of equal ids only the last one
//   writes: what the TPU kernel's sequential grid leaves in that page (last
//   write wins).  The engine pads the ids with one such run of sink ids, so
//   the padding costs neither reads nor writes.  Equal ids that are not
//   neighbours still both write, in no set order.
// - Bulk copies.  A page of one layer is one contiguous run in `staged` and
//   in the pool; it moves in chunks of kChunkBytes, each by one
//   `cp.async.bulk` into shared memory (completing on an mbarrier) and one
//   back out (a bulk group).  One thread per CTA issues every copy, so no
//   thread spends registers or instructions on addresses.
// - Persistent CTAs.  The grid is as many CTAs as fit on the SMs at once
//   (at most kCtasPerSm each); CTA b walks the work items (layer, item,
//   chunk) b, b + grid, ... through a ring of kStages chunks, with up to
//   kStages - 1 loads in flight ahead of the chunk being stored.  A stage
//   is refilled only after the bulk store that read it has finished
//   reading (`wait_group.read`).
#include "hopper_common.cuh"

namespace swap {

constexpr int kChunkBytes = 8192;      // one ring stage
constexpr int kStages = 8;
constexpr int kCtasPerSm = 3;

struct ScatterArgs {
  char* pages;                          // (L, n_phys, page_bytes), in place
  const int* ids;                       // (n,)
  const char* staged;                   // (L, n, page_bytes)
  int n_phys, n, n_chunks;
  long long page_bytes, n_items;        // n_items = L * n * n_chunks
};

// Whether work item w writes: its id is not followed by the same id.
__device__ __forceinline__ bool writes(const ScatterArgs& a, long long w) {
  const int i = (int)((w / a.n_chunks) % a.n);
  return i + 1 == a.n || __ldg(a.ids + i + 1) != __ldg(a.ids + i);
}

// This CTA's first writing item at or after w (stepping by the grid), or
// n_items.
__device__ __forceinline__ long long next_item(const ScatterArgs& a,
                                               long long w) {
  while (w < a.n_items && !writes(a, w)) w += gridDim.x;
  return w;
}

// The chunk of work item w: its offset in `staged` and in the pool, and
// its length.
struct Chunk {
  const char* src;
  char* dst;
  uint32_t bytes;
};

__device__ __forceinline__ Chunk chunk_of(const ScatterArgs& a, long long w) {
  const int c = (int)(w % a.n_chunks);
  const long long page = w / a.n_chunks;           // l * n + i
  const int i = (int)(page % a.n);
  const long long l = page / a.n;
  const long long off = (long long)c * kChunkBytes;
  const long long left = a.page_bytes - off;
  Chunk ch;
  ch.src = a.staged + page * a.page_bytes + off;
  ch.dst = a.pages + (l * a.n_phys + __ldg(a.ids + i)) * a.page_bytes + off;
  ch.bytes = (uint32_t)(left < kChunkBytes ? left : kChunkBytes);
  return ch;
}

__global__ void __launch_bounds__(32) scatter_kernel(const ScatterArgs a) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[kStages];
  if (threadIdx.x != 0) return;         // one elected thread moves it all

  const uint32_t ring0 = hopper::smem_addr(ring);
  for (int s = 0; s < kStages; ++s) hopper::mbar_init(hopper::smem_addr(&bars[s]), 1);
  hopper::mbar_init_fence();

  auto load = [&](long long w, int s) {
    const Chunk ch = chunk_of(a, w);
    const uint32_t bar = hopper::smem_addr(&bars[s]);
    hopper::mbar_expect_tx(bar, ch.bytes);
    hopper::bulk_load(ring0 + s * kChunkBytes, ch.src, ch.bytes, bar);
  };

  long long w_load = next_item(a, blockIdx.x);
  long long w_store = w_load;
  int k_load = 0;
  for (; k_load < kStages - 1 && w_load < a.n_items; ++k_load) {
    load(w_load, k_load);
    w_load = next_item(a, w_load + gridDim.x);
  }
  for (int k = 0; w_store < a.n_items; ++k) {
    const int s = k % kStages;
    hopper::mbar_wait(hopper::smem_addr(&bars[s]), (k / kStages) & 1);
    const Chunk ch = chunk_of(a, w_store);
    hopper::bulk_store(ch.dst, ring0 + s * kChunkBytes, ch.bytes);
    hopper::bulk_commit();
    w_store = next_item(a, w_store + gridDim.x);
    if (w_load < a.n_items) {
      // item k_load = k + kStages - 1 refills stage (k - 1) % kStages, which
      // item k - 1's store (the group before the newest) last read
      hopper::bulk_wait_read<1>();
      load(w_load, k_load % kStages);
      ++k_load;
      w_load = next_item(a, w_load + gridDim.x);
    }
  }
  hopper::bulk_wait<0>();               // the ring outlives every store
}

}  // namespace swap

extern "C" int swap_scatter_pages(void* pages, const void* ids,
                                  const void* staged, int L, int n_phys, int n,
                                  int page_bytes, void* stream) {
  if (page_bytes <= 0 || page_bytes % 16 != 0 || L < 0 || n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (L == 0 || n == 0) return 0;
  swap::ScatterArgs a;
  a.pages = static_cast<char*>(pages);
  a.ids = static_cast<const int*>(ids);
  a.staged = static_cast<const char*>(staged);
  a.n_phys = n_phys;
  a.n = n;
  a.n_chunks = (page_bytes + swap::kChunkBytes - 1) / swap::kChunkBytes;
  a.page_bytes = page_bytes;
  a.n_items = (long long)L * n * a.n_chunks;
  const int smem = swap::kStages * swap::kChunkBytes;
  int grid = 0;
  const cudaError_t err = hopper::persistent_grid(
      swap::scatter_kernel, 32, smem, swap::kCtasPerSm, a.n_items, &grid);
  if (err != cudaSuccess) return (int)err;
  swap::scatter_kernel<<<grid, 32, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
