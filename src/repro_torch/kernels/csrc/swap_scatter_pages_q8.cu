// INT8 dequantization fused with the KV page scatter, for Hopper (sm_90a):
// the swap-in and handoff import of the INT8 host tier
// (host_kv_dtype="int8").
//
// Replaces the TPU kernel `swap_scatter_pages_q8` (src/repro/kernels/swap.py:204,
// pallas_call at :221).  For staged page i of layer l it writes
//   pages[l, ids[i], s, h, d] = T(float(q[l, i, s, h, d]) * scales[l, i, h])
// in place: one f32 multiply an element, rounded once to the pool's dtype
// (round to nearest even for bf16), bit for bit the plain version.
//
// Bound on an H100: bytes.  Each distinct target page needs its codes (a
// quarter or half of the page's bytes) and 4 * H bytes of scales read once
// and the page written once; one multiply an element.  The design:
// - No writes for repeated ids.  Item i does nothing when i + 1 < n and
//   ids[i + 1] == ids[i], so in a run of equal ids only the last one writes:
//   what the TPU kernel's sequential grid leaves in that page (last write
//   wins).  The engine pads the ids with one such run of sink ids, so the
//   padding costs neither reads nor writes.  Equal ids that are not
//   neighbours still both write, in no set order.
// - Bulk copies into a ring.  A work item is (layer, item, chunk): up to
//   kChunkCodes contiguous codes of one staged page (a multiple of 16, so a
//   chunk never splits a 16-byte output vector, nor one across heads).  A
//   producer warp evaluates the CTA's next 32 items at once, a lane each
//   (whether it writes, where it goes), and loads each writing chunk, in
//   item order, into a stage of a kStages-deep ring in shared memory: the
//   lane holding it by one `cp.async.bulk` of the chunk's 16-byte aligned
//   body (codes off a 16-byte boundary add at most three 4- or 8-byte
//   `cp.async` copies at each end, a lane each), and all lanes the chunk's
//   scales, one 4-byte `cp.async` each, into slots: slot k holds the scale
//   of the chunk's k-th head row modulo H, so a stage holds at most min(H,
//   head rows of a chunk) scales, whatever H is.  Every copy completes on
//   the stage's full mbarrier.  The holding lane also writes a header
//   (where the chunk goes, its vectors, its first vector's column and its
//   codes' offset); a header without vectors ends the walk.
// - Consumer warps dequantize from shared memory: thread t takes output
//   vectors t, t + kConsumerThreads, ... (neighbouring threads on
//   neighbouring addresses), each from one 8- (bf16) or 4-byte (f32) word
//   of codes and its slot's scale, and stores it as one 16-byte
//   `st.global` (staging the output for bulk stores measured no faster).
//   The slot steps with the vector: one division a chunk sets the
//   thread's first column and slot, then none.  The warps then release
//   the stage on its empty mbarrier, which the producer waits on before
//   it refills the stage.
// - Persistent CTAs.  The grid is as many CTAs as fit on the SMs at once
//   (at most kCtasPerSm each); CTA b walks the items b, b + grid, ...,
//   the producer up to kStages chunks ahead of the consumers.
#include "hopper_common.cuh"
#include "swap_pages_common.cuh"

namespace swap {

constexpr int kChunkCodes = 4096;      // codes a ring stage holds at most
constexpr int kStages = 8;
constexpr int kConsumerWarps = 4;
constexpr int kCtasPerSm = 6;
constexpr int kConsumerThreads = 32 * kConsumerWarps;
constexpr int kHeaderBytes = 32;
static_assert(kChunkCodes % 16 == 0, "chunks of whole 16-byte code runs");

// Item and element indices within a page are 32-bit (the launch refuses
// shapes where they would not fit).
struct Q8ScatterArgs {
  char* pages;                         // (L, n_phys, page_size, H, hd), in place
  const int* ids;                      // (n,)
  const int8_t* q;                     // (L, n, page_size, H, hd)
  const float* scales;                 // (L, n, 1, H, 1)
  int n_phys;
  unsigned n, n_heads, hd, vpr, n_chunks;  // vpr: 16-byte vectors a head row
  unsigned page_elems, n_items;        // n_items = L * n * n_chunks
  int stage_bytes, scale_off;          // a stage: header, codes, scale slots
};

// A stage's header, written by the producer lane holding the chunk before
// its arrival on the stage's full mbarrier.
struct StageHeader {
  long long dst;                       // the chunk's first output element
  int nv;                              // its 16-byte output vectors; -1: done
  int col0;                            // its first vector's column in its head row
  int shift;                           // its codes' offset in the stage
};

// 4 or 8 bytes global -> shared, not bulk (either address may sit off a
// 16-byte boundary).
template <int kBytes>
__device__ __forceinline__ void cp_async_small(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(src), "n"(kBytes)
               : "memory");
}

// The mbarrier `bar` counts one arrival of this thread once its earlier
// cp.async copies have landed (`.noinc`: the arrival is one of the count the
// barrier was initialised with).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// Work item w as the producer lane that evaluates it sees it: staged page
// l * n + i, its first code, its target page id, and whether it writes
// (its id is not followed by the same id); the header's vectors and first
// column; the chunk's first head (mod H) and scale slots.
struct Chunk {
  unsigned page, e0;
  int id, nv, col0, h0, n_slots;
  bool writes;
};

template <typename T>
__device__ __forceinline__ Chunk chunk_of(const Q8ScatterArgs& a, unsigned w) {
  constexpr int kVec = 16 / sizeof(T);
  Chunk ch;
  ch.page = w / a.n_chunks;
  ch.e0 = (w - ch.page * a.n_chunks) * kChunkCodes;
  const unsigned i = ch.page % a.n;
  ch.id = __ldg(a.ids + i);
  ch.writes = i + 1 == a.n || __ldg(a.ids + i + 1) != ch.id;
  ch.nv = (int)min(a.page_elems - ch.e0, (unsigned)kChunkCodes) / kVec;
  ch.col0 = (int)(ch.e0 / kVec % a.vpr);
  ch.n_slots = min((int)a.n_heads, (int)((ch.col0 + ch.nv - 1) / a.vpr) + 1);
  ch.h0 = (int)(ch.e0 / a.hd % a.n_heads);
  return ch;
}

// The producer warp.  Its lanes evaluate the CTA's next 32 items at once
// (item w0 + lane * grid), and the warp fills stage f % kStages with the
// CTA's f-th writing chunk, in item order; at the end a header with nv =
// -1.
template <typename T>
__device__ __forceinline__ void produce(const Q8ScatterArgs& a,
                                        unsigned char* ring, uint64_t* full,
                                        uint64_t* empty) {
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x;
  const int H = (int)a.n_heads;
  int f = 0;
  auto stage_of = [&](int f) {          // the stage, once its last chunk was read
    const int s = f % kStages;
    if (f >= kStages) {
      hopper::mbar_wait(hopper::smem_addr(&empty[s]), (f / kStages - 1) & 1);
      hopper::fence_proxy_async();
    }
    return s;
  };
  for (unsigned w0 = blockIdx.x; w0 < a.n_items; w0 += 32 * gridDim.x) {
    const unsigned w = w0 + lane * gridDim.x;
    Chunk mine{};
    if (w < a.n_items) mine = chunk_of<T>(a, w);
    for (unsigned m = __ballot_sync(~0u, w < a.n_items && mine.writes); m;
         m &= m - 1, ++f) {
      const int j = __ffs(m) - 1;           // the lane holding the chunk
      const unsigned page = __shfl_sync(~0u, mine.page, j);
      const unsigned e0 = __shfl_sync(~0u, mine.e0, j);
      const int nb = __shfl_sync(~0u, mine.nv, j) * kVec;
      const int h0 = __shfl_sync(~0u, mine.h0, j);
      const int n_slots = __shfl_sync(~0u, mine.n_slots, j);
      const int s = stage_of(f);
      unsigned char* stage = ring + s * a.stage_bytes;
      const uint32_t st = hopper::smem_addr(stage);
      const uint32_t bar = hopper::smem_addr(&full[s]);
      const int8_t* src = a.q + (size_t)page * a.page_elems + e0;
      const int shift = (int)(reinterpret_cast<uintptr_t>(src) & 15);
      const int head = min(nb, (16 - shift) & 15);  // bytes before the body
      const int body = (nb - head) & ~15;
      const int tail = nb - head - body;
      const uint32_t codes = st + kHeaderBytes + shift;
      if (lane == j) {
        StageHeader* hdr = reinterpret_cast<StageHeader*>(stage);
        hdr->dst = ((long long)(page / a.n) * a.n_phys + mine.id) *
                       a.page_elems + e0;
        hdr->nv = mine.nv;
        hdr->col0 = mine.col0;
        hdr->shift = shift;
        hopper::mbar_expect_tx(bar, body);
        if (body > 0) hopper::bulk_load(codes + head, src + head, body, bar);
      }
      // the ends, a vector of codes a lane (at most three at each end)
      const int hv = head / kVec, tv = tail / kVec;
      if (lane < hv) {
        cp_async_small<kVec>(codes + lane * kVec, src + lane * kVec);
      } else if (lane < hv + tv) {
        const int o = head + body + (lane - hv) * kVec;
        cp_async_small<kVec>(codes + o, src + o);
      }
      // slot k: the scale of the chunk's head row k (mod H)
      const float* sc = a.scales + (size_t)page * H;
      for (int k = lane; k < n_slots; k += 32) {
        int h = h0 + k;
        if (h >= H) h -= H;
        cp_async_small<4>(st + a.scale_off + 4 * k, sc + h);
      }
      cp_async_arrive(bar);
    }
  }
  const int s = stage_of(f);
  const uint32_t bar = hopper::smem_addr(&full[s]);
  if (lane == 0) {
    reinterpret_cast<StageHeader*>(ring + s * a.stage_bytes)->nv = -1;
    hopper::mbar_arrive(bar);
  }
  cp_async_arrive(bar);
}

template <typename T>
__global__ void __launch_bounds__(32 * (1 + kConsumerWarps), kCtasPerSm)
scatter_q8_kernel(const Q8ScatterArgs a) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the holding lane's expect_tx arrival and the producer's 32 lanes'
      // cp.async arrivals
      hopper::mbar_init(hopper::smem_addr(&full[s]), 1 + 32);
      hopper::mbar_init(hopper::smem_addr(&empty[s]), kConsumerWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    produce<T>(a, ring, full, empty);
    return;
  }

  const int t = threadIdx.x - 32;
  const int vpr = (int)a.vpr;
  const int H = (int)a.n_heads;
  // a step of kConsumerThreads vectors: dc columns and dr head rows (dk
  // slots), plus one row when the column wraps
  const int dr = kConsumerThreads / vpr, dc = kConsumerThreads % vpr;
  const int dk = dr % H;
  T* pages = reinterpret_cast<T*>(a.pages);
  for (int f = 0;; ++f) {
    const int s = f % kStages;
    const unsigned char* stage = ring + s * a.stage_bytes;
    hopper::mbar_wait(hopper::smem_addr(&full[s]), (f / kStages) & 1);
    const StageHeader hdr = *reinterpret_cast<const StageHeader*>(stage);
    if (hdr.nv < 0) break;
    const CodeWord<T>* codes =
        reinterpret_cast<const CodeWord<T>*>(stage + kHeaderBytes + hdr.shift);
    const float* slot = reinterpret_cast<const float*>(stage + a.scale_off);
    int c = hdr.col0 + t;
    const int r = c / vpr;
    c -= r * vpr;
    int k = r % H;
    uint4* out = reinterpret_cast<uint4*>(pages + hdr.dst);
#pragma unroll 4
    for (int v = t; v < hdr.nv; v += kConsumerThreads) {
      const float scale = slot[k];
      const CodeWord<T> word = codes[v];
      const int8_t* cv = reinterpret_cast<const int8_t*>(&word);
      uint4 raw;
      T* x = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        x[e] = from_float<T>(static_cast<float>(cv[e]) * scale);
      }
      out[v] = raw;
      c += dc;
      k += dk;
      if (c >= vpr) {
        c -= vpr;
        ++k;
      }
      if (k >= H) k -= H;
    }
    __syncwarp();
    if ((t & 31) == 0) hopper::mbar_arrive(hopper::smem_addr(&empty[s]));
  }
}

template <typename T>
cudaError_t launch(void* pages, const int* ids, const void* q,
                   const void* scales, int L, int n_phys, int n, int page_size,
                   int n_heads, int hd, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (hd % kVec != 0 || page_size < 0) return cudaErrorInvalidValue;
  if (page_size == 0) return cudaSuccess;
  Q8ScatterArgs a;
  a.pages = static_cast<char*>(pages);
  a.ids = ids;
  a.q = static_cast<const int8_t*>(q);
  a.scales = static_cast<const float*>(scales);
  const long long page_elems = (long long)page_size * n_heads * hd;
  const long long n_chunks = (page_elems + kChunkCodes - 1) / kChunkCodes;
  const long long n_items = (long long)L * n * n_chunks;
  if (page_elems >= (1ll << 31) || n_items >= (1ll << 31)) {
    return cudaErrorInvalidValue;      // more than the card could hold
  }
  a.n_phys = n_phys;
  a.n = n;
  a.n_heads = n_heads;
  a.hd = hd;
  a.vpr = hd / kVec;
  a.page_elems = (unsigned)page_elems;
  a.n_chunks = (unsigned)n_chunks;
  a.n_items = (unsigned)n_items;
  // a chunk's vectors span at most this many head rows
  const int vpr = hd / kVec;
  const long long rows = (kChunkCodes / kVec + vpr - 2) / vpr + 1;
  const int max_slots = (int)(rows < n_heads ? rows : n_heads);
  a.scale_off = kHeaderBytes + kChunkCodes + 16;
  a.stage_bytes = (a.scale_off + 4 * max_slots + 127) / 128 * 128;
  const int smem = kStages * a.stage_bytes;
  int grid = 0;
  const cudaError_t err =
      hopper::persistent_grid(scatter_q8_kernel<T>, 32 * (1 + kConsumerWarps),
                              smem, kCtasPerSm, a.n_items, &grid);
  if (err != cudaSuccess) return err;
  scatter_q8_kernel<T><<<grid, 32 * (1 + kConsumerWarps), smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace swap

extern "C" int swap_scatter_pages_q8(void* pages, const void* ids,
                                     const void* q, const void* scales, int L,
                                     int n_phys, int n, int page_size,
                                     int n_heads, int hd, int dtype,
                                     void* stream) {
  if (n_heads <= 0 || hd <= 0 || L < 0 || n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (L == 0 || n == 0) return 0;
  const int* id = static_cast<const int*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case swap::kFloat32:
      return (int)swap::launch<float>(pages, id, q, scales, L, n_phys, n,
                                      page_size, n_heads, hd, s);
    case swap::kBFloat16:
      return (int)swap::launch<__nv_bfloat16>(pages, id, q, scales, L, n_phys,
                                              n, page_size, n_heads, hd, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
