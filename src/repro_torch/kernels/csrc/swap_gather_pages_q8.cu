// KV page gather fused with symmetric INT8 quantization, for Hopper
// (sm_90a): the swap-out and handoff export of the INT8 host tier
// (host_kv_dtype="int8").
//
// Replaces the TPU kernel `swap_gather_pages_q8` (src/repro/kernels/swap.py:162,
// pallas_call at :179).  For page ids[i] of layer l it writes
//   scale[h] = absmax over (s, d) of |x[s, h, d]| / 127          (f32)
//   q[s, h, d] = clip(round_half_even(x / safe[h]), -127, 127)   (int8)
// with safe[h] = scale[h], or 1 where the head is all zero (scale 0), into
// q (L, n, page_size, H, hd) and scales (L, n, 1, H, 1): bit for bit the
// plain version's codes and scales (IEEE division, round half to even, no
// fast math).
//
// Bound on an H100: bytes.  It reads each distinct page once and writes
// half (bf16) or a quarter (f32) of L * n pages as codes, plus 4 * H bytes
// of scales per page; a few operations per element, far below any peak.
// But each element's IEEE division compiles to about a dozen instructions
// (a quarter-rate reciprocal, a check and a convergence barrier around a
// slow path), so the quantization, not the memory, sets the kernel's time.
// The design:
// - A work item is (layer, page, head block): page_size rows of h_blk * hd
//   contiguous elements, one row per token.  One thread loads the item into
//   a stage of a kStages-deep ring in shared memory by `cp.async.bulk`
//   copies completing on the stage's mbarrier: one copy when the block is
//   the whole page (it is contiguous), else one per row.  h_blk is the most
//   heads whose rows fit kStageBytes (at least one), so a stage stays
//   bounded whatever H is.  Each input byte comes from device memory once.
// - A warp per head, from shared memory: its absmax (a running fmaxf per
//   lane and a shuffle reduction; fmaxf is exact and order-free, so the
//   scale is bitwise the plain version's), then its codes from the same
//   tile, 16 per thread and one 16-byte store (8 or 4 bytes when hd is not
//   a multiple of 16).  Lane 0 writes the scale.
// - Persistent CTAs (as many as fit at once, at most kCtasPerSm a SM) walk
//   the items b, b + grid, ...; while one item is quantized, the next
//   kStages - 1 load.  Each load is issued as the item before it lands, so
//   a CTA keeps kStages - 1 loads in flight and items land one after
//   another rather than all at the end of one burst.  Rows for repeated ids
//   (the engine's sink padding) are written like any other; their pages
//   come mostly from L2.
// A head whose page_size * hd elements exceed kMaxStageBytes cannot stage
// kStages-deep in shared memory; such shapes (none that the engine builds)
// take gather_q8_two_pass_kernel, which reads the page twice, the second
// time mostly from L2, a CTA per block of kHeadBlock heads.  Both kernels
// take any H.
#include "hopper_common.cuh"
#include "swap_pages_common.cuh"

namespace swap {

constexpr int kQ8Threads = 256;        // 8 warps
constexpr int kStageBytes = 32768;     // a stage holds this many bytes of heads
constexpr int kStages = 2;
constexpr int kMaxStageBytes = 110592; // one head's rows at most
constexpr int kCtasPerSm = 3;
constexpr int kHeadBlock = 256;        // heads a two-pass CTA takes
static_assert(kStages * kMaxStageBytes + 1024 <= 232448,
              "the ring fits a CTA's shared memory on an H100");

struct Q8Args {
  const char* pages;                   // (L, n_phys, page_size, H, hd)
  const int* ids;                      // (n,)
  int8_t* q;                           // (L, n, page_size, H, hd)
  float* scales;                       // (L, n, 1, H, 1)
  int n_phys, n, page_size, n_heads, hd, h_blk, n_hblk, stage_bytes;
  long long n_items;                   // L * n * n_hblk
};

// The item w = (l * n + i) * n_hblk + hb: page l * n + i of the output,
// heads [h0, h0 + nh).
struct Item {
  long long page;
  int i, h0, nh;
};

__device__ __forceinline__ Item item_of(const Q8Args& a, long long w) {
  Item it;
  const int hb = (int)(w % a.n_hblk);
  it.page = w / a.n_hblk;
  it.i = (int)(it.page % a.n);
  it.h0 = hb * a.h_blk;
  it.nh = min(a.h_blk, a.n_heads - it.h0);
  return it;
}

// Thread 0: load item w into the stage at `dst`, completing on `bar`.
template <typename T>
__device__ __forceinline__ void load_item(const Q8Args& a, long long w,
                                          uint32_t dst, uint32_t bar) {
  const Item it = item_of(a, w);
  const long long l = it.page / a.n;
  const long long row = (long long)a.n_heads * a.hd;         // elements
  const T* src = reinterpret_cast<const T*>(a.pages) +
                 ((l * a.n_phys + __ldg(a.ids + it.i)) * a.page_size) * row +
                 (long long)it.h0 * a.hd;
  const uint32_t row_bytes = (uint32_t)(it.nh * a.hd * sizeof(T));
  hopper::mbar_expect_tx(bar, row_bytes * a.page_size);
  if (it.nh == a.n_heads) {                 // the whole page: contiguous
    hopper::bulk_load(dst, src, row_bytes * a.page_size, bar);
  } else {
    for (int s = 0; s < a.page_size; ++s) {
      hopper::bulk_load(dst + s * row_bytes, src + s * row, row_bytes, bar);
    }
  }
}

// kCodes int8 codes, packed four to a word, stored as one kCodes-byte word.
template <int kCodes>
__device__ __forceinline__ void store_codes(int8_t* dst,
                                            const uint32_t (&p)[kCodes / 4]) {
  if constexpr (kCodes == 16) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(p[0], p[1], p[2], p[3]);
  } else if constexpr (kCodes == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(p[0], p[1]);
  } else {
    static_assert(kCodes == 4, "16, 8 or 4 codes a store");
    *reinterpret_cast<uint32_t*>(dst) = p[0];
  }
}

// Four int8 codes (the low bytes of c0..c3) as one word, c0 lowest.
__device__ __forceinline__ uint32_t pack4(int c0, int c1, int c2, int c3) {
  return __byte_perm(__byte_perm(c0, c1, 0x0040), __byte_perm(c2, c3, 0x0040),
                     0x5410);
}

// A walk over the (row, column) cells of a head's rows, lane by lane: cell
// lane, lane + 32, ... of `per_row` cells a row, stepped without dividing.
struct Walk {
  int r0, c0, dr, dc, per_row;
  __device__ __forceinline__ Walk(int lane, int per_row_)
      : r0(lane / per_row_), c0(lane % per_row_), dr(32 / per_row_),
        dc(32 % per_row_), per_row(per_row_) {}
  __device__ __forceinline__ void step(int& r, int& c) const {
    c += dc;
    r += dr;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
};

template <typename T, int kCodes>
__global__ void __launch_bounds__(kQ8Threads, kCtasPerSm)
gather_q8_kernel(const Q8Args a) {
  constexpr int kVec = 16 / sizeof(T);           // elements per 16 bytes
  constexpr int kWarps = kQ8Threads / 32;
  static_assert(kCodes % kVec == 0, "codes of whole 16-byte vectors");
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[kStages];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t ring0 = hopper::smem_addr(ring);
  const long long grid = gridDim.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(hopper::smem_addr(&bars[s]), 1);
    hopper::mbar_init_fence();
    for (int s = 0; s < kStages - 1; ++s) {
      const long long w = blockIdx.x + s * grid;
      if (w < a.n_items) {
        load_item<T>(a, w, ring0 + s * a.stage_bytes, hopper::smem_addr(&bars[s]));
      }
    }
  }
  __syncthreads();

  const Walk vecs(lane, a.hd / kVec);            // 16-byte vectors of a row
  const Walk groups(lane, a.hd / kCodes);        // groups of kCodes codes
  const long long page_elems = (long long)a.page_size * a.n_heads * a.hd;
  const long long q_row = (long long)a.n_heads * a.hd;
  int k = 0;
  for (long long w = blockIdx.x; w < a.n_items; w += grid, ++k) {
    const int s = k % kStages;
    const Item it = item_of(a, w);
    const int row_elems = it.nh * a.hd;          // a row of the tile
    const T* tile = reinterpret_cast<const T*>(ring + s * a.stage_bytes);
    int8_t* q_blk = a.q + it.page * page_elems + (long long)it.h0 * a.hd;
    hopper::mbar_wait(hopper::smem_addr(&bars[s]), (k / kStages) & 1);
    // item k + kStages - 1 into the stage item k - 1 left (every warp is
    // past it): issued as item k lands, so that each CTA keeps kStages - 1
    // loads in flight and the items land one after another, not all at the
    // end of one burst
    if (tid == 0 && w + (kStages - 1) * grid < a.n_items) {
      const int next = (k + kStages - 1) % kStages;
      hopper::fence_proxy_async();      // our reads before the async refill
      load_item<T>(a, w + (kStages - 1) * grid, ring0 + next * a.stage_bytes,
                   hopper::smem_addr(&bars[next]));
    }

    // a warp per head: its absmax, then its codes, both from shared memory
    for (int hl = warp; hl < it.nh; hl += kWarps) {
      const T* head = tile + hl * a.hd;
      float m = 0.f;
      for (int r = vecs.r0, c = vecs.c0; r < a.page_size; vecs.step(r, c)) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(head + r * row_elems + c * kVec);
        const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < kVec; ++e) m = fmaxf(m, fabsf(to_float(x[e])));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      }
      const float scale = m / 127.f;
      if (lane == 0) a.scales[it.page * a.n_heads + it.h0 + hl] = scale;
      const float safe = scale > 0.f ? scale : 1.f;

      int8_t* q_head = q_blk + hl * a.hd;
      for (int r = groups.r0, c = groups.c0; r < a.page_size;
           groups.step(r, c)) {
        const T* src = head + r * row_elems + c * kCodes;
        uint32_t packed[kCodes / 4];
#pragma unroll
        for (int v = 0; v < kCodes / kVec; ++v) {
          const uint4 raw = *reinterpret_cast<const uint4*>(src + v * kVec);
          const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int t = 0; t < kVec; t += 4) {
            packed[(v * kVec + t) / 4] = pack4(
                quantize(to_float(x[t]), safe), quantize(to_float(x[t + 1]), safe),
                quantize(to_float(x[t + 2]), safe),
                quantize(to_float(x[t + 3]), safe));
          }
        }
        store_codes<kCodes>(q_head + r * q_row + c * kCodes, packed);
      }
    }
    __syncthreads();                    // every warp is done with stage s
  }
}

// Shapes whose head does not fit a stage: one CTA per (page, block of up to
// kHeadBlock heads, layer), its heads' rows read twice.  Pass 1 keeps a
// running |x| max per thread for the head it is on and folds it into the
// head's shared max with atomicMax on the float's bits (valid: every value
// is >= 0); pass 2 reads the rows again and writes the codes, 8 (bf16) or 4
// (f32) per store.  Blocking the heads keeps the shared arrays fixed
// whatever H is; with H <= kHeadBlock a CTA takes the whole page.
template <typename T>
__global__ void __launch_bounds__(kThreads) gather_q8_two_pass_kernel(
    const T* __restrict__ pages,       // (L, n_phys, page_size, H, hd)
    const int* __restrict__ ids,       // (n,)
    int8_t* __restrict__ q,            // (L, n, page_size, H, hd)
    float* __restrict__ scales,        // (L, n, 1, H, 1)
    int n_phys, int n, int page_size, int n_heads, int hd, int n_hblk) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ unsigned amax_bits[kHeadBlock];
  __shared__ float safe_s[kHeadBlock];

  const int i = blockIdx.x / n_hblk, l = blockIdx.y;
  const int h0 = (blockIdx.x % n_hblk) * kHeadBlock;
  const int nh = min(kHeadBlock, n_heads - h0);
  const int id = __ldg(ids + i);
  const size_t page_elems = (size_t)page_size * n_heads * hd;
  const int head_vecs = hd / kVec;
  const size_t row_vecs = (size_t)n_heads * head_vecs;  // a token's row
  const size_t blk_vecs = (size_t)nh * head_vecs;       // its heads h0.. of it
  const size_t n_vec = (size_t)page_size * blk_vecs;
  const size_t page_out = (size_t)l * n + i;
  // vector v of the block is vector (v % blk_vecs) of the block's part of
  // row v / blk_vecs
  const uint4* src = reinterpret_cast<const uint4*>(
                         pages + ((size_t)l * n_phys + id) * page_elems) +
                     (size_t)h0 * head_vecs;

  for (int h = threadIdx.x; h < nh; h += kThreads) amax_bits[h] = 0u;
  __syncthreads();

  int cur = -1;
  float m = 0.f;
  for (size_t v = threadIdx.x; v < n_vec; v += kThreads) {
    const size_t s = v / blk_vecs, c = v - s * blk_vecs;
    const int h = (int)(c / head_vecs);
    if (h != cur) {
      if (cur >= 0) atomicMax(&amax_bits[cur], __float_as_uint(m));
      cur = h;
      m = 0.f;
    }
    const uint4 raw = __ldg(src + s * row_vecs + c);
    const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < kVec; ++e) m = fmaxf(m, fabsf(to_float(x[e])));
  }
  if (cur >= 0) atomicMax(&amax_bits[cur], __float_as_uint(m));
  __syncthreads();

  for (int h = threadIdx.x; h < nh; h += kThreads) {
    const float scale = __uint_as_float(amax_bits[h]) / 127.f;
    scales[page_out * n_heads + h0 + h] = scale;
    safe_s[h] = scale > 0.f ? scale : 1.f;
  }
  __syncthreads();

  CodeWord<T>* dst = reinterpret_cast<CodeWord<T>*>(q + page_out * page_elems) +
                     (size_t)h0 * head_vecs;
  for (size_t v = threadIdx.x; v < n_vec; v += kThreads) {
    const size_t s = v / blk_vecs, c = v - s * blk_vecs;
    const float safe = safe_s[c / head_vecs];
    const uint4 raw = __ldg(src + s * row_vecs + c);
    const T* x = reinterpret_cast<const T*>(&raw);
    CodeWord<T> word;
    int8_t* code = reinterpret_cast<int8_t*>(&word);
#pragma unroll
    for (int e = 0; e < kVec; ++e) code[e] = quantize(to_float(x[e]), safe);
    dst[s * row_vecs + c] = word;
  }
}

template <typename T>
cudaError_t launch(const void* pages, const int* ids, void* q, void* scales,
                   int L, int n_phys, int n, int page_size, int n_heads, int hd,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (hd % kVec != 0 || page_size < 0) return cudaErrorInvalidValue;
  const long long col_bytes = (long long)page_size * hd * sizeof(T);
  if (col_bytes == 0 || col_bytes > kMaxStageBytes) {
    const int n_hblk = (n_heads + kHeadBlock - 1) / kHeadBlock;
    if (L > 65535 || (long long)n * n_hblk > 0x7fffffffLL) {
      return cudaErrorInvalidValue;
    }
    gather_q8_two_pass_kernel<T><<<dim3(n * n_hblk, L), kThreads, 0, stream>>>(
        static_cast<const T*>(pages), ids, static_cast<int8_t*>(q),
        static_cast<float*>(scales), n_phys, n, page_size, n_heads, hd, n_hblk);
    return cudaGetLastError();
  }
  Q8Args a;
  a.pages = static_cast<const char*>(pages);
  a.ids = ids;
  a.q = static_cast<int8_t*>(q);
  a.scales = static_cast<float*>(scales);
  a.n_phys = n_phys;
  a.n = n;
  a.page_size = page_size;
  a.n_heads = n_heads;
  a.hd = hd;
  const long long fit = kStageBytes / col_bytes;
  a.h_blk = (int)(fit < 1 ? 1 : (fit < n_heads ? fit : n_heads));
  a.n_hblk = (n_heads + a.h_blk - 1) / a.h_blk;
  a.stage_bytes = (int)(a.h_blk * col_bytes);
  a.n_items = (long long)L * n * a.n_hblk;
  const int smem = kStages * a.stage_bytes;
  // 16 codes a store where every head row holds whole groups of 16
  auto kernel = hd % 16 == 0 ? gather_q8_kernel<T, 16> : gather_q8_kernel<T, kVec>;
  int grid = 0;
  const cudaError_t err = hopper::persistent_grid(kernel, kQ8Threads, smem,
                                                  kCtasPerSm, a.n_items, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kQ8Threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace swap

extern "C" int swap_gather_pages_q8(const void* pages, const void* ids,
                                    void* q, void* scales, int L, int n_phys,
                                    int n, int page_size, int n_heads, int hd,
                                    int dtype, void* stream) {
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
