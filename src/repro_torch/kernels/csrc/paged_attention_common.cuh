// Shared pieces of the attention kernels: dtype codes and conversions, warp
// reductions, the KV pool layouts (KVPool), and the f32 chunked-prefill body
// on CUDA cores -- K/V tile staging through the block table, one
// online-softmax step over a staged tile, and the final normalisation.  The
// f32 prefill kernels (paged and dense) run this body; the bf16 prefill
// kernels run the tensor-core body of prefill_wgmma.cuh and the decode
// kernels the split-K body of decode_splitk.cuh.  The layouts differ only in
// where load_kv_tile reads a key's K and V (KVPool), so a fused kernel on
// fuse_pages(k, v) stages the same f32 tile as the split kernel on (k, v)
// and gives the same output bit for bit.
//
// A CTA owns ROWS query rows that all read ONE kv head.  It walks the
// sequence's keys kTileK at a time: the whole CTA stages the tile's K and V
// rows (looked up page by page through the block table, which the CTA reads
// itself) into shared memory as f32, each warp scores its rows against the
// tile with lane j holding key j, and the (m, l, acc) online-softmax state
// stays in registers.  Everything is f32 FMA on CUDA cores: exact enough to
// match the plain PyTorch version in f32 (TF32 would not be).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

constexpr int kThreads = 128;             // 4 warps per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kTileK = 32;                // keys per tile: one per lane
constexpr float kNegInf = -1e30f;         // finite, like the Pallas kernels

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);             // round to nearest even, as torch's cast
}

// Which keys below its own position a query at position pos sees: every
// one (Causal), or those of the last `window` positions, keys > pos -
// window (SlidingWindow).  The attention kernels take it as a template
// argument, so a windowed launch shows in a trace by its kernel's name;
// Causal's lower bound is the constant 0, so its instantiation is the
// kernel without a window.
struct Causal {
  static constexpr bool kWindowed = false;
  __device__ __forceinline__ int lo(int) const { return 0; }
};
struct SlidingWindow {
  static constexpr bool kWindowed = true;
  int window;
  __device__ __forceinline__ int lo(int pos) const {
    return max(0, pos - window + 1);
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Where kv head `kv_head`'s K and V rows live in a page pool.  Key row
// `row` (= page * page_size + pos % page_size) holds its K values at
// k + row * row_stride + k_head_off and its V values at
// v + row * row_stride + v_head_off, HD contiguous elements each.
//   split pools (n_pages, ps, Hkv, HD) x2: row_stride Hkv*HD, both offsets
//     kv_head*HD, k and v two pools;
//   fused pool (n_pages, ps, 2*Hkv, HD), heads [K0,V0,K1,V1,...]:
//     row_stride 2*Hkv*HD, K at head 2h and V at 2h+1, k == v -- so K_h and
//     V_h of one key are one contiguous 2*HD run.
template <typename T>
struct KVPool {
  const T* k;
  const T* v;
  size_t row_stride;
  int k_head_off;
  int v_head_off;
};

template <typename T, bool FUSED>
__device__ __forceinline__ KVPool<T> kv_pool(const T* k_pages,
                                             const T* v_pages, int n_kv_heads,
                                             int kv_head, int hd) {
  if (FUSED) {
    return {k_pages, k_pages, (size_t)2 * n_kv_heads * hd,
            2 * kv_head * hd, (2 * kv_head + 1) * hd};
  }
  return {k_pages, v_pages, (size_t)n_kv_heads * hd, kv_head * hd,
          kv_head * hd};
}

// Stage keys [tile_start, tile_start + kTileK) of one kv head into shared
// memory as f32.  Key `pos` lives at row pos % page_size of physical page
// table_row[pos / page_size].  Thread i loads the 16-byte vector c of the
// key's K row and the same vector of its V row, neighbouring threads on
// neighbouring vectors; in the fused pool the two rows are the halves of one
// contiguous 2*HD run, so a warp reads each key's K and V as that one run
// (the GPU's form of the TPU kernel's one DMA per page for K and V).  Keys
// at or past `n_keys` are not read and stage as zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_kv_tile(
    float (*ks)[HD + 1], float (*vs)[HD], const KVPool<T>& pool,
    const int* __restrict__ table_row, int tile_start, int n_keys,
    int page_size) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = HD / kVec;
  for (int i = threadIdx.x; i < kTileK * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    const int pos = tile_start + r;
    uint4 kraw = make_uint4(0u, 0u, 0u, 0u);
    uint4 vraw = kraw;
    if (pos < n_keys) {
      const int page = __ldg(table_row + pos / page_size);
      const size_t row =
          ((size_t)page * page_size + pos % page_size) * pool.row_stride + c;
      kraw = __ldg(
          reinterpret_cast<const uint4*>(pool.k + row + pool.k_head_off));
      vraw = __ldg(
          reinterpret_cast<const uint4*>(pool.v + row + pool.v_head_off));
    }
    const T* ke = reinterpret_cast<const T*>(&kraw);
    const T* ve = reinterpret_cast<const T*>(&vraw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      ks[r][c + j] = to_float(ke[j]);
      vs[r][c + j] = to_float(ve[j]);
    }
  }
}

// Load ROWS query rows (row r from q_row(r), or zeros where q_row gives
// nullptr) into shared memory, pre-scaled by 1/sqrt(hd) in f32.
template <typename T, int HD, int ROWS, typename QRow>
__device__ __forceinline__ void load_q(float (*qs)[HD], float scale, QRow q_row) {
  for (int i = threadIdx.x; i < ROWS * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const T* src = q_row(r);
    qs[r][d] = src ? to_float(src[d]) * scale : 0.f;
  }
}

// One online-softmax step of ROWS query rows over the staged tile.  Warp w
// scores rows w, w + kWarps, ...; lane j holds key j.  valid(r, j) is the
// causal / length mask.  Thread t then owns output column t % HD of rows
// t / HD, t / HD + kThreads / HD, ... and folds the tile's p @ V into acc.
// m and l are per owned score row, acc per owned output row.
template <int HD, int ROWS, typename Valid>
__device__ __forceinline__ void attend_tile(
    float (*qs)[HD], float (*ks)[HD + 1], float (*vs)[HD],
    float (*p_s)[kTileK], float* alpha_s, float* m, float* l, float* acc,
    Valid valid) {
  static_assert(ROWS % kWarps == 0, "rows must split evenly over warps");
  static_assert(kThreads % HD == 0 && ROWS % (kThreads / HD) == 0, "bad HD");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < ROWS / kWarps; ++i) {
    const int r = warp + kWarps * i;
    float s = 0.f;
#pragma unroll 16
    for (int d = 0; d < HD; ++d) s = fmaf(qs[r][d], ks[lane][d], s);
    const bool ok = valid(r, lane);
    s = ok ? s : kNegInf;
    const float m_new = fmaxf(m[i], warp_max(s));
    const float alpha = expf(m[i] - m_new);
    const float p = ok ? expf(s - m_new) : 0.f;
    l[i] = l[i] * alpha + warp_sum(p);
    m[i] = m_new;
    p_s[r][lane] = p;
    if (lane == 0) alpha_s[r] = alpha;
  }
  __syncthreads();
  constexpr int kRowStep = kThreads / HD;
  const int d = threadIdx.x % HD, r0 = threadIdx.x / HD;
#pragma unroll
  for (int i = 0; i < ROWS / kRowStep; ++i) {
    const int r = r0 + kRowStep * i;
    float a = acc[i] * alpha_s[r];
#pragma unroll
    for (int j = 0; j < kTileK; ++j) a = fmaf(p_s[r][j], vs[j][d], a);
    acc[i] = a;
  }
}

// Normalise and store: out_row(r) gives row r's output (nullptr = padding
// row, not stored).  A row that saw no valid key has l == 0 and stores 0.
// A non-finite key or value of a valid key reaches l or acc as NaN or Inf
// (fmaxf drops a NaN score from the running max, but its exp does not), and
// the test is l != 0, not l > 0, so such a row stores NaN, as the plain
// version does, and the engine's NaN guard sees it.
template <typename T, int HD, int ROWS, typename ORow>
__device__ __forceinline__ void finish_rows(const float* l, float* l_s,
                                            const float* acc, ORow out_row) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < ROWS / kWarps; ++i) l_s[warp + kWarps * i] = l[i];
  }
  __syncthreads();
  constexpr int kRowStep = kThreads / HD;
  const int d = threadIdx.x % HD, r0 = threadIdx.x / HD;
#pragma unroll
  for (int i = 0; i < ROWS / kRowStep; ++i) {
    const int r = r0 + kRowStep * i;
    T* dst = out_row(r);
    if (dst) dst[d] = from_float<T>(l_s[r] != 0.f ? acc[i] / l_s[r] : 0.f);
  }
}

}  // namespace paged
