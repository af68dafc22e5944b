// K/V staging for the f32 chunked prefill over a dense per-sequence cache
// (B, S, Hkv, HD), on CUDA cores.  Everything after the staging -- the
// query load, the online-softmax step over a tile and the normalisation --
// is the paged prefill kernels' (paged_attention_common.cuh), so the dense
// kernel stages the same f32 tile as the paged kernel does from the same
// keys laid into pages, and returns its output bit for bit.  (The bf16
// chunked prefill stages its keys through prefill_wgmma.cuh, as the bf16
// paged prefill does; the decode kernels run decode_splitk.cuh.)
#pragma once

#include "paged_attention_common.cuh"

namespace paged {

// Where one sequence's K and V rows of one kv head live in a dense cache:
// key `pos` starts at k + pos * row_stride (and v + pos * row_stride), HD
// contiguous elements.  The cache may be a strided view -- the engine passes
// cache[:, :-1], which drops each slot's padding sink row, so the batch
// stride is (S + 1) * Hkv * HD -- and the kernel never asks for a copy.
template <typename T>
struct DenseKV {
  const T* k;
  const T* v;
  size_t row_stride;
};

// Sequence b's K/V rows of kv head `kv_head` in caches whose batch and key
// strides are `batch_stride` and `row_stride` elements.
template <typename T>
__device__ __forceinline__ DenseKV<T> dense_kv(const T* k_cache,
                                               const T* v_cache, int b,
                                               int kv_head, int hd,
                                               long long batch_stride,
                                               long long row_stride) {
  const size_t base = (size_t)b * batch_stride + (size_t)kv_head * hd;
  return {k_cache + base, v_cache + base, (size_t)row_stride};
}

// Stage keys [tile_start, tile_start + kTileK) into shared memory as f32,
// as load_kv_tile does from a page pool: thread i loads the 16-byte vector c
// of a key's K row and the same vector of its V row, neighbouring threads
// on neighbouring vectors.  Keys at or past `n_keys` are not read and stage
// as zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_dense_kv_tile(float (*ks)[HD + 1],
                                                   float (*vs)[HD],
                                                   const DenseKV<T>& kv,
                                                   int tile_start, int n_keys) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = HD / kVec;
  for (int i = threadIdx.x; i < kTileK * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    const int pos = tile_start + r;
    uint4 kraw = make_uint4(0u, 0u, 0u, 0u);
    uint4 vraw = kraw;
    if (pos < n_keys) {
      const size_t off = (size_t)pos * kv.row_stride + c;
      kraw = __ldg(reinterpret_cast<const uint4*>(kv.k + off));
      vraw = __ldg(reinterpret_cast<const uint4*>(kv.v + off));
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

}  // namespace paged
