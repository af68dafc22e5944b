// The bf16 chunked-prefill attention body on Hopper's tensor cores, shared
// by chunked_prefill_attention (dense cache) and paged_prefill_attention
// (split and fused page pools).  The f32 path and the decode kernels keep
// the CUDA-core body of paged_attention_common.cuh.
//
// What bounds it.  Each query row does 4 * keys * hd FLOPs against K/V
// bytes that the function reads once per kv head, so a short chunk over a
// long prefix is bound by bytes and a long chunk by tensor-core operations.
// The design against both:
//   - One CTA (one warpgroup, 128 threads) per (sequence, kv head, tile of
//     64 packed rows).  Rows are packed position-major as (query position i,
//     head g of the kv head's group): row i * group + g.  A K/V tile is
//     staged once per kv head, not once per query head.
//   - K and V stay bf16 in shared memory, 64 keys to a tile, in a ring of
//     kStages tiles filled by 16-byte cp.async copies (zero-filled past the
//     last key the CTA needs), so the next tiles load while this one
//     computes.  Keys are read one by one through a row function: the dense
//     cache's strides, or the block table row, which the CTA reads itself.
//     Both land in the same swizzled layout, so the dense and the paged
//     kernels compute the same values bit for bit.
//   - S = Q K^T on wgmma (m64n64k16, Q and K both K-major from shared
//     memory), f32 accumulators; the 1/sqrt(hd) scale (times log2 e, for
//     exp2) is applied to S in f32 after the product, which is exact
//     input by input: bf16 x bf16 products are exact in f32.
//   - f32 online softmax per row (m, l), as the CUDA-core body: masked keys
//     score -inf against a finite running max, so they weigh exactly 0; a
//     NaN score of a valid key is dropped by the max but reaches l and the
//     output, which the engine's NaN guard reads.
//   - O += P V on wgmma with P from registers (the S accumulator's layout is
//     the A fragment's) and V MN-major from shared memory.  P is split into
//     P_hi = bf16(P) and P_lo = bf16(P - P_hi), two wgmma into one f32
//     accumulator: P_hi + P_lo is P within 2^-17 |P|, so the output is
//     within about 2^-17 sum(p |v|) / l of the f32 product -- under the 1e-5
//     floor of the kernels' bf16 gate -- where a single bf16 P (2^-9
//     relative) misses that gate at outputs near 0.
//   - A tile past every live row's causal bound or past kv_len is never
//     loaded (the TPU kernel's whole-tile skip), nor, under a sliding
//     window (the Span template argument), a tile wholly below every live
//     row's window: the walk starts at the tile of the first row's first
//     key.  Tiles that every live row sees whole skip the per-element
//     mask.
#pragma once

#include "hopper_common.cuh"
#include "paged_attention_common.cuh"

namespace paged {
namespace wg {

constexpr int kRows = 64;       // packed query rows per CTA: one warpgroup
constexpr int kKeys = 64;       // keys per K/V tile
constexpr int kStages = 3;      // K/V tiles in flight
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: the Q tile, then kStages (K tile, V tile) pairs; each tile
// is 64 rows x HD bf16 in the swizzled layout (HD / 64 column blocks of
// 8 KB), 1024-byte aligned.
template <int HD>
struct Smem {
  static constexpr int kTile = 64 * HD * 2;
  static constexpr int kBytes = kTile * (1 + 2 * kStages) + 1024;  // + align
  __device__ static uint32_t k(uint32_t base, int s) {
    return base + kTile * (1 + 2 * s);
  }
  __device__ static uint32_t v(uint32_t base, int s) {
    return base + kTile * (2 + 2 * s);
  }
};

// Stage keys [tile_start, tile_start + kKeys) of one kv head: key pos's K
// row at k + row(pos) and V row at v + row(pos), HD contiguous bf16 each.
// Thread t copies 16-byte chunk t % (HD / 8) of rows t / (HD / 8), + 128 /
// (HD / 8), ...; keys at or past n_keys are zero-filled without a read.
template <int HD, typename Row>
__device__ __forceinline__ void load_kv_tile_async(
    uint32_t k_s, uint32_t v_s, const __nv_bfloat16* k,
    const __nv_bfloat16* v, Row row, int tile_start, int n_keys) {
  constexpr int kChunks = HD / 8;
  const int chunk = threadIdx.x % kChunks;
#pragma unroll
  for (int r = threadIdx.x / kChunks; r < kKeys; r += kThreads / kChunks) {
    const int pos = tile_start + r;
    const bool ok = pos < n_keys;
    const size_t off = ok ? row(pos) + chunk * 8 : 0;
    const uint32_t dst = hopper::swizzled_offset(r, chunk);
    hopper::cp_async16(k_s + dst, k + off, ok ? 16 : 0);
    hopper::cp_async16(v_s + dst, v + off, ok ? 16 : 0);
  }
}

// The attention of one CTA's packed rows [row0, row0 + 64) of sequence b,
// kv head kv_head, over the keys staged through (k, v, row); kv_len is the
// sequence's valid length, clipped to what the cache holds; a row at
// position pos sees keys span.lo(pos) .. pos.
template <int HD, typename Row, typename Span = Causal>
__device__ __forceinline__ void prefill_rows(
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
    const __nv_bfloat16* k, const __nv_bfloat16* v, Row row, int b,
    int kv_head, int row0, int Sq, int n_q_heads, int group, int kv_len,
    int q_off, float scale_log2, Span span = Span{}) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows = min(kRows, Sq * group - row0);            // live rows
  const int pos_first = q_off + row0 / group;
  const int pos_last = q_off + (row0 + rows - 1) / group;
  const int n_keys = max(0, min(kv_len, pos_last + 1));       // any row sees
  const int full_keys = max(0, min(kv_len, pos_first + 1));   // every row sees
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;
  // below every row's window: tiles before t0 are skipped; keys below
  // lo_last are not seen by every row
  const int t0 = Span::kWindowed ? min(span.lo(pos_first), n_keys) / kKeys : 0;
  const int lo_last = span.lo(pos_last);
  auto q_row = [&](int r) {   // packed row r of this CTA in q and out
    const int p = row0 + r;
    return (((size_t)b * Sq + p / group) * n_q_heads + kv_head * group +
            p % group) * HD;
  };

  // Q (rows past the live ones zero-filled) joins the first tile's group
  {
    constexpr int kChunks = HD / 8;
    const int chunk = threadIdx.x % kChunks;
#pragma unroll
    for (int r = threadIdx.x / kChunks; r < kRows; r += kThreads / kChunks) {
      const bool ok = r < rows;
      hopper::cp_async16(base + hopper::swizzled_offset(r, chunk),
                         q + (ok ? q_row(r) + chunk * 8 : 0), ok ? 16 : 0);
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (t0 + s < n_tiles) {
      load_kv_tile_async<HD>(Smem<HD>::k(base, s), Smem<HD>::v(base, s), k,
                             v, row, (t0 + s) * kKeys, n_keys);
    }
    hopper::cp_async_commit();
  }

  // this thread's two rows of every accumulator: r_lo and r_lo + 8
  const int r_lo = warp * 16 + lane / 4;
  bool live[2];
  int pos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    live[i] = r_lo + 8 * i < rows;
    pos[i] = q_off + (row0 + r_lo + 8 * i) / group;
  }
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // l: this thread's part

  for (int t = t0; t < n_tiles; ++t) {
    hopper::cp_async_wait<kStages - 2>();   // tile t (and Q) has landed
    hopper::fence_proxy_async();
    __syncthreads();   // ... for every thread, and tile t - 1 is done
    {
      const int nt = t + kStages - 1;
      if (nt < n_tiles) {
        const int s = (nt - t0) % kStages;
        load_kv_tile_async<HD>(Smem<HD>::k(base, s), Smem<HD>::v(base, s), k,
                               v, row, nt * kKeys, n_keys);
      }
      hopper::cp_async_commit();
    }
    const uint32_t k_s = Smem<HD>::k(base, (t - t0) % kStages);
    const uint32_t v_s = Smem<HD>::v(base, (t - t0) % kStages);

    // S = Q K^T
    float s[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
      hopper::mma_ss_n64<0>(s, hopper::desc(base + off, 16, 1024),
                            hopper::desc(k_s + off, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(s);

    // online softmax: s becomes p
    const int tile_start = t * kKeys;
    const bool masked = tile_start + kKeys > full_keys ||
                        (Span::kWindowed && tile_start < lo_last);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[4 * j + 2 * i + e] * scale_log2;
          if (masked) {
            const int key = tile_start + 8 * j + 2 * (lane % 4) + e;
            if (!(live[i] && key <= pos[i] && key < kv_len &&
                  (!Span::kWindowed || key >= span.lo(pos[i])))) {
              x = __uint_as_float(0xff800000u);   // -inf
            }
          }
          s[4 * j + 2 * i + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[4 * j + 2 * i + e] - mx);
          s[4 * j + 2 * i + e] = p;
          sum += p;
        }
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j + 2 * i] *= alpha;
        o[4 * j + 2 * i + 1] *= alpha;
      }
    }

    // O += P_hi V + P_lo V
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = s[8 * kb + 2 * r], c = s[8 * kb + 2 * r + 1];
        const __nv_bfloat16 ah = __float2bfloat16(a), ch = __float2bfloat16(c);
        hi[kb][r] =
            hopper::pack_bf16(__bfloat162float(ah), __bfloat162float(ch));
        lo[kb][r] = hopper::pack_bf16(a - __bfloat162float(ah),
                                      c - __bfloat162float(ch));
      }
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      const uint64_t vd = hopper::desc(v_s + kb * 2048, 8192, 1024);
      if constexpr (HD == 64) {
        hopper::mma_rs_n64<1>(o, hi[kb], vd, 1);
        hopper::mma_rs_n64<1>(o, lo[kb], vd, 1);
      } else {
        hopper::mma_rs_n128<1>(o, hi[kb], vd, 1);
        hopper::mma_rs_n128<1>(o, lo[kb], vd, 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(o);
  }
  hopper::cp_async_wait<0>();

  // normalise and store: l != 0, not l > 0, so a NaN row stores NaN; a row
  // with no valid key stores 0
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    if (!live[i]) continue;
    __nv_bfloat16* dst = out + q_row(r_lo + 8 * i) + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const float a = lt != 0.f ? o[4 * j + 2 * i] / lt : 0.f;
      const float c = lt != 0.f ? o[4 * j + 2 * i + 1] / lt : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(a, c);
    }
  }
}

}  // namespace wg
}  // namespace paged
