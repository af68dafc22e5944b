// The decode attention body for Hopper (sm_90a), shared by decode_attention
// (a dense per-sequence cache) and paged_decode_attention(_fused) (split and
// fused page pools): one query token per sequence against its keys
// < kv_len, f32 online softmax with scale 1/sqrt(hd), query head h reading
// kv head h / (Hq / Hkv), a row with no valid key stored as 0.  The three
// kernels differ only in the KV struct (where a key's K and V rows live), so
// on the same keys they compute the same values bit for bit.
//
// What bounds it.  The function must read each live key's K and V once per
// kv head, 2 * hd * sizeof(T) bytes, against 4 * group * hd FLOPs.  At
// groups 1-8 that is a few FLOPs per byte: bytes bind.  At group 48 in bf16
// it is 48 FLOPs per byte, above the ~20 that f32 FMA on CUDA cores (67
// TFLOP/s) can do per byte of device memory (3.35 TB/s): there the products
// would bind on CUDA cores.  The design against both:
//   - Split-K (flash decoding).  A sequence's keys are cut into splits of
//     kSplitKeys; the grid is (split, kv head x row block, sequence), so a
//     small batch of long sequences fills the card (B = 4, Hkv = 8 over a
//     32k cache: 2,048 CTAs, where one CTA per (sequence, kv head) gave 32).
//     The split points depend only on the key index: the dense and the paged
//     kernels cut the same keys alike, whatever S, max_pages or B.  A CTA
//     whose split starts at or past kv_len exits.
//   - One CTA holds up to kMaxRows query heads of one kv head (ROWS = 16;
//     8 or 16 in f32), so each K/V tile is read from memory once per group
//     of up to 16; a larger group takes several row blocks in the grid (K/V
//     then read once per block: at granite-34b's group 48, three times, for
//     three times the CTAs).
//   - K and V stay in their dtype in shared memory: tiles of 64 bf16 (32
//     f32) keys in a ring of kStages, filled by 16-byte cp.async through the
//     key-to-row function and zero-filled past the split's last valid key,
//     so the next tiles load while this one computes (the paged kernels
//     stage the split's block-table entries in shared memory first, so no
//     copy waits on a table read).  Each key row is padded by 16 bytes: one
//     key's 16-byte chunk per lane, and ldmatrix, read shared memory
//     without bank conflicts.
//   - Products.  bf16 on mma.sync m16n8k16 (bf16 in, f32 accumulate) at
//     every group, the rows padded to 16: each warp takes a 16-key slice of
//     every tile with its own online softmax, the slices merged at the end
//     of the split; P is split into bf16 hi + lo halves for P V,
//     two products into one f32 accumulator, as in prefill_wgmma.cuh (a
//     single bf16 P misses the bf16 gate).  At group 1 too this beat f32
//     FMA on CUDA cores reading bf16 from shared memory (timed on an H100:
//     PERF.md).  f32 runs on CUDA cores in f32 FMA, lane j of a warp
//     scoring key j (TF32 would break the f32 gate).
//   - The merge runs in the same launch.  A CTA of a sequence with more than
//     one split writes its rows' (m, l, acc) in f32 to the wrapper's
//     scratch, then draws a ticket per (sequence, kv head, row block); the
//     CTA that draws the last merges the splits in split order 0 .. n - 1,
//     an order that does not depend on arrival, stores the output and resets
//     the ticket to 0 for the next launch.  A sequence with one split stores
//     directly.  The kernel allocates nothing.
// NaN: masked keys score -inf against a finite running max and weigh
// exactly 0; a NaN score of a valid key is dropped by the max but reaches
// l and acc, and the merge carries it on (a split with no valid key has m =
// kNegInf and l = 0, which weighs 0, never NaN; the final test is l != 0),
// so it reaches its row's output and no other row's.
#pragma once

#include <type_traits>

#include "hopper_common.cuh"
#include "paged_attention_common.cuh"

namespace paged {
namespace dec {

constexpr int kThreads = 128;           // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSplitKeys = 512;         // keys per split
constexpr int kStages = 3;              // K/V tiles in flight
constexpr int kMaxRows = 16;            // query rows per CTA at most
constexpr float kLog2e = 1.4426950408889634f;

// Splits a capacity of `capacity` keys takes (at least one, which stores a
// sequence with kv_len == 0 as zeros).
inline int split_count(int capacity) {
  return capacity <= kSplitKeys ? 1 : (capacity + kSplitKeys - 1) / kSplitKeys;
}

// What a launch needs besides the KV struct.
struct Args {
  const void* q;      // (B, Hq, HD)
  void* out;          // (B, Hq, HD)
  float* part;        // B * Hq * n_splits * (HD + 2) f32: acc, then (m, l)
  int* tickets;       // >= B * Hkv * n_rb int32, zero between launches
  int n_q_heads;
  int group;
  int n_rb;           // row blocks per kv head
  int n_splits;       // split_count(the cache's capacity)
  float scale_log2;   // 1/sqrt(hd) * log2 e, in f32
};

// Shared memory of one CTA, in bytes from its base.  During the key loop:
// the K/V ring, then the query rows (and on CUDA cores the tile's
// probabilities and rescale factors).  After it, over the ring: each key
// slice's rows' (acc, m, l), then the CTA's per-row (m, l).
template <typename T, int HD, int ROWS, bool MMA>
struct Smem {
  static constexpr int kKeys = 128 / (int)sizeof(T);       // keys per tile
  static constexpr int kRowBytes = HD * (int)sizeof(T) + 16;
  static constexpr int kTile = kKeys * kRowBytes;
  static constexpr int kQ = kStages * 2 * kTile;
  static constexpr int kQRowBytes = MMA ? HD * 2 + 16 : HD * 4;
  static constexpr int kP = kQ + ROWS * kQRowBytes;
  static constexpr int kAlpha = kP + (MMA ? 0 : ROWS * kKeys * 4);
  static constexpr int kLoop = kAlpha + (MMA ? 0 : ROWS * 4);
  static constexpr int kSlices = MMA ? kWarps : 1;   // key slices
  static constexpr int kSlM = kSlices * ROWS * HD * 4;
  static constexpr int kSlL = kSlM + kSlices * ROWS * 4;
  static constexpr int kRowM = kSlL + kSlices * ROWS * 4;
  static constexpr int kRowL = kRowM + ROWS * 4;
  static constexpr int kEpilogue = kRowL + ROWS * 4;
  static constexpr int kBytes = kLoop > kEpilogue ? kLoop : kEpilogue;
  __host__ __device__ static constexpr int k(int s) { return kTile * 2 * s; }
  __host__ __device__ static constexpr int v(int s) {
    return kTile * (2 * s + 1);
  }
};

// Stage keys [tile0, tile0 + KEYS) of one kv head: key pos's K row at
// k + row(pos) and V row at v + row(pos), HD contiguous elements each.
// Thread i copies 16-byte chunk i % kChunks of key i / kChunks (+ kThreads
// / kChunks, ...), neighbouring threads on neighbouring chunks; keys at or
// past n_keys are zero-filled without a read.
template <typename T, int HD, int KEYS, typename Row>
__device__ __forceinline__ void load_tile(uint32_t k_s, uint32_t v_s,
                                          const T* k, const T* v, Row row,
                                          int tile0, int n_keys) {
  constexpr int kChunks = HD * (int)sizeof(T) / 16;
  constexpr int kElems = 16 / (int)sizeof(T);
  constexpr int kRowBytes = HD * (int)sizeof(T) + 16;
  static_assert(KEYS * kChunks % kThreads == 0, "tile / thread count");
#pragma unroll
  for (int it = 0; it < KEYS * kChunks / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / kChunks, c = i % kChunks;
    const int pos = tile0 + r;
    const bool ok = pos < n_keys;
    const size_t off = ok ? row(pos) + c * kElems : 0;
    const uint32_t dst = r * kRowBytes + c * 16;
    hopper::cp_async16(k_s + dst, k + off, ok ? 16 : 0);
    hopper::cp_async16(v_s + dst, v + off, ok ? 16 : 0);
  }
}

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The keys [key0, n_keys) of one split on CUDA cores (f32), for ROWS query
// rows of which the first `rows` are live.  Warp w scores rows w, w +
// kWarps, ... with lane j holding keys j (and j + 32) of the tile; thread t then owns
// output columns 2 (t % (HD / 2)), + 1 of rows t / (HD / 2), + kRowStep,
// ....  Leaves the rows' (acc, m, l) as slice 0 of the epilogue state.
template <typename T, int HD, int ROWS, typename Row>
__device__ __forceinline__ void cuda_core_split(
    uint8_t* smem, const T* __restrict__ q, const T* k, const T* v, Row row,
    int rows, int key0, int n_keys, float scale_log2) {
  using S = Smem<T, HD, ROWS, false>;
  constexpr int KEYS = S::kKeys;
  constexpr int kPerLane = KEYS / 32;
  constexpr int kElems = 16 / (int)sizeof(T);
  constexpr int kOwned = ROWS / kWarps;
  constexpr int kRowStep = kThreads / (HD / 2);
  constexpr int kAcc = ROWS / kRowStep;
  static_assert(ROWS % kWarps == 0 && ROWS % kRowStep == 0, "rows");
  const uint32_t base = hopper::smem_addr(smem);
  float(*qs)[HD] = reinterpret_cast<float(*)[HD]>(smem + S::kQ);
  float(*ps)[KEYS] = reinterpret_cast<float(*)[KEYS]>(smem + S::kP);
  float* alpha_s = reinterpret_cast<float*>(smem + S::kAlpha);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c2 = threadIdx.x % (HD / 2), r0 = threadIdx.x / (HD / 2);
  const int n_tiles = (n_keys - key0 + KEYS - 1) / KEYS;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) {
      load_tile<T, HD, KEYS>(base + S::k(s), base + S::v(s), k, v, row,
                             key0 + s * KEYS, n_keys);
    }
    hopper::cp_async_commit();
  }
  for (int i = threadIdx.x; i < ROWS * HD; i += kThreads) {
    qs[i / HD][i % HD] = i < rows * HD ? to_float(q[i]) : 0.f;
  }

  float m[kOwned], l[kOwned];
  float2 acc[kAcc];
#pragma unroll
  for (int i = 0; i < kOwned; ++i) { m[i] = kNegInf; l[i] = 0.f; }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = make_float2(0.f, 0.f);

  for (int t = 0; t < n_tiles; ++t) {
    hopper::cp_async_wait<kStages - 2>();   // tile t has landed
    __syncthreads();   // ... for every thread, and tile t - 1 is done
    {
      const int nt = t + kStages - 1;
      if (nt < n_tiles) {
        load_tile<T, HD, KEYS>(base + S::k(nt % kStages),
                               base + S::v(nt % kStages), k, v, row,
                               key0 + nt * KEYS, n_keys);
      }
      hopper::cp_async_commit();
    }
    const uint8_t* ks = smem + S::k(t % kStages);
    const uint8_t* vs = smem + S::v(t % kStages);
    const int tile0 = key0 + t * KEYS;

    // scores q . k, in f32 over d in order
    float s[kOwned][kPerLane];
#pragma unroll
    for (int i = 0; i < kOwned; ++i) {
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) s[i][u] = 0.f;
    }
#pragma unroll 2
    for (int c = 0; c < HD / kElems; ++c) {
      float kf[kPerLane][kElems];
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            ks + (lane + 32 * u) * S::kRowBytes + c * 16);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < kElems; ++j) kf[u][j] = to_float(e[j]);
      }
#pragma unroll
      for (int i = 0; i < kOwned; ++i) {
        if (warp + kWarps * i < rows) {
          const float* qr = qs[warp + kWarps * i] + c * kElems;
#pragma unroll
          for (int j = 0; j < kElems; ++j) {
            const float qv = qr[j];
#pragma unroll
            for (int u = 0; u < kPerLane; ++u) {
              s[i][u] = fmaf(qv, kf[u][j], s[i][u]);
            }
          }
        }
      }
    }

    // online softmax in base 2
#pragma unroll
    for (int i = 0; i < kOwned; ++i) {
      const int r = warp + kWarps * i;
      if (r >= rows) continue;
      float x[kPerLane];
      float mx = neg_inf();
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        x[u] = tile0 + lane + 32 * u < n_keys ? s[i][u] * scale_log2
                                              : neg_inf();
        mx = fmaxf(mx, x[u]);
      }
      const float m_new = fmaxf(m[i], warp_max(mx));
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const float p = exp2f(x[u] - m_new);
        ps[r][lane + 32 * u] = p;
        sum += p;
      }
      l[i] = fmaf(l[i], alpha, warp_sum(sum));
      m[i] = m_new;
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p V
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int r = r0 + kRowStep * i;
      if (r < rows) {
        const float a = alpha_s[r];
        acc[i].x *= a;
        acc[i].y *= a;
      }
    }
#pragma unroll 4
    for (int j = 0; j < KEYS; ++j) {
      const float2 vv = load_pair(
          reinterpret_cast<const T*>(vs + j * S::kRowBytes) + 2 * c2);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int r = r0 + kRowStep * i;
        if (r < rows) {
          const float p = ps[r][j];
          acc[i].x = fmaf(p, vv.x, acc[i].x);
          acc[i].y = fmaf(p, vv.y, acc[i].y);
        }
      }
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();   // the ring is free for the epilogue state

  float* sl_acc = reinterpret_cast<float*>(smem);
  float* sl_m = reinterpret_cast<float*>(smem + S::kSlM);
  float* sl_l = reinterpret_cast<float*>(smem + S::kSlL);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int r = r0 + kRowStep * i;
    if (r < rows) {
      *reinterpret_cast<float2*>(sl_acc + r * HD + 2 * c2) = acc[i];
    }
  }
#pragma unroll
  for (int i = 0; i < kOwned; ++i) {
    const int r = warp + kWarps * i;
    if (r < rows && lane == 0) {
      sl_m[r] = m[i];
      sl_l[r] = l[i];
    }
  }
}

// The keys [key0, n_keys) of one split on the tensor cores (bf16), for ROWS
// = 16 query rows (one m16 tile) of which the first `rows` are live.  Warp
// w takes key slice w, keys 16 w .. 16 w + 15 of each tile, with its own
// online softmax; leaves each slice's (acc, m, l) as epilogue state.
// (Blocks of 32 or 64 rows, a warp per 16 rows, timed slower at group 48:
// PERF.md.)
template <int HD, int ROWS, typename Row>
__device__ __forceinline__ void mma_split(
    uint8_t* smem, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* k, const __nv_bfloat16* v, Row row, int rows,
    int key0, int n_keys, float scale_log2) {
  using S = Smem<__nv_bfloat16, HD, ROWS, true>;
  constexpr int KEYS = S::kKeys;              // 64
  constexpr int KS = KEYS / kWarps;           // keys per slice: 16
  constexpr int NT = KS / 8;                  // S tiles of 8 keys
  constexpr int kChunks = HD / 8;
  static_assert(ROWS == 16 && NT % 2 == 0, "one m16 tile of rows");
  const uint32_t base = hopper::smem_addr(smem);
  const uint32_t q_s = base + S::kQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (n_keys - key0 + KEYS - 1) / KEYS;

  // Q (rows past the live ones zero-filled) is the oldest copy group
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < rows;
    hopper::cp_async16(q_s + r * S::kQRowBytes + c * 16,
                       q + (ok ? r * HD + c * 8 : 0), ok ? 16 : 0);
  }
  hopper::cp_async_commit();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) {
      load_tile<__nv_bfloat16, HD, KEYS>(base + S::k(s), base + S::v(s), k,
                                         v, row, key0 + s * KEYS, n_keys);
    }
    hopper::cp_async_commit();
  }

  uint32_t qa[HD / 16][4];
  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // l: this thread's part

  for (int t = 0; t < n_tiles; ++t) {
    hopper::cp_async_wait<kStages - 2>();   // tile t (and Q) has landed
    __syncthreads();   // ... for every thread, and tile t - 1 is done
    {
      const int nt = t + kStages - 1;
      if (nt < n_tiles) {
        load_tile<__nv_bfloat16, HD, KEYS>(
            base + S::k(nt % kStages), base + S::v(nt % kStages), k, v, row,
            key0 + nt * KEYS, n_keys);
      }
      hopper::cp_async_commit();
    }
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int r = lane % 8 + 8 * ((lane / 8) % 2);
        hopper::ldmatrix_x4(qa[kk], q_s + r * S::kQRowBytes +
                                        (kk * 16 + 8 * (lane / 16)) * 2);
      }
    }
    const uint32_t ks = base + S::k(t % kStages);
    const uint32_t vs = base + S::v(t % kStages);
    const int slice0 = warp * KS;               // first key of the slice
    const int tile0 = key0 + t * KEYS;

    // S = Q K^T over this warp's key slice
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        const int key = slice0 + np * 16 + lane % 8 + 8 * (lane / 16);
        const int d = kk * 16 + 8 * ((lane / 8) % 2);
        hopper::ldmatrix_x4(b, ks + key * S::kRowBytes + d * 2);
        hopper::mma_m16n8k16(s[2 * np], qa[kk], b[0], b[1]);
        hopper::mma_m16n8k16(s[2 * np + 1], qa[kk], b[2], b[3]);
      }
    }

    // online softmax in base 2: s becomes p; rows lane / 4 and + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = tile0 + slice0 + n * 8 + 2 * (lane % 4) + e;
          const float x =
              key < n_keys ? s[n][2 * h + e] * scale_log2 : neg_inf();
          s[n][2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(m[h] - mx);
      m[h] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[n][2 * h + e] - mx);
          s[n][2 * h + e] = p;
          sum += p;
        }
      }
      l[h] = fmaf(l[h], alpha, sum);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[j][2 * h] *= alpha;
        o[j][2 * h + 1] *= alpha;
      }
    }

    // O += P_hi V + P_lo V, 16 keys of the slice at a time
#pragma unroll
    for (int kc = 0; kc < KS / 16; ++kc) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = s[2 * kc + r / 2][2 * (r % 2)];
        const float c = s[2 * kc + r / 2][2 * (r % 2) + 1];
        const float ah = __bfloat162float(__float2bfloat16(a));
        const float ch = __bfloat162float(__float2bfloat16(c));
        hi[r] = hopper::pack_bf16(ah, ch);
        lo[r] = hopper::pack_bf16(a - ah, c - ch);
      }
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t b[4];
        const int key = slice0 + kc * 16 + lane % 8 + 8 * ((lane / 8) % 2);
        const int d = dp * 16 + 8 * (lane / 16);
        hopper::ldmatrix_x4_trans(b, vs + key * S::kRowBytes + d * 2);
        hopper::mma_m16n8k16(o[2 * dp], hi, b[0], b[1]);
        hopper::mma_m16n8k16(o[2 * dp], lo, b[0], b[1]);
        hopper::mma_m16n8k16(o[2 * dp + 1], hi, b[2], b[3]);
        hopper::mma_m16n8k16(o[2 * dp + 1], lo, b[2], b[3]);
      }
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();   // the ring is free for the epilogue state

  float* sl_acc = reinterpret_cast<float*>(smem);
  float* sl_m = reinterpret_cast<float*>(smem + S::kSlM);
  float* sl_l = reinterpret_cast<float*>(smem + S::kSlL);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = warp * ROWS + lane / 4 + 8 * h;   // slice-major
    if (lane % 4 == 0) {
      sl_m[r] = m[h];
      sl_l[r] = lt;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<float2*>(sl_acc + r * HD + 8 * j + 2 * (lane % 4)) =
          make_float2(o[j][2 * h], o[j][2 * h + 1]);
    }
  }
}

__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst);
  d[0] = __floats2bfloat162_rn(v.x, v.y);
  d[1] = __floats2bfloat162_rn(v.z, v.w);
}

__device__ __forceinline__ void fma4(float4& acc, float4 a, float w) {
  acc.x = fmaf(a.x, w, acc.x);
  acc.y = fmaf(a.y, w, acc.y);
  acc.z = fmaf(a.z, w, acc.z);
  acc.w = fmaf(a.w, w, acc.w);
}

// acc / l, or 0 where l == 0 (not l > 0: a NaN row stays NaN)
__device__ __forceinline__ float4 normalise(float4 acc, float l) {
  if (l == 0.f) return make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
}

// The epilogue.  First the CTA's rows over its key slices, in slice order;
// then either the output (one split) or this split's partial, a ticket and,
// in the CTA that draws the last, the merge of every split: per row, m =
// max m_s and l = sum l_s 2^(m_s - m) by one warp (lane j takes splits j, j
// + 32, ... in order, then a fixed butterfly), and acc = sum acc_s 2^(m_s -
// m) in split order 0 .. n - 1 by each thread over its float4 columns --
// orders that do not depend on which CTA arrived when.  Each thread keeps
// kPer float4 columns in flight, so the merge waits on L2 about once per
// split, not once per column.
template <typename T, int HD, int ROWS, typename S>
__device__ __forceinline__ void finish_split(uint8_t* smem, const Args& a,
                                             T* __restrict__ out, int rows,
                                             size_t head0, int split,
                                             int n_live, int ticket) {
  constexpr int SL = S::kSlices;
  constexpr int kV4 = HD / 4;                                // float4 per row
  constexpr int kPer = (ROWS * kV4 + kThreads - 1) / kThreads;
  const float* sl_acc = reinterpret_cast<const float*>(smem);
  const float* sl_m = reinterpret_cast<const float*>(smem + S::kSlM);
  const float* sl_l = reinterpret_cast<const float*>(smem + S::kSlL);
  float* row_m = reinterpret_cast<float*>(smem + S::kRowM);
  float* row_l = reinterpret_cast<float*>(smem + S::kRowL);
  const int n4 = rows * kV4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __shared__ int last;
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    float mx = sl_m[r];
#pragma unroll
    for (int s = 1; s < SL; ++s) mx = fmaxf(mx, sl_m[s * ROWS + r]);
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < SL; ++s) {
      sum = fmaf(sl_l[s * ROWS + r], exp2f(sl_m[s * ROWS + r] - mx), sum);
    }
    row_m[r] = mx;
    row_l[r] = sum;
  }
  __syncthreads();
  // the CTA's acc of float4 column e (row e / kV4) over its slices
  auto cta_acc = [&](int e) {
    const int r = e / kV4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < SL; ++s) {
      fma4(sum, reinterpret_cast<const float4*>(sl_acc + (s * ROWS + r) * HD)
                    [e % kV4],
           exp2f(sl_m[s * ROWS + r] - row_m[r]));
    }
    return sum;
  };
  if (n_live == 1) {
    for (int e = threadIdx.x; e < n4; e += kThreads) {
      store4(out + 4 * e, normalise(cta_acc(e), row_l[e / kV4]));
    }
    return;
  }

  // this split's partial: row r of the CTA is partial (head0 + r) *
  // n_splits + split
  const size_t n_part = (size_t)gridDim.z * a.n_q_heads * a.n_splits;
  float* part_acc = a.part;
  float* part_ml = a.part + n_part * HD;
  const size_t p0 = head0 * a.n_splits;
  for (int e = threadIdx.x; e < n4; e += kThreads) {
    const size_t p = p0 + (size_t)(e / kV4) * a.n_splits + split;
    store4(part_acc + p * HD + 4 * (e % kV4), cta_acc(e));
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    float* ml = part_ml + 2 * (p0 + (size_t)r * a.n_splits + split);
    ml[0] = row_m[r];
    ml[1] = row_l[r];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(a.tickets + ticket, 1) == n_live - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last CTA merges the n_live splits (reading past L1)
  for (int r = warp; r < rows; r += kWarps) {
    const float* ml = part_ml + 2 * (p0 + (size_t)r * a.n_splits);
    float mx = neg_inf();
    for (int s = lane; s < n_live; s += 32) mx = fmaxf(mx, __ldcg(ml + 2 * s));
    mx = warp_max(mx);
    float sum = 0.f;
    for (int s = lane; s < n_live; s += 32) {
      sum = fmaf(__ldcg(ml + 2 * s + 1), exp2f(__ldcg(ml + 2 * s) - mx), sum);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      row_m[r] = mx;
      row_l[r] = sum;
    }
  }
  __syncthreads();
  float4 acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < n_live; ++s) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = k * kThreads + threadIdx.x;
      if (e < n4) {
        const int r = e / kV4;
        const size_t p = p0 + (size_t)r * a.n_splits + s;
        fma4(acc[k],
             __ldcg(reinterpret_cast<const float4*>(part_acc + p * HD) +
                    e % kV4),
             exp2f(__ldcg(part_ml + 2 * p) - row_m[r]));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = k * kThreads + threadIdx.x;
    if (e < n4) store4(out + 4 * e, normalise(acc[k], row_l[e / kV4]));
  }
  if (threadIdx.x == 0) a.tickets[ticket] = 0;
}

// One CTA: split blockIdx.x of sequence blockIdx.z, kv head blockIdx.y /
// n_rb, rows block blockIdx.y % n_rb of its group.  KV gives kv_len(b) (the
// valid length clipped to the cache), k(b, h) and v(b, h) (kv head h's K
// and V rows of key 0's row) and rows(b, key0, n_keys, table_s): the
// key-to-row function of keys [key0, n_keys), which may stage what it reads
// (the block table's entries) in table_s, kSplitKeys + 1 ints of shared
// memory, before the CTA's barrier.  The splits start at the first key the
// query (at kv_len - 1) sees, span.lo(kv_len - 1): key 0 (Causal), or the
// window's first key (SlidingWindow), so keys below the window are neither
// read nor counted, and a window of W keys takes ceil(W / kSplitKeys)
// splits whatever the context.
template <typename T, int HD, int ROWS, bool MMA, typename KV, typename Span>
__global__ void __launch_bounds__(kThreads)
    decode_splitk_kernel(const Args a, const KV kv, const Span span) {
  extern __shared__ __align__(128) uint8_t dec_smem[];
  __shared__ int table_s[kSplitKeys + 1];
  using S = Smem<T, HD, ROWS, MMA>;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kv_head = blockIdx.y / a.n_rb, rb = blockIdx.y % a.n_rb;
  const int rows = min(ROWS, a.group - rb * ROWS);
  const size_t head0 = (size_t)b * a.n_q_heads +
                       (size_t)kv_head * a.group + rb * ROWS;
  T* out = static_cast<T*>(a.out) + head0 * HD;
  const int kv_len = kv.kv_len(b);
  const int key_lo = span.lo(kv_len - 1);
  const int key0 = key_lo + split * kSplitKeys;
  if (key0 >= kv_len) {
    if (split == 0) {   // kv_len == 0: the rows store 0
      for (int i = threadIdx.x; i < rows * HD; i += kThreads) {
        out[i] = from_float<T>(0.f);
      }
    }
    return;
  }
  const int n_keys = min(kv_len, key0 + kSplitKeys);
  const int n_live = (kv_len - key_lo + kSplitKeys - 1) / kSplitKeys;
  const T* q = static_cast<const T*>(a.q) + head0 * HD;
  const auto row = kv.rows(b, key0, n_keys, table_s);
  __syncthreads();
  if constexpr (MMA) {
    mma_split<HD, ROWS>(dec_smem, q, kv.k(b, kv_head), kv.v(b, kv_head), row,
                        rows, key0, n_keys, a.scale_log2);
  } else {
    cuda_core_split<T, HD, ROWS>(dec_smem, q, kv.k(b, kv_head),
                                 kv.v(b, kv_head), row, rows, key0, n_keys,
                                 a.scale_log2);
  }
  finish_split<T, HD, ROWS, S>(dec_smem, a, out, rows, head0, split, n_live,
                               b * gridDim.y + blockIdx.y);
}

template <typename T, int HD, int ROWS, bool MMA, typename KV, typename Span>
cudaError_t launch_rows(Args a, const KV& kv, int B, int n_kv_heads,
                        cudaStream_t stream, Span span) {
  a.n_rb = (a.group + ROWS - 1) / ROWS;
  if ((long long)n_kv_heads * a.n_rb > 65535 || B > 65535) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(a.n_splits, n_kv_heads * a.n_rb, B);
  constexpr int bytes = Smem<T, HD, ROWS, MMA>::kBytes;
  auto kernel = decode_splitk_kernel<T, HD, ROWS, MMA, KV, Span>;
  const cudaError_t err = hopper::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, stream>>>(a, kv, span);
  return cudaGetLastError();
}

// The smallest ROWS (doubling from the first) that holds the group; the
// largest takes any group in several row blocks.
template <typename T, int HD, bool MMA, int ROWS, typename KV, typename Span>
cudaError_t pick_rows(const Args& a, const KV& kv, int B, int n_kv_heads,
                      cudaStream_t stream, Span span) {
  if constexpr (ROWS == kMaxRows) {
    return launch_rows<T, HD, ROWS, MMA>(a, kv, B, n_kv_heads, stream, span);
  } else {
    if (a.group <= ROWS) {
      return launch_rows<T, HD, ROWS, MMA>(a, kv, B, n_kv_heads, stream,
                                           span);
    }
    return pick_rows<T, HD, MMA, ROWS * 2>(a, kv, B, n_kv_heads, stream,
                                           span);
  }
}

// bf16 on the tensor cores, f32 on CUDA cores.
template <typename T, int HD, typename KV, typename Span>
cudaError_t pick_path(const Args& a, const KV& kv, int B, int n_kv_heads,
                      cudaStream_t stream, Span span) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return pick_rows<T, HD, true, 16>(a, kv, B, n_kv_heads, stream, span);
  } else {
    return pick_rows<T, HD, false, 8>(a, kv, B, n_kv_heads, stream, span);
  }
}

// Launch the decode of `a` over `kv` (B sequences, n_kv_heads kv heads, head
// dim hd, `capacity` keys per sequence at most), each query over the keys
// `span` lets it see; returns the launch's cudaError_t.  Refuses only what
// the kernel cannot take: Hq % Hkv != 0, a head dim other than 64 or 128, a
// split count other than split_count(capacity), or a missing scratch or
// ticket buffer where a sequence may take several splits.
template <typename T, typename KV, typename Span = Causal>
cudaError_t launch_decode_splitk(Args a, const KV& kv, int B, int n_kv_heads,
                                 int hd, int capacity, float scale,
                                 cudaStream_t stream, Span span = Span{}) {
  if (B < 0 || n_kv_heads <= 0 || a.n_q_heads % n_kv_heads != 0 ||
      capacity < 0 || a.n_splits != split_count(capacity) ||
      (a.n_splits > 1 && (a.part == nullptr || a.tickets == nullptr))) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || a.n_q_heads == 0) return cudaSuccess;
  a.group = a.n_q_heads / n_kv_heads;
  a.scale_log2 = scale * kLog2e;
  if (hd == 64) return pick_path<T, 64>(a, kv, B, n_kv_heads, stream, span);
  if (hd == 128) return pick_path<T, 128>(a, kv, B, n_kv_heads, stream, span);
  return cudaErrorInvalidValue;
}

}  // namespace dec
}  // namespace paged
