// The grouped SwiGLU experts of the engine round on Hopper (sm_90a): the
// body of grouped_gate_up.cu (h = silu(x Wg[e]) * (x Wu[e]) for each routed
// row) and grouped_down.cu (y = h Wd[e]).
//
// Replaces no TPU kernel: the reference's MoE layers are plain jnp
// (repro/models/layers.py moe_ffn, moe_ffn_scatter), whose batched matmuls
// run every expert over its whole capacity buffer.  On this card those
// batched GEMMs read all E experts' weights and compute E x capacity rows
// each round, most of them empty.  These kernels compute only the rows that
// the round routes and keeps, sorted by expert (the wrapper's layout, built
// on the device), and read only the weights of experts that hold a row.
//
// Bound: bytes where an expert holds few rows -- the touched experts'
// weights (3 D F bf16 each) plus the rows, 4.4 GB and 1.3 ms at 3.35 TB/s
// for the ~21 experts a decode round of Arctic touches.  Where experts hold
// hundreds of rows each 64-row tile reads its expert again from L2, which
// bounds these kernels below the operations bound (6 D F per row); the
// round takes the batched GEMMs there (layers.moe_round).
//
// Design:
//   - A tile table of (expert, first row, rows, the expert's first tile,
//     the expert's tiles) entries, at most kBN rows of one expert each, and
//     its length on the device.  A work item is a tile and 128 of the
//     expert's output columns (F for gate/up, D for down); the grid is
//     persistent (one CTA per SM at most), each CTA walking items
//     blockIdx.x, + gridDim.x, ... below the table's length, so a launch of
//     a fixed shape (a CUDA graph) runs only the tiles in use and a CTA
//     with no item exits before loading anything.
//   - Items run expert by expert, and within an expert column block by
//     column block over its tiles.  The CTAs at work together then read
//     neighbouring columns of one expert (whole DRAM pages), and an expert
//     holding several tiles streams each column block from memory once, its
//     other tiles reading it from L2.  (Measured on an H100: tile-major,
//     each tile streams the expert again, 8 times at 512 rows an expert and
//     1.7x slower at mixtral-8x7b's widths; tile-fastest across all
//     experts, the CTAs read 256-byte pieces of 128 experts at once, 14%
//     slower at arctic-480b's.)
//   - Weight columns on wgmma's 64-row side, rows on its N side (kBN = 64):
//     swap A/B, so that at 1-3 rows an expert the tensor cores idle while
//     the weights stream.  (A 16-row tile is 1-2% faster there and
//     2.6-3.5x slower at 512 rows an expert; one tile serves both.)  The weight tile is an MN-major A operand
//     (TMA through a 3-D map, 128-byte swizzle, read with wgmma's transpose
//     bit), the rows a K-major B operand.
//   - A producer warpgroup fills a ring of stages (~205 KB): one thread
//     loads the weight tiles by TMA; in the gate/up kernel all 128 threads
//     gather the tile's rows of x by token index with 16-byte cp.async
//     (zeros past the tile's rows), arriving on the stage's full barrier
//     when their copies land; the down kernel loads its rows of h (sorted,
//     contiguous) by TMA.  Two consumer warpgroups take 64 weight columns
//     each.  The ring runs on across items, so one item's epilogue overlaps
//     the next item's loads.
//   - Numerics: bf16 operands, f32 accumulators.  Gate/up keeps the gate
//     and up sums of the whole reduction on the tensor cores (as
//     fused_swiglu.cu's first GEMM) and rounds silu(g) * u to bf16 once;
//     down adds its tensor-core sums into f32 registers every 128 terms (as
//     fused_swiglu.cu's second GEMM).  No atomics: every output is written
//     once, by one thread, in a fixed order.
#pragma once

#include <algorithm>

#include "hopper_common.cuh"
#include "tensor_map.cuh"

namespace grouped {

constexpr int kBK = 64;            // reduction columns per stage (128 bytes)
constexpr int kBN = 64;            // rows per tile: wgmma's N
constexpr int kCols = 128;         // weight columns per item: 2 x 64
constexpr int kTileInts = 5;       // a tile table entry
constexpr int kThreads = 384;      // a producer warpgroup, two consumers
constexpr int kConsumerWarps = 8;
constexpr int kChunk = 2;          // down: k tiles per tensor-core sum
constexpr int kRingBytes = 210 * 1024;

// A ring stage: the weight tile (kBK x kCols, two 64-column blocks of 8 KB),
// with GATED the up weights' tile after it, then the rows' tile (kBN x
// kBK, K-major).  Every piece starts on a 1024-byte boundary.
template <bool GATED>
struct Ring {
  static constexpr int kW = kBK * kCols * 2;
  static constexpr int kRows = kBN * kBK * 2;
  static constexpr int kStage = (GATED ? 2 : 1) * kW + kRows;
  static constexpr int kStages = std::min(12, kRingBytes / kStage);
  static constexpr int kBytes = kStages * (kStage + 16) + 1024;
  static_assert(kRows % 1024 == 0, "rows' tile off the swizzle atoms");
  static_assert(kBytes <= 227 * 1024, "ring too deep for shared memory");
};

struct Args {
  const __nv_bfloat16* x;    // gate/up: the tokens (n_tokens, n_red)
  const int* tok;            // gate/up: each sorted row's token (n_rows)
  const int* tiles;          // (max_tiles, kTileInts)
  const int* n_tiles;        // [0]: the entries in use
  __nv_bfloat16* out;        // (n_rows, n_out)
  int n_out, n_red, out_tiles;
};

// wgmma m64n64k16, A MN-major (transposed) and B K-major, both from shared
// memory; thread t holds D rows 16 (t / 32) + (t % 32) / 4 (+ 8) and
// columns 8 j + 2 (t % 4) (+ 1): d[4 j + 2 i + e] is row +8i, column +e.
__device__ __forceinline__ void mma_tn(float (&d)[32], uint64_t desc_a,
                                       uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)
      : "memory");
}

// Item w's tile and first weight column.  Entry w / out_tiles of the table
// belongs to the expert whose items w lies among; those run column block
// by column block over the expert's tiles.
__device__ __forceinline__ void item(const Args& a, int w, int& tile,
                                     int& n0) {
  const int* t = a.tiles + kTileInts * (w / a.out_tiles);
  const int first = __ldg(t + 3), per = __ldg(t + 4);
  const int l = w - first * a.out_tiles;
  tile = first + l % per;
  n0 = l / per * kCols;
}

// The mbarrier `bar` counts one arrival of this thread once its earlier
// cp.async copies have landed (`.noinc`: one of the barrier's count).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// The producer warpgroup.  Thread 0 loads the weight tiles (and, in the
// down kernel, the rows of h) by TMA; in the gate/up kernel every thread
// then copies its 16-byte chunks of the tile's rows of x and arrives.
template <bool GATED>
__device__ __forceinline__ void produce(const CUtensorMap* w0_map,
                                        const CUtensorMap* w1_map,
                                        const CUtensorMap* act_map,
                                        const Args& a, int n_tiles,
                                        uint32_t base, uint32_t bars) {
  using R = Ring<GATED>;
  constexpr int kPer = GATED ? kBN * 8 / 128 : 1;  // chunks per thread
  const int t = threadIdx.x;
  if (!GATED && t != 0) return;
  const int n_k = (a.n_red + kBK - 1) / kBK;
  const int n_items = n_tiles * a.out_tiles;
  int f = 0;
  for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
    int tile, n0;
    item(a, w, tile, n0);
    const int e = __ldg(a.tiles + kTileInts * tile);
    const int row0 = __ldg(a.tiles + kTileInts * tile + 1);
    const int nr = __ldg(a.tiles + kTileInts * tile + 2);
    // chunk i of this thread: row (t + 128 i) / 8 of the tile, 16-byte
    // chunk (t + 128 i) % 8 of its 64 columns
    const __nv_bfloat16* src[kPer];
    uint32_t dst[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = (t + 128 * i) / 8, c = (t + 128 * i) % 8;
      src[i] = nullptr;
      if (GATED && r < nr) {
        src[i] = a.x + (size_t)__ldg(a.tok + row0 + r) * a.n_red + 8 * c;
      }
      dst[i] = r * 128 + ((c ^ (r & 7)) << 4);
    }
    for (int kt = 0; kt < n_k; ++kt, ++f) {
      const int s = f % R::kStages;
      const uint32_t st = base + s * R::kStage;
      const uint32_t full = bars + 8 * s;
      hopper::mbar_wait(bars + 8 * (R::kStages + s),
                        ((f / R::kStages) & 1) ^ 1);
      if (t == 0) {
        hopper::mbar_expect_tx(full, GATED ? 2 * R::kW : R::kStage);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          hopper::tma_load_3d(st + h * 8192, w0_map, full, n0 + 64 * h,
                              kt * kBK, e);
          if (GATED) {
            hopper::tma_load_3d(st + R::kW + h * 8192, w1_map, full,
                                n0 + 64 * h, kt * kBK, e);
          }
        }
        if (!GATED) {
          hopper::tma_load_2d(st + R::kW, act_map, full, kt * kBK, row0);
        }
      }
      if constexpr (GATED) {
        const uint32_t rows = st + 2 * R::kW;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int col = kt * kBK + 8 * ((t + 128 * i) % 8);
          const bool ok = src[i] != nullptr && col < a.n_red;
          hopper::cp_async16(rows + dst[i], ok ? src[i] + kt * kBK : a.x,
                             ok ? 16 : 0);
        }
        cp_async_arrive(full);
      }
    }
  }
}

template <bool GATED>
__global__ void __launch_bounds__(kThreads, 1) grouped_kernel(
    const __grid_constant__ CUtensorMap w0_map,   // Wg or Wd: (E, n_red, n_out)
    const __grid_constant__ CUtensorMap w1_map,   // Wu (GATED)
    const __grid_constant__ CUtensorMap act_map,  // h: (n_rows, n_red) (down)
    const Args a) {
  using R = Ring<GATED>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + R::kStages * R::kStage;
  const int n_tiles = __ldg(a.n_tiles);
  const int n_items = n_tiles * a.out_tiles;
  if ((int)blockIdx.x >= n_items) return;       // no item: load nothing
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      // the TMA thread's expect_tx arrival, and with GATED the producer's
      // 128 cp.async arrivals
      hopper::mbar_init(bars + 8 * s, GATED ? 1 + 128 : 1);
      hopper::mbar_init(bars + 8 * (R::kStages + s), kConsumerWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (wg == 0) {
    produce<GATED>(&w0_map, &w1_map, &act_map, a, n_tiles, base, bars);
    return;
  }

  // consumers: warpgroup wg takes weight columns n0 + 64 (wg - 1) .. + 63
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int n_k = (a.n_red + kBK - 1) / kBK;
  constexpr int kAcc = kBN / 2;
  float acc0[kAcc], acc1[kAcc], total[kAcc];
  int f = 0;
  for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
    int tile, n0;
    item(a, w, tile, n0);
    const int row0 = __ldg(a.tiles + kTileInts * tile + 1);
    const int nr = __ldg(a.tiles + kTileInts * tile + 2);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc0[i] = acc1[i] = total[i] = 0.f;
    for (int kt = 0; kt < n_k; ++kt, ++f) {
      const int s = f % R::kStages;
      hopper::mbar_wait(bars + 8 * s, (f / R::kStages) & 1);
      // the rows' tile came through cp.async (the generic proxy); wgmma
      // reads through the async proxy
      if (GATED) hopper::fence_proxy_async();
      __syncwarp();
      const uint32_t st = base + s * R::kStage;
      const uint32_t wt = st + (wg - 1) * 8192;
      const uint32_t rows = st + (GATED ? 2 : 1) * R::kW;
      const bool first = GATED ? kt == 0 : kt % kChunk == 0;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t db = hopper::desc(rows + kk * 32, 16, 1024);
        const int scale = kk == 0 && first ? 0 : 1;
        mma_tn(acc0, hopper::desc(wt + kk * 2048, 8192, 1024), db, scale);
        if (GATED) {
          mma_tn(acc1, hopper::desc(wt + R::kW + kk * 2048, 8192, 1024),
                     db, scale);
        }
      }
      hopper::wgmma_commit();
      if (!GATED && (kt % kChunk == kChunk - 1 || kt == n_k - 1)) {
        hopper::wgmma_wait<0>();    // the chunk's sum is complete
        hopper::fence_operand(acc0);
#pragma unroll
        for (int i = 0; i < kAcc; ++i) total[i] += acc0[i];
      } else {
        hopper::wgmma_wait<1>();    // k tile kt - 1's wgmma is done ...
      }
      hopper::fence_operand(acc0);
      hopper::fence_operand(acc1);
      __syncwarp();
      if (kt > 0 && lane == 0) {    // ... so its stage is free
        hopper::mbar_arrive(bars + 8 * (R::kStages + (f - 1) % R::kStages));
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operand(acc0);
    hopper::fence_operand(acc1);
    __syncwarp();
    if (lane == 0) {                // the item's last stage
      hopper::mbar_arrive(bars + 8 * (R::kStages + (f - 1) % R::kStages));
    }

    // epilogue: weight column m of row n of the tile
    const int m0 = n0 + 64 * (wg - 1) + 16 * warp + lane / 4;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * j + 2 * (lane % 4) + e;
        if (n >= nr) continue;
        __nv_bfloat16* out = a.out + (size_t)(row0 + n) * a.n_out;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = m0 + 8 * i;
          if (m >= a.n_out) continue;
          const int k = 4 * j + 2 * i + e;
          float v;
          if constexpr (GATED) {
            // silu(g) * u as fused_swiglu.cu computes it, rounded once
            const float g = acc0[k];
            v = g * (1.f / (1.f + expf(-g))) * acc1[k];
          } else {
            v = total[k];
          }
          out[m] = __float2bfloat16_rn(v);
        }
      }
    }
  }
}

// One launch: a persistent grid of at most one CTA per SM, no more than
// the items the table could hold.
template <bool GATED>
cudaError_t launch(const CUtensorMap& w0, const CUtensorMap& w1,
                   const CUtensorMap& act, const Args& a, int max_tiles,
                   cudaStream_t stream) {
  using R = Ring<GATED>;
  static const int n_sm = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess) {
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    }
    return n;
  }();
  auto kernel = grouped_kernel<GATED>;
  const cudaError_t attr = hopper::allow_smem(kernel, R::kBytes);
  if (attr != cudaSuccess) return attr;
  const long long items = (long long)max_tiles * a.out_tiles;
  const int grid = (int)std::min<long long>(n_sm, items);
  kernel<<<grid, kThreads, R::kBytes, stream>>>(w0, w1, act, a);
  return cudaGetLastError();
}

}  // namespace grouped
