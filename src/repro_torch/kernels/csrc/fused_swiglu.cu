// Fused SwiGLU feed-forward for Hopper (sm_90a):
// out = (silu(x @ Wg) * (x @ Wu)) @ Wd.
//
// Replaces the TPU kernel `fused_swiglu`
// (src/repro/kernels/fused_swiglu.py:66, pallas_call at :85): x (M, D), Wg
// and Wu (D, F), Wd (F, D), all row-major in one dtype (f32 or bf16); every
// product accumulates in f32, and the hidden tile silu(g) * u is rounded to
// x's dtype before the down product, as the TPU kernel rounds it
// (fused_swiglu.py:58).  No model path calls it (the model's FFN is plain
// PyTorch, as the reference's is); it is ported as the reference exposes it,
// through ops.swiglu_ffn.
//
// Bound on an H100: operations at model widths -- 6 M D F FLOPs against
// 6 D F weight bytes in bf16: 35 GFLOP at M = 2048, D = 1024, F = 2816,
// 36 us at the 989 TFLOP/s bf16 tensor-core peak -- and bytes at small M
// (qwen3-8b's 302 MB of weights at M = 256: 90 us at 3.35 TB/s).
//
// The TPU kernel walks F sequentially and carries a (blk_m, D) f32
// accumulator across it in VMEM.  On this card that accumulator is the
// whole register file at D = 1024 and 64 rows, so bf16 runs as two GEMMs on
// the tensor cores instead, with the hidden activations H (M, F) in bf16 --
// the TPU kernel's rounded hidden tile -- as the only intermediate:
//   A: H = silu(x @ Wg) * (x @ Wu), the activation in the epilogue;
//   B: out = H @ Wd.
// Both are one CTA per (128 rows, BN output columns): a producer warpgroup
// whose one thread keeps a ring of about 192 KB of shared-memory stages
// filling by TMA (128-byte swizzle), and two consumer warpgroups of 64 rows
// running wgmma (bf16 in, f32 accumulators) on them -- in A one m64n(2 BN)
// k16 wgmma per step for the gate and up tiles together.  x and H are
// K-major A operands and the row-major weights MN-major B operands, read
// through wgmma's transpose bit, so no weight is copied.  BN is 128 where
// that gives nine SMs in ten a CTA, else 64.  B adds its tensor-core sums
// up in f32 every 128 terms, as the first kernel's partials did.  H costs
// 4 M F bytes of traffic (23 MB at M = 2048) where the first kernel's f32
// partials cost 8 M D F / 128 (185 MB).  The output is deterministic: no
// atomics, sums in a fixed order.
//
// f32 keeps the first kernel: F split over blocks, each block's (32, 128)
// hidden tile in shared memory multiplied into a (32, D) f32 partial by
// f32 FMA on CUDA cores (4 x 4 per thread), and a second kernel summing the
// ceil(F / 128) partials in block order.  Every division is IEEE (no fast
// math).
#include <algorithm>

#include "hopper_common.cuh"
#include "tensor_map.cuh"      // the TMA maps (encoder looked up at run time)
#include "paged_attention_common.cuh"   // dtype codes and conversions

namespace swiglu {

using paged::from_float;
using paged::to_float;

constexpr int kThreads = 256;  // 8 warps; thread (tr, tc) = (tid/32, tid%32)
constexpr int kBM = 32;        // rows of x per block: 4 per thread row
constexpr int kBF = 128;       // hidden columns per block: 4 per lane
constexpr int kBK = 32;        // D columns per step of the gate/up products
constexpr int kBN = 128;       // output columns per pass of the down product
constexpr int kBFD = 32;       // rows of Wd staged per step
static_assert(kBM == 4 * (kThreads / 32) && kBF == 4 * 32 && kBN == 4 * 32,
              "each thread owns a 4 x 4 tile");
static_assert(kBFD * kBN == kBK * kBF && kBM * kBF == kBK * kBF,
              "the down product reuses the gate/up staging buffers");

// Stage rows [row0, row0 + ROWS) and columns [col0, col0 + COLS) of a
// row-major matrix (leading dimension ld, n_rows x n_cols) into dst
// (ROWS x COLS, f32), 16-byte vectors with neighbouring threads on
// neighbouring vectors; what lies outside the matrix stages as 0.  n_cols is
// a multiple of the vector width, so a vector is wholly in or out.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const T* __restrict__ src, int ld,
                                      int row0, int n_rows, int col0,
                                      int n_cols) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = COLS / kVec;
  for (int i = threadIdx.x; i < ROWS * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow, c = (i % kVecPerRow) * kVec;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows && col0 + c < n_cols) {
      raw = __ldg(reinterpret_cast<const uint4*>(
          src + (size_t)(row0 + r) * ld + col0 + c));
    }
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[r * COLS + c + j] = to_float(e[j]);
  }
}

__device__ __forceinline__ void fma_row(float (&acc)[4], float a, float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) swiglu_partial_kernel(
    const T* __restrict__ x,       // (M, D)
    const T* __restrict__ wg,      // (D, F)
    const T* __restrict__ wu,      // (D, F)
    const T* __restrict__ wd,      // (F, D)
    float* __restrict__ partial,   // (ceil(F / kBF), M, D)
    int M, int D, int F) {
  __shared__ __align__(16) float x_s[kBM * kBK];
  __shared__ __align__(16) float a_s[kBK * kBF];   // Wg tile, then Wd tiles
  __shared__ __align__(16) float b_s[kBK * kBF];   // Wu tile, then the hidden tile

  const int m0 = blockIdx.x * kBM, f0 = blockIdx.y * kBF;
  const int tr = threadIdx.x / 32, tc = threadIdx.x % 32;

  // gate and up products of this block's (kBM, kBF) hidden tile
  float g[4][4], u[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) g[i][j] = u[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < D; k0 += kBK) {
    stage<T, kBM, kBK>(x_s, x, D, m0, M, k0, D);
    stage<T, kBK, kBF>(a_s, wg, F, k0, D, f0, F);
    stage<T, kBK, kBF>(b_s, wu, F, k0, D, f0, F);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      const float4 gw = *reinterpret_cast<const float4*>(a_s + k * kBF + 4 * tc);
      const float4 uw = *reinterpret_cast<const float4*>(b_s + k * kBF + 4 * tc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xv = x_s[(4 * tr + i) * kBK + k];   // one address per warp
        fma_row(g[i], xv, gw);
        fma_row(u[i], xv, uw);
      }
    }
    __syncthreads();
  }

  // the hidden tile silu(g) * u, rounded to T as the TPU kernel rounds it;
  // padding rows and columns (x or Wg/Wu staged as 0) give h = 0
  float* h_s = b_s;                                   // (kBM, kBF)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float gv = g[i][j];
      const float sig = 1.f / (1.f + expf(-gv));
      h_s[(4 * tr + i) * kBF + 4 * tc + j] =
          to_float(from_float<T>(gv * sig * u[i][j]));
    }
  }

  // the down product h @ Wd[f0 : f0 + kBF], kBN output columns per pass
  float* w_s = a_s;                                   // (kBFD, kBN)
  for (int n0 = 0; n0 < D; n0 += kBN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    for (int fc = 0; fc < kBF; fc += kBFD) {
      __syncthreads();            // h_s is written; the last w_s reads are done
      stage<T, kBFD, kBN>(w_s, wd, D, f0 + fc, F, n0, D);
      __syncthreads();
#pragma unroll 4
      for (int f = 0; f < kBFD; ++f) {
        const float4 w = *reinterpret_cast<const float4*>(w_s + f * kBN + 4 * tc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          fma_row(acc[i], h_s[(4 * tr + i) * kBF + fc + f], w);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 4 * tr + i;
      if (m < M) {
        *reinterpret_cast<float4*>(
            partial + ((size_t)blockIdx.y * M + m) * D + n0 + 4 * tc) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
  }
}

// out[i] = the partials' sum over the F blocks, in block order, rounded to T
template <typename T>
__global__ void __launch_bounds__(kThreads) swiglu_reduce_kernel(
    const float* __restrict__ partial, T* __restrict__ out, int n_parts,
    size_t n) {
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (size_t)gridDim.x * kThreads) {
    float s = 0.f;
    for (int p = 0; p < n_parts; ++p) s += partial[(size_t)p * n + i];
    out[i] = from_float<T>(s);
  }
}

// f32: the partials, then their sum in block order
cudaError_t launch_f32(const float* x, const float* wg, const float* wu,
                       const float* wd, float* partial, float* out, int M,
                       int D, int F, cudaStream_t stream) {
  const int n_parts = (F + kBF - 1) / kBF;
  const dim3 grid((M + kBM - 1) / kBM, n_parts);
  swiglu_partial_kernel<float><<<grid, kThreads, 0, stream>>>(
      x, wg, wu, wd, partial, M, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)M * D;
  const int blocks =
      (int)std::min<size_t>((n + kThreads - 1) / kThreads, 132 * 16);
  swiglu_reduce_kernel<float><<<blocks, kThreads, 0, stream>>>(
      partial, out, n_parts, n);
  return cudaGetLastError();
}

}  // namespace swiglu

// -- bf16: two TMA-fed wgmma GEMMs -------------------------------------------
namespace swiglu_wg {

constexpr int kBM = 128;      // rows per CTA: two warpgroups of 64
constexpr int kBK = 64;       // reduction columns per stage (128 bytes)
constexpr int kThreads = 384;  // a producer warpgroup, two consumers
constexpr int kConsumerWarps = 8;
// The down product's k tiles per tensor-core sum.  Summed on the tensor
// cores over all of F (12,288 at qwen3-8b's widths), a few outputs near 0
// landed more than one bf16 step from the f32 product of the same hidden
// values (chip_smoke.py phase 15's gate); sums of 2 * kBK = 128 terms, added
// up in f32 on the CUDA cores, are what the first kernel's 128-column
// partials were, and hold it.
constexpr int kChunk = 2;

// A ring of STAGES stages, each the A tile (kBM x kBK, K-major), then each
// B matrix's tile (kBK x BN, MN-major, BN / 64 column blocks of 8 KB); after
// the ring, the full and empty mbarriers of every stage.
template <int BN, bool GATED, int STAGES>
struct Tiles {
  static constexpr int kA = kBM * kBK * 2;
  static constexpr int kB = kBK * BN * 2;
  static constexpr int kStage = kA + (GATED ? 2 : 1) * kB;
  static constexpr int kBytes = STAGES * (kStage + 16) + 1024;
  static_assert(kBytes <= 227 * 1024, "ring too deep for shared memory");
};

// out (M, N) = A (M, K) @ B0 (K, N), or with GATED the hidden tile
// silu(A @ B0) * (A @ B1); bf16 in and out, f32 accumulators, each output
// rounded once.  CTA (i, j) owns rows [128 i, 128 i + 128) and columns
// [BN j, BN j + BN).  Warpgroup 0 is the producer: one thread keeps the
// ring's stages loading by TMA as the consumers free them.  Warpgroups 1
// and 2 consume, rows 64 (w - 1) .. + 63 each: they keep one k tile's
// wgmma in flight while issuing the next, and free a stage (the empty
// barrier, one arrival per warp) once the wgmma that read it is done.  TMA
// fills what lies outside a matrix with zeros, so ragged M, N and K need no
// masks but the store's.
template <int BN, bool GATED, int STAGES>
__global__ void __launch_bounds__(kThreads, 1) gemm_kernel(
    const __grid_constant__ CUtensorMap a_map,
    const __grid_constant__ CUtensorMap b0_map,
    const __grid_constant__ CUtensorMap b1_map,
    __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  using L = Tiles<BN, GATED, STAGES>;
  constexpr int kStages = STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + kStages * L::kStage;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int n_k = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32,
            lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), kConsumerWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        hopper::mbar_wait(empty(s), ((kt / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(full(s), L::kStage);
        const uint32_t st = base + s * L::kStage;
        hopper::tma_load_2d(st, &a_map, full(s), kt * kBK, m0);
#pragma unroll
        for (int h = 0; h < BN / 64; ++h) {
          hopper::tma_load_2d(st + L::kA + h * 8192, &b0_map, full(s),
                              n0 + 64 * h, kt * kBK);
          if (GATED) {
            hopper::tma_load_2d(st + L::kA + L::kB + h * 8192, &b1_map,
                                full(s), n0 + 64 * h, kt * kBK);
          }
        }
      }
    }
    return;
  }

  // With GATED one wgmma covers the gate and up tiles (2 BN columns: the
  // two B tiles' column blocks lie 8 KB apart, one after the other), so acc
  // holds g in its first BN / 2 registers and u in the rest.  Without, every
  // kChunk k tiles the tensor cores' sum in acc is added to `total` in f32
  // on the CUDA cores and the next chunk starts afresh.
  constexpr int kN = GATED ? 2 * BN : BN;
  float acc[kN / 2], total[GATED ? 1 : BN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (GATED ? 1 : BN / 2); ++i) total[i] = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kStages;
    hopper::mbar_wait(full(s), (kt / kStages) & 1);
    __syncwarp();                 // wgmma wants the warp converged
    const uint32_t a_s = base + s * L::kStage + (wg - 1) * (64 * kBK * 2);
    const uint32_t b_s = base + s * L::kStage + L::kA;
    const int fresh = !GATED && kt % kChunk == 0;    // a chunk's first tile
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      hopper::mma_ss<kN, 1>(acc, hopper::desc(a_s + kk * 32, 16, 1024),
                            hopper::desc(b_s + kk * 2048, 8192, 1024),
                            kk == 0 && fresh ? 0 : 1);
    }
    hopper::wgmma_commit();
    if (!GATED && (kt % kChunk == kChunk - 1 || kt == n_k - 1)) {
      hopper::wgmma_wait<0>();    // the chunk's sum is complete
      hopper::fence_operand(acc);
#pragma unroll
      for (int i = 0; i < (GATED ? 1 : BN / 2); ++i) total[i] += acc[i];
    } else {
      hopper::wgmma_wait<1>();    // k tile kt - 1's wgmma is done ...
    }
    hopper::fence_operand(acc);
    __syncwarp();
    if (kt > 0 && lane == 0) {    // ... so its stage is free
      hopper::mbar_arrive(empty((kt - 1) % kStages));
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_operand(acc);

  // epilogue: rows m0 + 64 (wg - 1) + 16 warp + lane / 4 (+ 8), columns
  // n0 + 8 j + 2 (lane % 4) (+ 1)
  const int row = m0 + 64 * (wg - 1) + 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= N) continue;               // N is even: col + 1 < N as well
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row + 8 * i >= M) continue;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (GATED) {
          // silu(g) * u as the f32 path computes it, rounded to bf16 as the
          // TPU kernel rounds the hidden tile
          const float g = acc[4 * j + 2 * i + e];
          const float u = acc[BN / 2 + 4 * j + 2 * i + e];
          v[e] = g * (1.f / (1.f + expf(-g))) * u;
        } else {
          v[e] = total[4 * j + 2 * i + e];
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row + 8 * i) * N +
                                         col) =
          __floats2bfloat162_rn(v[0], v[1]);
    }
  }
}

template <int BN, bool GATED, int STAGES>
cudaError_t launch_gemm(const CUtensorMap& a, const CUtensorMap& b0,
                        const CUtensorMap& b1, __nv_bfloat16* out, int M,
                        int N, int K, cudaStream_t stream) {
  using L = Tiles<BN, GATED, STAGES>;
  auto kernel = gemm_kernel<BN, GATED, STAGES>;
  const cudaError_t attr = hopper::allow_smem(kernel, L::kBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((M + kBM - 1) / kBM, (N + BN - 1) / BN);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(a, b0, b1, out, M, N, K);
  return cudaGetLastError();
}

// 128-column tiles where they give nine SMs in ten a CTA, else 64 (more
// CTAs for a small M); each ring about 192 KB deep.
template <bool GATED>
cudaError_t launch_tiled(const CUtensorMap& a, const CUtensorMap& b0,
                         const CUtensorMap& b1, __nv_bfloat16* out, int M,
                         int N, int K, cudaStream_t stream) {
  static const int n_sm = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess) {
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    }
    return n;
  }();
  const long long ctas = (long long)((M + kBM - 1) / kBM) * ((N + 127) / 128);
  if (ctas * 10 >= n_sm * 9) {
    return launch_gemm<128, GATED, GATED ? 4 : 6>(a, b0, b1, out, M, N, K,
                                                  stream);
  }
  return launch_gemm<64, GATED, GATED ? 6 : 8>(a, b0, b1, out, M, N, K,
                                               stream);
}

// h (M, F) = silu(x @ Wg) * (x @ Wu), then out (M, D) = h @ Wd
cudaError_t launch_bf16(const void* x, const void* wg, const void* wu,
                        const void* wd, __nv_bfloat16* h, void* out, int M,
                        int D, int F, cudaStream_t stream) {
  CUtensorMap x_map, wg_map, wu_map, h_map, wd_map;
  using hopper::make_map;
  if (!make_map(&x_map, x, M, D, kBM) || !make_map(&wg_map, wg, D, F, kBK) ||
      !make_map(&wu_map, wu, D, F, kBK) || !make_map(&h_map, h, M, F, kBM) ||
      !make_map(&wd_map, wd, F, D, kBK)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err =
      launch_tiled<true>(x_map, wg_map, wu_map, h, M, F, D, stream);
  if (err != cudaSuccess) return err;
  return launch_tiled<false>(h_map, wd_map, wd_map,
                            static_cast<__nv_bfloat16*>(out), M, D, F, stream);
}

}  // namespace swiglu_wg

// C entry point, bound from Python with ctypes.  `scratch`: in f32 the
// partials, ceil(F / 128) * M * D f32 (D a multiple of 128); in bf16 the
// hidden activations, M * F bf16 (D a multiple of 8).  F is a multiple of 8.
// Returns the first failing launch's cudaError_t (0 = both launched).
extern "C" int fused_swiglu(const void* x, const void* w_gate,
                            const void* w_up, const void* w_down,
                            void* scratch, void* out, int M, int D, int F,
                            int dtype, void* stream) {
  if (D <= 0 || D % 8 != 0 || F <= 0 || F % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case paged::kFloat32:
      if (D % swiglu::kBN != 0) return (int)cudaErrorInvalidValue;
      return (int)swiglu::launch_f32(
          static_cast<const float*>(x), static_cast<const float*>(w_gate),
          static_cast<const float*>(w_up), static_cast<const float*>(w_down),
          static_cast<float*>(scratch), static_cast<float*>(out), M, D, F, s);
    case paged::kBFloat16:
      return (int)swiglu_wg::launch_bf16(
          x, w_gate, w_up, w_down, static_cast<__nv_bfloat16*>(scratch), out,
          M, D, F, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
