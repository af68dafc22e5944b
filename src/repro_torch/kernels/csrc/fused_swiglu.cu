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
// The TPU kernel walks F sequentially for each row tile and carries a
// (blk_m, D) f32 accumulator across the F grid axis in VMEM.  CUDA blocks
// run in no order and a (32, D) f32 accumulator does not fit a block's
// registers at D = 4096, so here F is split across blocks instead: block
// (i, j) computes the hidden tile of rows [32i, 32i + 32) and hidden columns
// [128j, 128j + 128) in shared memory -- the gate and up products over all
// of D, 32 columns of D at a time -- rounds it, multiplies it by its 128
// rows of Wd, and writes that (32, D) f32 partial to a scratch buffer
// (F / 128, M, D).  A second kernel sums the partials in a fixed order and
// rounds the result, so the output is deterministic.  The hidden tile never
// leaves the SM, as on the TPU; the partials cost 8 * M * D * F / 128 bytes
// of traffic.
//
// Bound on an H100: operations, at these widths.  6 * M * D * F FLOPs
// against the weights' 6 * D * F bytes (bf16): at M = 2048, D = 1024,
// F = 2816 that is 35 GFLOP, 36 us at the 989 TFLOP/s bf16 tensor-core
// peak.  In bf16 the products run on the tensor cores as wmma fragments
// (16 x 16 x 16, f32 accumulators) fed from shared memory by plain 16-byte
// loads; each block re-reads its Wg/Wu/Wd slices once per 32 rows of x, so
// at large M the weight traffic through L2 grows with M / 32.  In f32 every
// product is f32 FMA on CUDA cores (67 TFLOP/s peak), each thread owning a
// 4 x 4 register tile.  TMA-fed wgmma with larger row tiles is the next
// step.  Every division is IEEE (no fast math).
#include <mma.h>

#include <algorithm>
#include <type_traits>

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

// -- bf16: the same tiles on the tensor cores --------------------------------
// In bf16 the block computes the same (kBM, kBF) hidden tile and (kBM, D)
// partial, but every product runs as 16 x 16 x 16 bf16 wmma fragments with
// f32 accumulators: warp w owns rows 16 * (w / 4) and columns
// 32 * (w % 4) .. + 32 of each tile (two fragments, for g and for u).  g and
// u share a fragment layout, so silu(g) * u is formed on the fragments
// themselves, staged once as f32 and rounded to bf16 for the down product.
using namespace nvcuda;
// row pitches padded by 16 bytes against bank conflicts (wmma wants a
// multiple of 16 bytes, and each fragment's first element 32-byte aligned)
constexpr int kLdx = kBK + 8;       // bf16
constexpr int kLdw = kBF + 8;       // bf16
constexpr int kLdf = kBF + 4;       // f32: the staged h and outputs
constexpr int kWdRows = 64;         // rows of Wd staged per step
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// bf16 tiles are held as their 16-bit patterns (a union member must be
// trivially constructible) and read through bf()
struct __align__(32) WmmaTiles {
  union {
    struct {                          // the gate/up products' operands
      uint16_t x[kBM * kLdx];
      uint16_t wg[kBK * kLdw];
      uint16_t wu[kBK * kLdw];
    } ab;
    float hf[kBM * kLdf];             // silu(g) * u in f32
    struct {                          // the down product's B tile and output
      uint16_t wd[kWdRows * kLdw];
      float out[kBM * kLdf];
    } d;
  };
  uint16_t h[kBM * kLdw];             // the hidden tile, rounded to bf16
};

__device__ __forceinline__ __nv_bfloat16* bf(uint16_t* p) {
  return reinterpret_cast<__nv_bfloat16*>(p);
}

// Copy rows [row0, row0 + ROWS) and columns [col0, col0 + COLS) of a bf16
// row-major matrix into dst (pitch LD) as 16-byte vectors; what lies outside
// the matrix is 0.
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* __restrict__ dst,
                                           const __nv_bfloat16* __restrict__ src,
                                           int ld, int row0, int n_rows,
                                           int col0, int n_cols) {
  constexpr int kVecPerRow = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow, c = (i % kVecPerRow) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows && col0 + c < n_cols) {
      v = __ldg(reinterpret_cast<const uint4*>(
          src + (size_t)(row0 + r) * ld + col0 + c));
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
  }
}

__global__ void __launch_bounds__(kThreads) swiglu_partial_wmma_kernel(
    const __nv_bfloat16* __restrict__ x,     // (M, D)
    const __nv_bfloat16* __restrict__ wg,    // (D, F)
    const __nv_bfloat16* __restrict__ wu,    // (D, F)
    const __nv_bfloat16* __restrict__ wd,    // (F, D)
    float* __restrict__ partial,             // (ceil(F / kBF), M, D)
    int M, int D, int F) {
  __shared__ WmmaTiles t;
  const int m0 = blockIdx.x * kBM, f0 = blockIdx.y * kBF;
  const int warp = threadIdx.x / 32;
  const int r0 = 16 * (warp / 4), c0 = 32 * (warp % 4);

  FragA a;
  FragB b;
  FragC g[2], u[2];
  for (int j = 0; j < 2; ++j) {
    wmma::fill_fragment(g[j], 0.f);
    wmma::fill_fragment(u[j], 0.f);
  }
  for (int k0 = 0; k0 < D; k0 += kBK) {
    stage_bf16<kBM, kBK, kLdx>(bf(t.ab.x), x, D, m0, M, k0, D);
    stage_bf16<kBK, kBF, kLdw>(bf(t.ab.wg), wg, F, k0, D, f0, F);
    stage_bf16<kBK, kBF, kLdw>(bf(t.ab.wu), wu, F, k0, D, f0, F);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::load_matrix_sync(a, bf(t.ab.x) + r0 * kLdx + kk, kLdx);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(b, bf(t.ab.wg) + kk * kLdw + c0 + 16 * j,
                               kLdw);
        wmma::mma_sync(g[j], a, b, g[j]);
        wmma::load_matrix_sync(b, bf(t.ab.wu) + kk * kLdw + c0 + 16 * j,
                               kLdw);
        wmma::mma_sync(u[j], a, b, u[j]);
      }
    }
    __syncthreads();
  }
  // silu(g) * u on the fragments (one layout for both), staged as f32 and
  // rounded to bf16 as the TPU kernel rounds the hidden tile
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < g[j].num_elements; ++e) {
      const float gv = g[j].x[e];
      const float sig = 1.f / (1.f + expf(-gv));
      g[j].x[e] = gv * sig * u[j].x[e];
    }
    wmma::store_matrix_sync(t.hf + r0 * kLdf + c0 + 16 * j, g[j], kLdf,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBF; i += kThreads) {
    const int r = i / kBF, c = i % kBF;
    bf(t.h)[r * kLdw + c] = __float2bfloat16(t.hf[r * kLdf + c]);
  }

  // the down product h @ Wd[f0 : f0 + kBF], kBN output columns per pass
  FragC acc[2];
  for (int n0 = 0; n0 < D; n0 += kBN) {
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int fc = 0; fc < kBF; fc += kWdRows) {
      __syncthreads();     // h is written; the last reads of wd / out are done
      stage_bf16<kWdRows, kBN, kLdw>(bf(t.d.wd), wd, D, f0 + fc, F, n0, D);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kWdRows; kk += 16) {
        wmma::load_matrix_sync(a, bf(t.h) + r0 * kLdw + fc + kk, kLdw);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::load_matrix_sync(b, bf(t.d.wd) + kk * kLdw + c0 + 16 * j,
                                 kLdw);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(t.d.out + r0 * kLdf + c0 + 16 * j, acc[j], kLdf,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kBM * kBN / 4; i += kThreads) {
      const int r = i / (kBN / 4), c = (i % (kBN / 4)) * 4;
      if (m0 + r < M) {
        *reinterpret_cast<float4*>(
            partial + ((size_t)blockIdx.y * M + m0 + r) * D + n0 + c) =
            *reinterpret_cast<const float4*>(t.d.out + r * kLdf + c);
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

template <typename T>
cudaError_t launch(const void* x, const void* wg, const void* wu,
                   const void* wd, float* partial, void* out, int M, int D,
                   int F, cudaStream_t stream) {
  const int n_parts = (F + kBF - 1) / kBF;
  const dim3 grid((M + kBM - 1) / kBM, n_parts);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    swiglu_partial_wmma_kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(wg),
        static_cast<const T*>(wu), static_cast<const T*>(wd), partial, M, D,
        F);
  } else {
    swiglu_partial_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(wg),
        static_cast<const T*>(wu), static_cast<const T*>(wd), partial, M, D,
        F);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)M * D;
  const int blocks =
      (int)std::min<size_t>((n + kThreads - 1) / kThreads, 132 * 16);
  swiglu_reduce_kernel<T><<<blocks, kThreads, 0, stream>>>(
      partial, static_cast<T*>(out), n_parts, n);
  return cudaGetLastError();
}

}  // namespace swiglu

// C entry point, bound from Python with ctypes.  `partial` is f32 scratch of
// ceil(F / 128) * M * D elements.  D must be a multiple of 128 and F of 8.
// Returns the first launch's failing cudaError_t (0 = both launched).
extern "C" int fused_swiglu(const void* x, const void* w_gate,
                            const void* w_up, const void* w_down,
                            void* partial, void* out, int M, int D, int F,
                            int dtype, void* stream) {
  if (D <= 0 || D % swiglu::kBN != 0 || F <= 0 || F % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (M == 0) return 0;
  float* p = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case paged::kFloat32:
      return (int)swiglu::launch<float>(x, w_gate, w_up, w_down, p, out, M,
                                        D, F, s);
    case paged::kBFloat16:
      return (int)swiglu::launch<__nv_bfloat16>(x, w_gate, w_up, w_down, p,
                                                out, M, D, F, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
