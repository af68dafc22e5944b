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
// plain version's codes and scales (IEEE division, rintf, no fast math).
//
// Bound on an H100: bytes.  It reads L * n full-width pages and writes half
// (bf16) or a quarter (f32) of that as codes, plus 4 * H bytes of scales per
// page; a few operations per element, far below the tensor cores.  The
// design: one CTA per (page, layer).  Pass 1 reads the page in 16-byte
// vectors and keeps a running |x| max per thread for the head it is on,
// folding it into the head's shared max with atomicMax on the float's bits
// (valid: every value is >= 0) when the head changes and at the end.  Pass 2
// reads the page again -- from L2, where pass 1 just put it -- and writes the
// codes, 8 (bf16) or 4 (f32) per store.  Device memory sees each input byte
// once.
#include "swap_pages_common.cuh"

namespace swap {

template <typename T>
__global__ void __launch_bounds__(kThreads) gather_q8_kernel(
    const T* __restrict__ pages,       // (L, n_phys, page_size, H, hd)
    const int* __restrict__ ids,       // (n,)
    int8_t* __restrict__ q,            // (L, n, page_size, H, hd)
    float* __restrict__ scales,        // (L, n, 1, H, 1)
    int n_phys, int n, int page_size, int n_heads, int hd) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ unsigned amax_bits[kMaxHeads];
  __shared__ float safe_s[kMaxHeads];

  const int i = blockIdx.x, l = blockIdx.y;
  const int id = __ldg(ids + i);
  const int page_elems = page_size * n_heads * hd;
  const int n_vec = page_elems / kVec;
  const int head_vecs = hd / kVec;
  const size_t page_out = (size_t)l * n + i;
  const uint4* src = reinterpret_cast<const uint4*>(
      pages + ((size_t)l * n_phys + id) * page_elems);

  for (int h = threadIdx.x; h < n_heads; h += kThreads) amax_bits[h] = 0u;
  __syncthreads();

  int cur = -1;
  float m = 0.f;
  for (int v = threadIdx.x; v < n_vec; v += kThreads) {
    const int h = (v / head_vecs) % n_heads;
    if (h != cur) {
      if (cur >= 0) atomicMax(&amax_bits[cur], __float_as_uint(m));
      cur = h;
      m = 0.f;
    }
    const uint4 raw = __ldg(src + v);
    const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < kVec; ++e) m = fmaxf(m, fabsf(to_float(x[e])));
  }
  if (cur >= 0) atomicMax(&amax_bits[cur], __float_as_uint(m));
  __syncthreads();

  for (int h = threadIdx.x; h < n_heads; h += kThreads) {
    const float scale = __uint_as_float(amax_bits[h]) / 127.f;
    scales[page_out * n_heads + h] = scale;
    safe_s[h] = scale > 0.f ? scale : 1.f;
  }
  __syncthreads();

  CodeWord<T>* dst = reinterpret_cast<CodeWord<T>*>(q + page_out * page_elems);
  for (int v = threadIdx.x; v < n_vec; v += kThreads) {
    const float safe = safe_s[(v / head_vecs) % n_heads];
    const uint4 raw = __ldg(src + v);
    const T* x = reinterpret_cast<const T*>(&raw);
    CodeWord<T> word;
    int8_t* c = reinterpret_cast<int8_t*>(&word);
#pragma unroll
    for (int e = 0; e < kVec; ++e) c[e] = quantize(to_float(x[e]), safe);
    dst[v] = word;
  }
}

template <typename T>
cudaError_t launch(const void* pages, const int* ids, void* q, void* scales,
                   int L, int n_phys, int n, int page_size, int n_heads, int hd,
                   cudaStream_t stream) {
  if (hd % (16 / sizeof(T)) != 0) return cudaErrorInvalidValue;
  gather_q8_kernel<T><<<dim3(n, L), kThreads, 0, stream>>>(
      static_cast<const T*>(pages), ids, static_cast<int8_t*>(q),
      static_cast<float*>(scales), n_phys, n, page_size, n_heads, hd);
  return cudaGetLastError();
}

}  // namespace swap

extern "C" int swap_gather_pages_q8(const void* pages, const void* ids,
                                    void* q, void* scales, int L, int n_phys,
                                    int n, int page_size, int n_heads, int hd,
                                    int dtype, void* stream) {
  if (n_heads <= 0 || n_heads > swap::kMaxHeads || hd <= 0 || L > 65535) {
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
