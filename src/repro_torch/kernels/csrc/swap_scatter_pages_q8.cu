// INT8 dequantization fused with the KV page scatter, for Hopper (sm_90a):
// the swap-in and handoff import of the INT8 host tier
// (host_kv_dtype="int8").
//
// Replaces the TPU kernel `swap_scatter_pages_q8` (src/repro/kernels/swap.py:204,
// pallas_call at :221).  For staged page i of layer l it writes
//   pages[l, ids[i], s, h, d] = T(float(q[l, i, s, h, d]) * scales[l, i, h])
// in place, the product in f32 and rounded once to the pool's dtype (round
// to nearest even for bf16): bit for bit the plain version.
//
// Bound on an H100: bytes.  It reads the codes (a quarter or half of the
// page bytes) and 4 * H bytes of scales per page and writes L * n
// full-width pages; one multiply per element.  The design: one CTA per
// (page, layer); the CTA loads its H scales into shared memory, then each
// thread turns one 8- (bf16) or 4-byte (f32) word of codes into one 16-byte
// vector of the pool's dtype, neighbouring threads on neighbouring
// addresses.  Padded ids repeat the sink page; those CTAs race on the sink,
// which is never read, and no page outside ids is touched.
#include "swap_pages_common.cuh"

namespace swap {

template <typename T>
__global__ void __launch_bounds__(kThreads) scatter_q8_kernel(
    T* __restrict__ pages,             // (L, n_phys, page_size, H, hd), in place
    const int* __restrict__ ids,       // (n,)
    const int8_t* __restrict__ q,      // (L, n, page_size, H, hd)
    const float* __restrict__ scales,  // (L, n, 1, H, 1)
    int n_phys, int n, int page_size, int n_heads, int hd) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float scale_s[kMaxHeads];

  const int i = blockIdx.x, l = blockIdx.y;
  const int id = __ldg(ids + i);
  const int page_elems = page_size * n_heads * hd;
  const int n_vec = page_elems / kVec;
  const int head_vecs = hd / kVec;
  const size_t page_in = (size_t)l * n + i;

  for (int h = threadIdx.x; h < n_heads; h += kThreads) {
    scale_s[h] = __ldg(scales + page_in * n_heads + h);
  }
  __syncthreads();

  const CodeWord<T>* src =
      reinterpret_cast<const CodeWord<T>*>(q + page_in * page_elems);
  uint4* dst = reinterpret_cast<uint4*>(
      pages + ((size_t)l * n_phys + id) * page_elems);
  for (int v = threadIdx.x; v < n_vec; v += kThreads) {
    const float scale = scale_s[(v / head_vecs) % n_heads];
    const CodeWord<T> word = src[v];
    const int8_t* c = reinterpret_cast<const int8_t*>(&word);
    uint4 raw;
    T* x = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int e = 0; e < kVec; ++e) x[e] = from_float<T>(static_cast<float>(c[e]) * scale);
    dst[v] = raw;
  }
}

template <typename T>
cudaError_t launch(void* pages, const int* ids, const void* q,
                   const void* scales, int L, int n_phys, int n, int page_size,
                   int n_heads, int hd, cudaStream_t stream) {
  if (hd % (16 / sizeof(T)) != 0) return cudaErrorInvalidValue;
  scatter_q8_kernel<T><<<dim3(n, L), kThreads, 0, stream>>>(
      static_cast<T*>(pages), ids, static_cast<const int8_t*>(q),
      static_cast<const float*>(scales), n_phys, n, page_size, n_heads, hd);
  return cudaGetLastError();
}

}  // namespace swap

extern "C" int swap_scatter_pages_q8(void* pages, const void* ids,
                                     const void* q, const void* scales, int L,
                                     int n_phys, int n, int page_size,
                                     int n_heads, int hd, int dtype,
                                     void* stream) {
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
