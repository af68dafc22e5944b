// The grouped experts' gate and up products: h[r] = silu(x[tok[r]] Wg[e])
// * (x[tok[r]] Wu[e]) for every row r of every tile (e, first row, rows) in
// use, rounded to bf16 once.  The design, the TPU kernel it replaces (none)
// and its bound: grouped_expert.cuh.
#include "grouped_expert.cuh"

// C entry point, bound from Python with ctypes.  x (n_tokens, D), w_gate
// and w_up (E, D, F), h (n_rows, F), all bf16; tok (n_rows) int32; tiles
// (max_tiles, 5) int32 and n_tiles (1) int32 on the device (the
// wrapper's layout, at most 64 rows a tile).  D and F are multiples of 8.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int grouped_gate_up(const void* x, const void* w_gate,
                               const void* w_up, const void* tok,
                               const void* tiles, const void* n_tiles,
                               void* h, int n_tokens, int n_rows, int D,
                               int F, int E, int max_tiles,
                               void* stream) {
  if (D <= 0 || D % 8 != 0 || F <= 0 || F % 8 != 0 || E <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows == 0 || max_tiles == 0 || n_tokens == 0) return 0;
  CUtensorMap wg_map, wu_map;
  if (!hopper::make_map_3d(&wg_map, w_gate, E, D, F, grouped::kBK) ||
      !hopper::make_map_3d(&wu_map, w_up, E, D, F, grouped::kBK)) {
    return (int)cudaErrorInvalidValue;
  }
  grouped::Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.tok = static_cast<const int*>(tok);
  a.tiles = static_cast<const int*>(tiles);
  a.n_tiles = static_cast<const int*>(n_tiles);
  a.out = static_cast<__nv_bfloat16*>(h);
  a.n_out = F;
  a.n_red = D;
  a.out_tiles = (F + grouped::kCols - 1) / grouped::kCols;
  return (int)grouped::launch<true>(wg_map, wu_map, wu_map, a, max_tiles,
                                    static_cast<cudaStream_t>(stream));
}
