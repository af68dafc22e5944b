// The grouped experts' down product: y[r] = h[r] Wd[e] for every row r of
// every tile (e, first row, rows) in use, rounded to bf16 once.  The
// design, the TPU kernel it replaces (none) and its bound:
// grouped_expert.cuh.
#include "grouped_expert.cuh"

// C entry point, bound from Python with ctypes.  h (n_rows, F), w_down (E,
// F, D), y (n_rows, D), all bf16; tiles (max_tiles, 3) int32 and n_tiles
// (1) int32 on the device (the wrapper's layout, at most 64 rows a tile).
// D and F are multiples of 8.  Returns the launch's cudaError_t (0 =
// launched).
extern "C" int grouped_down(const void* h, const void* w_down,
                            const void* tiles, const void* n_tiles, void* y,
                            int n_rows, int D, int F, int E, int max_tiles,
                            void* stream) {
  if (D <= 0 || D % 8 != 0 || F <= 0 || F % 8 != 0 || E <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows == 0 || max_tiles == 0) return 0;
  CUtensorMap wd_map, h_map;
  if (!hopper::make_map_3d(&wd_map, w_down, E, F, D, grouped::kBK) ||
      !hopper::make_map(&h_map, h, n_rows, F, grouped::kBN)) {
    return (int)cudaErrorInvalidValue;
  }
  grouped::Args a;
  a.x = nullptr;
  a.tok = nullptr;
  a.tiles = static_cast<const int*>(tiles);
  a.n_tiles = static_cast<const int*>(n_tiles);
  a.out = static_cast<__nv_bfloat16*>(y);
  a.n_out = D;
  a.n_red = F;
  a.out_tiles = (D + grouped::kCols - 1) / grouped::kCols;
  return (int)grouped::launch<false>(wd_map, wd_map, h_map, a, max_tiles,
                                     static_cast<cudaStream_t>(stream));
}
