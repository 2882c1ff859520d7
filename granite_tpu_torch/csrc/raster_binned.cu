// Kernel B1: depth-only binned rasterization into a visibility buffer.
//
// Replaces granite_tpu/ops/raster_binned.py:_raster_tile_kernel (reached
// through rasterize_binned).  One block per 32x128 tile walks its exact
// bin, its window bins and its row's huge list (raster_walk.cuh) and
// writes depth (f32, reverse-Z, 0 = clear) and the winning triangle id
// (int32, -1 = none) for the padded (tiles_y*32, tiles_x*128) target.
//
// Bound: FP32 arithmetic of the edge/z tests (see raster_walk.cuh); the
// outputs are 8 bytes a pixel.  Used for the 2048^2 sun shadow map and
// the 48 clustered-light atlas slices (512^2) of the bench frame.

#include "raster_walk.cuh"

namespace granite {

__global__ void __launch_bounds__(WALK_THREADS)
raster_binned_kernel(const int* __restrict__ starts,
                     const int* __restrict__ huge_starts,
                     const float* __restrict__ packets,
                     const float* __restrict__ huge_rows,
                     float* __restrict__ depth_out, int* __restrict__ tri_out,
                     int tiles_x, int tiles_y, int span_w, int span_h) {
  __shared__ WalkShared sh;
  const int tile = blockIdx.x;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int col = threadIdx.x % TILE_W;
  const int row0 = (threadIdx.x / TILE_W) * PIX;
  const float px = (float)(tx * TILE_W + col) + 0.5f;
  const float py0 = (float)(ty * TILE_H + row0) + 0.5f;
  float depth[PIX];
  int win[PIX];
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    depth[i] = 0.0f;
    win[i] = -1;
  }
  // B1 walks the small array with n_packets unused (ids, not rows).
  walk_tile<false>(starts, huge_starts, packets, 0, huge_rows, tiles_x,
                   tiles_y, span_w, span_h, tx, ty, px, py0, depth, win, sh);
  const int pw = tiles_x * TILE_W;
  const size_t x = (size_t)(tx * TILE_W + col);
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const size_t y = (size_t)(ty * TILE_H + row0 + i);
    depth_out[y * pw + x] = depth[i];
    tri_out[y * pw + x] = win[i];
  }
}

}  // namespace granite

extern "C" int granite_raster_binned(const int* starts, const int* huge_starts,
                                     const float* packets,
                                     const float* huge_rows, float* depth,
                                     int* tri, int tiles_x, int tiles_y,
                                     int span_w, int span_h,
                                     cudaStream_t stream) {
  const int ntiles = tiles_x * tiles_y;
  if (ntiles > 0) {
    granite::raster_binned_kernel<<<ntiles, granite::WALK_THREADS, 0,
                                    stream>>>(
        starts, huge_starts, packets, huge_rows, depth, tri, tiles_x,
        tiles_y, span_w, span_h);
  }
  return (int)cudaGetLastError();
}
