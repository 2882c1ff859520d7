// Kernel B1: depth-only binned rasterization into a visibility buffer.
//
// Replaces granite_tpu/ops/raster_binned.py:_raster_tile_kernel (reached
// through rasterize_binned).  Two phases on one stream: the tile walk of
// raster_walk.cu merges every slice of the work list into per-pixel keys,
// then one thread per pixel turns its key into depth (f32, reverse-Z,
// 0 = clear) and the winning triangle id (int32, -1 = none) for the
// padded (tiles_y*32, tiles_x*128) target.
//
// Bound: the walk's FP32 tests (raster_walk.cu); the resolve moves 8 B of
// key in and 8 B out a pixel, plus the winner's id lane.  Used for the
// 2048^2 sun shadow map and the 48 clustered-light atlas slices (512^2).

#include "kernel_attrs.cuh"
#include "raster_walk.cuh"

namespace granite {

__global__ void __launch_bounds__(RESOLVE_THREADS)
raster_binned_resolve_kernel(WalkArgs a, float* __restrict__ depth,
                             int* __restrict__ tri, int npix) {
  const int p = blockIdx.x * RESOLVE_THREADS + threadIdx.x;
  if (p >= npix) return;
  const unsigned long long key = a.keys[p];
  if (key == 0ull) {
    depth[p] = 0.0f;
    tri[p] = -1;
    return;
  }
  const float* row = winner_row(key, a);
  depth[p] = __uint_as_float((unsigned int)(key >> 32));
  tri[p] = __float_as_int(__ldg(row + COL_TRI));
}

}  // namespace granite

extern "C" int granite_raster_binned(const int* items, const int* n_items,
                                     const float* packets,
                                     const float* huge_rows,
                                     unsigned long long* scratch,
                                     float* depth, int* tri, int tiles_x,
                                     int tiles_y, int n_window, int stride,
                                     cudaStream_t stream) {
  const granite::WalkArgs a{reinterpret_cast<const int4*>(items), n_items,
                            packets, huge_rows, scratch, tiles_x,
                            tiles_y, n_window, (unsigned int)stride};
  const int err = granite::launch_walk(a, stream);
  if (err != 0) return err;
  const int npix = tiles_y * granite::TILE_H * tiles_x * granite::TILE_W;
  const int t = granite::RESOLVE_THREADS;
  if (npix > 0) {
    granite::raster_binned_resolve_kernel<<<(npix + t - 1) / t, t, 0,
                                            stream>>>(a, depth, tri, npix);
  }
  return (int)cudaGetLastError();
}

extern "C" int granite_attrs_raster_binned_resolve(int, int* out) {
  return granite::kernel_attrs(granite::raster_binned_resolve_kernel, out);
}
