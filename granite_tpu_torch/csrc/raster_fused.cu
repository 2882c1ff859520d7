// Kernel B2: binned rasterization + visibility resolve into 32 attribute
// planes.
//
// Replaces granite_tpu/ops/raster_fused.py:_fused_kernel (reached through
// rasterize_resolve from scene_renderer.fused_raster_surface).  Pass 1 is
// the tile walk of raster_walk.cuh tracking each pixel's winning GLOBAL
// packet row (small rows 0..n_packets-1, huge rows offset by n_packets).
// The reference then re-streamed the winners' chunks and fetched their
// payload with one-hot MXU matmuls; on Hopper each pixel simply loads its
// winner's 64-lane payload row from device memory (L2-resident for the
// packets of a frame), so there is no per-tile payload table and no
// capacity limit (dense tiles of the bench exceed 30k entries).
//
// Bound: the walk's FP32 arithmetic, as in B1; the resolve adds ~256 B of
// payload reads and 128 B of plane writes per pixel (~0.8 GB a 1080p
// frame, well under a millisecond of HBM time).
//
// Planes (PLANE_* of ops/raster_fused.py): depth, covered, pos3, nrm3,
// tan4, uv2, duv/dx2, duv/dy2, base4, mr2, bundle, emissive3, prev3, 0.
// Interpolation folds the triangle origin into the adjugate constant
// (lam_i = a_i*px + b_i*py + c_i) with analytic derivatives, in the
// plain version's operation order (compiled with --fmad=false).

#include "raster_walk.cuh"

namespace granite {

constexpr int PAYLOAD_LO = 21;

__global__ void __launch_bounds__(WALK_THREADS)
raster_resolve_kernel(const int* __restrict__ starts,
                      const int* __restrict__ huge_starts,
                      const float* __restrict__ packets, int n_packets,
                      const float* __restrict__ huge_rows,
                      float* __restrict__ planes, int tiles_x, int tiles_y,
                      int span_w, int span_h, int has_prev) {
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
  walk_tile<true>(starts, huge_starts, packets, n_packets, huge_rows,
                  tiles_x, tiles_y, span_w, span_h, tx, ty, px, py0, depth,
                  win, sh);
  // Park the walk's registers in shared memory so the resolve loop below
  // can index pixels at run time without pushing depth/win to local
  // memory for the whole walk.
  __shared__ float s_depth[WALK_THREADS * PIX];
  __shared__ int s_win[WALK_THREADS * PIX];
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    s_depth[i * WALK_THREADS + threadIdx.x] = depth[i];
    s_win[i * WALK_THREADS + threadIdx.x] = win[i];
  }

  const int pw = tiles_x * TILE_W;
  const int ph = tiles_y * TILE_H;
  const size_t plane = (size_t)ph * pw;
  const size_t x = (size_t)(tx * TILE_W + col);
  for (int i = 0; i < PIX; ++i) {
    const int gid = s_win[i * WALK_THREADS + threadIdx.x];
    const float py = py0 + (float)i;
    float* o = planes + (size_t)(ty * TILE_H + row0 + i) * pw + x;
    const float* src = nullptr;
    if (gid >= 0) {
      src = (gid < n_packets ? packets + (size_t)gid * PACKET_F32
                             : huge_rows + (size_t)(gid - n_packets) *
                                               PACKET_F32) +
            PAYLOAD_LO;
    }
    auto ld = [&](int k) { return src ? __ldg(src + k) : 0.0f; };
    const float a0 = ld(0), b0 = ld(1), c0 = ld(2);
    const float a1 = ld(3), b1 = ld(4), c1 = ld(5);
    const float a2 = ld(6), b2 = ld(7), c2 = ld(8);
    const float l0 = a0 * px + b0 * py + c0;
    const float l1 = a1 * px + b1 * py + c1;
    const float l2 = a2 * px + b2 * py + c2;
    float D = l0 + l1 + l2;
    const float Dx = a0 + a1 + a2;
    const float Dy = b0 + b1 + b2;
    D = fabsf(D) < 1e-20f ? 1e-20f : D;
    const float inv_d = 1.0f / D;
    o[0 * plane] = s_depth[i * WALK_THREADS + threadIdx.x];
    o[1 * plane] = gid >= 0 ? 1.0f : 0.0f;
    for (int k = 0; k < 12; ++k) {
      const float v0 = ld(9 + k), v1 = ld(21 + k), v2 = ld(33 + k);
      const float val = (l0 * v0 + l1 * v1 + l2 * v2) * inv_d;
      if (k < 10) {
        o[(2 + k) * plane] = val;  // PLANE_POS.. PLANE_TAN
      } else {
        const float nx = a0 * v0 + a1 * v1 + a2 * v2;
        const float ny = b0 * v0 + b1 * v1 + b2 * v2;
        o[(12 + k - 10) * plane] = val;                      // PLANE_UV
        o[(14 + k - 10) * plane] = (nx - val * Dx) * inv_d;  // PLANE_DUVDX
        o[(16 + k - 10) * plane] = (ny - val * Dy) * inv_d;  // PLANE_DUVDY
      }
    }
    for (int k = 0; k < 4; ++k) o[(18 + k) * plane] = ld(45 + k);  // base
    o[22 * plane] = ld(49);                                        // mr
    o[23 * plane] = ld(50);
    o[24 * plane] = ld(51);                                        // bundle
    for (int k = 0; k < 3; ++k) {
      o[(25 + k) * plane] = ld(52 + k);                            // emissive
      o[(28 + k) * plane] =
          has_prev
              ? (l0 * ld(55 + k) + l1 * ld(58 + k) + l2 * ld(61 + k)) * inv_d
              : 0.0f;
    }
    o[31 * plane] = 0.0f;
  }
}

}  // namespace granite

extern "C" int granite_raster_resolve(const int* starts,
                                      const int* huge_starts,
                                      const float* packets, int n_packets,
                                      const float* huge_rows, float* planes,
                                      int tiles_x, int tiles_y, int span_w,
                                      int span_h, int has_prev,
                                      cudaStream_t stream) {
  const int ntiles = tiles_x * tiles_y;
  if (ntiles > 0) {
    granite::raster_resolve_kernel<<<ntiles, granite::WALK_THREADS, 0,
                                     stream>>>(
        starts, huge_starts, packets, n_packets, huge_rows, planes, tiles_x,
        tiles_y, span_w, span_h, has_prev);
  }
  return (int)cudaGetLastError();
}
