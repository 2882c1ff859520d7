// Kernel B2: binned rasterization + visibility resolve into 32 attribute
// planes.
//
// Replaces granite_tpu/ops/raster_fused.py:_fused_kernel (reached through
// rasterize_resolve from scene_renderer.fused_raster_surface).  Pass 1 is
// the tile walk of raster_walk.cu, which leaves each pixel's winning
// packet in a merged key.  The reference then re-streamed the winners'
// chunks and fetched their payload with one-hot MXU matmuls; here a
// second phase runs one thread per pixel: it loads its winner's 64-lane
// payload row from device memory (L2-resident for neighbouring pixels of
// one triangle) and writes the planes with coalesced stores, so there is
// no per-tile payload table and no capacity limit.
//
// Bound: the walk's FP32 tests, as in B1; the resolve moves 8 B of key
// and up to 256 B of payload in and 128 B of planes out a pixel (~0.3 GB
// a 1080p frame, ~0.1 ms of HBM time).
//
// Planes (PLANE_* of ops/raster_fused.py): depth, covered, pos3, nrm3,
// tan4, uv2, duv/dx2, duv/dy2, base4, mr2, bundle, emissive3, prev3, 0.
// Interpolation folds the triangle origin into the adjugate constant
// (lam_i = a_i*px + b_i*py + c_i) with analytic derivatives, in the
// plain version's operation order (compiled with --fmad=false).

#include "kernel_attrs.cuh"
#include "raster_walk.cuh"

namespace granite {

constexpr int PAYLOAD_LO = 21;

__global__ void __launch_bounds__(RESOLVE_THREADS)
raster_fused_resolve_kernel(WalkArgs a, float* __restrict__ planes,
                            int has_prev) {
  const int pw = a.tiles_x * TILE_W;
  const int npix = a.tiles_y * TILE_H * pw;
  const int p = blockIdx.x * RESOLVE_THREADS + threadIdx.x;
  if (p >= npix) return;
  const int y = p / pw;
  const float px = (float)(p - y * pw) + 0.5f;
  const float py = (float)y + 0.5f;
  const size_t plane = (size_t)npix;
  float* o = planes + p;
  const unsigned long long key = a.keys[p];
  const float* src = nullptr;
  if (key != 0ull) src = winner_row(key, a) + PAYLOAD_LO;
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
  o[0] = key ? __uint_as_float((unsigned int)(key >> 32)) : 0.0f;
  o[1 * plane] = key ? 1.0f : 0.0f;
#pragma unroll
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
#pragma unroll
  for (int k = 0; k < 4; ++k) o[(18 + k) * plane] = ld(45 + k);  // base
  o[22 * plane] = ld(49);                                        // mr
  o[23 * plane] = ld(50);
  o[24 * plane] = ld(51);                                        // bundle
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[(25 + k) * plane] = ld(52 + k);                            // emissive
    o[(28 + k) * plane] =
        has_prev
            ? (l0 * ld(55 + k) + l1 * ld(58 + k) + l2 * ld(61 + k)) * inv_d
            : 0.0f;
  }
  o[31 * plane] = 0.0f;
}

}  // namespace granite

extern "C" int granite_raster_resolve(const int* items, const int* n_items,
                                      const float* packets,
                                      const float* huge_rows,
                                      unsigned long long* scratch,
                                      float* planes, int tiles_x,
                                      int tiles_y, int n_window, int stride,
                                      int has_prev, cudaStream_t stream) {
  const granite::WalkArgs a{reinterpret_cast<const int4*>(items), n_items,
                            packets, huge_rows, scratch, tiles_x,
                            tiles_y, n_window, (unsigned int)stride};
  const int err = granite::launch_walk(a, stream);
  if (err != 0) return err;
  const int npix = tiles_y * granite::TILE_H * tiles_x * granite::TILE_W;
  const int t = granite::RESOLVE_THREADS;
  if (npix > 0) {
    granite::raster_fused_resolve_kernel<<<(npix + t - 1) / t, t, 0,
                                           stream>>>(a, planes, has_prev);
  }
  return (int)cudaGetLastError();
}

extern "C" int granite_attrs_raster_fused_resolve(int, int* out) {
  return granite::kernel_attrs(granite::raster_fused_resolve_kernel, out);
}
