// Kernel B3: per-pixel approximate-trilinear fetch from packed LOD strips.
//
// Replaces granite_tpu/ops/tile_sampler.py:_sample_kernel (reached through
// sample_tiled from scene_renderer._material_shade_tail and
// environment.sample_environment_tiled), quad_parent mode.  The reference
// planned texel rects per tile, DMA'd them into VMEM and fetched with
// one-hot MXU matmuls because per-pixel gathers were slow on the TPU.
// Here one thread per pixel computes ops/texture.sample_packed_lod:
// clamp the lod, take floor(lod), find the texel in the level's gutter
// rows, read its ONE 5C-channel row [t00 t10 t01 t11 | parent], and lerp
// the bilinear quad toward the parent tap.  bundle < 0 (uncovered) and
// non-finite coordinates give 0; the output is nan_to_num'd
// (nan -> 0, +inf -> 1, -inf -> 0).
//
// Bound: memory — one random 5C-lane row per pixel (120 B of f16 for the
// 12 material channels, 80 B of f32 for the environment) against ~10
// FP32 ops a channel.  Neighbouring pixels read neighbouring texels, so
// most rows come from L2; the kernel keeps one pass and no staging.
//
// Kernel B3T (granite_sample_bilinear, below): the same reference
// kernel's bilinear_taps mode, the exact f32 clamp-to-edge bilinear fetch
// of raw (H, W, 2) VSM moments at level 0 (reached through
// ops/shadow.py:sample_vsm_shadow_tiled).  The reference laid the moments
// out as a clamp-wrapped mip strip, planned 48-row rects per tile and
// applied the bilinear weights inside a one-hot matmul; here one thread
// per pixel reads the 2x2 footprint as four float2 loads.  Semantics of
// ops/hdr._sample_bilinear_uv: x0 = clamp(floor(u*W - 0.5), 0, W-1)
// (clamped as a float, so +-inf saturate and NaN gives texel 0),
// x1 = min(x0+1, W-1), fx = clamp(x - x0, 0, 1) with NaN kept, so a NaN
// coordinate yields NaN and then 0.  Pixels that are not live return 0;
// the output is nan_to_num'd.  Bound: memory — 32 B of texels, 8 B of
// coordinates, 1 B of mask and 8 B of output a pixel against ~12 FP32
// ops; the 2048^2 moment map (32 MB) stays in the 50 MB L2 across a
// frame's fetch, so no staging.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_attrs.cuh"

namespace granite {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ float nan_to_num(float x) {
  if (isnan(x)) return 0.0f;
  if (isinf(x)) return x > 0.0f ? 1.0f : 0.0f;
  return x;
}

template <typename T, int C>
__global__ void sample_lod_kernel(const T* __restrict__ strip, int n_bundles,
                                  int rows, int size,
                                  const int* __restrict__ bundle,
                                  const float* __restrict__ u_in,
                                  const float* __restrict__ v_in,
                                  const float* __restrict__ lod_in,
                                  float* __restrict__ out, int n,
                                  int levels) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float* o = out + (size_t)i * C;
  const int b = bundle[i];
  const float u = u_in[i];
  const float v = v_in[i];
  float lod = lod_in[i];
  if (b < 0 || b >= n_bundles || !isfinite(u) || !isfinite(v) ||
      isnan(lod)) {
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = 0.0f;
    return;
  }
  lod = fminf(fmaxf(lod, 0.0f), (float)(levels - 1));
  const int l0 = (int)floorf(lod);
  const float frac = lod - (float)l0;
  const int level = min(max(l0, 0), levels - 1);
  const int ls = max(size >> level, 1);
  const int row0 = 2 * size - ((2 * size) >> level) + level;
  const float lsf = (float)ls;
  const float x = u * lsf - 0.5f;
  const float y = v * lsf - 0.5f;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  // repeat addressing (the strips' gutters are baked for it)
  const int x0 = floor_mod((int)x0f, ls);
  const int y0 = floor_mod((int)y0f, ls);
  const float fx = x - x0f;
  const float fy = y - y0f;
  const T* p = strip + (((size_t)b * rows + (row0 + y0)) * size + x0) *
                           (size_t)(5 * C);
  const float gx = 1.0f - fx;
  const float gy = 1.0f - fy;
  const float gf = 1.0f - frac;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float q0 = to_f32(p[c]);
    const float q1 = to_f32(p[C + c]);
    const float q2 = to_f32(p[2 * C + c]);
    const float q3 = to_f32(p[3 * C + c]);
    const float parent = to_f32(p[4 * C + c]);
    const float top = q0 * gx + q1 * fx;
    const float bot = q2 * gx + q3 * fx;
    const float fine = top * gy + bot * fy;
    o[c] = nan_to_num(fine * gf + parent * frac);
  }
}

// floor(x) clamped to [0, hi] in float (matches ops/hdr.clamped_floor).
__device__ __forceinline__ float clamped_floor(float x, int hi) {
  float f = floorf(x);
  if (isnan(f)) f = 0.0f;
  return fminf(fmaxf(f, 0.0f), (float)hi);
}

// clamp to [0, 1] that keeps NaN, like torch.clamp.
__device__ __forceinline__ float clamp01_keep_nan(float t) {
  return t < 0.0f ? 0.0f : (t > 1.0f ? 1.0f : t);
}

__global__ void sample_bilinear_kernel(const float2* __restrict__ img,
                                       int h, int w,
                                       const float* __restrict__ u_in,
                                       const float* __restrict__ v_in,
                                       const uint8_t* __restrict__ live,
                                       float2* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!live[i]) {
    out[i] = make_float2(0.0f, 0.0f);
    return;
  }
  const float x = u_in[i] * (float)w - 0.5f;
  const float y = v_in[i] * (float)h - 0.5f;
  const float x0f = clamped_floor(x, w - 1);
  const float y0f = clamped_floor(y, h - 1);
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const int x1 = min(x0 + 1, w - 1);
  const int y1 = min(y0 + 1, h - 1);
  const float fx = clamp01_keep_nan(x - x0f);
  const float fy = clamp01_keep_nan(y - y0f);
  const float2 t00 = img[(size_t)y0 * w + x0];
  const float2 t10 = img[(size_t)y0 * w + x1];
  const float2 t01 = img[(size_t)y1 * w + x0];
  const float2 t11 = img[(size_t)y1 * w + x1];
  const float gx = 1.0f - fx;
  const float gy = 1.0f - fy;
  // The plain version's order: (t00*gx + t10*fx)*gy + (t01*gx + t11*fx)*fy
  // (built with --fmad=false, so each product rounds on its own).
  const float r0 = (t00.x * gx + t10.x * fx) * gy + (t01.x * gx + t11.x * fx) * fy;
  const float r1 = (t00.y * gx + t10.y * fx) * gy + (t01.y * gx + t11.y * fx) * fy;
  out[i] = make_float2(nan_to_num(r0), nan_to_num(r1));
}

template <typename T, int C>
int launch_sample(const void* strip, int n_bundles, int rows, int size,
                  const int* bundle, const float* u, const float* v,
                  const float* lod, float* out, int n, int levels,
                  cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    sample_lod_kernel<T, C><<<(n + threads - 1) / threads, threads, 0,
                              stream>>>(
        static_cast<const T*>(strip), n_bundles, rows, size, bundle, u, v,
        lod, out, n, levels);
  }
  return (int)cudaGetLastError();
}

}  // namespace granite

extern "C" int granite_sample_lod(const void* strip, int is_half,
                                  int n_bundles, int rows, int size,
                                  int channels, const int* bundle,
                                  const float* u, const float* v,
                                  const float* lod, float* out, int n,
                                  int levels, cudaStream_t stream) {
  using granite::launch_sample;
  if (is_half && channels == 12)
    return launch_sample<__half, 12>(strip, n_bundles, rows, size, bundle, u,
                                     v, lod, out, n, levels, stream);
  if (is_half && channels == 4)
    return launch_sample<__half, 4>(strip, n_bundles, rows, size, bundle, u,
                                    v, lod, out, n, levels, stream);
  if (!is_half && channels == 12)
    return launch_sample<float, 12>(strip, n_bundles, rows, size, bundle, u,
                                    v, lod, out, n, levels, stream);
  if (!is_half && channels == 4)
    return launch_sample<float, 4>(strip, n_bundles, rows, size, bundle, u,
                                   v, lod, out, n, levels, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int granite_sample_bilinear(const float* img, int h, int w,
                                       int channels, const float* u,
                                       const float* v, const uint8_t* live,
                                       float* out, int n,
                                       cudaStream_t stream) {
  if (channels != 2 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int threads = 256;
    granite::sample_bilinear_kernel<<<(n + threads - 1) / threads, threads,
                                      0, stream>>>(
        reinterpret_cast<const float2*>(img), h, w, u, v, live,
        reinterpret_cast<float2*>(out), n);
  }
  return (int)cudaGetLastError();
}

// variant: 0 f16 C=12 (materials), 1 f32 C=4 (environment).
extern "C" int granite_attrs_sample_lod(int variant, int* out) {
  return variant == 0
             ? granite::kernel_attrs(granite::sample_lod_kernel<__half, 12>,
                                     out)
             : granite::kernel_attrs(granite::sample_lod_kernel<float, 4>,
                                     out);
}

extern "C" int granite_attrs_sample_bilinear(int, int* out) {
  return granite::kernel_attrs(granite::sample_bilinear_kernel, out);
}
