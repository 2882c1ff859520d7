// Kernel B4: the whole deferred lighting expression per pixel.
//
// Replaces granite_tpu/ops/shade_fused.py:_shade_kernel (reached through
// shade_planes_fused from scene_renderer.shade_surface_fused).  One thread
// per pixel reads its stacked planes (P_* layout: G-buffer + shadow term,
// specular env, background, irradiance, top-K cluster-shadow slot/term
// planes), then adds: the sun's GGX response times the shadow term;
// ambient or IBL (irradiance diffuse + specular env with fresnel_ibl);
// every clustered point/spot light whose bit is set in the pixel's 64-px
// tile mask word and whose view-depth window [LC_ZLO, LC_ZHI) holds the
// pixel, scaled by its cluster-shadow term; emissive; and the background
// where uncovered.  The light table (<= 32 lights) sits in shared memory.
//
// Bound: memory — 26 + 2k input planes and 3 output planes, 4 bytes each
// (~130 B a pixel, ~270 MB a 1080p frame), against a few hundred FP32 ops
// a pixel for the 8 bench lights that pass the mask.  Coalesced plane
// reads (threads along x) are what the design keeps; the light loop is
// gated per pixel by the mask word, as the reference gated it per tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_attrs.cuh"

namespace granite {

constexpr float PI = 3.1415628f;           // Granite's value (pbr.h)
constexpr float INV_PI = (float)(1.0 / 3.1415628);
constexpr int SHADE_THREADS = 128;
constexpr int MAX_LIGHTS = 32;
constexpr int LIGHT_COLS = 15;             // LC_POS .. LC_ZHI

enum {
  P_BASE = 0, P_NRM = 3, P_METAL = 6, P_ROUGH = 7, P_POS = 8,
  P_EMISSIVE = 11, P_COVERED = 14, P_SHADOW = 15, P_SPECENV = 16,
  P_BACKGROUND = 19, P_AO = 22, P_IRR = 23, P_FIXED = 26
};
enum {
  LC_POS = 0, LC_COLOR = 3, LC_INVR = 6, LC_DIR = 7, LC_SPOT_SCALE = 10,
  LC_SPOT_BIAS = 11, LC_IS_SPOT = 12, LC_ZLO = 13, LC_ZHI = 14
};

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(const Vec3& a, const Vec3& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// ops/pbr.cook_torrance, same operation order.
__device__ __forceinline__ Vec3 cook_torrance(const Vec3& n, const Vec3& v,
                                              const Vec3& l, const Vec3& col,
                                              float shadow, const Vec3& base,
                                              float metal, float rough) {
  const float nov = clampf(dot3(n, v), 1e-3f, 1.0f);
  const float m = rough * rough;
  const float m2 = m * m;
  const float r1 = rough + 1.0f;
  const float k_g = r1 * r1 * 0.125f;
  const float one_m_kg = 1.0f - k_g;
  const float gv = nov * one_m_kg + k_g;
  Vec3 h{l.x + v.x, l.y + v.y, l.z + v.z};
  const float hinv = rsqrtf(fmaxf(dot3(h, h), 1e-20f));
  h.x = h.x * hinv;
  h.y = h.y * hinv;
  h.z = h.z * hinv;
  const float nol = clampf(dot3(n, l), 1e-3f, 1.0f);
  const float hov = clampf(dot3(h, v), 1e-3f, 1.0f);
  const float t = 1.0f - hov;
  const float t2 = t * t;
  const float t5 = t2 * t2 * t;
  const float noh = clampf(dot3(n, h), 1e-4f, 1.0f);
  const float dd = (noh * m2 - noh) * noh + 1.0f;
  const float d = m2 / (PI * dd * dd);
  const float gl = nol * one_m_kg + k_g;
  const float g = 0.25f / fmaxf(gv * gl, 1e-3f);
  const float dg = d * g;
  const float one_m_metal = 1.0f - metal;
  const float b[3] = {base.x, base.y, base.z};
  const float lc[3] = {col.x, col.y, col.z};
  float o[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float f0 = 0.04f + (b[c] - 0.04f) * metal;
    const float f = f0 + (1.0f - f0) * t5;
    const float term = lc[c] * (nol * shadow);
    const float diff = (1.0f - f) * INV_PI * b[c] * one_m_metal;
    o[c] = term * (f * dg + diff);
  }
  return Vec3{o[0], o[1], o[2]};
}

__global__ void __launch_bounds__(SHADE_THREADS)
shade_fused_kernel(const float* __restrict__ planes, int ph, int pw,
                   const float* __restrict__ lights, int n_light_cap,
                   const int* __restrict__ tile_masks, int tm_w,
                   const float* __restrict__ uni, int k_shadow, int has_env,
                   int has_lights, int has_ao, int ambient,
                   float* __restrict__ out) {
  __shared__ float sl[MAX_LIGHTS][LIGHT_COLS];
  const int n_lights = min(n_light_cap, (int)uni[6]);
  for (int i = threadIdx.x; i < n_light_cap * LIGHT_COLS; i += blockDim.x) {
    const int li = i / LIGHT_COLS;
    const int c = i - li * LIGHT_COLS;
    sl[li][c] = lights[li * 128 + c];
  }
  __syncthreads();
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= pw) return;
  const size_t stride = (size_t)ph * pw;
  const float* P = planes + (size_t)y * pw + x;
  auto p1 = [&](int k) { return P[k * stride]; };
  auto p3 = [&](int k) { return Vec3{p1(k), p1(k + 1), p1(k + 2)}; };

  const Vec3 cam{uni[0], uni[1], uni[2]};
  const Vec3 base = p3(P_BASE);
  const Vec3 n = p3(P_NRM);
  const float metal = p1(P_METAL);
  const float rough_raw = p1(P_ROUGH);
  const float rough = rough_raw * 0.75f + 0.25f;
  const Vec3 pos = p3(P_POS);
  Vec3 v{cam.x - pos.x, cam.y - pos.y, cam.z - pos.z};
  const float vinv = rsqrtf(fmaxf(dot3(v, v), 1e-20f));
  v.x = v.x * vinv;
  v.y = v.y * vinv;
  v.z = v.z * vinv;
  const float one_m_metal = 1.0f - metal;

  const Vec3 sun_dir{uni[3], uni[4], uni[5]};
  const Vec3 sun_col{uni[128 + 0], uni[128 + 1], uni[128 + 2]};
  Vec3 s = cook_torrance(n, v, sun_dir, sun_col, p1(P_SHADOW), base, metal,
                         rough);
  const float ao = has_ao ? p1(P_AO) : 1.0f;
  if (ambient) {
    const float amb = 0.05f * one_m_metal * ao;
    s.x = s.x + base.x * amb;
    s.y = s.y + base.y * amb;
    s.z = s.z + base.z * amb;
  }
  if (has_env) {
    const Vec3 irr = p3(P_IRR);
    const float diff = one_m_metal * ao;
    s.x = s.x + irr.x * base.x * diff;
    s.y = s.y + irr.y * base.y * diff;
    s.z = s.z + irr.z * base.z * diff;
    const float nov_env = clampf(dot3(n, v), 0.0f, 1.0f);
    const float t = 1.0f - nov_env;
    const float t2 = t * t;
    const float t5 = t2 * t2 * t;
    const float one_m_rough = 1.0f - rough_raw;
    const Vec3 spec = p3(P_SPECENV);
    const float b[3] = {base.x, base.y, base.z};
    const float sp[3] = {spec.x, spec.y, spec.z};
    float e[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float f0 = 0.04f + (b[c] - 0.04f) * metal;
      e[c] = f0 + (fmaxf(one_m_rough, f0) - f0) * t5;
    }
    s.x = s.x + sp[0] * e[0] * ao;
    s.y = s.y + sp[1] * e[1] * ao;
    s.z = s.z + sp[2] * e[2] * ao;
  }
  if (has_lights) {
    Vec3 acc{0.0f, 0.0f, 0.0f};
    const float pvz =
        -(pos.x * uni[9] + pos.y * uni[10] + pos.z * uni[11] + uni[12]);
    const int word = tile_masks[(y / 64) * tm_w + (x / 64)];
    for (int i = 0; i < n_lights; ++i) {
      if (!((word >> i) & 1)) continue;
      const float* lt = sl[i];
      if (!(pvz >= lt[LC_ZLO] && pvz < lt[LC_ZHI])) continue;
      const float fx = pos.x - lt[LC_POS];
      const float fy = pos.y - lt[LC_POS + 1];
      const float fz = pos.z - lt[LC_POS + 2];
      const Vec3 f{fx, fy, fz};
      const float d2 = fmaxf(dot3(f, f), 1e-12f);
      const float dist = fmaxf(sqrtf(d2), 0.1f);      // MIN_POINT_DIST
      const float inv_d = 1.0f / dist;
      const Vec3 l{-fx * inv_d, -fy * inv_d, -fz * inv_d};
      const float xr = dist * lt[LC_INVR];
      const float tt = clampf((xr - 0.9f) * 10.0f, 0.0f, 1.0f);
      const float static_fall = 1.0f - tt * tt * (3.0f - 2.0f * tt);
      float cone = clampf(-(l.x * lt[LC_DIR] + l.y * lt[LC_DIR + 1] +
                            l.z * lt[LC_DIR + 2]) * lt[LC_SPOT_SCALE] +
                              lt[LC_SPOT_BIAS],
                          0.0f, 1.0f);
      cone = cone * cone;
      const float fall = (lt[LC_IS_SPOT] > 0.5f ? cone : 1.0f) * static_fall;
      const float att = fall / (dist * dist);
      const Vec3 col{lt[LC_COLOR] * att, lt[LC_COLOR + 1] * att,
                     lt[LC_COLOR + 2] * att};
      float sterm = 1.0f;
      for (int j = 0; j < k_shadow; ++j) {
        if (p1(P_FIXED + j) == (float)i) sterm = p1(P_FIXED + k_shadow + j);
      }
      const Vec3 r = cook_torrance(n, v, l, col, sterm, base, metal, rough);
      acc.x = acc.x + r.x;
      acc.y = acc.y + r.y;
      acc.z = acc.z + r.z;
    }
    s.x = s.x + acc.x;
    s.y = s.y + acc.y;
    s.z = s.z + acc.z;
  }
  const Vec3 em = p3(P_EMISSIVE);
  const bool cov = p1(P_COVERED) > 0.5f;
  const Vec3 bg = p3(P_BACKGROUND);
  const size_t o = (size_t)y * pw + x;
  out[o] = cov ? s.x + em.x : bg.x;
  out[stride + o] = cov ? s.y + em.y : bg.y;
  out[2 * stride + o] = cov ? s.z + em.z : bg.z;
}

}  // namespace granite

extern "C" int granite_shade_fused(const float* planes, int n_planes, int ph,
                                   int pw, const float* lights,
                                   int n_light_cap, const int* tile_masks,
                                   int tm_w, const float* uniforms,
                                   int k_shadow, int has_env, int has_lights,
                                   int has_ao, int ambient, float* out,
                                   cudaStream_t stream) {
  if (n_planes < granite::P_FIXED + 2 * k_shadow ||
      n_light_cap > granite::MAX_LIGHTS)
    return (int)cudaErrorInvalidValue;
  if (ph > 0 && pw > 0) {
    const dim3 grid((pw + granite::SHADE_THREADS - 1) /
                        granite::SHADE_THREADS,
                    ph);
    granite::shade_fused_kernel<<<grid, granite::SHADE_THREADS, 0, stream>>>(
        planes, ph, pw, lights, n_light_cap, tile_masks, tm_w, uniforms,
        k_shadow, has_env, has_lights, has_ao, ambient, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int granite_attrs_shade_fused(int, int* out) {
  return granite::kernel_attrs(granite::shade_fused_kernel, out);
}
