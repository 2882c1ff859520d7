// Kernel B3: approximate-trilinear fetch from packed LOD strips.
//
// Replaces granite_tpu/ops/tile_sampler.py:_sample_kernel, quad_parent
// mode (reached through sample_tiled from
// scene_renderer._material_shade_tail and
// environment.sample_environment_tiled).  The TPU kernel planned texel
// rects per tile, DMA'd them into VMEM and fetched with one-hot MXU
// matmuls, because per-pixel gathers were slow on the TPU.  The function
// is ops/texture.sample_packed_lod: clamp the lod, take floor(lod), find
// the texel in the level's gutter rows (repeat addressing; the float ->
// int conversion saturates like XLA's), read its ONE 5C-channel row
// [t00 t10 t01 t11 | parent] and lerp the bilinear quad toward the
// parent tap.  bundle outside [0, N), non-finite u or v and NaN lod give
// 0; the output is nan_to_num'd (nan -> 0, +inf -> 1, -inf -> 0).
//
// Bound on Hopper: bytes, and in a naive port the load/store units
// before them.  A pixel reads one row (120 B of f16 for the 12 material
// channels, 80 B of f32 for the environment) and writes C floats, for
// ~10 FP32 ops a channel.  One thread a pixel with scalar loads makes
// every warp-wide load touch up to 32 rows (60 such loads a material
// pixel) and every store span 1.5 KB, so the LSU pipe sets the time.
//
// The design: warp-cooperative gathers through shared memory.
// - A warp takes a batch of 32 consecutive pixels.  Each lane decodes
//   one pixel (bundle, u, v, lod -> flat strip row, fx, fy, frac) into
//   registers.  The four per-pixel inputs are read as rows of contiguous
//   elements through a row stride, so views of the uv planes need no
//   copy.
// - The persistent block count is worked out on a device's first launch
//   and kept: the frames are host-bound, so no occupancy query a call.
// - The warp copies the batch's rows into shared memory with cp.async in
//   chunks, chunk k on lane k % 32: 8-B chunks where rows are only 8-B
//   aligned (f16 C=12: 120 B), 16-B chunks otherwise (f32 C=4: 80 B).
//   One copy instruction then covers 2-3 neighbouring rows instead of 32
//   scattered ones.  Pixels that read nothing (uncovered, non-finite)
//   copy nothing.
// - Persistent blocks walk the batches in a grid-stride loop with two
//   staging buffers a warp: while a batch is computed, the next batch's
//   rows are in flight and the inputs of the one after that load.
// - Each lane reads its own row back in the same chunks.  A row is an
//   odd number of chunks (15 or 5), so the lanes of each shared-memory
//   phase fall on distinct banks with no padding.  The lerps keep the
//   plain version's order and the build's --fmad=false rounds each
//   product on its own: the result is bit-equal to sample_lod_plain.
// - C=12 stages the warp's 32 x 12 outputs in shared memory and writes
//   them as contiguous float4s (1,536 B in 3 instructions); C=4 is one
//   float4 a lane, contiguous already.
// Rejected: the texture unit's hardware filtering (its weights are 8-bit
// fixed point, so the 1e-6 gate against the plain version fails);
// computing the material lod in the kernel (the TPU kernel takes it as
// an input too); padding the strips (the strip builders are held
// bit-equal to the reference's, and a second copy costs memory).
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

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ float nan_to_num(float x) {
  if (isnan(x)) return 0.0f;
  if (isinf(x)) return x > 0.0f ? 1.0f : 0.0f;
  return x;
}

namespace b3 {

constexpr int WARPS = 4;  // warps a block
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

template <int BYTES>
struct Chunk;
template <>
struct Chunk<8> {
  using type = uint2;
};
template <>
struct Chunk<16> {
  using type = uint4;
};

// Byte layout of one variant: texel type T, C channels.
template <typename T, int C>
struct Layout {
  static constexpr int ROW = 5 * C * (int)sizeof(T);  // bytes a strip row
  static constexpr int CHUNK = ROW % 16 == 0 ? 16 : 8;
  static constexpr int CHUNKS = ROW / CHUNK;
  static constexpr int WORDS = ROW / 4;
  static constexpr bool STAGE_OUT = C > 4;  // C=4 is one float4 a lane
  // Blocks an SM that the launch bounds hold the registers to.  C=12: the
  // 6 its shared memory allows (6 x 36,864 B; left free, the compiler
  // takes 94 registers, which allow only 5).  C=4: 9, the 56 registers
  // the compiler takes when free (the 10 its shared memory allows cost
  // registers and ran slower).
  static constexpr int MIN_BLOCKS = STAGE_OUT ? 6 : 9;
  static_assert(ROW % 8 == 0, "strip rows are whole 8-byte chunks");
  static_assert(CHUNKS % 2 == 1,
                "an odd chunk stride keeps the lanes on distinct banks");
  static_assert(C % 4 == 0, "outputs are written as float4s");
};

// One warp's shared memory: two batches of rows, the staged outputs.
template <typename T, int C>
struct WarpShared {
  alignas(16) unsigned char rows[2][32 * Layout<T, C>::ROW];
  alignas(16) float out[Layout<T, C>::STAGE_OUT ? 32 * C : 4];
};

// The per-pixel inputs, each read as rows of `width` contiguous elements:
// element i of input k lies at (i / width) * row[k] + i % width.
struct Inputs {
  const int* bundle;
  const float* u;
  const float* v;
  const float* lod;
  long long width;
  long long row[4];  // bundle, u, v, lod
};

// A decoded pixel: its flat strip row (-1: output 0) and lerp weights.
struct Tap {
  int row;
  float fx, fy, frac;
};

// A pixel's raw inputs (bundle -1: past the end).
struct Raw {
  int b;
  float u, v, lod;
};

__device__ __forceinline__ Raw fetch(const Inputs& in, long long i,
                                     long long n) {
  Raw p{-1, 0.0f, 0.0f, 0.0f};
  if (i < n) {  // n < 2^31 (the wrapper checks): 32-bit division
    const unsigned int w = (unsigned int)in.width;
    const unsigned int r = (unsigned int)i / w;
    const long long c = (unsigned int)i - r * w;
    p.b = in.bundle[r * in.row[0] + c];
    p.u = in.u[r * in.row[1] + c];
    p.v = in.v[r * in.row[2] + c];
    p.lod = in.lod[r * in.row[3] + c];
  }
  return p;
}

__device__ __forceinline__ Tap decode(const Raw& p, int n_bundles, int rows,
                                      int size, int levels) {
  Tap t{-1, 0.0f, 0.0f, 0.0f};
  if (p.b < 0 || p.b >= n_bundles || !isfinite(p.u) || !isfinite(p.v) ||
      isnan(p.lod))
    return t;
  const float lod = fminf(fmaxf(p.lod, 0.0f), (float)(levels - 1));
  const int level = (int)floorf(lod);
  t.frac = lod - (float)level;
  const int ls = max(size >> level, 1);
  const int row0 = 2 * size - ((2 * size) >> level) + level;
  const float lsf = (float)ls;
  const float x = p.u * lsf - 0.5f;
  const float y = p.v * lsf - 0.5f;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  // Repeat addressing (the strips' gutters are baked for it).  The
  // conversion saturates (past 2^31 -> INT_MAX / INT_MIN), like XLA's.
  const int x0 = floor_mod(__float2int_rz(x0f), ls);
  const int y0 = floor_mod(__float2int_rz(y0f), ls);
  t.fx = x - x0f;
  t.fy = y - y0f;
  t.row = (p.b * rows + row0 + y0) * size + x0;
  return t;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned int s = (unsigned int)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(BYTES));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The warp copies its batch's rows into `dst`, chunk k on lane k % 32
// (the pixel's row comes from the lane that decoded it).
template <typename T, int C>
__device__ __forceinline__ void copy_rows(const unsigned char* strip,
                                          int row, unsigned char* dst,
                                          int lane) {
  using L = Layout<T, C>;
#pragma unroll
  for (int t = 0; t < L::CHUNKS; ++t) {
    const int k = t * 32 + lane;
    const int p = k / L::CHUNKS;
    const int j = k - p * L::CHUNKS;
    const int r = __shfl_sync(FULL, row, p);
    if (r >= 0)
      cp_async<L::CHUNK>(dst + p * L::ROW + j * L::CHUNK,
                         strip + (size_t)r * L::ROW + j * L::CHUNK);
  }
}

__device__ __forceinline__ void put_words(uint32_t* w, uint2 q) {
  w[0] = q.x;
  w[1] = q.y;
}

__device__ __forceinline__ void put_words(uint32_t* w, uint4 q) {
  w[0] = q.x;
  w[1] = q.y;
  w[2] = q.z;
  w[3] = q.w;
}

// Element e of a row held as 32-bit words.
template <typename T>
__device__ __forceinline__ float element(const uint32_t* w, int e);

template <>
__device__ __forceinline__ float element<float>(const uint32_t* w, int e) {
  return __uint_as_float(w[e]);
}

template <>
__device__ __forceinline__ float element<__half>(const uint32_t* w, int e) {
  return __half2float(
      __ushort_as_half((unsigned short)(w[e >> 1] >> (16 * (e & 1)))));
}

// Lane `lane` computes its pixel from the staged row; the warp writes the
// batch's outputs.
template <typename T, int C>
__device__ __forceinline__ void shade_batch(const Tap& t,
                                            const unsigned char* rows,
                                            float* stage, float* out,
                                            long long batch, long long n,
                                            int lane) {
  using L = Layout<T, C>;
  float o[C];
#pragma unroll
  for (int c = 0; c < C; ++c) o[c] = 0.0f;
  if (t.row >= 0) {
    uint32_t w[L::WORDS];
    using Q = typename Chunk<L::CHUNK>::type;
    const Q* src = reinterpret_cast<const Q*>(rows + lane * L::ROW);
#pragma unroll
    for (int j = 0; j < L::CHUNKS; ++j)
      put_words(w + j * (L::CHUNK / 4), src[j]);
    const float gx = 1.0f - t.fx;
    const float gy = 1.0f - t.fy;
    const float gf = 1.0f - t.frac;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float q0 = element<T>(w, c);
      const float q1 = element<T>(w, C + c);
      const float q2 = element<T>(w, 2 * C + c);
      const float q3 = element<T>(w, 3 * C + c);
      const float parent = element<T>(w, 4 * C + c);
      // The plain version's order: (q0*gx + q1*fx)*gy + (q2*gx + q3*fx)*fy,
      // then fine*(1-frac) + parent*frac.
      const float top = q0 * gx + q1 * t.fx;
      const float bot = q2 * gx + q3 * t.fx;
      const float fine = top * gy + bot * t.fy;
      o[c] = nan_to_num(fine * gf + parent * t.frac);
    }
  }
  const long long base = batch * 32;
  float4* go = reinterpret_cast<float4*>(out + base * C);
  if constexpr (L::STAGE_OUT) {
    float4* so = reinterpret_cast<float4*>(stage);
#pragma unroll
    for (int q = 0; q < C / 4; ++q)
      so[lane * (C / 4) + q] =
          make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
    __syncwarp();
    const int units = (int)min(32LL, n - base) * (C / 4);
    for (int k = lane; k < units; k += 32) go[k] = so[k];
  } else if (base + lane < n) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q)
      go[lane * (C / 4) + q] =
          make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(THREADS, Layout<T, C>::MIN_BLOCKS)
    sample_lod_kernel(const unsigned char* __restrict__ strip, int n_bundles,
                      int rows, int size, int levels, Inputs in,
                      float* __restrict__ out, long long n) {
  __shared__ WarpShared<T, C> shared[WARPS];
  const int lane = threadIdx.x & 31;
  WarpShared<T, C>& ws = shared[threadIdx.x >> 5];
  const long long batches = (n + 31) / 32;
  const long long stride = (long long)gridDim.x * WARPS;
  long long batch = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (batch >= batches) return;  // the whole warp
  // Three batches in flight: the inputs of batch + 2 strides load while
  // the rows of batch + 1 stride copy and this batch is computed.
  Tap cur = decode(fetch(in, batch * 32 + lane, n), n_bundles, rows, size,
                   levels);
  Raw raw_next = fetch(in, (batch + stride) * 32 + lane, n);
  copy_rows<T, C>(strip, cur.row, ws.rows[0], lane);
  cp_async_commit();
  int buf = 0;
  for (; batch < batches; batch += stride) {
    const long long next = batch + stride;
    const Raw raw_after = fetch(in, (next + stride) * 32 + lane, n);
    Tap nxt{-1, 0.0f, 0.0f, 0.0f};
    if (next < batches) {  // warp-uniform
      nxt = decode(raw_next, n_bundles, rows, size, levels);
      copy_rows<T, C>(strip, nxt.row, ws.rows[buf ^ 1], lane);
    }
    cp_async_commit();      // an empty group on the last batch
    cp_async_wait<1>();     // this batch's rows have landed
    __syncwarp();
    shade_batch<T, C>(cur, ws.rows[buf], ws.out, out, batch, n, lane);
    __syncwarp();           // rows[buf] and out are free again
    cur = nxt;
    raw_next = raw_after;
    buf ^= 1;
  }
}

constexpr int MAX_DEVICES = 64;

// Blocks of the variant that fit on device `dev` at once, worked out on
// the device's first launch and kept (0: not yet known).
template <typename T, int C>
cudaError_t resident_blocks(int dev, long long* fit) {
  static long long known[MAX_DEVICES];
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (known[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sample_lod_kernel<T, C>, THREADS, 0);
    if (err != cudaSuccess) return err;
    known[dev] = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  }
  *fit = known[dev];
  return cudaSuccess;
}

template <typename T, int C>
int launch(const void* strip, int n_bundles, int rows, int size, int levels,
           const Inputs& in, float* out, long long n, cudaStream_t stream) {
  if (n > 0) {
    int dev = 0;
    long long fit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = resident_blocks<T, C>(dev, &fit);
    if (err != cudaSuccess) return (int)err;
    // Persistent: as many blocks as fit on the card at once, or fewer.
    const long long want = ((n + 31) / 32 + WARPS - 1) / WARPS;
    const long long blocks = want < fit ? want : fit;
    sample_lod_kernel<T, C><<<(int)blocks, THREADS, 0, stream>>>(
        static_cast<const unsigned char*>(strip), n_bundles, rows, size,
        levels, in, out, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace b3

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

}  // namespace granite

// B3, f16 texels with 12 channels or f32 texels with 4.  bundle (int32),
// u, v, lod (f32) are read as rows of `width` contiguous elements through
// their row strides in elements; out is a contiguous (n, channels) f32
// array.
extern "C" int granite_sample_lod(
    const void* strip, int is_half, int n_bundles, int rows, int size,
    int channels, const int* bundle, const float* u, const float* v,
    const float* lod, long long width, long long bundle_row, long long u_row,
    long long v_row, long long lod_row, float* out, long long n, int levels,
    cudaStream_t stream) {
  using granite::b3::launch;
  const granite::b3::Inputs in{bundle, u, v, lod, width,
                               {bundle_row, u_row, v_row, lod_row}};
  if (width < 1) return (int)cudaErrorInvalidValue;
  if (is_half && channels == 12)  // materials
    return launch<__half, 12>(strip, n_bundles, rows, size, levels, in, out,
                              n, stream);
  if (!is_half && channels == 4)  // the environment
    return launch<float, 4>(strip, n_bundles, rows, size, levels, in, out,
                            n, stream);
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
             ? granite::kernel_attrs(
                   granite::b3::sample_lod_kernel<__half, 12>, out)
             : granite::kernel_attrs(granite::b3::sample_lod_kernel<float, 4>,
                                     out);
}

extern "C" int granite_attrs_sample_bilinear(int, int* out) {
  return granite::kernel_attrs(granite::sample_bilinear_kernel, out);
}
