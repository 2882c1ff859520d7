// The tile walk of kernels B1 and B2: every slice of the work list
// (ops/raster_binned.walk_items: tile, segment, first packet row, at most
// WALK_SLICE rows) is rasterized over its 32x128 tile and merged per
// pixel into a 64-bit key, (depth bits << 32) | ~walk ordinal, by
// atomicMax.  The maximum key is the sequential walk's result: the
// nearest hit, the first packet in walk order (exact bin, window bins
// (wy, wx), the row's huge list; rows ascending) winning ties.  Because
// the key orders every hit, no step of the walk has to follow walk
// order: packets, pixels and slices run in any order and the result is
// the same.
//
// Replaces the packet streaming of granite_tpu/ops/raster_binned.py
// _raster_tile_kernel and raster_fused.py _fused_kernel (pass 1), where
// the TPU grid walked each tile's whole list in order, DMA-ing 16-row
// packet chunks into VMEM.
//
// What bounds it on this card: the FP32 edge and z tests, one per
// (packet, pixel of its bbox inside the tile) pair, ~24 operations each —
// far below the card's peak for the bench frames (a few million pairs);
// in practice the latency of a packet's test chain.  Bench triangles
// cover a few pixels and crowd together (one 1080p tile holds ~6.5k of
// them), so the design spreads packets, not pixels, over the threads:
//  * pairs: each warp takes one packet at a time (warp w: packets w,
//    w + 8, ... of a stage) and its lanes take the pixels of the packet's
//    bbox inside the tile, 32 at a time; a hit is merged into the tile's
//    keys in shared memory (32 KB) with a 64-bit atomicMax.  No pixel
//    outside a bbox is tested, and 8 packets are in flight a block.
//  * balance: a list is split into slices, and persistent blocks (3 an
//    SM, 48 KB of dynamic shared memory each) take slices from an atomic
//    counter, so the longest bin (~9.4k entries at 1440x810) spreads over
//    many SMs instead of setting the kernel time.
//  * staging: 64-packet stages (lanes 0-23 and 120-127, 128 B a packet)
//    are double-buffered with cp.async, so the next stage loads while
//    this one is tested.
//  * early-z: a slice stops when its stage bound (max zmax, + the sort
//    key's quantum) is not above any pixel of its own depth; skipped
//    packets cannot beat the slice's depth, so not the merged one.
//  * merge: at the end of a slice the block adds its keys to the
//    target's with coalesced 64-bit atomicMax (only covered pixels).
//
// Parity: compiled with --fmad=false; the edge and z terms round in the
// plain version's order (a*(px-ex) + b*(py-ey)) + c, so keys are
// bit-identical to ops/raster_binned.plain_keys.

#include "kernel_attrs.cuh"
#include "raster_walk.cuh"

namespace granite {

namespace {

constexpr int WALK_THREADS = 256;  // 8 warps, one packet each at a time
constexpr int WALK_WARPS = WALK_THREADS / 32;
// 3 blocks an SM: at most 85 registers a thread (the walk needs 80, no
// spill), 3 x 48 KB of shared memory.
constexpr int WALK_MIN_BLOCKS = 3;
constexpr int TILE_PIX = TILE_W * TILE_H;
constexpr int STAGE = 64;          // packets a stage
constexpr int STAGE_F32 = 32;      // lanes 0-23, then 120-127
constexpr int S_ZMAX = 24;         // lane 120
constexpr int S_BBOX = 25;         // lanes 121-124
constexpr float ZQ_PAD = 3.814697265625e-06f;  // 2^-18, the sort quantum

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned int s = (unsigned int)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Dynamic shared memory of a block (48 KB): the tile's keys, then the
// two packet stages.
struct WalkShared {
  unsigned long long keys[TILE_PIX];
  float pk[2][STAGE][STAGE_F32];
};

// Copy stage `s` of the slice (rows first + s*STAGE ...) into buffer s&1.
__device__ __forceinline__ void issue_stage(WalkShared& sh,
                                            const float* rows, int first,
                                            int count, int s) {
  const int base = s * STAGE;
  const int n = min(STAGE, count - base);
  for (int i = threadIdx.x; i < n * 8; i += WALK_THREADS) {
    const int r = i >> 3;
    const int c = i & 7;
    const int lane = c < 6 ? c * 4 : 120 + (c - 6) * 4;
    cp_async16(&sh.pk[s & 1][r][c * 4],
               rows + (size_t)(first + base + r) * PACKET_F32 + lane);
  }
  cp_async_commit();
}

// One packet, tested by the calling warp on the pixels of its bbox inside
// the tile at (gx0, gy0), 32 at a time; hits go to the tile's keys.
__device__ __forceinline__ void test_packet(const float* __restrict__ p,
                                            unsigned int ordinal, int gx0,
                                            int gy0, int lane,
                                            unsigned long long* keys) {
  const int x0 = max((int)p[S_BBOX + 0] - gx0, 0);
  const int y0 = max((int)p[S_BBOX + 1] - gy0, 0);
  const int x1 = min((int)p[S_BBOX + 2] - gx0, TILE_W);
  const int y1 = min((int)p[S_BBOX + 3] - gy0, TILE_H);
  if (x1 <= x0 || y1 <= y0) return;  // warp-uniform
  const int w = x1 - x0;
  const int area = w * (y1 - y0);
  float a[3], b[3], c[3], ex[3], ey[3];
  bool tl[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    a[e] = p[e * 5 + 0];
    b[e] = p[e * 5 + 1];
    c[e] = p[e * 5 + 2];
    ex[e] = p[e * 5 + 3];
    ey[e] = p[e * 5 + 4];
    tl[e] = (a[e] > 0.0f) || ((a[e] == 0.0f) && (b[e] > 0.0f));
  }
  const float zx = p[15], zy = p[16], z0 = p[17], ox = p[18], oy = p[19];
  const unsigned long long lo = 0xFFFFFFFFu - ordinal;
  // Row of pixel i of the bbox: (i + 0.5) / w is at least 0.5 / w from an
  // integer and i < 4096, so the float product truncates exactly.
  const float inv_w = 1.0f / (float)w;
  for (int i = lane; i < area; i += 32) {
    const int ty = (int)(((float)i + 0.5f) * inv_w);
    const int tx = x0 + (i - ty * w);
    const int t = (y0 + ty) * TILE_W + tx;
    const float px = (float)(gx0 + tx) + 0.5f;
    const float py = (float)(gy0 + y0 + ty) + 0.5f;
    bool cover = true;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const float lam = (a[e] * (px - ex[e]) + b[e] * (py - ey[e])) + c[e];
      cover = cover && ((lam > 0.0f) || (tl[e] && lam == 0.0f));
    }
    const float z = (zx * (px - ox) + zy * (py - oy)) + z0;
    // A hit needs z > depth >= 0, so z == 0 never wins.  Keys only grow,
    // so a key not above the current one is dropped before the atomic.
    if (cover && z > 0.0f && z <= 1.0f) {
      const unsigned long long key =
          ((unsigned long long)__float_as_uint(z) << 32) | lo;
      if (key > keys[t]) atomicMax(keys + t, key);
    }
  }
}

__global__ void __launch_bounds__(WALK_THREADS, WALK_MIN_BLOCKS)
raster_walk_kernel(WalkArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  WalkShared& sh = *reinterpret_cast<WalkShared*>(smem);
  __shared__ int s_item;
  const int pw = a.tiles_x * TILE_W;
  const size_t npix = (size_t)a.tiles_y * TILE_H * pw;
  unsigned int* counter = reinterpret_cast<unsigned int*>(a.keys + npix);
  const int n_items = *a.n_items;
  const int huge_seg = 1 + a.n_window;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (;;) {
    if (threadIdx.x == 0) s_item = (int)atomicAdd(counter, 1u);
#pragma unroll
    for (int k = 0; k < TILE_PIX / WALK_THREADS; ++k)
      sh.keys[threadIdx.x + k * WALK_THREADS] = 0ull;
    __syncthreads();
    const int it = s_item;
    if (it >= n_items) break;  // block-uniform
    const int4 item = a.items[it];
    const int ty = item.x / a.tiles_x;
    const int gx0 = (item.x - ty * a.tiles_x) * TILE_W;
    const int gy0 = ty * TILE_H;
    const float* rows = item.y == huge_seg ? a.huge_rows : a.packets;
    const int first = item.z;
    const int count = item.w;
    const unsigned int ord0 = (unsigned int)item.y * a.stride +
                              (unsigned int)first;

    const int n_stages = (count + STAGE - 1) / STAGE;
    issue_stage(sh, rows, first, count, 0);
    for (int s = 0; s < n_stages; ++s) {
      if (s + 1 < n_stages) {
        issue_stage(sh, rows, first, count, s + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int n = min(STAGE, count - s * STAGE);
      const float(*pk)[STAGE_F32] = sh.pk[s & 1];
      for (int r = warp; r < n; r += WALK_WARPS)
        test_packet(pk[r], ord0 + (unsigned int)(s * STAGE + r), gx0, gy0,
                    lane, sh.keys);
      // The stage bound: every warp reduces the stage's zmax.
      float bound = 0.0f;
      if (lane < n) bound = fmaxf(bound, pk[lane][S_ZMAX]);
      if (lane + 32 < n) bound = fmaxf(bound, pk[lane + 32][S_ZMAX]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        bound = fmaxf(bound, __shfl_xor_sync(0xFFFFFFFFu, bound, off));
      __syncthreads();  // every hit of the stage is in the keys
      float mine = 1.0f;
#pragma unroll
      for (int k = 0; k < TILE_PIX / WALK_THREADS; ++k) {
        const unsigned long long key = sh.keys[threadIdx.x + k * WALK_THREADS];
        mine = fminf(mine, __uint_as_float((unsigned int)(key >> 32)));
      }
      // Also the barrier before the next issue overwrites this buffer.
      if (__syncthreads_and((bound + ZQ_PAD) <= mine)) break;
    }
    cp_async_wait<0>();  // an early stop leaves a stage in flight

#pragma unroll
    for (int k = 0; k < TILE_PIX / WALK_THREADS; ++k) {
      const int t = threadIdx.x + k * WALK_THREADS;
      const unsigned long long key = sh.keys[t];
      if (key != 0ull)
        atomicMax(a.keys + (size_t)(gy0 + t / TILE_W) * pw + gx0 + t % TILE_W,
                  key);
    }
    __syncthreads();  // s_item, the keys and the stages are rewritten next
  }
}

}  // namespace

int launch_walk(const WalkArgs& a, cudaStream_t stream) {
  const size_t npix = (size_t)a.tiles_y * TILE_H * a.tiles_x * TILE_W;
  cudaError_t err = cudaMemsetAsync(
      a.keys, 0, (npix + 1) * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  // Persistent blocks: as many as fit on the card at once.
  const int smem = (int)sizeof(WalkShared);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(raster_walk_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, raster_walk_kernel, WALK_THREADS, smem)) != cudaSuccess)
    return (int)err;
  raster_walk_kernel<<<sms * per_sm, WALK_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace granite

extern "C" int granite_attrs_raster_walk(int, int* out) {
  return granite::kernel_attrs(granite::raster_walk_kernel, out);
}
