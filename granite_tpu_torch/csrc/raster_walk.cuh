// Tile walk shared by kernels B1 (raster_binned.cu) and B2
// (raster_fused.cu): one thread block rasterizes one 32x128 screen tile
// against the packet ranges of its bins.
//
// Replaces the packet streaming of granite_tpu/ops/raster_binned.py
// _raster_tile_kernel and raster_fused.py _fused_kernel (pass 1).  On the
// TPU the grid ran tiles in order, double-buffering 16-row packet chunks
// from HBM into VMEM by DMA.  Here each block owns one tile: 256 threads
// x 16 pixels each (one column, 16 rows) keep depth and winner in
// registers; packets are staged through shared memory STAGE rows at a
// time (only the 21 lanes the test needs plus zmax).
//
// What bounds it on the card: arithmetic — every staged packet is
// evaluated against 4096 pixels (3 edge functions + a z plane), ~25 FP32
// ops per pixel, while packet bytes are small and broadcast from shared
// memory.  The design therefore cuts work, not bytes: a per-16-row-group
// tile-bbox union (COL_UNION_X/Y, written by the binner) skips groups
// that cannot reach the tile, and ranges sorted front to back stop early
// once every pixel of the tile is nearer than the stage's bound
// (__syncthreads_and, exact because a later packet can then never pass
// the strict GREATER test).
//
// Parity: the sources are compiled with --fmad=false and the edge and z
// terms are evaluated in the reference's order a*(px-ex) + b*(py-ey) + c,
// so the result is bit-identical to the plain PyTorch version; ties keep
// the first packet in walk order (exact bin, window bins (wy, wx), huge
// row list; rows ascending), and every range is clamped to
// MAX_ENTRIES_PER_TILE like the reference (the wrapper counts the
// clamped entries).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace granite {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int PACKET_F32 = 128;
constexpr int CHUNK = 16;
constexpr int MAX_ENTRIES_PER_TILE = 65536;
constexpr int COL_TRI = 20;
constexpr int COL_ZMAX = 120;
constexpr int COL_UNION_X = 126;
constexpr int COL_UNION_Y = 127;
constexpr int UNION_SHIFT = 11;
constexpr float ZQ_PAD = 3.814697265625e-06f;  // 2^-18

constexpr int WALK_THREADS = 256;
constexpr int PIX = TILE_H * TILE_W / WALK_THREADS;  // 16 rows a thread
constexpr int STAGE = 64;                            // packets per stage
constexpr int STAGE_COLS = 22;                       // lanes 0..20 + zmax

struct WalkShared {
  float pk[STAGE][STAGE_COLS];
  int hit[STAGE];
};

// Walk rows [start, start + count) of `rows`, updating this thread's 16
// pixels.  win receives gid_offset + row when STORE_GID, else the
// packet's triangle id.  Must be called by all threads of the block
// with block-uniform arguments (it synchronizes).
template <bool STORE_GID>
__device__ __forceinline__ void walk_range(
    const float* __restrict__ rows, int start, int count, int gid_offset,
    int tx, int ty, float px, float py0, float (&depth)[PIX],
    int (&win)[PIX], WalkShared& sh) {
  count = min(count, MAX_ENTRIES_PER_TILE);
  const int M = (1 << UNION_SHIFT) - 1;
  for (int base = 0; base < count; base += STAGE) {
    const int n = min(STAGE, count - base);
    for (int i = threadIdx.x; i < n * STAGE_COLS; i += blockDim.x) {
      const int r = i / STAGE_COLS;
      const int c = i - r * STAGE_COLS;
      const size_t g = (size_t)(start + base + r);
      sh.pk[r][c] = rows[g * PACKET_F32 + (c < 21 ? c : COL_ZMAX)];
    }
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      const size_t g = (size_t)(start + base + r);
      const size_t a = (g / CHUNK) * CHUNK;  // union lives on group row 0
      const int ux = (int)rows[a * PACKET_F32 + COL_UNION_X];
      const int uy = (int)rows[a * PACKET_F32 + COL_UNION_Y];
      sh.hit[r] = ((ux & M) <= tx) && (tx <= (ux >> UNION_SHIFT)) &&
                  ((uy & M) <= ty) && (ty <= (uy >> UNION_SHIFT));
    }
    __syncthreads();
    float bound = 0.0f;
    for (int r = 0; r < n; ++r) {
      const float* p = sh.pk[r];
      bound = fmaxf(bound, p[21]);
      if (!sh.hit[r]) continue;
      float xt[3], b[3], ey[3], c[3];
      bool tl[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float a = p[e * 5 + 0];
        b[e] = p[e * 5 + 1];
        c[e] = p[e * 5 + 2];
        xt[e] = a * (px - p[e * 5 + 3]);
        ey[e] = p[e * 5 + 4];
        tl[e] = (a > 0.0f) || ((a == 0.0f) && (b[e] > 0.0f));
      }
      const float zx = p[15] * (px - p[18]);
      const float z1 = p[16];
      const float oy = p[19];
      const float z2 = p[17];
      const int id = STORE_GID ? gid_offset + start + base + r
                               : __float_as_int(p[COL_TRI]);
#pragma unroll
      for (int i = 0; i < PIX; ++i) {
        const float py = py0 + (float)i;
        bool cover = true;
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          const float lam = (xt[e] + b[e] * (py - ey[e])) + c[e];
          cover = cover && ((lam > 0.0f) || (tl[e] && lam == 0.0f));
        }
        const float z = (zx + z1 * (py - oy)) + z2;
        if (cover && z >= 0.0f && z <= 1.0f && z > depth[i]) {
          depth[i] = z;
          win[i] = id;
        }
      }
    }
    float mine = depth[0];
#pragma unroll
    for (int i = 1; i < PIX; ++i) mine = fminf(mine, depth[i]);
    // Barrier too: the next stage may overwrite shared memory after it.
    if (__syncthreads_and((bound + ZQ_PAD) <= mine)) break;
  }
}

// The whole walk of one tile in the reference's order: exact bin, the
// span_h x span_w window bins up-left of it, the tile row's huge list.
template <bool STORE_GID>
__device__ __forceinline__ void walk_tile(
    const int* __restrict__ starts, const int* __restrict__ huge_starts,
    const float* __restrict__ packets, int n_packets,
    const float* __restrict__ huge_rows, int tiles_x, int tiles_y,
    int span_w, int span_h, int tx, int ty, float px, float py0,
    float (&depth)[PIX], int (&win)[PIX], WalkShared& sh) {
  const int ntiles = tiles_x * tiles_y;
  const int b0 = ty * tiles_x + tx;
  walk_range<STORE_GID>(packets, starts[b0], starts[b0 + 1] - starts[b0],
                        0, tx, ty, px, py0, depth, win, sh);
  for (int wy = 0; wy < span_h; ++wy) {
    for (int wx = 0; wx < span_w; ++wx) {
      const int by = ty - wy;
      const int bx = tx - wx;
      if (by < 0 || bx < 0) continue;  // block-uniform
      const int b = ntiles + by * tiles_x + bx;
      walk_range<STORE_GID>(packets, starts[b], starts[b + 1] - starts[b],
                            0, tx, ty, px, py0, depth, win, sh);
    }
  }
  walk_range<STORE_GID>(huge_rows, huge_starts[ty],
                        huge_starts[ty + 1] - huge_starts[ty], n_packets,
                        tx, ty, px, py0, depth, win, sh);
}

}  // namespace granite
