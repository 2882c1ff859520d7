// Tile walk shared by kernels B1 (raster_binned.cu) and B2
// (raster_fused.cu): the walk itself lives in raster_walk.cu; each
// kernel's entry point runs it, then its own resolve phase over the keys
// it leaves (one thread per pixel).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace granite {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int PACKET_F32 = 128;
constexpr int COL_TRI = 20;
constexpr int RESOLVE_THREADS = 256;

// What one launch of the walk reads and writes.
struct WalkArgs {
  const int4* items;      // work list: [tile, segment, first row, rows]
  const int* n_items;     // (1,) its length (on the device)
  const float* packets;   // (n_small, 128) small-triangle packets
  const float* huge_rows;  // (n_huge, 128) huge-list packets
  // (ph * pw) merged keys (depth bits << 32 | ~walk ordinal), then one
  // more word whose low half is the work counter
  unsigned long long* keys;
  int tiles_x;
  int tiles_y;
  int n_window;           // span_w * span_h: the huge segment is 1 + this
  unsigned int stride;    // walk ordinal = segment * stride + packet row
};

// Clears the keys and the counter, then walks every item of the work
// list (raster_walk.cu).  Returns the first CUDA error.
int launch_walk(const WalkArgs& a, cudaStream_t stream);

// The winning packet row of a non-zero key.
__device__ __forceinline__ const float* winner_row(unsigned long long key,
                                                   const WalkArgs& a) {
  const unsigned int ordinal = 0xFFFFFFFFu - (unsigned int)key;
  const unsigned int seg = ordinal / a.stride;
  const unsigned int row = ordinal - seg * a.stride;
  return (seg == (unsigned int)(1 + a.n_window) ? a.huge_rows : a.packets) +
         (size_t)row * PACKET_F32;
}

}  // namespace granite
