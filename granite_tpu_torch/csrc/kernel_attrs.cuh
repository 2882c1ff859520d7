// What the compiler gave a kernel, read back at run time for the report
// of chip_smoke.py: each source exports `granite_attrs_<name>(variant,
// out)` built on this helper, bound like every other entry point.

#pragma once

#include <cuda_runtime.h>

namespace granite {

// out[0..3] = registers a thread, local (spill) bytes a thread, static
// shared bytes a block, max threads a block.
template <typename Kernel>
inline int kernel_attrs(Kernel* kernel, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return 0;
}

}  // namespace granite
