// Kernel B5: the compile probe's body, acc = acc * 1.0001 + i for i in
// 0 .. N-1, elementwise over an (R, 256) f32 array.
//
// Replaces tools/compile_parallel_probe.py:_kernel_fn's `body` (its
// pl.pallas_call at :44).  On the TPU the probe measures whether two
// Mosaic compiles overlap; here it measures whether two nvcc builds
// overlap (granite_tpu_torch/tools/compile_parallel_probe.py).  N is a
// template parameter so the loop unrolls as it does under Mosaic and each
// N is distinct code: the main library carries the instances 96-99 (the
// four the probe compiles), and the probe's own builds of this source
// pick one with -DGRANITE_PROBE_N_ITERS=N.
//
// __fmul_rn and __fadd_rn keep the multiply and the add two roundings
// whatever the flags: a contracted FMA would part from the plain version
// (a torch mul, then add, N times).
//
// Bound: at N = 96-99 the kernel does 2N FP32 ops for every 8 bytes it
// moves (~25 ops a byte, over the card's ~20), so operations bound it
// by a little; at the probe's sizes (65,536-163,840 elements) either
// bound is a fraction of a microsecond, far under a launch's latency.
// A grid-stride loop with coalesced loads is all the design needs.

#include <cuda_runtime.h>

#include "kernel_attrs.cuh"

namespace granite {

constexpr int PROBE_THREADS = 256;
constexpr int PROBE_MAX_BLOCKS = 132 * 8;

template <int N>
__global__ void __launch_bounds__(PROBE_THREADS)
    compile_probe_kernel(const float* __restrict__ x, float* __restrict__ out,
                         long long n) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    float acc = x[i];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      acc = __fadd_rn(__fmul_rn(acc, 1.0001f), (float)k);
    }
    out[i] = acc;
  }
}

template <int N>
int launch_compile_probe(const float* x, float* out, long long n,
                         cudaStream_t stream) {
  if (n > 0) {
    long long blocks = (n + PROBE_THREADS - 1) / PROBE_THREADS;
    if (blocks > PROBE_MAX_BLOCKS) blocks = PROBE_MAX_BLOCKS;
    compile_probe_kernel<N>
        <<<(unsigned)blocks, PROBE_THREADS, 0, stream>>>(x, out, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace granite

#ifdef GRANITE_PROBE_N_ITERS
// The probe's own build: one instance.
extern "C" int granite_compile_probe_one(const float* x, float* out,
                                         long long n, cudaStream_t stream) {
  return granite::launch_compile_probe<GRANITE_PROBE_N_ITERS>(x, out, n,
                                                               stream);
}
#else
// The main library: the four instances the probe compiles.
extern "C" int granite_compile_probe(const float* x, float* out, long long n,
                                     int n_iters, cudaStream_t stream) {
  switch (n_iters) {
    case 96: return granite::launch_compile_probe<96>(x, out, n, stream);
    case 97: return granite::launch_compile_probe<97>(x, out, n, stream);
    case 98: return granite::launch_compile_probe<98>(x, out, n, stream);
    case 99: return granite::launch_compile_probe<99>(x, out, n, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// variant v: the instance with N = 96 + v.
extern "C" int granite_attrs_compile_probe(int variant, int* out) {
  switch (variant) {
    case 0: return granite::kernel_attrs(granite::compile_probe_kernel<96>,
                                         out);
    case 1: return granite::kernel_attrs(granite::compile_probe_kernel<97>,
                                         out);
    case 2: return granite::kernel_attrs(granite::compile_probe_kernel<98>,
                                         out);
    case 3: return granite::kernel_attrs(granite::compile_probe_kernel<99>,
                                         out);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif
