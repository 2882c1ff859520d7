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
// What bounds it.  Not bytes or FLOPs: at the probe's sizes (65,536-
// 163,840 elements) the roofline bound is 0.2-0.5 us.  An element is a
// chain of 2N dependent FMUL/FADD (the SASS holds exactly 2N and no
// FFMA), ~4 cycles each: 768-792 cycles.  The card issues 128 FP32
// instructions a cycle on each SM, so 2N x numel instructions take
// 745-1,920 cycles over 132 SMs.  The larger of the two is the floor
// (chip_smoke.py's latency_bound_ms); the launch comes on top of it.
//
// The design.  One element a thread and 256 threads a block, one block
// for every 256 elements: at the probe's sizes that is one wave of
// 256-640 blocks, 4-10 warps on each of the SM's four schedulers, enough
// to issue one chain's step while the others wait out their latency.
// More chains a thread (2 or 4, float2/float4 loads) give no gain: the
// instruction count is the same and fewer warps balance worse over the
// schedulers (measured on an H100: PERF.md).
// What it does attack is the launch: the kernel is launched with
// programmatic dependent launch (Hopper), so it is scheduled while the
// kernel before it on the stream is still running; cudaGridDependency-
// Synchronize holds every thread until that kernel has finished and its
// writes are visible, before x is read.  The trigger after the store lets
// the next such kernel do the same.  Stream capture keeps the
// programmatic edge, so the CUDA graphs that time the kernels see it too.
// The gain is only there for launches back to back: a caller that syncs
// after each call, as the compile probe does, sees the launch as before.

#include <cuda_runtime.h>

#include "kernel_attrs.cuh"

namespace granite {

constexpr int PROBE_THREADS = 256;

template <int N>
__global__ void __launch_bounds__(PROBE_THREADS)
    compile_probe_kernel(const float* __restrict__ x, float* __restrict__ out,
                         long long n) {
  cudaGridDependencySynchronize();
  const long long i = (long long)blockIdx.x * PROBE_THREADS + threadIdx.x;
  if (i < n) {
    float acc = x[i];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      acc = __fadd_rn(__fmul_rn(acc, 1.0001f), (float)k);
    }
    out[i] = acc;
  }
  cudaTriggerProgrammaticLaunchCompletion();
}

template <int N>
int launch_compile_probe(const float* x, float* out, long long n,
                         cudaStream_t stream) {
  if (n > 0) {
    cudaLaunchAttribute pdl;
    pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    pdl.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)((n + PROBE_THREADS - 1) / PROBE_THREADS));
    cfg.blockDim = dim3(PROBE_THREADS);
    cfg.stream = stream;
    cfg.attrs = &pdl;
    cfg.numAttrs = 1;
    const cudaError_t err =
        cudaLaunchKernelEx(&cfg, compile_probe_kernel<N>, x, out, n);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the error is returned here
      return (int)err;
    }
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
