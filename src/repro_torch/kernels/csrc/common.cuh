// Helpers shared by the kernels of this directory: f32 <-> storage-type
// conversion, the float-bits argument decoding of the C interfaces,
// programmatic dependent launch, and the fixed-order sum of split-K
// partials used by both matmul kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <string.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A float passed through a C int argument (the wrappers pack its bits).
inline float bits_to_float(int bits) {
  float f;
  memcpy(&f, &bits, sizeof(f));
  return f;
}

// Programmatic dependent launch (sm_90): a kernel started by
// launch_dependent may begin before the kernel ahead of it in the stream
// has finished, so its launch and the loads that do not depend on that
// kernel overlap it; it calls wait_for_prerequisite() before it touches
// what that kernel writes.  The kernel ahead calls allow_dependents() once
// it has started, so the one behind can be scheduled early.  Both are
// no-ops for kernels launched the ordinary way.
__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_prerequisite() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// y[e] = cast(sum over splits of partial[e * splits + z]), summed in split
// order, for each of `experts` outputs of MN elements (1 for a dense one).
template <typename XT>
__global__ void reduce_splits_kernel(const float* __restrict__ partial,
                                     XT* __restrict__ y, int MN, int splits, int experts) {
  wait_for_prerequisite();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= experts * MN) return;
  const float* p = partial + (size_t)(i / MN) * splits * MN + i % MN;
  float s = 0.f;
#pragma unroll 8                      // the loads of eight splits in flight at once
  for (int z = 0; z < splits; ++z) s += p[(size_t)z * MN];
  y[i] = from_f<XT>(s);
}

}  // namespace
