// Helpers shared by the kernels of this directory: f32 <-> storage-type
// conversion, the float-bits argument decoding of the C interfaces, and
// the fixed-order sum of split-K partials used by both matmul kernels.
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

// y = cast(sum over splits of partial[z]), summed in split order.
template <typename XT>
__global__ void reduce_splits_kernel(const float* __restrict__ partial,
                                     XT* __restrict__ y, int MN, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * MN + i];
  y[i] = from_f<XT>(s);
}

}  // namespace
