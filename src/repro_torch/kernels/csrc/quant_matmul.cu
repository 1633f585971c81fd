// int8 group-quantized matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `quant_matmul_kernel`
// (src/repro/kernels/quant_matmul.py, wrapper ops.quant_matmul):
//
//     y[M, N] = x[M, K] @ bf16(q[K, N] * scale[k / group, N])
//
// with the weight dequantized to bf16 before the product, the sum taken
// in f32 and y stored in x's dtype (bf16 or f32).  The SmoothQuant
// input scale is applied by the wrapper before the launch.
//
// What bounds it on the H100: bytes.  In decode M = 8, so each int8 code
// read from device memory feeds 8 multiply-adds; the codes of one step
// (2.02 GB for gemma2-2b) take 0.6 ms at 3.35 TB/s while their 33 GFLOP
// take far less on either the FMA pipes or the tensor cores.  In prefill
// (M in the hundreds) the same kernel becomes compute-bound.
//
// What the simple design does about it: the codes stay int8 in device
// memory (half the bytes of a bf16 weight) and are read once, with
// 16-byte loads, into registers; each thread dequantizes its 16 codes
// into a shared-memory tile, so no bf16 copy of the weight is ever
// written back.  Decode needs enough blocks in flight to fill 132 SMs:
// the grid splits N into 64-column tiles and, when that gives too few
// blocks, also splits K (`splits` > 1): each split writes f32 partial
// sums to a workspace, and a second small kernel adds them in a fixed
// order and casts.  Products use the FMA pipes in f32 (exact for bf16
// operands); tensor cores (mma/wgmma) and TMA pipelining are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// bf16(code * scale), back in f32: the reference rounds the dequantized
// weight to bf16 before the product.
__device__ __forceinline__ float dequant(int8_t code, float s) {
  return __bfloat162float(__float2bfloat16_rn(static_cast<float>(code) * s));
}

// One block computes a BM x BN tile of y over the K range of its split.
// Thread (tm, tn) owns rows tm*TM.. and columns tn*TN.. of the tile.
template <typename XT, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
quant_matmul_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ scale, XT* __restrict__ y,
                    float* __restrict__ partial, int M, int N, int K,
                    int group, int k_per_split, int vec) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int CHUNKS = BN / 16;          // 16-byte code chunks per tile row
  __shared__ float xs[BK][BM + 1];         // x tile, k-major; +1 avoids bank conflicts
  __shared__ __align__(16) float ws[BK][BN];  // dequantized weight tile

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * k_per_split;
  const int ke = min(K, kb + k_per_split);
  const int tid = threadIdx.x;
  const int tn = tid % (BN / TN);
  const int tm = tid / (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int mm = i / BK, kk = i % BK;
      const int m = m0 + mm, k = k0 + kk;
      xs[kk][mm] = (m < M && k < ke) ? to_f(x[(size_t)m * K + k]) : 0.f;
    }
    for (int i = tid; i < BK * CHUNKS; i += NT) {
      const int kk = i / CHUNKS, c = (i % CHUNKS) * 16;
      const int k = k0 + kk, n = n0 + c;
      float* dst = &ws[kk][c];
      if (k < ke && vec && n < N) {
        // N % 16 == 0 here, so the whole 16-byte chunk is in bounds
        const int4 raw = *reinterpret_cast<const int4*>(q + (size_t)k * N + n);
        const int8_t* codes = reinterpret_cast<const int8_t*>(&raw);
        const float4* s = reinterpret_cast<const float4*>(scale + (size_t)(k / group) * N + n);
        float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 sj = __ldg(s + j);
          d4[j] = make_float4(dequant(codes[4 * j], sj.x), dequant(codes[4 * j + 1], sj.y),
                              dequant(codes[4 * j + 2], sj.z), dequant(codes[4 * j + 3], sj.w));
        }
      } else {
        for (int j = 0; j < 16; ++j) {
          const int nj = n + j;
          dst[j] = (k < ke && nj < N)
                       ? dequant(q[(size_t)k * N + nj], __ldg(scale + (size_t)(k / group) * N + nj))
                       : 0.f;
        }
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][tm * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tn * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn * TN + j;
      if (n >= N) continue;
      if (partial != nullptr)
        partial[((size_t)blockIdx.z * M + m) * N + n] = acc[i][j];
      else
        y[(size_t)m * N + n] = from_f<XT>(acc[i][j]);
    }
  }
}

// Tile shapes: a skinny tile for decode (few rows of x), a square one
// for prefill.
constexpr int SMALL_BM = 8, SMALL_BN = 64, SMALL_BK = 128, SMALL_TM = 1, SMALL_TN = 2;
constexpr int LARGE_BM = 64, LARGE_BN = 64, LARGE_BK = 32, LARGE_TM = 4, LARGE_TN = 4;

template <typename XT>
int launch(const void* x, const void* q, const void* scale, void* y,
           void* partial, int M, int N, int K, int group, int small,
           int splits, int k_per_split, int vec, cudaStream_t stream) {
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const XT* xp = static_cast<const XT*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  XT* yp = static_cast<XT*>(y);
  if (small) {
    dim3 grid((N + SMALL_BN - 1) / SMALL_BN, (M + SMALL_BM - 1) / SMALL_BM, splits);
    dim3 block((SMALL_BM / SMALL_TM) * (SMALL_BN / SMALL_TN));
    quant_matmul_kernel<XT, SMALL_BM, SMALL_BN, SMALL_BK, SMALL_TM, SMALL_TN>
        <<<grid, block, 0, stream>>>(xp, qp, sp, yp, part, M, N, K, group, k_per_split, vec);
  } else {
    dim3 grid((N + LARGE_BN - 1) / LARGE_BN, (M + LARGE_BM - 1) / LARGE_BM, splits);
    dim3 block((LARGE_BM / LARGE_TM) * (LARGE_BN / LARGE_TN));
    quant_matmul_kernel<XT, LARGE_BM, LARGE_BN, LARGE_BK, LARGE_TM, LARGE_TN>
        <<<grid, block, 0, stream>>>(xp, qp, sp, yp, part, M, N, K, group, k_per_split, vec);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int MN = M * N;
  reduce_splits_kernel<XT><<<(MN + 255) / 256, 256, 0, stream>>>(part, yp, MN, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Tile heights, so the wrapper can size its grid and K split.
int quant_matmul_tile_m(int small) { return small ? SMALL_BM : LARGE_BM; }
int quant_matmul_tile_n(int small) { return small ? SMALL_BN : LARGE_BN; }
int quant_matmul_tile_k(int small) { return small ? SMALL_BK : LARGE_BK; }

// x [M, K] (bf16 if x_bf16 else f32), q [K, N] int8, scale [K/group, N]
// f32, y [M, N] in x's dtype, partial [splits, M, N] f32 (used when
// splits > 1).  k_per_split is a multiple of the tile's BK.  vec = 1
// allows 16-byte code loads (N % 16 == 0 and q 16-byte aligned).
// Returns cudaGetLastError() after the launches.
int quant_matmul_launch(const void* x, const void* q, const void* scale,
                        void* y, void* partial, int M, int N, int K, int group,
                        int x_bf16, int small, int splits, int k_per_split,
                        int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch<__nv_bfloat16>(x, q, scale, y, partial, M, N, K, group, small,
                                 splits, k_per_split, vec, s);
  return launch<float>(x, q, scale, y, partial, M, N, K, group, small, splits,
                       k_per_split, vec, s);
}

}  // extern "C"
