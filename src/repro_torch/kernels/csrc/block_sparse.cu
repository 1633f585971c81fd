// Block-sparse matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `block_sparse_matmul_kernel`
// (src/repro/kernels/block_sparse.py, wrapper ops.block_sparse_matmul):
//
//     y[M, N] = x[M, K] @ w[K, N]
//
// where w is a dense, zero-filled bf16 weight cut into bs x bs tiles and
// output block column j reads only the `keep` input blocks listed in
// idx[j, :] (the same count for every column).  Products and sums are
// f32; y is stored in x's dtype (bf16 or f32).
//
// What bounds it on the H100: bytes.  In decode M = 8, so each kept
// weight element read from device memory feeds 8 multiply-adds; one
// gemma2-2b layer at bs 16, density 0.75 keeps 116.8 MB of bf16 tiles,
// 34.9 us at 3.35 TB/s, while its 0.47 GFLOP take far less.  In prefill
// (M in the hundreds) the same kernel becomes compute-bound.
//
// What the simple design does about it: only the kept tiles are read,
// each once, with 16-byte loads; a block loads its own column's indices
// (there is no scalar prefetch) and treats the kept tiles, laid end to
// end, as one gathered K dimension that it walks in stages of BK rows,
// with the x rows it needs gathered by the same indices.  Decode needs
// enough blocks in flight to fill 132 SMs, but at M = 8 there are only
// N / bs block columns (as few as 8 at bs 128, N 1024): the grid then
// also splits each column's kept tiles (`splits` > 1), each split writes
// f32 partial sums to a workspace, and a second small kernel adds them
// in a fixed order and casts.  Products use the FMA pipes in f32 (exact
// for bf16 operands); tensor cores (mma/wgmma) and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// One block computes a BM x BS tile of y: rows m0.., block column j,
// over kept tiles [t0, t1) of idx[j, :].  16 threads across the BS
// columns (each owns TN of them, strided by 16) and BM / TM across rows.
template <typename XT, int BS, int BM, int BK, int TM>
__global__ void __launch_bounds__((BM / TM) * 16)
block_sparse_kernel(const XT* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    const int* __restrict__ idx, XT* __restrict__ y,
                    float* __restrict__ partial, int M, int N, int K, int keep,
                    int tiles_per_split) {
  constexpr int TX = 16;
  constexpr int TN = BS / TX;
  constexpr int NT = (BM / TM) * TX;
  constexpr int CHUNKS = BS / 8;            // 16-byte (8 x bf16) chunks per tile row
  __shared__ float xs[BK][BM + 1];          // gathered x, k-major; +1 avoids bank conflicts
  __shared__ __align__(16) float ws[BK][BS];  // gathered weight rows of column j

  const int j = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const int t0 = blockIdx.z * tiles_per_split;
  const int t1 = min(keep, t0 + tiles_per_split);
  const int kv_end = max(t1 - t0, 0) * BS;  // length of this split's gathered K
  const int* col = idx + (size_t)j * keep + t0;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0.f;

  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int mm = i / BK, kk = i % BK;
      const int m = m0 + mm, kv = kv0 + kk;
      float v = 0.f;
      if (m < M && kv < kv_end) {
        const int k = __ldg(col + kv / BS) * BS + kv % BS;
        v = to_f(x[(size_t)m * K + k]);
      }
      xs[kk][mm] = v;
    }
    for (int i = tid; i < BK * CHUNKS; i += NT) {
      const int kk = i / CHUNKS, c = (i % CHUNKS) * 8;
      const int kv = kv0 + kk;
      float4* dst = reinterpret_cast<float4*>(&ws[kk][c]);
      if (kv < kv_end) {
        const int k = __ldg(col + kv / BS) * BS + kv % BS;
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
            w + (size_t)k * N + (size_t)j * BS + c));
        const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
        dst[0] = make_float4(__bfloat162float(b[0]), __bfloat162float(b[1]),
                             __bfloat162float(b[2]), __bfloat162float(b[3]));
        dst[1] = make_float4(__bfloat162float(b[4]), __bfloat162float(b[5]),
                             __bfloat162float(b[6]), __bfloat162float(b[7]));
      } else {
        dst[0] = make_float4(0.f, 0.f, 0.f, 0.f);
        dst[1] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int c = 0; c < TN; ++c) b[c] = ws[kk][tx + c * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int n = j * BS + tx + c * TX;
      if (partial != nullptr)
        partial[((size_t)blockIdx.z * M + m) * N + n] = acc[i][c];
      else
        y[(size_t)m * N + n] = from_f<XT>(acc[i][c]);
    }
  }
}

// Tile heights: a skinny one for decode (few rows of x), a square one for
// prefill; ops.py's _BS_TILE_M mirrors them to size the grid and split.
// Stage depths keep the weight stage at or under 32 KB.
constexpr int SMALL_BM = 8, SMALL_TM = 1;
constexpr int LARGE_BM = 64, LARGE_TM = 4, LARGE_BK = 32;
constexpr int small_bk(int bs) { return bs >= 128 ? 64 : 128; }

template <typename XT, int BS>
int launch_bs(const XT* x, const __nv_bfloat16* w, const int* idx, XT* y,
              float* part, int M, int N, int K, int keep, int small, int splits,
              int tiles_per_split, cudaStream_t stream) {
  if (small) {
    dim3 grid(N / BS, (M + SMALL_BM - 1) / SMALL_BM, splits);
    block_sparse_kernel<XT, BS, SMALL_BM, small_bk(BS), SMALL_TM>
        <<<grid, (SMALL_BM / SMALL_TM) * 16, 0, stream>>>(x, w, idx, y, part, M, N, K,
                                                         keep, tiles_per_split);
  } else {
    dim3 grid(N / BS, (M + LARGE_BM - 1) / LARGE_BM, splits);
    block_sparse_kernel<XT, BS, LARGE_BM, LARGE_BK, LARGE_TM>
        <<<grid, (LARGE_BM / LARGE_TM) * 16, 0, stream>>>(x, w, idx, y, part, M, N, K,
                                                         keep, tiles_per_split);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename XT>
int launch(const void* x, const void* w, const void* idx, void* y, void* partial,
           int M, int N, int K, int bs, int keep, int small, int splits,
           int tiles_per_split, cudaStream_t stream) {
  const XT* xp = static_cast<const XT*>(x);
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w);
  const int* ip = static_cast<const int*>(idx);
  XT* yp = static_cast<XT*>(y);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  int err;
  switch (bs) {
    case 16: err = launch_bs<XT, 16>(xp, wp, ip, yp, part, M, N, K, keep, small, splits,
                                     tiles_per_split, stream); break;
    case 32: err = launch_bs<XT, 32>(xp, wp, ip, yp, part, M, N, K, keep, small, splits,
                                     tiles_per_split, stream); break;
    case 64: err = launch_bs<XT, 64>(xp, wp, ip, yp, part, M, N, K, keep, small, splits,
                                     tiles_per_split, stream); break;
    case 128: err = launch_bs<XT, 128>(xp, wp, ip, yp, part, M, N, K, keep, small, splits,
                                       tiles_per_split, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || splits == 1) return err;
  const int MN = M * N;
  reduce_splits_kernel<XT><<<(MN + 255) / 256, 256, 0, stream>>>(part, yp, MN, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [M, K] (bf16 if x_bf16 else f32), w [K, N] bf16 with 16-byte aligned
// rows, idx [N / bs, keep] int32 with entries in [0, K / bs), y [M, N] in
// x's dtype, partial [splits, M, N] f32 (used when splits > 1); bs is 16,
// 32, 64 or 128 and divides K and N; each split covers tiles_per_split
// kept tiles.  Returns cudaGetLastError() after the launches.
int block_sparse_launch(const void* x, const void* w, const void* idx, void* y,
                        void* partial, int M, int N, int K, int bs, int keep,
                        int x_bf16, int small, int splits, int tiles_per_split,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch<__nv_bfloat16>(x, w, idx, y, partial, M, N, K, bs, keep, small,
                                 splits, tiles_per_split, s);
  return launch<float>(x, w, idx, y, partial, M, N, K, bs, keep, small, splits,
                       tiles_per_split, s);
}

}  // extern "C"
