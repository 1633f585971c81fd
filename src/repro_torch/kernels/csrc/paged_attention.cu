// Paged-KV decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention_kernel`
// (src/repro/kernels/paged_attention.py, wrapper ops.paged_attention):
// one decode token per slot; the G = H / Kh query heads of each KV head
// attend over the slot's positions, whose K/V rows live in pool blocks
// named by the slot's block table.  Scores are f32, scaled by 1/sqrt(D),
// optionally tanh-softcapped; positions >= lengths[s] and, with a window,
// < lengths[s] - window get weight 0; the softmax is exact (max-
// subtracted, two passes over the stored scores, not an online
// recurrence), probabilities are rounded to V's dtype before the f32 PV
// sum, and the output is stored in q's dtype.
//
// What bounds it on the H100: bytes.  Each K and V element read is used
// for G = 2 multiply-adds, so the call is the time to read the slots'
// live K/V rows (plus the q/out rows) at 3.35 TB/s.
//
// What the simple design does about it: one thread block per (slot, KV
// head) reads only the rows below lengths[s] (and inside the window),
// each K/V row exactly once; the block loads its own table row and
// length (there is no scalar prefetch), so a scrambled table, aliased
// prefix blocks and the engine's trash block cost nothing extra.  The
// G x span f32 scores stay in shared memory for the exact softmax:
// dynamic shared memory, raised past 48 KB with cudaFuncSetAttribute,
// covers spans up to ~27k positions at G = 2.  Warps split the
// positions for QK^T (one row per warp, lanes over D); threads split D
// for PV.  Many slots at short lengths leave SMs idle (S * Kh blocks);
// splitting the positions across blocks is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace {

constexpr int MAX_G = 8;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Sum (or max) of v over the block; every thread gets the result.
__device__ float block_reduce(float v, bool is_max, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = is_max ? fmaxf(v, o) : v + o;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? red[lane] : (is_max ? -INFINITY : 0.f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v, off);
      v = is_max ? fmaxf(v, o) : v + o;
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float r = red[0];
  __syncthreads();
  return r;
}

// grid (S, Kh), THREADS threads.  Dynamic shared memory:
// q [G][D] f32 | scores [G][span] f32 | table row [nblk] int.
template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool, const int* __restrict__ tables,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int Kh, int G, int D, int bs, int nblk, float scale,
                       float softcap, int window, int span) {
  extern __shared__ float smem[];
  __shared__ float red[WARPS];
  float* qs = smem;
  float* sc = smem + G * D;
  int* tbl = reinterpret_cast<int*>(sc + G * span);

  const int s = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int len = lengths[s];
  const int hi = min(len, nblk * bs);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int n = max(hi - lo, 0);

  const T* qrow = q + (size_t)(s * Kh + h) * G * D;
  for (int i = tid; i < G * D; i += THREADS) qs[i] = to_f(qrow[i]);
  for (int i = tid; i < nblk; i += THREADS) tbl[i] = tables[(size_t)s * nblk + i];
  __syncthreads();

  // scores: one position per warp, lanes across D
  for (int i = warp; i < n; i += WARPS) {
    const int t = lo + i;
    const T* krow = k_pool + (((size_t)tbl[t / bs] * bs + t % bs) * Kh + h) * D;
    float acc[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;
#pragma unroll 8
    for (int d = lane; d < D; d += 32) {
      const float kv = to_f(krow[d]);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) acc[g] = fmaf(qs[g * D + d], kv, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g >= G) break;
      float v = acc[g];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) {
        v *= scale;
        if (softcap != 0.f) v = tanhf(v / softcap) * softcap;
        sc[g * span + i] = v;
      }
    }
  }
  __syncthreads();

  // exact softmax per query head; probabilities rounded to V's dtype
  for (int g = 0; g < G; ++g) {
    float* row = sc + g * span;
    float m = -INFINITY;
    for (int i = tid; i < n; i += THREADS) m = fmaxf(m, row[i]);
    m = block_reduce(m, true, red);
    float l = 0.f;
    for (int i = tid; i < n; i += THREADS) {
      const float p = expf(row[i] - m);
      row[i] = p;
      l += p;
    }
    l = block_reduce(l, false, red);
    for (int i = tid; i < n; i += THREADS) row[i] = to_f(from_f<T>(row[i] / l));
  }
  __syncthreads();

  // out[g, d] = sum_t probs[g, t] * v[t, d], threads across D
  T* orow = out + (size_t)(s * Kh + h) * G * D;
  for (int d = tid; d < D; d += THREADS) {
    float acc[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;
    // unrolled so several V loads are in flight per thread
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      const int t = lo + i;
      const float vv = to_f(v_pool[(((size_t)tbl[t / bs] * bs + t % bs) * Kh + h) * D + d]);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) acc[g] = fmaf(sc[g * span + i], vv, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) orow[g * D + d] = from_f<T>(acc[g]);
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* lengths, void* out, int S, int Kh,
           int G, int D, int bs, int nblk, float scale, float softcap,
           int window, int span, cudaStream_t stream) {
  const size_t smem = (size_t)G * D * 4 + (size_t)G * span * 4 + (size_t)nblk * 4;
  auto kernel = paged_attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(S, Kh), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), Kh, G, D, bs,
      nblk, scale, softcap, window, span);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int paged_attention_max_g() { return MAX_G; }

// q [S, Kh, G, D], pools [nb, bs, Kh, D] (bf16 if is_bf16 else f32, all
// alike), tables [S, nblk] int32, lengths [S] int32 (>= 1), out like q.
// scale and softcap are f32 values passed by their bit patterns; span is
// the most positions a slot can attend (nblk * bs, or the window if
// smaller).  Returns cudaGetLastError() after the launch.
int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                           const void* tables, const void* lengths, void* out,
                           int S, int Kh, int G, int D, int bs, int nblk,
                           int scale_bits, int softcap_bits, int window,
                           int span, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = bits_to_float(scale_bits);
  const float softcap = bits_to_float(softcap_bits);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, out, S, Kh,
                                 G, D, bs, nblk, scale, softcap, window, span, st);
  return launch<float>(q, k_pool, v_pool, tables, lengths, out, S, Kh, G, D, bs,
                       nblk, scale, softcap, window, span, st);
}

}  // extern "C"
