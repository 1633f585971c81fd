// Tiled online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_kernel`
// (src/repro/kernels/flash_attention.py, wrapper ops.flash_attention):
// q [B, S, H, D] against k/v [B, T, Kh, D], query head h reading KV head
// h / (H / Kh).  Query row i sits at position i + q_offset; keys at or
// past t_real are masked, as are, when causal, keys after the query and,
// with a window, keys `window` or more behind it.  Scores are f32, scaled
// by 1/sqrt(D) and tanh-softcapped before the mask; the softmax is the
// online recurrence over key tiles (running max m, sum l, f32 numerator),
// probabilities are rounded to V's dtype before the f32 PV sum, and the
// output is numerator / max(l, 1e-30) in q's dtype.  A masked key adds
// exactly zero, so a row with no live key gives 0, not NaN.  Key tiles
// with no live (query, key) pair for the block's query tile are skipped.
//
// What bounds it on the H100: operations.  Every K/V element read is
// used by the BQ = 64 query rows of a block, far above the ~295 FLOP per
// byte where the card turns compute-bound; gemma2-2b's causal prefill at
// S = T = 4096 (H 8, D 256) needs 68.7 GFLOP of live tiles, 0.069 ms at
// the bf16 tensor-core peak.
//
// What the simple design does about it: one block per (64-query tile,
// head) keeps q, the current 64-key K and V tiles and the probabilities
// in shared memory (at D = 256 that is 113 KB in bf16 and 210 KB in f32,
// so the dynamic limit is raised past 48 KB), the f32 numerator of its
// 64 x D outputs in registers, and walks only the live key tiles.
// Products run on the FMA pipes in f32; mma/wgmma tensor-core tiles fed
// by TMA are the later, fast version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 256;         // 16 x 16: ty over rows, tx over columns
constexpr float NEG_INF = -1e30f;

// Row padding of the q and k tiles, so that the 16 rows a half-warp
// reads at one d fall in distinct banks (a row stride of an odd number
// of 4-byte words).
template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int value = 1; };
template <> struct Pad<__nv_bfloat16> { static constexpr int value = 2; };

// Elements d and d + 1 of a padded tile row (d even).
__device__ __forceinline__ float2 pair(const float* p) { return make_float2(p[0], p[1]); }
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Copy a [rows, D] tile of a [.., heads, D] tensor into shared memory
// with row stride `stride`; rows past `valid` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, int stride, const T* src,
                                          size_t row_stride, int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    T* d = dst + r * stride + c;
    if (r < valid) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src + r * row_stride + c));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int v = 0; v < VEC; ++v) d[v] = e[v];
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) d[v] = from_f<T>(0.f);
    }
  }
}

// grid (ceil(S / BQ), B * H), THREADS threads.  Dynamic shared memory:
// q [BQ][D + P] | k [BKV][D + P] | v [BKV][D] (T) | p [BQ][BKV + 1] |
// m, l, corr [BQ] (f32).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S, int Tn,
                       int H, int Kh, int t_real, int q_offset, int window,
                       int causal, float scale, float softcap) {
  constexpr int P = Pad<T>::value;
  constexpr int QS = D + P;
  constexpr int DE = D / 32;         // output column pairs per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + BQ * QS;
  T* vs = ks + BKV * QS;
  float* ps = reinterpret_cast<float*>(vs + BKV * D);
  float* row_m = ps + BQ * (BKV + 1);
  float* row_l = row_m + BQ;
  float* row_c = row_l + BQ;

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kh = h / (H / Kh);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int kend = min(Tn, t_real);

  const size_t q_row = (size_t)H * D, kv_row = (size_t)Kh * D;
  load_tile<T, D>(qs, QS, q + ((size_t)b * S + q0) * q_row + (size_t)h * D, q_row,
                  min(BQ, S - q0));
  for (int i = tid; i < BQ; i += THREADS) {
    row_m[i] = NEG_INF;
    row_l[i] = 0.f;
  }

  // live key tiles of this query tile
  const int first_q = q0 + q_offset;
  const int last_q = min(q0 + BQ, S) - 1 + q_offset;
  int kt_lo = 0, kt_hi = (kend + BKV - 1) / BKV;
  if (causal) kt_hi = min(kt_hi, last_q / BKV + 1);
  if (window > 0) kt_lo = max(0, (first_q - window + 1) / BKV);

  float acc[4][DE][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DE; ++e) acc[i][e][0] = acc[i][e][1] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();                  // the previous tile's k, v and p are consumed
    const size_t kv_off = ((size_t)b * Tn + k0) * kv_row + (size_t)kh * D;
    load_tile<T, D>(ks, QS, k + kv_off, kv_row, min(BKV, Tn - k0));
    load_tile<T, D>(vs, D, v + kv_off, kv_row, min(BKV, Tn - k0));
    __syncthreads();

    // scores of rows ty + 16 i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 2) {
      float2 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = pair(qs + (ty + 16 * i) * QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = pair(ks + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = fmaf(a[i].y, c[j].y, fmaf(a[i].x, c[j].x, s[i][j]));
    }

    // softcap, mask and the online softmax update, one row per (ty, i);
    // the row's 64 scores are spread over the 16 lanes of a half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r + q_offset;
      bool live[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
        live[j] = kpos < kend && (!causal || qpos >= kpos) &&
                  (window <= 0 || qpos - kpos < window);
        s[i][j] = live[j] ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        ps[r * (BKV + 1) + tx + 16 * j] = to_f(from_f<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (tx == 0) {
        const float corr = expf(m_prev - m_new);
        row_c[r] = corr;
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // numerator: rows ty + 16 i, column pairs 2 tx + 32 e
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = row_c[ty + 16 * i];
#pragma unroll
      for (int e = 0; e < DE; ++e) {
        acc[i][e][0] *= corr;
        acc[i][e][1] *= corr;
      }
    }
#pragma unroll 2
    for (int c = 0; c < BKV; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * (BKV + 1) + c];
#pragma unroll
      for (int e = 0; e < DE; ++e) {
        const float2 vv = pair(vs + c * D + 2 * tx + 32 * e);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][e][0] = fmaf(p[i], vv.x, acc[i][e][0]);
          acc[i][e][1] = fmaf(p[i], vv.y, acc[i][e][1]);
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= S) continue;
    const float inv = 1.f / fmaxf(row_l[r], 1e-30f);
    T* orow = out + ((size_t)b * S + q0 + r) * q_row + (size_t)h * D;
#pragma unroll
    for (int e = 0; e < DE; ++e) {
      const int d = 2 * tx + 32 * e;
      orow[d] = from_f<T>(acc[i][e][0] * inv);
      orow[d + 1] = from_f<T>(acc[i][e][1] * inv);
    }
  }
}

template <typename T, int D>
size_t smem_bytes() {
  constexpr int P = Pad<T>::value;
  return sizeof(T) * ((size_t)BQ * (D + P) + (size_t)BKV * (D + P) + (size_t)BKV * D) +
         sizeof(float) * ((size_t)BQ * (BKV + 1) + 3 * BQ);
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B, int S,
             int Tn, int H, int Kh, int t_real, int q_offset, int window, int causal,
             float scale, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>();
  auto kernel = flash_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, Tn, H, Kh, t_real, q_offset, window, causal, scale,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S,
           int Tn, int H, int Kh, int D, int t_real, int q_offset, int window,
           int causal, float scale, float softcap, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_d<T, 32>(q, k, v, out, B, S, Tn, H, Kh, t_real, q_offset,
                                    window, causal, scale, softcap, stream);
    case 64: return launch_d<T, 64>(q, k, v, out, B, S, Tn, H, Kh, t_real, q_offset,
                                    window, causal, scale, softcap, stream);
    case 128: return launch_d<T, 128>(q, k, v, out, B, S, Tn, H, Kh, t_real, q_offset,
                                      window, causal, scale, softcap, stream);
    case 256: return launch_d<T, 256>(q, k, v, out, B, S, Tn, H, Kh, t_real, q_offset,
                                      window, causal, scale, softcap, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q [B, S, H, D], k/v [B, T, Kh, D], out like q, all contiguous and of one
// dtype (bf16 if is_bf16 else f32); D is 32, 64, 128 or 256; H % Kh == 0;
// 1 <= t_real <= T.  scale and softcap are f32 values passed by their bit
// patterns.  Returns cudaGetLastError() after the launch.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                           int B, int S, int T, int H, int Kh, int D, int t_real,
                           int q_offset, int window, int causal, int scale_bits,
                           int softcap_bits, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = bits_to_float(scale_bits);
  const float softcap = bits_to_float(softcap_bits);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, out, B, S, T, H, Kh, D, t_real, q_offset,
                                 window, causal, scale, softcap, st);
  return launch<float>(q, k, v, out, B, S, T, H, Kh, D, t_real, q_offset, window,
                       causal, scale, softcap, st);
}

}  // extern "C"
