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
// used by a whole query tile, far above the ~295 FLOP per byte where the
// card turns compute-bound; gemma2-2b's causal prefill at S = T = 4096
// (H 8, D 256) needs 68.7 GFLOP of live pairs, 0.069 ms at the bf16
// tensor-core peak.
//
// Two designs, chosen by dtype (ops.flash_variant), never by a failure:
// - bf16 (`mma`): the FA2 shape on the tensor cores.  A block of 8 warps
//   owns 128 query rows, 16 per warp.  QK^T and PV are
//   mma.sync.m16n8k16 bf16 -> f32 fed by ldmatrix; the scores, the
//   softcap, the mask and the online softmax stay in the accumulator
//   registers, and P, rounded to bf16 in registers (the rounding the
//   plain version does), is the A operand of PV without passing through
//   shared memory.  K and V tiles of 64 keys arrive by cp.async into a
//   two-stage ring, so the next tile is in flight while this one is
//   computed.  Rows are padded by 16 bytes so ldmatrix is conflict-free;
//   at D = 256 that is 198 KB of shared memory (q, and 2 x (K + V)).
//   Heavy causal query tiles are scheduled first, and the softcap's tanh
//   and the softmax's exp2 use one MUFU operation each (tanh.approx,
//   ex2.approx), which removes the softcap's cost.  wgmma versions of the
//   same tiles (cp.async-fed, with and without q k^T overlapping PV)
//   measured slower on the H100 (see PERF.md), so the products stay
//   mma.sync.
// - f32 (`fma`): one block per (64-query tile, head) on the FMA pipes,
//   q, K, V and the probabilities in shared memory (210 KB at D = 256).
//   Its sums are exact f32 products, which the check's 1e-5 bound needs
//   and TF32 tensor cores (10-bit mantissa) cannot give.
// Head dims: 32, 64, 128, 256 and zamba2's 112.  The `mma` design takes
// 112 as it is (7 k-steps of 16 for q k^T, 14 n8 tiles for PV, rows of
// 112 + 8 bf16, 240 bytes, whose ldmatrix rows still fall in distinct
// 16-byte bank groups).  The `fma` design's threads own column pairs
// 2 tx + 32 e, so its V tile and numerator are padded inside the kernel
// to the next multiple of 32 (128): the pad columns of V are zero, add
// nothing, and are not stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// f32: the FMA design
// ---------------------------------------------------------------------------

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 256;         // 16 x 16: ty over rows, tx over columns

// Row padding of the q and k tiles, so that the 16 rows a half-warp
// reads at one d fall in distinct banks (a row stride of an odd number
// of 4-byte words).
constexpr int QPAD = 1;

// Elements d and d + 1 of a padded tile row (d even).
__device__ __forceinline__ float2 pair(const float* p) { return make_float2(p[0], p[1]); }

// Copy a [rows, D] tile of a [.., heads, D] tensor into shared memory
// with row stride `stride` (columns past D untouched); rows past `valid`
// are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int stride, const float* src,
                                          size_t row_stride, int valid) {
  constexpr int VEC = 16 / sizeof(float);
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    float* d = dst + r * stride + c;
    if (r < valid) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src + r * row_stride + c));
      const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
      for (int v = 0; v < VEC; ++v) d[v] = e[v];
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) d[v] = 0.f;
    }
  }
}

// The numerator's width: D padded to the next multiple of 32.
template <int D>
__host__ __device__ constexpr int padded() { return (D + 31) / 32 * 32; }

// grid (ceil(S / BQ), B * H), THREADS threads.  Dynamic shared memory:
// q [BQ][D + P] | k [BKV][D + P] | v [BKV][DP] (float) | p [BQ][BKV + 1] |
// m, l, corr [BQ] (f32), DP = padded<D>().
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int S, int Tn,
                       int H, int Kh, int t_real, int q_offset, int window,
                       int causal, float scale, float softcap) {
  constexpr int P = QPAD;
  constexpr int QS = D + P;
  constexpr int DP = padded<D>();
  constexpr int DE = DP / 32;        // output column pairs per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + BQ * QS;
  float* vs = ks + BKV * QS;
  float* ps = reinterpret_cast<float*>(vs + BKV * DP);
  float* row_m = ps + BQ * (BKV + 1);
  float* row_l = row_m + BQ;
  float* row_c = row_l + BQ;

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kh = h / (H / Kh);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int kend = min(Tn, t_real);

  const size_t q_row = (size_t)H * D, kv_row = (size_t)Kh * D;
  load_tile<D>(qs, QS, q + ((size_t)b * S + q0) * q_row + (size_t)h * D, q_row,
                  min(BQ, S - q0));
  for (int i = tid; i < BQ; i += THREADS) {
    row_m[i] = NEG_INF;
    row_l[i] = 0.f;
  }
  if constexpr (DP > D) {            // v's pad columns, never loaded
    constexpr int W = DP - D;
    for (int i = tid; i < BKV * W; i += THREADS) vs[(i / W) * DP + D + i % W] = 0.f;
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
    load_tile<D>(ks, QS, k + kv_off, kv_row, min(BKV, Tn - k0));
    load_tile<D>(vs, DP, v + kv_off, kv_row, min(BKV, Tn - k0));
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
        ps[r * (BKV + 1) + tx + 16 * j] = p;
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
        const float2 vv = pair(vs + c * DP + 2 * tx + 32 * e);
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
    float* orow = out + ((size_t)b * S + q0 + r) * q_row + (size_t)h * D;
#pragma unroll
    for (int e = 0; e < DE; ++e) {
      const int d = 2 * tx + 32 * e;
      if (d >= D) continue;            // a pad column
      orow[d] = acc[i][e][0] * inv;
      orow[d + 1] = acc[i][e][1] * inv;
    }
  }
}

template <int D>
size_t smem_bytes() {
  constexpr int P = QPAD;
  return sizeof(float) * ((size_t)BQ * (D + P) + (size_t)BKV * (D + P) +
                          (size_t)BKV * padded<D>()) +
         sizeof(float) * ((size_t)BQ * (BKV + 1) + 3 * BQ);
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B, int S,
             int Tn, int H, int Kh, int t_real, int q_offset, int window, int causal,
             float scale, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  auto kernel = flash_attention_kernel<D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), S, Tn, H, Kh, t_real, q_offset, window, causal, scale,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core design
// ---------------------------------------------------------------------------

namespace tc {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = WARPS * 16;       // 16 query rows per warp
constexpr int BKV = 64;
constexpr int PAD = 8;               // bf16 elements (16 bytes) of row padding

// One MUFU operation each, where the exact forms take two or more: with
// the softcap every score needs a tanh and an exp2.  tanh.approx has a
// relative error near 2^-11 and ex2.approx.ftz about 2 ulp; both stay far
// inside the bf16 bound of every case (the bf16 output's own rounding is
// 2^-9).
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Copy rows [0, ROWS) of a [.., heads, D] bf16 tensor into shared memory
// at row stride D + PAD with cp.async; rows past `valid` are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t row_stride, int valid) {
  constexpr int CH = D / 8;          // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r < valid;
    cp_async16(smem_u32(dst + r * (D + PAD) + c), src + (ok ? r : 0) * row_stride + c, ok);
  }
}

// grid (ceil(S / BQ), B * H), THREADS threads.  Dynamic shared memory:
// q [BQ][D + PAD] | 2 stages x (k [BKV][D + PAD], v [BKV][D + PAD]).
// Scores are kept in the log2 domain: u = s * a, softcapped as
// tanh(u) * b, with (a, b) = (scale / softcap, softcap * log2 e) or
// (scale * log2 e, -) without a softcap, so exp2 gives the softmax.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out, int S, int Tn, int H, int Kh,
                           int t_real, int q_offset, int window, int causal, float a_mul,
                           float b_mul, int capped) {
  constexpr int RS = D + PAD;
  constexpr int NT = BKV / 8;        // n8 tiles of a score row block
  constexpr int DT = D / 8;          // n8 tiles of an output row block
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kvs = qs + BQ * RS;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest causal tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kh = h / (H / Kh);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kend = min(Tn, t_real);
  const size_t q_row = (size_t)H * D, kv_row = (size_t)Kh * D;
  const __nv_bfloat16* kg = k + (size_t)b * Tn * kv_row + (size_t)kh * D;
  const __nv_bfloat16* vg = v + (size_t)b * Tn * kv_row + (size_t)kh * D;

  const int first_q = q0 + q_offset;
  const int last_q = min(q0 + BQ, S) - 1 + q_offset;
  int kt_lo = 0, kt_hi = (kend + BKV - 1) / BKV;
  if (causal) kt_hi = min(kt_hi, last_q / BKV + 1);
  if (window > 0) kt_lo = max(0, (first_q - window + 1) / BKV);

  // this lane's two query rows: g and g + 8 of the warp's 16
  const int qpos0 = q0 + warp * 16 + g + q_offset;
  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};

  if (kt_lo < kt_hi) {
    load_rows<D, BQ>(qs, q + ((size_t)b * S + q0) * q_row + (size_t)h * D, q_row, S - q0);
    const int k0 = kt_lo * BKV;
    load_rows<D, BKV>(kvs, kg + (size_t)k0 * kv_row, kv_row, Tn - k0);
    load_rows<D, BKV>(kvs + BKV * RS, vg + (size_t)k0 * kv_row, kv_row, Tn - k0);
  }
  cp_async_commit();

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const __nv_bfloat16* ks = kvs + ((kt - kt_lo) & 1) * 2 * BKV * RS;
    const __nv_bfloat16* vs = ks + BKV * RS;
    if (kt + 1 < kt_hi) {            // the next tile goes to the other stage
      __nv_bfloat16* nk = kvs + ((kt + 1 - kt_lo) & 1) * 2 * BKV * RS;
      const int k1 = (kt + 1) * BKV;
      load_rows<D, BKV>(nk, kg + (size_t)k1 * kv_row, kv_row, Tn - k1);
      load_rows<D, BKV>(nk + BKV * RS, vg + (size_t)k1 * kv_row, kv_row, Tn - k1);
    }
    cp_async_commit();
    cp_async_wait<1>();              // this tile (and q) have landed
    __syncthreads();

    // S = q k^T: 16 rows x BKV keys per warp
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[4];
      ldsm_x4(a, smem_u32(qs + (warp * 16 + lane % 16) * RS + kc * 16 + (lane / 16) * 8));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, smem_u32(ks + (np * 16 + lane % 8 + (lane / 16) * 8) * RS + kc * 16 +
                             ((lane / 8) % 2) * 8));
        mma_bf16(s[2 * np], a, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
      }
    }

    // softcap, mask and the online softmax on the accumulators; the four
    // lanes of a quad hold one row's BKV scores
    const int k0 = kt * BKV;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + i * 8 + 2 * t + (e & 1);
        const int qpos = qpos0 + (e / 2) * 8;
        float u = s[i][e] * a_mul;
        if (capped) u = tanh_approx(u) * b_mul;
        const bool live = kpos < kend && (!causal || qpos >= kpos) &&
                          (window <= 0 || qpos - kpos < window);
        s[i][e] = live ? u : NEG_INF;
        mx[e / 2] = fmaxf(mx[e / 2], s[i][e]);
      }
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      const float corr = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      // a row with no live key yet keeps m = NEG_INF; exp2(NEG_INF - 0) is 0
      m_use[r] = m_new == NEG_INF ? 0.f : m_new;
      l_r[r] *= corr;
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        o[i][2 * r] *= corr;
        o[i][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][e] = ex2_approx(s[i][e] - m_use[e / 2]);
        l_r[e / 2] += s[i][e];
      }

    // O += bf16(P) v: P from the registers, v through ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bf[4];
        ldsm_x4_t(bf, smem_u32(vs + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) * RS +
                               dp * 16 + (lane / 16) * 8));
        mma_bf16(o[2 * dp], a, bf[0], bf[1]);
        mma_bf16(o[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();                 // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat16* orow = out + ((size_t)b * S + row) * q_row + (size_t)h * D + 2 * t;
#pragma unroll
    for (int i = 0; i < DT; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + i * 8) =
          __floats2bfloat162_rn(o[i][2 * r] * inv, o[i][2 * r + 1] * inv);
  }
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B, int S, int Tn,
             int H, int Kh, int t_real, int q_offset, int window, int causal, float scale,
             float softcap, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(BQ + 4 * BKV) * (D + PAD);
  auto kernel = flash_attention_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float log2e = 1.4426950408889634f;
  const int capped = softcap != 0.f;
  const float a_mul = capped ? scale / softcap : scale * log2e;
  const float b_mul = softcap * log2e;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), S, Tn, H, Kh,
      t_real, q_offset, window, causal, a_mul, b_mul, capped);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

int launch(bool bf16, const void* q, const void* k, const void* v, void* out, int B,
           int S, int Tn, int H, int Kh, int D, int t_real, int q_offset, int window,
           int causal, float scale, float softcap, cudaStream_t stream) {
#define FLASH_D(DD)                                                                     \
  case DD:                                                                             \
    return bf16 ? tc::launch_d<DD>(q, k, v, out, B, S, Tn, H, Kh, t_real, q_offset,    \
                                   window, causal, scale, softcap, stream)             \
                : launch_d<DD>(q, k, v, out, B, S, Tn, H, Kh, t_real, q_offset, \
                                      window, causal, scale, softcap, stream);
  switch (D) {
    FLASH_D(32)
    FLASH_D(64)
    FLASH_D(112)
    FLASH_D(128)
    FLASH_D(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_D
}

}  // namespace

extern "C" {

// q [B, S, H, D], k/v [B, T, Kh, D], out like q, all contiguous and of one
// dtype (bf16 if is_bf16, run by the tensor-core design, else f32, run by
// the FMA design); D is 32, 64, 112, 128 or 256; H % Kh == 0;
// 1 <= t_real <= T.  scale and softcap are f32 values passed by their bit
// patterns.  Returns cudaGetLastError() after the launch.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                           int B, int S, int T, int H, int Kh, int D, int t_real,
                           int q_offset, int window, int causal, int scale_bits,
                           int softcap_bits, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = bits_to_float(scale_bits);
  const float softcap = bits_to_float(softcap_bits);
  return launch(is_bf16 != 0, q, k, v, out, B, S, T, H, Kh, D, t_real, q_offset, window,
                causal, scale, softcap, st);
}

}  // extern "C"
