// int8 group-quantized matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `quant_matmul_kernel`
// (src/repro/kernels/quant_matmul.py, wrapper ops.quant_matmul):
//
//     y[M, N] = x[M, K] @ bf16(q[K, N] * scale[k / group, N])
//
// with the weight dequantized to bf16 before the product, the sum taken
// in f32 and y stored in x's dtype (bf16 or f32).  The SmoothQuant
// input scale is applied by the wrapper before the launch.  The weight is
// read in place in its QTensor layout (q [K, N] int8 row-major, scale
// [K/g, N] f32); no second, transposed or bf16 copy of it exists.
//
// What bounds it on the H100: bytes in decode, operations in prefill.
// In decode M = 8, so each int8 code read from device memory feeds 8
// multiply-adds; one gemma2-2b layer's codes and scales (80.3 MB) take
// 24 us at 3.35 TB/s.  In prefill (M in the hundreds) 2304 -> 9216 at
// M = 512 is 21.7 GFLOP, 22 us at the bf16 tensor-core peak.
//
// Three designs, chosen by the wrapper from x's dtype and the shape
// (ops.quant_matmul_variant), never by a failure:
// - bf16, M <= 16 (`decode`): the weight stream on the tensor cores.  A
//   block owns 128 columns of N (256 where N >= 4096, so that code rows
//   are read in 256-byte runs) and a split of K.  Stages of 64 code rows
//   (8 or 16 KB of codes, their scale row and the matching x columns)
//   arrive by cp.async in a ring of four stages (three at 256 columns),
//   so 24–32 KB of codes are in flight while a stage is consumed.  Each
//   warp dequantizes its own 32 columns of the stage once into a bf16
//   shared tile, bf16(float(code) * scale), the plain version's rounding,
//   and reads it back with ldmatrix.trans as the A operand of
//   mma.sync.m16n8k16:
//   y^T = w^T x^T, with x^T the n = 8 operand (two n-tiles for
//   9 <= M <= 16).
// - bf16, M > 16 (`mma`): 128 x 128 output tiles, 8 warps of 64 x 32.
//   x tiles (bf16) and int8 code tiles arrive by cp.async in a
//   three-stage ring; each stage's codes are dequantized into a bf16
//   tile, which ldmatrix.trans feeds to mma.sync with x through ldmatrix.
// - f32 x, and shapes the bf16 designs do not take (`fma`): N not a
//   multiple of 16, q or scale not 16-byte aligned, or a group that is
//   not a multiple of the 64-row stage (a stage then spans two scale
//   rows).  Codes are dequantized to an f32 shared tile and the products
//   run on the FMA pipes, exact in f32 as the 1e-3 whole-step f32 check
//   needs (bf16 or TF32 tensor cores cannot give that).
// The bf16 designs convert codes to floats without I2F: a code's byte,
// offset by 128 into the mantissa of 2^23, minus 2^23 + 128, is the code
// exactly; the product with the scale then rounds as the plain version.
// K2 over experts (an MoE layer's stack of E expert matrices, the
// vmapped TPU kernel) is the same kernels with the expert in the grid:
// z = expert * splits + split, and x, q, scale, y and the partials step by
// expert.  A dense linear is the case E = 1.
// Too few output tiles to fill 132 SMs also split K (`splits` > 1): each
// split writes f32 partial sums that a second kernel adds in a fixed
// order, so results do not depend on scheduling; that kernel is launched
// as a programmatic dependent, so its launch overlaps the first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// fma: f32 products on the FMA pipes
// ---------------------------------------------------------------------------

// bf16(code * scale), back in f32: the reference rounds the dequantized
// weight to bf16 before the product.
__device__ __forceinline__ float dequant(int8_t code, float s) {
  return __bfloat162float(__float2bfloat16_rn(static_cast<float>(code) * s));
}

// One block computes a BM x BN tile of y over the K range of its split.
// Thread (tm, tn) owns rows tm*TM.. and columns tn*TN.. of the tile.
template <typename XT, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
quant_matmul_fma_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
                        const float* __restrict__ scale, XT* __restrict__ y,
                        float* __restrict__ partial, int M, int N, int K,
                        int group, int splits, int k_per_split, int vec) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int CHUNKS = BN / 16;          // 16-byte code chunks per tile row
  __shared__ float xs[BK][BM + 1];         // x tile, k-major; +1 avoids bank conflicts
  __shared__ __align__(16) float ws[BK][BN];  // dequantized weight tile

  allow_dependents();                      // the split sum may launch now
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int e = blockIdx.z / splits;       // the expert
  x += (size_t)e * M * K;
  q += (size_t)e * K * N;
  scale += (size_t)e * (K / group) * N;
  y += (size_t)e * M * N;
  const int kb = (blockIdx.z % splits) * k_per_split;
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

// Tile shapes of the FMA design: a skinny tile for few rows of x, a
// square one for many.
constexpr int SMALL_BM = 8, SMALL_BN = 64, SMALL_BK = 128, SMALL_TM = 1, SMALL_TN = 2;
constexpr int LARGE_BM = 64, LARGE_BN = 64, LARGE_BK = 32, LARGE_TM = 4, LARGE_TN = 4;

// ---------------------------------------------------------------------------
// bf16: the tensor-core designs
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int PAD = 8;       // bf16 elements (16 bytes) of row padding: conflict-free ldmatrix
constexpr int BK = 64;       // code rows per stage; `group` is a multiple of it
constexpr int BN = 128;      // output columns per block
constexpr int WS = BN + PAD, XS = BK + PAD;
constexpr int CODE_BYTES = BK * BN, SCALE_BYTES = BN * 4;

// Sixteen codes (16 bytes) times their sixteen scales, rounded to bf16:
// the plain version's bf16(float(code) * scale).
__device__ __forceinline__ void dequant16(const int4 raw, const float* s, bf16* dst) {
  const uint32_t words[4] = {static_cast<uint32_t>(raw.x), static_cast<uint32_t>(raw.y),
                             static_cast<uint32_t>(raw.z), static_cast<uint32_t>(raw.w)};
  uint32_t out[8];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t u = words[w] ^ 0x80808080u;     // code + 128, as unsigned bytes
    const float4 sc = *reinterpret_cast<const float4*>(s + 4 * w);
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)                      // 2^23 + code + 128, exactly
      f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | b)) - 8388736.f;
    out[2 * w] = pack_bf16(f[0] * sc.x, f[1] * sc.y);
    out[2 * w + 1] = pack_bf16(f[2] * sc.z, f[3] * sc.w);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(out[0], out[1], out[2], out[3]);
  d[1] = make_uint4(out[4], out[5], out[6], out[7]);
}

// Store an adjacent pair of y (or of the split's partials), rows m and m + 1
// of column n (the m16n8 accumulator of y^T holds a column's pair).
__device__ __forceinline__ void store_col_pair(bf16* y, float* part, int M, int N, int m,
                                               int n, float a, float b) {
  if (n >= N) return;
  if (part != nullptr) {
    if (m < M) part[(size_t)m * N + n] = a;
    if (m + 1 < M) part[(size_t)(m + 1) * N + n] = b;
  } else {
    if (m < M) y[(size_t)m * N + n] = __float2bfloat16_rn(a);
    if (m + 1 < M) y[(size_t)(m + 1) * N + n] = __float2bfloat16_rn(b);
  }
}

// decode: a warp for each 32 of the block's BN_ columns, STAGES_ stages
// in the ring.  Wide weights (N >= DEC_WIDE_N) take 256 columns a block,
// so each code row is read in 256-byte runs, with three stages; narrower
// ones 128 columns with four, which gives their few columns more blocks.
constexpr int DEC_M = 16, DEC_WIDE_N = 4096;
template <int BN_, int STAGES_>
struct Dec {
  static constexpr int BN = BN_, STAGES = STAGES_, THREADS = BN_;
  static constexpr int WS = BN + PAD, CODE = BK * BN;
  static constexpr int STAGE = CODE + BN * 4 + DEC_M * XS * 2;    // bytes
  static constexpr int SMEM = STAGES * STAGE + BK * WS * 2;
};
using DecNarrow = Dec<128, 4>;
using DecWide = Dec<256, 3>;

// grid (ceil(N / C::BN), 1, experts * splits), C::THREADS threads; MT n8 tiles of
// x rows (M <= 8 MT).  Dynamic shared memory: the ring of stages (codes
// [BK][C::BN] int8 | scale [C::BN] f32 | x [DEC_M][XS] bf16), then the
// bf16 tile [BK][C::WS].
template <typename C, int MT>
__global__ void __launch_bounds__(C::THREADS)
quant_matmul_decode_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                           const float* __restrict__ scale, bf16* __restrict__ y,
                           float* __restrict__ partial, int M, int N, int K, int group,
                           int splits, int k_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* wt = reinterpret_cast<bf16*>(smem + C::STAGES * C::STAGE);
  allow_dependents();                // the split sum may launch now
  const int n0 = blockIdx.x * C::BN;
  const int e = blockIdx.z / splits; // the expert
  x += (size_t)e * M * K;
  q += (size_t)e * K * N;
  scale += (size_t)e * (K / group) * N;
  y += (size_t)e * M * N;
  const int kb = (blockIdx.z % splits) * k_per_split;
  const int nst = (min(K, kb + k_per_split) - kb) / BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  auto load = [&](int s) {
    unsigned char* st = smem + (s % C::STAGES) * C::STAGE;
    const int k0 = kb + s * BK;
    for (int i = tid; i < BK * (C::BN / 16); i += C::THREADS) {
      const int r = i / (C::BN / 16), c = (i % (C::BN / 16)) * 16;
      const bool ok = n0 + c < N;
      cp_async16(smem_u32(st + r * C::BN + c), q + (size_t)(k0 + r) * N + (ok ? n0 + c : 0),
                 ok);
    }
    for (int i = tid; i < C::BN / 4; i += C::THREADS) {
      const int c = i * 4;
      const bool ok = n0 + c < N;
      cp_async16(smem_u32(st + C::CODE + c * 4),
                 scale + (size_t)(k0 / group) * N + (ok ? n0 + c : 0), ok);
    }
    bf16* xs = reinterpret_cast<bf16*>(st + C::CODE + C::BN * 4);
    for (int i = tid; i < MT * 8 * (BK / 8); i += C::THREADS) {
      const int m = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = m < M;
      cp_async16(smem_u32(xs + m * XS + c), x + (size_t)(ok ? m : 0) * K + k0 + c, ok);
    }
  };

  float acc[2][MT][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) acc[r][mt][0] = acc[r][mt][1] = acc[r][mt][2] = acc[r][mt][3] = 0.f;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nst) load(s);
    cp_async_commit();
  }
  const int wc = warp * 32;          // this warp's columns of the block
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();                 // stage s landed; stage s - 1's slot is free
    if (s + C::STAGES - 1 < nst) load(s + C::STAGES - 1);
    cp_async_commit();
    const unsigned char* st = smem + (s % C::STAGES) * C::STAGE;
    const float* ss = reinterpret_cast<const float*>(st + C::CODE);
    const bf16* xs = reinterpret_cast<const bf16*>(st + C::CODE + C::BN * 4);
    // dequantize this warp's 64 x 32 codes: two 16-code pieces per row
#pragma unroll
    for (int i = 0; i < BK * 2 / 32; ++i) {
      const int p = lane + 32 * i, r = p / 2, c = wc + (p % 2) * 16;
      dequant16(*reinterpret_cast<const int4*>(st + r * C::BN + c), ss + c, wt + r * C::WS + c);
    }
    __syncwarp();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t bx[4];                // x^T of rows 0-7 (bx[0..1]) and 8-15 (bx[2..3])
      ldsm_x4(bx, smem_u32(xs + (lane % 8 + (lane / 16) * 8) * XS + kc * 16 +
                           ((lane / 8) % 2) * 8));
#pragma unroll
      for (int rq = 0; rq < 2; ++rq) {
        uint32_t a[4];               // w^T rows (output columns) wc + 16 rq ..
        ldsm_x4_t(a, smem_u32(wt + (kc * 16 + lane % 8 + (lane / 16) * 8) * C::WS + wc +
                              rq * 16 + ((lane / 8) % 2) * 8));
        mma_bf16(acc[rq][0], a, bx[0], bx[1]);
        if (MT > 1) mma_bf16(acc[rq][MT - 1], a, bx[2], bx[3]);
      }
    }
    __syncwarp();                    // the next stage rewrites this warp's tile
  }
  cp_async_wait<0>();

  const int g = lane / 4, t = lane % 4;
  float* part = partial != nullptr ? partial + (size_t)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int rq = 0; rq < 2; ++rq)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int n = n0 + wc + rq * 16 + g, m = mt * 8 + 2 * t;
      store_col_pair(y, part, M, N, m, n, acc[rq][mt][0], acc[rq][mt][1]);
      store_col_pair(y, part, M, N, m, n + 8, acc[rq][mt][2], acc[rq][mt][3]);
    }
}

// prefill: 8 warps (2 over rows x 4 over columns, 64 x 32 each) on a
// 128 x 128 output tile, a three-stage ring of 64 code rows
constexpr int PF_THREADS = 256, PF_STAGES = 3, PF_BM = 128;
constexpr int PF_STAGE = PF_BM * XS * 2 + CODE_BYTES + SCALE_BYTES;          // bytes
constexpr int PF_SMEM = PF_STAGES * PF_STAGE + BK * WS * 2;

// grid (ceil(N / BN), ceil(M / PF_BM), experts * splits), PF_THREADS threads.
// Dynamic shared memory: the ring of stages (x [PF_BM][XS] bf16 | codes
// [BK][BN] int8 | scale [BN] f32), then the bf16 tile [BK][WS].
__global__ void __launch_bounds__(PF_THREADS, 2)
quant_matmul_mma_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                        const float* __restrict__ scale, bf16* __restrict__ y,
                        float* __restrict__ partial, int M, int N, int K, int group,
                        int splits, int k_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* wt = reinterpret_cast<bf16*>(smem + PF_STAGES * PF_STAGE);
  allow_dependents();                // the split sum may launch now
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * PF_BM;
  const int e = blockIdx.z / splits; // the expert
  x += (size_t)e * M * K;
  q += (size_t)e * K * N;
  scale += (size_t)e * (K / group) * N;
  y += (size_t)e * M * N;
  const int kb = (blockIdx.z % splits) * k_per_split;
  const int nst = (min(K, kb + k_per_split) - kb) / BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  auto load = [&](int s) {
    unsigned char* st = smem + (s % PF_STAGES) * PF_STAGE;
    const int k0 = kb + s * BK;
    bf16* xs = reinterpret_cast<bf16*>(st);
    for (int i = tid; i < PF_BM * (BK / 8); i += PF_THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = m0 + r < M;
      cp_async16(smem_u32(xs + r * XS + c), x + (size_t)(ok ? m0 + r : 0) * K + k0 + c, ok);
    }
    unsigned char* cs = st + PF_BM * XS * 2;
    for (int i = tid; i < BK * (BN / 16); i += PF_THREADS) {
      const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
      const bool ok = n0 + c < N;
      cp_async16(smem_u32(cs + r * BN + c), q + (size_t)(k0 + r) * N + (ok ? n0 + c : 0), ok);
    }
    if (tid < BN / 4) {
      const int c = tid * 4;
      const bool ok = n0 + c < N;
      cp_async16(smem_u32(cs + CODE_BYTES + c * 4),
                 scale + (size_t)(k0 / group) * N + (ok ? n0 + c : 0), ok);
    }
  };

  const int wm = warp % 2, wn = warp / 2;
  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.f;

#pragma unroll
  for (int s = 0; s < PF_STAGES - 1; ++s) {
    if (s < nst) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<PF_STAGES - 2>();
    __syncthreads();                 // stage s landed; the last mma is done with wt
    if (s + PF_STAGES - 1 < nst) load(s + PF_STAGES - 1);
    cp_async_commit();
    const unsigned char* st = smem + (s % PF_STAGES) * PF_STAGE;
    const bf16* xs = reinterpret_cast<const bf16*>(st);
    const unsigned char* cs = st + PF_BM * XS * 2;
    const float* ss = reinterpret_cast<const float*>(cs + CODE_BYTES);
#pragma unroll
    for (int i = 0; i < BK * (BN / 16) / PF_THREADS; ++i) {
      const int p = tid + PF_THREADS * i, r = p / (BN / 16), c = (p % (BN / 16)) * 16;
      dequant16(*reinterpret_cast<const int4*>(cs + r * BN + c), ss + c, wt + r * WS + c);
    }
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(a[mi], smem_u32(xs + (wm * 64 + mi * 16 + lane % 16) * XS + kc * 16 +
                                (lane / 16) * 8));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, smem_u32(wt + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) * WS +
                              wn * 32 + np * 16 + (lane / 16) * 8));
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane / 4, t = lane % 4;
  float* part = partial != nullptr ? partial + (size_t)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = n0 + wn * 32 + ni * 8 + 2 * t;
      if (n >= N) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = m0 + wm * 64 + mi * 16 + g + 8 * r;
        if (m >= M) continue;
        const float a0 = acc[mi][ni][2 * r], a1 = acc[mi][ni][2 * r + 1];
        if (part != nullptr)
          *reinterpret_cast<float2*>(part + (size_t)m * N + n) = make_float2(a0, a1);
        else
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * N + n) =
              __floats2bfloat162_rn(a0, a1);
      }
    }
}

}  // namespace tc

// Designs of the C interface: the wrapper's names and their tiles.
enum Design { DECODE = 0, MMA = 1, FMA_SMALL = 2, FMA_LARGE = 3 };

template <typename XT>
int launch_fma(const XT* x, const int8_t* q, const float* scale, XT* y, float* part, int E,
               int M, int N, int K, int group, int small, int splits, int k_per_split, int vec,
               cudaStream_t stream) {
  if (small) {
    dim3 grid((N + SMALL_BN - 1) / SMALL_BN, (M + SMALL_BM - 1) / SMALL_BM, E * splits);
    dim3 block((SMALL_BM / SMALL_TM) * (SMALL_BN / SMALL_TN));
    quant_matmul_fma_kernel<XT, SMALL_BM, SMALL_BN, SMALL_BK, SMALL_TM, SMALL_TN>
        <<<grid, block, 0, stream>>>(x, q, scale, y, part, M, N, K, group, splits, k_per_split,
                                     vec);
  } else {
    dim3 grid((N + LARGE_BN - 1) / LARGE_BN, (M + LARGE_BM - 1) / LARGE_BM, E * splits);
    dim3 block((LARGE_BM / LARGE_TM) * (LARGE_BN / LARGE_TN));
    quant_matmul_fma_kernel<XT, LARGE_BM, LARGE_BN, LARGE_BK, LARGE_TM, LARGE_TN>
        <<<grid, block, 0, stream>>>(x, q, scale, y, part, M, N, K, group, splits, k_per_split,
                                     vec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename C>
cudaError_t launch_decode(const __nv_bfloat16* x, const int8_t* q, const float* scale,
                          __nv_bfloat16* y, float* part, int E, int M, int N, int K, int group,
                          int splits, int k_per_split, cudaStream_t stream) {
  auto kernel = M > 8 ? &tc::quant_matmul_decode_kernel<C, 2>
                      : &tc::quant_matmul_decode_kernel<C, 1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((N + C::BN - 1) / C::BN, 1, E * splits), C::THREADS, C::SMEM, stream>>>(
      x, q, scale, y, part, M, N, K, group, splits, k_per_split);
  return cudaGetLastError();
}

int launch_tc(const __nv_bfloat16* x, const int8_t* q, const float* scale, __nv_bfloat16* y,
              float* part, int E, int M, int N, int K, int group, int design, int splits,
              int k_per_split, cudaStream_t stream) {
  if (N % 16 || group % tc::BK || k_per_split % tc::BK) return cudaErrorInvalidValue;
  cudaError_t err;
  if (design == DECODE) {
    if (M > tc::DEC_M) return cudaErrorInvalidValue;
    err = N >= tc::DEC_WIDE_N
              ? launch_decode<tc::DecWide>(x, q, scale, y, part, E, M, N, K, group, splits,
                                           k_per_split, stream)
              : launch_decode<tc::DecNarrow>(x, q, scale, y, part, E, M, N, K, group, splits,
                                             k_per_split, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    err = cudaFuncSetAttribute(tc::quant_matmul_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, tc::PF_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((N + tc::BN - 1) / tc::BN, (M + tc::PF_BM - 1) / tc::PF_BM, E * splits);
    tc::quant_matmul_mma_kernel<<<grid, tc::PF_THREADS, tc::PF_SMEM, stream>>>(
        x, q, scale, y, part, M, N, K, group, splits, k_per_split);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Output tile (rows, columns) and K step of each design for an [K, N]
// weight, so the wrapper can size its grid and K split.
int quant_matmul_tile_m(int design, int N) {
  return design == DECODE ? tc::DEC_M : design == MMA ? tc::PF_BM
         : design == FMA_SMALL ? SMALL_BM : LARGE_BM;
}
int quant_matmul_tile_n(int design, int N) {
  if (design == DECODE) return N >= tc::DEC_WIDE_N ? tc::DecWide::BN : tc::DecNarrow::BN;
  return design == MMA ? tc::BN : design == FMA_SMALL ? SMALL_BN : LARGE_BN;
}
int quant_matmul_tile_k(int design, int N) {
  return design <= MMA ? tc::BK : design == FMA_SMALL ? SMALL_BK : LARGE_BK;
}

// For each of E experts: x [E, M, K] (bf16 if x_bf16 else f32), q
// [E, K, N] int8, scale [E, K/group, N] f32, y [E, M, N] in x's dtype,
// partial [E * splits, M, N] f32 (used when splits > 1); a dense linear
// is E = 1.  design: 0 `decode`, 1 `mma` (bf16 x with 16-byte aligned
// rows, N % 16 == 0, group a multiple of the 64-row stage, q and scale
// 16-byte aligned), 2 and 3 the skinny and square FMA tiles.  k_per_split
// is a multiple of the design's K step.  vec = 1 lets the FMA design load
// codes 16 bytes at a time (N % 16 == 0 and q 16-byte aligned).  Returns
// cudaGetLastError() after the launches.
int quant_matmul_launch(const void* x, const void* q, const void* scale, void* y,
                        void* partial, int E, int M, int N, int K, int group, int x_bf16,
                        int design, int splits, int k_per_split, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  int err;
  if (design <= MMA) {
    if (!x_bf16) return cudaErrorInvalidValue;
    err = launch_tc(static_cast<const __nv_bfloat16*>(x), qp, sp,
                    static_cast<__nv_bfloat16*>(y), part, E, M, N, K, group, design, splits,
                    k_per_split, s);
  } else if (x_bf16) {
    err = launch_fma(static_cast<const __nv_bfloat16*>(x), qp, sp,
                     static_cast<__nv_bfloat16*>(y), part, E, M, N, K, group,
                     design == FMA_SMALL, splits, k_per_split, vec, s);
  } else {
    err = launch_fma(static_cast<const float*>(x), qp, sp, static_cast<float*>(y), part, E, M,
                     N, K, group, design == FMA_SMALL, splits, k_per_split, vec, s);
  }
  if (err != cudaSuccess || splits == 1) return err;
  const int MN = M * N, blocks = (E * MN + 255) / 256;
  if (x_bf16)
    return static_cast<int>(launch_dependent(reduce_splits_kernel<__nv_bfloat16>, blocks, 256,
                                             0, s, part, static_cast<__nv_bfloat16*>(y), MN,
                                             splits, E));
  return static_cast<int>(launch_dependent(reduce_splits_kernel<float>, blocks, 256, 0, s,
                                           part, static_cast<float*>(y), MN, splits, E));
}

}  // extern "C"
