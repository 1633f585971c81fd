// Block-sparse matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `block_sparse_matmul_kernel`
// (src/repro/kernels/block_sparse.py, wrapper ops.block_sparse_matmul):
//
//     y[M, N] = x[M, K] @ w[K, N]
//
// where w is a dense, zero-filled bf16 weight cut into bs x bs tiles and
// output block column j reads only the `keep` input blocks listed in
// idx[j, :] (the same count for every column).  Tiles outside idx are
// never read.  Sums are f32; y is stored in x's dtype (bf16 or f32).
//
// What bounds it on the H100: bytes in decode, operations in prefill.
// In decode M = 8, so each kept weight element read from device memory
// feeds 8 multiply-adds; one gemma2-2b layer at bs 16, density 0.75 keeps
// 116.8 MB of bf16 tiles, 34.9 us at 3.35 TB/s.  In prefill (M in the
// hundreds) the same layer needs 59.8 GFLOP at M = 512, 0.060 ms at the
// bf16 tensor-core peak.
//
// Three designs, chosen by the wrapper from x's dtype and M
// (ops.block_sparse_variant), never by a failure:
// - bf16, M <= 16 (`decode`): a block owns one output block column and a
//   range of its kept tiles, laid end to end as one gathered K.  Stages
//   of that K (4-8 KB of weight rows and the matching x columns) arrive
//   by cp.async in a four-deep ring, so three stages are in flight while
//   one is computed.  The product runs on the tensor cores as
//   y^T = w^T x^T: the weight tile, through ldmatrix.trans, is the A
//   operand of mma.sync.m16n8k16 and x^T the n = 8 operand, so the
//   memory-bound stream needs no FMA per weight element.
// - bf16, M > 16 (`mma`): a block owns 128 rows of x and a group of
//   adjacent output block columns 128 wide.  It builds, in shared memory,
//   the input blocks that any column of its group keeps and a bit per
//   (block, column), then walks those blocks in order: each x[128, bs]
//   tile is loaded once for every column of the group, only kept weight
//   tiles are read, and the pruned slots of the group's panel are
//   zero-filled by cp.async, so the panel runs as 128 x 128 mma.sync
//   tiles fed by a three-stage ring.
// - f32 (`fma`): the gathered-K design on the FMA pipes, with f32
//   products that the check's 1e-5 bound needs and TF32 tensor cores
//   (10-bit mantissa) cannot give.
// Decode needs enough blocks to fill 132 SMs but may have as few as 8
// output columns: every design also splits its walk (`splits` > 1), each
// split writing f32 partial sums that a second kernel adds in a fixed
// order, so results do not depend on scheduling.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

// One block computes a BM x BS tile of y: rows m0.., block column j,
// over kept tiles [t0, t1) of idx[j, :].  16 threads across the BS
// columns (each owns TN of them, strided by 16) and BM / TM across rows.
template <int BS, int BM, int BK, int TM>
__global__ void __launch_bounds__((BM / TM) * 16)
block_sparse_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    const int* __restrict__ idx, float* __restrict__ y,
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
        y[(size_t)m * N + n] = acc[i][c];
    }
  }
}

// FMA tile heights: a skinny one for decode (few rows of x), a square one
// for prefill.  Stage depths keep the weight stage at or under 32 KB.
constexpr int SMALL_BM = 8, SMALL_TM = 1;
constexpr int LARGE_BM = 64, LARGE_TM = 4, LARGE_BK = 32;
constexpr int small_bk(int bs) { return bs >= 128 ? 64 : 128; }

template <int BS>
int launch_fma(const float* x, const __nv_bfloat16* w, const int* idx, float* y,
               float* part, int M, int N, int K, int keep, int small, int splits,
               int tiles_per_split, cudaStream_t stream) {
  if (small) {
    dim3 grid(N / BS, (M + SMALL_BM - 1) / SMALL_BM, splits);
    block_sparse_kernel<BS, SMALL_BM, small_bk(BS), SMALL_TM>
        <<<grid, (SMALL_BM / SMALL_TM) * 16, 0, stream>>>(x, w, idx, y, part, M, N, K,
                                                         keep, tiles_per_split);
  } else {
    dim3 grid(N / BS, (M + LARGE_BM - 1) / LARGE_BM, splits);
    block_sparse_kernel<BS, LARGE_BM, LARGE_BK, LARGE_TM>
        <<<grid, (LARGE_BM / LARGE_TM) * 16, 0, stream>>>(x, w, idx, y, part, M, N, K,
                                                         keep, tiles_per_split);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core designs
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int PAD = 8;               // bf16 elements (16 bytes) of row padding:
                                     // conflict-free ldmatrix at every stride used

// decode: 4 warps, M <= 16 rows of x, a four-stage ring of BK gathered rows
constexpr int DEC_THREADS = 128, DEC_STAGES = 4, DEC_M = 16;
__host__ __device__ constexpr int dec_bk(int bs) { return bs >= 32 ? 4096 / bs : 128; }
__host__ __device__ constexpr int dec_stage(int bs) {
  return dec_bk(bs) * (bs + PAD) + DEC_M * (dec_bk(bs) + PAD);
}

// Store one f32 value or an adjacent pair of y (or of the split's partials).
__device__ __forceinline__ void store_pair(bf16* y, float* part, size_t at, float a, float b) {
  if (part != nullptr)
    *reinterpret_cast<float2*>(part + at) = make_float2(a, b);
  else
    *reinterpret_cast<__nv_bfloat162*>(y + at) = __floats2bfloat162_rn(a, b);
}

// grid (N / BS, 1, splits), DEC_THREADS threads; MT n8 tiles of x rows
// (M <= 8 MT).  Warps split the BS / 16 row tiles of w^T (WR of them)
// and the stage's k16 chunks (WK); their sums meet in shared memory and
// are added in warp order.
template <int BS, int MT>
__global__ void __launch_bounds__(DEC_THREADS)
block_sparse_decode_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                           const int* __restrict__ idx, bf16* __restrict__ y,
                           float* __restrict__ partial, int M, int N, int K, int keep,
                           int tiles_per_split) {
  constexpr int BK = dec_bk(BS);
  constexpr int RT = BS / 16, KC = BK / 16;
  constexpr int WR = RT < 4 ? RT : 4, WK = 4 / WR;
  constexpr int RPW = RT / WR, KPW = KC / WK;
  constexpr int WS = BS + PAD, XS = BK + PAD, STAGE = dec_stage(BS);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);

  const int j = blockIdx.x;
  const int t0 = blockIdx.z * tiles_per_split;
  const int t1 = min(keep, t0 + tiles_per_split);
  const int kv_end = max(t1 - t0, 0) * BS;
  const int nst = (kv_end + BK - 1) / BK;
  const int* col = idx + (size_t)j * keep + t0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp % WR, wk = warp / WR;

  // stage s of the gathered K: weight rows [BK][WS], then x^T's rows [DEC_M][XS]
  auto load = [&](int s) {
    bf16* ws = ring + (s % DEC_STAGES) * STAGE;
    bf16* xs = ws + BK * WS;
    const int kv0 = s * BK;
    for (int i = tid; i < BK * (BS / 8); i += DEC_THREADS) {
      const int kk = i / (BS / 8), c = (i % (BS / 8)) * 8;
      const int kv = kv0 + kk;
      const bool ok = kv < kv_end;
      const int k = ok ? __ldg(col + kv / BS) * BS + kv % BS : 0;
      cp_async16(smem_u32(ws + kk * WS + c), w + (size_t)k * N + (size_t)j * BS + c, ok);
    }
    for (int i = tid; i < MT * 8 * (BK / 8); i += DEC_THREADS) {
      const int m = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int kv = kv0 + c;
      const bool ok = m < M && kv < kv_end;
      const int k = ok ? __ldg(col + kv / BS) * BS + kv % BS : 0;
      cp_async16(smem_u32(xs + m * XS + c), x + (size_t)(ok ? m : 0) * K + k, ok);
    }
  };

  float acc[RPW][MT][4];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) acc[r][mt][0] = acc[r][mt][1] = acc[r][mt][2] = acc[r][mt][3] = 0.f;

#pragma unroll
  for (int s = 0; s < DEC_STAGES - 1; ++s) {
    if (s < nst) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    if (s + DEC_STAGES - 1 < nst) load(s + DEC_STAGES - 1);
    cp_async_commit();
    cp_async_wait<DEC_STAGES - 1>();
    __syncthreads();
    const bf16* ws = ring + (s % DEC_STAGES) * STAGE;
    const bf16* xs = ws + BK * WS;
#pragma unroll
    for (int kq = 0; kq < KPW; ++kq) {
      const int kc = wk + WK * kq;
      uint32_t bx[4];             // x^T of rows 0-7 (bx[0..1]) and 8-15 (bx[2..3])
      ldsm_x4(bx, smem_u32(xs + (lane % 8 + (lane / 16) * 8) * XS + kc * 16 +
                           ((lane / 8) % 2) * 8));
#pragma unroll
      for (int rq = 0; rq < RPW; ++rq) {
        uint32_t a[4];            // w^T rows (output columns) of row tile wr + WR rq
        ldsm_x4_t(a, smem_u32(ws + (kc * 16 + lane % 8 + (lane / 16) * 8) * WS +
                              (wr + WR * rq) * 16 + ((lane / 8) % 2) * 8));
        mma_bf16(acc[rq][0], a, bx[0], bx[1]);
        if (MT > 1) mma_bf16(acc[rq][MT - 1], a, bx[2], bx[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // red[wk][n][m]: each warp's sums, added in warp order
  constexpr int MW = MT * 8;
  float* red = reinterpret_cast<float*>(smem);
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int rq = 0; rq < RPW; ++rq)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int n = (wr + WR * rq) * 16 + g, m = mt * 8 + 2 * t;
      float* r0 = red + (size_t)(wk * BS + n) * MW + m;
      r0[0] = acc[rq][mt][0];
      r0[1] = acc[rq][mt][1];
      r0[8 * MW] = acc[rq][mt][2];
      r0[8 * MW + 1] = acc[rq][mt][3];
    }
  __syncthreads();
  for (int e = tid; e < MW * BS; e += DEC_THREADS) {
    const int m = e / BS, n = e % BS;
    if (m >= M) break;
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < WK; ++q) sum += red[(q * BS + n) * MW + m];
    const size_t at = (size_t)m * N + (size_t)j * BS + n;
    if (partial != nullptr)
      partial[(size_t)blockIdx.z * M * N + at] = sum;
    else
      y[at] = __float2bfloat16_rn(sum);
  }
}

// prefill: 8 warps (2 over rows x 4 over columns, 64 x 32 each) on a
// 128 x 128 output tile, a three-stage ring of 64 gathered rows
constexpr int PF_THREADS = 256, PF_STAGES = 3, PF_BM = 128, PF_BN = 128, PF_BK = 64;
constexpr int PF_XS = PF_BK + PAD, PF_WS = PF_BN + PAD;
constexpr int PF_STAGE = PF_BM * PF_XS + PF_BK * PF_WS;

// grid (ceil(N / PF_BN), ceil(M / PF_BM), splits), PF_THREADS threads.
// Dynamic shared memory: the ring, then kept[K / BS] (bit c: column c of
// the group keeps input block i) and active[K / BS] (the input blocks
// kept by any column of the group, in order).  Split z walks active
// blocks [z per, (z + 1) per).
template <int BS>
__global__ void __launch_bounds__(PF_THREADS, 2)
block_sparse_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const int* __restrict__ idx, bf16* __restrict__ y,
                        float* __restrict__ partial, int M, int N, int K, int keep, int per) {
  constexpr int GN = PF_BN / BS;     // output block columns of the group
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int nbi = K / BS;
  uint32_t* kept = reinterpret_cast<uint32_t*>(ring + PF_STAGES * PF_STAGE);
  int* active = reinterpret_cast<int*>(kept + nbi);
  __shared__ int n_active;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * GN;    // the group's first output block column
  const int ncols = min(GN, N / BS - c0);
  const int m0 = blockIdx.y * PF_BM;

  for (int i = tid; i < nbi; i += PF_THREADS) kept[i] = 0u;
  __syncthreads();
  for (int i = tid; i < ncols * keep; i += PF_THREADS)
    atomicOr(&kept[__ldg(idx + (size_t)c0 * keep + i)], 1u << (i / keep));
  __syncthreads();
  if (warp == 0) {                   // compact the kept blocks, in order
    int cnt = 0;
    for (int base = 0; base < nbi; base += 32) {
      const bool on = base + lane < nbi && kept[base + lane] != 0u;
      const unsigned bal = __ballot_sync(0xffffffffu, on);
      if (on) active[cnt + __popc(bal & ((1u << lane) - 1u))] = base + lane;
      cnt += __popc(bal);
    }
    if (lane == 0) n_active = cnt;
  }
  __syncthreads();
  const int a0 = blockIdx.z * per;
  const int kv_end = max(min(n_active, a0 + per) - a0, 0) * BS;
  const int nst = (kv_end + PF_BK - 1) / PF_BK;

  auto load = [&](int s) {
    bf16* xs = ring + (s % PF_STAGES) * PF_STAGE;
    bf16* ws = xs + PF_BM * PF_XS;
    const int kv0 = s * PF_BK;
    for (int i = tid; i < PF_BM * (PF_BK / 8); i += PF_THREADS) {
      const int r = i / (PF_BK / 8), c = (i % (PF_BK / 8)) * 8;
      const int kv = kv0 + c, m = m0 + r;
      const bool ok = m < M && kv < kv_end;
      const int k = ok ? active[a0 + kv / BS] * BS + kv % BS : 0;
      cp_async16(smem_u32(xs + r * PF_XS + c), x + (size_t)(ok ? m : 0) * K + k, ok);
    }
    for (int i = tid; i < PF_BK * (PF_BN / 8); i += PF_THREADS) {
      const int kk = i / (PF_BN / 8), c = (i % (PF_BN / 8)) * 8;
      const int kv = kv0 + kk;
      bool ok = kv < kv_end && c / BS < ncols;
      size_t off = 0;
      if (ok) {
        const int blk = active[a0 + kv / BS];
        ok = (kept[blk] >> (c / BS)) & 1u;
        off = (size_t)(blk * BS + kv % BS) * N + (size_t)c0 * BS + c;
      }
      cp_async16(smem_u32(ws + kk * PF_WS + c), w + (ok ? off : 0), ok);
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
    if (s + PF_STAGES - 1 < nst) load(s + PF_STAGES - 1);
    cp_async_commit();
    cp_async_wait<PF_STAGES - 1>();
    __syncthreads();
    const bf16* xs = ring + (s % PF_STAGES) * PF_STAGE;
    const bf16* ws = xs + PF_BM * PF_XS;
#pragma unroll
    for (int kc = 0; kc < PF_BK / 16; ++kc) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(a[mi], smem_u32(xs + (wm * 64 + mi * 16 + lane % 16) * PF_XS + kc * 16 +
                                (lane / 16) * 8));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, smem_u32(ws + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) * PF_WS +
                              wn * 32 + np * 16 + (lane / 16) * 8));
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  const int g = lane / 4, t = lane % 4;
  float* part = partial != nullptr ? partial + (size_t)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = c0 * BS + wn * 32 + ni * 8 + 2 * t;
      if (n >= N) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = m0 + wm * 64 + mi * 16 + g + 8 * r;
        if (m < M)
          store_pair(y, part, (size_t)m * N + n, acc[mi][ni][2 * r], acc[mi][ni][2 * r + 1]);
      }
    }
}

template <int BS>
int launch_bs(const bf16* x, const bf16* w, const int* idx, bf16* y, float* part, int M,
              int N, int K, int keep, int small, int splits, int per, cudaStream_t stream) {
  if (small) {
    if (M > DEC_M) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(bf16) * (size_t)DEC_STAGES * dec_stage(BS);
    auto kernel = M > 8 ? &block_sparse_decode_kernel<BS, 2> : &block_sparse_decode_kernel<BS, 1>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(N / BS, 1, splits), DEC_THREADS, smem, stream>>>(x, w, idx, y, part, M, N,
                                                                   K, keep, per);
  } else {
    const size_t smem = sizeof(bf16) * (size_t)PF_STAGES * PF_STAGE +
                        2 * sizeof(int) * (size_t)(K / BS);
    auto kernel = block_sparse_mma_kernel<BS>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((N + PF_BN - 1) / PF_BN, (M + PF_BM - 1) / PF_BM, splits);
    kernel<<<grid, PF_THREADS, smem, stream>>>(x, w, idx, y, part, M, N, K, keep, per);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

int launch(const void* x, const void* w, const void* idx, void* y, void* partial, int M,
           int N, int K, int bs, int keep, int x_bf16, int small, int splits,
           int tiles_per_split, cudaStream_t stream) {
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w);
  const int* ip = static_cast<const int*>(idx);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
#define BS_CASE(B)                                                                       \
  case B:                                                                                \
    err = x_bf16 ? tc::launch_bs<B>(static_cast<const __nv_bfloat16*>(x), wp, ip,        \
                                    static_cast<__nv_bfloat16*>(y), part, M, N, K, keep, \
                                    small, splits, tiles_per_split, stream)              \
                 : launch_fma<B>(static_cast<const float*>(x), wp, ip,                   \
                                 static_cast<float*>(y), part, M, N, K, keep, small,     \
                                 splits, tiles_per_split, stream);                       \
    break;
  int err;
  switch (bs) {
    BS_CASE(16)
    BS_CASE(32)
    BS_CASE(64)
    BS_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BS_CASE
  if (err != cudaSuccess || splits == 1) return err;
  const int MN = M * N;
  if (x_bf16)
    reduce_splits_kernel<__nv_bfloat16><<<(MN + 255) / 256, 256, 0, stream>>>(
        part, static_cast<__nv_bfloat16*>(y), MN, splits, 1);
  else
    reduce_splits_kernel<float><<<(MN + 255) / 256, 256, 0, stream>>>(
        part, static_cast<float*>(y), MN, splits, 1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [M, K] (bf16 if x_bf16 else f32) with 16-byte aligned rows, w [K, N]
// bf16 with 16-byte aligned rows, idx [N / bs, keep] int32 with entries
// in [0, K / bs), y [M, N] in x's dtype, partial [splits, M, N] f32 (used
// when splits > 1); bs is 16, 32, 64 or 128 and divides K and N.  `small`
// (M <= 16) picks the skinny design: `decode` in bf16, the skinny FMA tile
// in f32; otherwise `mma` in bf16, the square FMA tile in f32.  Each split
// walks tiles_per_split input blocks: kept tiles of one column for
// `decode` and the FMA tiles, blocks kept by the group for `mma`.
// Returns cudaGetLastError() after the launches.
int block_sparse_launch(const void* x, const void* w, const void* idx, void* y,
                        void* partial, int M, int N, int K, int bs, int keep,
                        int x_bf16, int small, int splits, int tiles_per_split,
                        void* stream) {
  return launch(x, w, idx, y, partial, M, N, K, bs, keep, x_bf16, small, splits,
                tiles_per_split, static_cast<cudaStream_t>(stream));
}

// Output tile of each design: rows of x a block owns, and output columns
// (bs for the single-column designs, the group's width for `mma`).
int block_sparse_tile_m(int x_bf16, int small) {
  if (x_bf16) return small ? tc::DEC_M : tc::PF_BM;
  return small ? SMALL_BM : LARGE_BM;
}
int block_sparse_tile_n(int x_bf16, int small, int bs) {
  return x_bf16 && !small ? tc::PF_BN : bs;
}

}  // extern "C"
