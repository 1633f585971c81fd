// Paged-KV decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention_kernel`
// (src/repro/kernels/paged_attention.py, wrapper ops.paged_attention):
// one decode token per slot; the G = H / Kh query heads of each KV head
// attend over the slot's positions, whose K/V rows live in pool blocks
// named by the slot's block table.  Scores are f32, scaled by 1/sqrt(D),
// optionally tanh-softcapped; positions >= lengths[s] and, with a window,
// < lengths[s] - window get weight 0; the softmax is exact (max-
// subtracted over all of the slot's positions, not an online
// recurrence), probabilities are rounded to V's dtype before the f32 PV
// sum, and the output is stored in q's dtype.
//
// What bounds it on the H100: bytes.  Each K and V element read is used
// for G multiply-adds: G = 2 at gemma2-2b's shape, so the call is the time
// to read the slots' live K/V rows (plus the q/out rows) at 3.35 TB/s:
// 1.3 us for 8 slots of 128 positions there, 10 us for 8 slots of 1024.
// granite-20b's MQA (48 query heads on one KV head of 128) makes G = 48:
// 201 MFLOP over 4.4 MB for 8 slots of 1024, about 3.0 us on the FMA pipes
// against 1.3 us of bytes, so at large G the products go to the tensor
// cores, where they take about 0.2 us and bytes bound the call again.
//
// Three designs, chosen by dtype and G (ops.paged_attention_variant),
// never by a failure.  All three cut the slots the same way and keep the
// same arithmetic:
// - the positions of a slot are cut into splits of a whole number of pool
//   blocks, planned by the wrapper from the span (the table's length, or
//   the window if smaller; ops.paged_attention_plan), never from
//   `lengths`, which live on the card.  Split z covers positions
//   [lo + z per, lo + (z + 1) per) of the live range [lo, len),
//   lo = max(0, len - window), so a window costs no dead splits, and a
//   block whose split lies past the live range exits at once;
// - K and V rows are read through the table (aliased prefix blocks and
//   the engine's trash block cost nothing extra);
// - rounding stays where the reference has it: probabilities are rounded
//   to V's dtype only once the slot's global max and sum, formed from the
//   splits' (max, sum of exp) pairs in split order, are known, and the
//   splits' f32 PV partials are added in split order, so no sum depends
//   on scheduling.  A split with no live key contributes nothing (its max
//   is -inf and its sum 0).
//
// `split` (G <= MAX_G = 8, bf16 and f32): one block per (split, KV head,
// slot) reads each of its live K rows once, a row per group of lanes with
// 16-byte loads (one warp covers a D = 256 bf16 row in one load), several
// rows in flight per lane; the G query rows stay in registers.  A row of
// D / 8 (bf16) or D / 4 (f32) pieces that is not a power of two (zamba2's
// D = 112: 14 and 28 pieces) takes the next power of two of lanes, 16 or
// 32, and the idle lanes hold zero pieces, which add nothing to the
// xor-shuffle sums over the row's lanes and store nothing.  Two kernels:
// - scores: writes each live position's G scores (f32) and its split's
//   (max, sum of exp) to a workspace;
// - pv: forms the slot's global (m, l) from the splits' pairs, in split
//   order, rounds exp(s - m) / l to V's dtype for its positions and sums
//   its PV partial in f32 over V rows read like K's; the last block of a
//   (slot, head) to finish, by a ticket counter that the scores kernel
//   reset, adds the partials in split order and stores the output.
// The pv kernel is launched as a programmatic dependent of the scores
// kernel, so its launch and its V loads overlap the scores kernel.  Both
// stay on the FMA pipes: with G = 2 query rows per KV head an m16n8k16
// tile would be mostly padding on a byte-bound call.
//
// `chunked` (f32 with G > 8, and bf16 with G > wide::MAX_G): the split
// kernels over `chunks` blocks per KV head, each owning G / chunks <= 8 of
// its query rows (the largest such divisor of G); each block reads the
// head's K/V rows again, from L2 after the first.  f32 has no tensor-core
// path that keeps the exact f32 products the 1e-5 checks need.
//
// `mma` (bf16, 8 < G <= wide::MAX_G = 64): the query rows, padded to a
// multiple of 16, are the A operand of mma.sync.m16n8k16 (bf16 -> f32).
// One block of four warps per (split, KV head, slot), as in `split`, and
// three kernels, each a programmatic dependent of the one before:
// - scores: q and the split's K rows arrive in shared memory by cp.async
//   (K through the table, rows padded by 16 bytes so ldmatrix is
//   conflict-free); warps take (m16 tile, 16 positions) items of q K^T,
//   and the scaled, softcapped scores and the split's (max, sum of exp)
//   per query row go to the same workspace as `split`'s;
// - pv: stages the split's V rows before the scores kernel has finished,
//   forms the slot's (m, l) from the pairs in split order, writes the
//   probabilities rounded to bf16 to shared memory (pad rows and columns
//   zero) and stores the split's f32 partial P V, by (m16 tile, 16
//   columns) items;
// - reduce: a thread per four outputs adds the live splits' partials in
//   split order, over the whole card rather than one block per head.
// Its plan takes at least 2 G positions a split (ops.paged_attention_plan's
// min_per), so a split's f32 partial [G][D] is no larger than its bf16 V
// rows.  Shared memory: (D + 8)(GP + per) bf16 for scores, (D + 8) per +
// GP (per + 8) for pv, GP = G rounded up to 16: at most 169 KB (G 64,
// D 256, per 256), the opt-in attribute set to that once a device.
#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int MAX_G = 8;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_PER = 256;          // positions per split
constexpr int UNROLL = 8;             // rows in flight per lane

// 16 bytes of T (one load), widened to f32: 8 bf16 or 4 f32 elements.
__device__ __forceinline__ int4 load16(const void* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}
template <typename T> struct Piece;
template <> struct Piece<__nv_bfloat16> {
  static constexpr int E = 8;
  static __device__ __forceinline__ void widen(const int4& raw, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
};
template <> struct Piece<float> {
  static constexpr int E = 4;
  static __device__ __forceinline__ void widen(const int4& raw, float (&f)[4]) {
    f[0] = __int_as_float(raw.x), f[1] = __int_as_float(raw.y);
    f[2] = __int_as_float(raw.z), f[3] = __int_as_float(raw.w);
  }
};

// Lanes of a warp over one K or V row of np 16-byte pieces: LR lanes per
// row, the power of two at or above np up to 32 (piece pl + LR i, i < PPL,
// of lane pl, where it lies in the row: has(i)), RW = 32 / LR rows side by
// side.
struct RowLanes {
  int np, LR, PPL, RW, sub, pl;
  __device__ RowLanes(int D, int E, int lane) {
    np = D / E;
    LR = 1;
    while (LR < np && LR < 32) LR <<= 1;
    PPL = (np + LR - 1) / LR;
    RW = 32 / LR;
    sub = lane / LR;
    pl = lane % LR;
  }
  __device__ bool has(int i) const { return pl + LR * i < np; }
};

// Where the split of block (z, h, s) lies: positions [t0, t1) (empty when
// t0 >= t1), and how many leading splits of the slot are not empty.
struct Split {
  int t0, t1, live;
  __device__ Split(const int* lengths, int s, int z, int T, int window, int per) {
    const int len = lengths[s];
    const int hi = min(len, T);
    const int lo = window > 0 ? max(0, len - window) : 0;
    t0 = lo + z * per;
    t1 = min(hi, t0 + per);
    live = hi > lo ? (hi - lo + per - 1) / per : 0;
  }
};

// Workspace layout (f32 unless said): partial [S Kh][splits][G][D] first
// (its rows stay 16-byte aligned), scores [S Kh][G][splits per],
// ml [S Kh][splits][G][2], then the tickets [S Kh] int32.
struct Workspace {
  float *partial, *scores, *ml;
  int* tickets;
  __host__ __device__ Workspace(void* base, int S, int Kh, int G, int D, int splits, int per) {
    const size_t sk = (size_t)S * Kh;
    partial = static_cast<float*>(base);
    scores = partial + sk * splits * G * D;
    ml = scores + sk * G * splits * per;
    tickets = reinterpret_cast<int*>(ml + sk * splits * G * 2);
  }
  static size_t bytes(int S, int Kh, int G, int D, int splits, int per) {
    const size_t sk = (size_t)S * Kh;
    return 4 * (sk * G * splits * per + sk * splits * G * 2 + sk * splits * G * D + sk);
  }
};

// The lane's pieces of rows i0, i0 + stride, ... (UNROLL of them) of the
// split that starts at position t0 and holds n rows: first the rows' table
// entries, then their 16-byte pieces, so that all are in flight before
// the first is used.  Rows past the split repeat its last row.
template <typename T, int MAX_PPL>
__device__ __forceinline__ void load_rows(int4 (&raw)[UNROLL][MAX_PPL], const T* pool,
                                          const int* trow, int t0, int i0, int stride, int n,
                                          int bs, int Kh, int h, int D, const RowLanes& rl) {
  int blk[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) blk[u] = __ldg(trow + (t0 + min(i0 + u * stride, n - 1)) / bs);
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int t = t0 + min(i0 + u * stride, n - 1);
    const T* row = pool + (((size_t)blk[u] * bs + t % bs) * Kh + h) * D;
#pragma unroll
    for (int c = 0; c < MAX_PPL; ++c)
      if (c < rl.PPL)
        raw[u][c] = rl.has(c) ? load16(row + (rl.pl + rl.LR * c) * Piece<T>::E)
                              : make_int4(0, 0, 0, 0);
  }
}

// grid (splits, Kh, S), THREADS threads.  Dynamic shared memory: the
// split's scores [G][per] f32.
template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
paged_scores_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const int* __restrict__ tables, const int* __restrict__ lengths,
                    Workspace ws, int Kh, int D, int bs, int nblk, float scale, float softcap,
                    int window, int splits, int per, int nc) {
  using P = Piece<T>;
  constexpr int E = P::E, MAX_PPL = sizeof(T) == 4 ? 2 : 1;
  extern __shared__ float sc[];
  // block row y owns query rows [G (y % nc), G (y % nc + 1)) of KV head
  // y / nc (nc > 1: the `chunked` design), so q, out and the workspace
  // index by (slot, y)
  const int z = blockIdx.x, h = blockIdx.y / nc, s = blockIdx.z;
  const int sh = s * gridDim.y + blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  allow_dependents();                              // the pv kernel may launch now
  if (z == 0 && tid == 0) ws.tickets[sh] = 0;      // the pv kernel's counter
  const Split sp(lengths, s, z, nblk * bs, window, per);
  const int n = sp.t1 - sp.t0;
  if (n <= 0) return;
  const RowLanes rl(D, E, lane);
  const int* trow = tables + (size_t)s * nblk;

  int4 qraw[MAX_PPL][G];
#pragma unroll
  for (int i = 0; i < MAX_PPL; ++i)
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (i < rl.PPL)
        qraw[i][g] = rl.has(i) ? load16(q + ((size_t)sh * G + g) * D + (rl.pl + rl.LR * i) * E)
                               : make_int4(0, 0, 0, 0);
  // the warp's first rows: their table entries, then their pieces, all in
  // flight with q's before any is used (rows past the split repeat its last)
  const int stride = WARPS * rl.RW, first = warp * rl.RW;
  int4 raw[UNROLL][MAX_PPL];
  load_rows<T, MAX_PPL>(raw, k_pool, trow, sp.t0, first + rl.sub, stride, n, bs, Kh, h, D, rl);
  float qv[MAX_PPL][E][G];
#pragma unroll
  for (int i = 0; i < MAX_PPL; ++i)
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (i < rl.PPL) {
        float f[E];
        P::widen(qraw[i][g], f);
#pragma unroll
        for (int e = 0; e < E; ++e) qv[i][e][g] = f[e];
      }

  for (int base = first; base < n; base += stride * UNROLL) {
    if (base != first)
      load_rows<T, MAX_PPL>(raw, k_pool, trow, sp.t0, base + rl.sub, stride, n, bs, Kh, h, D,
                            rl);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + rl.sub + u * stride;
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dot[g] = 0.f;
#pragma unroll
      for (int c = 0; c < MAX_PPL; ++c)
        if (c < rl.PPL) {
          float kv[E];
          P::widen(raw[u][c], kv);
#pragma unroll
          for (int e = 0; e < E; ++e)
#pragma unroll
            for (int g = 0; g < G; ++g) dot[g] = fmaf(qv[c][e][g], kv[e], dot[g]);
        }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float v = dot[g];
        for (int off = rl.LR / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (rl.pl == 0 && i < n) {
          v *= scale;
          if (softcap != 0.f) v = tanhf(v / softcap) * softcap;
          sc[g * per + i] = v;
          ws.scores[((size_t)sh * G + g) * splits * per + z * per + i] = v;
        }
      }
    }
  }
  __syncthreads();

  // the split's (max, sum of exp) per query head, one warp per head
  for (int g = warp; g < G; g += WARPS) {
    float m = -INFINITY;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, sc[g * per + i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int i = lane; i < n; i += 32) l += expf(sc[g * per + i] - m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      float* ml = ws.ml + (((size_t)sh * splits + z) * G + g) * 2;
      ml[0] = m;
      ml[1] = l;
    }
  }
}

// grid (splits, Kh, S), THREADS threads.  Dynamic shared memory: the
// warps' PV sums [WARPS][G][D] f32, then probabilities [G][per] f32.
template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
paged_pv_kernel(const T* __restrict__ v_pool, const int* __restrict__ tables,
                const int* __restrict__ lengths, Workspace ws, T* __restrict__ out, int Kh,
                int D, int bs, int nblk, int window, int splits, int per, int nc) {
  using P = Piece<T>;
  constexpr int E = P::E, MAX_PPL = sizeof(T) == 4 ? 2 : 1;
  extern __shared__ float smem[];
  __shared__ float gm[MAX_G], gl[MAX_G];
  __shared__ bool last;
  float* red = smem;
  float* pr = smem + WARPS * G * D;
  const int z = blockIdx.x, h = blockIdx.y / nc, s = blockIdx.z;
  const int sh = s * gridDim.y + blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Split sp(lengths, s, z, nblk * bs, window, per);
  const int n = sp.t1 - sp.t0;
  float* part = ws.partial + (size_t)sh * splits * G * D;
  // the warp's first V rows go out before the scores kernel has finished:
  // they do not depend on it
  const RowLanes rl(D, E, lane);
  const int* trow = tables + (size_t)s * nblk;
  const int stride = WARPS * rl.RW, first = warp * rl.RW;
  int4 raw[UNROLL][MAX_PPL];
  if (n > 0)
    load_rows<T, MAX_PPL>(raw, v_pool, trow, sp.t0, first + rl.sub, stride, n, bs, Kh, h, D,
                          rl);
  wait_for_prerequisite();           // the scores kernel's workspace and tickets

  if (n > 0) {
    // the slot's global max and sum, from the live splits' pairs in order
    if (tid < G) {
      const float* ml = ws.ml + (size_t)sh * splits * G * 2;
      float m = -INFINITY;
#pragma unroll 8
      for (int y = 0; y < sp.live; ++y) m = fmaxf(m, ml[(y * G + tid) * 2]);
      float l = 0.f;
#pragma unroll 8
      for (int y = 0; y < sp.live; ++y) {
        const float* p = ml + (y * G + tid) * 2;
        l += p[1] * expf(p[0] - m);
      }
      gm[tid] = m;
      gl[tid] = l;
    }
    __syncthreads();
    // probabilities, rounded to V's dtype as the reference rounds them
    for (int e = tid; e < G * n; e += THREADS) {
      const int g = e / n, i = e % n;
      const float sv = ws.scores[((size_t)sh * G + g) * splits * per + z * per + i];
      pr[g * per + i] = to_f(from_f<T>(expf(sv - gm[g]) / gl[g]));
    }
    __syncthreads();

    float acc[MAX_PPL][E][G];
#pragma unroll
    for (int c = 0; c < MAX_PPL; ++c)
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int g = 0; g < G; ++g) acc[c][e][g] = 0.f;
    for (int base = first; base < n; base += stride * UNROLL) {
      if (base != first)
        load_rows<T, MAX_PPL>(raw, v_pool, trow, sp.t0, base + rl.sub, stride, n, bs, Kh, h,
                              D, rl);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + rl.sub + u * stride;
        if (i >= n) continue;
#pragma unroll
        for (int c = 0; c < MAX_PPL; ++c)
          if (c < rl.PPL) {
            float vv[E];
            P::widen(raw[u][c], vv);
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const float p = pr[g * per + i];
#pragma unroll
              for (int e = 0; e < E; ++e) acc[c][e][g] = fmaf(p, vv[e], acc[c][e][g]);
            }
          }
      }
    }
    // the warp's rows side by side, then the warps in order
#pragma unroll
    for (int c = 0; c < MAX_PPL; ++c)
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int g = 0; g < G; ++g)
          for (int off = rl.LR; off < 32; off <<= 1)
            acc[c][e][g] += __shfl_xor_sync(0xffffffffu, acc[c][e][g], off);
    if (rl.sub == 0)
#pragma unroll
      for (int c = 0; c < MAX_PPL; ++c)
        if (c < rl.PPL && rl.has(c))
#pragma unroll
          for (int e = 0; e < E; ++e)
#pragma unroll
            for (int g = 0; g < G; ++g)
              red[(warp * G + g) * D + (rl.pl + rl.LR * c) * E + e] = acc[c][e][g];
    __syncthreads();
    for (int e = tid; e < G * D / 4; e += THREADS) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float4 r = reinterpret_cast<const float4*>(red + w * G * D)[e];
        sum.x += r.x, sum.y += r.y, sum.z += r.z, sum.w += r.w;
      }
      reinterpret_cast<float4*>(part + (size_t)z * G * D)[e] = sum;
    }
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(ws.tickets + sh, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  // the last block of the (slot, head): partials added in split order
  T* orow = out + (size_t)sh * G * D;
  for (int e = tid; e < G * D / 4; e += THREADS) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int y = 0; y < sp.live; ++y) {
      const float4 r = __ldcg(reinterpret_cast<const float4*>(part + (size_t)y * G * D) + e);
      sum.x += r.x, sum.y += r.y, sum.z += r.z, sum.w += r.w;
    }
    orow[4 * e] = from_f<T>(sum.x);
    orow[4 * e + 1] = from_f<T>(sum.y);
    orow[4 * e + 2] = from_f<T>(sum.z);
    orow[4 * e + 3] = from_f<T>(sum.w);
  }
}

template <typename T, int G>
int launch_g(const T* q, const T* k_pool, const T* v_pool, const int* tables,
             const int* lengths, void* work, T* out, int S, int Kh, int D, int bs, int nblk,
             float scale, float softcap, int window, int splits, int per, int nc,
             cudaStream_t stream) {
  const Workspace ws(work, S, Kh * nc, G, D, splits, per);
  const dim3 grid(splits, Kh * nc, S);
  paged_scores_kernel<T, G><<<grid, THREADS, sizeof(float) * G * per, stream>>>(
      q, k_pool, tables, lengths, ws, Kh, D, bs, nblk, scale, softcap, window, splits, per,
      nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dependent(paged_pv_kernel<T, G>, grid, THREADS,
                                           sizeof(float) * G * (per + WARPS * D), stream,
                                           v_pool, tables, lengths, ws, out, Kh, D, bs, nblk,
                                           window, splits, per, nc));
}

// ---------------------------------------------------------------------------
// bf16, many query rows per KV head: the tensor-core design (`mma`)
// ---------------------------------------------------------------------------

namespace wide {

constexpr int MAX_G = 64;            // query rows per KV head (four m16 tiles)
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int PAD = 8;               // bf16 elements (16 bytes) of row padding

// Copy `rows` rows of D bf16 into shared memory at row stride D + PAD with
// cp.async: row r < valid from row_of(r), the rest zero-filled (their
// source, row_of(0), is read by no one).
template <typename RowOf>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int rows, int valid, int D,
                                           RowOf row_of) {
  const int ch = D / 8;              // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * ch; i += THREADS) {
    const int r = i / ch, c = (i % ch) * 8;
    const bool ok = r < valid;
    cp_async16(smem_u32(dst + r * (D + PAD) + c), row_of(ok ? r : 0) + c, ok);
  }
}

// Row i of the split at t0 in a pool, through the slot's table row.
struct PoolRows {
  const __nv_bfloat16* pool;
  const int* trow;
  int t0, bs, Kh, h, D;
  __device__ const __nv_bfloat16* operator()(int i) const {
    const int t = t0 + i;
    return pool + (((size_t)__ldg(trow + t / bs) * bs + t % bs) * Kh + h) * D;
  }
};

// grid (splits, Kh, S), THREADS threads.  Dynamic shared memory: q
// [GP][D + PAD] | K [NP][D + PAD] (bf16), GP = G and NP = the split's
// rows, each rounded up to 16.  Warps take (m16 tile, 16 positions) items
// of S = q K^T in turn; the scores, scaled and softcapped, go to the
// workspace, from which the block then forms each query row's (max, sum
// of exp) over the split.
__global__ void __launch_bounds__(THREADS)
scores_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pool,
              const int* __restrict__ tables, const int* __restrict__ lengths, Workspace ws,
              int Kh, int G, int D, int bs, int nblk, float scale, float softcap, int window,
              int splits, int per) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int z = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int sh = s * Kh + h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  allow_dependents();                // the pv kernel may launch now
  const Split sp(lengths, s, z, nblk * bs, window, per);
  const int n = sp.t1 - sp.t0;
  if (n <= 0) return;
  const int RS = D + PAD, MT = (G + 15) / 16, NP = (n + 15) / 16 * 16;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + MT * 16 * RS;
  const __nv_bfloat16* qrow = q + (size_t)sh * G * D;
  stage_rows(qs, MT * 16, G, D, [&](int r) { return qrow + (size_t)r * D; });
  stage_rows(ks, NP, n, D, PoolRows{k_pool, tables + (size_t)s * nblk, sp.t0, bs, Kh, h, D});
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float* srow = ws.scores + (size_t)sh * G * splits * per + (size_t)z * per;
  for (int it = warp; it < MT * (NP / 16); it += WARPS) {
    const int mt = it % MT, np = it / MT;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[4], b[4];
      ldsm_x4(a, smem_u32(qs + (mt * 16 + lane % 16) * RS + kc * 16 + (lane / 16) * 8));
      ldsm_x4(b, smem_u32(ks + (np * 16 + lane % 8 + (lane / 16) * 8) * RS + kc * 16 +
                          ((lane / 8) % 2) * 8));
      mma_bf16(acc[0], a, b[0], b[1]);
      mma_bf16(acc[1], a, b[2], b[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = mt * 16 + g + (e / 2) * 8, i = np * 16 + j * 8 + 2 * t + (e & 1);
        if (row >= G || i >= n) continue;
        float v = acc[j][e] * scale;
        if (softcap != 0.f) v = tanhf(v / softcap) * softcap;
        srow[(size_t)row * splits * per + i] = v;
      }
  }
  __syncthreads();                   // the block's scores are visible to the block

  // the split's (max, sum of exp) per query row, one warp per row
  for (int r = warp; r < G; r += WARPS) {
    const float* sr = srow + (size_t)r * splits * per;
    float m = -INFINITY;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, sr[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int i = lane; i < n; i += 32) l += expf(sr[i] - m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      float* ml = ws.ml + (((size_t)sh * splits + z) * G + r) * 2;
      ml[0] = m;
      ml[1] = l;
    }
  }
}

// grid (splits, Kh, S), THREADS threads.  Dynamic shared memory: V
// [NP][D + PAD] | P [GP][NP + PAD] (bf16).  The split's V rows are staged
// before the scores kernel has finished (they do not depend on it); then
// the slot's (m, l) from the live splits' pairs in split order, the
// probabilities rounded to bf16, and the split's f32 partial P V [G][D]
// by (m16 tile, 16 columns) items, stored to the workspace.
__global__ void __launch_bounds__(THREADS)
pv_kernel(const __nv_bfloat16* __restrict__ v_pool, const int* __restrict__ tables,
          const int* __restrict__ lengths, Workspace ws, int Kh, int G, int D, int bs,
          int nblk, int window, int splits, int per) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float gm[MAX_G], gl[MAX_G];
  const int z = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int sh = s * Kh + h;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  allow_dependents();                // the reduce kernel may launch now
  const Split sp(lengths, s, z, nblk * bs, window, per);
  const int n = sp.t1 - sp.t0;
  const int RS = D + PAD, MT = (G + 15) / 16, NP = (n + 15) / 16 * 16, PS = NP + PAD;
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ps = vs + NP * RS;
  if (n > 0)
    stage_rows(vs, NP, n, D, PoolRows{v_pool, tables + (size_t)s * nblk, sp.t0, bs, Kh, h, D});
  cp_async_commit();
  wait_for_prerequisite();           // the scores kernel's scores and pairs
  if (n <= 0) return;

  if (tid < G) {
    const float* ml = ws.ml + (size_t)sh * splits * G * 2;
    float m = -INFINITY;
    for (int y = 0; y < sp.live; ++y) m = fmaxf(m, ml[(y * G + tid) * 2]);
    float l = 0.f;
    for (int y = 0; y < sp.live; ++y) {
      const float* p = ml + (y * G + tid) * 2;
      l += p[1] * expf(p[0] - m);
    }
    gm[tid] = m;
    gl[tid] = l;
  }
  __syncthreads();
  // probabilities, rounded to bf16 as the reference rounds them; the pad
  // rows and columns are zero
  const float* srow = ws.scores + (size_t)sh * G * splits * per + (size_t)z * per;
  for (int e = tid; e < MT * 16 * NP; e += THREADS) {
    const int r = e / NP, i = e % NP;
    float p = 0.f;
    if (r < G && i < n) p = expf(srow[(size_t)r * splits * per + i] - gm[r]) / gl[r];
    ps[r * PS + i] = __float2bfloat16_rn(p);
  }
  cp_async_wait<0>();
  __syncthreads();

  float* part = ws.partial + ((size_t)sh * splits + z) * G * D;
  for (int it = warp; it < MT * (D / 16); it += WARPS) {
    const int mt = it % MT, dp = it / MT;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int kc = 0; kc < NP / 16; ++kc) {
      uint32_t a[4], b[4];
      ldsm_x4(a, smem_u32(ps + (mt * 16 + lane % 16) * PS + kc * 16 + (lane / 16) * 8));
      ldsm_x4_t(b, smem_u32(vs + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) * RS + dp * 16 +
                            (lane / 16) * 8));
      mma_bf16(acc[0], a, b[0], b[1]);
      mma_bf16(acc[1], a, b[2], b[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = mt * 16 + g + 8 * r;
        if (row < G)
          *reinterpret_cast<float2*>(part + (size_t)row * D + dp * 16 + j * 8 + 2 * t) =
              make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      }
  }
}

// grid (ceil(G D / 4 / THREADS), Kh, S): out = the live splits' partials
// added in split order, four elements a thread.
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const int* __restrict__ lengths, Workspace ws, __nv_bfloat16* __restrict__ out,
              int Kh, int G, int D, int T, int window, int splits, int per) {
  const int h = blockIdx.y, s = blockIdx.z, sh = s * Kh + h;
  const int e = blockIdx.x * THREADS + threadIdx.x;
  const int live = Split(lengths, s, 0, T, window, per).live;
  wait_for_prerequisite();           // every split's partial
  if (e >= G * D / 4) return;
  const float4* part = reinterpret_cast<const float4*>(ws.partial + (size_t)sh * splits * G * D);
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int y = 0; y < live; ++y) {
    const float4 r = __ldcg(part + (size_t)y * G * D / 4 + e);
    sum.x += r.x, sum.y += r.y, sum.z += r.z, sum.w += r.w;
  }
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + (size_t)sh * G * D) + 2 * e;
  o[0] = __floats2bfloat162_rn(sum.x, sum.y);
  o[1] = __floats2bfloat162_rn(sum.z, sum.w);
}

size_t scores_smem(int G, int D, int per) {
  return sizeof(__nv_bfloat16) * (size_t)(D + PAD) * ((G + 15) / 16 * 16 + (per + 15) / 16 * 16);
}
size_t pv_smem(int G, int D, int per) {
  const size_t np = (per + 15) / 16 * 16;
  return sizeof(__nv_bfloat16) * (np * (D + PAD) + (size_t)(G + 15) / 16 * 16 * (np + PAD));
}

// Opts both kernels in to the design's most dynamic shared memory (G 64,
// D 256, per 256: 169 KB), once a device rather than at every launch.
cudaError_t opt_in_smem() {
  static std::atomic<unsigned> done{0};   // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)scores_smem(MAX_G, 256, MAX_PER));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)pv_smem(MAX_G, 256, MAX_PER));
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

int launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
           const void* lengths, void* work, void* out, int S, int Kh, int G, int D, int bs,
           int nblk, float scale, float softcap, int window, int splits, int per,
           cudaStream_t stream) {
  if (G < 1 || G > MAX_G || D % 16 || D > 256 || per > MAX_PER || per % bs)
    return cudaErrorInvalidValue;
  const Workspace ws(work, S, Kh, G, D, splits, per);
  const dim3 grid(splits, Kh, S);
  const size_t s_smem = scores_smem(G, D, per), p_smem = pv_smem(G, D, per);
  cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
  scores_kernel<<<grid, THREADS, s_smem, stream>>>(
      qb, static_cast<const __nv_bfloat16*>(k_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), ws, Kh, G, D, bs, nblk, scale, softcap, window,
      splits, per);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_dependent(pv_kernel, grid, THREADS, p_smem, stream,
                           static_cast<const __nv_bfloat16*>(v_pool),
                           static_cast<const int*>(tables), static_cast<const int*>(lengths),
                           ws, Kh, G, D, bs, nblk, window, splits, per);
  if (err == cudaSuccess)
    err = launch_dependent(reduce_kernel, dim3((G * D / 4 + THREADS - 1) / THREADS, Kh, S),
                           THREADS, 0, stream, static_cast<const int*>(lengths), ws,
                           static_cast<__nv_bfloat16*>(out), Kh, G, D, nblk * bs, window,
                           splits, per);
  return static_cast<int>(err);
}

}  // namespace wide

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
           const void* lengths, void* work, void* out, int S, int Kh, int G, int D, int bs,
           int nblk, float scale, float softcap, int window, int splits, int per, int nc,
           cudaStream_t stream) {
  if (D % Piece<T>::E || D / Piece<T>::E > 32 * (sizeof(T) == 4 ? 2 : 1) ||
      per > MAX_PER || per % bs || nc < 1)
    return cudaErrorInvalidValue;
#define G_CASE(GG)                                                                        \
  case GG:                                                                                \
    return launch_g<T, GG>(static_cast<const T*>(q), static_cast<const T*>(k_pool),       \
                           static_cast<const T*>(v_pool), static_cast<const int*>(tables), \
                           static_cast<const int*>(lengths), work, static_cast<T*>(out),  \
                           S, Kh, D, bs, nblk, scale, softcap, window, splits, per, nc,    \
                           stream);
  switch (G) {
    G_CASE(1)
    G_CASE(2)
    G_CASE(3)
    G_CASE(4)
    G_CASE(5)
    G_CASE(6)
    G_CASE(7)
    G_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef G_CASE
}

}  // namespace

extern "C" {

int paged_attention_max_g() { return MAX_G; }
int paged_attention_mma_max_g() { return wide::MAX_G; }

// Bytes of the workspace a launch with this shape and plan needs (for the
// `chunked` design: Kh * chunks heads of G / chunks rows).
long long paged_attention_workspace(int S, int Kh, int G, int D, int splits, int per) {
  return static_cast<long long>(Workspace::bytes(S, Kh, G, D, splits, per));
}

// q [S, Kh, G, D], pools [nb, bs, Kh, D] (bf16 if is_bf16 else f32, all
// alike, 16-byte aligned), tables [S, nblk] int32, lengths [S] int32
// (1 <= lengths <= nblk * bs), out like q, work of
// paged_attention_workspace() bytes (16-byte aligned).  D is a multiple
// of 8 (bf16) or 4 (f32) up to 256 (ops.PA_HEAD_DIMS: 16, 32, 64, 112,
// 128 and 256).  splits * per covers the span (the window, or nblk * bs
// if smaller), per is a multiple of bs up to MAX_PER (ops.PA_MAX_PER).
// design 0 (`split`, G <= MAX_G) and 2 (`chunked`) run the split kernels
// over `chunks` blocks of G / chunks <= MAX_G query rows per KV head
// (chunks 1 for `split`); design 1 (`mma`, bf16) runs the tensor-core
// kernels on G <= wide::MAX_G rows.  scale and softcap are f32 values
// passed by their bit patterns.  Returns cudaGetLastError() after the
// launches.
int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                           const void* tables, const void* lengths, void* work, void* out,
                           int S, int Kh, int G, int D, int bs, int nblk, int scale_bits,
                           int softcap_bits, int window, int splits, int per, int is_bf16,
                           int design, int chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = bits_to_float(scale_bits);
  const float softcap = bits_to_float(softcap_bits);
  if (design == 1)
    return is_bf16 ? wide::launch(q, k_pool, v_pool, tables, lengths, work, out, S, Kh, G, D,
                                  bs, nblk, scale, softcap, window, splits, per, st)
                   : static_cast<int>(cudaErrorInvalidValue);
  if (chunks < 1 || G % chunks || (design == 0 && chunks != 1) || design < 0 || design > 2)
    return cudaErrorInvalidValue;
  const int gc = G / chunks;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, work, out, S, Kh, gc, D,
                                 bs, nblk, scale, softcap, window, splits, per, chunks, st);
  return launch<float>(q, k_pool, v_pool, tables, lengths, work, out, S, Kh, gc, D, bs, nblk,
                       scale, softcap, window, splits, per, chunks, st);
}

}  // extern "C"
