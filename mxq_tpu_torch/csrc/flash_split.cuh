// Flash attention's tiles on wgmma, shared by K13 (flash_attn.cu) and
// K13-bwd (flash_attn_bwd.cu): bf16 pairs and the hi + lo split of float32
// values, the products over TMA-loaded tiles with one bf16 plane (the bf16
// path) or two (the float32 path's split products), the producer's
// cp.async of bf16 rows into the same tile layout (head_dims whose rows
// TMA cannot address), stores of outputs at their true width, and the
// split pass.
//
// The float32 path runs the bf16 kernels on bf16 planes hi = bf16(x) and
// lo = bf16(x - hi) (x = hi + lo to about 16 significant bits, as the
// TPU's float32 matmul is bf16 passes too): every product A . B becomes
// hi.lo + lo.hi + hi.hi, the small terms first, each accumulated in f32.
// TMA copies bytes and cannot split a float32 tile on its way into shared
// memory, so a pass of its own (the split kernels below) writes the
// planes to global memory first, where TMA copies them as it copies bf16
// rows. That pass is bound by bytes: each float32 element read once, its
// two bf16 halves written once (8 bytes an element); at T = 2048 and 32
// heads of 128, q, k and v are 100 MB read and 100 MB written, about
// 0.06 ms at 3.35 TB/s.
// Each source includes it inside its anonymous namespace, after
// device_util.cuh and hopper_util.cuh.

#pragma once

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x = hi + lo, hi = bf16(x), lo = bf16(x - hi), for a pair of values (x -
// hi is exact in f32)
__device__ __forceinline__ void split_bf2(float x, float y, uint32_t& hi,
                                          uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf2(x - f.x, y - f.y);
}

// ---- products over tiles as TMA leaves them --------------------------------
// A tile of R rows of a [..][D] operand lies as D / 64 boxes of R lines of
// 128 bytes (TMA's 128-byte swizzle); with NP = 2 planes its lo plane
// follows its hi plane, R D elements on.

// acc (+)= A[row0 .. row0 + 64) . B^T over D, both K-major: A rows of an
// [RA][D] tile, B N rows of an [RB][D] tile (b at the first of them, a
// multiple of 8 lines into its box; k16 slice kk: box kk / 4, 32 (kk % 4)
// bytes into the line); acc is overwritten. NP = 2: hi.lo + lo.hi + hi.hi.
template <int D, int RA, int N, int NP, int RB = N>
__device__ __forceinline__ void gemm_abt(float (&acc)[N / 2],
                                         const __nv_bfloat16* a, int row0,
                                         const __nv_bfloat16* b) {
  auto one = [&](const __nv_bfloat16* ap, const __nv_bfloat16* bp,
                 bool first) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<N>(acc,
                  wgmma_desc(ap + (kk / 4) * RA * 64 + row0 * 64
                             + (kk % 4) * 16, 16, 1024),
                  wgmma_desc(bp + (kk / 4) * RB * 64 + (kk % 4) * 16, 16,
                             1024),
                  first ? kk : 1);
  };
  if constexpr (NP == 2) {
    one(a, b + RB * D, true);
    one(a + RA * D, b, false);
    one(a, b, false);
  } else {
    one(a, b, true);
  }
}

// acc [64 x D] += X . B: X [64 x N] as bf16 pairs, a k16 slice a row of
// x[plane] (hi, then lo), B D columns of an [N][DS] tile read transposed
// (rows 16 kk .. of every box; the next 64 columns one box, N lines of
// 128 bytes, on; b at the first of them, a plane N DS elements long).
// NP = 2: hi.lo + lo.hi + hi.hi.
template <int D, int N, int NP, int DS = D>
__device__ __forceinline__ void gemm_xb(float (&acc)[D / 2],
                                        const uint32_t (&x)[NP][N / 16][4],
                                        const __nv_bfloat16* b) {
  auto one = [&](const uint32_t (&xp)[N / 16][4], const __nv_bfloat16* bp) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_rs<D>(acc, xp[kk], wgmma_desc(bp + kk * 16 * 64, N * 128, 1024));
  };
  if constexpr (NP == 2) {
    one(x[0], b + N * DS);
    one(x[1], b);
    one(x[0], b);
  } else {
    one(x[0], b);
  }
}

// x (f32, an accumulator's layout: element 8 kk + 2 j + {0, 1} of a lane)
// -> wgmma's A operand, one k16 slice a row: bf16 pairs (NP = 1) or their
// hi and lo pairs (NP = 2)
template <int NP, int N>
__device__ __forceinline__ void to_pairs(const float (&x)[N / 2],
                                         uint32_t (&a)[NP][N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (NP == 2)
        split_bf2(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1], a[0][kk][j],
                  a[1][kk][j]);
      else
        a[0][kk][j] = pack_bf2(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
    }
}

// ---- bf16 rows by cp.async, and outputs at their width --------------------

// element offset of (row r, column c) of a [R][D] bf16 tile as TMA leaves
// it: D / 64 boxes of R lines of 128 bytes, 16-byte chunk j of line r at
// chunk j ^ (r % 8)
template <int R>
__device__ __forceinline__ int tile_at(int r, int c) {
  return (c >> 6) * R * 64 + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3)
         + (c & 7);
}

// bf16 rows x[b][token][head][0, d) (heads d apart, d contiguous) that the
// producer reads in place by cp.async where TMA cannot (d * 2 bytes, the
// head stride, not a multiple of 16)
struct Rows {
  const __nv_bfloat16* x;
  long long sb, st;                     // batch and token strides, elements
};

constexpr int CP_THREADS = 128;         // the producer warpgroup

// Tokens row0 .. row0 + R of head h, batch row b of x into an R x W tile
// laid out as TMA lays its boxes (tile_at), by the producer warpgroup's
// threads (t: this one), a cp.async of G bytes each, neighbouring threads
// on neighbouring columns: columns >= d and tokens >= T are filled with
// zeros, the bits TMA leaves past its maps' extents. A thread keeps its
// column for the whole tile and steps RS rows a copy, so a copy costs its
// row's swizzle and a pointer step; the loop is not unrolled, which keeps
// the producer within its 40 registers.
template <int W, int R, int G>
__device__ __forceinline__ void cp_rows_g(__nv_bfloat16* dst, const Rows& x,
                                          int d, int T, int h, int row0,
                                          int b, int t) {
  constexpr int E = G / 2, PER_ROW = W / E, RS = CP_THREADS / PER_ROW;
  static_assert(RS >= 1 && RS * PER_ROW == CP_THREADS && R % RS == 0,
                "whole passes of the tile");
  const int c = t % PER_ROW * E, chunk = (c >> 3) & 7;
  const uint32_t bytes = c < d ? G : 0;  // a column past d reads nothing
  const uint32_t at = smem_addr(dst) + ((c >> 6) * R * 64 + (c & 7)) * 2;
  const int rows = min(R, T - row0);     // tokens below T
  const long long step = RS * x.st;
  const __nv_bfloat16* src = x.x + b * x.sb + (long long)h * d
                             + (c < d ? c : 0) + (row0 + t / PER_ROW) * x.st;
  int r = t / PER_ROW;
#pragma unroll 1
  for (; r < rows; r += RS, src += step)
    cp_async_zfill<G>(at + r * 128 + ((chunk ^ (r & 7)) << 4), src, bytes);
#pragma unroll 1
  for (; r < R; r += RS)
    cp_async_zfill<G>(at + r * 128 + ((chunk ^ (r & 7)) << 4), x.x, 0);
}

// A cp.async producer warpgroup's wait for a stage (t: this thread): one
// thread waits on the mbarrier, the others at named barrier `id`
__device__ __forceinline__ void producer_wait(uint64_t* bar, uint32_t parity,
                                              int t, int id) {
  if (t == 0) mbar_wait(bar, parity);
  __syncwarp();
  named_sync(id, CP_THREADS);
}

// A consumer's wait for a tile; where the producer copied it by cp.async
// (CPA), its stores (the generic proxy) then made visible to wgmma's reads
// (the async proxy)
template <bool CPA>
__device__ __forceinline__ void wait_tile(uint64_t* bar, uint32_t parity) {
  mbar_wait(bar, parity);
  if constexpr (CPA) fence_proxy_async();
}

// the same by the granule a call takes: 8 bytes (d % 4 == 0, rows 8-byte
// aligned) or 4
template <int W, int R>
__device__ __forceinline__ void cp_rows(__nv_bfloat16* dst, const Rows& x,
                                        int d, int T, int gran, int h,
                                        int row0, int b, int t) {
  if (gran == 8) cp_rows_g<W, R, 8>(dst, x, d, T, h, row0, b, t);
  else cp_rows_g<W, R, 4>(dst, x, d, T, h, row0, b, t);
}

__device__ __forceinline__ void store1(__nv_bfloat16* at, float x) {
  *at = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void store1(float* at, float x) { *at = x; }

__device__ __forceinline__ void store2(__nv_bfloat16* at, float x, float y) {
  *reinterpret_cast<uint32_t*>(at) = pack_bf2(x, y);
}

__device__ __forceinline__ void store2(float* at, float x, float y) {
  *reinterpret_cast<float2*>(at) = make_float2(x, y);
}

// columns col (even) and col + 1 of an output row d columns wide, `at` at
// column col: one pair where d is even (rows d apart keep it aligned),
// else one at a time; nothing at or past d
template <typename OutT>
__device__ __forceinline__ void store_cols(OutT* at, int col, int d, float x,
                                           float y) {
  if (col >= d) return;
  if (!(d & 1)) {
    store2(at, x, y);
    return;
  }
  store1(at, x);
  if (col + 1 < d) store1(at + 1, y);
}

// ---- the split pass --------------------------------------------------------

constexpr int SPLIT_JOBS = 4;           // tensors a launch splits
constexpr int SPLIT_THREADS = 256;

// One float32 tensor x [B, T, H, D] (heads and D contiguous, batch and
// token strides sb, st in elements) to its planes [2B, T, H, W]: batch
// row b's hi at b, its lo at B + b, zeros in columns D .. W.
struct SplitJob {
  const float* x;
  long long sb, st;
  __nv_bfloat16* planes;
  int heads;
  int vec;                              // 16-byte loads: x, D, sb, st allow
};

struct SplitParams {
  SplitJob job[SPLIT_JOBS];
  int B, T, D;
  // the backward's pass, for job di_job (dO): di = rowsum(o . dO) in f32
  // and lse log2(e) into [B, H, Tp], di 0 and lse +inf at rows T .. Tp
  const float* o;                       // o [B, T, H, D], strides osb, ost
  long long osb, ost;
  int ovec;
  const float* lse;                     // [B, H, T]
  float* lse2;
  float* di;
  int Tp, di_job;                       // di_job -1: none
};

inline int split_vec(const void* x, long long sb, long long st, int d) {
  return d % 4 == 0 && sb % 4 == 0 && st % 4 == 0
         && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

inline SplitJob split_job(const void* x, long long sb, long long st,
                          __nv_bfloat16* planes, int heads, int d) {
  return {static_cast<const float*>(x), sb, st, planes, heads,
          split_vec(x, sb, st, d)};
}

// columns c0 .. c0 + 7 of a row of D (zeros at and past D)
__device__ __forceinline__ void load8(float (&x)[8], const float* row, int c0,
                                      int d, int vec) {
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = 0.f;
  if (vec) {                            // D % 4 == 0: whole float4s
    if (c0 < d) {
      const float4 a = *reinterpret_cast<const float4*>(row + c0);
      x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    }
    if (c0 + 4 < d) {
      const float4 a = *reinterpret_cast<const float4*>(row + c0 + 4);
      x[4] = a.x, x[5] = a.y, x[6] = a.z, x[7] = a.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c0 + i < d) x[i] = row[c0 + i];
  }
}

// A thread a (row, 8 columns) of one job (blockIdx.y): the columns split
// into 16-byte stores to each plane. In the backward's dO job rows run on
// to Tp, and each row's W / 8 lanes (in one warp) sum o . dO over their
// columns and shuffle the sum to the row's first lane, which writes di and
// lse log2(e).
template <int W, bool BWD>
__device__ __forceinline__ void split_rows(const SplitParams& p) {
  constexpr int CH = W / 8;             // 8-column chunks a row
  const SplitJob& j = p.job[blockIdx.y];
  const bool with_di = BWD && (int)blockIdx.y == p.di_job;
  const int tokens = with_di ? p.Tp : p.T;
  const long long rows = (long long)p.B * tokens * j.heads;
  if ((long long)blockIdx.x * SPLIT_THREADS >= rows * CH) return;
  const long long i = (long long)blockIdx.x * SPLIT_THREADS + threadIdx.x;
  const long long row = i / CH;
  const int c0 = (int)(i % CH) * 8;
  const bool live = row < rows;
  const int h = (int)(row % j.heads);
  const int t = (int)(row / j.heads % tokens);
  const int b = (int)(row / j.heads / tokens);
  const bool in = live && t < p.T;
  float x[8];
  if (in) {
    load8(x, j.x + b * j.sb + t * j.st + (long long)h * p.D, c0, p.D, j.vec);
    uint4 hi, lo;
    split_bf2(x[0], x[1], hi.x, lo.x);
    split_bf2(x[2], x[3], hi.y, lo.y);
    split_bf2(x[4], x[5], hi.z, lo.z);
    split_bf2(x[6], x[7], hi.w, lo.w);
    __nv_bfloat16* at = j.planes
                        + (((long long)b * p.T + t) * j.heads + h) * W + c0;
    *reinterpret_cast<uint4*>(at) = hi;
    *reinterpret_cast<uint4*>(at + (long long)p.B * p.T * j.heads * W) = lo;
  }
  if constexpr (BWD) {
    if (!with_di) return;
    float acc = 0.f;
    if (in) {
      float y[8];
      load8(y, p.o + b * p.osb + t * p.ost + (long long)h * p.D, c0, p.D,
            p.ovec);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc = fmaf(x[k], y[k], acc);
    }
#pragma unroll
    for (int off = CH / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (live && c0 == 0) {
      const long long bh = (long long)b * j.heads + h;
      p.di[bh * p.Tp + t] = in ? acc : 0.f;
      p.lse2[bh * p.Tp + t] = in ? p.lse[bh * p.T + t] * LOG2E : INFINITY;
    }
  }
}

// K13's pass (q, k, v) and K13-bwd's (q, k, v, dO, with di and lse): two
// names, so that a profile tells their times apart
template <int W>
__global__ void __launch_bounds__(SPLIT_THREADS)
    fwd_split_kernel(const __grid_constant__ SplitParams p) {
  split_rows<W, false>(p);
}

template <int W>
__global__ void __launch_bounds__(SPLIT_THREADS)
    bwd_split_kernel(const __grid_constant__ SplitParams p) {
  split_rows<W, true>(p);
}

// One launch over p's `jobs` jobs (rows: the most a job has, Tp for the
// backward's dO job).
template <int W, bool BWD>
int launch_split(const SplitParams& p, int jobs, long long rows,
                 cudaStream_t stream) {
  const long long blocks = (rows * (W / 8) + SPLIT_THREADS - 1)
                           / SPLIT_THREADS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, jobs);
  if constexpr (BWD) bwd_split_kernel<W><<<grid, SPLIT_THREADS, 0, stream>>>(p);
  else fwd_split_kernel<W><<<grid, SPLIT_THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// The planes' 4-D map, as tensor_map_rows maps rows: [2B, T, H, W]
// contiguous, the lo plane of batch row b at b + B.
inline bool tensor_map_planes(CUtensorMap* map, const __nv_bfloat16* planes,
                              int w, int heads, int T, int B, int rows) {
  return tensor_map_rows(map, planes, w, heads, T, 2 * B,
                         (long long)heads * w, (long long)T * heads * w,
                         rows);
}
