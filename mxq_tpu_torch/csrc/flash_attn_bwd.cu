// K13-bwd: the backward of K13 (flash_attn.cu), causal self-attention from
// position 0. q [B, T, Hq, D] attended k, v [B, >=T, Hkv, D] (query row i
// saw keys j <= i), query head h reading kv head h / G (G = Hq / Hkv),
// scale 1/sqrt(D). Given the output o's row sums di = rowsum(o . dO) and
// K13's row log-sum-exp lse, it writes dQ [B, T, Hq, D] and dK, dV
// [B, S, Hkv, D] (rows < T; the wrapper zeroes rows >= T).
//
// Replaces the upstream Pallas TPU kernels of flash attention's VJP
// (jax/experimental/pallas/ops/tpu/flash_attention.py
// _flash_attention_bwd, :254-318), which mxq_tpu reaches when QAT
// differentiates mxq_tpu/models/llama.py attention's use_flash
// (:383-396): the dK/dV kernel (_flash_attention_bwd_dkv, pallas_call
// :1121, body :796-939) and the dQ kernel (_flash_attention_bwd_dq,
// pallas_call :1456, body :1146-1285). Upstream computes di in jnp
// (:270-273); here the wrapper does, in one PyTorch reduction. Per block
// of query rows and block of keys:
//   s  = (q . k^T) * scale, causal mask    p  = exp(s - lse)
//   dV = p^T . dO     (p in dO's type)     dP = dO . v^T
//   dS = (dP - di) * p * scale
//   dK = dS^T . q,  dQ = dS . k            (dS in the input type)
// every product accumulated in f32, the results written in the input
// type. With GQA the kernel sums dK and dV over the G query heads of a kv
// head; JAX repeats k and v before the call and its autograd sums the
// repeats, in another order.
//
// Bound on the H100: operations. Five products over the causal half (S
// and dP recomputed, dV, dK, dQ), 10 * B * Hq * D * T(T+1)/2: at T = 2048
// and 32 heads of 128 86 GFLOP a layer, 0.0869 ms at 989 TFLOP/s; the
// bytes (q, k, v, o, dO read once, dQ, dK, dV written) are 134 MB at
// bf16, 0.040 ms at 3.35 TB/s.
//
// Design: FlashAttention-2's backward on mma.sync m16n8k16 with K13's
// building blocks (swizzled shared tiles, cp.async, ldmatrix; wgmma, TMA
// and warp specialisation are later work). Two kernels, each output
// element written by one thread and no atomics, so a gradient has the
// same bits on every run:
// - dq_kernel: one block of 4 warps per (64 query rows, query head, batch
//   row), heaviest row blocks first, 16 rows a warp. Q and dO stay in
//   shared memory; K and V come in 64-key tiles up to the diagonal,
//   double-buffered. S = Q K^T and dP = dO V^T are accumulator registers;
//   dS goes from them straight into the A operand of dQ += dS K (the C
//   and A fragment layouts line up), K's B operand from ldmatrix .trans.
// - dkv_kernel: one block of 4 warps per (64 keys, kv head, batch row),
//   heaviest key blocks (the first) first, 16 keys a warp, K and V in
//   shared memory. It walks the G query heads of its kv head and, for
//   each, the 32-row query tiles from the diagonal down (Q, dO, lse and
//   di double-buffered), keeping dK and dV in registers throughout. It
//   computes the transposes S^T = K Q^T and dP^T = V dO^T (keys as rows),
//   so that P^T and dS^T feed dV += P^T dO and dK += dS^T Q from
//   registers. The query tile is 32 rows so that the 2 x D/8 x 4
//   accumulators of dK and dV leave room in 255 registers.
// Only tiles that cross the diagonal are masked. Rows at or past T read as
// zero with lse = +inf, so their p is 0 and they add nothing.
//
// f32 inputs (the float32 model, QAT's main path) take the same kernels
// with SPLIT, as K13: every operand, p and dS included, is split into
// bf16 hi + lo, and a product is hi.lo + lo.hi + hi.hi (three mma.sync).
//
// Shared memory at D = 128: dq_kernel 96 KB (Q, dO, two K and two V tiles
// of 64 x D bf16; SPLIT 192 KB), dkv_kernel 64.5 KB (K, V of 64 rows, two
// Q and two dO tiles of 32 rows, lse and di; SPLIT 128.5 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

#include "device_util.cuh"
#include "flash_tile.cuh"

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BR = 16 * WARPS;          // rows a block owns: query rows
                                        // (dq_kernel) or keys (dkv_kernel)
constexpr int BC = 64;                  // keys per tile of dq_kernel
constexpr int BQ = 32;                  // query rows per tile of dkv_kernel

struct Args {
  const void* q;                        // [B, T, Hq, D], strides below
  const void* k;                        // [B, >=T, Hkv, D]
  const void* v;
  const void* dout;                     // [B, T, Hq, D]
  const float* lse;                     // [B, Hq, T]
  const float* di;                      // [B, Hq, T]
  void* dq;                             // [B, T, Hq, D] contiguous
  void* dk;                             // [B, S, Hkv, D] contiguous
  void* dv;
  long long qsb, qst, ksb, kst, vsb, vst, dsb, dst;   // batch, token
                                                      // strides (elems)
  long long kvsb;                       // dK/dV's batch stride, S*Hkv*D
  int T, Hq, Hkv;
  float scale;
};

// c += a . b over one k-step; b's two registers at bh (and bl). SPLIT:
// hi.lo + lo.hi + hi.hi, the small terms first, as K13.
template <bool SPLIT>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t* bh, const uint32_t* bl) {
  if constexpr (SPLIT) {
    mma_acc(c, ah, bl[0], bl[1]);
    mma_acc(c, al, bh[0], bh[1]);
  }
  mma_acc(c, ah, bh[0], bh[1]);
}

// acc [16 x 8 NT] = A[row0 .. row0 + 16) . B[0 .. 8 NT)^T over D, both
// [rows][D] tiles in shared memory, their lo planes at a + ap, b + bp
template <int D, bool SPLIT, int NT>
__device__ __forceinline__ void product_abt(float (&acc)[NT][4],
                                            const __nv_bfloat16* a, int ap,
                                            int row0,
                                            const __nv_bfloat16* b, int bp,
                                            int lane) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t ah[4], al[4];
    const int ao = sw<D>(row0 + (lane & 15), 2 * kk + (lane >> 4));
    ldmatrix<4>(ah, a + ao);
    if constexpr (SPLIT) ldmatrix<4>(al, a + ap + ao);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      const int bo = sw<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                           2 * kk + ((lane >> 3) & 1));
      uint32_t bh[4], bl[4];
      ldmatrix<4>(bh, b + bo);
      if constexpr (SPLIT) ldmatrix<4>(bl, b + bp + bo);
      mma3<SPLIT>(acc[2 * np], ah, al, bh, bl);
      mma3<SPLIT>(acc[2 * np + 1], ah, al, bh + 2, bl + 2);
    }
  }
}

// acc [16 x D] += X . B: X [16 x 16 KS] given as accumulator tiles (its
// columns the k dimension, rounded to bf16 or split here), B [16 KS rows][D]
// in shared memory (lo plane at b + bp), read through ldmatrix .trans
template <int D, bool SPLIT, int KS>
__device__ __forceinline__ void product_xb(float (&acc)[D / 8][4],
                                           const float (&x)[2 * KS][4],
                                           const __nv_bfloat16* b, int bp,
                                           int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t xh[4], xl[4];
    if constexpr (SPLIT) {
      split_bf2(x[2 * kk][0], x[2 * kk][1], xh[0], xl[0]);
      split_bf2(x[2 * kk][2], x[2 * kk][3], xh[1], xl[1]);
      split_bf2(x[2 * kk + 1][0], x[2 * kk + 1][1], xh[2], xl[2]);
      split_bf2(x[2 * kk + 1][2], x[2 * kk + 1][3], xh[3], xl[3]);
    } else {
      xh[0] = pack_bf2(x[2 * kk][0], x[2 * kk][1]);
      xh[1] = pack_bf2(x[2 * kk][2], x[2 * kk][3]);
      xh[2] = pack_bf2(x[2 * kk + 1][0], x[2 * kk + 1][1]);
      xh[3] = pack_bf2(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    }
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      const int bo = sw<D>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                           2 * dp + (lane >> 4));
      uint32_t bh[4], bl[4];
      ldmatrix_t(bh, b + bo);
      if constexpr (SPLIT) ldmatrix_t(bl, b + bp + bo);
      mma3<SPLIT>(acc[2 * dp], xh, xl, bh, bl);
      mma3<SPLIT>(acc[2 * dp + 1], xh, xl, bh + 2, bl + 2);
    }
  }
}

// rows r0 (accumulator registers 0, 1) and r0 + 8 (2, 3) of acc, those
// below nrows, to dst + r * rstride in T
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* dst, long long rstride, int r0,
                                           int nrows,
                                           const float (&acc)[D / 8][4],
                                           int lane) {
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= nrows) continue;
    T* row = dst + r * rstride + col;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const float x = acc[i][2 * half], y = acc[i][2 * half + 1];
      if constexpr (std::is_same<T, float>::value)
        *reinterpret_cast<float2*>(row + i * 8) = make_float2(x, y);
      else
        *reinterpret_cast<uint32_t*>(row + i * 8) = pack_bf2(x, y);
    }
  }
}

template <int D, bool SPLIT>
__global__ void __launch_bounds__(THREADS) dq_kernel(const Args a) {
  using T = typename std::conditional<SPLIT, float, __nv_bfloat16>::type;
  constexpr int TILE = BR * D;          // one plane of a 64-row tile
  constexpr int NP = SPLIT ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdo = sq + NP * TILE;
  __nv_bfloat16* sk = sdo + NP * TILE;  // [2 buffers][NP][64][D]
  __nv_bfloat16* sv = sk + 2 * NP * TILE;

  const int qt = gridDim.x - 1 - blockIdx.x;     // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = qt * BR;
  const int nkt = (min(q0 + BR, a.T) + BC - 1) / BC;   // key tiles read
  const T* kg = static_cast<const T*>(a.k) + b * a.ksb + hk * D;
  const T* vg = static_cast<const T*>(a.v) + b * a.vsb + hk * D;

  load_tile<D, SPLIT, BR, THREADS>(
      sq, sq + TILE, static_cast<const T*>(a.q) + b * a.qsb + q0 * a.qst
      + h * D, a.qst, a.T - q0, tid);
  load_tile<D, SPLIT, BR, THREADS>(
      sdo, sdo + TILE, static_cast<const T*>(a.dout) + b * a.dsb
      + q0 * a.dst + h * D, a.dst, a.T - q0, tid);
  load_tile<D, SPLIT, BC, THREADS>(sk, sk + TILE, kg, a.kst, a.T, tid);
  load_tile<D, SPLIT, BC, THREADS>(sv, sv + TILE, vg, a.vst, a.T, tid);
  cp_commit();

  // this lane's rows: r0 (accumulator registers 0, 1) and r0 + 8 (2, 3)
  const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const long long rows = ((long long)b * a.Hq + h) * a.T;
  const float lse0 = r0 < a.T ? a.lse[rows + r0] : INFINITY;
  const float lse1 = r1 < a.T ? a.lse[rows + r1] : INFINITY;
  const float di0 = r0 < a.T ? a.di[rows + r0] : 0.f;
  const float di1 = r1 < a.T ? a.di[rows + r1] : 0.f;
  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nkt) {                 // the next tile into the other buffer
      const int nb = buf ^ 1;
      const long long k1 = (long long)(kt + 1) * BC;
      load_tile<D, SPLIT, BC, THREADS>(
          sk + nb * NP * TILE, sk + nb * NP * TILE + TILE, kg + k1 * a.kst,
          a.kst, a.T - (int)k1, tid);
      load_tile<D, SPLIT, BC, THREADS>(
          sv + nb * NP * TILE, sv + nb * NP * TILE + TILE, vg + k1 * a.vst,
          a.vst, a.T - (int)k1, tid);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kb = sk + buf * NP * TILE;
    const __nv_bfloat16* vb = sv + buf * NP * TILE;

    float s[BC / 8][4], dp[BC / 8][4];
    product_abt<D, SPLIT, BC / 8>(s, sq, TILE, warp * 16, kb, TILE, lane);
    product_abt<D, SPLIT, BC / 8>(dp, sdo, TILE, warp * 16, vb, TILE, lane);
    // p = exp(s * scale - lse), masked on the diagonal tile (the last);
    // dS = (dP - di) * p * scale, in dp's registers
    const bool edge = kt == nkt - 1;
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * a.scale;
        if (edge) {
          const int key = kt * BC + nt * 8 + 2 * (lane & 3) + (e & 1);
          if (key > (e < 2 ? r0 : r1)) x = -INFINITY;
        }
        const float p = expf(x - (e < 2 ? lse0 : lse1));
        dp[nt][e] = (dp[nt][e] - (e < 2 ? di0 : di1)) * p * a.scale;
      }
    }
    product_xb<D, SPLIT, BC / 16>(dq, dp, kb, TILE, lane);
    __syncthreads();                    // this buffer is refilled next
  }

  store_rows<D, T>(static_cast<T*>(a.dq) + ((long long)b * a.T * a.Hq + h)
                   * D, (long long)a.Hq * D, r0, a.T, dq, lane);
}

// Q, dO, lse and di of iteration it of a dkv block (query head g of the
// kv head, query tile qs + it % nq) into buffer buf
template <int D, bool SPLIT>
__device__ __forceinline__ void stage_queries(
    const Args& a, int b, int hk, int qs, int nq, int it,
    __nv_bfloat16* sq, __nv_bfloat16* sdo, float* slse, float* sdi,
    int tid) {
  using T = typename std::conditional<SPLIT, float, __nv_bfloat16>::type;
  const int g = it / nq, q0 = (qs + it % nq) * BQ;
  const int h = hk * (a.Hq / a.Hkv) + g;
  load_tile<D, SPLIT, BQ, THREADS>(
      sq, sq + BQ * D, static_cast<const T*>(a.q) + b * a.qsb + q0 * a.qst
      + h * D, a.qst, a.T - q0, tid);
  load_tile<D, SPLIT, BQ, THREADS>(
      sdo, sdo + BQ * D, static_cast<const T*>(a.dout) + b * a.dsb
      + q0 * a.dst + h * D, a.dst, a.T - q0, tid);
  if (tid < BQ) {
    const int r = q0 + tid;
    const long long rows = ((long long)b * a.Hq + h) * a.T;
    slse[tid] = r < a.T ? a.lse[rows + r] : INFINITY;
    sdi[tid] = r < a.T ? a.di[rows + r] : 0.f;
  }
}

template <int D, bool SPLIT>
__global__ void __launch_bounds__(THREADS) dkv_kernel(const Args a) {
  using T = typename std::conditional<SPLIT, float, __nv_bfloat16>::type;
  constexpr int KT = BR * D;            // one plane of a 64-key tile
  constexpr int QT = BQ * D;            // one plane of a 32-row query tile
  constexpr int NP = SPLIT ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sv = sk + NP * KT;
  __nv_bfloat16* sq = sv + NP * KT;     // [2 buffers][NP][32][D]
  __nv_bfloat16* sdo = sq + 2 * NP * QT;
  float* slse = reinterpret_cast<float*>(sdo + 2 * NP * QT);   // [2][32]
  float* sdi = slse + 2 * BQ;

  const int kt = blockIdx.x;            // key tile 0 is seen by every row
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = kt * BR;
  const int qs = k0 / BQ;               // the first query tile to see k0
  const int nq = (a.T + BQ - 1) / BQ - qs;
  const int iters = (a.Hq / a.Hkv) * nq;

  load_tile<D, SPLIT, BR, THREADS>(
      sk, sk + KT, static_cast<const T*>(a.k) + b * a.ksb + k0 * a.kst
      + hk * D, a.kst, a.T - k0, tid);
  load_tile<D, SPLIT, BR, THREADS>(
      sv, sv + KT, static_cast<const T*>(a.v) + b * a.vsb + k0 * a.vst
      + hk * D, a.vst, a.T - k0, tid);
  stage_queries<D, SPLIT>(a, b, hk, qs, nq, 0, sq, sdo, slse, sdi, tid);
  cp_commit();

  // this lane's keys: c0 (accumulator registers 0, 1) and c0 + 8 (2, 3)
  const int c0 = k0 + warp * 16 + (lane >> 2);
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  for (int it = 0; it < iters; ++it) {
    const int buf = it & 1;
    if (it + 1 < iters) {               // the next tile into the other buffer
      const int nb = buf ^ 1;
      stage_queries<D, SPLIT>(a, b, hk, qs, nq, it + 1, sq + nb * NP * QT,
                              sdo + nb * NP * QT, slse + nb * BQ,
                              sdi + nb * BQ, tid);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int q0 = (qs + it % nq) * BQ;
    const __nv_bfloat16* qb = sq + buf * NP * QT;
    const __nv_bfloat16* dob = sdo + buf * NP * QT;
    const float* lb = slse + buf * BQ;
    const float* db = sdi + buf * BQ;

    // P^T = exp(S^T * scale - lse), keys as rows, masked where a key
    // follows a query row (only tiles that cross the diagonal)
    float s[BQ / 8][4], dp[BQ / 8][4];
    product_abt<D, SPLIT, BQ / 8>(s, sk, KT, warp * 16, qb, QT, lane);
    const bool edge = q0 < k0 + BR;
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + 2 * (lane & 3) + (e & 1);
        float x = s[nt][e] * a.scale;
        if (edge && c0 + 8 * (e >> 1) > q0 + qi) x = -INFINITY;
        s[nt][e] = expf(x - lb[qi]);
      }
    }
    product_xb<D, SPLIT, BQ / 16>(dv, s, dob, QT, lane);     // dV += P^T dO
    // dS^T = (dP^T - di) * P^T * scale, in dp's registers
    product_abt<D, SPLIT, BQ / 8>(dp, sv, KT, warp * 16, dob, QT, lane);
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + 2 * (lane & 3) + (e & 1);
        dp[nt][e] = (dp[nt][e] - db[qi]) * s[nt][e] * a.scale;
      }
    }
    product_xb<D, SPLIT, BQ / 16>(dk, dp, qb, QT, lane);     // dK += dS^T Q
    __syncthreads();                    // this buffer is refilled next
  }

  const long long kst = (long long)a.Hkv * D;
  const long long base = b * a.kvsb + hk * D;
  store_rows<D, T>(static_cast<T*>(a.dk) + base, kst, c0, a.T, dk, lane);
  store_rows<D, T>(static_cast<T*>(a.dv) + base, kst, c0, a.T, dv, lane);
}

template <int D, bool SPLIT>
int launch(const Args& a, int B, void* stream) {
  constexpr int NP = SPLIT ? 2 : 1;
  const size_t dq_smem = (size_t)6 * NP * BR * D * 2;
  const size_t dkv_smem =
      (size_t)NP * (2 * BR + 4 * BQ) * D * 2 + 4 * BQ * sizeof(float);
  auto kq = dq_kernel<D, SPLIT>;
  auto kkv = dkv_kernel<D, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.T + BR - 1) / BR;
  kq<<<dim3(blocks, a.Hq, B), THREADS, dq_smem, (cudaStream_t)stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<dim3(blocks, a.Hkv, B), THREADS, dkv_smem, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, T, Hq, D], k/v [B, >=T, Hkv, D] and dout [B, T, Hq, D] with
// element strides (batch, token) given and heads and D contiguous,
// 16-byte aligned rows; lse (K13's, flash_attn with its lse) and di =
// rowsum(o . dout) f32 [B, Hq, T]; dq [B, T, Hq, D] contiguous; dk, dv
// [B, S, Hkv, D] contiguous with batch stride kvsb = S * Hkv * D (rows < T
// written). f32 = 0: bf16 tensors; f32 = 1: float32 tensors (the split
// products). Launches the dQ kernel, then the dK/dV kernel. Returns a
// cudaError_t.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* di, void* dq, void* dk, void* dv,
                              long long qsb, long long qst, long long ksb,
                              long long kst, long long vsb, long long vst,
                              long long dsb, long long dst, long long kvsb,
                              int B, int T, int Hq, int Hkv, int D, int f32,
                              float scale, void* stream) {
  if (B < 0 || T < 0 || Hkv < 1 || Hq < Hkv || Hq % Hkv || B > 65535
      || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const Args a{q, k, v, dout, lse, di, dq, dk, dv, qsb, qst,
               ksb, kst, vsb, vst, dsb, dst, kvsb, T, Hq, Hkv, scale};
  switch (D * 2 + (f32 ? 1 : 0)) {
    case 128: return launch<64, false>(a, B, stream);
    case 129: return launch<64, true>(a, B, stream);
    case 256: return launch<128, false>(a, B, stream);
    case 257: return launch<128, true>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
