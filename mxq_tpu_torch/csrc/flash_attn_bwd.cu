// K13-bwd: the backward of K13 (flash_attn.cu), causal self-attention from
// position 0. q [B, T, Hq, D] attended k, v [B, >=T, Hkv, D] (query row i
// saw keys j <= i), query head h reading kv head h / G (G = Hq / Hkv),
// scale 1/sqrt(D). Given K13's output o and row log-sum-exp lse and the
// output's gradient dO, it writes dQ [B, T, Hq, D] and dK, dV
// [B, S, Hkv, D] (rows < T; the wrapper zeroes rows >= T).
//
// Replaces the upstream Pallas TPU kernels of flash attention's VJP
// (jax/experimental/pallas/ops/tpu/flash_attention.py
// _flash_attention_bwd, :254-318), which mxq_tpu reaches when QAT
// differentiates mxq_tpu/models/llama.py attention's use_flash
// (:383-396): the dK/dV kernel (_flash_attention_bwd_dkv, pallas_call
// :1121, body :796-939) and the dQ kernel (_flash_attention_bwd_dq,
// pallas_call :1456, body :1146-1285). Upstream computes di = rowsum(o .
// dO) in jnp (:270-273). Per block of query rows and block of keys:
//   s  = (q . k^T) * scale, causal mask    p  = exp(s - lse)
//   dV = p^T . dO     (p in dO's type)     dP = dO . v^T
//   dS = (dP - di) * p * scale
//   dK = dS^T . q,  dQ = dS . k            (dS in the input type)
// every product accumulated in f32, the results written in the input
// type. With GQA the kernels sum dK and dV over the G query heads of a kv
// head; JAX repeats k and v before the call and its autograd sums the
// repeats, in another order.
//
// Bound on the H100: operations. Five products over the causal half (S
// and dP recomputed, dV, dK, dQ), 10 * B * Hq * D * T(T+1)/2: at T = 2048
// and 32 heads of 128 86 GFLOP a layer, 0.0869 ms at 989 TFLOP/s; the
// bytes (q, k, v, o, dO read once, dQ, dK, dV written) are 134 MB at
// bf16, 0.040 ms at 3.35 TB/s. Both designs below recompute S and dP in
// each of their two kernels: 7 products, 14 * B * Hq * D * T(T+1)/2, so
// their own floor is 0.122 ms there.
//
// bf16 (dq_wgmma_kernel, dkv_wgmma_kernel: FlashAttention-3's backward,
// kept deterministic). Only wgmma reaches the tensor cores' rate, and only
// with operands in shared memory that the multiplying threads spend no
// instructions copying. Each kernel is one persistent block of three
// warpgroups an SM walking work items longest first, in a snake (as
// K13's flash_wgmma_kernel): warpgroup 0 the producer (setmaxnreg gives
// its registers away; one thread starts every copy, by TMA through 4-D
// tensor maps over (D, heads, tokens, batch) on the strides the wrapper
// passes, tokens >= T filled with zeros), warpgroups 1 and 2 consumers of
// 64 rows each. Tiles lie in shared memory as TMA's 128-byte swizzle
// leaves them, the layout wgmma's descriptors name; a ring of stages with
// full and empty mbarriers runs ahead of the products.
// - dQ kernel: an item is 128 query rows of one (query head, batch row).
//   Q, dO and o come once an item. di = rowsum(o . dO) is computed in f32
//   from the o and dO tiles in shared memory (no PyTorch reduction), and
//   the kernel writes di and lse log2(e) into [B, Hq, Tp] f32 scratch
//   (Tp = T rounded up to 128; rows >= T get di 0 and lse +inf, so that
//   their p is 0) for the dK/dV kernel. K and V come in 64-key tiles up
//   to the diagonal. Per tile: S = Q K^T and dP = dO V^T, wgmma with both
//   operands in shared memory (m64n64k16); P = 2^(S scale log2(e) - lse
//   log2(e)), masked only on the diagonal tile; dS = (dP - di) P scale
//   rounded to bf16 pairs, which are wgmma's register-A operand of dQ +=
//   dS K (K read through the descriptor's transpose). dQ's product runs
//   under the next tile's S and dP; a warpgroup skips the tiles past its
//   rows (the second 64 keys of the diagonal block for the first 64
//   rows). 64-key tiles keep S, dP, dQ and dS in 160 registers of the
//   232 a consumer thread has; 128-key tiles would need 224 and spill.
// - dK/dV kernel: an item is 128 keys of one kv head (64 a consumer
//   warpgroup), K and V loaded once. Q, dO, lse and di come in 64-row
//   query tiles from the diagonal on, for each query head of the item's
//   heads. Per tile, keys as rows: S^T = K Q^T and dP^T = V dO^T (SS),
//   P^T and dS^T in registers, one pass that rounds each pair to bf16 as
//   it goes, then dV += P^T dO and dK += dS^T Q (RS, dO and Q read
//   transposed). dK and dV stay in registers for the whole item, 128
//   floats a thread at D = 128.
// - GQA: when (key tiles x kv heads x batch) items are fewer than the
//   SMs (G = 8, T = 512: 32 items), each kv head's G query heads are
//   split over S blocks (the largest divisor of G that keeps the items
//   in one wave: S = 4 there). Each block writes f32 partial dK and dV;
//   the last of the S blocks of a (key tile, kv head, batch row), found
//   by a ticket, sums the partials in split order and writes dK and dV.
// No atomics on a gradient and a fixed order of every sum: the same bits
// on every call.
// Shared memory at D = 128: dQ kernel 192 KB (Q, dO, o of 128 rows; three
// stages of K and V tiles of 64 keys), dK/dV kernel 194 KB (K, V of 128
// keys; four stages of Q and dO tiles of 64 rows, lse and di).
//
// float32 inputs (the float32 model, QAT's default; dq_kernel,
// dkv_kernel) stay on the first design, FlashAttention-2's backward on
// mma.sync m16n8k16 with K13's float32 building blocks: TMA copies bytes
// and cannot split an f32 tile into the bf16 hi and lo planes the split
// products take (hi.lo + lo.hi + hi.hi, three mma.sync, every operand, p
// and dS included, split). di there is one PyTorch reduction (the
// wrapper's). Two kernels, each output element written by one thread:
// - dq_kernel: one block of 4 warps per (64 query rows, query head, batch
//   row), heaviest row blocks first, 16 rows a warp. Q and dO stay in
//   shared memory; K and V come in 64-key tiles up to the diagonal,
//   double-buffered, split into hi and lo as they are stored. S and dP
//   are accumulator registers; dS goes from them straight into the A
//   operand of dQ += dS K, K's B operand from ldmatrix .trans.
// - dkv_kernel: one block of 4 warps per (64 keys, kv head, batch row),
//   16 keys a warp, K and V in shared memory. It walks the G query heads
//   of its kv head and, for each, the 32-row query tiles from the
//   diagonal down (Q, dO, lse and di double-buffered), keeping dK and dV
//   in registers, computing the transposes S^T = K Q^T and dP^T = V dO^T
//   so that P^T and dS^T feed dV += P^T dO and dK += dS^T Q from
//   registers.
// Only tiles that cross the diagonal are masked. Rows at or past T read as
// zero with lse = +inf, so their p is 0 and they add nothing. Shared
// memory at D = 128: dq_kernel 192 KB, dkv_kernel 128.5 KB.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "device_util.cuh"
#include "flash_tile.cuh"
#include "hopper_util.cuh"

// ---------------------------------------------------------------------------
// float32: bf16 hi + lo split products on mma.sync
// ---------------------------------------------------------------------------

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BR = 16 * WARPS;          // rows a block owns: query rows
                                        // (dq_kernel) or keys (dkv_kernel)
constexpr int BC = 64;                  // keys per tile of dq_kernel
constexpr int BQ = 32;                  // query rows per tile of dkv_kernel
// FENCES: the tiles are loaded through registers, so no copy is in
// flight; the cp.async commits and waits stay as the scheduling fences
// these kernels' register budgets were set with (without them ptxas
// moves the next tile's loads into the products and dq_kernel<64>
// spills).

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

// c += a . b over one k-step, b's two registers at bh and bl: hi.lo +
// lo.hi + hi.hi, the small terms first, as K13.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t* bh, const uint32_t* bl) {
  mma_acc(c, ah, bl[0], bl[1]);
  mma_acc(c, al, bh[0], bh[1]);
  mma_acc(c, ah, bh[0], bh[1]);
}

// acc [16 x 8 NT] = A[row0 .. row0 + 16) . B[0 .. 8 NT)^T over D, both
// [rows][D] tiles in shared memory, their lo planes at a + ap, b + bp
template <int D, int NT>
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
    ldmatrix<4>(al, a + ap + ao);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      const int bo = sw<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                           2 * kk + ((lane >> 3) & 1));
      uint32_t bh[4], bl[4];
      ldmatrix<4>(bh, b + bo);
      ldmatrix<4>(bl, b + bp + bo);
      mma3(acc[2 * np], ah, al, bh, bl);
      mma3(acc[2 * np + 1], ah, al, bh + 2, bl + 2);
    }
  }
}

// acc [16 x D] += X . B: X [16 x 16 KS] given as accumulator tiles (its
// columns the k dimension, split here), B [16 KS rows][D] in shared
// memory (lo plane at b + bp), read through ldmatrix .trans
template <int D, int KS>
__device__ __forceinline__ void product_xb(float (&acc)[D / 8][4],
                                           const float (&x)[2 * KS][4],
                                           const __nv_bfloat16* b, int bp,
                                           int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t xh[4], xl[4];
    split_bf2(x[2 * kk][0], x[2 * kk][1], xh[0], xl[0]);
    split_bf2(x[2 * kk][2], x[2 * kk][3], xh[1], xl[1]);
    split_bf2(x[2 * kk + 1][0], x[2 * kk + 1][1], xh[2], xl[2]);
    split_bf2(x[2 * kk + 1][2], x[2 * kk + 1][3], xh[3], xl[3]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      const int bo = sw<D>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                           2 * dp + (lane >> 4));
      uint32_t bh[4], bl[4];
      ldmatrix_t(bh, b + bo);
      ldmatrix_t(bl, b + bp + bo);
      mma3(acc[2 * dp], xh, xl, bh, bl);
      mma3(acc[2 * dp + 1], xh, xl, bh + 2, bl + 2);
    }
  }
}

// rows r0 (accumulator registers 0, 1) and r0 + 8 (2, 3) of acc, those
// below nrows, to dst + r * rstride
template <int D>
__device__ __forceinline__ void store_rows(float* dst, long long rstride,
                                           int r0,
                                           int nrows,
                                           const float (&acc)[D / 8][4],
                                           int lane) {
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= nrows) continue;
    float* row = dst + r * rstride + col;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(row + i * 8) =
          make_float2(acc[i][2 * half], acc[i][2 * half + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) dq_kernel(const Args a) {
  constexpr int TILE = BR * D;          // one plane of a 64-row tile
  constexpr int NP = 2;                 // hi and lo planes
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
  const float* kg = static_cast<const float*>(a.k) + b * a.ksb + hk * D;
  const float* vg = static_cast<const float*>(a.v) + b * a.vsb + hk * D;

  load_tile<D, BR, THREADS>(
      sq, sq + TILE, static_cast<const float*>(a.q) + b * a.qsb + q0 * a.qst
      + h * D, a.qst, a.T - q0, tid);
  load_tile<D, BR, THREADS>(
      sdo, sdo + TILE, static_cast<const float*>(a.dout) + b * a.dsb
      + q0 * a.dst + h * D, a.dst, a.T - q0, tid);
  load_tile<D, BC, THREADS>(sk, sk + TILE, kg, a.kst, a.T, tid);
  load_tile<D, BC, THREADS>(sv, sv + TILE, vg, a.vst, a.T, tid);
  cp_commit();                          // see FENCES

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
      load_tile<D, BC, THREADS>(
          sk + nb * NP * TILE, sk + nb * NP * TILE + TILE, kg + k1 * a.kst,
          a.kst, a.T - (int)k1, tid);
      load_tile<D, BC, THREADS>(
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
    product_abt<D, BC / 8>(s, sq, TILE, warp * 16, kb, TILE, lane);
    product_abt<D, BC / 8>(dp, sdo, TILE, warp * 16, vb, TILE, lane);
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
    product_xb<D, BC / 16>(dq, dp, kb, TILE, lane);
    __syncthreads();                    // this buffer is refilled next
  }

  store_rows<D>(static_cast<float*>(a.dq) + ((long long)b * a.T * a.Hq + h)
                   * D, (long long)a.Hq * D, r0, a.T, dq, lane);
}

// Q, dO, lse and di of iteration it of a dkv block (query head g of the
// kv head, query tile qs + it % nq) into buffer buf
template <int D>
__device__ __forceinline__ void stage_queries(
    const Args& a, int b, int hk, int qs, int nq, int it,
    __nv_bfloat16* sq, __nv_bfloat16* sdo, float* slse, float* sdi,
    int tid) {
  const int g = it / nq, q0 = (qs + it % nq) * BQ;
  const int h = hk * (a.Hq / a.Hkv) + g;
  load_tile<D, BQ, THREADS>(
      sq, sq + BQ * D, static_cast<const float*>(a.q) + b * a.qsb + q0 * a.qst
      + h * D, a.qst, a.T - q0, tid);
  load_tile<D, BQ, THREADS>(
      sdo, sdo + BQ * D, static_cast<const float*>(a.dout) + b * a.dsb
      + q0 * a.dst + h * D, a.dst, a.T - q0, tid);
  if (tid < BQ) {
    const int r = q0 + tid;
    const long long rows = ((long long)b * a.Hq + h) * a.T;
    slse[tid] = r < a.T ? a.lse[rows + r] : INFINITY;
    sdi[tid] = r < a.T ? a.di[rows + r] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) dkv_kernel(const Args a) {
  constexpr int KT = BR * D;            // one plane of a 64-key tile
  constexpr int QT = BQ * D;            // one plane of a 32-row query tile
  constexpr int NP = 2;                 // hi and lo planes
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

  load_tile<D, BR, THREADS>(
      sk, sk + KT, static_cast<const float*>(a.k) + b * a.ksb + k0 * a.kst
      + hk * D, a.kst, a.T - k0, tid);
  load_tile<D, BR, THREADS>(
      sv, sv + KT, static_cast<const float*>(a.v) + b * a.vsb + k0 * a.vst
      + hk * D, a.vst, a.T - k0, tid);
  stage_queries<D>(a, b, hk, qs, nq, 0, sq, sdo, slse, sdi, tid);
  cp_commit();                          // see FENCES

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
      stage_queries<D>(a, b, hk, qs, nq, it + 1, sq + nb * NP * QT,
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
    product_abt<D, BQ / 8>(s, sk, KT, warp * 16, qb, QT, lane);
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
    product_xb<D, BQ / 16>(dv, s, dob, QT, lane);     // dV += P^T dO
    // dS^T = (dP^T - di) * P^T * scale, in dp's registers
    product_abt<D, BQ / 8>(dp, sv, KT, warp * 16, dob, QT, lane);
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + 2 * (lane & 3) + (e & 1);
        dp[nt][e] = (dp[nt][e] - db[qi]) * s[nt][e] * a.scale;
      }
    }
    product_xb<D, BQ / 16>(dk, dp, qb, QT, lane);     // dK += dS^T Q
    __syncthreads();                    // this buffer is refilled next
  }

  const long long kst = (long long)a.Hkv * D;
  const long long base = b * a.kvsb + hk * D;
  store_rows<D>(static_cast<float*>(a.dk) + base, kst, c0, a.T, dk, lane);
  store_rows<D>(static_cast<float*>(a.dv) + base, kst, c0, a.T, dv, lane);
}

template <int D>
int launch_split(const Args& a, int B, void* stream) {
  constexpr int NP = 2;
  const size_t dq_smem = (size_t)6 * NP * BR * D * 2;
  const size_t dkv_smem =
      (size_t)NP * (2 * BR + 4 * BQ) * D * 2 + 4 * BQ * sizeof(float);
  auto kq = dq_kernel<D>;
  auto kkv = dkv_kernel<D>;
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

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA, warp specialisation
// ---------------------------------------------------------------------------

constexpr int WG = 128;                 // threads of a warpgroup
constexpr int WS_THREADS = 3 * WG;      // producer + two consumers
// the producer's loops over items, heads and tiles spill at 24 registers
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int CONSUMER_WARPS = 8;       // arrivals that empty a stage
constexpr int BAR_CONSUMERS = 1;        // named barrier of the consumers
constexpr int IM = 128;                 // rows of an item: query rows (dQ
                                        // kernel) or keys (dK/dV kernel)
constexpr int TN = 64;                  // rows of a ring tile: keys (dQ
                                        // kernel) or query rows (dK/dV)
constexpr int DQ_STAGES = 3, DKV_STAGES = 4;
constexpr float LOG2E = 1.4426950408889634f;

struct DqParams {
  CUtensorMap q, dout, o;               // 4-D (D, heads, T, B), IM-row boxes
  CUtensorMap k, v;                     // TN-row boxes
  const float* lse;                     // [B, Hq, T]
  float* lse2;                          // [B, Hq, Tp]: lse log2(e); +inf
  float* di;                            // and 0 at rows >= T
  __nv_bfloat16* dq;                    // [B, T, Hq, D] contiguous
  int nq, B, T, Tp, Hq, Hkv;            // nq = Tp / IM = ceil(T / IM)
  float scale, scale_log2;
};

struct DkvParams {
  CUtensorMap k, v;                     // IM-row boxes
  CUtensorMap q, dout;                  // TN-row boxes
  const float* lse2;                    // the dQ kernel's [B, Hq, Tp]
  const float* di;
  float* part;                          // [2][S][B][Hkv][Tp][D] when S > 1
  int* tickets;                         // [nq][Hkv][B] when S > 1
  __nv_bfloat16* dk;                    // [B, S rows, Hkv, D]
  __nv_bfloat16* dv;
  long long kvsb;                       // their batch stride
  int nq, B, T, Tp, Hq, Hkv, splits;
  float scale, scale_log2;
};

template <int D>
struct DqSmem {                         // every tile 1024-byte aligned
  __nv_bfloat16 q[IM * D], dout[IM * D], o[IM * D];   // D / 64 boxes each
  __nv_bfloat16 k[DQ_STAGES][TN * D], v[DQ_STAGES][TN * D];
  uint64_t q_full, q_empty, kv_full[DQ_STAGES], kv_empty[DQ_STAGES];
};

template <int D>
struct DkvSmem {
  __nv_bfloat16 k[IM * D], v[IM * D];
  __nv_bfloat16 q[DKV_STAGES][TN * D], dout[DKV_STAGES][TN * D];
  float lse2[DKV_STAGES][TN], di[DKV_STAGES][TN];
  uint64_t kv_full, kv_empty, full[DKV_STAGES], empty[DKV_STAGES];
  int last;                             // this block sums the partials
};

// Work item j of this block: items j G + i and j G + G - 1 - i in turn (G
// blocks, i its index), a snake over items ordered longest first
__device__ __forceinline__ int item_index(int j) {
  const int g = gridDim.x, i = blockIdx.x;
  return j * g + ((j & 1) ? g - 1 - i : i);
}

// element offset of (row r, column c) of a [R][D] bf16 tile as TMA leaves
// it: D / 64 boxes of R lines of 128 bytes, 16-byte chunk j of line r at
// chunk j ^ (r % 8)
template <int R>
__device__ __forceinline__ int tile_at(int r, int c) {
  return (c >> 6) * R * 64 + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3)
         + (c & 7);
}

// acc [64 x 64] = A[row0 .. row0 + 64) . B^T over D: A a [RA][D] tile, B
// a [TN][D] tile, both K-major (k16 slice kk: box kk / 4, 32 kk % 4 bytes
// into the line)
template <int D, int RA>
__device__ __forceinline__ void gemm_abt(float (&acc)[32],
                                         const __nv_bfloat16* a, int row0,
                                         const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(acc,
                 wgmma_desc(a + (kk / 4) * RA * 64 + row0 * 64
                            + (kk % 4) * 16, 16, 1024),
                 wgmma_desc(b + (kk / 4) * TN * 64 + (kk % 4) * 16, 16,
                            1024),
                 kk);
}

// acc [64 x D] += X . B: X [64 x TN] as bf16 pairs (a k16 slice a row), B
// a [TN][D] tile read transposed (rows 16 kk.. of every box; the next 64
// columns one box, TN lines of 128 bytes, on)
template <int D>
__device__ __forceinline__ void gemm_xb(float (&acc)[D / 2],
                                        const uint32_t (&x)[TN / 16][4],
                                        const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < TN / 16; ++kk) {
    const uint64_t db = wgmma_desc(b + kk * 16 * 64, TN * 128, 1024);
    if constexpr (D == 128) wgmma_rs_n128(acc, x[kk], db);
    else wgmma_rs_n64(acc, x[kk], db);
  }
}

// this lane's element i of a 64 x 64 accumulator: row 16 warp + lane / 4
// + 8 ((i >> 1) & 1), column acc_col(i, lane)
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// the lane's two rows of a [64 x D] accumulator, rows < nrows, to dst +
// row * rstride as bf16 pairs
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* dst,
                                          long long rstride, int row0,
                                          int nrows, const float (&acc)[D / 2],
                                          int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= nrows) continue;
    __nv_bfloat16* out = dst + row * rstride + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(out + 8 * i) =
          pack_bf2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
  }
}

// key tiles of a dQ item (query rows qt IM ..): keys < min((qt + 1) IM, T)
__device__ __forceinline__ int dq_key_tiles(int qt, int T) {
  return (min((qt + 1) * IM, T) + TN - 1) / TN;
}

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    dq_wgmma_kernel(const __grid_constant__ DqParams p) {
  constexpr int BOXES = D / 64;
  constexpr uint32_t ROWS_BYTES = IM * D * 2, TILE_BYTES = TN * D * 2;
  extern __shared__ __align__(1024) unsigned char dq_smem[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(
      (reinterpret_cast<uintptr_t>(dq_smem) + 1023) & ~uintptr_t(1023));
  const int heads = p.B * p.Hq;
  const int items = p.nq * heads;
  const int wg = threadIdx.x / WG;
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    mbar_init(&sm.q_empty, CONSUMER_WARPS);
#pragma unroll
    for (int st = 0; st < DQ_STAGES; ++st) {
      mbar_init(&sm.kv_full[st], 1);
      mbar_init(&sm.kv_empty[st], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {                        // producer: one thread starts TMA
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int it = 0;                       // tiles loaded: the ring's position
      for (int j = 0, w; (w = item_index(j)) < items; ++j) {
        const int qt = p.nq - 1 - w / heads, h = w % p.Hq;
        const int b = w % heads / p.Hq, hk = h / (p.Hq / p.Hkv);
        mbar_wait(&sm.q_empty, (j & 1) ^ 1);   // the last item done
        mbar_expect(&sm.q_full, 3 * ROWS_BYTES);
#pragma unroll
        for (int c = 0; c < BOXES; ++c) {
          tma_load_4d(sm.q + c * IM * 64, &p.q, &sm.q_full, c * 64, h,
                      qt * IM, b);
          tma_load_4d(sm.dout + c * IM * 64, &p.dout, &sm.q_full, c * 64, h,
                      qt * IM, b);
          tma_load_4d(sm.o + c * IM * 64, &p.o, &sm.q_full, c * 64, h,
                      qt * IM, b);
        }
        const int nkt = dq_key_tiles(qt, p.T);
        for (int kt = 0; kt < nkt; ++kt, ++it) {
          const int st = it % DQ_STAGES;
          mbar_wait(&sm.kv_empty[st], ((it / DQ_STAGES) & 1) ^ 1);
          mbar_expect(&sm.kv_full[st], 2 * TILE_BYTES);
#pragma unroll
          for (int c = 0; c < BOXES; ++c) {
            tma_load_4d(sm.k[st] + c * TN * 64, &p.k, &sm.kv_full[st],
                        c * 64, hk, kt * TN, b);
            tma_load_4d(sm.v[st] + c * TN * 64, &p.v, &sm.kv_full[st],
                        c * 64, hk, kt * TN, b);
          }
        }
      }
    }
    return;
  }

  regs_inc<CONSUMER_REGS>();
  const int cw = wg - 1;                // rows 64 cw .. 64 cw + 63
  const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
  const int row0 = 64 * cw + 16 * warp + lane / 4;    // and row0 + 8
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  float dq[D / 2], s[32], dp[32];
  uint32_t ds[TN / 16][4];
  int it = 0;                           // tiles consumed: the ring's position
  for (int j = 0, w; (w = item_index(j)) < items; ++j) {
    const int qt = p.nq - 1 - w / heads, h = w % p.Hq;
    const int b = w % heads / p.Hq;
    const int nkt = dq_key_tiles(qt, p.T);
    // tiles that reach this warpgroup's rows: the diagonal one is
    // 2 qt + cw (the first warpgroup skips the item's last 64 keys)
    const int diag = 2 * qt + cw, mine = min(diag + 1, nkt);
    const long long rows = ((long long)b * p.Hq + h);
    mbar_wait(&sm.q_full, j & 1);

    // di = rowsum(o . dO) of the lane's two rows from the tiles (a quad's
    // four lanes split D), and lse in base 2; both into the scratch
    float di[2], lse2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = row0 + 8 * r, row = qt * IM + rr;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int at = tile_at<IM>(rr, 8 * i + 2 * (lane & 3));
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sm.o + at));
        const float2 y = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sm.dout + at));
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      di[r] = row < p.T ? acc : 0.f;
      lse2[r] = row < p.T ? p.lse[rows * p.T + row] * LOG2E : INFINITY;
      if ((lane & 3) == 0) {
        p.lse2[rows * p.Tp + row] = lse2[r];
        p.di[rows * p.Tp + row] = di[r];
      }
    }

#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    int pending = -1;                   // the stage dQ's product still reads
    for (int kt = 0; kt < nkt; ++kt, ++it) {
      const int st = it % DQ_STAGES;
      mbar_wait(&sm.kv_full[st], (it / DQ_STAGES) & 1);
      if (kt >= mine) {                 // all keys past this warpgroup's rows
        release(&sm.kv_empty[st]);
        continue;
      }
      reg_fence(s);
      reg_fence(dp);
      wgmma_fence();
      gemm_abt<D, IM>(s, sm.q, 64 * cw, sm.k[st]);
      wgmma_commit();
      gemm_abt<D, IM>(dp, sm.dout, 64 * cw, sm.v[st]);
      wgmma_commit();
      wgmma_wait<1>();                  // the last tile's dQ and S done
      reg_fence(s);
      reg_fence(dq);
      if (pending >= 0) release(&sm.kv_empty[pending]);
      // P = 2^(S scale log2(e) - lse log2(e)), masked on the diagonal
      // tile, under dP's product
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = ex2(fmaf(s[i], p.scale_log2, -lse2[r]));
        if (kt == diag && kt * TN + acc_col(i, lane) > qt * IM + row0 + 8 * r)
          s[i] = 0.f;
      }
      wgmma_wait<0>();
      reg_fence(dp);
      if (kt == mine - 1) release(&sm.q_empty);   // Q, dO, o read for good
      // dS = (dP - di) P scale, rounded to bf16 pairs
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dp[i] = (dp[i] - di[(i >> 1) & 1]) * s[i] * p.scale;
#pragma unroll
      for (int kk = 0; kk < TN / 16; ++kk)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          ds[kk][jj] = pack_bf2(dp[8 * kk + 2 * jj], dp[8 * kk + 2 * jj + 1]);
      wgmma_fence();
      gemm_xb<D>(dq, ds, sm.k[st]);     // dQ += dS K, under the next S, dP
      wgmma_commit();
      pending = st;
    }
    wgmma_wait<0>();
    reg_fence(dq);
    if (pending >= 0) release(&sm.kv_empty[pending]);
    store_acc<D>(p.dq + (((long long)b * p.T + qt * IM) * p.Hq + h) * D,
                 (long long)p.Hq * D, row0, p.T - qt * IM, dq, lane);
  }
}

// Work item w of the dK/dV kernel, longest first: key tile kt (keys kt IM
// ..) of kv head hk, batch row b, split s of its query heads
struct KvItem {
  int kt, hk, b, s;
};

__device__ __forceinline__ KvItem kv_item(const DkvParams& p, int w) {
  const int per = p.Hkv * p.B * p.splits;
  const int r = w % per;
  return {w / per, r % p.Hkv, r / p.Hkv % p.B, r / (p.Hkv * p.B)};
}

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    dkv_wgmma_kernel(const __grid_constant__ DkvParams p) {
  constexpr int BOXES = D / 64;
  constexpr uint32_t ROWS_BYTES = IM * D * 2, TILE_BYTES = TN * D * 2;
  extern __shared__ __align__(1024) unsigned char dkv_smem[];
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(
      (reinterpret_cast<uintptr_t>(dkv_smem) + 1023) & ~uintptr_t(1023));
  const int items = p.nq * p.Hkv * p.B * p.splits;
  const int g_all = p.Hq / p.Hkv, g_split = g_all / p.splits;
  const int nqt = (p.T + TN - 1) / TN;  // query tiles
  const int wg = threadIdx.x / WG;
  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    mbar_init(&sm.kv_empty, CONSUMER_WARPS);
#pragma unroll
    for (int st = 0; st < DKV_STAGES; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {                        // producer: one thread starts TMA
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int j = 0, w; (w = item_index(j)) < items; ++j) {
        const KvItem e = kv_item(p, w);
        mbar_wait(&sm.kv_empty, (j & 1) ^ 1);
        mbar_expect(&sm.kv_full, 2 * ROWS_BYTES);
#pragma unroll
        for (int c = 0; c < BOXES; ++c) {
          tma_load_4d(sm.k + c * IM * 64, &p.k, &sm.kv_full, c * 64, e.hk,
                      e.kt * IM, e.b);
          tma_load_4d(sm.v + c * IM * 64, &p.v, &sm.kv_full, c * 64, e.hk,
                      e.kt * IM, e.b);
        }
        for (int g = e.s * g_split; g < (e.s + 1) * g_split; ++g) {
          const int h = e.hk * g_all + g;
          const long long rows = ((long long)e.b * p.Hq + h) * p.Tp;
          for (int qt = 2 * e.kt; qt < nqt; ++qt, ++it) {
            const int st = it % DKV_STAGES;
            mbar_wait(&sm.empty[st], ((it / DKV_STAGES) & 1) ^ 1);
            mbar_expect(&sm.full[st], 2 * TILE_BYTES + 2 * TN * 4);
#pragma unroll
            for (int c = 0; c < BOXES; ++c) {
              tma_load_4d(sm.q[st] + c * TN * 64, &p.q, &sm.full[st], c * 64,
                          h, qt * TN, e.b);
              tma_load_4d(sm.dout[st] + c * TN * 64, &p.dout, &sm.full[st],
                          c * 64, h, qt * TN, e.b);
            }
            bulk_load(sm.lse2[st], p.lse2 + rows + qt * TN, TN * 4,
                      &sm.full[st]);
            bulk_load(sm.di[st], p.di + rows + qt * TN, TN * 4,
                      &sm.full[st]);
          }
        }
      }
    }
    return;
  }

  regs_inc<CONSUMER_REGS>();
  const int cw = wg - 1;                // keys 64 cw .. 64 cw + 63
  const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
  const int krow = 16 * warp + lane / 4;   // keys krow (+ 8) of the
  const int key0 = 64 * cw + krow;         // warpgroup's, key0 of the item
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  float dk[D / 2], dv[D / 2], s[32], dp[32];
  uint32_t pa[TN / 16][4], da[TN / 16][4];
  int it = 0;
  for (int j = 0, w; (w = item_index(j)) < items; ++j) {
    const KvItem e = kv_item(p, w);
    const int diag = 2 * e.kt + cw;     // the query tile on this warpgroup's
                                        // diagonal; the ones before it see
                                        // none of its keys
    mbar_wait(&sm.kv_full, j & 1);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    for (int g = 0; g < g_split; ++g) {
      for (int qt = 2 * e.kt; qt < nqt; ++qt, ++it) {
        const int st = it % DKV_STAGES;
        mbar_wait(&sm.full[st], (it / DKV_STAGES) & 1);
        if (qt < diag) {
          release(&sm.empty[st]);
          continue;
        }
        reg_fence(s);
        reg_fence(dp);
        wgmma_fence();
        gemm_abt<D, IM>(s, sm.k, 64 * cw, sm.q[st]);      // S^T = K Q^T
        wgmma_commit();
        gemm_abt<D, IM>(dp, sm.v, 64 * cw, sm.dout[st]);  // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait<1>();
        reg_fence(s);
        // P^T = 2^(S^T scale log2(e) - lse log2(e)) (a query row's lse a
        // column) in f32, masked where a key follows the query row on the
        // diagonal tile, under dP^T's product
        const float* lse2 = sm.lse2[st];
        const float* dis = sm.di[st];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = acc_col(i, lane);
          s[i] = ex2(fmaf(s[i], p.scale_log2, -lse2[col]));
          if (qt == diag && krow + 8 * ((i >> 1) & 1) > col) s[i] = 0.f;
        }
        wgmma_wait<0>();
        reg_fence(dp);
        // dS^T = (dP^T - di) P^T scale; P^T and dS^T rounded to bf16
        // pairs in one pass (each pair's four floats die as it is made),
        // the A operands of dV += P^T dO and dK += dS^T Q
#pragma unroll
        for (int kk = 0; kk < TN / 16; ++kk)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int i = 8 * kk + 2 * jj, col = acc_col(i, lane);
            pa[kk][jj] = pack_bf2(s[i], s[i + 1]);
            da[kk][jj] = pack_bf2(
                (dp[i] - dis[col]) * s[i] * p.scale,
                (dp[i + 1] - dis[col + 1]) * s[i + 1] * p.scale);
          }
        reg_fence(dv);
        reg_fence(dk);
        wgmma_fence();
        gemm_xb<D>(dv, pa, sm.dout[st]);                  // dV += P^T dO
        gemm_xb<D>(dk, da, sm.q[st]);                     // dK += dS^T Q
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dk);
        reg_fence(dv);
        release(&sm.empty[st]);
      }
    }
    release(&sm.kv_empty);

    const int keys = p.T - e.kt * IM;   // rows of the item below T
    const long long out0 = (long long)e.b * p.kvsb
                           + ((long long)e.kt * IM * p.Hkv + e.hk) * D;
    const long long kst = (long long)p.Hkv * D;
    if (p.splits == 1) {
      store_acc<D>(p.dk + out0, kst, key0, keys, dk, lane);
      store_acc<D>(p.dv + out0, kst, key0, keys, dv, lane);
      continue;
    }
    // split heads: this block's f32 partials, then the last block of the
    // (key tile, kv head, batch row) sums all of them in split order
    const long long plane = (long long)p.splits * p.B * p.Hkv * p.Tp * D;
    const long long own =
        ((((long long)e.s * p.B + e.b) * p.Hkv + e.hk) * p.Tp + e.kt * IM)
        * D;
    const long long step = (long long)p.B * p.Hkv * p.Tp * D;  // a split
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long at = own + (long long)(key0 + 8 * r) * D
                           + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<float2*>(p.part + at + 8 * i) =
            make_float2(dk[4 * i + 2 * r], dk[4 * i + 2 * r + 1]);
        *reinterpret_cast<float2*>(p.part + plane + at + 8 * i) =
            make_float2(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
      }
    }
    __threadfence();
    named_sync(BAR_CONSUMERS, 2 * WG);
    int* ticket = p.tickets + ((long long)e.kt * p.Hkv + e.hk) * p.B + e.b;
    if (threadIdx.x == WG)
      sm.last = atomicAdd(ticket, 1) == p.splits - 1;
    named_sync(BAR_CONSUMERS, 2 * WG);
    if (!sm.last) continue;
    __threadfence();
    // each of the lane's rows of dK, then of dV: split by split, the row's
    // D / 4 values read at once (loads in flight, not one chain a value),
    // summed in split order
    const float* first = p.part + own - e.s * step;
#pragma unroll 1
    for (int pl = 0; pl < 2; ++pl) {
#pragma unroll 1
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        const float* row = first + pl * plane + key * D + 2 * (lane & 3);
        float2 acc[D / 8];
#pragma unroll
        for (int i = 0; i < D / 8; ++i) acc[i] = make_float2(0.f, 0.f);
        for (int sp = 0; sp < p.splits; ++sp) {
#pragma unroll
          for (int i = 0; i < D / 8; ++i) {
            const float2 x = __ldcg(reinterpret_cast<const float2*>(
                row + sp * step + 8 * i));
            acc[i].x += x.x;
            acc[i].y += x.y;
          }
        }
        if (key >= keys) continue;
        __nv_bfloat16* out = (pl ? p.dv : p.dk) + out0 + key * kst
                             + 2 * (lane & 3);
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          *reinterpret_cast<uint32_t*>(out + 8 * i) =
              pack_bf2(acc[i].x, acc[i].y);
      }
    }
    if (threadIdx.x == WG) *ticket = 0;  // for the next call
  }
}

int sm_count(int* sms) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

// The bf16 path's scratch: lse log2(e) and di [B, Hq, Tp], and with S > 1
// the partial dK and dV [2][S][B][Hkv][Tp][D] (floats) and the tickets
// [nq][Hkv][B]. S splits each kv head's query heads: the largest divisor
// of G for which S x the items (key tiles x kv heads x batch) still fit
// the SMs in one wave, else 1. (At G = 8, T = 512: S = 4, 128 items; S =
// 8 took two waves and twice the partials, and was slower than S = 1.)
struct Scratch {
  int nq, Tp, splits;
  long long floats, tickets;
};

Scratch scratch_of(int B, int T, int Hq, int Hkv, int D, int sms) {
  Scratch s;
  s.nq = (T + IM - 1) / IM;
  s.Tp = s.nq * IM;
  const long long items = (long long)s.nq * Hkv * B;
  const int g = Hq / Hkv;
  s.splits = 1;                         // the largest divisor of G that
  for (int d = 2; d <= g; ++d)          // keeps the items in one wave
    if (g % d == 0 && items * d <= sms) s.splits = d;
  s.floats = 2LL * B * Hq * s.Tp
             + (s.splits > 1 ? 2LL * s.splits * B * Hkv * s.Tp * D : 0);
  s.tickets = s.splits > 1 ? items : 0;
  return s;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, void* dq, void* dk,
                 void* dv, float* ws, int* tickets, long long qsb,
                 long long qst, long long ksb, long long kst, long long vsb,
                 long long vst, long long osb, long long ost, long long dsb,
                 long long dst, long long kvsb, int B, int T, int Hq,
                 int Hkv, float scale, void* stream) {
  int sms;
  int err = sm_count(&sms);
  if (err) return err;
  const Scratch sc = scratch_of(B, T, Hq, Hkv, D, sms);
  if (ws == nullptr || (sc.splits > 1 && tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long dq_items = (long long)sc.nq * Hq * B;
  const long long kv_items = (long long)sc.nq * Hkv * B * sc.splits;
  if (dq_items > 0x7fffffff || kv_items > 0x7fffffff)
    return (int)cudaErrorInvalidValue;

  DqParams a;
  DkvParams c;
  if (!tensor_map_rows(&a.q, q, D, Hq, T, B, qst, qsb, IM)
      || !tensor_map_rows(&a.dout, dout, D, Hq, T, B, dst, dsb, IM)
      || !tensor_map_rows(&a.o, o, D, Hq, T, B, ost, osb, IM)
      || !tensor_map_rows(&a.k, k, D, Hkv, T, B, kst, ksb, TN)
      || !tensor_map_rows(&a.v, v, D, Hkv, T, B, vst, vsb, TN)
      || !tensor_map_rows(&c.k, k, D, Hkv, T, B, kst, ksb, IM)
      || !tensor_map_rows(&c.v, v, D, Hkv, T, B, vst, vsb, IM)
      || !tensor_map_rows(&c.q, q, D, Hq, T, B, qst, qsb, TN)
      || !tensor_map_rows(&c.dout, dout, D, Hq, T, B, dst, dsb, TN))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * Hq * sc.Tp;
  a.lse = lse;
  a.lse2 = ws;
  a.di = ws + rows;
  a.dq = static_cast<__nv_bfloat16*>(dq);
  c.lse2 = ws;
  c.di = ws + rows;
  c.part = ws + 2 * rows;
  c.tickets = tickets;
  c.dk = static_cast<__nv_bfloat16*>(dk);
  c.dv = static_cast<__nv_bfloat16*>(dv);
  c.kvsb = kvsb;
  a.nq = c.nq = sc.nq;
  a.B = c.B = B;
  a.T = c.T = T;
  a.Tp = c.Tp = sc.Tp;
  a.Hq = c.Hq = Hq;
  a.Hkv = c.Hkv = Hkv;
  c.splits = sc.splits;
  a.scale = c.scale = scale;
  a.scale_log2 = c.scale_log2 = scale * LOG2E;

  const size_t dq_smem = sizeof(DqSmem<D>) + 1024;   // + the alignment
  const size_t kv_smem = sizeof(DkvSmem<D>) + 1024;
  auto kq = dq_wgmma_kernel<D>;
  auto kkv = dkv_wgmma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
  if (e != cudaSuccess) return (int)e;
  kq<<<(int)(dq_items > sms ? sms : dq_items), WS_THREADS, dq_smem,
       (cudaStream_t)stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kkv<<<(int)(kv_items > sms ? sms : kv_items), WS_THREADS, kv_smem,
        (cudaStream_t)stream>>>(c);
  return (int)cudaGetLastError();
}

}  // namespace

// The floats of f32 scratch and the int32 tickets the bf16 path of
// flash_attn_bwd takes for these shapes on the current device, and the
// splits of each kv head's query heads: out[0], out[1], out[2] (all 0 at
// f32 = 1, which takes none). Returns a cudaError_t.
extern "C" int flash_attn_bwd_scratch(int B, int T, int Hq, int Hkv, int D,
                                      int f32, long long* out) {
  out[0] = out[1] = out[2] = 0;
  if (B < 0 || T < 0 || Hkv < 1 || Hq < Hkv || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  if (f32 || B == 0 || T == 0) return 0;
  int sms;
  const int err = sm_count(&sms);
  if (err) return err;
  const Scratch s = scratch_of(B, T, Hq, Hkv, D, sms);
  out[0] = s.floats;
  out[1] = s.tickets;
  out[2] = s.splits;
  return 0;
}

// q [B, T, Hq, D], k/v [B, >=T, Hkv, D], o and dout [B, T, Hq, D] with
// element strides (batch, token) given and heads and D contiguous,
// 16-byte aligned rows and strides; lse (K13's, flash_attn with its lse)
// f32 [B, Hq, T]; dq [B, T, Hq, D] contiguous; dk, dv [B, S, Hkv, D]
// contiguous with batch stride kvsb = S * Hkv * D (rows < T written).
// f32 = 0: bf16 tensors (wgmma): o is read, di is not; ws and tickets as
// flash_attn_bwd_scratch sizes them (tickets 0 on entry, left at 0).
// f32 = 1: float32 tensors (the split products): di = rowsum(o . dout)
// f32 [B, Hq, T] is read, o, ws and tickets are not. Launches the dQ
// kernel, then the dK/dV kernel. Returns a cudaError_t.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const float* lse, const float* di, void* dq,
                              void* dk, void* dv, float* ws, int* tickets,
                              long long qsb, long long qst, long long ksb,
                              long long kst, long long vsb, long long vst,
                              long long osb, long long ost, long long dsb,
                              long long dst, long long kvsb, int B, int T,
                              int Hq, int Hkv, int D, int f32, float scale,
                              void* stream) {
  if (B < 0 || T < 0 || Hkv < 1 || Hq < Hkv || Hq % Hkv || B > 65535
      || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  if (f32) {
    const Args a{q, k, v, dout, lse, di, dq, dk, dv, qsb, qst,
                 ksb, kst, vsb, vst, dsb, dst, kvsb, T, Hq, Hkv, scale};
    if (D == 64) return launch_split<64>(a, B, stream);
    if (D == 128) return launch_split<128>(a, B, stream);
    return (int)cudaErrorInvalidValue;
  }
  if (D == 64)
    return launch_wgmma<64>(q, k, v, o, dout, lse, dq, dk, dv, ws, tickets,
                            qsb, qst, ksb, kst, vsb, vst, osb, ost, dsb, dst,
                            kvsb, B, T, Hq, Hkv, scale, stream);
  if (D == 128)
    return launch_wgmma<128>(q, k, v, o, dout, lse, dq, dk, dv, ws, tickets,
                             qsb, qst, ksb, kst, vsb, vst, osb, ost, dsb,
                             dst, kvsb, B, T, Hq, Hkv, scale, stream);
  return (int)cudaErrorInvalidValue;
}
