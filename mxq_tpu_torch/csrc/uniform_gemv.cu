// K7 and K8: y = x @ dequant(p) for the uniform 4-bit and 2-bit formats
// (ops/uniform4.py), x rounded to bf16, f32 accumulation; one template on
// the code width, its products on the tensor cores at every batch size.
//
// Replaces the TPU kernels
//   K7  mxq_tpu/ops/uniform4.py _u4_kernel (:117) via _u4_matmul_padded
//       (:152) and u4_matmul (:188) — the packed lm_head of the engine;
//   K8  mxq_tpu/ops/uniform4.py _u2_kernel (:292) via _u2_matmul_padded
//       (:325) and u2_matmul (:354).
//
// Format: word r of k-tile t (1024 input columns) holds the codes of
// columns t*1024 + j*SLAB + r at bits BITS*j (SLAB = 1024 / codes per
// word: 128 word rows for 4-bit, 64 for 2-bit); quant group g = 128
// columns has one bf16 scale s and integer zero z per output column. The
// kernel computes, per group,
//   acc += s_g * (x_g . (c_g - z_g))
// where c - z is an integer of at most 4 bits: exact in bf16, as is x,
// so a bf16 x bf16 -> f32 MMA (mma.sync m16n8k16) forms every product
// exactly. Only the order of the f32 sums differs from the plain
// version's bf16(x) @ (s*(c - z)). Each group's k-steps accumulate into a
// fresh f32 partial that is folded into the running sum with the column's
// scale once per group and k-tile.
//
// The codes become an MMA operand in registers: one prmt puts the 16-bit
// halves of two word rows (k, k+1) side by side, a shift and a mask-or
// (one lop3) drop each code into the low mantissa of a bf16 128.0
// (0x4300), one sub.bf16x2 of 128 + z leaves c - z: two codes per three
// integer instructions and one bf16x2 subtraction, no per-code convert.
//
// Bound on the H100: bytes at decode batch sizes (the lm_head reads 4.25
// or 2.25 bits per weight once), operations in prefill (the engine takes
// logits of up to 2048 rows). Two mainloops, picked by the wrapper from B:
//  * B <= 64 (decode, a verify round), "codes-major": the weight is the
//    MMA's A operand (16 output columns by 16 k) and x its B operand (8
//    or 32 batch rows a block; two row blocks above 32), so no MMA row
//    is wasted at B <= 8. A block
//    stages a whole k-tile (its words [SLAB, BN], scales and zeros [8, BN]
//    and x [BM, 1024]) with cp.async, one k-tile ahead; each lane loads the
//    four word rows of a k-step once and unpacks from them the codes of
//    all 8 groups (all 16 half-groups at 2 bits), each group with its own
//    partial. The weight is read once.
//  * B > 64 (prefill), "group-major": the weight is the B operand, x the A
//    operand in 128-row tiles (warps of 2 x 4, each 64 by 32), so the
//    weight is re-read B/128 times. The k-tile's words are staged with
//    cp.async and the 8 groups are walked from shared memory, each group's
//    x [BM, 128] staged one group ahead.
// Block x runs over row tiles, so the blocks that share a column block's
// words run together (L2). K is split across blocks (blockIdx.z) in whole
// k-tiles when the blocks do not fill the 132 SMs; a second pass adds the
// partial sums in split order (deterministic). With one split the kernel
// writes y.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "device_util.cuh"

constexpr int KT = 1024;          // input columns per k-tile
constexpr int GROUP = 128;        // quant group along K
constexpr int GPT = KT / GROUP;   // groups per k-tile

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16x2(128 + z) twice
__device__ __forceinline__ uint32_t zero_pair(__nv_bfloat16 z) {
  const __nv_bfloat16 h = __float2bfloat16_rn(128.f + __bfloat162float(z));
  return bf16x2_bits(__halves2bfloat162(h, h));
}

// the halves of word rows k (wa) and k + 1 (wb) that hold bit `pos`, side
// by side: k in the low half
__device__ __forceinline__ uint32_t pair_halves(uint32_t wa, uint32_t wb,
                                                int pos) {
  return __byte_perm(wa, wb, pos < 16 ? 0x5410u : 0x7632u);
}

// c - z of the codes at bits pos % 16 of both halves of p (pair_halves),
// as one bf16x2; zz = bf16x2(128 + z) twice.
//   lop3:    (p >> pos % 16) & mask | 0x43004300 = bf16(128 + c) twice
//   sub:     (128 + c) - (128 + z), exact
template <int BITS>
__device__ __forceinline__ uint32_t codes_minus_zero(uint32_t p, int pos,
                                                     uint32_t zz) {
  constexpr uint32_t MASK2 = ((1u << BITS) - 1u) * 0x00010001u;
  const uint32_t c = ((p >> (pos & 15)) & MASK2) | 0x43004300u;
  return bf16x2_bits(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&c),
                             *reinterpret_cast<const __nv_bfloat162*>(&zz)));
}

// ---------------------------------------------------------------------------
// B <= 64: codes-major. A block of WARPS warps owns BN = 16 * WARPS output
// columns and BM = 8 * NB batch rows; warp w owns columns w*16 .. +15, in
// the MMA's A rows as: row q (0..7) = column 2q, row q + 8 = column 2q + 1,
// so that a lane's two columns are one 8-byte load of a word row.
// ---------------------------------------------------------------------------

template <int BITS, int NB>
struct Small {
  static constexpr int WARPS = NB == 4 ? 4 : 8;   // two stages fit
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BN = 16 * WARPS, BM = 8 * NB;
  static constexpr int SLAB = KT * BITS / 32;   // word rows per k-tile
  static constexpr int WS = BN + 4;   // word row stride: a k-step's loads
                                      // hit 32 banks per 16 lanes
  static constexpr int XK = KT + 8;   // x row stride (bf16): ldmatrix
                                      // without conflicts
  static constexpr int SW = SLAB * WS, SX = BM * XK, SS = GPT * BN;
  static constexpr size_t SMEM = 2ull * (SW * 4 + SX * 2 + 2 * SS * 2);
};

template <int BITS, int NB>
__global__ void __launch_bounds__(Small<BITS, NB>::THREADS)
uniform_small_kernel(const __nv_bfloat16* __restrict__ x, int B, int ldx,
                     const uint32_t* __restrict__ w,
                     const __nv_bfloat16* __restrict__ s,
                     const __nv_bfloat16* __restrict__ z, int n_kt, int npad,
                     int tiles_per_split, float* __restrict__ out, int ldo,
                     int ncols) {
  using P = Small<BITS, NB>;
  constexpr int PER = 32 / BITS, SLAB = P::SLAB, BN = P::BN, BM = P::BM;
  constexpr int WS = P::WS, XK = P::XK, THREADS = P::THREADS;
  constexpr int SPG = PER / GPT;   // slabs per group: 1 (u4), 2 (u2)
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* wsm = reinterpret_cast<uint32_t*>(smem);        // [2][SLAB][WS]
  __nv_bfloat16* xsm =
      reinterpret_cast<__nv_bfloat16*>(wsm + 2 * P::SW);      // [2][BM][XK]
  __nv_bfloat16* ssm = xsm + 2 * P::SX;                       // [2][GPT][BN]
  __nv_bfloat16* zsm = ssm + 2 * P::SS;                       // [2][GPT][BN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wc = warp * 16 + 2 * g;     // this lane's columns wc, wc + 1
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int t0 = blockIdx.z * tiles_per_split;
  const int t1 = min(n_kt, t0 + tiles_per_split);

  // k-tile t (words, scales, zeros, x) -> stage (t - t0) % 2
  auto load = [&](int t) {
    const int st = (t - t0) & 1;
    uint32_t* dw = wsm + st * P::SW;
    const uint32_t* gw = w + (size_t)t * SLAB * npad + n0;
    constexpr int CW = BN / 4;            // 16-byte chunks per word row
    for (int i = tid; i < SLAB * CW; i += THREADS) {
      const int r = i / CW, c = i % CW;
      cp16(dw + r * WS + c * 4, gw + (size_t)r * npad + c * 4, true);
    }
    constexpr int CS = BN / 8;
    for (int i = tid; i < 2 * GPT * CS; i += THREADS) {
      const int zs = i / (GPT * CS), r = i % (GPT * CS) / CS, c = i % CS;
      cp16((zs ? zsm : ssm) + st * P::SS + r * BN + c * 8,
           (zs ? z : s) + (size_t)(t * GPT + r) * npad + n0 + c * 8, true);
    }
    __nv_bfloat16* dx = xsm + st * P::SX;
    constexpr int CX = KT / 8;
    for (int i = tid; i < BM * CX; i += THREADS) {
      const int r = i / CX, c = i % CX;
      const int row = m0 + r, col = t * KT + c * 8;
      const bool ok = row < B && col < ldx;
      cp16(dx + r * XK + c * 8, ok ? x + (size_t)row * ldx + col : x, ok);
    }
  };

  float acc[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  if (t0 < t1) load(t0);
  cp_commit();
  for (int t = t0; t < t1; ++t) {
    if (t + 1 < t1) load(t + 1);
    cp_commit();
    cp_wait1();
    __syncthreads();
    const int st = (t - t0) & 1;
    const uint32_t* wb = wsm + st * P::SW;
    const __nv_bfloat16* xb = xsm + st * P::SX;
    const __nv_bfloat16* sb = ssm + st * P::SS;
    const __nv_bfloat16* zb = zsm + st * P::SS;

    uint32_t zz[GPT][2];                  // 128 + z of columns wc, wc + 1
    float part[GPT][NB][4];
#pragma unroll
    for (int gi = 0; gi < GPT; ++gi) {
      zz[gi][0] = zero_pair(zb[gi * BN + wc]);
      zz[gi][1] = zero_pair(zb[gi * BN + wc + 1]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[gi][nb][e] = 0.f;
    }
    // ldmatrix addresses: x rows (lane & 7) (+ 8 for lanes 16..31 when a
    // load covers two row tiles), k + 8 for lanes 8..15 and 24..31
    const __nv_bfloat16* xl =
        xb + ((lane & 7) + 8 * (NB > 1 ? lane >> 4 : 0)) * XK
        + 8 * ((lane >> 3) & 1);

#pragma unroll
    for (int kk = 0; kk < SLAB / 16; ++kk) {
      // word rows k, k + 1, k + 8, k + 9 (k = kk*16 + 2*tq) of both columns
      const uint32_t* wr = wb + (kk * 16 + 2 * tq) * WS + wc;
      const uint2 w0 = *reinterpret_cast<const uint2*>(wr);
      const uint2 w1 = *reinterpret_cast<const uint2*>(wr + WS);
      const uint2 w8 = *reinterpret_cast<const uint2*>(wr + 8 * WS);
      const uint2 w9 = *reinterpret_cast<const uint2*>(wr + 9 * WS);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        // slab j: group j / SPG, columns j*SLAB + kk*16 .. of the k-tile
        const int gi = j / SPG, pos = BITS * j;
        const uint32_t a0 = codes_minus_zero<BITS>(
            pair_halves(w0.x, w1.x, pos), pos, zz[gi][0]);
        const uint32_t a1 = codes_minus_zero<BITS>(
            pair_halves(w0.y, w1.y, pos), pos, zz[gi][1]);
        const uint32_t a2 = codes_minus_zero<BITS>(
            pair_halves(w8.x, w9.x, pos), pos, zz[gi][0]);
        const uint32_t a3 = codes_minus_zero<BITS>(
            pair_halves(w8.y, w9.y, pos), pos, zz[gi][1]);
        const __nv_bfloat16* xj = xl + j * SLAB + kk * 16;
        if constexpr (NB == 1) {
          uint32_t b[2];
          ldmatrix(b, xj);
          mma_bf16(part[gi][0], a0, a1, a2, a3, b[0], b[1]);
        } else {
#pragma unroll
          for (int h = 0; h < NB / 2; ++h) {
            uint32_t b[4];
            ldmatrix(b, xj + h * 16 * XK);
            mma_bf16(part[gi][2 * h], a0, a1, a2, a3, b[0], b[1]);
            mma_bf16(part[gi][2 * h + 1], a0, a1, a2, a3, b[2], b[3]);
          }
        }
      }
    }
    // fold: accumulator e holds column wc + (e >> 1), batch row
    // 2*tq + (e & 1) of row tile nb
#pragma unroll
    for (int gi = 0; gi < GPT; ++gi) {
      const float s0 = __bfloat162float(sb[gi * BN + wc]);
      const float s1 = __bfloat162float(sb[gi * BN + wc + 1]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        acc[nb][0] += s0 * part[gi][nb][0];
        acc[nb][1] += s0 * part[gi][nb][1];
        acc[nb][2] += s1 * part[gi][nb][2];
        acc[nb][3] += s1 * part[gi][nb][3];
      }
    }
    __syncthreads();
  }

  float* o = out + (size_t)blockIdx.z * B * ldo;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + nb * 8 + 2 * tq + (e & 1);
      const int c = n0 + wc + (e >> 1);
      if (r < B && c < ncols) o[(size_t)r * ldo + c] = acc[nb][e];
    }
}

// ---------------------------------------------------------------------------
// B > 64: group-major. A block owns BM x BN, WGM x WGN warps, each MT m16
// row tiles by NT n8 column tiles.
// ---------------------------------------------------------------------------

template <int BM_, int BN_, int WGM_, int WGN_>
struct Large {
  static constexpr int BM = BM_, BN = BN_, WGM = WGM_, WGN = WGN_;
  static constexpr int THREADS = 32 * WGM * WGN;
  static constexpr int MT = BM / (16 * WGM);
  static constexpr int NT = BN / (8 * WGN);
  static constexpr int WS = BN + 4;   // word row stride: the lanes of a
                                      // B fragment hit 32 banks
  static constexpr int XS = GROUP + 8;   // x row stride (bf16)
  template <int BITS>
  static constexpr size_t smem() {
    return 2ull * (KT * BITS / 32) * WS * 4   // words, two k-tiles
           + 2ull * 2 * GPT * BN * 2          // scales and zeros
           + 2ull * BM * XS * 2;              // x, two groups
  }
};
// measured on the H100 against 64 x 64, 128 x 64 and 16-warp tiles
using Large128 = Large<128, 128, 2, 4>;

template <int BITS, class TL>
__global__ void __launch_bounds__(TL::THREADS)
uniform_large_kernel(const __nv_bfloat16* __restrict__ x, int B, int ldx,
                     const uint32_t* __restrict__ w,
                     const __nv_bfloat16* __restrict__ s,
                     const __nv_bfloat16* __restrict__ z, int n_kt, int npad,
                     int tiles_per_split, float* __restrict__ out, int ldo,
                     int ncols) {
  constexpr int SLAB = KT * BITS / 32;   // word rows per k-tile
  constexpr int BM = TL::BM, BN = TL::BN, MT = TL::MT, NT = TL::NT;
  constexpr int WS = TL::WS, XS = TL::XS, THREADS = TL::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* wsm = reinterpret_cast<uint32_t*>(smem);           // [2][SLAB][WS]
  __nv_bfloat16* ssm =
      reinterpret_cast<__nv_bfloat16*>(wsm + 2 * SLAB * WS);     // [2][GPT][BN]
  __nv_bfloat16* zsm = ssm + 2 * GPT * BN;                       // [2][GPT][BN]
  __nv_bfloat16* xsm = zsm + 2 * GPT * BN;                       // [2][BM][XS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / TL::WGN) * MT * 16;
  const int wn0 = (warp % TL::WGN) * NT * 8;
  const int g = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int t0 = blockIdx.z * tiles_per_split;
  const int t1 = min(n_kt, t0 + tiles_per_split);
  const int nsteps = max(t1 - t0, 0) * GPT;

  // k-tile t's words, scales and zeros -> buffer (t - t0) % 2
  auto load_tile = [&](int t) {
    const int buf = (t - t0) & 1;
    uint32_t* dw = wsm + buf * SLAB * WS;
    const uint32_t* gw = w + (size_t)t * SLAB * npad + n0;
    constexpr int CW = BN / 4;            // 16-byte chunks per word row
    for (int i = tid; i < SLAB * CW; i += THREADS) {
      const int r = i / CW, c = i % CW;
      cp16(dw + r * WS + c * 4, gw + (size_t)r * npad + c * 4, true);
    }
    constexpr int CS = BN / 8;            // chunks per scale row
    for (int i = tid; i < 2 * GPT * CS; i += THREADS) {
      const int zs = i / (GPT * CS), r = i % (GPT * CS) / CS, c = i % CS;
      cp16((zs ? zsm : ssm) + (buf * GPT + r) * BN + c * 8,
           (zs ? z : s) + (size_t)(t * GPT + r) * npad + n0 + c * 8, true);
    }
  };
  // x of step's group [BM, 128] -> buffer step % 2; rows >= B and columns
  // >= ldx are zero
  auto load_x = [&](int step) {
    const int col0 = (t0 + step / GPT) * KT + step % GPT * GROUP;
    __nv_bfloat16* dx = xsm + (step & 1) * BM * XS;
    constexpr int CX = GROUP / 8;
    for (int i = tid; i < BM * CX; i += THREADS) {
      const int r = i / CX, c = i % CX;
      const int row = m0 + r, col = col0 + c * 8;
      const bool ok = row < B && col < ldx;
      cp16(dx + r * XS + c * 8, ok ? x + (size_t)row * ldx + col : x, ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  if (nsteps > 0) {
    load_tile(t0);
    load_x(0);
  }
  cp_commit();
  for (int step = 0; step < nsteps; ++step) {
    const int t = t0 + step / GPT, gi = step % GPT;
    // one copy group per step: x one group ahead, words one k-tile ahead
    if (step + 1 < nsteps) load_x(step + 1);
    if (gi == 0 && t + 1 < t1) load_tile(t + 1);
    cp_commit();
    cp_wait1();
    __syncthreads();

    const int buf = (t - t0) & 1;
    const uint32_t* wb = wsm + buf * SLAB * WS;
    const __nv_bfloat16* sb = ssm + (buf * GPT + gi) * BN;
    const __nv_bfloat16* zb = zsm + (buf * GPT + gi) * BN;
    const __nv_bfloat16* xb = xsm + (step & 1) * BM * XS;
    uint32_t zz[NT];                      // 128 + z of this lane's column
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) zz[nt] = zero_pair(zb[wn0 + nt * 8 + g]);
    float part[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;

#pragma unroll
    for (int kk = 0; kk < GROUP / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix(a[mt], xb + (wm0 + mt * 16 + (lane & 15)) * XS
                            + kk * 16 + (lane >> 4) * 8);
      // k-step kk of group gi is code j of word rows kk*16 % SLAB ..
      const int pos = BITS * (gi * (GROUP / SLAB) + kk * 16 / SLAB);
      const uint32_t* wr = wb + ((kk * 16) % SLAB + 2 * tq) * WS + wn0 + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t* wc = wr + nt * 8;
        const uint32_t b0 = codes_minus_zero<BITS>(
            pair_halves(wc[0], wc[WS], pos), pos, zz[nt]);
        const uint32_t b1 = codes_minus_zero<BITS>(
            pair_halves(wc[8 * WS], wc[9 * WS], pos), pos, zz[nt]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_bf16(part[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b0,
                   b1);
      }
    }
    // fold the group: this lane's accumulator columns are 2*tq, 2*tq + 1
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = wn0 + nt * 8 + 2 * tq;
      const float s0 = __bfloat162float(sb[c]);
      const float s1 = __bfloat162float(sb[c + 1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        acc[mt][nt][0] += s0 * part[mt][nt][0];
        acc[mt][nt][1] += s1 * part[mt][nt][1];
        acc[mt][nt][2] += s0 * part[mt][nt][2];
        acc[mt][nt][3] += s1 * part[mt][nt][3];
      }
    }
    __syncthreads();
  }

  float* o = out + (size_t)blockIdx.z * B * ldo;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = m0 + wm0 + mt * 16 + g;
      const int c = n0 + wn0 + nt * 8 + 2 * tq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = r + (e >> 1) * 8, cc = c + (e & 1);
        if (rr < B && cc < ncols) o[(size_t)rr * ldo + cc] = acc[mt][nt][e];
      }
    }
}

// y[b, n] = sum over splits of part[split, b, n], in split order.
__global__ void reduce_splits_kernel(const float* __restrict__ part,
                                     int ksplit, int B, int npad, int O,
                                     float* __restrict__ y) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)B * O) return;
  const int b = (int)(i / O), n = (int)(i % O);
  float a = 0.f;
  for (int k = 0; k < ksplit; ++k) a += part[((size_t)k * B + b) * npad + n];
  y[i] = a;
}

struct Call {
  const void *x, *w, *s, *z;
  int B, ldx, n_kt, npad, O, tiles_per_split, ksplit;
  void *part, *y;
  cudaStream_t st;
};

template <class K>
int launch(K kernel, int bm, int bn, int threads, size_t smem,
           const Call& c) {
  if (c.npad % bn || c.npad / bn > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool split = c.ksplit > 1;
  dim3 grid((c.B + bm - 1) / bm, c.npad / bn, c.ksplit);
  kernel<<<grid, threads, smem, c.st>>>(
      (const __nv_bfloat16*)c.x, c.B, c.ldx, (const uint32_t*)c.w,
      (const __nv_bfloat16*)c.s, (const __nv_bfloat16*)c.z, c.n_kt, c.npad,
      c.tiles_per_split, (float*)(split ? c.part : c.y),
      split ? c.npad : c.O, split ? c.npad : c.O);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return (int)err;
  const long total = (long)c.B * c.O;
  reduce_splits_kernel<<<(unsigned)((total + 255) / 256), 256, 0, c.st>>>(
      (const float*)c.part, c.ksplit, c.B, c.npad, c.O, (float*)c.y);
  return (int)cudaGetLastError();
}

template <int BITS, int NB>
int launch_small(const Call& c) {
  using P = Small<BITS, NB>;
  return launch(uniform_small_kernel<BITS, NB>, P::BM, P::BN, P::THREADS,
                P::SMEM, c);
}

template <int BITS, class TL>
int launch_large(const Call& c) {
  return launch(uniform_large_kernel<BITS, TL>, TL::BM, TL::BN, TL::THREADS,
                TL::template smem<BITS>(), c);
}

// tile ids: 0, 1 codes-major with 8, 32 batch rows per block, 2
// group-major with 128
template <int BITS>
int by_tile(int tile, const Call& c) {
  switch (tile) {
    case 0: return launch_small<BITS, 1>(c);
    case 1: return launch_small<BITS, 4>(c);
    case 2: return launch_large<BITS, Large128>(c);
    default: return (int)cudaErrorInvalidValue;
  }
}

constexpr int TILE_BM_BN[][2] = {{Small<4, 1>::BM, Small<4, 1>::BN},
                                 {Small<4, 4>::BM, Small<4, 4>::BN},
                                 {Large128::BM, Large128::BN}};
constexpr int NTILES = sizeof(TILE_BM_BN) / sizeof(TILE_BM_BN[0]);

}  // namespace

// (batch rows, columns) of each tile id into bm_bn[2 * id], [2 * id + 1],
// for at most n ids; returns the number of ids. The wrapper sizes its K
// split from these.
extern "C" int uniform_gemv_tiles(int* bm_bn, int n) {
  for (int i = 0; i < NTILES && i < n; ++i) {
    bm_bn[2 * i] = TILE_BM_BN[i][0];
    bm_bn[2 * i + 1] = TILE_BM_BN[i][1];
  }
  return NTILES;
}

// bits = 4 (K7) or 2 (K8); tile as by_tile numbers them (picked by the
// wrapper from B). x [B, ldx] bf16 row-major, 16-byte aligned, ldx % 8 == 0
// (columns >= K zero or absent); w/s/z as packed; part [ksplit, B, npad]
// f32 scratch (unused with one split); y [B, O] f32.
extern "C" int uniform_gemv(int bits, int tile, const void* x, int B, int ldx,
                            const void* w, const void* s, const void* z,
                            int n_kt, int npad, int O, int tiles_per_split,
                            int ksplit, void* part, void* y, void* stream) {
  if (B < 1 || ldx % 8 || (uintptr_t)x % 16 || ksplit < 1 || ksplit > 65535)
    return (int)cudaErrorInvalidValue;
  const Call c{x, w, s, z, B, ldx, n_kt, npad, O, tiles_per_split, ksplit,
               part, y, (cudaStream_t)stream};
  if (bits == 4) return by_tile<4>(tile, c);
  if (bits == 2) return by_tile<2>(tile, c);
  return (int)cudaErrorInvalidValue;
}
