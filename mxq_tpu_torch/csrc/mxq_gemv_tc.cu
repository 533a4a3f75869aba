// K1 and K6 at B >= 2 rows: y = x @ dequant(p) for the packed MXQ format
// (packfmt.py), x rounded to bf16, f32 accumulation, the products on the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 out). One template over
// the unpack layout and the tile.
//
// Replaces the TPU kernels
//   K1  mxq_tpu/ops/mxq_matmul.py _kernel_body (:66) via _mxq_matmul_padded
//       (:554) and _stacked_kernel (:1033) — the B>=2 GEMV/GEMM;
//   K6  _kernel_body_quad (:169) and _kernel_body_bfexp (:252), the two
//       other unpack bodies of K1's pallas_call, picked by MXQ_GEMV_LAYOUT.
// A stacked weight is only a layer offset: the wrapper passes the layer's
// base pointers. The one-row kernels (K2, K6 at B=1) are in mxq_gemv.cu.
//
// Format (per k-tile t of 1024 input columns = 16 packed blocks of 64):
// w2 row t*48 + g holds 2-bit group g's 16 codes (code j at bits 2j), its
// columns 64*(g/3) + 16*(g%3) of the tile; meta word (t, g%16), field g/16
// holds the group's zero (2 bits) and scale code (8 bits), and
// s = qscale * code + qmin; w4 rows 2b, 2b+1 hold the 16 4-bit codes of
// block b's columns 64b + 48 .. 63 (8 a word), with a per-channel scale s4
// and integer zero z4.
//
// The algebra. A 2-bit group is 16 codes: one MMA k-step. Its zero is an
// integer 0..3, so c - z is exact in bf16, as is bf16(x): every product is
// exact. Each group's MMA starts from C = 0 and is folded into the running
// sum with the group's f32 scale, acc += s * (x . (c - z)); the 4-bit
// plane's c4 - z4 (z4 an integer 0..15) accumulates over all of K in its
// own fragment, and y = acc + s4 * acc4. Only the f32 summation order and
// the rounding of s * sum against sum of s*(c - z) differ from the plain
// version. bfexp's weights are bf16 by definition (two roundings, as
// gemv_bfexp_plain): they are the MMA operand as they are, accumulated
// straight through; bf16 x bf16 is exact in f32.
//
// The operands. A register holds a (j, j+8) code pair of one 2-bit word:
// (word >> 2j) & 0x00030003 | 0x43004300 is the bf16 pair (128 + c_j,
// 128 + c_{j+8}), and one sub.bf16x2 of bf16x2(128 + z) leaves c - z. The
// 4-bit word gives (j, j+4) with & 0x000F000F. quad builds the same
// registers through (word >> 2j) & 0x03030303 (byte b = code j + 4b) and
// one byte permute of bytes 0, 2 (or 1, 3) into the bf16 halves, so its
// sums equal slab's bit for bit. bfexp rotates the pair into bf16 1.0's
// mantissa (1 + c/4; 4-bit 1 + c/16) and forms bf16(bf16(4s * p) - bf16(4s
// + s*z)) with two bf16x2 FMAs. Lane (gid, tq) takes j = tq and tq + 4, so
// MMA k-slot 2i + h holds code i + 8h of a 2-bit group (i + 4h + 4*(i>=4)
// of a 4-bit chunk); a first pass (permute_x_kernel) writes x as bf16 in
// that slot order, zero-padded to the packed K, so each x fragment is one
// ldmatrix.
//
// Bound on the H100: bytes at decode batch sizes (~3.5 bits per weight read
// once), operations toward 512 rows. Measured (PERF.md), both mainloops
// are latency-bound at their 8 warps per SM rather than by either bound,
// so the design spends shared memory and registers on residency. Two
// mainloops, picked by the wrapper from B (ops/mxq_matmul._k1_tile):
//  * B <= 64, "codes-major": the weight is the A operand (16 output columns
//    by 16 k), x the B operand in 8-row n-tiles (8 or 32 rows a block), so
//    the weight is read once (twice, from L2, above 32 rows). A step is
//    half a k-tile: its words and x are staged with cp.async one step
//    ahead, the k-tile's metadata one k-tile ahead, so that two blocks
//    fit on an SM (~105 and ~110 KB of shared memory, <= 128 registers).
//  * B > 64, "group-major": x is the A operand in 128-row tiles (warps of
//    2 x 4, each 64 rows by 32 columns), the weight the B operand, re-read
//    B/128 times. The k-tile's words and metadata are staged one k-tile
//    ahead, x one packed block (64 columns) ahead; one block per SM.
// Both build, once per k-tile and block, a table of every group's scale
// (f32) and zero (a byte; bfexp: its two bf16 operands in one word) for the
// block's columns in shared memory, so that a lane reads its groups'
// operands instead of decoding the metadata itself. Block x runs over row
// tiles, so the blocks that share a column block's words run together
// (L2). K is split across blocks (blockIdx.z) in whole k-tiles, as many as
// fill the card's waves best (ops/mxq_matmul._k1_split_tiles, from each
// tile's blocks per SM that mxq_gemv_tc_tiles reports); a second pass adds
// the partial sums in split order (deterministic, no atomics). With one
// split the kernel writes y.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "device_util.cuh"

constexpr int KT = 1024;        // input columns per k-tile
constexpr int NBLK = 16;        // packed blocks (64 columns) per k-tile
constexpr int G2 = 48;          // 2-bit groups per k-tile
constexpr int WROWS = 48 + 32 + 16;   // staged word rows: w2, w4, meta2
constexpr int SLAB = 0, QUAD = 1, BFEXP = 2;
constexpr uint32_t MAGIC = 0x43004300u;   // bf16 128.0 in both halves

// c += a . b
__device__ __forceinline__ void mma_acc(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b (C = 0)
__device__ __forceinline__ void mma_zero(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// (128 + c) - (128 + z) in both halves: exact
__device__ __forceinline__ uint32_t sub_zero(uint32_t c, uint32_t zz) {
  const __nv_bfloat162 d =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&c),
              *reinterpret_cast<const __nv_bfloat162*>(&zz));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// The group operands of a table entry (group_table): for slab and quad
// e0 = bf16x2(128 + z) from the zero byte zb; for bfexp e0 = bf16x2(4s)
// and e1 = bf16x2(4s + s*z) from the packed entry ts.
template <int LAYOUT>
__device__ __forceinline__ void entry_ops(uint32_t ts, uint32_t zb,
                                          uint32_t& e0, uint32_t& e1) {
  if constexpr (LAYOUT == BFEXP) {
    e0 = __byte_perm(ts, 0, 0x1010u);
    e1 = __byte_perm(ts, 0, 0x3232u);
  } else {
    e0 = __byte_perm(zb, 0x43u, 0x4040u);   // bytes z, 0x43, z, 0x43
    e1 = 0;
  }
}

// The two operand registers of lane tq from 2-bit word w: r0 holds codes
// (tq, tq+8), r1 (tq+4, tq+12), each as c - z (bfexp: as its bf16
// weight). e0, e1: the group's entry_ops.
template <int LAYOUT>
__device__ __forceinline__ void operand2(uint32_t w, int tq, uint32_t e0,
                                         uint32_t e1, uint32_t& r0,
                                         uint32_t& r1) {
  if constexpr (LAYOUT == SLAB) {
    r0 = sub_zero(((w >> (2 * tq)) & 0x00030003u) | MAGIC, e0);
    r1 = sub_zero(((w >> (2 * tq + 8)) & 0x00030003u) | MAGIC, e0);
  } else if constexpr (LAYOUT == QUAD) {
    const uint32_t t = (w >> (2 * tq)) & 0x03030303u;   // byte b: tq + 4b
    r0 = sub_zero(__byte_perm(t, 0x43434343u, 0x4240u), e0);
    r1 = sub_zero(__byte_perm(t, 0x43434343u, 0x4341u), e0);
  } else {
    // 1 + c/4 in bf16: the code at bits 5-6 of bf16 1.0 (0x3F80)
    r0 = bfexp_pair(w, 5 - 2 * tq, 0x00600060u, e0, e1);
    r1 = bfexp_pair(w, 29 - 2 * tq, 0x00600060u, e0, e1);
  }
}

// The same for a 4-bit chunk from its two words: r0 holds codes (tq,
// tq+4) of w0, r1 codes (8+tq, 12+tq) of w1. p, q: the column's 4-bit
// constants (four_consts).
template <int LAYOUT>
__device__ __forceinline__ void operand4(uint32_t w0, uint32_t w1, int tq,
                                         uint32_t p, uint32_t q,
                                         uint32_t& r0, uint32_t& r1) {
  if constexpr (LAYOUT == SLAB) {
    r0 = sub_zero(((w0 >> (4 * tq)) & 0x000F000Fu) | MAGIC, p);
    r1 = sub_zero(((w1 >> (4 * tq)) & 0x000F000Fu) | MAGIC, p);
  } else if constexpr (LAYOUT == QUAD) {
    // byte b of (w >> 4(tq&1)) & 0x0F0F0F0F holds code 2b + (tq&1)
    const int sh = 4 * (tq & 1);
    const uint32_t sel = 0x4240u + 0x0101u * (uint32_t)(tq >> 1);
    r0 = sub_zero(__byte_perm((w0 >> sh) & 0x0F0F0F0Fu, 0x43434343u, sel), p);
    r1 = sub_zero(__byte_perm((w1 >> sh) & 0x0F0F0F0Fu, 0x43434343u, sel), p);
  } else {
    // 1 + c/16: the code at bits 3-6 of bf16 1.0
    r0 = bfexp_pair(w0, 3 - 4 * tq, 0x00780078u, p, q);
    r1 = bfexp_pair(w1, 3 - 4 * tq, 0x00780078u, p, q);
  }
}

// A column's 4-bit operand constants: bf16x2(128 + z4) (slab, quad), or
// bfexp's bf16(16*s4) and bf16(16*s4 + s4*z4)
template <int LAYOUT>
__device__ __forceinline__ void four_consts(float s4, float z4, uint32_t& p,
                                            uint32_t& q) {
  if constexpr (LAYOUT == BFEXP) {
    const float s16 = 16.f * s4;
    p = bf2_splat(s16);
    q = bf2_splat(__fadd_rn(s16, __fmul_rn(s4, z4)));
  } else {
    p = bf2_splat(128.f + z4);
    q = 0;
  }
}

// A k-tile's metadata for BN columns in shared memory: meta2 words
// [16][BN], then qscale and qmin rows [32][BN] bf16.
template <int BN>
struct Meta {
  static constexpr size_t BYTES = 16 * BN * 4 + 32 * BN * 2;
};

// The group table of a k-tile's 48 groups for BN columns: ts [48][BN]
// u32, zb [48][BN] bytes. slab, quad: ts = s (f32 bits), zb = z; bfexp:
// ts = bf16(4s) | bf16(4s + s*z) << 16, rounded as gemv_bfexp_plain
// rounds them.
template <int BN>
struct Table {
  static constexpr size_t BYTES = G2 * BN * 5;
};

template <int LAYOUT, int BN, int THREADS>
__device__ __forceinline__ void group_table(const unsigned char* meta_sm,
                                            uint32_t* ts, uint8_t* zb,
                                            int tid) {
  static_assert(G2 * BN % THREADS == 0, "whole rounds");
  const uint32_t* meta = reinterpret_cast<const uint32_t*>(meta_sm);
  const __nv_bfloat16* qs =
      reinterpret_cast<const __nv_bfloat16*>(meta + 16 * BN);
  const __nv_bfloat16* qm = qs + 16 * BN;
#pragma unroll
  for (int k = 0; k < G2 * BN / THREADS; ++k) {
    const int i = tid + k * THREADS;
    const int g = i / BN, c = i % BN, r = g % 16, f = g / 16;
    const uint32_t m = meta[r * BN + c];
    const uint32_t z = (m >> (2 * f)) & 3u;
    const float sc = (float)((m >> (6 + 8 * f)) & 255u);
    const float s = __fadd_rn(__fmul_rn(__bfloat162float(qs[r * BN + c]), sc),
                              __bfloat162float(qm[r * BN + c]));
    if constexpr (LAYOUT == BFEXP) {
      ts[i] = bfexp_entry(4.f * s, __fmul_rn(s, (float)z));
    } else {
      ts[i] = __float_as_uint(s);
      zb[i] = (uint8_t)z;
    }
  }
}

struct Args {
  const __nv_bfloat16* x;       // permuted [B, kp]
  const uint32_t *w2, *w4, *meta2;
  const __nv_bfloat16 *qscale, *qmin;
  const float* smeta4;
  int B, kp, npad, n_kt, tiles_per_split, ldo, ncols;
  float* out;
};

// k-tile t's metadata (Meta) of columns n0 .. n0 + BN
template <int BN, int THREADS>
__device__ __forceinline__ void load_meta(unsigned char* dst, const Args& a,
                                          int t, int n0, int tid) {
  uint32_t* dw = reinterpret_cast<uint32_t*>(dst);
  constexpr int CW = BN / 4;            // 16-byte chunks per word row
  for (int i = tid; i < 16 * CW; i += THREADS) {
    const int r = i / CW, c = i % CW;
    cp16(dw + r * BN + c * 4, a.meta2 + (size_t)(t * 16 + r) * a.npad + n0
                                  + c * 4, true);
  }
  __nv_bfloat16* dq = reinterpret_cast<__nv_bfloat16*>(dw + 16 * BN);
  constexpr int CQ = BN / 8;            // chunks per bf16 row
  for (int i = tid; i < 32 * CQ; i += THREADS) {
    const int r = i / CQ, c = i % CQ;
    const __nv_bfloat16* src =
        (r < 16 ? a.qscale : a.qmin) + (size_t)(t * 16 + (r & 15)) * a.npad;
    cp16(dq + r * BN + c * 8, src + n0 + c * 8, true);
  }
}

// word rows [n2 rows of w2 from r2, n4 rows of w4 from r4] of columns
// n0 .. n0 + BN -> dw [n2 + n4][BN]
template <int BN, int THREADS>
__device__ __forceinline__ void load_words(uint32_t* dw, const Args& a,
                                           int r2, int n2, int r4, int n4,
                                           int n0, int tid) {
  constexpr int CW = BN / 4;
  for (int i = tid; i < (n2 + n4) * CW; i += THREADS) {
    const int r = i / CW, c = i % CW;
    const uint32_t* src = r < n2 ? a.w2 + (size_t)(r2 + r) * a.npad
                                 : a.w4 + (size_t)(r4 + r - n2) * a.npad;
    cp16(dw + r * BN + c * 4, src + n0 + c * 4, true);
  }
}

// x rows m0 .. m0 + rows, columns col0 .. col0 + cols -> dx [rows][stride];
// rows >= B zero
template <int THREADS>
__device__ __forceinline__ void load_x(__nv_bfloat16* dx, const Args& a,
                                       int m0, int rows, int col0, int cols,
                                       int stride, int tid) {
  const int cx = cols / 8;
  for (int i = tid; i < rows * cx; i += THREADS) {
    const int r = i / cx, c = i % cx;
    const bool ok = m0 + r < a.B;
    cp16(dx + r * stride + c * 8,
         ok ? a.x + (size_t)(m0 + r) * a.kp + col0 + c * 8 : a.x, ok);
  }
}

// ---------------------------------------------------------------------------
// B <= 64: codes-major. A block of WARPS warps owns BN = 16 * WARPS output
// columns and BM = 8 * NB batch rows; warp w owns columns w*16 .. +15, in
// the MMA's A rows as: row q (0..7) = column 2q, row q + 8 = column 2q + 1,
// so that a lane's two columns are one 8-byte load of a word row. A step
// is half a k-tile (8 packed blocks): its words and x are staged one step
// ahead, the k-tile's metadata one k-tile ahead, so that two blocks fit
// on an SM.
// ---------------------------------------------------------------------------

template <int NB>
struct Small {
  static constexpr int WARPS = NB == 1 ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BN = 16 * WARPS, BM = 8 * NB;
  static constexpr int HALF = KT / 2;
  static constexpr int XK = HALF + 8;   // x row stride (bf16): ldmatrix
                                        // without conflicts
  static constexpr int WR = 24 + 16;    // word rows per step: w2, w4
  static constexpr size_t STAGE = WR * BN * 4ull + BM * XK * 2ull;
  static constexpr size_t SMEM =
      2 * STAGE + Meta<BN>::BYTES + Table<BN>::BYTES;
};

template <int LAYOUT, int NB>
__global__ void __launch_bounds__(Small<NB>::THREADS, 2)
gemv_small_kernel(const Args a) {
  using P = Small<NB>;
  constexpr int BN = P::BN, BM = P::BM, XK = P::XK, THREADS = P::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* meta_sm = smem + 2 * P::STAGE;
  uint32_t* ts = reinterpret_cast<uint32_t*>(meta_sm + Meta<BN>::BYTES);
  uint8_t* zb = reinterpret_cast<uint8_t*>(ts + G2 * BN);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  const int wc = warp * 16 + 2 * gid;     // this lane's columns wc, wc + 1
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int t0 = blockIdx.z * a.tiles_per_split;
  const int t1 = min(a.n_kt, t0 + a.tiles_per_split);
  const int nsteps = max(t1 - t0, 0) * 2;

  // step s (half h = s % 2 of k-tile t0 + s / 2) -> stage s % 2
  auto load_step = [&](int s) {
    const int t = t0 + s / 2, h = s & 1;
    uint32_t* dw = reinterpret_cast<uint32_t*>(smem + (s & 1) * P::STAGE);
    load_words<BN, THREADS>(dw, a, t * 48 + 24 * h, 24, t * 32 + 16 * h, 16,
                            n0, tid);
    load_x<THREADS>(reinterpret_cast<__nv_bfloat16*>(dw + P::WR * BN), a, m0,
                    BM, t * KT + P::HALF * h, P::HALF, XK, tid);
  };

  uint32_t p4[2], q4[2];
  float s4[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s4[h] = a.smeta4[n0 + wc + h];
    four_consts<LAYOUT>(s4[h], a.smeta4[a.npad + n0 + wc + h], p4[h], q4[h]);
  }
  float acc[NB][4], acc4[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = acc4[nb][e] = 0.f;

  // one chunk of 16 x slots: the fragments c += A . x, or with fold
  // c += s * (A . x) (s0 for column wc, s1 for wc + 1)
  auto chunk = [&](const uint32_t (&am)[4], const __nv_bfloat16* xl,
                   float (&c)[NB][4], bool fold, float s0, float s1) {
#pragma unroll
    for (int h = 0; h < (NB + 1) / 2; ++h) {
      uint32_t b[4];
      if constexpr (NB == 1) {
        uint32_t b2[2];
        ldmatrix(b2, xl);
        b[0] = b2[0];
        b[1] = b2[1];
      } else {
        ldmatrix(b, xl + h * 16 * XK);
      }
#pragma unroll
      for (int u = 0; u < (NB == 1 ? 1 : 2); ++u) {
        float (&cc)[4] = c[2 * h + u];
        if (fold) {
          float part[4];
          mma_zero(part, am, b[2 * u], b[2 * u + 1]);
          // accumulator e: column wc + (e >> 1), batch row 2*tq + (e & 1)
          cc[0] += s0 * part[0];
          cc[1] += s0 * part[1];
          cc[2] += s1 * part[2];
          cc[3] += s1 * part[3];
        } else {
          mma_acc(cc, am, b[2 * u], b[2 * u + 1]);
        }
      }
    }
  };

  if (nsteps > 0) {
    load_meta<BN, THREADS>(meta_sm, a, t0, n0, tid);
    load_step(0);
  }
  cp_commit();
  for (int s = 0; s < nsteps; ++s) {
    const int h = s & 1;
    if (s + 1 < nsteps) {
      load_step(s + 1);
      if (h == 1) load_meta<BN, THREADS>(meta_sm, a, t0 + s / 2 + 1, n0, tid);
    }
    cp_commit();
    cp_wait1();
    __syncthreads();
    if (h == 0) {
      group_table<LAYOUT, BN, THREADS>(meta_sm, ts, zb, tid);
      __syncthreads();
    }
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(
        smem + (s & 1) * P::STAGE);
    // ldmatrix addresses: x rows (lane & 7) (+ 8 for lanes 16..31 when a
    // load covers two row tiles), slots + 8 for lanes 8..15 and 24..31
    const __nv_bfloat16* xl =
        reinterpret_cast<const __nv_bfloat16*>(ws + P::WR * BN)
        + ((lane & 7) + 8 * (NB > 1 ? lane >> 4 : 0)) * XK
        + 8 * ((lane >> 3) & 1);

#pragma unroll 4
    for (int bl = 0; bl < NBLK / 2; ++bl) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int g = 24 * h + 3 * bl + q;    // group of the k-tile
        const uint2 w = *reinterpret_cast<const uint2*>(
            ws + (3 * bl + q) * BN + wc);
        const uint2 sv = *reinterpret_cast<const uint2*>(ts + g * BN + wc);
        const uint32_t z2 = LAYOUT == BFEXP ? 0u
            : *reinterpret_cast<const uint16_t*>(zb + g * BN + wc);
        uint32_t e0, e1, f0, f1, am[4];
        entry_ops<LAYOUT>(sv.x, z2, e0, e1);
        entry_ops<LAYOUT>(sv.y, z2 >> 8, f0, f1);
        operand2<LAYOUT>(w.x, tq, e0, e1, am[0], am[2]);
        operand2<LAYOUT>(w.y, tq, f0, f1, am[1], am[3]);
        chunk(am, xl + 64 * bl + 16 * q, acc, LAYOUT != BFEXP,
              __uint_as_float(sv.x), __uint_as_float(sv.y));
      }
      const uint2 u0 =
          *reinterpret_cast<const uint2*>(ws + (24 + 2 * bl) * BN + wc);
      const uint2 u1 =
          *reinterpret_cast<const uint2*>(ws + (25 + 2 * bl) * BN + wc);
      uint32_t am[4];
      operand4<LAYOUT>(u0.x, u1.x, tq, p4[0], q4[0], am[0], am[2]);
      operand4<LAYOUT>(u0.y, u1.y, tq, p4[1], q4[1], am[1], am[3]);
      if constexpr (LAYOUT == BFEXP)
        chunk(am, xl + 64 * bl + 48, acc, false, 0.f, 0.f);
      else
        chunk(am, xl + 64 * bl + 48, acc4, false, 0.f, 0.f);
    }
    __syncthreads();
  }

  float* o = a.out + (size_t)blockIdx.z * a.B * a.ldo;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + nb * 8 + 2 * tq + (e & 1);
      const int c = n0 + wc + (e >> 1);
      const float v = LAYOUT == BFEXP ? acc[nb][e]
                                      : acc[nb][e] + s4[e >> 1] * acc4[nb][e];
      if (r < a.B && c < a.ncols) o[(size_t)r * a.ldo + c] = v;
    }
}

// ---------------------------------------------------------------------------
// B > 64: group-major. A block owns BM x BN, WGM x WGN warps, each MT m16
// row tiles by NT n8 column tiles. The k-tile's words and metadata are
// staged one k-tile ahead; a step is one packed block (64 columns), whose
// x [BM, 64] is staged one step ahead.
// ---------------------------------------------------------------------------

struct Large {
  static constexpr int BM = 128, BN = 128, WGM = 2, WGN = 4;
  static constexpr int THREADS = 32 * WGM * WGN;
  static constexpr int MT = BM / (16 * WGM), NT = BN / (8 * WGN);
  static constexpr int XS = 64 + 8;     // x row stride (bf16), one block
  static constexpr size_t WSTAGE = WROWS * BN * 4ull + Meta<BN>::BYTES;
  static constexpr size_t XSTAGE = BM * XS * 2ull;
  static constexpr size_t SMEM =
      2 * WSTAGE + 2 * XSTAGE + Table<BN>::BYTES;
};

template <int LAYOUT>
__global__ void __launch_bounds__(Large::THREADS)
gemv_large_kernel(const Args a) {
  using L = Large;
  constexpr int BM = L::BM, BN = L::BN, MT = L::MT, NT = L::NT;
  constexpr int XS = L::XS, THREADS = L::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* xsm = smem + 2 * L::WSTAGE;
  uint32_t* ts = reinterpret_cast<uint32_t*>(xsm + 2 * L::XSTAGE);
  uint8_t* zb = reinterpret_cast<uint8_t*>(ts + G2 * BN);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / L::WGN) * MT * 16;
  const int wn0 = (warp % L::WGN) * NT * 8;
  const int gid = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int t0 = blockIdx.z * a.tiles_per_split;
  const int t1 = min(a.n_kt, t0 + a.tiles_per_split);
  const int nsteps = max(t1 - t0, 0) * NBLK;

  // k-tile t's words [WROWS][BN] and metadata -> stage (t - t0) % 2
  auto wstage = [&](int t) { return smem + ((t - t0) & 1) * L::WSTAGE; };
  auto load_tile = [&](int t) {
    unsigned char* st = wstage(t);
    load_words<BN, THREADS>(reinterpret_cast<uint32_t*>(st), a, t * 48, 48,
                            t * 32, 32, n0, tid);
    load_meta<BN, THREADS>(st + WROWS * BN * 4, a, t, n0, tid);
  };
  // step s's x (block s % 16 of k-tile t0 + s / 16) -> slot s % 2
  auto load_step_x = [&](int s) {
    const int t = t0 + s / NBLK, blk = s % NBLK;
    load_x<THREADS>(
        reinterpret_cast<__nv_bfloat16*>(xsm + (s % 2) * L::XSTAGE), a, m0,
        BM, t * KT + 64 * blk, 64, XS, tid);
  };

  // this lane's B-operand column of tile nt: wn0 + nt*8 + gid
  uint32_t p4[NT], q4[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = n0 + wn0 + nt * 8 + gid;
    four_consts<LAYOUT>(a.smeta4[c], a.smeta4[a.npad + c], p4[nt], q4[nt]);
  }
  float acc[MT][NT][4], acc4[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = acc4[mt][nt][e] = 0.f;

  // one copy group per step: x one step ahead, words one k-tile ahead
  if (nsteps > 0) {
    load_tile(t0);
    load_step_x(0);
  }
  cp_commit();
  for (int s = 0; s < nsteps; ++s) {
    const int t = t0 + s / NBLK, blk = s % NBLK;
    if (s + 1 < nsteps) load_step_x(s + 1);
    if (blk == 0 && t + 1 < t1) load_tile(t + 1);
    cp_commit();
    cp_wait1();
    __syncthreads();
    const unsigned char* st = wstage(t);
    const uint32_t* w2s = reinterpret_cast<const uint32_t*>(st);
    const uint32_t* w4s = w2s + 48 * BN;
    if (blk == 0) {
      group_table<LAYOUT, BN, THREADS>(st + WROWS * BN * 4, ts, zb, tid);
      __syncthreads();
    }
    const __nv_bfloat16* xb =
        reinterpret_cast<const __nv_bfloat16*>(xsm + (s % 2) * L::XSTAGE);

#pragma unroll
    for (int q = 0; q < 4; ++q) {     // groups 3*blk + q, then the 4-bit
      uint32_t am[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix(am[mt], xb + (wm0 + mt * 16 + (lane & 15)) * XS + 16 * q
                             + (lane >> 4) * 8);
      const int g = 3 * blk + q;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int cn = wn0 + nt * 8 + gid;
        uint32_t b0, b1;
        if (q < 3) {
          uint32_t e0, e1;
          entry_ops<LAYOUT>(ts[g * BN + cn],
                            LAYOUT == BFEXP ? 0u : zb[g * BN + cn], e0, e1);
          operand2<LAYOUT>(w2s[g * BN + cn], tq, e0, e1, b0, b1);
          if constexpr (LAYOUT == BFEXP) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_acc(acc[mt][nt], am[mt], b0, b1);
          } else {
            // accumulator e: batch row gid + 8*(e >> 1), column
            // 2*tq + (e & 1)
            const float2 sv = *reinterpret_cast<const float2*>(
                ts + g * BN + wn0 + nt * 8 + 2 * tq);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              float part[4];
              mma_zero(part, am[mt], b0, b1);
              acc[mt][nt][0] += sv.x * part[0];
              acc[mt][nt][1] += sv.y * part[1];
              acc[mt][nt][2] += sv.x * part[2];
              acc[mt][nt][3] += sv.y * part[3];
            }
          }
        } else {
          operand4<LAYOUT>(w4s[(2 * blk) * BN + cn],
                           w4s[(2 * blk + 1) * BN + cn], tq, p4[nt], q4[nt],
                           b0, b1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if constexpr (LAYOUT == BFEXP)
              mma_acc(acc[mt][nt], am[mt], b0, b1);
            else
              mma_acc(acc4[mt][nt], am[mt], b0, b1);
          }
        }
      }
    }
    __syncthreads();
  }

  float* o = a.out + (size_t)blockIdx.z * a.B * a.ldo;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = n0 + wn0 + nt * 8 + 2 * tq;
    const float s4[2] = {a.smeta4[c], a.smeta4[c + 1]};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = m0 + wm0 + mt * 16 + gid;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = r + (e >> 1) * 8, cc = c + (e & 1);
        const float v = LAYOUT == BFEXP
                            ? acc[mt][nt][e]
                            : acc[mt][nt][e] + s4[e & 1] * acc4[mt][nt][e];
        if (rr < a.B && cc < a.ncols) o[(size_t)rr * a.ldo + cc] = v;
      }
    }
  }
}

// x [B, ldx] (f32 or bf16, K valid columns) -> xp [B, kp] bf16, each
// 16-column chunk in the MMA's k-slot order: slot 2i + h holds column
// i + 8h of a 2-bit group, i + 4h + 4*(i >= 4) of a block's 4-bit chunk
// (its fourth chunk); columns >= K are zero.
__global__ void permute_x_kernel(const void* __restrict__ x, int x_f32, int B,
                                 int K, int ldx, int kp,
                                 __nv_bfloat16* __restrict__ xp) {
  const int chunks = kp / 16;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)B * chunks) return;
  const int row = (int)(i / chunks), ch = (int)(i % chunks);
  float v[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = ch * 16 + j;
    const size_t at = (size_t)row * ldx + col;
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    v[j] = col >= K ? 0.f
           : x_f32  ? static_cast<const float*>(x)[at]
                    : __bfloat162float(xb[at]);
  }
  uint32_t o[8];
  auto pair = [&](int c0, int c1) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[c0]))
           | ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[c1]))
              << 16);
  };
  if ((ch & 3) == 3) {
#pragma unroll
    for (int i2 = 0; i2 < 8; ++i2) {
      const int c0 = i2 + 4 * (i2 >= 4);
      o[i2] = pair(c0, c0 + 4);
    }
  } else {
#pragma unroll
    for (int i2 = 0; i2 < 8; ++i2) o[i2] = pair(i2, i2 + 8);
  }
  uint4* dst = reinterpret_cast<uint4*>(xp + (size_t)row * kp + ch * 16);
  dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
  dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// y[b, n] = sum over splits of part[split, b, n], in split order.
__global__ void reduce_splits_kernel(const float* __restrict__ part,
                                     int ksplit, int B, int npad, int O,
                                     float* __restrict__ y) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)B * O) return;
  const int b = (int)(i / O), n = (int)(i % O);
  float s = 0.f;
  for (int k = 0; k < ksplit; ++k) s += part[((size_t)k * B + b) * npad + n];
  y[i] = s;
}

struct Call {
  const void* x;
  int x_f32, B, K, ldx;
  Args a;
  int O, ksplit;
  void *xp, *part, *y;
  cudaStream_t st;
};

template <class Kern>
int launch(Kern kernel, int bm, int bn, int threads, size_t smem, Call c) {
  if (c.a.npad % bn || c.a.npad / bn > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long chunks = (long)c.B * (c.a.kp / 16);
  permute_x_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0, c.st>>>(
      c.x, c.x_f32, c.B, c.K, c.ldx, c.a.kp, (__nv_bfloat16*)c.xp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool split = c.ksplit > 1;
  c.a.out = (float*)(split ? c.part : c.y);
  c.a.ldo = c.a.ncols = split ? c.a.npad : c.O;
  dim3 grid((c.B + bm - 1) / bm, c.a.npad / bn, c.ksplit);
  kernel<<<grid, threads, smem, c.st>>>(c.a);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return (int)err;
  const long total = (long)c.B * c.O;
  reduce_splits_kernel<<<(unsigned)((total + 255) / 256), 256, 0, c.st>>>(
      (const float*)c.part, c.ksplit, c.B, c.a.npad, c.O, (float*)c.y);
  return (int)cudaGetLastError();
}

// tile ids: 0, 1 codes-major with 8, 32 batch rows per block, 2
// group-major with 128
template <int LAYOUT>
int by_tile(int tile, const Call& c) {
  switch (tile) {
    case 0:
      return launch(gemv_small_kernel<LAYOUT, 1>, Small<1>::BM, Small<1>::BN,
                    Small<1>::THREADS, Small<1>::SMEM, c);
    case 1:
      return launch(gemv_small_kernel<LAYOUT, 4>, Small<4>::BM, Small<4>::BN,
                    Small<4>::THREADS, Small<4>::SMEM, c);
    case 2:
      return launch(gemv_large_kernel<LAYOUT>, Large::BM, Large::BN,
                    Large::THREADS, Large::SMEM, c);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

constexpr int TILE_BM_BN[][2] = {{Small<1>::BM, Small<1>::BN},
                                 {Small<4>::BM, Small<4>::BN},
                                 {Large::BM, Large::BN}};
constexpr int NTILES = sizeof(TILE_BM_BN) / sizeof(TILE_BM_BN[0]);

// blocks of a kernel resident on one SM at its shared memory, 0 on error
template <class Kern>
int per_sm(Kern kernel, int threads, size_t smem) {
  int n = 0;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                       smem) != cudaSuccess)
    return 0;
  return n;
}

}  // namespace

// (batch rows, columns, blocks per SM) of each tile id into
// out[3 * id .. 3 * id + 2], for at most n ids; returns the number of ids.
// Blocks per SM are the slab instantiation's (the most registers). The
// wrapper sizes its K split from these.
extern "C" int mxq_gemv_tc_tiles(int* out, int n) {
  const int res[NTILES] = {
      per_sm(gemv_small_kernel<SLAB, 1>, Small<1>::THREADS, Small<1>::SMEM),
      per_sm(gemv_small_kernel<SLAB, 4>, Small<4>::THREADS, Small<4>::SMEM),
      per_sm(gemv_large_kernel<SLAB>, Large::THREADS, Large::SMEM)};
  for (int i = 0; i < NTILES && i < n; ++i) {
    out[3 * i] = TILE_BM_BN[i][0];
    out[3 * i + 1] = TILE_BM_BN[i][1];
    out[3 * i + 2] = res[i];
  }
  return NTILES;
}

// layout 0 slab (K1), 1 quad, 2 bfexp (K6); tile as by_tile numbers them
// (picked by the wrapper from B). x [B, ldx] f32 (x_f32) or bf16, K valid
// columns; w2 ... smeta4 one packed layer, nbp % 16 == 0; xp [B, nbp*64]
// bf16 scratch, 16-byte aligned; part [ksplit, B, npad] f32 scratch (unused
// with one split); y [B, O] f32.
extern "C" int mxq_gemv_tc(int layout, int tile, const void* x, int x_f32,
                           int B, int K, int ldx, const void* w2,
                           const void* w4, const void* meta2,
                           const void* qscale, const void* qmin,
                           const void* smeta4, int nbp, int npad, int O,
                           int tiles_per_split, int ksplit, void* xp,
                           void* part, void* y, void* stream) {
  if (B < 1 || nbp % NBLK || K > nbp * 64 || ksplit < 1 || ksplit > 65535
      || (uintptr_t)xp % 16)
    return (int)cudaErrorInvalidValue;
  Call c{x, x_f32, B, K, ldx,
         Args{(const __nv_bfloat16*)xp, (const uint32_t*)w2,
              (const uint32_t*)w4, (const uint32_t*)meta2,
              (const __nv_bfloat16*)qscale, (const __nv_bfloat16*)qmin,
              (const float*)smeta4, B, nbp * 64, npad, nbp / NBLK,
              tiles_per_split, 0, 0, nullptr},
         O, ksplit, xp, part, y, (cudaStream_t)stream};
  switch (layout) {
    case SLAB: return by_tile<SLAB>(tile, c);
    case QUAD: return by_tile<QUAD>(tile, c);
    case BFEXP: return by_tile<BFEXP>(tile, c);
    default: return (int)cudaErrorInvalidValue;
  }
}
