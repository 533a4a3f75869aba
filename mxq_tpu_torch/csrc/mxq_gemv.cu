// K2 and K6 at one row: y = x @ dequant(p) for the packed MXQ format
// (packfmt.py), x rounded to bf16, f32 accumulation. The B >= 2 kernels
// (K1, K6) are the tensor-core template in mxq_gemv_tc.cu.
//
// Replaces the TPU kernels
//   K2  mxq_tpu/ops/mxq_matmul.py _bdg_kernel (:360) via
//       _mxq_matmul_bdg_padded (:429) and _stacked_bdg_kernel (:1096) —
//       the exact B=1 GEMV;
//   K6  _kernel_body_quad (:169) and _kernel_body_bfexp (:252) at one row
//       (MXQ_GEMV_LAYOUT_B1=quad|bfexp).
// A stacked weight is only a layer offset: the wrapper passes the layer's
// base pointers.
//
// Bound on the H100: bytes, by the roofline. At one row every packed
// weight is read once (~3.5 bits/weight with the metadata) and feeds one
// multiply-add, far below the ~295 operations per byte the card needs
// before the tensor cores limit. On the CUDA cores, though, each weight
// costs an unpack, a convert and an FMA: gemv_row_kernel's loop is ~5.5
// (quad) to ~6.4 (slab) SASS instructions per weight, ~38 M warp
// instructions for a llama2_7b layer's 204.5 M weights, so instruction
// issue, not the 27 us byte bound, sets its time (PERF.md).
//
// gemv_row_kernel (K2 = SLAB, K6-quad = QUAD) is laid out for the card's
// memory pipeline:
//  * each lane owns 4 adjacent output columns, so each packed row is read
//    with 16-byte loads (w2's three words, w4's two words and meta2 of one
//    meta row: one uint4 each; qscale and qmin: 8 bytes each) and a warp's
//    load is 512 contiguous bytes; a block is ROW_WARPS warps over the same
//    128 columns that split the block's meta rows in contiguous runs;
//  * the next meta row's words are loaded into registers before the
//    current row's arithmetic, and a warp's first row is in flight while
//    the block stages x;
//  * K is split across blocks (blockIdx.z) in meta rows (64 input columns
//    each): a split is a divisor of 16 rows or a multiple of 16, so it
//    never straddles a k-tile; the wrapper sizes it from mxq_gemv_tiles so
//    that the blocks fill every SM;
//  * x of the split's k-tiles is staged once as f32 in shared memory, 8
//    columns a thread, with the sum of every 16-column chunk ((x0 + .. +
//    x7) + (x8 + .. + x15), in that order): a k-tile's 48 two-bit group
//    sums and 16 four-bit block sums, behind one barrier; x is then read
//    by 16-byte broadcast loads, each value serving the lane's 4 columns;
//  * the per-group algebra of the reference kernel: for every 16-code
//    group, dot the raw codes with x, then add s*dot - s*z*sum(x) once;
//    the 4-bit plane accumulates raw-code dots and takes its per-channel
//    scale and zero at the end of the split;
//  * the warps' partial sums are added in warp order in shared memory;
//    a second pass adds the splits in split order (deterministic, no
//    atomics).
// No code is converted by an int-to-float instruction: code c becomes the
// f32 pattern 0x4B0000cc (= 2^23 + c) less 2^23, both exact. LAYOUT is how
// the codes leave their word:
//  * SLAB (K2): one shift and one mask-or per code;
//  * QUAD (K6): (word >> 2j) & 0x03030303 yields four codes per shift and
//    mask (byte b holds code j + 4b; 4-bit plane & 0x0F0F0F0F, code
//    j + 2b), and one byte permute puts each byte into 0x4B0000cc. The
//    floats, and the order they are summed in, are slab's, so quad gives
//    K2's sums bit for bit (and the same greedy tokens).
//
// bfexp_row_kernel is K6's bfexp layout at one row (BFEXP), on the tensor
// cores. bfexp is a different, lossy function (~2.4% max rel weight
// error): each weight is bf16(bf16(4s * (1 + c/4)) - bf16(4s + s*z)), two
// bf16 roundings, a multiply then a subtract (4-bit plane: bf16(16*s4),
// bf16(16*s4 + s4*z4) and 1 + c/16), with the group's scale inside the
// weight and no separate 4-bit epilogue; gemv_bfexp_plain in
// ops/mxq_matmul.py gives the same weights bit for bit, so only the f32
// summation order differs. The weights are bf16 by definition, so a lane
// builds them as mma.sync m16n8k16's A operand (bfexp_pair, device_util.cuh:
// a rotate, a mask-or that reads as 1 + c/4 in bf16, a bf16x2 multiply and
// subtract: 2 instructions a weight) and the tensor cores multiply them by
// x, the B operand, in f32: ~4.4 SASS instructions a weight in all, where
// the CUDA-core design (FFMA, gemv_row_kernel's lanes) took 5.6. The map:
//  * the lanes (gid, tq) of a quad share 4 adjacent output columns n0 ..
//    n0 + 3 (n0 = block's first + 4 gid), each read as 16 bytes; MMA tile
//    A's rows gid, gid + 8 are columns n0, n0 + 1, tile B's n0 + 2, n0 + 3,
//    so a lane multiplies only words it read;
//  * a meta row's four 16-code k-chunks go to the quad's four lanes: lane
//    tq < 3 takes 2-bit group 16 tq + r of the row's k-tile (one w2 word a
//    column), lane 3 the row's 4-bit chunk (two w4 words a column);
//  * a lane's eight registers of a column hold, low half first, codes
//    (2i+1, 2i+9) for i < 4 and (2i-8, 2i) for i >= 4 of its 2-bit word
//    (the word, then the word rotated by 2, each rotated by 3 - 4(i % 4));
//    4-bit: codes (i, i+4) of the first word, then (i-4, i) of the second,
//    by the same rotations with the 4-bit mask, so that every lane runs
//    the same instructions; register i is k-slot pair (2tq, 2tq+1) of MMA
//    i / 2 for even i, (2tq+8, 2tq+9) for odd i;
//  * x of the block's split is staged once in shared memory as bf16 pairs
//    in that order (bf_stage_pairs: a 16-column chunk read as 16 bytes
//    twice and byte-permuted in registers), 128 bytes a meta row, lane tq's
//    32 (register i's pair at 4i), read by two 16-byte broadcast loads per
//    row; B's eight columns all hold x, and C's column 0 is kept;
//  * the memory pipeline: warps split the block's meta rows in contiguous
//    runs; each warp keeps the next BF_STAGES - 1 of its rows in flight,
//    copied by cp.async into its own ring in shared memory (a row of the
//    block's 32 columns is 896 bytes, 2 chunks of 16 a lane), and reads a
//    row's words from there; blocks split K (blockIdx.z) in whole meta rows
//    that never straddle a k-tile, sized from mxq_gemv_tiles' geometry; the
//    warps' sums are added in warp order, a second pass adds the splits in
//    split order (deterministic, no atomics).
// The group's entry (s, then bf16(4s) and bf16(4s + s*z), packed in one
// word whose halves the bf16x2 multiply and subtract read as operand
// selectors) is decoded once per column and group by the lane that uses
// it; lane 3 takes the column's 4-bit entry from registers. At one row the
// kernel is bound by instruction issue and per-call latency, not bytes
// (PERF.md). The TPU's activation permutes (permute_x2_quad/_pair) served
// Mosaic's sublane bitcasts; here x's slot order is the staging's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "device_util.cuh"

constexpr int KT = 1024;        // input columns per k-tile (16 blocks of 64)
constexpr int NB_TILE = 16;     // meta rows per k-tile
constexpr int SLAB = 0, QUAD = 1;

// gemv_row_kernel's geometry (reported by mxq_gemv_tiles)
constexpr int ROW_WARPS = 8;                 // warps per block, splitting K
constexpr int ROW_THREADS = 32 * ROW_WARPS;
constexpr int ROW_COLS = 128;                // columns per block: 4 a lane
constexpr int ROW_MIN_BLOCKS = 2;            // launch bound: blocks per SM

// bfexp_row_kernel's geometry (reported by mxq_gemv_tiles)
constexpr int BF_WARPS = 4;                  // warps per block, splitting K
constexpr int BF_THREADS = 32 * BF_WARPS;
constexpr int BF_COLS = 32;                  // columns per block: 4 a quad
constexpr int BF_STAGES = 4;                 // a warp's ring of meta rows
constexpr int BF_MIN_BLOCKS = 8;             // launch bound: blocks per SM
// a warp's meta row in its ring: w2's 3 word rows, w4's 2, meta2 (128
// bytes each), qscale, qmin (64 each)
constexpr int BF_ROW_BYTES = 7 * 128;

// k-tiles of x a split of rows_per_split meta rows stages
__host__ __device__ constexpr int row_tiles(int rows_per_split) {
  return rows_per_split >= NB_TILE ? rows_per_split / NB_TILE : 1;
}

// dynamic shared memory of gemv_row_kernel: x and its chunk sums per
// k-tile, then the warps' partial sums
size_t row_smem(int rows_per_split) {
  return (size_t)row_tiles(rows_per_split) * (KT + 64) * 4
         + (size_t)ROW_WARPS * (2 * ROW_COLS + 1) * 4;
}

// The codes' floats are built on magic = 0x4B000000 (2^23) held in a
// register. A literal would let ptxas put it in the permute's immediate
// slot, with the selector in a register that it then rematerialises for
// every permute (~230 moves per meta row), and split each slab mask-or
// into two LOP3s: gemv_row_kernel computes magic from an argument.

// byte b of t (a code 0..255) as an exact float: 0x4B0000cc is 2^23 + c
__device__ __forceinline__ float byte_code(uint32_t t, int b,
                                           uint32_t magic) {
  return __uint_as_float(__byte_perm(t, magic, 0x7540u | b)) - 8388608.f;
}

// a small field f (0 <= f < 2^23) as an exact float, the same pattern
__device__ __forceinline__ float field_code(uint32_t f, uint32_t magic) {
  return __uint_as_float(f | magic) - 8388608.f;
}

// one meta row's packed words for a lane's 4 columns
struct Row {
  uint4 w2[3], w4[2], meta;
  uint2 qs, qm;   // 4 bf16 each
};

__device__ __forceinline__ Row load_row(
    const uint32_t* __restrict__ w2, const uint32_t* __restrict__ w4,
    const uint32_t* __restrict__ meta2,
    const __nv_bfloat16* __restrict__ qscale,
    const __nv_bfloat16* __restrict__ qmin, int mm, int npad, int n0) {
  const int t = mm / NB_TILE, r = mm % NB_TILE;
  Row w;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    w.w2[i] = __ldg(reinterpret_cast<const uint4*>(
        w2 + (size_t)(t * 48 + 16 * i + r) * npad + n0));
#pragma unroll
  for (int h = 0; h < 2; ++h)
    w.w4[h] = __ldg(reinterpret_cast<const uint4*>(
        w4 + (size_t)(2 * mm + h) * npad + n0));
  const size_t mo = (size_t)mm * npad + n0;
  w.meta = __ldg(reinterpret_cast<const uint4*>(meta2 + mo));
  w.qs = __ldg(reinterpret_cast<const uint2*>(qscale + mo));
  w.qm = __ldg(reinterpret_cast<const uint2*>(qmin + mo));
  return w;
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// bf16 number c of 4 packed in a uint2, as f32 (exact)
__device__ __forceinline__ float bf16_of(const uint2& v, int c) {
  const uint32_t w = c < 2 ? v.x : v.y;
  return __uint_as_float(c & 1 ? w & 0xFFFF0000u : w << 16);
}

// the 16 codes of a 2-bit word, code j at bits 2j, as exact floats
template <int LAYOUT>
__device__ __forceinline__ void codes2(uint32_t w, uint32_t magic,
                                       float (&v)[16]) {
  if constexpr (LAYOUT == QUAD) {
    uint32_t tq[4];               // code j in byte j / 4 of tq[j % 4]
#pragma unroll
    for (int k = 0; k < 4; ++k) tq[k] = (w >> (2 * k)) & 0x03030303u;
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = byte_code(tq[j % 4], j / 4, magic);
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      v[j] = field_code((w >> (2 * j)) & 3u, magic);
  }
}

// the 8 codes of a 4-bit word, code j at bits 4j, as exact floats
template <int LAYOUT>
__device__ __forceinline__ void codes4(uint32_t w, uint32_t magic,
                                       float (&v)[8]) {
  if constexpr (LAYOUT == QUAD) {
    // code j in byte j / 2 of tq[j % 2]
    const uint32_t tq[2] = {w & 0x0F0F0F0Fu, (w >> 4) & 0x0F0F0F0Fu};
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = byte_code(tq[j % 2], j / 2, magic);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = field_code((w >> (4 * j)) & 15u, magic);
  }
}

template <int N>
__device__ __forceinline__ void load_x(const float* p, float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = f.x, v[4 * q + 1] = f.y, v[4 * q + 2] = f.z,
    v[4 * q + 3] = f.w;
  }
}

// one meta row (k-tile row r) into the lane's sums; xt is the row's
// k-tile of x in shared memory, ct its 64 chunk sums
template <int LAYOUT>
__device__ __forceinline__ void row_sums(const Row& w, int r, const float* xt,
                                         const float* ct, float (&acc)[4],
                                         float (&acc4)[4], float& xsum4,
                                         uint32_t magic) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int g = 16 * i + r;                        // group within tile
    const int chunk = 4 * (g / 3) + g % 3;           // its 16 x columns
    float xv[16];
    load_x(xt + 16 * chunk, xv);
    const float gs = ct[chunk];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v[16];
      codes2<LAYOUT>(word_of(w.w2[i], c), magic, v);
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) dot += xv[j] * v[j];
      const uint32_t m = word_of(w.meta, c);
      const float zc = field_code((m >> (2 * i)) & 3u, magic);
      const float sc = field_code((m >> (6 + 8 * i)) & 255u, magic);
      const float s = bf16_of(w.qs, c) * sc + bf16_of(w.qm, c);
      acc[c] += s * dot - s * zc * gs;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float xv[8];
    load_x(xt + 64 * r + 48 + 8 * h, xv);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v[8];
      codes4<LAYOUT>(word_of(w.w4[h], c), magic, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc4[c] += xv[j] * v[j];
    }
  }
  xsum4 += ct[4 * r + 3];
}

template <int LAYOUT>
__global__ void __launch_bounds__(ROW_THREADS, ROW_MIN_BLOCKS)
gemv_row_kernel(const __nv_bfloat16* __restrict__ x, int K, int ldx,
                const uint32_t* __restrict__ w2,
                const uint32_t* __restrict__ w4,
                const uint32_t* __restrict__ meta2,
                const __nv_bfloat16* __restrict__ qscale,
                const __nv_bfloat16* __restrict__ qmin,
                const float* __restrict__ smeta4, int nbp, int npad,
                int rows_per_split, float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  const int tiles = row_tiles(rows_per_split);
  float* xs = reinterpret_cast<float*>(smem4);      // [tiles][KT]
  float* csum = xs + tiles * KT;                    // [tiles][64]
  float* red = csum + tiles * 64;                   // [warps][2][ROW_COLS]
  float* red4 = red + ROW_WARPS * 2 * ROW_COLS;     // [warps]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * ROW_COLS + 4 * lane;
  const int split = blockIdx.z;
  const int m0 = split * rows_per_split;
  const int m1 = min(nbp, m0 + rows_per_split);
  const int t0 = m0 / NB_TILE;
  // this warp's run of meta rows
  const int per_warp = (rows_per_split + ROW_WARPS - 1) / ROW_WARPS;
  const int mb = min(m1, m0 + warp * per_warp);
  const int me = min(m1, m0 + (warp + 1) * per_warp);
  const uint32_t magic = 0x4B000000u | ((uint32_t)npad >> 31);  // npad >= 0

  Row cur;
  if (mb < me) cur = load_row(w2, w4, meta2, qscale, qmin, mb, npad, n0);

  // x of the split's k-tiles as f32, 8 columns a thread, and the sum of
  // every 16 columns: lane pairs (2c, 2c+1) hold chunk c's two halves
  const __nv_bfloat16* xr = x + (size_t)blockIdx.y * ldx;
  const int nx = ((m1 - 1) / NB_TILE - t0 + 1) * (KT / 8);
  const bool vec = (K % 8) == 0 && ((uintptr_t)xr % 16) == 0;
  for (int i = threadIdx.x; i < nx; i += ROW_THREADS) {
    const int col = t0 * KT + 8 * i;
    float v[8];
    if (vec) {
      const uint4 q = col < K ? *reinterpret_cast<const uint4*>(xr + col)
                              : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t qw[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[2 * e] = __uint_as_float(qw[e] << 16);
        v[2 * e + 1] = __uint_as_float(qw[e] & 0xFFFF0000u);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = col + e < K ? __bfloat162float(xr[col + e]) : 0.f;
    }
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) s += v[e];
    float4* dst = reinterpret_cast<float4*>(xs + 8 * i);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    // nx is a multiple of 128: every lane of a warp is in the loop
    const float other = __shfl_xor_sync(0xffffffffu, s, 1);
    if ((i & 1) == 0) csum[i / 2] = s + other;
  }
  __syncthreads();

  float acc[4] = {0.f, 0.f, 0.f, 0.f}, acc4[4] = {0.f, 0.f, 0.f, 0.f};
  float xsum4 = 0.f;
#pragma unroll 1
  for (int mm = mb; mm < me; ++mm) {
    Row nxt;
    if (mm + 1 < me)
      nxt = load_row(w2, w4, meta2, qscale, qmin, mm + 1, npad, n0);
    const int tt = mm / NB_TILE - t0;
    row_sums<LAYOUT>(cur, mm % NB_TILE, xs + tt * KT, csum + tt * 64, acc,
                     acc4, xsum4, magic);
    cur = nxt;
  }

  // the warps' sums, added in warp order; thread n < 128 takes column n
  float* ra = red + warp * 2 * ROW_COLS;
  reinterpret_cast<float4*>(ra)[lane] =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
  reinterpret_cast<float4*>(ra + ROW_COLS)[lane] =
      make_float4(acc4[0], acc4[1], acc4[2], acc4[3]);
  if (lane == 0) red4[warp] = xsum4;
  __syncthreads();
  if (threadIdx.x < ROW_COLS) {
    float a = 0.f, a4 = 0.f, x4 = 0.f;
#pragma unroll
    for (int ww = 0; ww < ROW_WARPS; ++ww) {
      a += red[ww * 2 * ROW_COLS + threadIdx.x];
      a4 += red[(ww * 2 + 1) * ROW_COLS + threadIdx.x];
      x4 += red4[ww];
    }
    const int n = blockIdx.x * ROW_COLS + threadIdx.x;
    const float s4 = smeta4[n], z4 = smeta4[npad + n];
    part[((size_t)split * gridDim.y + blockIdx.y) * npad + n] =
        a + s4 * a4 - s4 * z4 * x4;
  }
}

// dynamic shared memory of bfexp_row_kernel: x of the split as bf16 pairs
// in slot order (128 bytes a meta row), the warps' rings of meta rows,
// then the warps' partial sums
size_t bf_smem(int rows_per_split) {
  return (size_t)rows_per_split * 128
         + (size_t)BF_WARPS * BF_STAGES * BF_ROW_BYTES
         + (size_t)BF_WARPS * BF_COLS * 4;
}

// one meta row's packed words for lane (gid, tq) of bfexp_row_kernel, for
// its 4 columns: wa and wb the same w2 word row (group 16 tq + r; tq < 3)
// or the 4-bit plane's two w4 rows (tq == 3), then the meta row
struct BfRow {
  uint4 wa, wb, meta;
  uint2 qs, qm;   // 4 bf16 each
};

// Lane l's part of copying a warp's meta rows into its ring: chunk ch = l,
// then l + 32 (< 56), of each row, 16 bytes at byte 16 ch of the slot:
// ch / 8 < 3 w2 row 16 (ch / 8) + r of k-tile t, then w4 rows 2 mm, 2 mm
// + 1, meta2 row mm (8 chunks each), qscale, qmin row mm (4 each); chunk c
// of a row holds the block's columns 4c .. 4c + 3 (words) or 8c .. 8c + 7
// (bf16). A cursor points at its chunk of the next row to fetch.
struct BfCursor {
  const char* p;
  int step, extra;   // bytes to the next row; more after a k-tile's last
};

__device__ __forceinline__ BfCursor bf_cursor(
    int ch, const uint32_t* w2, const uint32_t* w4, const uint32_t* meta2,
    const __nv_bfloat16* qscale, const __nv_bfloat16* qmin, int npad,
    int nblk, int mm) {
  const int t = mm / NB_TILE, r = mm % NB_TILE, c = ch % 8;
  const int wp = 4 * npad;
  if (ch < 24)
    return {reinterpret_cast<const char*>(
                w2 + (size_t)(48 * t + r + 16 * (ch / 8)) * npad + nblk
                + 4 * c), wp, 32 * wp};
  if (ch < 40)
    return {reinterpret_cast<const char*>(
                w4 + (size_t)(2 * mm + (ch - 24) / 8) * npad + nblk + 4 * c),
            2 * wp, 0};
  if (ch < 48)
    return {reinterpret_cast<const char*>(meta2 + (size_t)mm * npad + nblk
                                          + 4 * c), wp, 0};
  const __nv_bfloat16* q = ch < 52 ? qscale : qmin;
  return {reinterpret_cast<const char*>(q + (size_t)mm * npad + nblk
                                        + 8 * (ch % 4)), 2 * npad, 0};
}

// cp.async of this lane's chunks of meta row mm (the cursors' next) into a
// ring slot; the cursors move to row mm + 1
__device__ __forceinline__ void bf_fetch(char* slot, BfCursor (&cu)[2],
                                         int nck, int lane, int mm) {
  const bool tile_end = (mm + 1) % NB_TILE == 0;
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (k < nck) {
      cp16(slot + 16 * (lane + 32 * k), cu[k].p, true);
      cu[k].p += cu[k].step + (tile_end ? cu[k].extra : 0);
    }
}

// lane (gid, tq)'s words of a ring slot
__device__ __forceinline__ BfRow bf_read(const char* slot, int gid, int tq) {
  const int oa = tq < 3 ? 128 * tq : 384, ob = tq < 3 ? oa : 512;
  BfRow w;
  w.wa = *reinterpret_cast<const uint4*>(slot + oa + 16 * gid);
  w.wb = *reinterpret_cast<const uint4*>(slot + ob + 16 * gid);
  w.meta = *reinterpret_cast<const uint4*>(slot + 640 + 16 * gid);
  w.qs = *reinterpret_cast<const uint2*>(slot + 768 + 8 * gid);
  w.qm = *reinterpret_cast<const uint2*>(slot + 832 + 8 * gid);
  return w;
}

// c += a . b: m16n8k16, bf16 in, f32 out
__device__ __forceinline__ void mma_acc(float (&c)[4], uint32_t a0,
                                        uint32_t a1, uint32_t a2, uint32_t a3,
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Lane tq's x pairs of meta row mm (its 8 registers' slots): a 16-column
// chunk of x, 2-bit group g = 16 tq + r's (tq < 3) or the block's 4-bit
// chunk (tq == 3), loaded as 8 words of column pairs (2c, 2c + 1) and
// permuted into the registers' code pairs: 2-bit (2i+1, 2i+9) for i < 4,
// (2i-8, 2i) for i >= 4; 4-bit (i, i+4), then (i+4, i+8). Columns >= K are
// zero.
__device__ __forceinline__ void bf_stage_pairs(const __nv_bfloat16* xr,
                                               int K, bool vec, int mm,
                                               int tq, uint32_t* dst) {
  const int t = mm / NB_TILE, r = mm % NB_TILE, g = 16 * tq + r;
  const int col = t * KT + (tq == 3 ? 64 * r + 48
                                    : 64 * (g / 3) + 16 * (g % 3));
  uint32_t w[8];
  if (vec) {
    const uint4 lo = col < K ? *reinterpret_cast<const uint4*>(xr + col)
                             : make_uint4(0u, 0u, 0u, 0u);
    const uint4 hi = col + 8 < K
                         ? *reinterpret_cast<const uint4*>(xr + col + 8)
                         : make_uint4(0u, 0u, 0u, 0u);
    w[0] = lo.x, w[1] = lo.y, w[2] = lo.z, w[3] = lo.w;
    w[4] = hi.x, w[5] = hi.y, w[6] = hi.z, w[7] = hi.w;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = col + 2 * k;
      w[k] = (c < K ? (uint32_t)__bfloat16_as_ushort(xr[c]) : 0u)
             | (c + 1 < K ? (uint32_t)__bfloat16_as_ushort(xr[c + 1]) << 16
                          : 0u);
    }
  }
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t two_hi = __byte_perm(w[i], w[i + 4], 0x7632u);
    const uint32_t two_lo = __byte_perm(w[i], w[i + 4], 0x5410u);
    const uint32_t four_x = __byte_perm(w[i >> 1], w[(i >> 1) + 2],
                                        i & 1 ? 0x7632u : 0x5410u);
    const uint32_t four_y = __byte_perm(w[4 + (i >> 1)], w[6 + (i >> 1)],
                                        i & 1 ? 0x7632u : 0x5410u);
    o[i] = tq == 3 ? four_x : two_hi;
    o[i + 4] = tq == 3 ? four_y : two_lo;
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

__global__ void __launch_bounds__(BF_THREADS, BF_MIN_BLOCKS)
bfexp_row_kernel(const __nv_bfloat16* __restrict__ x, int K, int ldx,
                 const uint32_t* __restrict__ w2,
                 const uint32_t* __restrict__ w4,
                 const uint32_t* __restrict__ meta2,
                 const __nv_bfloat16* __restrict__ qscale,
                 const __nv_bfloat16* __restrict__ qmin,
                 const float* __restrict__ smeta4, int nbp, int npad,
                 int rows_per_split, float* __restrict__ part) {
  extern __shared__ uint4 smem_bf[];
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem_bf);  // [rows][4][8]
  char* rings = reinterpret_cast<char*>(
      smem_bf + rows_per_split * 8);                    // [warps][stages]
  float* red = reinterpret_cast<float*>(
      rings + BF_WARPS * BF_STAGES * BF_ROW_BYTES);     // [warps][BF_COLS]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * BF_COLS + 4 * gid;
  const int split = blockIdx.z;
  const int m0 = split * rows_per_split;
  const int m1 = min(nbp, m0 + rows_per_split);
  const int per_warp = (rows_per_split + BF_WARPS - 1) / BF_WARPS;
  const int mb = min(m1, m0 + warp * per_warp);
  const int me = min(m1, m0 + (warp + 1) * per_warp);

  // the lane's part of the mapping: lane 3 the 4-bit chunk, the others a
  // 2-bit group's fields of the meta word; a 2-bit lane keeps its decoded
  // entries (keep), lane 3 takes its columns' 4-bit entries (pq)
  const bool four = tq == 3;
  const uint32_t mask = four ? 0x00780078u : 0x00600060u;
  const uint32_t keep = four ? 0u : ~0u;
  const int rot_b = four ? 0 : 2;
  const int zsh = 2 * tq, ssh = 6 + 8 * tq;
  uint32_t pq[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float s4 = smeta4[n0 + c], z4 = smeta4[npad + n0 + c];
    pq[c] = four ? bfexp_entry(16.f * s4, __fmul_rn(s4, z4)) : 0u;
  }

  // the warp's ring: row mm in slot (mm - mb) % BF_STAGES, the first
  // BF_STAGES - 1 rows in flight while the block stages x; one copy group
  // per row
  char* ring = rings + warp * BF_STAGES * BF_ROW_BYTES;
  const int nck = lane + 32 < 56 ? 2 : 1;
  BfCursor cu[2] = {
      bf_cursor(lane, w2, w4, meta2, qscale, qmin, npad,
                blockIdx.x * BF_COLS, mb),
      bf_cursor(nck == 2 ? lane + 32 : 55, w2, w4, meta2, qscale, qmin, npad,
                blockIdx.x * BF_COLS, mb)};
#pragma unroll
  for (int d = 0; d < BF_STAGES - 1; ++d) {
    if (mb + d < me) bf_fetch(ring + d * BF_ROW_BYTES, cu, nck, lane, mb + d);
    cp_commit();
  }

  // x of the split's meta rows as bf16 pairs in slot order, a lane's 8
  // pairs of a row a thread per round
  const __nv_bfloat16* xr = x + (size_t)blockIdx.y * ldx;
  const bool vec = (K % 8) == 0 && ((uintptr_t)xr % 16) == 0;
  for (int i = threadIdx.x; i < (m1 - m0) * 4; i += BF_THREADS)
    bf_stage_pairs(xr, K, vec, m0 + i / 4, i % 4, xs + 8 * i);
  __syncthreads();

  // tile A: rows gid, gid + 8 = columns n0, n0 + 1; tile B: n0 + 2, n0 + 3
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 1
  for (int mm = mb; mm < me; ++mm) {
    const int j = mm - mb;
    if (mm + BF_STAGES - 1 < me)
      bf_fetch(ring + (j + BF_STAGES - 1) % BF_STAGES * BF_ROW_BYTES, cu,
               nck, lane, mm + BF_STAGES - 1);
    cp_commit();
    cp_wait<BF_STAGES - 1>();
    __syncwarp();
    const BfRow cur = bf_read(ring + j % BF_STAGES * BF_ROW_BYTES, gid, tq);
    const uint4* xp = reinterpret_cast<const uint4*>(xs + (mm - m0) * 32
                                                     + tq * 8);
    const uint4 xa = xp[0], xb = xp[1];
    const uint32_t xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
    uint32_t a[4][8];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t m = word_of(cur.meta, c);
      const float z = field_code((m >> zsh) & 3u, 0x4B000000u);
      const float sc = field_code((m >> ssh) & 255u, 0x4B000000u);
      const float s = __fadd_rn(__fmul_rn(bf16_of(cur.qs, c), sc),
                                bf16_of(cur.qm, c));
      const uint32_t pe =
          (bfexp_entry(4.f * s, __fmul_rn(s, z)) & keep) | pq[c];
      // its halves, each in both halves (ptxas folds these moves into the
      // bf16x2 multiply's and subtract's operand selectors)
      const __nv_bfloat162 pb = *reinterpret_cast<const __nv_bfloat162*>(&pe);
      const __nv_bfloat162 e0b = __low2bfloat162(pb);
      const __nv_bfloat162 e1b = __high2bfloat162(pb);
      const uint32_t e0 = *reinterpret_cast<const uint32_t*>(&e0b);
      const uint32_t e1 = *reinterpret_cast<const uint32_t*>(&e1b);
      const uint32_t wa = word_of(cur.wa, c);
      const uint32_t wb = rotl(word_of(cur.wb, c), rot_b);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[c][i] = bfexp_pair(wa, 3 - 4 * i, mask, e0, e1);
        a[c][i + 4] = bfexp_pair(wb, 3 - 4 * i, mask, e0, e1);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mma_acc(acc[h], a[2 * h][2 * q], a[2 * h + 1][2 * q],
                a[2 * h][2 * q + 1], a[2 * h + 1][2 * q + 1], xv[2 * q],
                xv[2 * q + 1]);
    __syncwarp();   // the slot is read before a later copy refills it
  }

  // the warps' sums, added in warp order; thread n < 32 takes column n.
  // C's row gid is acc[.][0], row gid + 8 acc[.][2] (x in every column)
  if (tq == 0)
    reinterpret_cast<float4*>(red + warp * BF_COLS)[gid] =
        make_float4(acc[0][0], acc[0][2], acc[1][0], acc[1][2]);
  __syncthreads();
  if (threadIdx.x < BF_COLS) {
    float v = 0.f;
#pragma unroll
    for (int ww = 0; ww < BF_WARPS; ++ww)
      v += red[ww * BF_COLS + threadIdx.x];
    part[((size_t)split * gridDim.y + blockIdx.y) * npad
         + blockIdx.x * BF_COLS + threadIdx.x] = v;
  }
}

// y[b, n] = sum over splits of part[split, b, n], in split order.
__global__ void gemv_row_sum_kernel(const float* __restrict__ part,
                                    int ksplit, int B, int npad, int O,
                                    float* __restrict__ y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * O) return;
  const int b = i / O, n = i % O;
  float s = 0.f;
  for (int k = 0; k < ksplit; ++k) s += part[((size_t)k * B + b) * npad + n];
  y[i] = s;
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// the split is whole: a divisor of 16 rows or a multiple of 16, and
// ksplit splits of it cover nbp
bool valid_split(int nbp, int rows_per_split, int ksplit) {
  return rows_per_split >= 1 && nbp % NB_TILE == 0
         && (rows_per_split >= NB_TILE ? rows_per_split % NB_TILE == 0
                                       : NB_TILE % rows_per_split == 0)
         && ksplit == (nbp + rows_per_split - 1) / rows_per_split
         && ksplit <= 65535;
}

int sum_splits(const void* part, int ksplit, int B, int npad, int O,
               void* y, cudaStream_t st) {
  const int total = B * O;
  gemv_row_sum_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      (const float*)part, ksplit, B, npad, O, (float*)y);
  return (int)cudaGetLastError();
}

// a one-row kernel of cols columns and threads threads a block, then the
// split sum
template <class Kern>
int launch_one_row(Kern kernel, int cols, int threads, size_t smem,
                   const void* x, int B, int K, int ldx, const void* w2,
                   const void* w4, const void* meta2, const void* qscale,
                   const void* qmin, const void* smeta4, int nbp, int npad,
                   int O, int rows_per_split, int ksplit, void* part,
                   void* y, void* stream) {
  if (B < 1 || B > 65535 || npad % cols || K > nbp * 64
      || !valid_split(nbp, rows_per_split, ksplit) || !aligned16(w2)
      || !aligned16(w4) || !aligned16(meta2) || !aligned16(qscale)
      || !aligned16(qmin))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(npad / cols, B, ksplit);
  kernel<<<grid, threads, smem, st>>>(
      (const __nv_bfloat16*)x, K, ldx, (const uint32_t*)w2,
      (const uint32_t*)w4, (const uint32_t*)meta2,
      (const __nv_bfloat16*)qscale, (const __nv_bfloat16*)qmin,
      (const float*)smeta4, nbp, npad, rows_per_split, (float*)part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_splits(part, ksplit, B, npad, O, y, st);
}

#define ONE_ROW_ARGS                                                       \
  x, B, K, ldx, w2, w4, meta2, qscale, qmin, smeta4, nbp, npad, O,        \
      rows_per_split, ksplit, part, y, stream
#define ONE_ROW_PARAMS                                                     \
  const void *x, int B, int K, int ldx, const void *w2, const void *w4,   \
      const void *meta2, const void *qscale, const void *qmin,            \
      const void *smeta4, int nbp, int npad, int O, int rows_per_split,   \
      int ksplit, void *part, void *y, void *stream

template <int LAYOUT>
int launch_row(ONE_ROW_PARAMS) {
  return launch_one_row(gemv_row_kernel<LAYOUT>, ROW_COLS, ROW_THREADS,
                        row_smem(rows_per_split), ONE_ROW_ARGS);
}

int launch_bfexp(ONE_ROW_PARAMS) {
  return launch_one_row(bfexp_row_kernel, BF_COLS, BF_THREADS,
                        bf_smem(rows_per_split), ONE_ROW_ARGS);
}

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

#define MXQ_GEMV_ENTRY(NAME, LAUNCH) \
  int NAME(ONE_ROW_PARAMS) { return LAUNCH(ONE_ROW_ARGS); }

extern "C" {

// K2 and K6's one-row entries: one block row per batch row. x [B, ldx]
// bf16, K valid columns; w2 ... smeta4 one packed layer; part [ksplit, B,
// npad] f32 scratch; y [B, O] f32. rows_per_split from mxq_gemv_tiles'
// geometry (ops/mxq_matmul._split_rows).
MXQ_GEMV_ENTRY(mxq_gemv_k2, launch_row<SLAB>)
MXQ_GEMV_ENTRY(mxq_gemv_k6_quad1, launch_row<QUAD>)
MXQ_GEMV_ENTRY(mxq_gemv_k6_bfexp1, launch_bfexp)

// (columns per block, warps per block that split its meta rows, blocks
// per SM) of gemv_row_kernel (K2, K6-quad) and of bfexp_row_kernel
// (K6-bfexp), in that order: blocks per SM by the card's occupancy at one
// k-tile of x, 0 on error. Returns the count.
int mxq_gemv_tiles(int* out, int n) {
  const int tiles[2][3] = {
      {ROW_COLS, ROW_WARPS,
       per_sm(gemv_row_kernel<SLAB>, ROW_THREADS, row_smem(NB_TILE))},
      {BF_COLS, BF_WARPS,
       per_sm(bfexp_row_kernel, BF_THREADS, bf_smem(NB_TILE))}};
  for (int i = 0; i < 2 && i < n; ++i)
    for (int j = 0; j < 3; ++j) out[3 * i + j] = tiles[i][j];
  return 2;
}

}  // extern "C"
