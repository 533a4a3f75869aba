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
// mxq_gemv_kernel is K6's bfexp layout at one row (BFEXP), one thread per
// column: exponent injection, the reference CUDA kernel's LOP3
// magic-number conversion. ((word >> (2j-5)) & 0x00600060) | 0x3F803F80
// read as two bf16 is 1 + c/4 for codes j and j+8 (4-bit plane: mask
// 0x00780078, 1 + c/16, codes j and j+4), and each weight is
// bf16(bf16(4s * (1 + c/4)) - bf16(4s + s*z)): two bf16 roundings, a
// multiply then a subtract, with no zero-correction term and the 4-bit
// plane's scale applied per weight. This is a different, lossy function
// (~2.4% max rel weight error); gemv_bfexp_plain in ops/mxq_matmul.py
// gives the same weights bit for bit, so only the f32 summation order
// differs. The TPU's activation permutes (permute_x2_quad/_pair) served
// Mosaic's sublane bitcasts; here x is read by code position from shared
// memory instead.

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

// mxq_gemv_kernel's (bfexp) geometry: one thread per column, sized for
// two blocks per SM, one batch row per block row
constexpr int THREADS = 128;
constexpr int BT = 1;
constexpr int BFEXP_BLOCKS_PER_SM = 2;

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

// K6's bfexp layout at one row: one thread per column n (the loop K2 and
// K6 shared before gemv_row_kernel, kept as it was)
__global__ void __launch_bounds__(THREADS)
mxq_gemv_kernel(const __nv_bfloat16* __restrict__ x, int B, int K, int ldx,
                const uint32_t* __restrict__ w2,
                const uint32_t* __restrict__ w4,
                const uint32_t* __restrict__ meta2,
                const __nv_bfloat16* __restrict__ qscale,
                const __nv_bfloat16* __restrict__ qmin,
                const float* __restrict__ smeta4,
                int nbp, int npad, int rows_per_split,
                float* __restrict__ part) {
  __shared__ float xs[BT][KT];

  const int n = blockIdx.x * THREADS + threadIdx.x;   // npad % 128 == 0
  const int b0 = blockIdx.y * BT;
  const int split = blockIdx.z;
  const int m0 = split * rows_per_split;
  const int m1 = min(nbp, m0 + rows_per_split);

  float acc[BT];
#pragma unroll
  for (int bb = 0; bb < BT; ++bb) acc[bb] = 0.f;
  const float s4 = smeta4[n], z4 = smeta4[npad + n];
  // the 4-bit plane: bf16(16*s4) and bf16(16*s4 + s4*z4), per channel
  const float s16 = 16.f * s4;
  const uint32_t s16b = bf2_splat(s16);
  const uint32_t b16 = bf2_splat(__fadd_rn(s16, __fmul_rn(s4, z4)));

  for (int m = m0; m < m1;) {
    const int t = m / 16;
    const int mend = min(m1, (t + 1) * 16);
    __syncthreads();
    for (int i = threadIdx.x; i < BT * KT; i += THREADS) {
      const int bb = i / KT, c = i % KT;
      const int row = b0 + bb, col = t * KT + c;
      xs[bb][c] = (row < B && col < K)
                      ? __bfloat162float(x[(size_t)row * ldx + col]) : 0.f;
    }
    __syncthreads();

    for (int mm = m; mm < mend; ++mm) {
      const int r = mm - t * 16;
      const size_t mo = (size_t)mm * npad + n;
      const uint32_t meta = meta2[mo];
      const float qs = __bfloat162float(qscale[mo]);
      const float qm = __bfloat162float(qmin[mo]);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int g = 16 * i + r;                     // group within tile
        const float zc = (float)((meta >> (2 * i)) & 3u);
        const float sc = (float)((meta >> (6 + 8 * i)) & 255u);
        const uint32_t word = w2[(size_t)(t * 48 + g) * npad + n];
        const int off = 64 * (g / 3) + 16 * (g % 3);  // x column in tile
        // s, 4s and 4s + s*z rounded as the plain version rounds them
        const float s = __fadd_rn(__fmul_rn(qs, sc), qm);
        const float s4x = 4.f * s;
        const uint32_t s2 = bf2_splat(s4x);
        const uint32_t z2 = bf2_splat(__fadd_rn(s4x, __fmul_rn(s, zc)));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t tj = 2 * j >= 5 ? word >> (2 * j - 5)
                                         : word << (5 - 2 * j);
          const uint32_t pb = (tj & 0x00600060u) | 0x3F803F80u;
          const uint32_t w = bf2_sub(bf2_mul(s2, pb), z2);
          const float wlo = __uint_as_float(w << 16);      // code j
          const float whi = __uint_as_float(w & 0xFFFF0000u);  // j + 8
#pragma unroll
          for (int bb = 0; bb < BT; ++bb)
            acc[bb] += xs[bb][off + j] * wlo + xs[bb][off + j + 8] * whi;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t word = w4[(size_t)(2 * mm + h) * npad + n];
        const int off = 64 * r + 48 + 8 * h;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t tj = 4 * j >= 3 ? word >> (4 * j - 3)
                                         : word << (3 - 4 * j);
          const uint32_t pb = (tj & 0x00780078u) | 0x3F803F80u;
          const uint32_t w = bf2_sub(bf2_mul(s16b, pb), b16);
          const float wlo = __uint_as_float(w << 16);      // code j
          const float whi = __uint_as_float(w & 0xFFFF0000u);  // j + 4
#pragma unroll
          for (int bb = 0; bb < BT; ++bb)
            acc[bb] += xs[bb][off + j] * wlo + xs[bb][off + j + 4] * whi;
        }
      }
    }
    m = mend;
  }

#pragma unroll
  for (int bb = 0; bb < BT; ++bb) {
    const int row = b0 + bb;
    if (row < B) part[((size_t)split * B + row) * npad + n] = acc[bb];
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

template <int LAYOUT>
int launch_row(const void* x, int B, int K, int ldx, const void* w2,
               const void* w4, const void* meta2, const void* qscale,
               const void* qmin, const void* smeta4, int nbp, int npad,
               int O, int rows_per_split, int ksplit, void* part, void* y,
               void* stream) {
  if (B < 1 || B > 65535 || npad % ROW_COLS || K > nbp * 64
      || !valid_split(nbp, rows_per_split, ksplit) || !aligned16(w2)
      || !aligned16(w4) || !aligned16(meta2) || (uintptr_t)qscale % 8
      || (uintptr_t)qmin % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = row_smem(rows_per_split);
  cudaError_t err = cudaFuncSetAttribute(
      gemv_row_kernel<LAYOUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(npad / ROW_COLS, B, ksplit);
  gemv_row_kernel<LAYOUT><<<grid, ROW_THREADS, smem, st>>>(
      (const __nv_bfloat16*)x, K, ldx, (const uint32_t*)w2,
      (const uint32_t*)w4, (const uint32_t*)meta2,
      (const __nv_bfloat16*)qscale, (const __nv_bfloat16*)qmin,
      (const float*)smeta4, nbp, npad, rows_per_split, (float*)part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_splits(part, ksplit, B, npad, O, y, st);
}

int launch_bfexp(const void* x, int B, int K, int ldx, const void* w2,
                 const void* w4, const void* meta2, const void* qscale,
                 const void* qmin, const void* smeta4, int nbp, int npad,
                 int O, int rows_per_split, int ksplit, void* part, void* y,
                 void* stream) {
  if (B < 1 || B > 65535 || npad % THREADS || K > nbp * 64
      || !valid_split(nbp, rows_per_split, ksplit))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(npad / THREADS, B, ksplit);
  mxq_gemv_kernel<<<grid, THREADS, 0, st>>>(
      (const __nv_bfloat16*)x, B, K, ldx, (const uint32_t*)w2,
      (const uint32_t*)w4, (const uint32_t*)meta2,
      (const __nv_bfloat16*)qscale, (const __nv_bfloat16*)qmin,
      (const float*)smeta4, nbp, npad, rows_per_split, (float*)part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_splits(part, ksplit, B, npad, O, y, st);
}

}  // namespace

#define MXQ_GEMV_ENTRY(NAME, LAUNCH)                                         \
  int NAME(const void* x, int B, int K, int ldx, const void* w2,           \
           const void* w4, const void* meta2, const void* qscale,          \
           const void* qmin, const void* smeta4, int nbp, int npad, int O, \
           int rows_per_split, int ksplit, void* part, void* y,            \
           void* stream) {                                                 \
    return LAUNCH(x, B, K, ldx, w2, w4, meta2, qscale, qmin, smeta4, nbp,  \
                  npad, O, rows_per_split, ksplit, part, y, stream);       \
  }

extern "C" {

// K2 and K6's one-row entries: one block row per batch row. x [B, ldx]
// bf16, K valid columns; w2 ... smeta4 one packed layer; part [ksplit, B,
// npad] f32 scratch; y [B, O] f32. rows_per_split from mxq_gemv_tiles'
// geometry (ops/mxq_matmul._split_rows).
MXQ_GEMV_ENTRY(mxq_gemv_k2, launch_row<SLAB>)
MXQ_GEMV_ENTRY(mxq_gemv_k6_quad1, launch_row<QUAD>)
MXQ_GEMV_ENTRY(mxq_gemv_k6_bfexp1, launch_bfexp)

// (columns per block, warps per block that split its meta rows, blocks
// per SM) of gemv_row_kernel (K2, K6-quad; the card's occupancy at one
// k-tile of x, 0 on error) and of mxq_gemv_kernel (bfexp: one K slice per
// block, sized for two blocks per SM), in that order. Returns the count.
int mxq_gemv_tiles(int* out, int n) {
  int per_sm = 0;
  const size_t smem = row_smem(NB_TILE);
  if (cudaFuncSetAttribute(gemv_row_kernel<SLAB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, gemv_row_kernel<SLAB>, ROW_THREADS, smem)
             != cudaSuccess)
    per_sm = 0;
  const int tiles[2][3] = {{ROW_COLS, ROW_WARPS, per_sm},
                           {THREADS, 1, BFEXP_BLOCKS_PER_SM}};
  for (int i = 0; i < 2 && i < n; ++i)
    for (int j = 0; j < 3; ++j) out[3 * i + j] = tiles[i][j];
  return 2;
}

}  // extern "C"
