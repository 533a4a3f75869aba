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
// Bound on the H100: bytes. At one row every packed weight is read once
// (~3.5 bits/weight with the metadata) and feeds one multiply-add, far
// below the ~295 operations per byte the card needs before arithmetic
// limits; the kernel runs at or below the one library call for the same
// function (PERF.md). The design aims at coalesced weight reads and enough
// blocks in flight:
//  * one thread per output column n; a warp reads 32 neighbouring int32
//    words of one packed row (128 contiguous bytes);
//  * the per-group algebra of the reference kernel: for every 16-code
//    group, dot the raw codes with x, then apply s*dot - s*z*sum(x) once,
//    so the per-weight work is shift, mask, convert and one FMA; the 4-bit
//    plane accumulates raw-code dots and applies its per-channel scale and
//    zero once at the end;
//  * x of one 1024-column k-tile is staged in shared memory as f32 (all
//    threads of a warp read the same element: a broadcast), together with
//    its per-group sums;
//  * K is split across blocks (blockIdx.z) in units of packed meta rows
//    (64 input columns each) so that N/128 column blocks still fill the
//    132 SMs; a second pass adds the partial sums in a fixed order
//    (deterministic, no atomics).
// LAYOUT picks how the codes leave their words (K6 is the same loop):
//  * SLAB (K2): one shift, mask and int-to-float convert per code;
//  * QUAD (K6): (word >> 2j) & 0x03030303 yields four codes per shift and
//    mask (byte b holds code j + 4b; 4-bit plane & 0x0F0F0F0F, code
//    j + 2b), and each byte becomes a float by one byte permute into the
//    f32 pattern 0x4B0000cc (= 2^23 + c) and one subtract of 2^23, both
//    exact. The dot then runs in code order, as K2's does, so quad gives
//    K2's sums bit for bit (and the same greedy tokens);
//  * BFEXP (K6): exponent injection, the reference CUDA kernel's LOP3
//    magic-number conversion. ((word >> (2j-5)) & 0x00600060) | 0x3F803F80
//    read as two bf16 is 1 + c/4 for codes j and j+8 (4-bit plane: mask
//    0x00780078, 1 + c/16, codes j and j+4), and each weight is
//    bf16(bf16(4s * (1 + c/4)) - bf16(4s + s*z)): two bf16 roundings, a
//    multiply then a subtract, with no zero-correction term and the 4-bit
//    plane's scale applied per weight. This is a different, lossy
//    function (~2.4% max rel weight error); gemv_bfexp_plain in
//    ops/mxq_matmul.py gives the same weights bit for bit, so only the
//    f32 summation order differs. The TPU's activation permutes
//    (permute_x2_quad/_pair) served Mosaic's sublane bitcasts; here x is
//    read by code position from shared memory instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "device_util.cuh"

constexpr int KT = 1024;        // input columns per k-tile (16 blocks of 64)
constexpr int THREADS = 128;    // columns per block
constexpr int BT = 1;           // batch rows: one
constexpr int SLAB = 0, QUAD = 1, BFEXP = 2;

// byte b of t (a code 0..255) as an exact float: 0x4B0000cc is 2^23 + c
__device__ __forceinline__ float byte_code(uint32_t t, int b) {
  return __uint_as_float(__byte_perm(t, 0x4B000000u, 0x7540u | b))
         - 8388608.f;
}

template <int LAYOUT>
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
  __shared__ float gsum[BT][48];     // sum of x over each 2-bit group
  __shared__ float bsum4[BT][16];    // sum of x over each block's 4-bit part

  const int n = blockIdx.x * THREADS + threadIdx.x;   // npad % 128 == 0
  const int b0 = blockIdx.y * BT;
  const int split = blockIdx.z;
  const int m0 = split * rows_per_split;
  const int m1 = min(nbp, m0 + rows_per_split);

  float acc[BT], acc4[BT], xsum4[BT];
#pragma unroll
  for (int bb = 0; bb < BT; ++bb) acc[bb] = acc4[bb] = xsum4[bb] = 0.f;
  const float s4 = smeta4[n], z4 = smeta4[npad + n];
  // bfexp's 4-bit plane: bf16(16*s4) and bf16(16*s4 + s4*z4), per channel
  uint32_t s16b = 0, b16 = 0;
  if constexpr (LAYOUT == BFEXP) {
    const float s16 = 16.f * s4;
    s16b = bf2_splat(s16);
    b16 = bf2_splat(__fadd_rn(s16, __fmul_rn(s4, z4)));
  }

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
    if constexpr (LAYOUT != BFEXP) {
      for (int i = threadIdx.x; i < BT * 64; i += THREADS) {
        const int bb = i / 64, g = i % 64;
        const float* p = g < 48 ? &xs[bb][64 * (g / 3) + 16 * (g % 3)]
                                : &xs[bb][64 * (g - 48) + 48];
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) s += p[j];
        if (g < 48) gsum[bb][g] = s; else bsum4[bb][g - 48] = s;
      }
      __syncthreads();
    }

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
        if constexpr (LAYOUT == BFEXP) {
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
        } else {
          const float s = qs * sc + qm;
          float dot[BT];
#pragma unroll
          for (int bb = 0; bb < BT; ++bb) dot[bb] = 0.f;
          if constexpr (LAYOUT == QUAD) {
            uint32_t tj[4];           // code c in byte c / 4 of tj[c % 4]
#pragma unroll
            for (int j = 0; j < 4; ++j)
              tj[j] = (word >> (2 * j)) & 0x03030303u;
#pragma unroll
            for (int c = 0; c < 16; ++c) {
              const float v = byte_code(tj[c % 4], c / 4);
#pragma unroll
              for (int bb = 0; bb < BT; ++bb) dot[bb] += xs[bb][off + c] * v;
            }
          } else {
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const float c = (float)((word >> (2 * j)) & 3u);
#pragma unroll
              for (int bb = 0; bb < BT; ++bb) dot[bb] += xs[bb][off + j] * c;
            }
          }
#pragma unroll
          for (int bb = 0; bb < BT; ++bb)
            acc[bb] += s * dot[bb] - s * zc * gsum[bb][g];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t word = w4[(size_t)(2 * mm + h) * npad + n];
        const int off = 64 * r + 48 + 8 * h;
        if constexpr (LAYOUT == BFEXP) {
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
        } else if constexpr (LAYOUT == QUAD) {
          // code c in byte c / 2 of tj[c % 2]
          const uint32_t tj[2] = {word & 0x0F0F0F0Fu,
                                  (word >> 4) & 0x0F0F0F0Fu};
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const float v = byte_code(tj[c % 2], c / 2);
#pragma unroll
            for (int bb = 0; bb < BT; ++bb) acc4[bb] += xs[bb][off + c] * v;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float c = (float)((word >> (4 * j)) & 15u);
#pragma unroll
            for (int bb = 0; bb < BT; ++bb) acc4[bb] += xs[bb][off + j] * c;
          }
        }
      }
      if constexpr (LAYOUT != BFEXP) {
#pragma unroll
        for (int bb = 0; bb < BT; ++bb) xsum4[bb] += bsum4[bb][r];
      }
    }
    m = mend;
  }

#pragma unroll
  for (int bb = 0; bb < BT; ++bb) {
    const int row = b0 + bb;
    if (row < B)
      part[((size_t)split * B + row) * npad + n] =
          LAYOUT == BFEXP ? acc[bb]
                          : acc[bb] + s4 * acc4[bb] - s4 * z4 * xsum4[bb];
  }
}

// y[b, n] = sum over splits of part[split, b, n], in split order.
__global__ void reduce_splits_kernel(const float* __restrict__ part,
                                     int ksplit, int B, int npad, int O,
                                     float* __restrict__ y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * O) return;
  const int b = i / O, n = i % O;
  float s = 0.f;
  for (int k = 0; k < ksplit; ++k) s += part[((size_t)k * B + b) * npad + n];
  y[i] = s;
}

template <int LAYOUT>
int launch(const void* x, int B, int K, int ldx, const void* w2,
           const void* w4, const void* meta2, const void* qscale,
           const void* qmin, const void* smeta4, int nbp, int npad, int O,
           int rows_per_split, int ksplit, void* part, void* y,
           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(npad / THREADS, B, ksplit);
  mxq_gemv_kernel<LAYOUT><<<grid, THREADS, 0, st>>>(
      (const __nv_bfloat16*)x, B, K, ldx, (const uint32_t*)w2,
      (const uint32_t*)w4, (const uint32_t*)meta2,
      (const __nv_bfloat16*)qscale, (const __nv_bfloat16*)qmin,
      (const float*)smeta4, nbp, npad, rows_per_split, (float*)part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = B * O;
  reduce_splits_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      (const float*)part, ksplit, B, npad, O, (float*)y);
  return (int)cudaGetLastError();
}

}  // namespace

#define MXQ_GEMV_ENTRY(NAME, LAYOUT)                                         \
  int NAME(const void* x, int B, int K, int ldx, const void* w2,           \
           const void* w4, const void* meta2, const void* qscale,          \
           const void* qmin, const void* smeta4, int nbp, int npad, int O, \
           int rows_per_split, int ksplit, void* part, void* y,            \
           void* stream) {                                                 \
    return launch<LAYOUT>(x, B, K, ldx, w2, w4, meta2, qscale, qmin,       \
                          smeta4, nbp, npad, O, rows_per_split, ksplit,    \
                          part, y, stream);                                \
  }

extern "C" {

// K2 and K6's one-row entries: one block row per batch row.
MXQ_GEMV_ENTRY(mxq_gemv_k2, SLAB)
MXQ_GEMV_ENTRY(mxq_gemv_k6_quad1, QUAD)
MXQ_GEMV_ENTRY(mxq_gemv_k6_bfexp1, BFEXP)

}  // extern "C"
