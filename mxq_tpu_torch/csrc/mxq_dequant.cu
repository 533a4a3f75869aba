// K3: unpack both planes of a packed MXQ linear (packfmt.py) to bf16
// weights in natural plane order, for the prefill GEMMs
// y = x2 @ wd2 + x4 @ wd4 that follow it (torch.matmul, as XLA had them).
// K5 (second kernel below): the same planes requantized to int8 per output
// column, for the int8 prefill GEMMs of mxq_matmul_prefill_a8.
//
// Replaces the TPU kernel mxq_tpu/ops/mxq_matmul.py _dequant_kernel (:713)
// via _dequant_pallas (:751), used by mxq_matmul_prefill (:787). The TPU
// wrote slab-order rows to suit its sublanes; here row word*16 + j of wd2
// is code j of w2 row `word` (and likewise 8 codes per w4 word), so the
// activations need no permutation.
//
// Values: w = s*c - s*z with s = qscale*code8 + qmin (2-bit groups) or the
// per-channel 4-bit scale, rounded once to bf16 — the TPU kernel's order of
// operations. This file is compiled with --fmad=false so that no multiply
// and add fuse: the result equals the plain PyTorch version bit for bit.
//
// Bound on the H100: bytes. It reads ~2.9 bits and writes 16 bits per
// weight. One thread per (packed word, column): a warp reads 32
// neighbouring words of one packed row and writes 32 neighbouring bf16 of
// each of the 16 (or 8) output rows, so every access is coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
mxq_dequant_kernel(const uint32_t* __restrict__ w2,
                   const uint32_t* __restrict__ w4,
                   const uint32_t* __restrict__ meta2,
                   const __nv_bfloat16* __restrict__ qscale,
                   const __nv_bfloat16* __restrict__ qmin,
                   const float* __restrict__ smeta4, int nbp, int npad,
                   __nv_bfloat16* __restrict__ wd2,
                   __nv_bfloat16* __restrict__ wd4) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= npad) return;
  const int word = blockIdx.y;                 // w2 rows first, then w4 rows
  if (word < nbp * 3) {
    const int t = word / 48, g = word % 48;
    const int i = g / 16, r = g % 16;
    const size_t mo = (size_t)(t * 16 + r) * npad + n;
    const uint32_t meta = meta2[mo];
    const float zc = (float)((meta >> (2 * i)) & 3u);
    const float sc = (float)((meta >> (6 + 8 * i)) & 255u);
    const float s = __bfloat162float(qscale[mo]) * sc
                    + __bfloat162float(qmin[mo]);
    const float sz = s * zc;
    const uint32_t w = w2[(size_t)word * npad + n];
    __nv_bfloat16* out = wd2 + (size_t)word * 16 * npad + n;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float c = (float)((w >> (2 * j)) & 3u);
      out[(size_t)j * npad] = __float2bfloat16_rn(s * c - sz);
    }
  } else {
    const int w4row = word - nbp * 3;
    const float s4 = smeta4[n];
    const float sz4 = s4 * smeta4[npad + n];
    const uint32_t w = w4[(size_t)w4row * npad + n];
    __nv_bfloat16* out = wd4 + (size_t)w4row * 8 * npad + n;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float c = (float)((w >> (4 * j)) & 15u);
      out[(size_t)j * npad] = __float2bfloat16_rn(s4 * c - sz4);
    }
  }
}

// K5: replaces the TPU kernel mxq_tpu/ops/mxq_matmul.py
// _dequant_int8_kernel (:856) via _dequant_int8_pallas (:879), used by
// mxq_matmul_prefill_a8 (:924). Each weight is (s*c - s*z) * inv[n] in f32,
// in the TPU kernel's order (mxq_matmul.py:858-875), rounded half to even
// to int8; inv is 1 / the closed-form per-column bound of
// _int8_weight_scale, so the codes lie in [-127, 127]. The planes are in
// natural plane order, as K3's (the int32 GEMM is exact, so the order of
// its terms cannot change y), but stored transposed, q2t [N, NBP*48] and
// q4t [N, NBP*16]: the card's int8 GEMM (torch._int_mm) takes its second
// operand column-major. --fmad=false keeps each rounding of the plain
// version.
//
// Bound on the H100: bytes. It reads ~2.9 bits and writes 8 bits per
// weight, half of K3's writes. One thread per (packed word, column), as
// K3: reads of a packed row are coalesced across a warp; each thread
// stores its 16 (or 8) codes, contiguous in the transposed plane, as one
// 16-byte (8-byte) write.
__global__ void __launch_bounds__(THREADS)
mxq_dequant_int8_kernel(const uint32_t* __restrict__ w2,
                        const uint32_t* __restrict__ w4,
                        const uint32_t* __restrict__ meta2,
                        const __nv_bfloat16* __restrict__ qscale,
                        const __nv_bfloat16* __restrict__ qmin,
                        const float* __restrict__ smeta4,
                        const float* __restrict__ inv, int nbp, int npad,
                        int8_t* __restrict__ q2t, int8_t* __restrict__ q4t) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= npad) return;
  const int word = blockIdx.y;                 // w2 rows first, then w4 rows
  const float iv = inv[n];
  if (word < nbp * 3) {
    const int t = word / 48, g = word % 48;
    const int i = g / 16, r = g % 16;
    const size_t mo = (size_t)(t * 16 + r) * npad + n;
    const uint32_t meta = meta2[mo];
    const float zc = (float)((meta >> (2 * i)) & 3u);
    const float sc = (float)((meta >> (6 + 8 * i)) & 255u);
    const float s = __bfloat162float(qscale[mo]) * sc
                    + __bfloat162float(qmin[mo]);
    const float sz = s * zc;
    const uint32_t w = w2[(size_t)word * npad + n];
    uint32_t b[4] = {0u, 0u, 0u, 0u};      // code j in byte j
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float c = (float)((w >> (2 * j)) & 3u);
      const int v = __float2int_rn((s * c - sz) * iv);
      b[j / 4] |= ((uint32_t)v & 0xFFu) << (8 * (j % 4));
    }
    *reinterpret_cast<uint4*>(q2t + (size_t)n * nbp * 48 + word * 16) =
        make_uint4(b[0], b[1], b[2], b[3]);
  } else {
    const int w4row = word - nbp * 3;
    const float s4 = smeta4[n];
    const float sz4 = s4 * smeta4[npad + n];
    const uint32_t w = w4[(size_t)w4row * npad + n];
    uint32_t b[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float c = (float)((w >> (4 * j)) & 15u);
      const int v = __float2int_rn((s4 * c - sz4) * iv);
      b[j / 4] |= ((uint32_t)v & 0xFFu) << (8 * (j % 4));
    }
    *reinterpret_cast<uint2*>(q4t + (size_t)n * nbp * 16 + w4row * 8) =
        make_uint2(b[0], b[1]);
  }
}

}  // namespace

extern "C" int mxq_dequant_k3(const void* w2, const void* w4,
                              const void* meta2, const void* qscale,
                              const void* qmin, const void* smeta4, int nbp,
                              int npad, void* wd2, void* wd4, void* stream) {
  dim3 grid((npad + THREADS - 1) / THREADS, nbp * 5);
  mxq_dequant_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)w2, (const uint32_t*)w4, (const uint32_t*)meta2,
      (const __nv_bfloat16*)qscale, (const __nv_bfloat16*)qmin,
      (const float*)smeta4, nbp, npad, (__nv_bfloat16*)wd2,
      (__nv_bfloat16*)wd4);
  return (int)cudaGetLastError();
}

extern "C" int mxq_dequant_k5(const void* w2, const void* w4,
                              const void* meta2, const void* qscale,
                              const void* qmin, const void* smeta4,
                              const void* inv, int nbp, int npad, void* q2t,
                              void* q4t, void* stream) {
  dim3 grid((npad + THREADS - 1) / THREADS, nbp * 5);
  mxq_dequant_int8_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)w2, (const uint32_t*)w4, (const uint32_t*)meta2,
      (const __nv_bfloat16*)qscale, (const __nv_bfloat16*)qmin,
      (const float*)smeta4, (const float*)inv, nbp, npad, (int8_t*)q2t,
      (int8_t*)q4t);
  return (int)cudaGetLastError();
}
