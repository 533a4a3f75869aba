// K3: unpack both planes of a packed MXQ linear (packfmt.py) to bf16
// weights in natural plane order, for the prefill GEMMs
// y = x2 @ wd2 + x4 @ wd4 that follow it (torch.matmul, as XLA had them).
// K5 (the kernels below it): the same weights requantized to int8 per
// output column, in x's padded order, for the one int8 GEMM of
// mxq_matmul_prefill_a8.
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
// K3's bound on the H100: bytes. It reads ~2.9 bits and writes 16 bits per
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
// _dequant_int8_kernel (:856) via _dequant_int8_pallas (:879), and the
// closed-form bound _int8_weight_scale (:836) that mxq_matmul_prefill_a8
// (:924) computes around it. Two kernels, one call:
//   k5_scale_kernel  sw[n] = max(max over n's 2-bit groups of
//                    |s| * max(z, 3 - z), |s4| * max(z4, 15 - z4)) / 127,
//                    clamped to 1e-12: reads only the meta (~1 bit a weight)
//   k5_codes_kernel  q[n, b*64 + i] = round_half_even((s*c - s*z) * inv[n])
//                    with inv = 1 / sw[n], in x's padded order: block b's
//                    48 2-bit codes (words 3b..3b+2 of w2), then its 16
//                    4-bit codes (w4 rows 2b, 2b+1), so that q.t() is the
//                    column-major operand of one int8 GEMM against x.
// Each multiply, add and division is rounded once as in the plain version
// (--fmad=false, IEEE division): the outputs are equal bit for bit.
//
// Bound on the H100: bytes (~3.5 bits read, 8 bits written a weight).
// A codes block owns 32 columns (a lane each) of one k-tile (1024 inputs):
// its packed words are read with loads coalesced across the columns; a
// 2-bit group's four possible codes are computed once and its 16 codes
// looked up by byte permutes (the 4-bit plane's 16 per column likewise),
// so the arithmetic stays off the critical path; the codes are staged in
// shared memory as [column][k] and each column's 1024 bytes are written
// as two contiguous 512-byte warp stores.

constexpr int K5_COLS = 32;            // columns of a block: one a lane
constexpr int K5_WARPS = 8;
constexpr int K5_THREADS = K5_COLS * K5_WARPS;
constexpr int K5_PITCH = 256 + 4;      // 32-bit words a column in shared
                                       // memory: 1024 codes and a pad that
                                       // spreads 16-byte stores over banks

// the bound: 16 warps of a block split the meta rows of its 32 columns,
// four rows' loads in flight a warp
constexpr int K5_SCALE_WARPS = 16;

__global__ void __launch_bounds__(K5_SCALE_WARPS * 32)
k5_scale_kernel(const uint32_t* __restrict__ meta2,
                const __nv_bfloat16* __restrict__ qscale,
                const __nv_bfloat16* __restrict__ qmin,
                const float* __restrict__ smeta4, int nbp, int npad,
                float* __restrict__ sw) {
  __shared__ float part[K5_SCALE_WARPS][K5_COLS];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n = blockIdx.x * K5_COLS + lane;
  float m = 0.f;                        // every term is >= +0
#pragma unroll 4
  for (int r = warp; r < nbp; r += K5_SCALE_WARPS) {
    const size_t o = (size_t)r * npad + n;
    const uint32_t meta = meta2[o];
    const float qs = __bfloat162float(qscale[o]);
    const float qm = __bfloat162float(qmin[o]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float zc = (float)((meta >> (2 * i)) & 3u);
      const float sc = (float)((meta >> (6 + 8 * i)) & 255u);
      const float s = qs * sc + qm;
      m = fmaxf(m, fabsf(s) * fmaxf(zc, 3.f - zc));
    }
  }
  part[warp][lane] = m;
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int w = 1; w < K5_SCALE_WARPS; ++w) m = fmaxf(m, part[w][lane]);
  const float s4 = smeta4[n], z4 = smeta4[npad + n];
  m = fmaxf(m, fabsf(s4) * fmaxf(z4, 15.f - z4));
  sw[n] = fmaxf(m / 127.f, 1e-12f);
}

// the int8 code of v, rounded half to even, in the low byte
__device__ __forceinline__ uint32_t code_byte(float v) {
  return (uint32_t)__float2int_rn(v) & 0xFFu;
}

// four code bytes, a in byte 0
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040u), __byte_perm(c, d, 0x0040u),
                     0x5410u);
}

// 2-bit codes 8h..8h+7 of word w (code j at bits 2j) looked up in the
// group's table t (byte c = the int8 code of 2-bit code c): two words,
// code 8h in the low byte of the first
__device__ __forceinline__ uint2 lookup2(uint32_t t, uint32_t w, int h) {
  const uint32_t ws = w >> (16 * h);
  const uint32_t ev = __byte_perm(t, 0u, ws & 0x3333u);         // 0, 2, 4, 6
  const uint32_t od = __byte_perm(t, 0u, (ws >> 2) & 0x3333u);  // 1, 3, 5, 7
  return make_uint2(__byte_perm(ev, od, 0x5140u),
                    __byte_perm(ev, od, 0x7362u));
}

// 4-bit codes 4h..4h+3 of word w (code j at bits 4j) looked up in the
// column's table t[0..3] (byte c of the 16 = the int8 code of 4-bit code
// c): the low three bits pick a byte of t[0..1] and of t[2..3], the top
// bit picks between them
__device__ __forceinline__ uint32_t lookup4(const uint32_t (&t)[4],
                                            uint32_t w, int h) {
  const uint32_t ws = w >> (16 * h);
  const uint32_t lo = __byte_perm(t[0], t[1], ws & 0x7777u);
  const uint32_t hi = __byte_perm(t[2], t[3], ws & 0x7777u);
  const uint32_t top = __byte_perm(0u, 0xFFFFFFFFu, (ws >> 1) & 0x4444u);
  return (lo & ~top) | (hi & top);
}

__global__ void __launch_bounds__(K5_THREADS)
k5_codes_kernel(const uint32_t* __restrict__ w2,
                const uint32_t* __restrict__ w4,
                const uint32_t* __restrict__ meta2,
                const __nv_bfloat16* __restrict__ qscale,
                const __nv_bfloat16* __restrict__ qmin,
                const float* __restrict__ smeta4,
                const float* __restrict__ sw, int nbp, int npad,
                int8_t* __restrict__ q) {
  __shared__ __align__(16) uint32_t tile[K5_COLS * K5_PITCH];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n = blockIdx.x * K5_COLS + lane;
  const int kt = blockIdx.y;
  // Warp `warp` takes meta rows r = warp and warp + 8 of the k-tile: the
  // six 2-bit groups 16i + r (i < 3) of those rows, and the 4-bit words of
  // blocks warp and warp + 8. Every load first, then the arithmetic.
  uint32_t meta[2], wv[2][3], w4v[2][2];
  float qs[2], qm[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp + 8 * h;
    const size_t mo = (size_t)(kt * 16 + r) * npad + n;
    meta[h] = meta2[mo];
    qs[h] = __bfloat162float(qscale[mo]);
    qm[h] = __bfloat162float(qmin[mo]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      wv[h][i] = w2[(size_t)(kt * 48 + 16 * i + r) * npad + n];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      w4v[h][j] = w4[(size_t)(kt * 32 + 2 * r + j) * npad + n];
  }
  const float iv = 1.f / sw[n];
  const float s4 = smeta4[n];
  const float sz4 = s4 * smeta4[npad + n];

  uint32_t* col = tile + lane * K5_PITCH;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp + 8 * h;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float zc = (float)((meta[h] >> (2 * i)) & 3u);
      const float sc = (float)((meta[h] >> (6 + 8 * i)) & 255u);
      const float s = qs[h] * sc + qm[h];
      const float sz = s * zc;
      const uint32_t t = pack4(code_byte((s * 0.f - sz) * iv),
                               code_byte((s * 1.f - sz) * iv),
                               code_byte((s * 2.f - sz) * iv),
                               code_byte((s * 3.f - sz) * iv));
      const int g = 16 * i + r;          // word g: inputs 16(g%3) of block g/3
      const uint2 a = lookup2(t, wv[h][i], 0), b = lookup2(t, wv[h][i], 1);
      *reinterpret_cast<uint4*>(col + (g / 3) * 16 + (g % 3) * 4) =
          make_uint4(a.x, a.y, b.x, b.y);
    }
  }
  uint32_t t4[4];
#pragma unroll
  for (int c = 0; c < 16; c += 4)
    t4[c / 4] = pack4(code_byte((s4 * (float)c - sz4) * iv),
                      code_byte((s4 * (float)(c + 1) - sz4) * iv),
                      code_byte((s4 * (float)(c + 2) - sz4) * iv),
                      code_byte((s4 * (float)(c + 3) - sz4) * iv));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int blk = warp + 8 * h;        // inputs 48..63 of block blk
    *reinterpret_cast<uint4*>(col + blk * 16 + 12) = make_uint4(
        lookup4(t4, w4v[h][0], 0), lookup4(t4, w4v[h][0], 1),
        lookup4(t4, w4v[h][1], 0), lookup4(t4, w4v[h][1], 1));
  }
  __syncthreads();
  // each warp writes 4 columns' 1024 contiguous bytes, 512 at a time
  const size_t row = (size_t)nbp * 64;
  int8_t* out = q + (size_t)blockIdx.x * K5_COLS * row + (size_t)kt * 1024;
#pragma unroll
  for (int c = warp; c < K5_COLS; c += K5_WARPS)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<uint4*>(out + c * row + half * 512 + lane * 16) =
          *reinterpret_cast<const uint4*>(tile + c * K5_PITCH + half * 128
                                          + lane * 4);
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
                              const void* qmin, const void* smeta4, int nbp,
                              int npad, void* sw, void* q, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  k5_scale_kernel<<<npad / K5_COLS, K5_SCALE_WARPS * 32, 0, st>>>(
      (const uint32_t*)meta2, (const __nv_bfloat16*)qscale,
      (const __nv_bfloat16*)qmin, (const float*)smeta4, nbp, npad,
      (float*)sw);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  k5_codes_kernel<<<dim3(npad / K5_COLS, nbp / 16), K5_THREADS, 0, st>>>(
      (const uint32_t*)w2, (const uint32_t*)w4, (const uint32_t*)meta2,
      (const __nv_bfloat16*)qscale, (const __nv_bfloat16*)qmin,
      (const float*)smeta4, (const float*)sw, nbp, npad, (int8_t*)q);
  return (int)cudaGetLastError();
}
