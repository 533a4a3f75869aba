// K7 and K8: y = x @ dequant(p) for the uniform 4-bit and 2-bit formats
// (ops/uniform4.py), x rounded to bf16, f32 accumulation; one template on
// the code width.
//
// Replaces the TPU kernels
//   K7  mxq_tpu/ops/uniform4.py _u4_kernel (:117) via _u4_matmul_padded
//       (:152) and u4_matmul (:188) — the packed lm_head of the engine;
//   K8  mxq_tpu/ops/uniform4.py _u2_kernel (:292) via _u2_matmul_padded
//       (:325) and u2_matmul (:354).
//
// Format: word r of k-tile t (1024 input columns) holds the codes of
// columns t*1024 + j*SLAB + r at bits BITS*j (SLAB = 1024 / codes per
// word); quant group g = 128 columns has one bf16 scale s and zero z per
// output column. The TPU kernel's factored algebra, per group:
//   acc += s_g * (x_g . c_g) - s_g * z_g * sum(x_g)
// so the per-weight work is shift, mask, convert and one FMA per batch row.
//
// Bound on the H100: bytes at decode batch sizes (the lm_head reads 4.25
// or 2.25 bits per weight once, each weight feeding B multiply-adds), and
// operations in prefill, where the engine computes logits of up to 2048
// rows; this kernel runs them on the CUDA cores (no tensor cores yet), so
// it is slow there. The design, as K1's (mxq_gemv.cu):
//  * one thread per output column; a warp reads 32 neighbouring int32
//    words of one packed row (128 contiguous bytes);
//  * x of one k-tile is staged in shared memory as f32 with its per-group
//    sums (all threads of a warp read the same element: a broadcast);
//  * BT batch rows in registers per thread (BT=1 for one row, else 8);
//  * K is split across blocks (blockIdx.z) in whole k-tiles so that the
//    column blocks fill the 132 SMs; a second pass adds the partial sums
//    in split order (deterministic). With one split the kernel writes y.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KT = 1024;          // input columns per k-tile
constexpr int GROUP = 128;        // quant group along K
constexpr int GPT = KT / GROUP;   // groups per k-tile
constexpr int THREADS = 128;      // columns per block

template <int BITS, int BT>
__global__ void __launch_bounds__(THREADS)
uniform_gemv_kernel(const __nv_bfloat16* __restrict__ x, int B, int K,
                    const uint32_t* __restrict__ w,
                    const __nv_bfloat16* __restrict__ s,
                    const __nv_bfloat16* __restrict__ z, int n_kt, int npad,
                    int tiles_per_split, float* __restrict__ out, int ldo,
                    int ncols) {
  constexpr int PER = 32 / BITS;      // codes per word
  constexpr int SLAB = KT / PER;      // words per k-tile = columns per slab
  constexpr int SPG = GROUP / SLAB;   // slabs per group: 1 (u4), 2 (u2)
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  __shared__ float xs[BT][KT];
  __shared__ float gsum[BT][GPT];

  const int n = blockIdx.x * THREADS + threadIdx.x;   // npad % 128 == 0
  const int b0 = blockIdx.y * BT;
  const int t0 = blockIdx.z * tiles_per_split;
  const int t1 = min(n_kt, t0 + tiles_per_split);

  float acc[BT];
#pragma unroll
  for (int bb = 0; bb < BT; ++bb) acc[bb] = 0.f;

  for (int t = t0; t < t1; ++t) {
    __syncthreads();
    for (int i = threadIdx.x; i < BT * KT; i += THREADS) {
      const int bb = i / KT, c = i % KT;
      const int row = b0 + bb, col = t * KT + c;
      xs[bb][c] = (row < B && col < K)
                      ? __bfloat162float(x[(size_t)row * K + col]) : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BT * GPT; i += THREADS) {
      const int bb = i / GPT, g = i % GPT;
      float a = 0.f;
      for (int c = 0; c < GROUP; ++c) a += xs[bb][g * GROUP + c];
      gsum[bb][g] = a;
    }
    __syncthreads();

    float dot[GPT][BT];
#pragma unroll
    for (int g = 0; g < GPT; ++g)
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) dot[g][bb] = 0.f;
    const uint32_t* wt = w + (size_t)t * SLAB * npad + n;
    for (int r = 0; r < SLAB; ++r) {
      const uint32_t word = wt[(size_t)r * npad];
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const float c = (float)((word >> (BITS * j)) & MASK);
#pragma unroll
        for (int bb = 0; bb < BT; ++bb)
          dot[j / SPG][bb] += xs[bb][j * SLAB + r] * c;
      }
    }
#pragma unroll
    for (int g = 0; g < GPT; ++g) {
      const size_t so = (size_t)(t * GPT + g) * npad + n;
      const float sg = __bfloat162float(s[so]);
      const float szg = sg * __bfloat162float(z[so]);
#pragma unroll
      for (int bb = 0; bb < BT; ++bb)
        acc[bb] += sg * dot[g][bb] - szg * gsum[bb][g];
    }
  }

  float* o = out + (size_t)blockIdx.z * B * ldo;
  if (n < ncols) {
#pragma unroll
    for (int bb = 0; bb < BT; ++bb) {
      const int row = b0 + bb;
      if (row < B) o[(size_t)row * ldo + n] = acc[bb];
    }
  }
}

// y[b, n] = sum over splits of part[split, b, n], in split order.
__global__ void reduce_splits_kernel(const float* __restrict__ part,
                                     int ksplit, int B, int npad, int O,
                                     float* __restrict__ y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * O) return;
  const int b = i / O, n = i % O;
  float a = 0.f;
  for (int k = 0; k < ksplit; ++k) a += part[((size_t)k * B + b) * npad + n];
  y[i] = a;
}

template <int BITS, int BT>
int launch(const void* x, int B, int K, const void* w, const void* s,
           const void* z, int n_kt, int npad, int O, int tiles_per_split,
           int ksplit, void* part, void* y, cudaStream_t st) {
  dim3 grid(npad / THREADS, (B + BT - 1) / BT, ksplit);
  float* out = (float*)(ksplit > 1 ? part : y);
  uniform_gemv_kernel<BITS, BT><<<grid, THREADS, 0, st>>>(
      (const __nv_bfloat16*)x, B, K, (const uint32_t*)w,
      (const __nv_bfloat16*)s, (const __nv_bfloat16*)z, n_kt, npad,
      tiles_per_split, out, ksplit > 1 ? npad : O, ksplit > 1 ? npad : O);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return (int)err;
  const long total = (long)B * O;
  reduce_splits_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      (const float*)part, ksplit, B, npad, O, (float*)y);
  return (int)cudaGetLastError();
}

}  // namespace

// bits = 4 (K7) or 2 (K8). x [B, K] bf16 row-major; w/s/z as packed; part
// [ksplit, B, npad] f32 scratch (unused with one split); y [B, O] f32.
extern "C" int uniform_gemv(int bits, const void* x, int B, int K,
                            const void* w, const void* s, const void* z,
                            int n_kt, int npad, int O, int tiles_per_split,
                            int ksplit, void* part, void* y, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (npad % THREADS || B < 1 || (B + 7) / 8 > 65535 || ksplit > 65535)
    return (int)cudaErrorInvalidValue;
  if (bits == 4)
    return B == 1 ? launch<4, 1>(x, B, K, w, s, z, n_kt, npad, O,
                                 tiles_per_split, ksplit, part, y, st)
                  : launch<4, 8>(x, B, K, w, s, z, n_kt, npad, O,
                                 tiles_per_split, ksplit, part, y, st);
  if (bits == 2)
    return B == 1 ? launch<2, 1>(x, B, K, w, s, z, n_kt, npad, O,
                                 tiles_per_split, ksplit, part, y, st)
                  : launch<2, 8>(x, B, K, w, s, z, n_kt, npad, O,
                                 tiles_per_split, ksplit, part, y, st);
  return (int)cudaErrorInvalidValue;
}
