// K12: one-token GQA decode attention over the bf16 paged KV pool.
//
// Replaces the upstream Pallas TPU kernel that mxq_tpu/serving/paged.py
// paged_attend (:265) calls for a bf16 pool with head_dim % 128 == 0
// (:287-298): jax/experimental/pallas/ops/tpu/paged_attention/
// paged_attention_kernel.py paged_attention (:376, pallas_call :628),
// once per layer per decode substep of PagedEngine at --kv_bits 32. It
// computes what mxq_tpu's reference (_paged_attend_reference, :301-318)
// computes, per batch row b and query head:
//   s   = (q . k[s]) / sqrt(D)      f32, rows s < lengths[b] of b's pages
//   p   = softmax(s)                f32
//   ctx = sum_s p[s] * v[s]         f32 (the wrapper casts to q's type)
// mxq_tpu's TPU route pre-scales q by 1/sqrt(D) and rounds it to q's type
// before the kernel; its CPU reference, which this follows, divides the
// f32 scores.
//
// Pool layout (serving/paged.py, folded): k/v pages [Hkv, LP, ps, dp]
// bf16, tables [B, pps] int32 physical page ids, any page size. The
// kernel is a template at D = 64 or 128 and reads pages of any row width
// dp <= D in place: columns dp..D-1 of its shared tiles are zeros, and
// the wrapper pads q (a few KB) to D with zeros, so those columns add
// nothing to q . k and give zero context columns. Each copy moves V
// elements, the most (8, 4, 2 or 1) that divide dp and keep the pages'
// start aligned to a copy.
//
// Design (split history, "flash-decoding"): one block of 128 threads per
// (split of CH = 128 history rows, kv head, batch row). A block copies
// its rows of K and V into shared memory with cp.async (16 bytes a copy
// at D = 64 or 128, all in flight at once, each row found through the table), then scores
// every row for all G = Hq / Hkv query heads of its kv head (a warp per
// row, a lane per D/32 columns), so each page is read once for the G
// heads. It writes its split's max m_j, sum l_j = sum exp(s - m_j) and
// partial context sum exp(s - m_j) v to a scratch. The last block of each
// (b, kv head) to finish (an atomic ticket, reset to 0 by that block, as
// attn_split.cuh's values_kernel) combines the splits in split order:
// ctx = sum_j exp(m_j - M) ctx_j / sum_j exp(m_j - M) l_j, M = max_j m_j,
// so the result is the same bit for bit on every run. Rows at or past
// lengths[b] are never read, nor is any page past ceil(lengths[b] / ps)
// (the null page, tables clamped past a slot's capacity); a length past
// the table is cut to pps * ps rows. A row of length <= 0 gets zeros.
//
// Bound on the H100: bytes. Every K and V row below the length is read
// once (2 * D * 2 bytes per (b, kv head, row)) for 4 * G * D operations:
// at G = 1 one flop per byte, far below the card's ~295. expf, no fast
// math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "device_util.cuh"

constexpr int THREADS = 128;
constexpr int NW = THREADS / 32;
constexpr int CH = 128;                 // history rows per split
constexpr int GMAX = 16;                // query heads per kv head

struct Args {
  const float* q;                       // [B, Hkv, G, D] f32
  const __nv_bfloat16* kp;              // [Hkv, LP, ps, dp]
  const __nv_bfloat16* vp;
  const int* lengths;                   // [B]
  const int* tables;                    // [B, pps]
  int B, Hkv, G, dp, LP, ps, pps, NS;
  float sqrt_d;
  float* ws;      // maxima [BHG, NS], sums [BHG, NS], contexts [BHG, NS, D]
  int* tickets;                         // [B * Hkv], 0 between calls
  float* out;                           // [B, Hkv, G, D] f32
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// V bf16 elements (2V bytes) from global to shared memory, zeros where
// !valid: cp.async for 16, 8 and 4 bytes, a plain load for one element
template <int V>
__device__ __forceinline__ void cp_elems(__nv_bfloat16* dst,
                                         const __nv_bfloat16* src,
                                         bool valid) {
  if constexpr (V == 8) {
    cp16(dst, src, valid);
  } else if constexpr (V == 1) {
    *dst = valid ? *src : __float2bfloat16(0.f);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::
                     "r"(smem_addr(dst)), "l"(src), "n"(2 * V),
                     "r"(valid ? 2 * V : 0));
  }
}

template <int D, int V>
__global__ void __launch_bounds__(THREADS) paged_bf16_kernel(const Args a) {
  constexpr int CPR = D / V;            // copies per shared row
  constexpr int EPL = D / 32;           // columns per lane in the scores
  constexpr int RS = THREADS / D;       // row slices in the context sum
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [CH][D]
  __nv_bfloat16* sv = sk + CH * D;                                  // [CH][D]
  float* sq = reinterpret_cast<float*>(sv + CH * D);   // [G][D]
  float* se = sq + a.G * D;                            // [G][CH]
  float* sred = se + a.G * CH;                         // [RS - 1][G][D]
  __shared__ int last;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * a.Hkv + h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = min(max(a.lengths[b], 0), a.pps * a.ps);
  const int nlive = max(1, (n + CH - 1) / CH);
  if (j >= nlive) return;
  const int c0 = j * CH;
  const int nv = min(max(n - c0, 0), CH);
  const size_t bhg = (size_t)a.B * a.Hkv * a.G;
  float* wmax = a.ws;
  float* wsum = wmax + bhg * a.NS;
  float* wctx = wsum + bhg * a.NS;

  for (int i = tid; i < CH * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = r < nv && c * V < a.dp;
    size_t off = 0;
    if (ok) {
      const int row = c0 + r;
      const int page = a.tables[(size_t)b * a.pps + row / a.ps];
      off = (((size_t)h * a.LP + page) * a.ps + row % a.ps) * a.dp + c * V;
    }
    cp_elems<V>(sk + r * D + c * V, a.kp + off, ok);
    cp_elems<V>(sv + r * D + c * V, a.vp + off, ok);
  }
  cp_commit();
  const float* qb = a.q + (size_t)bh * a.G * D;
  for (int i = tid; i < a.G * D; i += THREADS) sq[i] = qb[i];
  cp_wait<0>();
  __syncthreads();

  // scores: a warp per history row, all G heads of the row
  for (int r = warp; r < nv; r += NW) {
    float kf[EPL];
    const __nv_bfloat16* kr = sk + r * D + lane * EPL;
#pragma unroll
    for (int e = 0; e < EPL; ++e) kf[e] = __bfloat162float(kr[e]);
    for (int g = 0; g < a.G; ++g) {
      const float* qr = sq + g * D + lane * EPL;
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) s = fmaf(qr[e], kf[e], s);
      s = warp_sum(s);
      if (lane == 0) se[g * CH + r] = s / a.sqrt_d;
    }
  }
  __syncthreads();

  // the split's max, exp(s - m_j) and its sum, per query head
  for (int g = warp; g < a.G; g += NW) {
    float m = -INFINITY;
    for (int r = lane; r < nv; r += 32) m = fmaxf(m, se[g * CH + r]);
    m = warp_max(m);
    float l = 0.f;
    for (int r = lane; r < CH; r += 32) {
      float e = 0.f;
      if (r < nv) {
        e = expf(se[g * CH + r] - m);
        l += e;
      }
      se[g * CH + r] = e;
    }
    l = warp_sum(l);
    if (lane == 0) {
      wmax[((size_t)bh * a.G + g) * a.NS + j] = m;
      wsum[((size_t)bh * a.G + g) * a.NS + j] = l;
    }
  }
  __syncthreads();

  // the split's partial context: a thread per column (and row slice)
  const int d = tid % D, rs = tid / D;
  float acc[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g] = 0.f;
  for (int r = rs; r < nv; r += RS) {
    const float v = __bfloat162float(sv[r * D + d]);
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < a.G) acc[g] = fmaf(se[g * CH + r], v, acc[g]);
  }
  if constexpr (RS > 1) {
    if (rs > 0)
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < a.G) sred[((rs - 1) * a.G + g) * D + d] = acc[g];
    __syncthreads();
  }
  if (rs == 0)
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= a.G) break;
      float s = acc[g];
      for (int k = 1; k < RS; ++k) s += sred[((k - 1) * a.G + g) * D + d];
      wctx[(((size_t)bh * a.G + g) * a.NS + j) * D + d] = s;
    }

  // the last block of (b, h) to get here combines the splits in order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.tickets + bh, 1) == nlive - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < a.G * D; i += THREADS) {
    const int g = i / D, dd = i % D;
    const size_t br = (size_t)bh * a.G + g;
    float mfin = -INFINITY;
    for (int jj = 0; jj < nlive; ++jj)
      mfin = fmaxf(mfin, __ldcg(wmax + br * a.NS + jj));
    float acc_d = 0.f, l = 0.f;
    if (mfin > -INFINITY)
      for (int jj = 0; jj < nlive; ++jj) {
        const float f = expf(__ldcg(wmax + br * a.NS + jj) - mfin);
        acc_d += __ldcg(wctx + (br * a.NS + jj) * D + dd) * f;
        l += __ldcg(wsum + br * a.NS + jj) * f;
      }
    a.out[br * D + dd] = l > 0.f ? acc_d / l : 0.f;
  }
  if (tid == 0) a.tickets[bh] = 0;
}

template <int D, int V>
int launch(const Args& a, void* stream) {
  const size_t smem = (size_t)2 * CH * D * 2
                      + sizeof(float) * ((size_t)a.G * D + (size_t)a.G * CH
                                         + (size_t)(THREADS / D - 1) * a.G * D);
  auto kern = paged_bf16_kernel<D, V>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(a.NS, a.Hkv, a.B);
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_width(const Args& a, int v, void* stream) {
  switch (v) {
    case 8: return launch<D, 8>(a, stream);
    case 4: return launch<D, 4>(a, stream);
    case 2: return launch<D, 2>(a, stream);
    default: return launch<D, 1>(a, stream);
  }
}

}  // namespace

// q [B, Hkv, G, D] f32 (columns >= dp zero); k/v pages [Hkv, LP, ps, dp]
// bf16, dp <= D; lengths [B]; tables [B, pps] physical page ids; ws the
// scratch of B * Hkv * G * NS * (D + 2) floats, NS = ceil(pps * ps / 128);
// tickets [B * Hkv] int32, 0 between calls; out [B, Hkv, G, D] f32.
// Returns a cudaError_t.
extern "C" int paged_attn_bf16(const void* q, const void* kp, const void* vp,
                               const void* lengths, const void* tables, int B,
                               int Hkv, int G, int D, int dp, int LP, int ps,
                               int pps, float sqrt_d, void* ws, void* tickets,
                               void* out, void* stream) {
  if (B < 0 || B > 65535 || Hkv < 1 || Hkv > 65535 || G < 1 || G > GMAX
      || dp < 1 || dp > D || LP < 1 || ps < 1 || pps < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Args a{(const float*)q, (const __nv_bfloat16*)kp,
               (const __nv_bfloat16*)vp, (const int*)lengths,
               (const int*)tables, B, Hkv, G, dp, LP, ps, pps,
               (pps * ps + CH - 1) / CH, sqrt_d, (float*)ws, (int*)tickets,
               (float*)out};
  // the widest copy that divides a row and keeps both pools aligned to it
  const uintptr_t starts = (uintptr_t)kp | (uintptr_t)vp;
  int v = 8;
  while (v > 1 && (dp % v || starts % (2 * v))) v >>= 1;
  switch (D) {
    case 64: return launch_width<64>(a, v, stream);
    case 128: return launch_width<128>(a, v, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
