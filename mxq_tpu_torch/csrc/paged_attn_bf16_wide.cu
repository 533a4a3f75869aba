// K12's wide path: one-token GQA decode attention over the bf16 paged KV
// pool at head_dim D > 256, which no template of paged_attn_bf16.cu holds
// (a lane group there keeps its heads of q and of the context in
// registers, 128 floats a lane at D = 256).
//
// Replaces, at those D, the same upstream Pallas TPU kernel as
// paged_attn_bf16.cu (jax/experimental/pallas/ops/tpu/paged_attention,
// which mxq_tpu/serving/paged.py paged_attend :287-299 calls for a bf16
// pool with D % 128 == 0; any other D goes to _paged_attend_reference
// :301-318, which the plain version follows). Per batch row b and query
// head: s = (q . k[r]) / sqrt(D) in f32 over rows r < lengths[b], p =
// softmax(s), ctx = sum_r p[r] v[r] in f32, written in q's type.
//
// Design: a work item is (row b, kv head h, split j of SPLIT = 256
// history rows, column chunk c of C = 128 columns of the context), one
// block each; the grid holds every item a table could have, and a block
// whose split lies past its row's length (derived from lengths, as the
// template derives its work list) returns at once. A block
// - stages q's G heads in f32 (zeros past G are never read) where they
//   fit in QFLOATS floats of shared memory; past that (one head of D >
//   32768, the kernel's QS = false) it reads q from device memory where
//   it would have read the staged copy, the same values in the same
//   order, so the same bits come out at every D;
// - scores its split's rows over ALL of D: a warp takes 4 rows at once
//   (their loads in flight together), its lanes 8 columns by one 16-byte
//   load (or one column at a time where D % 8 or the pool's start
//   forbids it) and sum q . k over them, then a butterfly over the warp:
//   the same instructions, so the same bits, in every chunk's block;
// - forms the split's max m_j and sum l_j per head from those scores,
//   e = exp(s - m_j) (again the same bits in every chunk);
// - sums e . v over its chunk's columns of the V rows: warp w takes rows
//   w, w + 8, ... (4 in flight), a lane 4 columns by one 8-byte load; the
//   8 warps' partial sums are added in warp order;
// - one split: writes ctx / l; else its partial context to the scratch
//   (chunk 0 also m_j and l_j), and the last of the (b, kv head)'s splits
//   x chunks to finish (an atomic ticket, reset to 0 by that block)
//   combines every column over the splits in split order, as the template
//   does: M = max m_j, ctx = sum_j exp(m_j - M) ctx_j / sum_j exp(m_j - M)
//   l_j.
// The result is the same bits on every call and does not depend on the
// batch or on the other rows' lengths.
//
// Bound on the H100: bytes. Every K and V row below the length is read
// once (2 * D * 2 bytes per (b, kv head, row)) for 4 * G * D operations.
// This path reads each K row once per column chunk (ceil(D / 128) times,
// from L2 after the first) and each V row once; it is a simple form of
// the kernel, not a tuned one.
// expf and IEEE division, no fast math: the float32 gate is 1e-5.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int SPLIT = 256;               // history rows per work item
constexpr int C = 128;                   // context columns per work item
constexpr int GW = 8;                    // query heads of a launch at most
constexpr int QFLOATS = 32768;           // q's G * D floats staged at most
constexpr int RW = 4;                    // rows a warp has in flight

struct Args {
  const void* q;                         // [B, Hkv * Gtot, d]
  const __nv_bfloat16* kp;               // [Hkv, LP, ps, d]
  const __nv_bfloat16* vp;
  const int* lengths;                    // [B]
  const int* tables;                     // [B, pps]
  void* out;                             // [B, Hkv * Gtot, d], q's type
  float* ws;      // maxima [BHG, NS], sums [BHG, NS], contexts [BHG, NS, d]
  int* tickets;                          // [B * Hkv], 0 between calls
  int B, Hkv, Gtot, g0, G, d, LP, ps, pps, NS, NCH;
  int qf32;                              // q and out float32, else bf16
  int vec;                               // 16-byte K loads
  int vec4;                              // 8-byte V loads
  float sqrt_d;
};

__device__ __forceinline__ size_t head_off(const Args& a, int b, int h,
                                           int g) {
  return (((size_t)b * a.Hkv + h) * a.Gtot + a.g0 + g) * a.d;
}

__device__ __forceinline__ void store_out(const Args& a, size_t i, float x) {
  if (a.qf32)
    static_cast<float*>(a.out)[i] = x;
  else
    static_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16_rn(x);
}

// element offset of history row r of (b's table, kv head h) in the pool
__device__ __forceinline__ size_t row_off(const Args& a, const int* tab,
                                         int h, int r) {
  return (((size_t)h * a.LP + __ldg(tab + r / a.ps)) * a.ps + r % a.ps)
         * a.d;
}

// a bf16 pair of a 32-bit word as two floats
__device__ __forceinline__ void unpack2(uint32_t w, float& x, float& y) {
  x = __uint_as_float(w << 16);
  y = __uint_as_float(w & 0xffff0000u);
}

// head g's q at column c: staged (QS) or read from q itself at qo, the
// element offset of the launch's first head
template <bool QS>
__device__ __forceinline__ float q_at(const Args& a, const float* qs,
                                      size_t qo, int g, int c) {
  if (QS) return qs[g * a.d + c];
  const size_t o = qo + (size_t)g * a.d + c;
  return a.qf32 ? __ldg(static_cast<const float*>(a.q) + o)
                : __bfloat162float(
                      static_cast<const __nv_bfloat16*>(a.q)[o]);
}

// smem: q [G][d] f32 (QS); the split's scores, then probabilities
// [GW][SPLIT]; the warps' partial contexts [NW][GW][C]; the heads' m and l
template <bool QS>
__global__ void __launch_bounds__(THREADS)
    paged_bf16_wide_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* sc = qs + (QS ? (size_t)a.G * a.d : 0);
  float* red = sc + GW * SPLIT;
  float* mh = red + NW * GW * C;
  float* lh = mh + GW;
  __shared__ int last;
  const int j = blockIdx.x / a.NCH, ch = blockIdx.x % a.NCH;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = min(max(__ldg(a.lengths + b), 0), a.pps * a.ps);
  const int ns = max(1, (n + SPLIT - 1) / SPLIT);
  if (j >= ns) return;
  const int c0 = ch * C, ncol = min(C, a.d - c0);
  if (n == 0) {                          // a row of length <= 0: zeros
    for (int i = tid; i < a.G * ncol; i += THREADS)
      store_out(a, head_off(a, b, h, i / ncol) + c0 + i % ncol, 0.f);
    return;
  }
  const int r0 = j * SPLIT, nv = min(n - r0, SPLIT);
  const int* tab = a.tables + (size_t)b * a.pps;
  const size_t qo = head_off(a, b, h, 0);
  if (QS)
    for (int i = tid; i < a.G * a.d; i += THREADS)
      qs[i] = q_at<false>(a, qs, qo, 0, i);
  __syncthreads();

  // scores of the split's rows over all of D: a warp takes RW rows at a
  // time (their loads in flight together), its lanes 8 columns a step
  // (one at a time where D % 8 or the pool's start forbids 16 bytes),
  // then a butterfly per (row, head)
  for (int rb = warp; rb < nv; rb += RW * NW) {
    const __nv_bfloat16* k[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i)
      k[i] = a.kp + row_off(a, tab, h, r0 + min(rb + i * NW, nv - 1));
    float p[RW][GW];
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int g = 0; g < GW; ++g) p[i][g] = 0.f;
    if (a.vec) {
      for (int c = lane * 8; c < a.d; c += 32 * 8) {
        uint4 u[RW];
#pragma unroll
        for (int i = 0; i < RW; ++i)
          u[i] = __ldg(reinterpret_cast<const uint4*>(k[i] + c));
#pragma unroll
        for (int g = 0; g < GW; ++g) {
          if (g >= a.G) break;
          float4 qa, qb;
          if (QS) {
            const float* qg = qs + g * a.d + c;
            qa = *reinterpret_cast<const float4*>(qg);
            qb = *reinterpret_cast<const float4*>(qg + 4);
          } else {
            qa = make_float4(q_at<QS>(a, qs, qo, g, c),
                             q_at<QS>(a, qs, qo, g, c + 1),
                             q_at<QS>(a, qs, qo, g, c + 2),
                             q_at<QS>(a, qs, qo, g, c + 3));
            qb = make_float4(q_at<QS>(a, qs, qo, g, c + 4),
                             q_at<QS>(a, qs, qo, g, c + 5),
                             q_at<QS>(a, qs, qo, g, c + 6),
                             q_at<QS>(a, qs, qo, g, c + 7));
          }
#pragma unroll
          for (int i = 0; i < RW; ++i) {
            float k0, k1, k2, k3, k4, k5, k6, k7;
            unpack2(u[i].x, k0, k1);
            unpack2(u[i].y, k2, k3);
            unpack2(u[i].z, k4, k5);
            unpack2(u[i].w, k6, k7);
            float x = p[i][g];
            x = fmaf(qa.x, k0, x);
            x = fmaf(qa.y, k1, x);
            x = fmaf(qa.z, k2, x);
            x = fmaf(qa.w, k3, x);
            x = fmaf(qb.x, k4, x);
            x = fmaf(qb.y, k5, x);
            x = fmaf(qb.z, k6, x);
            p[i][g] = fmaf(qb.w, k7, x);
          }
        }
      }
    } else {
      for (int c = lane; c < a.d; c += 32) {
        float kf[RW];
#pragma unroll
        for (int i = 0; i < RW; ++i) kf[i] = __bfloat162float(k[i][c]);
#pragma unroll
        for (int g = 0; g < GW; ++g) {
          if (g >= a.G) break;
          const float qv = q_at<QS>(a, qs, qo, g, c);
#pragma unroll
          for (int i = 0; i < RW; ++i) p[i][g] = fmaf(qv, kf[i], p[i][g]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int g = 0; g < GW; ++g)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          p[i][g] += __shfl_xor_sync(0xffffffffu, p[i][g], o);
    if (lane == 0)
#pragma unroll
      for (int i = 0; i < RW; ++i)
        if (rb + i * NW < nv)
#pragma unroll
          for (int g = 0; g < GW; ++g)
            if (g < a.G) sc[g * SPLIT + rb + i * NW] = p[i][g] / a.sqrt_d;
  }
  __syncthreads();

  // each head's max and sum over the split, a warp a head
  for (int g = warp; g < a.G; g += NW) {
    float m = -INFINITY;
    for (int r = lane; r < nv; r += 32) m = fmaxf(m, sc[g * SPLIT + r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int r = lane; r < nv; r += 32) {
      const float e = expf(sc[g * SPLIT + r] - m);
      sc[g * SPLIT + r] = e;
      l += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      mh[g] = m;
      lh[g] = l;
    }
  }
  __syncthreads();

  // the chunk's context: warp w sums rows w, w + NW, ... (RW loads in
  // flight), a lane 4 columns; then the warps' sums in warp order
  {
    const int cc = lane * 4;             // the lane's columns in the chunk
    float acc[GW][4];
#pragma unroll
    for (int g = 0; g < GW; ++g)
      acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
    for (int rb = warp; rb < nv; rb += RW * NW) {
      float v[RW][4];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int r = rb + i * NW;
        v[i][0] = v[i][1] = v[i][2] = v[i][3] = 0.f;
        if (r < nv && cc < ncol) {
          const __nv_bfloat16* vp = a.vp + row_off(a, tab, h, r0 + r) + c0
                                    + cc;
          if (a.vec4 && cc + 4 <= ncol) {
            const uint2 u = __ldg(reinterpret_cast<const uint2*>(vp));
            unpack2(u.x, v[i][0], v[i][1]);
            unpack2(u.y, v[i][2], v[i][3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (cc + e < ncol) v[i][e] = __bfloat162float(vp[e]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int r = rb + i * NW;
        if (r >= nv) break;
#pragma unroll
        for (int g = 0; g < GW; ++g) {
          if (g >= a.G) break;
          const float pr = sc[g * SPLIT + r];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(pr, v[i][e], acc[g][e]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GW; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(warp * GW + g) * C + cc + e] = acc[g][e];
  }
  __syncthreads();

  const size_t bh = (size_t)b * a.Hkv + h;
  const size_t bhg = (size_t)a.B * a.Hkv * a.G;
  float* wmax = a.ws;
  float* wsum = wmax + bhg * a.NS;
  float* wctx = wsum + bhg * a.NS;
  for (int i = tid; i < a.G * ncol; i += THREADS) {
    const int g = i / ncol, c = i % ncol;
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) x += red[(w * GW + g) * C + c];
    if (ns == 1) {
      store_out(a, head_off(a, b, h, g) + c0 + c, x / lh[g]);
    } else {
      const size_t br = bh * a.G + g;
      wctx[(br * a.NS + j) * a.d + c0 + c] = x;
      if (ch == 0 && c == 0) {
        wmax[br * a.NS + j] = mh[g];
        wsum[br * a.NS + j] = lh[g];
      }
    }
  }
  if (ns == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.tickets + bh, 1) == ns * a.NCH - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < a.G * a.d; i += THREADS) {
    const int g = i / a.d, c = i % a.d;
    const size_t br = bh * a.G + g;
    const float* mj = wmax + br * a.NS;
    const float* lj = wsum + br * a.NS;
    const float* cj = wctx + br * a.NS * a.d + c;
    float mx = -INFINITY;
    for (int jj = 0; jj < ns; ++jj) mx = fmaxf(mx, __ldcg(mj + jj));
    float x = 0.f, y = 0.f;
    for (int jj = 0; jj < ns; ++jj) {
      const float f = expf(__ldcg(mj + jj) - mx);
      x = fmaf(__ldcg(cj + (size_t)jj * a.d), f, x);
      y = fmaf(__ldcg(lj + jj), f, y);
    }
    store_out(a, head_off(a, b, h, g) + c, x / y);
  }
  if (tid == 0) a.tickets[bh] = 0;
}

}  // namespace

// paged_attn_bf16 (paged_attn_bf16.cu) at head_dim d > 256: q [B, Hkv *
// Gtot, d] (float32 if qf32, else bf16), contiguous; k/v pages [Hkv, LP,
// ps, d] bf16; lengths [B]; tables [B, pps]; query heads g0 .. g0 + G - 1
// of each kv head, G <= 8 and G * d <= 32768 (q staged in shared
// memory) or G = 1 at any d (q read in place); D, the template argument
// of paged_attn_bf16, must equal d; ws the scratch of B * Hkv * G * NS *
// (d + 2) floats, NS = ceil(pps * ps / 256); tickets [B * Hkv] int32, 0
// between calls; out shaped and typed as q (only the launch's heads written). Returns a cudaError_t.
extern "C" int paged_attn_bf16_wide(const void* q, int qf32, const void* kp,
                                    const void* vp, const void* lengths,
                                    const void* tables, int B, int Hkv,
                                    int Gtot, int g0, int G, int D, int d,
                                    int LP, int ps, int pps, float sqrt_d,
                                    void* ws, void* tickets, void* out,
                                    void* stream) {
  const int ns = (int)(((long long)pps * ps + SPLIT - 1) / SPLIT);
  const int nch = (d + C - 1) / C;
  if (B < 0 || B > 65535 || Hkv < 1 || Hkv > 65535 || G < 1 || G > GW
      || g0 < 0 || g0 + G > Gtot || d <= 256 || D != d
      || ((long long)G * d > QFLOATS && G > 1) || LP < 1 || ps < 1
      || pps < 1
      || (long long)pps * ps > (1 << 30)
      || (long long)ns * nch > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const uintptr_t starts = (uintptr_t)kp | (uintptr_t)vp;
  Args a{q, (const __nv_bfloat16*)kp, (const __nv_bfloat16*)vp,
         (const int*)lengths, (const int*)tables, out, (float*)ws,
         (int*)tickets, B, Hkv, Gtot, g0, G, d, LP, ps, pps, ns, nch,
         qf32 != 0, d % 8 == 0 && starts % 16 == 0,
         d % 4 == 0 && starts % 8 == 0, sqrt_d};
  const bool qs = (long long)G * d <= QFLOATS;
  const int bytes = (int)(sizeof(float)
                          * ((qs ? (size_t)G * d : 0) + GW * SPLIT
                             + NW * GW * C + 2 * GW));
  auto kern = qs ? paged_bf16_wide_kernel<true>
                 : paged_bf16_wide_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(ns * nch, Hkv, B), THREADS, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
