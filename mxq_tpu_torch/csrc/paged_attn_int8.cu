// K9 / K10 / K11: one-token GQA decode attention over the int8 paged KV
// pool, one kernel with two compile-time flags:
//   K9  (CUR=0, WRITE=0)  rows < lengths[b]
//   K10 (CUR=1, WRITE=0)  rows < positions[b], plus the current token
//                         (out of the pool) folded in after the last page
//   K11 (CUR=1, WRITE=1)  K10, plus the current token's code row and scale
//                         lane written into its pool page in place
//
// Replaces the TPU kernels mxq_tpu/ops/attn_int8.py _kernel_paged (:559,
// via _paged_attn_call :604 / int8_paged_decode_attention :1016),
// _kernel_paged_cur (:658, via int8_paged_decode_attention_cur :990) and
// _kernel_paged_cur_write (:773, via int8_paged_decode_attend_update :957,
// which serving/paged.py's decode step calls once per layer). The TPU's
// g8 = max(8, G) padding, 8-row octet write windows, aliased outputs and
// null-page parking were Mosaic devices: here the write is a direct store
// of D codes and one scale lane per (b, head), and no other pool byte is
// touched.
//
// Pool layout (serving/paged.py, folded): codes [Hkv, LP, PAGE, D] int8,
// scales [Hkv, LP, 1, PAGE] bf16; tables [B, pps] int32 physical page ids.
//
// Math per (batch b, kv head h), its G query heads, bound n = bound[b]:
// pages are folded in table order into a running (m, l, acc), exactly as
// the TPU kernel folds its sequential page grid axis (attn_int8.py:575-600):
//   st    = (q . kc[s]) * (ks[s] * scale)            rows s < n of the page
//   m_new = max(m, max_s st); alpha = exp(m - m_new); pexp = exp(st - m_new)
//   l     = l * alpha + sum_s pexp
//   acc   = acc * alpha + sum_s bf16(pexp * vs[s]) * vc[s]
// bf16(pexp * vs) is rounded against the RUNNING max of each page, not the
// global max as K4 does, so the roundings match mxq_tpu's. With CUR the
// current token folds in last (:701-717), gated on nothing: with no cache
// rows m = NEG and alpha2 = exp(NEG - stc) = 0. ctx = acc / max(l, 1e-30).
// A page wholly past n folds in as the identity (alpha = 1, pexp = 0), so
// it is skipped and the null page is never read. expf, not fast math.
//
// Bound on the H100: bytes. Every code row below n is read once (2*D bytes
// per (b, h, row)) with its two bf16 scales, at two multiply-adds per code
// byte. One block of 8 warps per (b, h) walks its pages: in the score pass
// a warp reads one D-byte code row per step (D/32 bytes a lane, coalesced)
// and reduces across lanes with shuffles; warp g then updates query head
// g's (m, l) and turns its scores into bf16(pexp * vs) in shared memory;
// in the V pass each warp keeps its own running accumulator in registers
// (rescaled by alpha every page), and the warps are summed once at the
// end. Not yet tuned: no split over pages, so a (b, h) pair is one block
// however long its sequence is, and each page costs three block barriers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int GMAX = 8;
constexpr int PAGE = 128;
constexpr float NEG = -3.402823466e38f;   // f32 min, the TPU kernel's NEG

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

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// E consecutive int8 codes (E = D / 32: 4 or 2) as floats, one load
template <int E>
__device__ __forceinline__ void load_codes(const int8_t* p, float (&c)[E]) {
  if constexpr (E == 4) {
    const char4 v = *reinterpret_cast<const char4*>(p);
    c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
  } else {
    const char2 v = *reinterpret_cast<const char2*>(p);
    c[0] = v.x; c[1] = v.y;
  }
}

template <int D, bool CUR, bool WRITE>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const __nv_bfloat16* __restrict__ q,    // [B, Hkv, G, D]
                  int8_t* kp,                             // [Hkv, LP, PAGE, D]
                  __nv_bfloat16* ks,                      // [Hkv, LP, PAGE]
                  int8_t* vp,
                  __nv_bfloat16* vs,
                  const int8_t* __restrict__ kcur,        // [B, Hkv, D]
                  const __nv_bfloat16* __restrict__ kscur,  // [B, Hkv]
                  const int8_t* __restrict__ vcur,
                  const __nv_bfloat16* __restrict__ vscur,
                  const int* __restrict__ bound,          // [B]
                  const int* __restrict__ tables,         // [B, pps]
                  int Hkv, int G, int LP, int pps, float scale,
                  float* __restrict__ out) {               // [B, Hkv, G, D]
  constexpr int E = D / 32;                 // code bytes per lane
  extern __shared__ float smem[];
  float* qf = smem;                         // [G, D]
  float* st = qf + G * D;                   // [G, PAGE]: scores, then pv
  float* red = st + G * PAGE;               // [NW, G, D]
  __shared__ float m_s[GMAX], l_s[GMAX], alpha_s[GMAX], stc_s[GMAX];

  const int bh = blockIdx.x;
  const int b = bh / Hkv, h = bh % Hkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n = max(bound[b], 0);
  const int npages = min((n + PAGE - 1) / PAGE, pps);
  const int* tbl = tables + (size_t)b * pps;
  const size_t head0 = (size_t)h * LP;      // head h's first page

  for (int i = tid; i < G * D; i += THREADS)
    qf[i] = __bfloat162float(q[(size_t)bh * G * D + i]);
  if (tid < G) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  if (CUR && warp < G) {                    // current token's logit
    float k[E];
    load_codes<E>(kcur + (size_t)bh * D + lane * E, k);
    float a = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) a += qf[warp * D + lane * E + e] * k[e];
    a = warp_sum(a);
    if (lane == 0) stc_s[warp] = a * (__bfloat162float(kscur[bh]) * scale);
  }

  float acc[GMAX][E];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;

  for (int j = 0; j < npages; ++j) {
    const size_t page = head0 + (size_t)tbl[j];
    const int8_t* kpg = kp + page * PAGE * D;
    const int8_t* vpg = vp + page * PAGE * D;
    const __nv_bfloat16* kspg = ks + page * PAGE;
    const __nv_bfloat16* vspg = vs + page * PAGE;
    const int nvalid = min(n - j * PAGE, PAGE);   // >= 1

    // scores of the valid rows, one code row per warp step
#pragma unroll 4
    for (int s = warp; s < nvalid; s += NW) {
      float k[E];
      load_codes<E>(kpg + (size_t)s * D + lane * E, k);
      const float ksc = __bfloat162float(kspg[s]) * scale;
      for (int g = 0; g < G; ++g) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) a += qf[g * D + lane * E + e] * k[e];
        a = warp_sum(a);
        if (lane == 0) st[g * PAGE + s] = a * ksc;
      }
    }
    __syncthreads();

    // warp g: query head g's running max and denominator, and its scores
    // turned into bf16(pexp * vs) against the new running max
    if (warp < G) {
      float* sg = st + warp * PAGE;
      float mx = NEG;
      for (int s = lane; s < nvalid; s += 32) mx = fmaxf(mx, sg[s]);
      mx = warp_max(mx);
      const float m_old = m_s[warp];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int s = lane; s < nvalid; s += 32) {
        const float p = expf(sg[s] - m_new);
        sum += p;
        sg[s] = bf16_round(p * __bfloat162float(vspg[s]));
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[warp] = alpha;
        l_s[warp] = l_s[warp] * alpha + sum;
        m_s[warp] = m_new;
      }
    }
    __syncthreads();

    // V pass: rescale each warp's running sums, then add its rows
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) {
        const float alpha = alpha_s[g];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
      }
#pragma unroll 4
    for (int s = warp; s < nvalid; s += NW) {
      float v[E];
      load_codes<E>(vpg + (size_t)s * D + lane * E, v);
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) {
          const float p = st[g * PAGE + s];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] += p * v[e];
        }
    }
    __syncthreads();                        // st is the next page's scratch
  }

  // sum the warps in a fixed order, fold the current token in, normalise
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
    if (g < G)
#pragma unroll
      for (int e = 0; e < E; ++e)
        red[(warp * G + g) * D + lane * E + e] = acc[g][e];
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float a = 0.f;
    for (int w = 0; w < NW; ++w) a += red[(w * G + g) * D + d];
    float l = l_s[g];
    if (CUR) {
      const float m = m_s[g], c = stc_s[g];
      const float m_fin = fmaxf(m, c);
      const float alpha2 = expf(m - m_fin);
      const float pc = expf(c - m_fin);
      l = l * alpha2 + pc;
      const float pcb = bf16_round(pc * __bfloat162float(vscur[bh]));
      a = a * alpha2 + pcb * (float)vcur[(size_t)bh * D + d];
    }
    out[(size_t)bh * G * D + i] = a / fmaxf(l, 1e-30f);
  }

  // K11: the current row at (tbl[pos / PAGE], pos % PAGE). Rows >= pos are
  // never read, and the write page belongs to sequence b alone.
  if (WRITE && n / PAGE < pps) {
    const size_t page = head0 + (size_t)tbl[n / PAGE];
    const int off = n % PAGE;
    for (int i = tid; i < D; i += THREADS) {
      kp[(page * PAGE + off) * D + i] = kcur[(size_t)bh * D + i];
      vp[(page * PAGE + off) * D + i] = vcur[(size_t)bh * D + i];
    }
    if (tid == 0) {
      ks[page * PAGE + off] = kscur[bh];
      vs[page * PAGE + off] = vscur[bh];
    }
  }
}

template <int D, bool CUR, bool WRITE>
int launch(const void* q, void* kp, void* ks, void* vp, void* vs,
           const void* kcur, const void* kscur, const void* vcur,
           const void* vscur, const void* bound, const void* tables, int B,
           int Hkv, int G, int LP, int pps, float scale, void* out,
           void* stream) {
  // at most 8 * (128 + 128 + 8 * 128) * 4 = 40 KB: no opt-in needed
  const size_t smem = sizeof(float) * ((size_t)G * D + (size_t)G * PAGE
                                       + (size_t)NW * G * D);
  paged_attn_kernel<D, CUR, WRITE>
      <<<B * Hkv, THREADS, smem, (cudaStream_t)stream>>>(
          (const __nv_bfloat16*)q, (int8_t*)kp, (__nv_bfloat16*)ks,
          (int8_t*)vp, (__nv_bfloat16*)vs, (const int8_t*)kcur,
          (const __nv_bfloat16*)kscur, (const int8_t*)vcur,
          (const __nv_bfloat16*)vscur, (const int*)bound, (const int*)tables,
          Hkv, G, LP, pps, scale, (float*)out);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch(int cur, int write, const void* q, void* kp, void* ks, void* vp,
             void* vs, const void* kcur, const void* kscur, const void* vcur,
             const void* vscur, const void* bound, const void* tables, int B,
             int Hkv, int G, int LP, int pps, float scale, void* out,
             void* stream) {
  if (!cur)
    return launch<D, false, false>(q, kp, ks, vp, vs, kcur, kscur, vcur,
                                   vscur, bound, tables, B, Hkv, G, LP, pps,
                                   scale, out, stream);
  if (!write)
    return launch<D, true, false>(q, kp, ks, vp, vs, kcur, kscur, vcur,
                                  vscur, bound, tables, B, Hkv, G, LP, pps,
                                  scale, out, stream);
  return launch<D, true, true>(q, kp, ks, vp, vs, kcur, kscur, vcur, vscur,
                               bound, tables, B, Hkv, G, LP, pps, scale, out,
                               stream);
}

}  // namespace

// cur = 0: K9 (bound = lengths); cur = 1: K10 (bound = positions);
// cur = 1, write = 1: K11. kcur/kscur/vcur/vscur may be null when cur = 0.
extern "C" int paged_attn_int8(const void* q, void* kp, void* ks, void* vp,
                               void* vs, const void* kcur, const void* kscur,
                               const void* vcur, const void* vscur,
                               const void* bound, const void* tables, int B,
                               int Hkv, int G, int D, int LP, int pps, int cur,
                               int write, float scale, void* out,
                               void* stream) {
  if (G < 1 || G > GMAX || B < 0 || Hkv < 1 || pps < 1 || (write && !cur))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  switch (D) {
    case 64:
      return dispatch<64>(cur, write, q, kp, ks, vp, vs, kcur, kscur, vcur,
                          vscur, bound, tables, B, Hkv, G, LP, pps, scale,
                          out, stream);
    case 128:
      return dispatch<128>(cur, write, q, kp, ks, vp, vs, kcur, kscur, vcur,
                           vscur, bound, tables, B, Hkv, G, LP, pps, scale,
                           out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
