// K4 family: one-token GQA decode attention over the int8 KV cache of one
// layer of the stacked cache, one kernel with two compile-time flags:
//   CUR=1, WRITE=1  K4   the current token folded in out of cache and its
//                        K/V code rows written into the cache in place
//   CUR=0, WRITE=0  K4a  rows s <= pos only, no current token (K4c: the
//                        same launch, the layer read out of the stack)
//   CUR=1, WRITE=0  K4b  rows s < pos plus the current token, no write
//                        (K4d: the same launch on the stack)
//
// Replaces the TPU kernels in mxq_tpu/ops/attn_int8.py: _kernel_cur_write
// (:318) via int8_decode_attention_fused_write (:449), dispatched by
// decode_attend_update (:1149); _kernel (:97, int8_decode_attention :491)
// and _stacked_kernel (:232, int8_decode_attention_stacked :287), which the
// engine's speculative verify runs once per query; _kernel_cur (:154,
// int8_decode_attention_cur :201) and the kernel of _attn_call_cur_folded
// (:1045, int8_decode_attention_cur_folded :1123). The TPU's 8-row octet
// write windows, aliased outputs, g8 = max(8, G) padding and folded-stack
// reshapes were Mosaic devices; here a layer of the stack is a pointer
// offset and the code rows are stored directly at row pos[b].
//
// Math per (batch b, kv head h), its G query heads, p = pos[b] (_attend,
// attn_int8.py:50-94):
//   st[g,s] = (q[g] . kc[s]) * (ks[s] * scale)   rows s < p (CUR) or <= p
//   stc[g]  = (q[g] . kcur)  * (kscur * scale)   the current token (CUR)
//   m = max(st, stc); e = exp(st - m); ec = exp(stc - m)
//   ctx[g] = (sum_s bf16(e*vs[s]) * vc[s] + bf16(ec*vscur) * vcur)
//            / (sum_s e + ec)
// q is bf16; p*v_scale is rounded to bf16 against the global max before
// the V sum for cache rows and the current row alike (attn_int8.py:81,91).
// expf, not fast math.
//
// Bound on the H100: bytes — every attended code row is read once (2*D
// bytes per row per (b, h)), with two multiply-adds per byte. One block of
// 8 warps per (b, h): in the score pass a warp reads one code row per step
// (D/32 bytes a lane, coalesced) and reduces across lanes with shuffles;
// scores stay in shared memory (G*S f32); in the V pass each warp
// accumulates its rows into registers and the warps are summed through
// shared memory. Not yet tuned: no split over S, so a (b, h) pair is one
// block however long its history is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int GMAX = 8;

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

template <int D, bool CUR, bool WRITE>
__global__ void __launch_bounds__(THREADS)
attn_int8_kernel(const __nv_bfloat16* __restrict__ q,   // [B, Hkv, G, D]
                 int8_t* __restrict__ kc,               // [B, Hkv, S, D]
                 const __nv_bfloat16* __restrict__ ks,  // [B, Hkv, S]
                 int8_t* __restrict__ vc,
                 const __nv_bfloat16* __restrict__ vs,
                 const int8_t* __restrict__ kcur,       // [B, Hkv, D] (CUR)
                 const __nv_bfloat16* __restrict__ kscur,  // [B, Hkv]
                 const int8_t* __restrict__ vcur,
                 const __nv_bfloat16* __restrict__ vscur,
                 const int* __restrict__ positions,     // [B]
                 int Hkv, int G, int S, float scale,
                 float* __restrict__ out) {              // [B, Hkv, G, D]
  constexpr int E = D / 32;                 // code bytes per lane
  extern __shared__ float smem[];
  float* qf = smem;                         // [G, D]
  float* st = qf + G * D;                   // [G, S]: scores, then bf16 p*vs
  float* red = st + G * S;                  // [NW, G, D]
  __shared__ float stc[GMAX], mx[GMAX], den[GMAX], pcv[GMAX];
  __shared__ float wred[NW][GMAX];

  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int pos = positions[b];
  // history rows s < pos with the current token, s <= pos without it
  const int nrows = min(max(CUR ? pos : pos + 1, 0), S);
  const size_t cbase = (size_t)bh * S * D;
  const size_t sbase = (size_t)bh * S;

  for (int i = tid; i < G * D; i += THREADS)
    qf[i] = __bfloat162float(q[(size_t)bh * G * D + i]);
  __syncthreads();

  // current token's logits (one warp per query head)
  if (CUR && warp < G) {
    float a = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e)
      a += qf[warp * D + lane * E + e] * (float)kcur[(size_t)bh * D + lane * E + e];
    a = warp_sum(a);
    if (lane == 0)
      stc[warp] = a * (__bfloat162float(kscur[bh]) * scale);
  }

  // scores over the history: one code row per warp step
  for (int s = warp; s < nrows; s += NW) {
    const int8_t* row = kc + cbase + (size_t)s * D + lane * E;
    float k[E];
#pragma unroll
    for (int e = 0; e < E; ++e) k[e] = (float)row[e];
    const float ksc = __bfloat162float(ks[sbase + s]) * scale;
    for (int g = 0; g < G; ++g) {
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) a += qf[g * D + lane * E + e] * k[e];
      a = warp_sum(a);
      if (lane == 0) st[g * S + s] = a * ksc;
    }
  }
  __syncthreads();

  // softmax statistics per query head
  for (int g = 0; g < G; ++g) {
    float m = -INFINITY;
    for (int s = tid; s < nrows; s += THREADS) m = fmaxf(m, st[g * S + s]);
    m = warp_max(m);
    if (lane == 0) wred[warp][g] = m;
  }
  __syncthreads();
  if (tid < G) {
    float m = CUR ? stc[tid] : -INFINITY;
    for (int w = 0; w < NW; ++w) m = fmaxf(m, wred[w][tid]);
    mx[tid] = m;
  }
  __syncthreads();
  for (int g = 0; g < G; ++g) {
    const float m = mx[g];
    float d = 0.f;
    for (int s = tid; s < nrows; s += THREADS) {
      const float e = expf(st[g * S + s] - m);
      d += e;
      st[g * S + s] = bf16_round(e * __bfloat162float(vs[sbase + s]));
    }
    d = warp_sum(d);
    if (lane == 0) wred[warp][g] = d;
  }
  __syncthreads();
  if (tid < G) {
    float d = 0.f;
    for (int w = 0; w < NW; ++w) d += wred[w][tid];
    if (CUR) {
      const float ec = expf(stc[tid] - mx[tid]);
      den[tid] = d + ec;
      pcv[tid] = bf16_round(ec * __bfloat162float(vscur[bh]));
    } else {
      den[tid] = d;
    }
  }
  __syncthreads();

  // V pass: warp-strided rows, lane-owned columns
  float acc[GMAX][E];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  for (int s = warp; s < nrows; s += NW) {
    const int8_t* row = vc + cbase + (size_t)s * D + lane * E;
    float v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = (float)row[e];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        const float p = st[g * S + s];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] += p * v[e];
      }
    }
  }
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
    if (CUR) a += pcv[g] * (float)vcur[(size_t)bh * D + d];
    out[(size_t)bh * G * D + i] = a / den[g];
  }

  // commit the current token's code rows (row pos is never read above)
  if (WRITE && pos >= 0 && pos < S) {
    for (int i = tid; i < D; i += THREADS) {
      kc[cbase + (size_t)pos * D + i] = kcur[(size_t)bh * D + i];
      vc[cbase + (size_t)pos * D + i] = vcur[(size_t)bh * D + i];
    }
  }
}

template <int D, bool CUR, bool WRITE>
int launch(const void* q, void* kc, const void* ks, void* vc, const void* vs,
           const void* kcur, const void* kscur, const void* vcur,
           const void* vscur, const void* positions, int B, int Hkv, int G,
           int S, float scale, void* out, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)G * D + (size_t)G * S
                                       + (size_t)NW * G * D);
  cudaError_t err = cudaFuncSetAttribute(
      attn_int8_kernel<D, CUR, WRITE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_int8_kernel<D, CUR, WRITE>
      <<<B * Hkv, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (int8_t*)kc, (const __nv_bfloat16*)ks,
      (int8_t*)vc, (const __nv_bfloat16*)vs, (const int8_t*)kcur,
      (const __nv_bfloat16*)kscur, (const int8_t*)vcur,
      (const __nv_bfloat16*)vscur, (const int*)positions, Hkv, G, S, scale,
      (float*)out);
  return (int)cudaGetLastError();
}

template <int D>
int launch_flags(int cur, int write, const void* q, void* kc, const void* ks,
                 void* vc, const void* vs, const void* kcur,
                 const void* kscur, const void* vcur, const void* vscur,
                 const void* positions, int B, int Hkv, int G, int S,
                 float scale, void* out, void* stream) {
  if (cur && write)
    return launch<D, true, true>(q, kc, ks, vc, vs, kcur, kscur, vcur, vscur,
                                 positions, B, Hkv, G, S, scale, out, stream);
  if (cur)
    return launch<D, true, false>(q, kc, ks, vc, vs, kcur, kscur, vcur,
                                  vscur, positions, B, Hkv, G, S, scale, out,
                                  stream);
  if (!write)
    return launch<D, false, false>(q, kc, ks, vc, vs, kcur, kscur, vcur,
                                   vscur, positions, B, Hkv, G, S, scale,
                                   out, stream);
  return (int)cudaErrorInvalidValue;           // a write needs the token
}

}  // namespace

// cur, write: the flags above (K4: 1, 1; K4a/K4c: 0, 0; K4b/K4d: 1, 0).
// kcur/kscur/vcur/vscur are not read when cur is 0.
extern "C" int attn_int8(const void* q, void* kc, const void* ks, void* vc,
                         const void* vs, const void* kcur, const void* kscur,
                         const void* vcur, const void* vscur,
                         const void* positions, int B, int Hkv, int G, int S,
                         int D, int cur, int write, float scale, void* out,
                         void* stream) {
  if (G < 1 || G > GMAX) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch_flags<64>(cur, write, q, kc, ks, vc, vs, kcur, kscur,
                              vcur, vscur, positions, B, Hkv, G, S, scale,
                              out, stream);
    case 128:
      return launch_flags<128>(cur, write, q, kc, ks, vc, vs, kcur, kscur,
                               vcur, vscur, positions, B, Hkv, G, S, scale,
                               out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
