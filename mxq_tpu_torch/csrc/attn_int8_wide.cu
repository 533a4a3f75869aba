// The int8 family's wide path: K4 (K4a-K4d) and K9-K11 at head_dim D >
// 256, which no template of attn_split.cuh holds (its templates stage q
// as f32 [G*T, D] in shared memory, 128 KB at G*T = 64 and D = 512, and
// hold a row's D/16 code loads a lane in registers).
//
// Replaces, at those D, the same TPU kernels as attn_int8.cu (the K4
// family: mxq_tpu/ops/attn_int8.py _kernel_cur_write :318, _kernel :97,
// _stacked_kernel :232, _kernel_cur :154, the folded-cur kernel :1045)
// and paged_attn_int8.cu (K9-K11: _kernel_paged :559, _kernel_paged_cur
// :658, _kernel_paged_cur_write :773). Their Pallas blocks are [S, D]
// with group == head_dim, so they take any D; so does this path. The math
// and every bf16 rounding point are attn_split.cuh's, and so are the
// splits of 128 history rows, the scratch (attn_split::carve), the
// tickets and the ordered combine by the last block of a (b, kv head).
//
// What changes is that D is walked in column chunks of C = 256 (the D =
// 256 template's geometry, Geo<256>: 16 lanes a code row, 16 bytes a lane):
//   pass A (scores_wide_kernel)  one block a split, as before. For each
//     chunk in order it stages that chunk of q (f32 [G*T, 256], zeros
//     past D), loads its code bytes of the split's rows, and adds each
//     row's partial dot product to a running f32 sum in shared memory
//     (one lane owns each (query row, history row) sum, so every score is
//     ((c_0 + c_1) + c_2) + ... in chunk order). Only then is the sum
//     multiplied by k_scale * scale, as the template multiplies its one
//     dot product. The current token's logit (CUR) is summed the same
//     way. The split's maxima and scores go to the scratch as before.
//   pass B (values_wide_kernel)  one block a (split, column chunk): the
//     split's probabilities (the same bits in every chunk: the same
//     scores, maxima and code) times its chunk of V, the partial context
//     [.., chunk] written; chunk 0 writes the partial denominator. The
//     last of the (b, kv head)'s splits x chunks to finish combines every
//     column in split order (attn_split.cuh's combine). K4 and K11 write
//     the current token's code row (all D columns) and scale lanes once,
//     from the block of split 0, chunk 0.
// Code loads are attn_split::load16 with RAG set: 16, 4 or 1 bytes as the
// rows' alignment allows (the wrapper's code_load_bytes), zeros past D.
//
// Bound on the H100: bytes, as the templates (2 D code bytes a history row
// read once, two multiply-adds a code byte). Pass A still reads each code
// byte once; pass B reads each V byte once. The cost of the chunking is
// q staged once per chunk per split (from L2) and the scores re-read by
// each chunk's block of pass B (128 f32 per query row, beside 128 * 256
// code bytes a chunk).

#include "attn_split.cuh"

namespace attn_wide {

using namespace attn_split;

constexpr int C = 256;                   // columns a chunk
using Gw = Geo<C>;

template <bool PAGED, bool CUR>
__global__ void __launch_bounds__(THREADS, 2)
    scores_wide_kernel(const Args a) {
  const int d = a.D;
  const int nch = (d + C - 1) / C;
  extern __shared__ float smem[];
  const int Q = a.G * a.T;
  float* qf = smem;                      // [Q, C]: this chunk of q
  float* sst = qf + Q * C;               // [Q, CHUNK]: dot products
  float* scur = sst + Q * CHUNK;         // [Q]: the current token's
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * a.Hkv + h;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nmax = hist_rows<PAGED, CUR>(a, b, a.T - 1);
  const int nlive = max(1, (nmax + CHUNK - 1) / CHUNK);
  if (j >= nlive) return;
  const int c0 = j * CHUNK;
  const int nv = min(max(nmax - c0, 0), CHUNK);
  const int lcol = (lane % Gw::LPR) * 16;
  const WS w = carve(a, d);
  const size_t r0 = nv > 0 ? row0<PAGED>(a, b, h, j) : 0;

  for (int i = tid; i < Q * CHUNK; i += THREADS) sst[i] = 0.f;
  for (int i = tid; i < Q; i += THREADS) scur[i] = 0.f;
  for (int ch = 0; ch < nch; ++ch) {
    const int col = ch * C + lcol;
    uint4 kr[Gw::NSTEP];
#pragma unroll
    for (int i = 0; i < Gw::NSTEP; ++i) {
      const int s = row_of<C>(i, warp, lane);
      kr[i] = s < nv ? load16<true>(a.kc + (r0 + s) * d, col, a)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();                     // the last chunk's q is read
    for (int i = tid; i < Q * C; i += THREADS) {
      const int c = ch * C + i % C;
      qf[i] = c < d ? bf(a.q[qoff(a, b, h, i / C, d) + c]) : 0.f;
    }
    __syncthreads();
    if (CUR && j == 0) {
      float kf[16];
      unpack16(load16<true>(a.kcur + (size_t)bh * d, col, a), kf);
      for (int r = warp; r < Q; r += NW) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) s += qf[r * C + lcol + e] * kf[e];
        s = group_sum<Gw::LPR>(s);
        if (lane == 0) scur[r] += s;
      }
    }
    for (int r = 0; r < Q; ++r) {
      float qv[16];
      const float4* q4 = reinterpret_cast<const float4*>(qf + r * C + lcol);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 v = q4[e];
        qv[4 * e] = v.x; qv[4 * e + 1] = v.y;
        qv[4 * e + 2] = v.z; qv[4 * e + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < Gw::NSTEP; ++i) {
        float kf[16];
        unpack16(kr[i], kf);
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) s += qv[e] * kf[e];
        s = group_sum<Gw::LPR>(s);
        if (lane % Gw::LPR == 0) sst[r * CHUNK + row_of<C>(i, warp, lane)] += s;
      }
    }
  }
  // the dot products times k_scale * scale, by the lane that owns them
  float ksc[Gw::NSTEP];
#pragma unroll
  for (int i = 0; i < Gw::NSTEP; ++i) {
    const int s = row_of<C>(i, warp, lane);
    ksc[i] = s < nv ? bf(a.ks[r0 + s]) * a.scale : 0.f;
  }
  if (lane % Gw::LPR == 0)
    for (int r = 0; r < Q; ++r)
#pragma unroll
      for (int i = 0; i < Gw::NSTEP; ++i)
        sst[r * CHUNK + row_of<C>(i, warp, lane)] *= ksc[i];
  if (CUR && j == 0)
    for (int r = warp; r < Q; r += NW)
      if (lane == 0)
        w.stc[(size_t)bh * Q + r] = scur[r] * (bf(a.kscur[bh]) * a.scale);
  __syncthreads();

  for (int r = warp; r < Q; r += NW) {   // the split's max per query row
    const int nr = min(max(hist_rows<PAGED, CUR>(a, b, r / a.G) - c0, 0),
                       CHUNK);
    float m = NEG;
    for (int s = lane; s < nr; s += 32) m = fmaxf(m, sst[r * CHUNK + s]);
    m = warp_max(m);
    if (lane == 0) w.mx[((size_t)bh * Q + r) * a.NS + j] = m;
  }
  for (int i = tid; i < Q * CHUNK; i += THREADS)
    w.sc[((size_t)bh * Q + i / CHUNK) * a.NS * CHUNK + c0 + i % CHUNK] =
        sst[i];
}

template <bool PAGED, bool CUR, bool WRITE>
__global__ void __launch_bounds__(THREADS, 2)
    values_wide_kernel(const Args a) {
  const int d = a.D;
  const int nch = (d + C - 1) / C;
  extern __shared__ float smem[];
  const int Q = a.G * a.T;
  float* pv = smem;                      // [Q, CHUNK]: scores, then pv
  float* mr = pv + Q * CHUNK;            // [Q]: the max each row rounds at
  float* vss = mr + Q;                   // [CHUNK]
  float* red = vss + CHUNK;              // [NW, QT, C]
  __shared__ int last;
  const int j = blockIdx.x / nch, ch = blockIdx.x % nch;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * a.Hkv + h;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nmax = hist_rows<PAGED, CUR>(a, b, a.T - 1);
  const int nlive = max(1, (nmax + CHUNK - 1) / CHUNK);
  if (j >= nlive) return;
  const int c0 = j * CHUNK;
  const int nv = min(max(nmax - c0, 0), CHUNK);
  const int lcol = (lane % Gw::LPR) * 16;
  const int col0 = ch * C;               // the chunk's first column
  const WS w = carve(a, d);

  uint4 vr[Gw::NSTEP];
  const size_t r0 = nv > 0 ? row0<PAGED>(a, b, h, j) : 0;
#pragma unroll
  for (int i = 0; i < Gw::NSTEP; ++i) {
    const int s = row_of<C>(i, warp, lane);
    vr[i] = s < nv ? load16<true>(a.vc + (r0 + s) * d, col0 + lcol, a)
                   : make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid < CHUNK) vss[tid] = tid < nv ? bf(a.vs[r0 + tid]) : 0.f;
  for (int r = warp; r < Q; r += NW) {
    const float* mx = w.mx + ((size_t)bh * Q + r) * a.NS;
    float m = NEG;
    for (int jj = lane; jj < (PAGED ? j + 1 : nlive); jj += 32)
      m = fmaxf(m, mx[jj]);
    m = warp_max(m);
    if (!PAGED && CUR) m = fmaxf(m, w.stc[(size_t)bh * Q + r]);
    if (lane == 0) mr[r] = m;
  }
  for (int i = tid; i < Q * CHUNK; i += THREADS)
    pv[i] = w.sc[((size_t)bh * Q + i / CHUNK) * a.NS * CHUNK + c0
                 + i % CHUNK];
  __syncthreads();

  // e = exp(st - m), bf16(e * v_scale) and the partial denominator
  for (int r = warp; r < Q; r += NW) {
    const int nr = min(max(hist_rows<PAGED, CUR>(a, b, r / a.G) - c0, 0),
                       CHUNK);
    const float m = mr[r];
    float l = 0.f;
    for (int s = lane; s < CHUNK; s += 32) {
      float p = 0.f;
      if (s < nr) {
        const float e = expf(pv[r * CHUNK + s] - m);
        l += e;
        p = bf16_round(e * vss[s]);
      }
      pv[r * CHUNK + s] = p;
    }
    l = warp_sum(l);
    if (lane == 0 && ch == 0) w.pden[((size_t)bh * Q + r) * a.NS + j] = l;
  }
  __syncthreads();

  // the split's partial context in this chunk's columns
  const int ncol = min(C, d - col0);
  for (int q0 = 0; q0 < Q; q0 += QT) {
    const int nq = min(QT, Q - q0);
    for (int rr = 0; rr < nq; ++rr) {
      const float* pr = pv + (q0 + rr) * CHUNK;
      float acc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = 0.f;
#pragma unroll
      for (int i = 0; i < Gw::NSTEP; ++i) {
        const float p = pr[row_of<C>(i, warp, lane)];
        float vf[16];
        unpack16(vr[i], vf);
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] += p * vf[e];
      }
#pragma unroll
      for (int o = Gw::LPR; o < 32; o <<= 1)
#pragma unroll
        for (int e = 0; e < 16; ++e)
          acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
      if (lane < Gw::LPR)
#pragma unroll
        for (int e = 0; e < 16; ++e)
          red[(warp * QT + rr) * C + lcol + e] = acc[e];
    }
    __syncthreads();
    for (int i = tid; i < nq * ncol; i += THREADS) {
      const int rr = i / ncol, c = i % ncol;
      float s = 0.f;
#pragma unroll
      for (int ww = 0; ww < NW; ++ww) s += red[(ww * QT + rr) * C + c];
      w.pctx[(((size_t)bh * Q + q0 + rr) * a.NS + j) * d + col0 + c] = s;
    }
    __syncthreads();
  }
  if (WRITE && j == 0 && ch == 0) write_current<C, true, PAGED>(a, b, h, tid);

  // the last block of (b, h) to get here combines the splits in order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.tickets + bh, 1) == nlive * nch - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < Q * d; i += THREADS) {
    const int r = i / d, dc = i % d;
    const size_t br = (size_t)bh * Q + r;
    const float* pc = w.pctx + br * a.NS * d + dc;
    const float* pd = w.pden + br * a.NS;
    float acc = 0.f, l = 0.f, o;
    if (PAGED) {
      const float* mx = w.mx + br * a.NS;
      float mfin = NEG;
      for (int jj = 0; jj < nlive; ++jj) mfin = fmaxf(mfin, __ldcg(mx + jj));
      float m = NEG;
      for (int jj = 0; jj < nlive; ++jj) {
        m = fmaxf(m, __ldcg(mx + jj));
        const float f = expf(m - mfin);
        acc += __ldcg(pc + (size_t)jj * d) * f;
        l += __ldcg(pd + jj) * f;
      }
      if (CUR) {
        const float c = __ldcg(w.stc + br);
        const float m2 = fmaxf(mfin, c);
        const float alpha2 = expf(mfin - m2);
        const float pcur = expf(c - m2);
        l = l * alpha2 + pcur;
        acc = acc * alpha2 + bf16_round(pcur * bf(a.vscur[bh]))
                             * (float)a.vcur[(size_t)bh * d + dc];
      }
      o = acc / fmaxf(l, 1e-30f);
    } else {
      for (int jj = 0; jj < nlive; ++jj) {
        acc += __ldcg(pc + (size_t)jj * d);
        l += __ldcg(pd + jj);
      }
      if (CUR) {
        const float ec = expf(__ldcg(w.stc + br) - mr[r]);
        l += ec;
        acc += bf16_round(ec * bf(a.vscur[bh]))
               * (float)a.vcur[(size_t)bh * d + dc];
      }
      o = acc / l;
    }
    a.out[qoff(a, b, h, r, d) + dc] = o;
  }
  if (tid == 0) a.tickets[bh] = 0;
}

template <bool PAGED, bool CUR, bool WRITE>
int launch(const Args& a, void* stream) {
  const int Q = a.G * a.T;
  const int nch = (a.D + C - 1) / C;
  const size_t sa = sizeof(float) * ((size_t)Q * (C + CHUNK) + Q);
  const size_t sb = sizeof(float) * ((size_t)Q * (CHUNK + 1) + CHUNK
                                     + (size_t)NW * QT * C);
  auto ka = scores_wide_kernel<PAGED, CUR>;
  auto kb = values_wide_kernel<PAGED, CUR, WRITE>;
  cudaError_t err = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sa);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sb);
  if (err != cudaSuccess) return (int)err;
  ka<<<dim3(a.NS, a.Hkv, a.B), THREADS, sa, (cudaStream_t)stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kb<<<dim3(a.NS * nch, a.Hkv, a.B), THREADS, sb, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// attn_split::dispatch's checks, for head_dim D > 256: the flags' three
// kernels. Returns a cudaError_t.
template <bool PAGED>
int dispatch(const Args& a, int cur, int write, void* stream) {
  const int d = a.D;
  if ((write && !cur) || (cur && a.T != 1) || !rows_ok(a) || a.B < 0
      || a.B > 65535 || a.Hkv < 1
      || a.Hkv > 65535 || a.NS < 1 || d <= 256
      || (long long)a.NS * ((d + C - 1) / C) > 0x7fffffffLL
      || (a.vec != 16 && a.vec != 4 && a.vec != 1) || d % a.vec)
    return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  if (!cur) return launch<PAGED, false, false>(a, stream);
  return write ? launch<PAGED, true, true>(a, stream)
               : launch<PAGED, true, false>(a, stream);
}

}  // namespace attn_wide

// attn_int8 (attn_int8.cu) at head_dim D > 256: the same arguments, the
// same scratch and tickets. Returns a cudaError_t.
extern "C" int attn_int8_wide(const void* q, void* kc, void* ks, void* vc,
                              void* vs, const void* kcur, const void* kscur,
                              const void* vcur, const void* vscur,
                              const void* positions, int B, int Hkv, int G,
                              int T, int Gq, int g0, int Tq, int t0, int S,
                              int D, int cur, int write,
                              int vec, float scale, void* ws, void* tickets,
                              void* out, void* stream) {
  if (S < 1) return (int)cudaErrorInvalidValue;
  attn_split::Args a{
      (const __nv_bfloat16*)q, (int8_t*)kc, (__nv_bfloat16*)ks,
      (int8_t*)vc, (__nv_bfloat16*)vs, (const int8_t*)kcur,
      (const __nv_bfloat16*)kscur, (const int8_t*)vcur,
      (const __nv_bfloat16*)vscur, (const int*)positions, nullptr,
      B, Hkv, G, T, S, 0, (S + attn_split::CHUNK - 1) / attn_split::CHUNK,
      scale, (float*)ws, (int*)tickets, (float*)out, D, vec, Gq, g0, Tq,
      t0};
  return attn_wide::dispatch<false>(a, cur, write, stream);
}

// paged_attn_int8 (paged_attn_int8.cu) at head_dim D > 256: the same
// arguments, the same scratch and tickets. Returns a cudaError_t.
extern "C" int paged_attn_int8_wide(const void* q, void* kp, void* ks,
                                    void* vp, void* vs, const void* kcur,
                                    const void* kscur, const void* vcur,
                                    const void* vscur, const void* bound,
                                    const void* tables, int B, int Hkv, int G,
                                    int Gq, int g0, int D, int LP, int pps,
                                    int cur,
                                    int write, int vec, float scale, void* ws,
                                    void* tickets, void* out, void* stream) {
  attn_split::Args a{
      (const __nv_bfloat16*)q, (int8_t*)kp, (__nv_bfloat16*)ks,
      (int8_t*)vp, (__nv_bfloat16*)vs, (const int8_t*)kcur,
      (const __nv_bfloat16*)kscur, (const int8_t*)vcur,
      (const __nv_bfloat16*)vscur, (const int*)bound, (const int*)tables,
      B, Hkv, G, 1, 0, LP, pps, scale, (float*)ws, (int*)tickets,
      (float*)out, D, vec, Gq, g0, 1, 0};
  return attn_wide::dispatch<true>(a, cur, write, stream);
}
