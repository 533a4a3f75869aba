// The two-pass, split-history decode attention over an int8 KV cache that
// the K4 family (attn_int8.cu, a dense [B, Hkv, S, D] layer of the stacked
// cache) and K9-K11 (paged_attn_int8.cu, the folded page pool) share.
//
// A (batch b, kv head h) pair attends Q = G * T query rows: its G query
// heads for each of T query tokens (T > 1 only for K4a, the speculative
// verify: token t sees rows <= pos + t). Its history is cut into splits of
// CHUNK = 128 rows (a page of the pool), one block per (split, h, b), so a
// long history is read by many blocks at once: at B=8, Hkv=32 and the
// positions {0 .. 2046} of chip_smoke.py 1,888 blocks hold rows where one
// block per (b, h) made 256. Blocks past the longest query's bound exit
// at once; the paged pool's pages past the bound (the null page) are
// never read.
//
//   pass A (scores_kernel)  each thread loads 16 code bytes of up to
//     CHUNK*D/4096 rows at once (D/16 threads per row, all loads in flight
//     before any arithmetic), reduces each row's dot product over its D/16
//     lanes (3 shuffle levels at D=128) and writes the f32 score of every
//     (query row, history row) and the split's max per query row to a
//     scratch in device memory, and the current token's logit (CUR).
//   pass B (values_kernel)  each block forms the max its rounding must see
//     (dense: the GLOBAL max over every split and the current token, as
//     mxq_tpu/ops/attn_int8.py:77-91 rounds against; paged: the RUNNING
//     max of pages 0..j, the prefix max of the page maxima in table order,
//     as the TPU kernel's sequential page fold :585-596 rounds against),
//     then e = exp(st - m), bf16(e * v_scale) and its split's partial
//     denominator and context over its 16-byte V loads. The last block of
//     a (b, h) to finish (an atomic ticket, reset to 0 by that block)
//     combines the splits in split order, so the result is deterministic:
//     dense, sum the partials, fold the current token in and divide;
//     paged, scale page j by exp(m_j - m_final), fold the current token in
//     against the running max and divide by max(l, 1e-30).
// Every bf16 rounding sees the input it has in the sequential plain
// versions; only f32 sums run in another order (and, paged, the product of
// the rescales alpha_j becomes one exp(m_j - m_final)).
//
// Why CHUNK = 128: one page of the pool, so one split is one page; 16 KB
// of codes per block and pass, 64 bytes in flight per thread; and the
// partial contexts [.., nsplit, D] are no larger than the codes they
// replace. Query rows are accumulated QT = 8 at a time (registers), so Q
// is bounded only by shared memory (QMAX = 64; llama2_70b's G = 8 with
// five verify tokens is 40). A call of more query rows is cut by its
// wrapper into launches of floor(64 / G) tokens (ops/attn_int8.py
// token_chunks), each at positions + its first token.
//
// Bound on the H100: bytes (two multiply-adds per code byte, one query
// row per head: no tensor-core work). Two launches per call. What bounds
// a pass is latency: each block loads, computes and writes in turn, so
// the number of blocks resident on an SM sets the bytes in flight. The
// codes stay packed in registers until a dot product needs them, and
// __launch_bounds__ holds a thread to 85 registers so that three blocks
// share an SM (measured on the H100 at the shapes of chip_smoke.py: the
// codes unpacked up front at 97-128 registers, the same code without the
// cap, or a cap of 64 registers with spills were 7-50% slower; 128-thread
// blocks no faster).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn_split {

constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 3;              // per SM: at most 85 registers
constexpr int NW = THREADS / 32;
constexpr int CHUNK = 128;                 // rows per split (= a page)
constexpr int QT = 8;                      // query rows per V tile
constexpr int QMAX = 64;                   // query rows per (b, kv head)
constexpr float NEG = -3.402823466e38f;    // f32 min, the TPU kernels' NEG

struct Args {
  const __nv_bfloat16* q;     // [B, T, Hkv, G, D]
  int8_t* kc;                 // dense [B, Hkv, S, D]; paged [Hkv, LP, 128, D]
  __nv_bfloat16* ks;          // dense [B, Hkv, S];    paged [Hkv, LP, 128]
  int8_t* vc;
  __nv_bfloat16* vs;
  const int8_t* kcur;         // [B, Hkv, D] (CUR)
  const __nv_bfloat16* kscur; // [B, Hkv]
  const int8_t* vcur;
  const __nv_bfloat16* vscur;
  const int* bound;           // [B]: dense positions; paged the row bound
  const int* tables;          // [B, NS] physical page ids (paged)
  int B, Hkv, G, T, S, LP;
  int NS;                     // splits per (b, h): ceil(S / 128) or pps
  float scale;
  float* ws;                  // scratch, see carve()
  int* tickets;               // [B * Hkv], 0 between calls
  float* out;                 // [B, T, Hkv, G, D] f32
};

template <int D>
struct Geo {
  static constexpr int LPR = D / 16;            // lanes per code row
  static constexpr int RPW = 32 / LPR;          // rows per warp and step
  static constexpr int RSTEP = NW * RPW;        // rows per block and step
  static constexpr int NSTEP = CHUNK / RSTEP;   // steps per split
};

// the scratch: f32 scores [BHQ, NS, 128], split maxima [BHQ, NS], current
// logits [BHQ], partial contexts [BHQ, NS, D], partial denominators
// [BHQ, NS]; BHQ = B * Hkv * Q. The wrapper sizes it the same way.
struct WS {
  float *sc, *mx, *stc, *pctx, *pden;
};

template <int D>
__device__ __forceinline__ WS carve(const Args& a) {
  const size_t bhq = (size_t)a.B * a.Hkv * a.G * a.T;
  WS w;
  w.sc = a.ws;
  w.mx = w.sc + bhq * a.NS * CHUNK;
  w.stc = w.mx + bhq * a.NS;
  w.pctx = w.stc + bhq;
  w.pden = w.pctx + bhq * a.NS * D;
  return w;
}

__device__ __forceinline__ float bf(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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

// sum over the W consecutive lanes that share a code row
template <int W>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 int8 codes (one 16-byte load) as floats, in memory order
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[16]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[4 * i + k] = (float)(((int)(w[i] << (24 - 8 * k))) >> 24);
}

// history rows query token t attends: dense rows < pos (CUR) or <= pos + t;
// paged rows < bound, within the table
template <bool PAGED, bool CUR>
__device__ __forceinline__ int hist_rows(const Args& a, int b, int t) {
  const int p = a.bound[b];
  if (PAGED) return min(max(p, 0), a.NS * CHUNK);
  return min(max(CUR ? p : p + t + 1, 0), a.S);
}

// index of split j's first row in the code rows (times D) and the scales
template <bool PAGED>
__device__ __forceinline__ size_t row0(const Args& a, int b, int h, int j) {
  if (PAGED)
    return ((size_t)h * a.LP + a.tables[(size_t)b * a.NS + j]) * CHUNK;
  return ((size_t)b * a.Hkv + h) * a.S + (size_t)j * CHUNK;
}

template <int D>
__device__ __forceinline__ size_t qoff(const Args& a, int b, int h, int r) {
  const int t = r / a.G, g = r % a.G;
  return ((((size_t)b * a.T + t) * a.Hkv + h) * a.G + g) * D;
}

// the row of this thread in step i of a split
template <int D>
__device__ __forceinline__ int row_of(int i, int warp, int lane) {
  using G = Geo<D>;
  return i * G::RSTEP + warp * G::RPW + lane / G::LPR;
}

// this thread's 16 bytes of each of its rows < nv of the split at r0
template <int D>
__device__ __forceinline__ void load_rows(const int8_t* codes, size_t r0,
                                          int nv, int warp, int lane,
                                          uint4 (&c)[Geo<D>::NSTEP]) {
  const int col = (lane % Geo<D>::LPR) * 16;
#pragma unroll
  for (int i = 0; i < Geo<D>::NSTEP; ++i) {
    const int s = row_of<D>(i, warp, lane);
    c[i] = s < nv ? __ldg(reinterpret_cast<const uint4*>(
                        codes + (r0 + s) * D + col))
                  : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int D, bool PAGED, bool CUR>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) scores_kernel(const Args a) {
  using G = Geo<D>;
  extern __shared__ float smem[];
  const int Q = a.G * a.T;
  float* qf = smem;                      // [Q, D]
  float* sst = qf + Q * D;               // [Q, CHUNK]
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * a.Hkv + h;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nmax = hist_rows<PAGED, CUR>(a, b, a.T - 1);
  const int nlive = max(1, (nmax + CHUNK - 1) / CHUNK);
  if (j >= nlive) return;
  const int c0 = j * CHUNK;
  const int nv = min(max(nmax - c0, 0), CHUNK);
  const int col = (lane % G::LPR) * 16;
  const WS w = carve<D>(a);

  uint4 kr[G::NSTEP];
  float ksc[G::NSTEP];
  const size_t r0 = nv > 0 ? row0<PAGED>(a, b, h, j) : 0;
  load_rows<D>(a.kc, r0, nv, warp, lane, kr);
#pragma unroll
  for (int i = 0; i < G::NSTEP; ++i) {
    const int s = row_of<D>(i, warp, lane);
    ksc[i] = s < nv ? bf(a.ks[r0 + s]) * a.scale : 0.f;
  }
  for (int i = tid; i < Q * D; i += THREADS)
    qf[i] = bf(a.q[qoff<D>(a, b, h, i / D) + i % D]);
  __syncthreads();

  if (CUR && j == 0) {                   // the current token's logits
    float kf[16];
    unpack16(__ldg(reinterpret_cast<const uint4*>(a.kcur + (size_t)bh * D
                                                  + col)), kf);
    for (int r = warp; r < Q; r += NW) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) s += qf[r * D + col + e] * kf[e];
      s = group_sum<G::LPR>(s);
      if (lane == 0)
        w.stc[(size_t)bh * Q + r] = s * (bf(a.kscur[bh]) * a.scale);
    }
  }

  for (int r = 0; r < Q; ++r) {
    float qv[16];
    const float4* q4 = reinterpret_cast<const float4*>(qf + r * D + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 v = q4[e];
      qv[4 * e] = v.x; qv[4 * e + 1] = v.y;
      qv[4 * e + 2] = v.z; qv[4 * e + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < G::NSTEP; ++i) {
      float kf[16];
      unpack16(kr[i], kf);
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) s += qv[e] * kf[e];
      s = group_sum<G::LPR>(s);
      if (lane % G::LPR == 0)
        sst[r * CHUNK + row_of<D>(i, warp, lane)] = s * ksc[i];
    }
  }
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

// K4 / K11: the current token's code rows (and, paged, its scale lanes)
// stored in place. The call never reads that row: dense rows < pos, paged
// rows < n.
template <int D, bool PAGED>
__device__ __forceinline__ void write_current(const Args& a, int b, int h,
                                              int tid) {
  const int bh = b * a.Hkv + h;
  size_t row;
  if (PAGED) {
    const int n = max(a.bound[b], 0);
    if (n / CHUNK >= a.NS) return;
    row = ((size_t)h * a.LP + a.tables[(size_t)b * a.NS + n / CHUNK])
          * CHUNK + n % CHUNK;
    if (tid == 0) {
      a.ks[row] = a.kscur[bh];
      a.vs[row] = a.vscur[bh];
    }
  } else {
    const int p = a.bound[b];
    if (p < 0 || p >= a.S) return;
    row = (size_t)bh * a.S + p;
  }
  for (int i = tid; i < D; i += THREADS) {
    a.kc[row * D + i] = a.kcur[(size_t)bh * D + i];
    a.vc[row * D + i] = a.vcur[(size_t)bh * D + i];
  }
}

template <int D, bool PAGED, bool CUR, bool WRITE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) values_kernel(const Args a) {
  using G = Geo<D>;
  extern __shared__ float smem[];
  const int Q = a.G * a.T;
  float* pv = smem;                      // [Q, CHUNK]: scores, then pv
  float* mr = pv + Q * CHUNK;            // [Q]: the max each row rounds at
  float* vss = mr + Q;                   // [CHUNK]
  float* red = vss + CHUNK;              // [NW, QT, D]
  __shared__ int last;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * a.Hkv + h;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nmax = hist_rows<PAGED, CUR>(a, b, a.T - 1);
  const int nlive = max(1, (nmax + CHUNK - 1) / CHUNK);
  if (j >= nlive) return;
  const int c0 = j * CHUNK;
  const int nv = min(max(nmax - c0, 0), CHUNK);
  const int col = (lane % G::LPR) * 16;
  const WS w = carve<D>(a);

  uint4 vr[G::NSTEP];
  const size_t r0 = nv > 0 ? row0<PAGED>(a, b, h, j) : 0;
  load_rows<D>(a.vc, r0, nv, warp, lane, vr);
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
    if (lane == 0) w.pden[((size_t)bh * Q + r) * a.NS + j] = l;
  }
  __syncthreads();

  // the split's partial context, QT query rows at a time
  for (int q0 = 0; q0 < Q; q0 += QT) {
    const int nq = min(QT, Q - q0);
    for (int rr = 0; rr < nq; ++rr) {
      const float* pr = pv + (q0 + rr) * CHUNK;
      float acc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = 0.f;
#pragma unroll
      for (int i = 0; i < G::NSTEP; ++i) {
        const float p = pr[row_of<D>(i, warp, lane)];
        float vf[16];
        unpack16(vr[i], vf);
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] += p * vf[e];
      }
#pragma unroll
      for (int o = G::LPR; o < 32; o <<= 1)
#pragma unroll
        for (int e = 0; e < 16; ++e)
          acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
      if (lane < G::LPR)
#pragma unroll
        for (int e = 0; e < 16; ++e)
          red[(warp * QT + rr) * D + col + e] = acc[e];
    }
    __syncthreads();
    for (int i = tid; i < nq * D; i += THREADS) {
      const int rr = i / D, d = i % D;
      float s = 0.f;
#pragma unroll
      for (int ww = 0; ww < NW; ++ww) s += red[(ww * QT + rr) * D + d];
      w.pctx[(((size_t)bh * Q + q0 + rr) * a.NS + j) * D + d] = s;
    }
    __syncthreads();
  }
  if (WRITE && j == 0) write_current<D, PAGED>(a, b, h, tid);

  // the last block of (b, h) to get here combines the splits in order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.tickets + bh, 1) == nlive - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < Q * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const size_t br = (size_t)bh * Q + r;
    const float* pc = w.pctx + br * a.NS * D + d;
    const float* pd = w.pden + br * a.NS;
    float acc = 0.f, l = 0.f, o;
    if (PAGED) {
      // page j was rounded against m_j = max(NEG, maxima 0..j): rescale
      // each to the final running max, in page order
      const float* mx = w.mx + br * a.NS;
      float mfin = NEG;
      for (int jj = 0; jj < nlive; ++jj) mfin = fmaxf(mfin, __ldcg(mx + jj));
      float m = NEG;
      for (int jj = 0; jj < nlive; ++jj) {
        m = fmaxf(m, __ldcg(mx + jj));
        const float f = expf(m - mfin);
        acc += __ldcg(pc + (size_t)jj * D) * f;
        l += __ldcg(pd + jj) * f;
      }
      if (CUR) {
        const float c = __ldcg(w.stc + br);
        const float m2 = fmaxf(mfin, c);
        const float alpha2 = expf(mfin - m2);
        const float pcur = expf(c - m2);
        l = l * alpha2 + pcur;
        acc = acc * alpha2 + bf16_round(pcur * bf(a.vscur[bh]))
                             * (float)a.vcur[(size_t)bh * D + d];
      }
      o = acc / fmaxf(l, 1e-30f);
    } else {
      for (int jj = 0; jj < nlive; ++jj) {
        acc += __ldcg(pc + (size_t)jj * D);
        l += __ldcg(pd + jj);
      }
      if (CUR) {
        const float ec = expf(__ldcg(w.stc + br) - mr[r]);
        l += ec;
        acc += bf16_round(ec * bf(a.vscur[bh]))
               * (float)a.vcur[(size_t)bh * D + d];
      }
      o = acc / l;
    }
    a.out[qoff<D>(a, b, h, r) + d] = o;
  }
  if (tid == 0) a.tickets[bh] = 0;
}

template <int D, bool PAGED, bool CUR, bool WRITE>
int launch(const Args& a, void* stream) {
  const int Q = a.G * a.T;
  const size_t sa = sizeof(float) * (size_t)Q * (D + CHUNK);
  const size_t sb = sizeof(float) * ((size_t)Q * (CHUNK + 1) + CHUNK
                                     + (size_t)NW * QT * D);
  auto ka = scores_kernel<D, PAGED, CUR>;
  auto kb = values_kernel<D, PAGED, CUR, WRITE>;
  cudaError_t err;
  if (sa > 48 * 1024) {
    err = cudaFuncSetAttribute(
        ka, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sa);
    if (err != cudaSuccess) return (int)err;
  }
  if (sb > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kb, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sb);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(a.NS, a.Hkv, a.B);
  ka<<<grid, THREADS, sa, (cudaStream_t)stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kb<<<grid, THREADS, sb, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// cur, write: compile-time flags (a write needs the current token; the
// current token needs T = 1). Returns a cudaError_t.
template <bool PAGED>
int dispatch(const Args& a, int D, int cur, int write, void* stream) {
  if ((write && !cur) || (cur && a.T != 1) || a.G < 1 || a.T < 1
      || a.G * a.T > QMAX || a.B < 0 || a.Hkv < 1 || a.NS < 1)
    return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  switch (D) {
    case 64:
      if (!cur) return launch<64, PAGED, false, false>(a, stream);
      return write ? launch<64, PAGED, true, true>(a, stream)
                   : launch<64, PAGED, true, false>(a, stream);
    case 128:
      if (!cur) return launch<128, PAGED, false, false>(a, stream);
      return write ? launch<128, PAGED, true, true>(a, stream)
                   : launch<128, PAGED, true, false>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace attn_split
