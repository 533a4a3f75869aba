// K13 and K13-bwd's wide path: causal flash attention from position 0
// and its backward at head_dim D > 256, which no template of flash_attn.cu
// or flash_attn_bwd.cu holds (their Q, K and V tiles span all of D in
// shared memory: a bf16 Q tile of 128 rows alone is 128 KB at D = 512).
//
// Replaces, at those D, the same upstream Pallas TPU kernels as
// flash_attn.cu and flash_attn_bwd.cu: jax/experimental/pallas/ops/tpu/
// flash_attention.py flash_attention's forward pallas_call (:758), and
// its backward's dK/dV and dQ pallas_calls (:1121, :1456), which
// mxq_tpu/models/llama.py (attention, :383-396) reaches for every
// multiple of 128 above 128 (the XLA path, which the plain versions
// follow, takes the rest). The math is the templates': f32 scores and
// sums, the probabilities rounded to the inputs' type for P V (and P^T
// dO, dS . K, dS^T . Q) as upstream rounds them; at float32 every product
// is three bf16 products of hi and lo planes (hi.lo + lo.hi + hi.hi),
// the planes written first by a split pass (flash_split.cuh's load8 and
// split_bf2) at the width of whole 64-column slices, zeros past D.
//
// Design: D is walked in column chunks, and a work item owns one chunk of
// its output:
// - forward, an item is (64 query rows, query head, 128 columns of O).
//   For each key tile (64 keys up to the diagonal), S = Q K^T is summed
//   over ALL of D in 64-column depth slices staged in shared memory;
//   then the online softmax (base 2, the scale folded in), then O's chunk
//   += P V[:, chunk]. Every chunk's block runs the same instructions on
//   the same S, so m, l and lse are the same bits in every chunk; chunk 0
//   writes lse.
// - backward: a pre-pass writes di = rowsum(o . dO) over all of D (a warp
//   a row, one fixed order) and lse log2(e) [B, Hq, T]. A dQ item is (64
//   query rows, query head, 128 columns of dQ): per key tile it recomputes
//   S and dP = dO V^T over all of D, then dS = P (dP - di) / sqrt(D), and
//   dQ's chunk += dS K[:, chunk]. A dK/dV item is (64 keys, kv head, 64
//   columns of dK and dV): for each of the kv head's G query heads in
//   order and each query tile at or past the diagonal it recomputes S^T
//   = K Q^T and dP^T = V dO^T over all of D, then dV's chunk += P^T
//   dO[:, chunk] and dK's chunk += dS^T Q[:, chunk]; the G heads are
//   summed in head order inside the block, so the result is the same bits
//   on every call.
// - Products are mma.sync m16n8k16 (bf16 in, f32 accumulation), four
//   warps of 16 rows an item. The depth slices go through a 2-stage ring
//   in shared memory filled by 16-byte cp.async (zero-filled at rows >=
//   T and columns >= D): the next slice's copies run under this slice's
//   products, and a key tile's chunk of V (or K, Q, dO) is copied under
//   its slices. Where D or the strides are not multiples of 8 (bf16 rows
//   read in place, never padded by a copy), the tiles are filled by plain
//   loads instead. Every tile is row-major; the chunk products read
//   theirs through ldmatrix's transpose. No row >= T is read.
//
// Bound on the H100: operations (forward 4 Hq D T(T+1)/2, backward
// 10 Hq D T(T+1)/2). This path recomputes S (and in the backward dP) once
// per column chunk: at D = 512 four times in the forward and the dQ
// kernel and eight times in the dK/dV kernel, on mma.sync. It is the
// simple, correct form of the kernels; the speed is left for later work.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "device_util.cuh"
#include "hopper_util.cuh"
#include "flash_split.cuh"

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;            // four warps, 16 rows each
constexpr int BM = 64;                  // query rows a tile
constexpr int BN = 64;                  // keys a tile
constexpr int DK = 64;                  // columns a depth slice
constexpr int CO = 128;                 // columns of O and dQ an item
constexpr int CKV = 64;                 // columns of dK and dV an item
constexpr int LD = DK + 8;              // row stride of a slice's tiles
constexpr int LDO = CO + 8;             // of V's (K's) chunk, forward (dQ)
constexpr int LDKV = CKV + 8;           // of Q's and dO's chunk, dK/dV
constexpr float LN2 = 0.6931471805599453f;

// An operand [B, T, heads, w] in bf16: element (b, t, h, c) at p + b sb +
// t st + h hs + c; with two planes (float32 inputs) the lo plane lo
// elements on. Columns at and past w read as zeros.
struct Src {
  const bf16* p;
  long long sb, st, lo;
  int hs, w;
  int vec;                              // 16-byte copies (w % 8 == 0)
};

// rows r0 .. r0 + R of (b, head h), columns c0 .. c0 + NC of s into a
// row-major shared tile [R][ld], each of NP planes `plane` elements after
// the last; zeros at rows >= T and columns >= w. cp.async (one group is
// the caller's to commit) where s.vec, else plain loads and stores.
template <int R, int NC, int NP>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, int plane,
                                          const Src& s, int b, int h, int r0,
                                          int T, int c0) {
  constexpr int G8 = NC / 8;
  const bf16* base = s.p + b * s.sb + (long long)h * s.hs;
  for (int i = threadIdx.x; i < NP * R * G8; i += THREADS) {
    const int pl = i / (R * G8), rem = i % (R * G8);
    const int r = rem / G8, c = (rem % G8) * 8;
    const int row = r0 + r, col = c0 + c;
    const bool in = row < T && col < s.w;
    const bf16* src = base + pl * s.lo
                      + (in ? (long long)row * s.st + col : 0);
    bf16* t = dst + pl * plane + r * ld + c;
    if (s.vec) {
      cp16(t, src, in);
    } else {
      uint32_t u[4] = {0u, 0u, 0u, 0u};
      const uint16_t* e = reinterpret_cast<const uint16_t*>(src);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (in && col + k < s.w)
          u[k / 2] |= (uint32_t)__ldg(e + k) << (16 * (k % 2));
      *reinterpret_cast<uint4*>(t) = make_uint4(u[0], u[1], u[2], u[3]);
    }
  }
}

// mma.sync's A fragment: rows m0 .. m0 + 16, columns k0 .. k0 + 16 of a
// row-major tile
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t,
                                       int ld, int m0, int k0, int lane) {
  const bf16* p = t + (m0 + (lane >> 2)) * ld + k0 + (lane & 3) * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// its B fragment (k0 .. k0 + 16 x n0 .. n0 + 8) from the tile of B's
// columns as rows (k contiguous)
__device__ __forceinline__ void frag_b(uint32_t (&b)[2], const bf16* t,
                                       int ld, int n0, int k0, int lane) {
  const bf16* p = t + (n0 + (lane >> 2)) * ld + k0 + (lane & 3) * 2;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// the B fragments of two n8 tiles (n0, n0 + 8) over k0 .. k0 + 16 from a
// row-major [k][n] tile, by ldmatrix's transpose: b[0..1] of n0, b[2..3]
// of n0 + 8
__device__ __forceinline__ void frag_bt2(uint32_t (&b)[4], const bf16* t,
                                         int ld, int k0, int n0, int lane) {
  const bf16* p = t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0
                  + (lane >> 4) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  mma_acc(c, a, b0, b1);
}

// acc [16 x N] += A [16 x 64] . B^T over a depth slice: A the warp's rows
// m0.. of tile ta, B the N rows of tile tb (both [rows][LD], planes pa
// and pb elements apart). NP = 2: hi.lo + lo.hi + hi.hi.
template <int N, int NP>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4],
                                        const bf16* ta, int pa,
                                        const bf16* tb, int pb, int m0,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    uint32_t ah[4], al[4];
    frag_a(ah, ta, LD, m0, kk * 16, lane);
    if constexpr (NP == 2) frag_a(al, ta + pa, LD, m0, kk * 16, lane);
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      uint32_t bh[2];
      frag_b(bh, tb, LD, n * 8, kk * 16, lane);
      if constexpr (NP == 2) {
        uint32_t bl[2];
        frag_b(bl, tb + pb, LD, n * 8, kk * 16, lane);
        mma(acc[n], ah, bl[0], bl[1]);
        mma(acc[n], al, bh[0], bh[1]);
      }
      mma(acc[n], ah, bh[0], bh[1]);
    }
  }
}

// acc [16 x N] += X [16 x K] . B: X in an accumulator's layout ([K / 8][4]
// f32, rounded to bf16, or split into hi and lo for NP = 2), B the
// row-major [K][ld] tile tb (planes pb elements apart)
template <int K, int N, int NP>
__device__ __forceinline__ void mma_xb(float (&acc)[N / 8][4],
                                       const float (&x)[K / 8][4],
                                       const bf16* tb, int ld, int pb,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t ah[4], al[4];
    const float* x0 = x[2 * kk];
    const float* x1 = x[2 * kk + 1];
    if constexpr (NP == 2) {
      split_bf2(x0[0], x0[1], ah[0], al[0]);
      split_bf2(x0[2], x0[3], ah[1], al[1]);
      split_bf2(x1[0], x1[1], ah[2], al[2]);
      split_bf2(x1[2], x1[3], ah[3], al[3]);
    } else {
      ah[0] = pack_bf2(x0[0], x0[1]);
      ah[1] = pack_bf2(x0[2], x0[3]);
      ah[2] = pack_bf2(x1[0], x1[1]);
      ah[3] = pack_bf2(x1[2], x1[3]);
    }
#pragma unroll
    for (int n = 0; n < N / 8; n += 2) {
      uint32_t bh[4];
      frag_bt2(bh, tb, ld, kk * 16, n * 8, lane);
      if constexpr (NP == 2) {
        uint32_t bl[4];
        frag_bt2(bl, tb + pb, ld, kk * 16, n * 8, lane);
        mma(acc[n], ah, bl[0], bl[1]);
        mma(acc[n + 1], ah, bl[2], bl[3]);
        mma(acc[n], al, bh[0], bh[1]);
        mma(acc[n + 1], al, bh[2], bh[3]);
      }
      mma(acc[n], ah, bh[0], bh[1]);
      mma(acc[n + 1], ah, bh[2], bh[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
    x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
}

__device__ __forceinline__ void store(void* out, bool f32, size_t i,
                                      float x) {
  if (f32)
    static_cast<float*>(out)[i] = x;
  else
    static_cast<bf16*>(out)[i] = __float2bfloat16_rn(x);
}

// Wait until slice `it` of a ring has landed: `chunk` (a chunk tile's
// copies were committed after it) and `more` (so was the next slice's)
// say how many groups may stay in flight.
__device__ __forceinline__ void wait_slice(bool chunk, bool more) {
  if (chunk && more)
    cp_wait<2>();
  else if (chunk || more)
    cp_wait<1>();
  else
    cp_wait<0>();
  __syncthreads();
}

// Wait until the chunk tile has landed, where the last slice's `more`
// copies may still be in flight.
__device__ __forceinline__ void wait_chunk(bool more) {
  if (more)
    cp_wait<1>();
  else
    cp_wait<0>();
  __syncthreads();
}

// ---- forward ---------------------------------------------------------------

struct FwdParams {
  Src q, k, v;
  void* out;                            // [B, T, Hq, d], f32 at NP = 2
  float* lse;                           // [B, Hq, T] or null
  int T, Hq, G, d, nq, nch, nds;
  float scale_log2;
};

template <int NP>
struct FwdSmem {                        // bf16 elements
  static constexpr int Q = NP * BM * LD, K = NP * BN * LD;   // a stage's
  static constexpr int V = NP * BN * LDO;                    // V's chunk
  static constexpr int ELEMS = 2 * (Q + K) + V;
};

template <int NP>
__global__ void __launch_bounds__(THREADS)
    flash_wide_fwd_kernel(const FwdParams p) {
  using S = FwdSmem<NP>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);   // [2][NP][BM][LD]
  bf16* sk = sq + 2 * S::Q;                   // [2][NP][BN][LD]
  bf16* sv = sk + 2 * S::K;                   // [NP][BN][LDO]
  const int qt = p.nq - 1 - (int)blockIdx.x;  // longest first
  const int h = blockIdx.y / p.nch, ch = blockIdx.y % p.nch;
  const int b = blockIdx.z, kh = h / p.G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = qt * BM, c0 = ch * CO, t2 = (lane & 3) * 2;
  const int row = q0 + warp * 16 + (lane >> 2);   // and row + 8
  float o[CO / 8][4];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int nkt = (min(q0 + BM, p.T) + BN - 1) / BN;
  const int n = nkt * p.nds;                  // slices, in (kt, ds) order
  auto issue = [&](int it) {
    const int st = it & 1, kt = it / p.nds, c = it % p.nds * DK;
    load_tile<BM, DK, NP>(sq + st * S::Q, LD, BM * LD, p.q, b, h, q0, p.T,
                          c);
    load_tile<BN, DK, NP>(sk + st * S::K, LD, BN * LD, p.k, b, kh, kt * BN,
                          p.T, c);
    cp_commit();
  };
  issue(0);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BN;
    float s[BN / 8][4];
    zero(s);
    for (int ds = 0; ds < p.nds; ++ds) {
      const int it = kt * p.nds + ds;
      if (ds == 0) {                          // V's chunk of this key tile
        load_tile<BN, CO, NP>(sv, LDO, BN * LDO, p.v, b, kh, k0, p.T, c0);
        cp_commit();
      }
      if (it + 1 < n) issue(it + 1);
      wait_slice(ds == 0, it + 1 < n);
      mma_abt<BN, NP>(s, sq + (it & 1) * S::Q, BM * LD, sk + (it & 1) * S::K,
                      BN * LD, warp * 16, lane);
      __syncthreads();                        // the stage is free again
    }
    // the causal mask, the online softmax of the lane's two rows
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k0 + 8 * j + t2 + (e & 1) > row + 8 * (e >> 1))
          s[j][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = mx[r];
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float mn = fmaxf(m[r], x * p.scale_log2);
      alpha[r] = exp2f(m[r] - mn);
      m[r] = mn;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(fmaf(s[j][e], p.scale_log2, -m[e >> 1]));
        ps[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ps[r];
#pragma unroll
    for (int j = 0; j < CO / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
    wait_chunk(kt * p.nds + p.nds < n);
    mma_xb<BN, CO, NP>(o, s, sv, LDO, BN * LDO, lane);
    __syncthreads();                          // V's chunk is free again
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int j = 0; j < CO / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + 8 * (e >> 1), c = c0 + 8 * j + t2 + (e & 1);
      if (r < p.T && c < p.d)
        store(p.out, NP == 2, (((size_t)b * p.T + r) * p.Hq + h) * p.d + c,
              o[j][e] / l[e >> 1]);
    }
  if (p.lse != nullptr && ch == 0 && (lane & 3) == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row + 8 * r < p.T)
        p.lse[((size_t)b * p.Hq + h) * p.T + row + 8 * r] =
            (m[r] + log2f(l[r])) * LN2;
}

// ---- backward --------------------------------------------------------------

struct DiParams {
  const void* o;                        // [B, T, Hq, d], strides osb, ost
  const void* dout;                     // strides dsb, dst
  long long osb, ost, dsb, dst;
  const float* lse;                     // [B, Hq, T]
  float* lse2;                          // lse log2(e)
  float* di;                            // rowsum(o . dO), f32
  int B, T, Hq, d, f32;
};

// a warp a row (b, h, t), lanes over the columns, one butterfly
__global__ void __launch_bounds__(256) flash_wide_di_kernel(const DiParams p) {
  const long long i = ((long long)blockIdx.x * 256 + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (i >= (long long)p.B * p.Hq * p.T) return;
  const int t = (int)(i % p.T), h = (int)(i / p.T % p.Hq);
  const int b = (int)(i / p.T / p.Hq);
  const long long oo = b * p.osb + t * p.ost + (long long)h * p.d;
  const long long od = b * p.dsb + t * p.dst + (long long)h * p.d;
  float acc = 0.f;
  for (int c = lane; c < p.d; c += 32) {
    const float x =
        p.f32 ? static_cast<const float*>(p.o)[oo + c]
              : __bfloat162float(static_cast<const bf16*>(p.o)[oo + c]);
    const float y =
        p.f32 ? static_cast<const float*>(p.dout)[od + c]
              : __bfloat162float(static_cast<const bf16*>(p.dout)[od + c]);
    acc = fmaf(x, y, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    p.di[i] = acc;
    p.lse2[i] = p.lse[i] * LOG2E;
  }
}

struct BwdParams {
  Src q, k, v, dout;
  void* dq;                             // [B, T, Hq, d]
  void* dk;                             // [B, S, Hkv, d], batch stride kvsb
  void* dv;
  const float* lse2;                    // [B, Hq, T]
  const float* di;
  long long kvsb;
  int T, Hq, Hkv, G, d, nq, nchq, nchkv, nds;
  float scale, scale_log2;
};

template <int NP>
struct BwdSmem {                        // bf16 elements
  static constexpr int T = NP * 64 * LD;            // a slice's tile
  static constexpr int STAGE = 4 * T;               // q, dO, k, v
  static constexpr int DQ = 2 * STAGE + NP * BN * LDO;        // + K's chunk
  static constexpr int DKV = 2 * STAGE + 2 * NP * BM * LDKV;  // + Q's, dO's
};

// dQ: an item is (64 query rows, query head, 128 columns of dQ)
template <int NP>
__global__ void __launch_bounds__(THREADS)
    flash_wide_dq_kernel(const BwdParams p) {
  using S = BwdSmem<NP>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [2] x (q, dO, k, v) tiles
  bf16* skc = ring + 2 * S::STAGE;             // [NP][BN][LDO]: K's chunk
  const int qt = p.nq - 1 - (int)blockIdx.x;
  const int h = blockIdx.y / p.nchq, ch = blockIdx.y % p.nchq;
  const int b = blockIdx.z, kh = h / p.G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = qt * BM, c0 = ch * CO, t2 = (lane & 3) * 2;
  const int row = q0 + warp * 16 + (lane >> 2);
  const size_t bh = (size_t)b * p.Hq + h;
  float lse2[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row + 8 * r < p.T;
    lse2[r] = in ? p.lse2[bh * p.T + row + 8 * r] : 0.f;
    di[r] = in ? p.di[bh * p.T + row + 8 * r] : 0.f;
  }
  float dq[CO / 8][4];
  zero(dq);
  const int nkt = (min(q0 + BM, p.T) + BN - 1) / BN;
  const int n = nkt * p.nds;
  auto issue = [&](int it) {
    bf16* t = ring + (it & 1) * S::STAGE;
    const int k0 = it / p.nds * BN, c = it % p.nds * DK;
    load_tile<BM, DK, NP>(t, LD, BM * LD, p.q, b, h, q0, p.T, c);
    load_tile<BM, DK, NP>(t + S::T, LD, BM * LD, p.dout, b, h, q0, p.T, c);
    load_tile<BN, DK, NP>(t + 2 * S::T, LD, BN * LD, p.k, b, kh, k0, p.T, c);
    load_tile<BN, DK, NP>(t + 3 * S::T, LD, BN * LD, p.v, b, kh, k0, p.T, c);
    cp_commit();
  };
  issue(0);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BN;
    float s[BN / 8][4], dp[BN / 8][4];
    zero(s);
    zero(dp);
    for (int ds = 0; ds < p.nds; ++ds) {
      const int it = kt * p.nds + ds;
      if (ds == 0) {                           // K's chunk of this tile
        load_tile<BN, CO, NP>(skc, LDO, BN * LDO, p.k, b, kh, k0, p.T, c0);
        cp_commit();
      }
      if (it + 1 < n) issue(it + 1);
      wait_slice(ds == 0, it + 1 < n);
      const bf16* t = ring + (it & 1) * S::STAGE;
      mma_abt<BN, NP>(s, t, BM * LD, t + 2 * S::T, BN * LD, warp * 16, lane);
      mma_abt<BN, NP>(dp, t + S::T, BM * LD, t + 3 * S::T, BN * LD,
                      warp * 16, lane);
      __syncthreads();
    }
    // dS = P (dP - di) / sqrt(D) into s, P zero past the diagonal and T
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + 8 * (e >> 1), key = k0 + 8 * j + t2 + (e & 1);
        const float pr = key <= r && r < p.T
            ? exp2f(fmaf(s[j][e], p.scale_log2, -lse2[e >> 1])) : 0.f;
        s[j][e] = pr * (dp[j][e] - di[e >> 1]) * p.scale;
      }
    wait_chunk(kt * p.nds + p.nds < n);
    mma_xb<BN, CO, NP>(dq, s, skc, LDO, BN * LDO, lane);
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < CO / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + 8 * (e >> 1), c = c0 + 8 * j + t2 + (e & 1);
      if (r < p.T && c < p.d)
        store(p.dq, NP == 2, (((size_t)b * p.T + r) * p.Hq + h) * p.d + c,
              dq[j][e]);
    }
}

// dK and dV: an item is (64 keys, kv head, 64 columns of dK and dV); its
// passes run over (query head of the kv head, query tile from the
// diagonal on) in that order
template <int NP>
__global__ void __launch_bounds__(THREADS)
    flash_wide_dkv_kernel(const BwdParams p) {
  using S = BwdSmem<NP>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [2] x (k, v, q, dO) tiles
  bf16* sqc = ring + 2 * S::STAGE;             // [NP][BM][LDKV]: Q's chunk
  bf16* sdoc = sqc + NP * BM * LDKV;           // and dO's
  float* sl = reinterpret_cast<float*>(sdoc + NP * BM * LDKV);  // [BM]
  float* sd = sl + BM;                                          // [BM]
  const int kt = blockIdx.x;                   // key tile 0 has most work
  const int kh = blockIdx.y / p.nchkv, ch = blockIdx.y % p.nchkv;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = kt * BN, c0 = ch * CKV, t2 = (lane & 3) * 2;
  const int key = k0 + warp * 16 + (lane >> 2);   // and key + 8
  const int qt0 = k0 / BM, nqt = p.nq - qt0;
  const int n = p.G * nqt * p.nds;             // slices, in (g, qt, ds) order
  float dk[CKV / 8][4], dv[CKV / 8][4];
  zero(dk);
  zero(dv);
  auto issue = [&](int it) {
    bf16* t = ring + (it & 1) * S::STAGE;
    const int pass = it / p.nds, c = it % p.nds * DK;
    const int h = kh * p.G + pass / nqt, q0 = (qt0 + pass % nqt) * BM;
    load_tile<BN, DK, NP>(t, LD, BN * LD, p.k, b, kh, k0, p.T, c);
    load_tile<BN, DK, NP>(t + S::T, LD, BN * LD, p.v, b, kh, k0, p.T, c);
    load_tile<BM, DK, NP>(t + 2 * S::T, LD, BM * LD, p.q, b, h, q0, p.T, c);
    load_tile<BM, DK, NP>(t + 3 * S::T, LD, BM * LD, p.dout, b, h, q0, p.T,
                          c);
    cp_commit();
  };
  issue(0);
  for (int pass = 0; pass < p.G * nqt; ++pass) {
    const int h = kh * p.G + pass / nqt, q0 = (qt0 + pass % nqt) * BM;
    const size_t bh = (size_t)b * p.Hq + h;
    float s[BM / 8][4], dp[BM / 8][4];
    zero(s);
    zero(dp);
    for (int ds = 0; ds < p.nds; ++ds) {
      const int it = pass * p.nds + ds;
      if (ds == 0) {                           // Q's and dO's chunks
        load_tile<BM, CKV, NP>(sqc, LDKV, BM * LDKV, p.q, b, h, q0, p.T, c0);
        load_tile<BM, CKV, NP>(sdoc, LDKV, BM * LDKV, p.dout, b, h, q0, p.T,
                               c0);
        cp_commit();
        for (int i = threadIdx.x; i < BM; i += THREADS) {
          const bool in = q0 + i < p.T;
          sl[i] = in ? p.lse2[bh * p.T + q0 + i] : 0.f;
          sd[i] = in ? p.di[bh * p.T + q0 + i] : 0.f;
        }
      }
      if (it + 1 < n) issue(it + 1);
      wait_slice(ds == 0, it + 1 < n);
      const bf16* t = ring + (it & 1) * S::STAGE;
      mma_abt<BM, NP>(s, t, BN * LD, t + 2 * S::T, BM * LD, warp * 16, lane);
      mma_abt<BM, NP>(dp, t + S::T, BN * LD, t + 3 * S::T, BM * LD,
                      warp * 16, lane);
      __syncthreads();
    }
    // P^T into s, dS^T into dp; P zero where the query row is before the
    // key or at or past T
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = 8 * j + t2 + (e & 1), qr = q0 + jj;
        const int kr = key + 8 * (e >> 1);
        const float pr = kr <= qr && qr < p.T
            ? exp2f(fmaf(s[j][e], p.scale_log2, -sl[jj])) : 0.f;
        s[j][e] = pr;
        dp[j][e] = pr * (dp[j][e] - sd[jj]) * p.scale;
      }
    wait_chunk((pass + 1) * p.nds < n);
    mma_xb<BM, CKV, NP>(dv, s, sdoc, LDKV, BM * LDKV, lane);
    mma_xb<BM, CKV, NP>(dk, dp, sqc, LDKV, BM * LDKV, lane);
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < CKV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = key + 8 * (e >> 1), c = c0 + 8 * j + t2 + (e & 1);
      if (r < p.T && c < p.d) {
        const size_t i = b * p.kvsb + ((size_t)r * p.Hkv + kh) * p.d + c;
        store(p.dk, NP == 2, i, dk[j][e]);
        store(p.dv, NP == 2, i, dv[j][e]);
      }
    }
}

// ---- host side -------------------------------------------------------------

int plane_width(int d) { return (d + DK - 1) / DK * DK; }

// a bf16 operand read in place
Src rows_of(const void* x, long long sb, long long st, int d) {
  const bool vec = d % 8 == 0 && sb % 8 == 0 && st % 8 == 0
                   && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return {static_cast<const bf16*>(x), sb, st, 0, d, d, vec};
}

// an operand's hi and lo planes [2B, T, heads, W]
Src planes_of(const bf16* planes, int B, int T, int heads, int W) {
  const long long st = (long long)heads * W, sb = st * T;
  return {planes, sb, st, sb * B, W, W, 1};
}

// the split pass at width W (any multiple of 8): sp's jobs into planes
__global__ void __launch_bounds__(SPLIT_THREADS)
    wide_split_kernel(const __grid_constant__ SplitParams p, int W) {
  const int CH = W / 8;
  const SplitJob& j = p.job[blockIdx.y];
  const long long rows = (long long)p.B * p.T * j.heads;
  const long long i = (long long)blockIdx.x * SPLIT_THREADS + threadIdx.x;
  if (i >= rows * CH) return;
  const long long row = i / CH;
  const int c0 = (int)(i % CH) * 8;
  const int h = (int)(row % j.heads);
  const int t = (int)(row / j.heads % p.T);
  const int b = (int)(row / j.heads / p.T);
  float x[8];
  load8(x, j.x + b * j.sb + t * j.st + (long long)h * p.D, c0, p.D, j.vec);
  uint4 hi, lo;
  split_bf2(x[0], x[1], hi.x, lo.x);
  split_bf2(x[2], x[3], hi.y, lo.y);
  split_bf2(x[4], x[5], hi.z, lo.z);
  split_bf2(x[6], x[7], hi.w, lo.w);
  bf16* at = j.planes + (((long long)b * p.T + t) * j.heads + h) * W + c0;
  *reinterpret_cast<uint4*>(at) = hi;
  *reinterpret_cast<uint4*>(at + (long long)p.B * p.T * j.heads * W) = lo;
}

int launch_wide_split(const SplitParams& sp, int jobs, int maxheads,
                      int W, cudaStream_t stream) {
  const long long blocks =
      ((long long)sp.B * sp.T * maxheads * (W / 8) + SPLIT_THREADS - 1)
      / SPLIT_THREADS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  wide_split_kernel<<<dim3((unsigned)blocks, jobs), SPLIT_THREADS, 0,
                      stream>>>(sp, W);
  return (int)cudaGetLastError();
}

template <typename K>
int set_smem(K kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int NP>
int launch_fwd(const FwdParams& p, int B, cudaStream_t stream) {
  const size_t bytes = sizeof(bf16) * FwdSmem<NP>::ELEMS;
  int err = set_smem(flash_wide_fwd_kernel<NP>, bytes);
  if (err) return err;
  flash_wide_fwd_kernel<NP><<<dim3(p.nq, p.Hq * p.nch, B), THREADS, bytes,
                              stream>>>(p);
  return (int)cudaGetLastError();
}

template <int NP>
int launch_bwd(const BwdParams& p, int B, cudaStream_t stream) {
  const size_t bq = sizeof(bf16) * BwdSmem<NP>::DQ;
  const size_t bkv = sizeof(bf16) * BwdSmem<NP>::DKV
                     + 2 * BM * sizeof(float);
  int err = set_smem(flash_wide_dq_kernel<NP>, bq);
  if (!err) err = set_smem(flash_wide_dkv_kernel<NP>, bkv);
  if (err) return err;
  flash_wide_dq_kernel<NP><<<dim3(p.nq, p.Hq * p.nchq, B), THREADS, bq,
                             stream>>>(p);
  if ((err = (int)cudaGetLastError())) return err;
  flash_wide_dkv_kernel<NP><<<dim3(p.nq, p.Hkv * p.nchkv, B), THREADS, bkv,
                              stream>>>(p);
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int T, int Hq, int Hkv, int d) {
  return B >= 0 && B <= 65535 && T >= 0 && Hkv >= 1 && Hq >= Hkv
         && Hq % Hkv == 0 && d > 256
         && (long long)Hq * ((d + CKV - 1) / CKV) <= 65535
         && (long long)(T + BM - 1) / BM <= 0x7fffffffLL;
}

}  // namespace

// flash_attn (flash_attn.cu) at head_dim d > 256: q [B, T, Hq, d], k/v
// [B, >=T, Hkv, d] with element strides (batch, token) given and heads
// and d contiguous; out [B, T, Hq, d] contiguous in the inputs' type; lse
// [B, Hq, T] f32 or null; scale 1/sqrt(d). f32 = 0: bf16 tensors read in
// place (16-byte loads where d, the strides and the start allow them);
// planes is not read. f32 = 1: float32 tensors; planes: bf16 scratch of 2
// B T (Hq + 2 Hkv) W elements, W = d rounded up to a multiple of 64, for
// the split pass. Returns a cudaError_t.
extern "C" int flash_attn_wide(const void* q, const void* k, const void* v,
                               void* out, float* lse, long long qsb,
                               long long qst, long long ksb, long long kst,
                               long long vsb, long long vst, int B, int T,
                               int Hq, int Hkv, int d, int f32, float scale,
                               void* planes, void* stream) {
  if (!shape_ok(B, T, Hq, Hkv, d) || (f32 && planes == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  FwdParams p;
  p.out = out;
  p.lse = lse;
  p.T = T;
  p.Hq = Hq;
  p.G = Hq / Hkv;
  p.d = d;
  p.nq = (T + BM - 1) / BM;
  p.nch = (d + CO - 1) / CO;
  p.nds = (d + DK - 1) / DK;
  p.scale_log2 = scale * LOG2E;
  if (!f32) {
    p.q = rows_of(q, qsb, qst, d);
    p.k = rows_of(k, ksb, kst, d);
    p.v = rows_of(v, vsb, vst, d);
    return launch_fwd<1>(p, B, st);
  }
  const int W = plane_width(d);
  bf16* qp = static_cast<bf16*>(planes);
  bf16* kp = qp + 2LL * B * T * Hq * W;
  bf16* vp = kp + 2LL * B * T * Hkv * W;
  SplitParams sp{};
  sp.job[0] = split_job(q, qsb, qst, qp, Hq, d);
  sp.job[1] = split_job(k, ksb, kst, kp, Hkv, d);
  sp.job[2] = split_job(v, vsb, vst, vp, Hkv, d);
  sp.B = B;
  sp.T = T;
  sp.D = d;
  sp.di_job = -1;
  const int err = launch_wide_split(sp, 3, Hq, W, st);
  if (err) return err;
  p.q = planes_of(qp, B, T, Hq, W);
  p.k = planes_of(kp, B, T, Hkv, W);
  p.v = planes_of(vp, B, T, Hkv, W);
  return launch_fwd<2>(p, B, st);
}

// flash_attn_bwd (flash_attn_bwd.cu) at head_dim d > 256: q, k, v, o and
// dout as flash_attn_wide and flash_attn_bwd take them; lse [B, Hq, T]
// f32; dq [B, T, Hq, d] contiguous; dk, dv [B, S, Hkv, d] contiguous with
// batch stride kvsb = S Hkv d (rows < T written); ws: f32 scratch of 2 B
// Hq T floats (lse log2(e) and di); planes (f32 = 1): bf16 scratch of 2 B
// T (2 Hq + 2 Hkv) W elements, W = d rounded up to a multiple of 64.
// Launches the di pass, the split pass (float32), the dQ kernel, then
// the dK/dV kernel. Returns a cudaError_t.
extern "C" int flash_attn_bwd_wide(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* planes, void* dq, void* dk,
    void* dv, float* ws, long long qsb, long long qst, long long ksb,
    long long kst, long long vsb, long long vst, long long osb,
    long long ost, long long dsb, long long dst, long long kvsb, int B,
    int T, int Hq, int Hkv, int d, int f32, float scale, void* stream) {
  if (!shape_ok(B, T, Hq, Hkv, d) || ws == nullptr
      || (f32 && planes == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)B * Hq * T;
  DiParams dp{o, dout, osb, ost, dsb, dst, lse, ws, ws + rows, B, T, Hq, d,
              f32};
  const long long dblocks = (rows * 32 + 255) / 256;
  if (dblocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  flash_wide_di_kernel<<<(unsigned)dblocks, 256, 0, st>>>(dp);
  int err = (int)cudaGetLastError();
  if (err) return err;
  BwdParams p;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.lse2 = ws;
  p.di = ws + rows;
  p.kvsb = kvsb;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  p.d = d;
  p.nq = (T + BM - 1) / BM;
  p.nchq = (d + CO - 1) / CO;
  p.nchkv = (d + CKV - 1) / CKV;
  p.nds = (d + DK - 1) / DK;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  if (!f32) {
    p.q = rows_of(q, qsb, qst, d);
    p.k = rows_of(k, ksb, kst, d);
    p.v = rows_of(v, vsb, vst, d);
    p.dout = rows_of(dout, dsb, dst, d);
    return launch_bwd<1>(p, B, st);
  }
  const int W = plane_width(d);
  bf16* qp = static_cast<bf16*>(planes);
  bf16* kp = qp + 2LL * B * T * Hq * W;
  bf16* vp = kp + 2LL * B * T * Hkv * W;
  bf16* dp2 = vp + 2LL * B * T * Hkv * W;
  SplitParams sp{};
  sp.job[0] = split_job(q, qsb, qst, qp, Hq, d);
  sp.job[1] = split_job(k, ksb, kst, kp, Hkv, d);
  sp.job[2] = split_job(v, vsb, vst, vp, Hkv, d);
  sp.job[3] = split_job(dout, dsb, dst, dp2, Hq, d);
  sp.B = B;
  sp.T = T;
  sp.D = d;
  sp.di_job = -1;
  err = launch_wide_split(sp, 4, Hq, W, st);
  if (err) return err;
  p.q = planes_of(qp, B, T, Hq, W);
  p.k = planes_of(kp, B, T, Hkv, W);
  p.v = planes_of(vp, B, T, Hkv, W);
  p.dout = planes_of(dp2, B, T, Hq, W);
  return launch_bwd<2>(p, B, st);
}
