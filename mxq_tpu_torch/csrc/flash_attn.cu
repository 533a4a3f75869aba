// K13: causal self-attention from position 0, the forward of flash
// attention. q [B, T, Hq, D] attends k, v [B, >=T, Hkv, D] (query row i
// sees keys j <= i; only the first T key rows are read), query head h
// reading kv head h / G (G = Hq / Hkv) in place, scale 1/sqrt(D).
//
// Replaces the upstream Pallas TPU kernel that mxq_tpu/models/llama.py
// (attention, :383-396, use_flash) calls: jax/experimental/pallas/ops/tpu/
// flash_attention.py flash_attention (:140), its forward pallas_call
// (:758) over _flash_attention_kernel_single_batch (:342-480). Per block
// of query rows and block of keys it computes
//   s     = (q . k^T) * scale                      f32, causal mask
//   m_new = max(m, rowmax(s)); p = exp(s - m_new); alpha = exp(m - m_new)
//   l     = alpha * l + rowsum(p)                  f32, p unrounded
//   acc   = alpha * acc + p.astype(v.dtype) . v    f32 accumulation
// and writes acc / l in q's type, and where asked the row log-sum-exp
// lse = m + log(l) in the same scaled units, f32 [B, Hq, T]: what the
// backward (K13-bwd, flash_attn_bwd.cu) needs of the forward (upstream
// saves l and m apart, :234-252). Upstream keeps acc divided by l after
// every block; here the division comes once at the end (the same sum,
// one rounding instead of one per block). The rounding of p to V's type
// against the running max is the point where this differs most from the
// plain version (ops/attn_bf16.py), which rounds the normalized
// probabilities.
//
// Bound on the H100: operations. 4 * B * Hq * D * T(T+1)/2 (two products
// over the causal half), at T = 2048 and 32 heads of 128 34.4 GFLOP a
// layer: 0.0348 ms at 989 TFLOP/s; the bytes (q, k, v read once, the
// output written) are 67 MB a layer at bf16, 0.020 ms at 3.35 TB/s.
//
// Design (FlashAttention-2 on mma.sync, sm_80-style; wgmma, TMA and warp
// specialisation are later work): one block of 4 warps per (64 query
// rows, query head, batch row), heaviest row blocks first. Each warp owns
// 16 query rows; their Q fragments stay in registers (ldmatrix from a
// swizzled shared tile, loaded once). K and V come in 64-key tiles
// through cp.async, double-buffered: tile kt + 1 is in flight while tile
// kt is used. S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16 in,
// f32 out); P goes from S's accumulator registers straight into the A
// operand (the C and A fragment layouts line up), V's B operand comes
// from ldmatrix .trans. Only the diagonal tile is masked; tiles wholly
// above the diagonal are never loaded. The row max and sum live in the
// four lanes of a quad (two shuffles). No atomics: the result is the same
// bit for bit on every run.
//
// f32 inputs (the float32 model) take the same kernel with SPLIT: every
// operand x is split into bf16 hi = bf16(x) and lo = bf16(x - hi), and a
// product is hi.hi + hi.lo + lo.hi (three mma.sync), ~16 significant bits
// (the TPU's f32 matmul is bf16 passes too). Their tiles are converted on
// the way into shared memory (no cp.async).
//
// Shared memory: Q, two K and two V tiles of 64 x D bf16 (80 KB at D=128;
// SPLIT 160 KB: a hi and a lo plane each). 16-byte chunk c of row r sits
// at chunk c ^ (r % 8) of the row, so that ldmatrix's eight row addresses
// fall in eight different bank groups.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

#include "device_util.cuh"
#include "flash_tile.cuh"

constexpr int BQ = 64;                  // query rows per block
constexpr int BK = 64;                  // keys per tile
constexpr int WARPS = BQ / 16;          // 16 query rows a warp
constexpr int THREADS = 32 * WARPS;

struct Args {
  const void* q;                        // [B, T, Hq, D], strides below
  const void* k;                        // [B, >=T, Hkv, D]
  const void* v;
  void* out;                            // [B, T, Hq, D] contiguous
  float* lse;                           // [B, Hq, T] or null
  long long qsb, qst, ksb, kst, vsb, vst;   // batch, token strides (elems)
  int T, Hq, Hkv;
  float scale;
};

template <int D, bool SPLIT>
__global__ void __launch_bounds__(THREADS) flash_kernel(const Args a) {
  using T = typename std::conditional<SPLIT, float, __nv_bfloat16>::type;
  constexpr int TILE = 64 * D;          // elements of one plane of a tile
  constexpr int NP = SPLIT ? 2 : 1;     // planes: hi (and lo)
  constexpr int KD = D / 16;            // mma k-steps over D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + NP * TILE;   // [2 buffers][NP][64][D]
  __nv_bfloat16* sv = sk + 2 * NP * TILE;

  const int qt = gridDim.x - 1 - blockIdx.x;     // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = qt * BQ;
  const int nkt = (min(q0 + BQ, a.T) + BK - 1) / BK;   // key tiles read
  const T* qg = static_cast<const T*>(a.q) + b * a.qsb + q0 * a.qst + h * D;
  const T* kg = static_cast<const T*>(a.k) + b * a.ksb + hk * D;
  const T* vg = static_cast<const T*>(a.v) + b * a.vsb + hk * D;

  load_tile<D, SPLIT, BQ, THREADS>(sq, sq + TILE, qg, a.qst, a.T - q0, tid);
  load_tile<D, SPLIT, BK, THREADS>(sk, sk + TILE, kg, a.kst, a.T, tid);
  load_tile<D, SPLIT, BK, THREADS>(sv, sv + TILE, vg, a.vst, a.T, tid);
  cp_commit();

  uint32_t qa[NP][KD][4];
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  // this lane's rows: r0 (accumulator registers 0, 1) and r0 + 8 (2, 3)
  const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nkt) {                 // the next tile into the other buffer
      const int nb = buf ^ 1;
      const long long k1 = (long long)(kt + 1) * BK;
      load_tile<D, SPLIT, BK, THREADS>(
          sk + nb * NP * TILE, sk + nb * NP * TILE + TILE, kg + k1 * a.kst,
          a.kst, a.T - (int)k1, tid);
      load_tile<D, SPLIT, BK, THREADS>(
          sv + nb * NP * TILE, sv + nb * NP * TILE + TILE, vg + k1 * a.vst,
          a.vst, a.T - (int)k1, tid);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          ldmatrix<4>(qa[p][kk], sq + p * TILE
                      + sw<D>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
    }
    const __nv_bfloat16* kb = sk + buf * NP * TILE;
    const __nv_bfloat16* vb = sv + buf * NP * TILE;

    // S = Q K^T: 16 rows x 64 keys a warp, 8 accumulator tiles of n8
    float s[BK / 8][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int ch = 2 * kk + ((lane >> 3) & 1);
        uint32_t bh[4];
        ldmatrix<4>(bh, kb + sw<D>(key, ch));
        if constexpr (SPLIT) {
          uint32_t bl[4];
          ldmatrix<4>(bl, kb + TILE + sw<D>(key, ch));
          mma_acc(s[2 * np], qa[0][kk], bl[0], bl[1]);
          mma_acc(s[2 * np + 1], qa[0][kk], bl[2], bl[3]);
          mma_acc(s[2 * np], qa[NP - 1][kk], bh[0], bh[1]);
          mma_acc(s[2 * np + 1], qa[NP - 1][kk], bh[2], bh[3]);
        }
        mma_acc(s[2 * np], qa[0][kk], bh[0], bh[1]);
        mma_acc(s[2 * np + 1], qa[0][kk], bh[2], bh[3]);
      }
    }

    // scale, the causal mask on the last tile, the running max and sum
    const bool edge = kt == nkt - 1;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * a.scale;
        if (edge) {
          const int key = kt * BK + nt * 8 + 2 * (lane & 3) + (e & 1);
          if (key > (e < 2 ? r0 : r1) || key >= a.T) x = -INFINITY;
        }
        s[nt][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // key kt * BK is visible to every row of the block: the max is finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= al0;
      o[i][1] *= al0;
      o[i][2] *= al1;
      o[i][3] *= al1;
    }

    // O += P V: P in V's type as the A operand, straight from S's registers
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[NP][4];
      if constexpr (SPLIT) {
        split_bf2(s[2 * kk][0], s[2 * kk][1], pa[0][0], pa[NP - 1][0]);
        split_bf2(s[2 * kk][2], s[2 * kk][3], pa[0][1], pa[NP - 1][1]);
        split_bf2(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[0][2],
                  pa[NP - 1][2]);
        split_bf2(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[0][3],
                  pa[NP - 1][3]);
      } else {
        pa[0][0] = pack_bf2(s[2 * kk][0], s[2 * kk][1]);
        pa[0][1] = pack_bf2(s[2 * kk][2], s[2 * kk][3]);
        pa[0][2] = pack_bf2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[0][3] = pack_bf2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        const int ch = 2 * dp + (lane >> 4);
        uint32_t bh[4];
        ldmatrix_t(bh, vb + sw<D>(key, ch));
        if constexpr (SPLIT) {
          uint32_t bl[4];
          ldmatrix_t(bl, vb + TILE + sw<D>(key, ch));
          mma_acc(o[2 * dp], pa[0], bl[0], bl[1]);
          mma_acc(o[2 * dp + 1], pa[0], bl[2], bl[3]);
          mma_acc(o[2 * dp], pa[NP - 1], bh[0], bh[1]);
          mma_acc(o[2 * dp + 1], pa[NP - 1], bh[2], bh[3]);
        }
        mma_acc(o[2 * dp], pa[0], bh[0], bh[1]);
        mma_acc(o[2 * dp + 1], pa[0], bh[2], bh[3]);
      }
    }
    __syncthreads();                    // this buffer is refilled next
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (a.lse != nullptr && (lane & 3) == 0) {    // m and l are the quad's
    float* lse = a.lse + ((long long)b * a.Hq + h) * a.T;
    if (r0 < a.T) lse[r0] = m0 + logf(l0);
    if (r1 < a.T) lse[r1] = m1 + logf(l1);
  }
  T* out = static_cast<T*>(a.out);
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= a.T) continue;
    const float l = half ? l1 : l0;
    T* row = out + (((long long)b * a.T + r) * a.Hq + h) * D + col;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const float x = o[i][2 * half] / l, y = o[i][2 * half + 1] / l;
      if constexpr (SPLIT)
        *reinterpret_cast<float2*>(row + i * 8) = make_float2(x, y);
      else
        *reinterpret_cast<uint32_t*>(row + i * 8) = pack_bf2(x, y);
    }
  }
}

template <int D, bool SPLIT>
int launch(const Args& a, int B, void* stream) {
  const size_t smem = (size_t)(SPLIT ? 10 : 5) * 64 * D * 2;
  auto kern = flash_kernel<D, SPLIT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.T + BQ - 1) / BQ, a.Hq, B);
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, T, Hq, D], k/v [B, >=T, Hkv, D] with element strides (batch,
// token) given and heads and D contiguous, 16-byte aligned rows; out
// [B, T, Hq, D] contiguous; lse [B, Hq, T] f32 or null (not written).
// f32 = 0: bf16 tensors; f32 = 1: float32 tensors (the split products).
// Returns a cudaError_t.
extern "C" int flash_attn(const void* q, const void* k, const void* v,
                          void* out, float* lse, long long qsb, long long qst,
                          long long ksb, long long kst, long long vsb,
                          long long vst, int B, int T, int Hq, int Hkv, int D,
                          int f32, float scale, void* stream) {
  if (B < 0 || T < 0 || Hkv < 1 || Hq < Hkv || Hq % Hkv || B > 65535
      || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const Args a{q, k, v, out, lse, qsb, qst, ksb, kst, vsb, vst,
               T, Hq, Hkv, scale};
  switch (D * 2 + (f32 ? 1 : 0)) {
    case 128: return launch<64, false>(a, B, stream);
    case 129: return launch<64, true>(a, B, stream);
    case 256: return launch<128, false>(a, B, stream);
    case 257: return launch<128, true>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
