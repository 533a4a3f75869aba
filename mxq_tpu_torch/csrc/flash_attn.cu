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
// output written) are 67 MB a layer at bf16, 0.020 ms at 3.35 TB/s. Only
// wgmma reaches that tensor-core rate, and only when its operands arrive
// in shared memory without the threads that multiply spending
// instructions on the copies, and while one warpgroup's exponentials run
// under the other's products.
//
// bf16 (flash_wgmma_kernel, FlashAttention-3's forward): a work item is
// 128 query rows of one (query head, batch row). Items run longest first
// (every head's last row block, then the one before), and one block of
// three warpgroups an SM walks a snake of them (persistent), so that an
// item's start, its loads and its epilogue run beside the last item's
// products instead of in a block's own prologue.
// - Warpgroup 0 is the producer: setmaxnreg gives its registers to the
//   others, and one thread starts every copy by TMA (4-D tensor maps over
//   (D, heads, tokens, batch) on the strides the wrapper passes, so the
//   fused qkv projection's slices are read in place). Q comes once an
//   item, into a buffer the consumers free after their last S; K and V in
//   128-key tiles through a ring of three stages that runs on across
//   items, each stage with a full and an empty mbarrier: copies run ahead
//   of the products with no thread of the consumers spent on them. The
//   maps' token extent is T, so TMA fills keys >= T with zeros and a
//   cache's rows past T, whatever they hold, are never read.
// - Warpgroups 1 and 2 consume, 64 query rows each, sharing each K and V
//   tile (one copy feeds 128 query rows). S = Q K^T is wgmma m64n128k16
//   with both operands in shared memory (K [keys][D] is K-major as it
//   lies); O += P V is wgmma's register-A form, P straight from S's
//   accumulator registers (rounded to bf16 pairs: the accumulator and A
//   fragment layouts line up) and V [keys][D] read through the
//   descriptor's transpose, no copy of V made. Tiles are stored with TMA's
//   128-byte swizzle, which is the layout the descriptors name. f32
//   accumulation throughout; the softmax in base 2 with the scale folded
//   in (log2 e / sqrt D), only the diagonal tile masked.
// - Overlap: the two consumer warpgroups take turns at issuing their
//   products on two named barriers, so that one's softmax runs under the
//   other's wgmma; and each starts S of tile j together with P V of tile
//   j - 1, so that its own softmax of tile j runs under that P V.
// Shared memory at D = 128: Q 32 KB and three stages of K and V, 64 KB
// each (225 KB of the 227).
// No atomics and no split of the keys: the same bits on every call, and
// writing lse leaves the output's bits as they are.
//
// float32 inputs (the float32 model; flash_kernel) stay on the mma.sync
// design of the first port: TMA copies bytes, and cannot split an f32
// tile into the bf16 hi and lo planes the split products take
// (hi.hi + hi.lo + lo.hi, ~16 significant bits, as the TPU's f32 matmul
// is bf16 passes too). One block of 4 warps per 64 query rows, 16 rows a
// warp; 64-key K and V tiles split into hi and lo on their way into
// swizzled shared memory, double-buffered; Q fragments kept in registers;
// S's accumulator registers turned straight into P's A operand; V through
// ldmatrix .trans. Shared memory: Q, two K and two V tiles of 64 x D, each
// a hi and a lo plane (160 KB at D = 128).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "device_util.cuh"
#include "flash_tile.cuh"
#include "hopper_util.cuh"

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA, warp specialisation
// ---------------------------------------------------------------------------

constexpr int BM = 128;                 // query rows a work item
constexpr int BN = 128;                 // keys a tile
constexpr int STAGES = 3;               // K and V tiles in flight
constexpr int WG = 128;                 // threads of a warpgroup
constexpr int WS_THREADS = 3 * WG;      // producer + two consumers
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int CONSUMER_WARPS = 8;       // arrivals that empty a stage
constexpr int BAR_TURN = 1;             // named barriers 1, 2: whose turn

struct WsParams {
  CUtensorMap q, k, v;                  // 4-D (D, heads, T, B) maps
  __nv_bfloat16* out;                   // [B, T, Hq, D] contiguous
  float* lse;                           // [B, Hq, T] or null
  int nq, B, T, Hq, Hkv;                // nq: row blocks, ceil(T / BM)
  float scale_log2;                     // scale * log2(e)
};

template <int D>
struct WsSmem {                         // every tile 1024-byte aligned
  __nv_bfloat16 q[BM * D];              // D / 64 boxes of [BM][64]
  __nv_bfloat16 k[STAGES][BN * D];      // D / 64 boxes of [BN][64]
  __nv_bfloat16 v[STAGES][BN * D];
  uint64_t q_full, q_empty, k_full[STAGES], v_full[STAGES],
      k_empty[STAGES], v_empty[STAGES];
};

// One tile's raw scores s (this lane's 64 of the warpgroup's 64 x 128) ->
// p = 2^(s c - m_new) in place, f32; the running max m (in units of s c)
// and sum l of the lane's two rows (row0, row0 + 8 of the block) moved on;
// alpha = 2^(m_old - m_new) for the rows' context. On the diagonal tile
// (DIAG) key j of the tile is masked for block row i when j > i; key 0 is
// visible to every row, so m is finite after the first tile. Maxima and
// sums run in four partials a row, so that no chain of dependent adds is
// longer than eight.
template <bool DIAG>
__device__ __forceinline__ void online_softmax(float (&s)[64], float c,
                                               int row0, int lane,
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2]) {
  float mx[2][4], ps[2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mx[0][j] = mx[1][j] = -INFINITY;
    ps[0][j] = ps[1][j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    if (DIAG && 8 * (i >> 2) + 2 * (lane & 3) + (i & 1) > row0 + 8 * r)
      s[i] = -INFINITY;
    mx[r][(i >> 2) & 3] = fmaxf(mx[r][(i >> 2) & 3], s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float mn = fmaxf(m[r], x * c);
    alpha[r] = ex2(m[r] - mn);
    m[r] = mn;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = ex2(fmaf(s[i], c, -m[r]));
    ps[r][(i >> 2) & 3] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] + ((ps[r][0] + ps[r][1]) + (ps[r][2] + ps[r][3]));
}

// p (f32, S's accumulator layout) -> bf16 pairs as wgmma's A operand, one
// k16 slice of keys a row of pa
__device__ __forceinline__ void to_a(const float (&s)[64],
                                     uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pa[kk][j] = pack_bf2(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// Work item w (0 <= w < nq * B * Hq) in order of work, longest first: every
// (head, batch row) of the last row block qt = nq - 1, then of the one
// before. A block takes items j G + i and j G + G - 1 - i in turn (G
// blocks, i its index, j = 0, 1, ...), a snake that gives each block
// about the same number of key tiles.
struct Item {
  int qt, h, b;
};

__device__ __forceinline__ int item_index(int j) {
  const int g = gridDim.x, i = blockIdx.x;
  return j * g + ((j & 1) ? g - 1 - i : i);
}

__device__ __forceinline__ Item item_of(const WsParams& p, int w) {
  const int heads = p.Hq * p.B;
  return {p.nq - 1 - w / heads, w % p.Hq, w % heads / p.Hq};
}

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ WsParams p) {
  constexpr int BOXES = D / 64;
  constexpr uint32_t TILE_BYTES = BN * D * 2;
  static_assert(BM == BN, "the diagonal tile is the last tile of an item");
  extern __shared__ __align__(1024) unsigned char ws_smem[];
  WsSmem<D>& sm = *reinterpret_cast<WsSmem<D>*>(
      (reinterpret_cast<uintptr_t>(ws_smem) + 1023) & ~uintptr_t(1023));
  const int items = p.nq * p.B * p.Hq;
  const int wg = threadIdx.x / WG;
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    mbar_init(&sm.q_empty, CONSUMER_WARPS);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&sm.k_full[st], 1);
      mbar_init(&sm.v_full[st], 1);
      mbar_init(&sm.k_empty[st], CONSUMER_WARPS);
      mbar_init(&sm.v_empty[st], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {                        // producer: one thread starts TMA
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int it = 0;                       // tiles loaded: the ring's position
      for (int j = 0, w; (w = item_index(j)) < items; ++j) {
        const Item e = item_of(p, w);
        const int hk = e.h / (p.Hq / p.Hkv);
        mbar_wait(&sm.q_empty, (j & 1) ^ 1);   // the last item's S done
        mbar_expect(&sm.q_full, TILE_BYTES);
#pragma unroll
        for (int c = 0; c < BOXES; ++c)
          tma_load_4d(sm.q + c * BM * 64, &p.q, &sm.q_full, c * 64, e.h,
                      e.qt * BM, e.b);
        for (int kt = 0; kt <= e.qt; ++kt, ++it) {
          const int st = it % STAGES;
          const uint32_t ph = (it / STAGES) & 1;
          mbar_wait(&sm.k_empty[st], ph ^ 1);   // the stage's last use done
          mbar_expect(&sm.k_full[st], TILE_BYTES);
#pragma unroll
          for (int c = 0; c < BOXES; ++c)
            tma_load_4d(sm.k[st] + c * BN * 64, &p.k, &sm.k_full[st],
                        c * 64, hk, kt * BN, e.b);
          mbar_wait(&sm.v_empty[st], ph ^ 1);
          mbar_expect(&sm.v_full[st], TILE_BYTES);
#pragma unroll
          for (int c = 0; c < BOXES; ++c)
            tma_load_4d(sm.v[st] + c * BN * 64, &p.v, &sm.v_full[st],
                        c * 64, hk, kt * BN, e.b);
        }
      }
    }
    return;
  }

  regs_inc<CONSUMER_REGS>();
  const int cw = wg - 1;                // rows 64 cw .. 64 cw + 63
  const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
  const int row0 = 64 * cw + 16 * warp + lane / 4;    // and row0 + 8
  const float c = p.scale_log2;
  // whose turn it is to start wgmma: named barrier BAR_TURN + cw, synced
  // by its owner and arrived at by the other consumer warpgroup
  auto turn_wait = [&] { named_sync(BAR_TURN + cw, 2 * WG); };
  auto turn_pass = [&] { named_arrive(BAR_TURN + (cw ^ 1), 2 * WG); };
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // S = Q K^T over stage st: D / 16 k16 slices, box kk / 4 of each tile
  auto gemm_s = [&](float (&s)[64], int st) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(
          s,
          wgmma_desc(sm.q + (kk / 4) * BM * 64 + cw * 64 * 64 + (kk % 4) * 16,
                     16, 1024),
          wgmma_desc(sm.k[st] + (kk / 4) * BN * 64 + (kk % 4) * 16, 16,
                     1024),
          kk);
  };
  // O += P V over stage st: 8 k16 slices of keys, V read transposed (the
  // next 64 columns of D one box, BN lines of 128 bytes, on)
  auto gemm_o = [&](float (&o)[D / 2], const uint32_t (&pa)[8][4], int st) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t dv = wgmma_desc(sm.v[st] + kk * 16 * 64, BN * 128, 1024);
      if constexpr (D == 128) wgmma_rs_n128(o, pa[kk], dv);
      else wgmma_rs_n64(o, pa[kk], dv);
    }
  };

  float o[D / 2], s[64], m[2], l[2], alpha[2];
  uint32_t pa[8][4];
  auto rescale = [&] {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
  };
  auto softmax = [&](bool diag) {
    if (diag) online_softmax<true>(s, c, row0, lane, m, l, alpha);
    else online_softmax<false>(s, c, row0, lane, m, l, alpha);
  };
  if (cw == 1) named_arrive(BAR_TURN, 2 * WG);   // warpgroup 0 first
  int it = 0;                           // tiles consumed: the ring's position
  for (int j = 0, w; (w = item_index(j)) < items; ++j) {
    const Item e = item_of(p, w);
    const int nkt = e.qt + 1;           // key tiles 0..qt
    // warpgroup 1 starts the last products of the block's last item
    const bool pass_last = cw == 0 || item_index(j + 1) < items;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
    mbar_wait(&sm.q_full, j & 1);

    // tile 0's S alone; then S of tile kt with P V of tile kt - 1 (the
    // context rescaled between the two); then the last P V
    mbar_wait(&sm.k_full[it % STAGES], (it / STAGES) & 1);
    turn_wait();
    reg_fence(s);
    wgmma_fence();
    gemm_s(s, it % STAGES);
    wgmma_commit();
    turn_pass();
    wgmma_wait<0>();
    reg_fence(s);
    release(&sm.k_empty[it % STAGES]);
    if (nkt == 1) release(&sm.q_empty);
    softmax(nkt == 1);
    to_a(s, pa);
    for (int kt = 1; kt < nkt; ++kt) {
      const int st = (it + kt) % STAGES;
      const int pst = (it + kt - 1) % STAGES;
      mbar_wait(&sm.k_full[st], ((it + kt) / STAGES) & 1);
      mbar_wait(&sm.v_full[pst], ((it + kt - 1) / STAGES) & 1);
      turn_wait();
      reg_fence(s);
      wgmma_fence();
      gemm_s(s, st);
      wgmma_commit();
      rescale();
      wgmma_fence();
      gemm_o(o, pa, pst);
      wgmma_commit();
      turn_pass();
      wgmma_wait<1>();                  // S done, P V still running
      reg_fence(s);
      release(&sm.k_empty[st]);
      if (kt == nkt - 1) release(&sm.q_empty);
      softmax(kt == nkt - 1);
      wgmma_wait<0>();
      reg_fence(o);
      release(&sm.v_empty[pst]);
      to_a(s, pa);
    }
    const int lst = (it + nkt - 1) % STAGES;
    mbar_wait(&sm.v_full[lst], ((it + nkt - 1) / STAGES) & 1);
    turn_wait();
    rescale();
    wgmma_fence();
    gemm_o(o, pa, lst);
    wgmma_commit();
    if (pass_last) turn_pass();
    wgmma_wait<0>();
    reg_fence(o);
    release(&sm.v_empty[lst]);
    it += nkt;

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = e.qt * BM + row0 + 8 * r;
      if (row >= p.T) continue;
      if (p.lse != nullptr && (lane & 3) == 0)  // m and l are the quad's
        p.lse[((long long)e.b * p.Hq + e.h) * p.T + row] =
            m[r] * 0.69314718055994531f + logf(l[r]);
      const float inv = 1.f / l[r];
      __nv_bfloat16* out = p.out
                           + (((long long)e.b * p.T + row) * p.Hq + e.h) * D
                           + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(out + 8 * i) =
            pack_bf2(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 float* lse, long long qsb, long long qst, long long ksb,
                 long long kst, long long vsb, long long vst, int B, int T,
                 int Hq, int Hkv, float scale, void* stream) {
  WsParams p;
  if (!tensor_map_rows(&p.q, q, D, Hq, T, B, qst, qsb, BM)
      || !tensor_map_rows(&p.k, k, D, Hkv, T, B, kst, ksb, BN)
      || !tensor_map_rows(&p.v, v, D, Hkv, T, B, vst, vsb, BN))
    return (int)cudaErrorInvalidValue;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = lse;
  p.nq = (T + BM - 1) / BM;
  p.B = B;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.scale_log2 = scale * 1.4426950408889634f;
  const long long items = (long long)p.nq * Hq * B;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(WsSmem<D>) + 1024;  // + the 1024 alignment
  auto kern = flash_wgmma_kernel<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  // one block an SM walks its items
  const int blocks = items > sms ? sms : (int)items;
  kern<<<blocks, WS_THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: bf16 hi + lo split products on mma.sync
// ---------------------------------------------------------------------------

constexpr int SQ = 64;                  // query rows per block
constexpr int SK = 64;                  // keys per tile
constexpr int SPLIT_THREADS = 32 * SQ / 16;   // 16 query rows a warp

struct Args {
  const float* q;                       // [B, T, Hq, D], strides below
  const float* k;                       // [B, >=T, Hkv, D]
  const float* v;
  float* out;                           // [B, T, Hq, D] contiguous
  float* lse;                           // [B, Hq, T] or null
  long long qsb, qst, ksb, kst, vsb, vst;   // batch, token strides (elems)
  int T, Hq, Hkv;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS) flash_kernel(const Args a) {
  constexpr int TILE = 64 * D;          // elements of one plane of a tile
  constexpr int KD = D / 16;            // mma k-steps over D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + 2 * TILE;    // [2 buffers][hi, lo][64][D]
  __nv_bfloat16* sv = sk + 4 * TILE;

  const int qt = gridDim.x - 1 - blockIdx.x;     // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = qt * SQ;
  const int nkt = (min(q0 + SQ, a.T) + SK - 1) / SK;   // key tiles read
  const float* qg = a.q + b * a.qsb + q0 * a.qst + h * D;
  const float* kg = a.k + b * a.ksb + hk * D;
  const float* vg = a.v + b * a.vsb + hk * D;

  load_tile<D, SQ, SPLIT_THREADS>(sq, sq + TILE, qg, a.qst, a.T - q0,
                                        tid);
  load_tile<D, SK, SPLIT_THREADS>(sk, sk + TILE, kg, a.kst, a.T, tid);
  load_tile<D, SK, SPLIT_THREADS>(sv, sv + TILE, vg, a.vst, a.T, tid);

  uint32_t qa[2][KD][4];
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
      const long long k1 = (long long)(kt + 1) * SK;
      load_tile<D, SK, SPLIT_THREADS>(
          sk + nb * 2 * TILE, sk + nb * 2 * TILE + TILE, kg + k1 * a.kst,
          a.kst, a.T - (int)k1, tid);
      load_tile<D, SK, SPLIT_THREADS>(
          sv + nb * 2 * TILE, sv + nb * 2 * TILE + TILE, vg + k1 * a.vst,
          a.vst, a.T - (int)k1, tid);
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int pl = 0; pl < 2; ++pl)
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          ldmatrix<4>(qa[pl][kk], sq + pl * TILE
                      + sw<D>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
    }
    const __nv_bfloat16* kb = sk + buf * 2 * TILE;
    const __nv_bfloat16* vb = sv + buf * 2 * TILE;

    // S = Q K^T: 16 rows x 64 keys a warp, 8 accumulator tiles of n8
    float s[SK / 8][4];
#pragma unroll
    for (int i = 0; i < SK / 8; ++i)
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < SK / 16; ++np) {
        const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int ch = 2 * kk + ((lane >> 3) & 1);
        uint32_t bh[4], bl[4];
        ldmatrix<4>(bh, kb + sw<D>(key, ch));
        ldmatrix<4>(bl, kb + TILE + sw<D>(key, ch));
        mma_acc(s[2 * np], qa[0][kk], bl[0], bl[1]);
        mma_acc(s[2 * np + 1], qa[0][kk], bl[2], bl[3]);
        mma_acc(s[2 * np], qa[1][kk], bh[0], bh[1]);
        mma_acc(s[2 * np + 1], qa[1][kk], bh[2], bh[3]);
        mma_acc(s[2 * np], qa[0][kk], bh[0], bh[1]);
        mma_acc(s[2 * np + 1], qa[0][kk], bh[2], bh[3]);
      }
    }

    // scale, the causal mask on the last tile, the running max and sum
    const bool edge = kt == nkt - 1;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < SK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * a.scale;
        if (edge) {
          const int key = kt * SK + nt * 8 + 2 * (lane & 3) + (e & 1);
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
    // key kt * SK is visible to every row of the block: the max is finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < SK / 8; ++nt) {
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

    // O += P V: P split into hi and lo as the A operand, straight from S's
    // registers
#pragma unroll
    for (int kk = 0; kk < SK / 16; ++kk) {
      uint32_t pa[2][4];
      split_bf2(s[2 * kk][0], s[2 * kk][1], pa[0][0], pa[1][0]);
      split_bf2(s[2 * kk][2], s[2 * kk][3], pa[0][1], pa[1][1]);
      split_bf2(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[0][2], pa[1][2]);
      split_bf2(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[0][3], pa[1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        const int ch = 2 * dp + (lane >> 4);
        uint32_t bh[4], bl[4];
        ldmatrix_t(bh, vb + sw<D>(key, ch));
        ldmatrix_t(bl, vb + TILE + sw<D>(key, ch));
        mma_acc(o[2 * dp], pa[0], bl[0], bl[1]);
        mma_acc(o[2 * dp + 1], pa[0], bl[2], bl[3]);
        mma_acc(o[2 * dp], pa[1], bh[0], bh[1]);
        mma_acc(o[2 * dp + 1], pa[1], bh[2], bh[3]);
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
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= a.T) continue;
    const float l = half ? l1 : l0;
    float* row = a.out + (((long long)b * a.T + r) * a.Hq + h) * D + col;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(row + i * 8) =
          make_float2(o[i][2 * half] / l, o[i][2 * half + 1] / l);
  }
}

template <int D>
int launch_split(const Args& a, int B, void* stream) {
  const size_t smem = (size_t)10 * 64 * D * 2;
  auto kern = flash_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.T + SQ - 1) / SQ, a.Hq, B);
  kern<<<grid, SPLIT_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, T, Hq, D], k/v [B, >=T, Hkv, D] with element strides (batch,
// token) given and heads and D contiguous, 16-byte aligned rows and
// strides; out [B, T, Hq, D] contiguous; lse [B, Hq, T] f32 or null (not
// written). f32 = 0: bf16 tensors (wgmma; the tensor maps' encoding
// failing returns cudaErrorInvalidValue); f32 = 1: float32 tensors (the
// split products). Returns a cudaError_t.
extern "C" int flash_attn(const void* q, const void* k, const void* v,
                          void* out, float* lse, long long qsb, long long qst,
                          long long ksb, long long kst, long long vsb,
                          long long vst, int B, int T, int Hq, int Hkv, int D,
                          int f32, float scale, void* stream) {
  if (B < 0 || T < 0 || Hkv < 1 || Hq < Hkv || Hq % Hkv || B > 65535
      || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  if (f32) {
    const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<float*>(out),
                 lse, qsb, qst, ksb, kst, vsb, vst, T, Hq, Hkv, scale};
    if (D == 64) return launch_split<64>(a, B, stream);
    if (D == 128) return launch_split<128>(a, B, stream);
    return (int)cudaErrorInvalidValue;
  }
  if (D == 64)
    return launch_wgmma<64>(q, k, v, out, lse, qsb, qst, ksb, kst, vsb, vst,
                            B, T, Hq, Hkv, scale, stream);
  if (D == 128)
    return launch_wgmma<128>(q, k, v, out, lse, qsb, qst, ksb, kst, vsb, vst,
                             B, T, Hq, Hkv, scale, stream);
  return (int)cudaErrorInvalidValue;
}
