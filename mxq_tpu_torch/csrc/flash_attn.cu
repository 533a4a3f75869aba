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
// float32 inputs (the float32 model, the CLI's default) run the same
// kernel (F32 = true) on bf16 hi and lo planes (flash_split.cuh): one
// launch of fwd_split_kernel writes q's, k's and v's planes [2B, T, H, W]
// (the first T rows of k and v only, zeros past the true head_dim D in
// columns D .. W, so no padded copy is made), then the kernel's tensor
// maps read the planes as they read bf16 rows. Every plane doubles the
// tiles, so K and V come in 64-key tiles through two stages: per tile S =
// Q K^T is three SS products (hi.lo, lo.hi, hi.hi) into one accumulator, P
// is split into hi and lo bf16 pairs straight from S's registers, and O
// += P V is three register-A products; the item's last two key tiles are
// masked (for the first warpgroup the last one entirely). The output is
// written in f32. Shared memory at D = 128: Q hi and lo 64 KB, two stages
// of K and V hi and lo, 64 KB each (192 KB); consumer registers: O 64, S
// 32, P's hi and lo pairs 32. The design's floor is three times the
// bf16 bound (0.104 ms at T = 2048, 32 heads of 128) plus the split
// pass's bytes (201 MB there, 0.06 ms).
//
// A head_dim D that is not a template width runs at the next one, W, with
// zeros past D in every tile, reading its rows in place (no padded copy)
// and writing its output D columns wide (NARROW):
// - bf16, D % 8 == 0 (80, 96, 192): the tensor maps' column extent is D,
//   so TMA fills columns D .. W of each 64-column box with zeros;
// - bf16, D even otherwise (open_llama_3b's 100: a head stride of 200
//   bytes, which a tensor map refuses, and TMA faults on a box that
//   starts off 16 bytes): the producer warpgroup's 128 threads copy the
//   rows by cp.async of 8 bytes (D % 4 == 0) or 4 into the same swizzled
//   layout (CPA), zero-filling columns >= D and tokens >= T; each thread's
//   copies complete on the stage's full mbarrier
//   (cp.async.mbarrier.arrive.noinc, 128 arrivals), and the consumers
//   fence the generic proxy's writes before wgmma reads them. The
//   producer computes addresses, so it keeps 40 registers (consumers
//   232); cp.async costs more than TMA (about 1.4x at D = 100 against
//   TMA at 96, PERF.md), the price of rows TMA cannot address;
// - float32: the split pass writes the planes W wide, zeros past D.
// An odd D, or a view whose rows start off 4 bytes, reaches the kernels
// on zero-padded copies at W (ops/attn_bf16.py load_route).
//
// head_dim 256 (D in 129..256 runs at it) keeps the design with smaller
// tiles, as the tiles of D <= 128 outgrow shared memory (Q alone is 64 KB
// at bf16, 128 KB at float32): bf16 K and V in 64-key tiles through two
// stages (Q 64 KB, the ring 128 KB: 192 KB), O += P V one m64n256k16
// product a k16 slice, O 128 registers of a consumer's 240; float32 in
// 32-key tiles through one stage (Q's planes 128 KB, the ring 64 KB: 192
// KB), so that each tile's copies wait for the last tile's products.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

#include "device_util.cuh"
#include "hopper_util.cuh"
#include "flash_split.cuh"

// ---------------------------------------------------------------------------
// wgmma, TMA, warp specialisation: bf16 rows, or float32's hi and lo planes
// ---------------------------------------------------------------------------

constexpr int BM = 128;                 // query rows a work item
constexpr int WG = 128;                 // threads of a warpgroup
constexpr int WS_THREADS = 3 * WG;      // producer + two consumers
// registers of a producer and a consumer thread after setmaxnreg (the
// block's 384 x 168 shared out again): a TMA producer needs few, a
// cp.async producer (CPA) computes addresses for its 128 threads' copies
template <bool CPA>
struct Regs {
  static constexpr int PRODUCER = CPA ? 40 : 24, CONSUMER = CPA ? 232 : 240;
};
constexpr int CONSUMER_WARPS = 8;       // arrivals that empty a stage
constexpr int BAR_TURN = 1;             // named barriers 1, 2: whose turn
constexpr int BAR_PRODUCER = 3;         // a cp.async producer's threads

// The tiles of each path: planes (hi, and lo for float32), keys a tile,
// K and V tiles in flight; at D = 256 fewer of each, to fit shared memory
template <int D, bool F32>
struct Tiles {
  static constexpr int NP = F32 ? 2 : 1;
  static constexpr int BN = D > 128 ? (F32 ? 32 : 64) : (F32 ? 64 : 128);
  static constexpr int STAGES = D > 128 ? (F32 ? 1 : 2) : (F32 ? 2 : 3);
};

struct WsParams {
  CUtensorMap q, k, v;                  // 4-D (d, heads, T, B) maps; at
                                        // float32 over the planes (2B)
  Rows qr, kr, vr;                      // or bf16 rows read by cp.async
  void* out;                            // [B, T, Hq, d] contiguous, bf16
                                        // or float32
  float* lse;                           // [B, Hq, T] or null
  int nq, B, T, Hq, Hkv;                // nq: row blocks, ceil(T / BM)
  int d, gran;                          // head_dim, cp.async bytes
  float scale_log2;                     // scale * log2(e)
};

template <int D, bool F32>
struct WsSmem {                         // every tile 1024-byte aligned
  using C = Tiles<D, F32>;
  __nv_bfloat16 q[C::NP * BM * D];      // per plane D / 64 boxes of [BM][64]
  __nv_bfloat16 k[C::STAGES][C::NP * C::BN * D];   // [BN][64] boxes
  __nv_bfloat16 v[C::STAGES][C::NP * C::BN * D];
  uint64_t q_full, q_empty, k_full[C::STAGES], v_full[C::STAGES],
      k_empty[C::STAGES], v_empty[C::STAGES];
};

// One tile's raw scores s (this lane's N / 2 of the warpgroup's 64 x N) ->
// p = 2^(s c - m_new) in place, f32; the running max m (in units of s c)
// and sum l of the lane's two rows (row, row + 8 of the block) moved on;
// alpha = 2^(m_old - m_new) for the rows' context. With DIAG key j of the
// tile is masked for block row i when j > i - koff (koff: the tile's first
// key less the block's first row); every row sees a key of the item's
// first tile, so m is finite after it. Maxima and sums run in four
// partials a row, so that no chain of dependent adds is longer than N / 16.
template <bool DIAG, int N>
__device__ __forceinline__ void online_softmax(float (&s)[N / 2], float c,
                                               int row, int lane,
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2]) {
  float mx[2][4], ps[2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mx[0][j] = mx[1][j] = -INFINITY;
    ps[0][j] = ps[1][j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i >> 1) & 1;
    if (DIAG && 8 * (i >> 2) + 2 * (lane & 3) + (i & 1) > row + 8 * r)
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
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = ex2(fmaf(s[i], c, -m[r]));
    ps[r][(i >> 2) & 3] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] + ((ps[r][0] + ps[r][1]) + (ps[r][2] + ps[r][3]));
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

// CPA: the producer warpgroup copies bf16 rows by cp.async (else one
// thread by TMA); NARROW: the output is d < D columns wide (else the
// template's own code, d = D: an epilogue that took any d cost the
// template widths 3-10%, PERF.md)
template <int D, bool F32, bool CPA, bool NARROW>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ WsParams p) {
  using C = Tiles<D, F32>;
  using OutT = typename std::conditional<F32, float, __nv_bfloat16>::type;
  constexpr int NP = C::NP, BN = C::BN, STAGES = C::STAGES;
  // a full barrier's arrivals: TMA's one expect, or each producer thread's
  // cp.async arrival
  constexpr int FULL_ARRIVALS = CPA ? CP_THREADS : 1;
  constexpr int BOXES = D / 64;
  constexpr int DIAG_TILES = BM / BN;   // the item's last tiles, masked
  constexpr uint32_t Q_BYTES = NP * BM * D * 2, TILE_BYTES = NP * BN * D * 2;
  extern __shared__ __align__(1024) unsigned char ws_smem[];
  WsSmem<D, F32>& sm = *reinterpret_cast<WsSmem<D, F32>*>(
      (reinterpret_cast<uintptr_t>(ws_smem) + 1023) & ~uintptr_t(1023));
  const int items = p.nq * p.B * p.Hq;
  const int wg = threadIdx.x / WG;
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, FULL_ARRIVALS);
    mbar_init(&sm.q_empty, CONSUMER_WARPS);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&sm.k_full[st], FULL_ARRIVALS);
      mbar_init(&sm.v_full[st], FULL_ARRIVALS);
      mbar_init(&sm.k_empty[st], CONSUMER_WARPS);
      mbar_init(&sm.v_empty[st], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {                        // producer
    regs_dec<Regs<CPA>::PRODUCER>();
    if constexpr (CPA) {                // every thread copies by cp.async
      const int t = threadIdx.x;
      int it = 0;
      for (int j = 0, w; (w = item_index(j)) < items; ++j) {
        const Item e = item_of(p, w);
        const int hk = e.h / (p.Hq / p.Hkv);
        producer_wait(&sm.q_empty, (j & 1) ^ 1, t, BAR_PRODUCER);
        cp_rows<D, BM>(sm.q, p.qr, p.d, p.T, p.gran, e.h, e.qt * BM, e.b,
                       t);
        cp_async_arrive_noinc(&sm.q_full);
        const int nkt = (e.qt + 1) * DIAG_TILES;
        for (int kt = 0; kt < nkt; ++kt, ++it) {
          const int st = it % STAGES;
          const uint32_t ph = (it / STAGES) & 1;
          producer_wait(&sm.k_empty[st], ph ^ 1, t, BAR_PRODUCER);
          cp_rows<D, BN>(sm.k[st], p.kr, p.d, p.T, p.gran, hk, kt * BN, e.b,
                         t);
          cp_async_arrive_noinc(&sm.k_full[st]);
          producer_wait(&sm.v_empty[st], ph ^ 1, t, BAR_PRODUCER);
          cp_rows<D, BN>(sm.v[st], p.vr, p.d, p.T, p.gran, hk, kt * BN, e.b,
                         t);
          cp_async_arrive_noinc(&sm.v_full[st]);
        }
      }
    } else if (threadIdx.x == 0) {      // one thread starts TMA
      int it = 0;                       // tiles loaded: the ring's position
      for (int j = 0, w; (w = item_index(j)) < items; ++j) {
        const Item e = item_of(p, w);
        const int hk = e.h / (p.Hq / p.Hkv);
        mbar_wait(&sm.q_empty, (j & 1) ^ 1);   // the last item's S done
        mbar_expect(&sm.q_full, Q_BYTES);
#pragma unroll
        for (int pl = 0; pl < NP; ++pl)  // plane pl of batch row b: b + pl B
#pragma unroll
          for (int c = 0; c < BOXES; ++c)
            tma_load_4d(sm.q + (pl * BOXES + c) * BM * 64, &p.q, &sm.q_full,
                        c * 64, e.h, e.qt * BM, e.b + pl * p.B);
        const int nkt = (e.qt + 1) * DIAG_TILES;
        for (int kt = 0; kt < nkt; ++kt, ++it) {
          const int st = it % STAGES;
          const uint32_t ph = (it / STAGES) & 1;
          mbar_wait(&sm.k_empty[st], ph ^ 1);   // the stage's last use done
          mbar_expect(&sm.k_full[st], TILE_BYTES);
#pragma unroll
          for (int pl = 0; pl < NP; ++pl)
#pragma unroll
            for (int c = 0; c < BOXES; ++c)
              tma_load_4d(sm.k[st] + (pl * BOXES + c) * BN * 64, &p.k,
                          &sm.k_full[st], c * 64, hk, kt * BN,
                          e.b + pl * p.B);
          mbar_wait(&sm.v_empty[st], ph ^ 1);
          mbar_expect(&sm.v_full[st], TILE_BYTES);
#pragma unroll
          for (int pl = 0; pl < NP; ++pl)
#pragma unroll
            for (int c = 0; c < BOXES; ++c)
              tma_load_4d(sm.v[st] + (pl * BOXES + c) * BN * 64, &p.v,
                          &sm.v_full[st], c * 64, hk, kt * BN,
                          e.b + pl * p.B);
        }
      }
    }
    return;
  }

  regs_inc<Regs<CPA>::CONSUMER>();
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

  float o[D / 2], s[BN / 2], m[2], l[2], alpha[2];
  uint32_t pa[NP][BN / 16][4];
  // S = Q K^T over stage st (BN keys), the warpgroup's 64 rows of Q
  auto gemm_s = [&](int st) {
    gemm_abt<D, BM, BN, NP>(s, sm.q, 64 * cw, sm.k[st]);
  };
  // O += P V over stage st, V read transposed (no copy of V made)
  auto gemm_o = [&](int st) { gemm_xb<D, BN, NP>(o, pa, sm.v[st]); };
  auto rescale = [&] {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
  };
  // key tile kt of nkt: the last DIAG_TILES are masked, key j of the tile
  // seen by item row i when j <= i - koff
  auto softmax = [&](int kt, int nkt) {
    const int koff = (kt - (nkt - DIAG_TILES)) * BN;
    if (koff >= 0)
      online_softmax<true, BN>(s, c, row0 - koff, lane, m, l, alpha);
    else online_softmax<false, BN>(s, c, row0, lane, m, l, alpha);
  };
  if (cw == 1) named_arrive(BAR_TURN, 2 * WG);   // warpgroup 0 first
  int it = 0;                           // tiles consumed: the ring's position
  for (int j = 0, w; (w = item_index(j)) < items; ++j) {
    const Item e = item_of(p, w);
    const int nkt = (e.qt + 1) * DIAG_TILES;   // key tiles of the item
    // warpgroup 1 starts the last products of the block's last item
    const bool pass_last = cw == 0 || item_index(j + 1) < items;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
    wait_tile<CPA>(&sm.q_full, j & 1);

    // tile 0's S alone; then S of tile kt with P V of tile kt - 1 (the
    // context rescaled between the two); then the last P V
    wait_tile<CPA>(&sm.k_full[it % STAGES], (it / STAGES) & 1);
    turn_wait();
    reg_fence(s);
    wgmma_fence();
    gemm_s(it % STAGES);
    wgmma_commit();
    turn_pass();
    wgmma_wait<0>();
    reg_fence(s);
    release(&sm.k_empty[it % STAGES]);
    if (nkt == 1) release(&sm.q_empty);
    softmax(0, nkt);
    to_pairs<NP, BN>(s, pa);
    for (int kt = 1; kt < nkt; ++kt) {
      const int st = (it + kt) % STAGES;
      const int pst = (it + kt - 1) % STAGES;
      wait_tile<CPA>(&sm.k_full[st], ((it + kt) / STAGES) & 1);
      wait_tile<CPA>(&sm.v_full[pst], ((it + kt - 1) / STAGES) & 1);
      turn_wait();
      reg_fence(s);
      wgmma_fence();
      gemm_s(st);
      wgmma_commit();
      rescale();
      wgmma_fence();
      gemm_o(pst);
      wgmma_commit();
      turn_pass();
      wgmma_wait<1>();                  // S done, P V still running
      reg_fence(s);
      release(&sm.k_empty[st]);
      if (kt == nkt - 1) release(&sm.q_empty);
      softmax(kt, nkt);
      wgmma_wait<0>();
      reg_fence(o);
      release(&sm.v_empty[pst]);
      to_pairs<NP, BN>(s, pa);
    }
    const int lst = (it + nkt - 1) % STAGES;
    wait_tile<CPA>(&sm.v_full[lst], ((it + nkt - 1) / STAGES) & 1);
    turn_wait();
    rescale();
    wgmma_fence();
    gemm_o(lst);
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
      if constexpr (NARROW) {           // columns < d, the output's width
        OutT* const out = static_cast<OutT*>(p.out)
                          + (((long long)e.b * p.T + row) * p.Hq + e.h) * p.d;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          const int col = 8 * i + 2 * (lane & 3);
          store_cols(out + col, col, p.d, o[4 * i + 2 * r] * inv,
                     o[4 * i + 2 * r + 1] * inv);
        }
        continue;
      }
      const long long at = (((long long)e.b * p.T + row) * p.Hq + e.h) * D
                           + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const float x = o[4 * i + 2 * r] * inv, y = o[4 * i + 2 * r + 1] * inv;
        if constexpr (F32)
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at
                                     + 8 * i) = make_float2(x, y);
        else
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.out)
                                       + at + 8 * i) = pack_bf2(x, y);
      }
    }
  }
}

// The kernel over p's maps (or, CPA, rows), its output d columns wide:
// one persistent block an SM.
template <int D, bool F32, bool CPA>
int launch_wgmma(WsParams& p, int B, int T, int Hq, int Hkv, int d,
                 float scale, cudaStream_t stream) {
  p.nq = (T + BM - 1) / BM;
  p.d = d;
  p.B = B;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.scale_log2 = scale * LOG2E;
  const long long items = (long long)p.nq * Hq * B;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(WsSmem<D, F32>) + 1024;  // + the alignment
  void (*kern)(WsParams);               // cp.async only at NARROW
  if constexpr (CPA)
    kern = flash_wgmma_kernel<D, F32, true, true>;
  else
    kern = d < D ? flash_wgmma_kernel<D, F32, false, true>
                 : flash_wgmma_kernel<D, F32, false, false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  // one block an SM walks its items
  const int blocks = items > sms ? sms : (int)items;
  kern<<<blocks, WS_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// bf16 rows of head_dim d <= D read in place: gran 0, the maps over q, k,
// v on their strides (column extent d: TMA fills columns d .. D with
// zeros); gran 4 or 8, the producer's cp.async of that many bytes
template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, long long qsb, long long qst, long long ksb,
                long long kst, long long vsb, long long vst, int B, int T,
                int Hq, int Hkv, int d, int gran, float scale,
                cudaStream_t stream) {
  WsParams p;
  p.out = out;
  p.lse = lse;
  p.gran = gran;
  if (gran) {
    p.qr = {static_cast<const __nv_bfloat16*>(q), qsb, qst};
    p.kr = {static_cast<const __nv_bfloat16*>(k), ksb, kst};
    p.vr = {static_cast<const __nv_bfloat16*>(v), vsb, vst};
    return launch_wgmma<D, false, true>(p, B, T, Hq, Hkv, d, scale,
                                        stream);
  }
  if (!tensor_map_rows(&p.q, q, d, Hq, T, B, qst, qsb, BM)
      || !tensor_map_rows(&p.k, k, d, Hkv, T, B, kst, ksb,
                          Tiles<D, false>::BN)
      || !tensor_map_rows(&p.v, v, d, Hkv, T, B, vst, vsb,
                          Tiles<D, false>::BN))
    return (int)cudaErrorInvalidValue;
  return launch_wgmma<D, false, false>(p, B, T, Hq, Hkv, d, scale,
                                       stream);
}

// float32: the split pass into planes (q's, then k's, then v's, each
// [2B, T, H, W]), then the kernel over maps of the planes
template <int W>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, long long qsb, long long qst, long long ksb,
               long long kst, long long vsb, long long vst, int B, int T,
               int Hq, int Hkv, int d, float scale, __nv_bfloat16* planes,
               cudaStream_t stream) {
  constexpr int BN = Tiles<W, true>::BN;
  __nv_bfloat16* qp = planes;
  __nv_bfloat16* kp = qp + 2LL * B * T * Hq * W;
  __nv_bfloat16* vp = kp + 2LL * B * T * Hkv * W;
  SplitParams sp{};
  sp.job[0] = split_job(q, qsb, qst, qp, Hq, d);
  sp.job[1] = split_job(k, ksb, kst, kp, Hkv, d);
  sp.job[2] = split_job(v, vsb, vst, vp, Hkv, d);
  sp.B = B;
  sp.T = T;
  sp.D = d;
  sp.di_job = -1;
  int err = launch_split<W, false>(sp, 3, (long long)B * T * Hq, stream);
  if (err) return err;
  WsParams p;
  if (!tensor_map_planes(&p.q, qp, W, Hq, T, B, BM)
      || !tensor_map_planes(&p.k, kp, W, Hkv, T, B, BN)
      || !tensor_map_planes(&p.v, vp, W, Hkv, T, B, BN))
    return (int)cudaErrorInvalidValue;
  p.out = out;
  p.lse = lse;
  return launch_wgmma<W, true, false>(p, B, T, Hq, Hkv, d, scale,
                                      stream);
}

// Whether bf16 rows x (element strides sb, st; heads d apart) start and
// step on multiples of `bytes`
inline bool rows_aligned(const void* x, long long sb, long long st, int d,
                         int bytes) {
  return reinterpret_cast<uintptr_t>(x) % bytes == 0 && sb * 2 % bytes == 0
         && st * 2 % bytes == 0 && d * 2 % bytes == 0;
}

}  // namespace

// q [B, T, Hq, d], k/v [B, >=T, Hkv, d] with element strides (batch,
// token) given and heads and d contiguous; out [B, T, Hq, d] contiguous in
// the inputs' type; lse [B, Hq, T] f32 or null (not written). W (64, 128
// or 256) is the kernel's head_dim template, d <= W the true head_dim (the
// kernel's tiles hold zeros in columns d .. W); scale is 1/sqrt(d). f32 =
// 0: bf16 tensors read in place, `load` says how: 0 by TMA (d % 8 == 0,
// 16-byte aligned rows and strides; the tensor maps' encoding failing
// returns cudaErrorInvalidValue), 8 or 4 by the producer's cp.async of
// that many bytes (d even, d % 4 == 0 for 8; rows and strides aligned to
// them); planes is not read. f32 = 1: float32 tensors; planes: bf16
// scratch of 2 B T (Hq + 2 Hkv) W elements, 16-byte aligned, for the split
// pass; load is not read. Returns a cudaError_t.
extern "C" int flash_attn(const void* q, const void* k, const void* v,
                          void* out, float* lse, long long qsb, long long qst,
                          long long ksb, long long kst, long long vsb,
                          long long vst, int B, int T, int Hq, int Hkv, int W,
                          int d, int f32, int load, float scale,
                          void* planes, void* stream) {
  if (B < 0 || T < 0 || Hkv < 1 || Hq < Hkv || Hq % Hkv || B > 65535
      || Hq > 65535 || d < 1 || d > W)
    return (int)cudaErrorInvalidValue;
  if (!f32 && load
      && ((load != 4 && load != 8) || !rows_aligned(q, qsb, qst, d, load)
          || !rows_aligned(k, ksb, kst, d, load)
          || !rows_aligned(v, vsb, vst, d, load)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (f32) {
    auto* pl = static_cast<__nv_bfloat16*>(planes);
    if (pl == nullptr) return (int)cudaErrorInvalidValue;
    if (W == 64)
      return launch_f32<64>(q, k, v, out, lse, qsb, qst, ksb, kst, vsb, vst,
                            B, T, Hq, Hkv, d, scale, pl, st);
    if (W == 128)
      return launch_f32<128>(q, k, v, out, lse, qsb, qst, ksb, kst, vsb, vst,
                             B, T, Hq, Hkv, d, scale, pl, st);
    if (W == 256)
      return launch_f32<256>(q, k, v, out, lse, qsb, qst, ksb, kst, vsb, vst,
                             B, T, Hq, Hkv, d, scale, pl, st);
    return (int)cudaErrorInvalidValue;
  }
  if (W == 64)
    return launch_bf16<64>(q, k, v, out, lse, qsb, qst, ksb, kst, vsb, vst,
                           B, T, Hq, Hkv, d, load, scale, st);
  if (W == 128)
    return launch_bf16<128>(q, k, v, out, lse, qsb, qst, ksb, kst, vsb, vst,
                            B, T, Hq, Hkv, d, load, scale, st);
  if (W == 256)
    return launch_bf16<256>(q, k, v, out, lse, qsb, qst, ksb, kst, vsb, vst,
                            B, T, Hq, Hkv, d, load, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The split pass alone, over one float32 tensor x [B, T, H, d] (element
// strides sb, st; heads and d contiguous) into planes [2B, T, H, W] bf16
// (hi, then lo; zeros in columns d .. W). Returns a cudaError_t.
extern "C" int flash_split(const void* x, long long sb, long long st,
                           void* planes, int B, int T, int H, int d, int W,
                           void* stream) {
  if (B < 0 || T < 0 || H < 1 || d < 1 || d > W || planes == nullptr)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  SplitParams sp{};
  sp.job[0] = split_job(x, sb, st, static_cast<__nv_bfloat16*>(planes), H,
                        d);
  sp.B = B;
  sp.T = T;
  sp.D = d;
  sp.di_job = -1;
  const long long rows = (long long)B * T * H;
  if (W == 64) return launch_split<64, false>(sp, 1, rows, (cudaStream_t)stream);
  if (W == 128)
    return launch_split<128, false>(sp, 1, rows, (cudaStream_t)stream);
  if (W == 256)
    return launch_split<256, false>(sp, 1, rows, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
