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
// dO, dS . K, dS^T . Q) as upstream rounds them, against the running max
// in the forward; at float32 every product is three bf16 products of hi
// and lo planes (hi.lo + lo.hi + hi.hi), the planes written first by a
// split pass (flash_split.cuh's load8 and split_bf2) at the width of
// whole 64-column boxes, zeros past D.
//
// Design: D is cut into NR = ceil(D / 256) ranges of 256 columns, and a
// thread-block cluster of C = min(NR, 8) blocks shares one work item:
// - forward and dQ: 64 query rows of one (query head, batch row); dK/dV:
//   64 keys of one (kv head, batch row);
// - block r of the cluster holds the item's 64 rows of its range's
//   columns of Q (forward; and dO for dQ; K and V for dK/dV) in shared
//   memory, and streams the other operands' tiles of the same columns
//   (K and V tiles of N keys, or Q and dO tiles of N queries) through a
//   ring filled by TMA (a producer warpgroup, one thread issuing every
//   copy; full and empty mbarriers a stage);
// - its two consumer warpgroups split the range, 128 columns each. For
//   each tile each computes its partial S = Q K^T over its 128 columns
//   (and dP = dO V^T; dK/dV: S^T = K Q^T, dP^T = V dO^T) on wgmma with
//   both operands in shared memory; the block adds its two partials
//   into its block sum, and the cluster's C block sums are added in rank
//   order: each block writes its sum into its own shared memory and
//   signals every block (one cluster fence, then remote mbarrier
//   arrivals), each warpgroup waits for the C signals on its own block's
//   barrier and reads the other blocks' sums through distributed shared
//   memory (ld.shared::cluster). So every warpgroup of the cluster holds
//   S with the same bits, runs the same online softmax (or forms the same
//   P and dS) and holds the same m and l;
// - then each warpgroup adds its output's 128 columns: O += P V (dQ +=
//   dS K; dV += P^T dO, dK += dS^T Q) on wgmma with P (dS) from
//   registers and the tile read transposed, as the templates do.
// So S (and dP) is computed once per (row tile, key tile) pair: at D =
// 512, in units of one causal T x T x D product, the forward does 2 (S,
// P V), the dQ kernel 3 (S, dP, dQ) and the dK/dV kernel 4 (S, dP, dV,
// dK), the bound's 2 and 5; at float32 each unit is three bf16 products.
// Past the cluster limit (D > 2048, NR > 8) the output columns are cut
// into NG = ceil(NR / 8) groups of 8 ranges, a cluster of 8 blocks per
// group: block r of group g writes range 8 g + r and sums its partials
// over ranges r, r + 8, ... in that order in every group, so each group
// computes S once (NG times in all) with the same bits as the others;
// there the resident operand is reloaded for every (tile, range) step,
// and the backward loads the output range's tiles once more, in a step
// of their own, where that range is not the block's last.
// Items run longest first; a cluster walks one item. Tiles: forward N =
// 64 keys (float32 32), two stages; backward N = 32 rows (float32 16),
// three stages (float32 two). No atomics: the same bits on every call,
// whatever the batch. The tensor maps' token extent is T, so no row >= T
// is read (TMA fills zeros).
//
// Bound on the H100: operations (forward 4 Hq D T(T+1)/2, backward
// 10 Hq D T(T+1)/2, three times that at float32). What holds this design
// is the exchange, not the products: on the H100 at D = 512, copies of
// this source without the exchange ran 2-3x faster, and without either
// product barely faster; hence block sums (not warpgroup partials) over
// distributed shared memory and one cluster fence a round.

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

constexpr int FWD = 0, DQ = 1, DKV = 2;  // the three kernels
constexpr int WG = 128;                 // threads of a warpgroup
constexpr int THREADS = 3 * WG;         // producer + two consumers
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int CONSUMER_WARPS = 8;       // arrivals that free a buffer
constexpr int RA = 64;                  // rows of the resident operands
constexpr int DR = 256;                 // columns of a range
constexpr int CMAX = 8;                 // blocks of a cluster at most
constexpr float LN2 = 0.6931471805599453f;

// keys (forward) or rows (backward) a ring tile, stages, and the partial
// matrices a tile exchanges
template <int MODE, int NP>
struct Cfg {
  static constexpr int N = MODE == FWD ? (NP == 2 ? 32 : 64)
                                       : (NP == 2 ? 16 : 32);
  static constexpr int STAGES = MODE == FWD || NP == 2 ? 2 : 3;
  static constexpr int NM = MODE == FWD ? 1 : 2;
  // bf16 elements: the resident tiles (a, and b but in the forward), a
  // stage's tiles x and y; then the exchange's f32 partials
  static constexpr int A = NP * RA * DR, X = NP * N * DR;
  static constexpr int TILES = (MODE == FWD ? 1 : 2) * A + 2 * STAGES * X;
  // floats: the two warpgroups' partials, two slots of the block's sum
  static constexpr int XB = 4 * NM * RA * N;
  static constexpr size_t BYTES = 2 * (size_t)TILES + 4 * (size_t)XB
                                  + 8 * (4 + 2 * STAGES);
};

struct Params {
  CUtensorMap a, b, x, y;   // resident (a, b) and ring (x, y) operands'
                            // 4-D maps (w, heads, T, B or 2B planes)
  void* out0;               // forward out, dQ, dK
  void* out1;               // dV
  float* lse;               // forward: [B, Hq, T] or null
  const float* lse2;        // backward: lse log2(e) [B, Hq, T]
  const float* di;          // backward: rowsum(o . dO) [B, Hq, T]
  long long kvsb;           // dK/dV's batch stride
  int B, T, Hq, Hkv, G, d;
  int NR, C, NG;            // ranges, cluster size, column groups
  float scale, scale_log2;
};

// ---- clusters: rank, remote arrivals and loads ----------------------------

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// a shared::cta address as block `rank` of the cluster sees it
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// until phase `parity` of this block's barrier has completed, acquiring
// at cluster scope what the arrivals released (measured: polling this way
// cost less than polling at block scope and one cluster fence after)
__device__ __forceinline__ void wait_cluster(uint64_t* bar,
                                             uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1],"
        " %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ float4 ld_cluster(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr) : "memory");
  return v;
}

// ---- products over a range's boxes ----------------------------------------
// A tile of R rows of a range lies as 4 boxes of R lines of 128 bytes
// (TMA's 128-byte swizzle), its lo plane R * DR elements after its hi.

// acc (+)= A . X^T over boxes b0 .. b0 + nb - 1 of the range: A the 64
// resident rows, X a ring tile of N rows; `fresh`: the first product
// overwrites acc. NP = 2: hi.lo + lo.hi + hi.hi.
template <int N, int NP>
__device__ __forceinline__ void partial(float (&acc)[N / 2], const bf16* a,
                                        const bf16* x, int b0, int nb,
                                        bool& fresh) {
  for (int bx = b0; bx < b0 + nb; ++bx)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const bf16* ap = a + bx * RA * 64 + kk * 16;
      const bf16* xp = x + bx * N * 64 + kk * 16;
      if constexpr (NP == 2) {
        wgmma_ss<N>(acc, wgmma_desc(ap, 16, 1024),
                    wgmma_desc(xp + N * DR, 16, 1024), fresh ? 0 : 1);
        wgmma_ss<N>(acc, wgmma_desc(ap + RA * DR, 16, 1024),
                    wgmma_desc(xp, 16, 1024), 1);
        wgmma_ss<N>(acc, wgmma_desc(ap, 16, 1024), wgmma_desc(xp, 16, 1024),
                    1);
      } else {
        wgmma_ss<N>(acc, wgmma_desc(ap, 16, 1024), wgmma_desc(xp, 16, 1024),
                    fresh ? 0 : 1);
      }
      fresh = false;
    }
}

// acc [64 x 128] += P . Y[:, boxes b0, b0 + 1]: P [64 x N] as bf16 pairs
// (hi, then lo at NP = 2), Y a ring tile of N rows read transposed
template <int N, int NP>
__device__ __forceinline__ void out_product(float (&acc)[64],
                                            const uint32_t (&p)[NP][N / 16][4],
                                            const bf16* y, int b0) {
  const bf16* b = y + b0 * N * 64;
  auto one = [&](const uint32_t (&pp)[N / 16][4], const bf16* bp) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_rs<128>(acc, pp[kk], wgmma_desc(bp + kk * 16 * 64, N * 128,
                                            1024));
  };
  if constexpr (NP == 2) {
    one(p[0], b + N * DR);
    one(p[1], b);
    one(p[0], b);
  } else {
    one(p[0], b);
  }
}

// One tile's raw scores s (this lane's N / 2 of the warpgroup's 64 x N) ->
// p = 2^(s c - m_new) in place, f32; the running max m (in units of s c)
// and sum l of the lane's two rows (row, row + 8) moved on; alpha =
// 2^(m_old - m_new) for the rows' context. With DIAG key j of the tile is
// masked for row i when j > row (row: the lane's row less the tile's
// first key). flash_attn.cu's softmax, four partials a row.
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

// ---- the exchange ---------------------------------------------------------

// The cluster's sum of the NM partials x[0 .. NM) of a tile (each [64 x
// N], this lane's N / 2), round `round` of the item. The block's two
// warpgroups add their partials through shared memory (warpgroup 0's
// first) into the block's sum b; each writes half of b into the round's
// slot of the block's sum buffer, and one thread signals every block of
// the cluster (one cluster fence, then relaxed remote arrivals: an
// arrival that released at cluster scope by itself cost microseconds,
// and a slot needed a second signal to be freed); then every warpgroup
// waits for the cluster's C block sums and adds them in rank order into
// x (a remote block's read through distributed shared memory, its loads
// issued together, then added; its own from its shared memory).
// Distributed shared memory is the scarce path (summing all 2C warpgroup
// partials there took most of a tile's time), so only block sums cross
// it. Two slots and no signal that frees them: a block writes slot s
// again two rounds on, after it has seen every block's signal of the
// round between, which each block gives only after both its warpgroups
// finished reading slot s.
constexpr int BAR_BLOCK = 3;            // named barrier of both consumers

// one cluster fence (this warpgroup's writes, ordered before it by the
// block barrier, released at cluster scope), then a relaxed arrival on
// barrier `bar` of every block of the cluster
__device__ __forceinline__ void signal_cluster(uint64_t* bar, int C) {
  asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
  for (int c = 0; c < C; ++c)
    asm volatile(
        "mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [%0];\n" ::
            "r"(mapa(smem_addr(bar), c)) : "memory");
}

template <int N, int NM>
__device__ __forceinline__ void exchange(float (&x)[NM][N / 2], float* xb,
                                         uint64_t* ready, int round, int C,
                                         int rank, int cw, int t) {
  constexpr int V4 = N / 8;             // float4s a lane a matrix
  constexpr int PART = NM * RA * N;     // floats a partial
  const int slot = round & 1;
  float4* mine = reinterpret_cast<float4*>(xb + cw * PART);
  const float4* other =
      reinterpret_cast<const float4*>(xb + (1 - cw) * PART);
  float4* sum = reinterpret_cast<float4*>(xb + (2 + slot) * PART);
#pragma unroll
  for (int mt = 0; mt < NM; ++mt)
#pragma unroll
    for (int i = 0; i < V4; ++i)
      mine[(mt * V4 + i) * WG + t] =
          make_float4(x[mt][4 * i], x[mt][4 * i + 1], x[mt][4 * i + 2],
                      x[mt][4 * i + 3]);
  named_sync(BAR_BLOCK, 2 * WG);
#pragma unroll
  for (int mt = 0; mt < NM; ++mt)
#pragma unroll
    for (int i = 0; i < V4; ++i) {
      const float4 v = other[(mt * V4 + i) * WG + t];
      float* e = &x[mt][4 * i];
      if (cw == 0) {
        e[0] += v.x, e[1] += v.y, e[2] += v.z, e[3] += v.w;
      } else {
        e[0] = v.x + e[0], e[1] = v.y + e[1];
        e[2] = v.z + e[2], e[3] = v.w + e[3];
      }
      if ((mt * V4 + i) % 2 == cw)
        sum[(mt * V4 + i) * WG + t] = make_float4(e[0], e[1], e[2], e[3]);
    }
  named_sync(BAR_BLOCK, 2 * WG);        // b written; the partials read
  if (cw == 0 && t == 0) signal_cluster(&ready[slot], C);
  wait_cluster(&ready[slot], (round >> 1) & 1);
  const uint32_t base = smem_addr(sum);
  for (int r = 0; r < C; ++r) {
    float4 v[NM][V4];
    if (r == rank) {
#pragma unroll
      for (int mt = 0; mt < NM; ++mt)
#pragma unroll
        for (int i = 0; i < V4; ++i) v[mt][i] = sum[(mt * V4 + i) * WG + t];
    } else {
      const uint32_t at = mapa(base, r);
#pragma unroll
      for (int mt = 0; mt < NM; ++mt)
#pragma unroll
        for (int i = 0; i < V4; ++i)
          v[mt][i] = ld_cluster(at + ((mt * V4 + i) * WG + t) * 16);
    }
#pragma unroll
    for (int mt = 0; mt < NM; ++mt)
#pragma unroll
      for (int i = 0; i < V4; ++i) {
        if (r == 0) {
          x[mt][4 * i] = v[mt][i].x, x[mt][4 * i + 1] = v[mt][i].y;
          x[mt][4 * i + 2] = v[mt][i].z, x[mt][4 * i + 3] = v[mt][i].w;
        } else {
          x[mt][4 * i] += v[mt][i].x, x[mt][4 * i + 1] += v[mt][i].y;
          x[mt][4 * i + 2] += v[mt][i].z, x[mt][4 * i + 3] += v[mt][i].w;
        }
      }
  }
}

// ---- the kernels ----------------------------------------------------------

struct Item {
  int r0;       // first resident row (query row, or key)
  int h;        // head of the resident operand: query head, or kv head
  int b;
};

// work item w (longest first): forward and dQ the last row blocks first,
// dK/dV the first key blocks first
template <int MODE>
__device__ __forceinline__ Item item_of(const Params& p, int w) {
  if (MODE == DKV) {
    const int heads = p.Hkv * p.B;
    return {w / heads * RA, w % p.Hkv, w % heads / p.Hkv};
  }
  const int heads = p.Hq * p.B, nq = (p.T + RA - 1) / RA;
  return {(nq - 1 - w / heads) * RA, w % p.Hq, w % heads / p.Hq};
}

// boxes of range rg that hold columns < d
__device__ __forceinline__ int range_boxes(const Params& p, int rg) {
  return (min(p.d - rg * DR, DR) + 63) / 64;
}

template <int MODE, int NP>
__device__ __forceinline__ void wide_body(const Params& p) {
  using K = Cfg<MODE, NP>;
  constexpr int N = K::N, STAGES = K::STAGES, NM = K::NM;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* const sa = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* const sb = sa + K::A;                       // dQ, dK/dV
  bf16* const sx = sa + (MODE == FWD ? 1 : 2) * K::A;   // [STAGES] x
  bf16* const sy = sx + STAGES * K::X;                 // [STAGES] y
  float* const xb = reinterpret_cast<float*>(sa + K::TILES);
  uint64_t* const bars = reinterpret_cast<uint64_t*>(xb + K::XB);
  uint64_t* const res_full = bars;
  uint64_t* const res_empty = bars + 1;
  uint64_t* const ready = bars + 2;           // [2]: the exchange's slots
  uint64_t* const full = bars + 4;
  uint64_t* const empty = full + STAGES;

  const int C = p.C;
  const int rank = cluster_rank();
  const int cid = (int)blockIdx.x / C;
  const int g = cid % p.NG;
  const Item e = item_of<MODE>(p, cid / p.NG);
  const int out_rg = g * C + rank;             // the range this block writes
  const bool has_out = out_rg < p.NR;
  const int nr = (p.NR - rank + C - 1) / C;    // ranges it sums over
  // steps of a tile: ranges rank, rank + C, ... in that order in every
  // column group, so that every group's blocks hold S with the same bits;
  // in the backward, where the output range is not the last of them, one
  // more step loads its tiles again (the products after the exchange
  // read them from the tile's last stage)
  const int ns = nr + (MODE != FWD && has_out && g != nr - 1 ? 1 : 0);
  auto range_at = [&](int j) { return j < nr ? rank + j * C : out_rg; };
  // tiles of the item: forward and dQ key tiles to the diagonal; dK/dV
  // (query head of the kv head, query tile from the diagonal)
  const int nqt = MODE == DKV ? (p.T + N - 1) / N - e.r0 / N : 0;
  const int ntiles = MODE == DKV ? p.G * nqt
                                 : (min(e.r0 + RA, p.T) + N - 1) / N;
  const int steps = ntiles * ns;
  const int kh = MODE == DKV ? e.h : e.h / p.G;

  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    mbar_init(res_empty, CONSUMER_WARPS);
    for (int i = 0; i < 2; ++i) mbar_init(&ready[i], C);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  cluster_sync();                              // every block's barriers set

  // the warpgroup, from lane 0: a value the compiler sees as the same in
  // every lane, so that no wgmma below sits in a path it takes for
  // divergent (which would serialize them)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / WG, 0);
  if (wg == 0) {                               // producer: one thread
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      // the boxes of range rg of rows r0.. (R a box) of head hh into dst
      auto load = [&](bf16* dst, const CUtensorMap* map, uint64_t* bar,
                      int R, int rg, int hh, int r0) {
        const int nb = range_boxes(p, rg);
#pragma unroll
        for (int pl = 0; pl < NP; ++pl)
          for (int bx = 0; bx < nb; ++bx)
            tma_load_4d(dst + (pl * 4 + bx) * R * 64, map, bar,
                        rg * DR + bx * 64, hh, r0, e.b + pl * p.B);
        return (uint32_t)(NP * nb * R * 128);
      };
      for (int s = 0; s < steps; ++s) {
        const int o = s / ns, j = s % ns, rg = range_at(j);
        const int ra = o * nr + j;             // the resident rows' load
        if (j < nr && (ra == 0 || nr > 1)) {
          mbar_wait(res_empty, ((nr > 1 ? ra : 0) & 1) ^ 1);
          const uint32_t nbytes = (uint32_t)(NP * range_boxes(p, rg) * RA
                                             * 128 * (MODE == FWD ? 1 : 2));
          mbar_expect(res_full, nbytes);
          load(sa, &p.a, res_full, RA, rg, e.h, e.r0);
          if (MODE != FWD) load(sb, &p.b, res_full, RA, rg, e.h, e.r0);
        }
        const int st = s % STAGES;
        mbar_wait(&empty[st], ((s / STAGES) & 1) ^ 1);
        // the tile's rows and head
        int hx = kh, rx = o * N;
        if constexpr (MODE == DKV) {
          hx = e.h * p.G + o / nqt;
          rx = (e.r0 / N + o % nqt) * N;
        }
        const bool with_y = MODE != FWD || (j == nr - 1 && has_out);
        const int nbx = range_boxes(p, rg);
        const int nby = MODE == FWD ? range_boxes(p, out_rg) : nbx;
        mbar_expect(&full[st], (uint32_t)(NP * N * 128
                                          * (nbx + (with_y ? nby : 0))));
        load(sx + st * K::X, &p.x, &full[st], N, rg, hx, rx);
        if (with_y)
          load(sy + st * K::X, &p.y, &full[st], N,
               MODE == FWD ? out_rg : rg, hx, rx);
      }
    }
  } else {
    regs_inc<CONSUMER_REGS>();
    const int cw = wg - 1;                     // columns 128 cw .. of a range
    const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
    const int row0 = 16 * warp + lane / 4;     // and row0 + 8, of the item
    const int nbo = has_out ? min(max(range_boxes(p, out_rg) - 2 * cw, 0), 2)
                            : 0;               // output boxes of this wg
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    float acc0[64], acc1[64];                  // O, dQ or dK; dV
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    // backward: lse log2(e) and di of the lane's two query rows (dQ)
    float lr[2] = {0.f, 0.f}, dr[2] = {0.f, 0.f};
    if (MODE == DQ)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = e.r0 + row0 + 8 * r;
        if (q < p.T) {
          const size_t i = ((size_t)e.b * p.Hq + e.h) * p.T + q;
          lr[r] = p.lse2[i];
          dr[r] = p.di[i];
        }
      }
    for (int o = 0; o < ntiles; ++o) {
      // tile o's partials over the block's ranges (nr steps), then summed
      // over the cluster
      float x[NM][N / 2];
      bool fresh = true;
      for (int j = 0; j < ns; ++j) {
        const int s = o * ns + j, rg = range_at(j), ra = o * nr + j;
        if (j < nr && (ra == 0 || nr > 1))
          mbar_wait(res_full, (nr > 1 ? ra : 0) & 1);
        const int st = s % STAGES;
        mbar_wait(&full[st], (s / STAGES) & 1);
        const int nb = min(max(range_boxes(p, rg) - 2 * cw, 0), 2);
        if (j < nr && nb > 0) {
          reg_fence(x[0]);
          if (NM == 2) reg_fence(x[NM - 1]);
          wgmma_fence();
          bool f0 = fresh;
          partial<N, NP>(x[0], sa, sx + st * K::X, 2 * cw, nb, f0);
          if constexpr (NM == 2) {
            bool f1 = fresh;
            partial<N, NP>(x[1], sb, sy + st * K::X, 2 * cw, nb, f1);
          }
          fresh = false;
          wgmma_commit();
          wgmma_wait<0>();
          reg_fence(x[0]);
          if (NM == 2) reg_fence(x[NM - 1]);
        }
        if (j < nr && nr > 1) release(res_empty);
        if (j < ns - 1) release(&empty[st]);
      }
      if (fresh)
#pragma unroll
        for (int mt = 0; mt < NM; ++mt)
#pragma unroll
          for (int i = 0; i < N / 2; ++i) x[mt][i] = 0.f;
      exchange<N, NM>(x, xb, ready, o, C, rank, cw, t);
      const int st = (o * ns + ns - 1) % STAGES;   // tile o's held stage
      if (nbo > 0) {
        uint32_t pa[NP][N / 16][4];
        if constexpr (MODE == FWD) {
          const int koff = o * N;
          const int row = e.r0 + row0 - koff;  // keys j > row are masked
          if (koff + N - 1 > e.r0)
            online_softmax<true, N>(x[0], p.scale_log2, row, lane, m, l,
                                    alpha);
          else
            online_softmax<false, N>(x[0], p.scale_log2, row, lane, m, l,
                                     alpha);
          to_pairs<NP, N>(x[0], pa);
#pragma unroll
          for (int i = 0; i < 64; ++i) acc0[i] *= alpha[(i >> 1) & 1];
          wgmma_fence();
          out_product<N, NP>(acc0, pa, sy + st * K::X, 2 * cw);
        } else if constexpr (MODE == DQ) {
          // dS = P (dP - di) / sqrt(D), P zero past the diagonal and T
#pragma unroll
          for (int i = 0; i < N / 2; ++i) {
            const int r = (i >> 1) & 1, q = e.r0 + row0 + 8 * r;
            const int key = o * N + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
            const float pr = key <= q && q < p.T
                ? exp2f(fmaf(x[0][i], p.scale_log2, -lr[r])) : 0.f;
            x[0][i] = pr * (x[1][i] - dr[r]) * p.scale;
          }
          to_pairs<NP, N>(x[0], pa);
          wgmma_fence();
          out_product<N, NP>(acc0, pa, sx + st * K::X, 2 * cw);
        } else {
          // P^T and dS^T: rows are keys, columns the tile's queries
          const int h = e.h * p.G + o / nqt;
          const int q0 = (e.r0 / N + o % nqt) * N;
          const size_t bh = ((size_t)e.b * p.Hq + h) * p.T;
          uint32_t da[NP][N / 16][4];
#pragma unroll
          for (int i = 0; i < N / 2; ++i) {
            const int r = (i >> 1) & 1, key = e.r0 + row0 + 8 * r;
            const int q = q0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
            float pr = 0.f, dd = 0.f;
            if (key <= q && q < p.T) {
              pr = exp2f(fmaf(x[0][i], p.scale_log2,
                              -__ldg(p.lse2 + bh + q)));
              dd = __ldg(p.di + bh + q);
            }
            x[1][i] = pr * (x[1][i] - dd) * p.scale;
            x[0][i] = pr;
          }
          to_pairs<NP, N>(x[0], pa);
          to_pairs<NP, N>(x[1], da);
          wgmma_fence();
          out_product<N, NP>(acc1, pa, sy + st * K::X, 2 * cw);   // dV
          out_product<N, NP>(acc0, da, sx + st * K::X, 2 * cw);   // dK
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(acc0);
        if (MODE == DKV) reg_fence(acc1);
      }
      release(&empty[st]);
    }

    // the output: rows < T, columns < d of this warpgroup's 128
    if (nbo > 0) {
      const int c0 = out_rg * DR + 128 * cw + 2 * (lane & 3);
      if (MODE == FWD)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = e.r0 + row0 + 8 * r;
        if (row >= p.T) continue;
        size_t at;
        float inv = 1.f;
        if (MODE == DKV) {
          at = e.b * p.kvsb + ((size_t)row * p.Hkv + e.h) * p.d;
        } else {
          at = (((size_t)e.b * p.T + row) * p.Hq + e.h) * p.d;
          if (MODE == FWD) inv = 1.f / l[r];
        }
        if (MODE == FWD && p.lse != nullptr && out_rg == 0 && cw == 0
            && (lane & 3) == 0)
          p.lse[((size_t)e.b * p.Hq + e.h) * p.T + row] =
              m[r] * LN2 + logf(l[r]);
#pragma unroll
        for (int jb = 0; jb < 16; ++jb)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = c0 + 8 * jb + c;
            if (col >= p.d) continue;
            const int i = 4 * jb + 2 * r + c;
            if constexpr (NP == 2) {
              static_cast<float*>(p.out0)[at + col] = acc0[i] * inv;
              if (MODE == DKV)
                static_cast<float*>(p.out1)[at + col] = acc1[i];
            } else {
              static_cast<bf16*>(p.out0)[at + col] =
                  __float2bfloat16_rn(acc0[i] * inv);
              if (MODE == DKV)
                static_cast<bf16*>(p.out1)[at + col] =
                    __float2bfloat16_rn(acc1[i]);
            }
          }
      }
    }
  }
  cluster_sync();            // no block leaves while another reads its smem
}

template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_wide_fwd_kernel(const __grid_constant__ Params p) {
  wide_body<FWD, NP>(p);
}

template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_wide_dq_kernel(const __grid_constant__ Params p) {
  wide_body<DQ, NP>(p);
}

template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_wide_dkv_kernel(const __grid_constant__ Params p) {
  wide_body<DKV, NP>(p);
}

// ---- the backward's di pass -----------------------------------------------

struct DiParams {
  const void* o;                        // [B, T, Hq, d], strides osb, ost
  const void* dout;                     // strides dsb, dst, heads dhs
  long long osb, ost, dsb, dst, dhs;
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
  const long long od = b * p.dsb + t * p.dst + (long long)h * p.dhs;
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

// ---- host side -------------------------------------------------------------

int plane_width(int d) { return (d + 63) / 64 * 64; }

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

// An operand [B, T, heads, w] as a map of boxes of `rows` rows: bf16 rows
// read in place (w, strides and start 16-byte aligned), or (planes) its
// hi and lo planes [2B, T, heads, w].
struct Operand {
  const void* x;
  long long sb, st;
  int heads;
};

bool map_of(CUtensorMap* map, const Operand& x, int w, int B, int T,
            bool planes, int rows) {
  if (planes)
    return tensor_map_planes(map, static_cast<const bf16*>(x.x), w, x.heads,
                             T, B, rows);
  return tensor_map_rows(map, x.x, w, x.heads, T, B, x.st, x.sb, rows);
}

// the ranges, the cluster and its groups of a head_dim d
void set_ranges(Params& p, int d) {
  p.d = d;
  p.NR = (d + DR - 1) / DR;
  p.C = p.NR < CMAX ? p.NR : CMAX;
  p.NG = (p.NR + p.C - 1) / p.C;
}

// one launch of kernel `kern` over `items` work items, a cluster of p.C
// blocks each per column group
template <int MODE, int NP>
int launch_clusters(void (*kern)(Params), const Params& p, long long items,
                    cudaStream_t stream) {
  const size_t smem = Cfg<MODE, NP>::BYTES + 1024;   // + the alignment
  const long long blocks = items * p.NG * p.C;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int NP>
int launch_fwd(Params& p, const Operand& q, const Operand& k,
               const Operand& v, int w, cudaStream_t stream) {
  constexpr int N = Cfg<FWD, NP>::N;
  if (!map_of(&p.a, q, w, p.B, p.T, NP == 2, RA)
      || !map_of(&p.x, k, w, p.B, p.T, NP == 2, N)
      || !map_of(&p.y, v, w, p.B, p.T, NP == 2, N))
    return (int)cudaErrorInvalidValue;
  p.b = p.a;
  const long long items = (long long)((p.T + RA - 1) / RA) * p.Hq * p.B;
  return launch_clusters<FWD, NP>(flash_wide_fwd_kernel<NP>, p, items,
                                  stream);
}

// the dQ kernel (p.out0: dQ), then the dK/dV kernel into dk and dv
template <int NP>
int launch_bwd(Params& p, void* dk, void* dv, const Operand& q,
               const Operand& k, const Operand& v, const Operand& dout,
               int w, cudaStream_t stream) {
  constexpr int N = Cfg<DQ, NP>::N;
  const bool pl = NP == 2;
  const long long nq = (p.T + RA - 1) / RA;
  if (!map_of(&p.a, q, w, p.B, p.T, pl, RA)
      || !map_of(&p.b, dout, w, p.B, p.T, pl, RA)
      || !map_of(&p.x, k, w, p.B, p.T, pl, N)
      || !map_of(&p.y, v, w, p.B, p.T, pl, N))
    return (int)cudaErrorInvalidValue;
  int err = launch_clusters<DQ, NP>(flash_wide_dq_kernel<NP>, p,
                                    nq * p.Hq * p.B, stream);
  if (err) return err;
  Params pk = p;
  pk.out0 = dk;
  pk.out1 = dv;
  if (!map_of(&pk.a, k, w, p.B, p.T, pl, RA)
      || !map_of(&pk.b, v, w, p.B, p.T, pl, RA)
      || !map_of(&pk.x, q, w, p.B, p.T, pl, N)
      || !map_of(&pk.y, dout, w, p.B, p.T, pl, N))
    return (int)cudaErrorInvalidValue;
  return launch_clusters<DKV, NP>(flash_wide_dkv_kernel<NP>, pk,
                                  nq * p.Hkv * p.B, stream);
}

// bf16 rows of w columns (a multiple of 8, zeros past d), float32 of d
bool shape_ok(int B, int T, int Hq, int Hkv, int w, int d, int f32) {
  return B >= 0 && T >= 0 && Hkv >= 1 && Hq >= Hkv && Hq % Hkv == 0
         && d > 256
         && (f32 ? w == d : w >= d && w % 8 == 0 && w <= plane_width(d));
}

}  // namespace

// flash_attn (flash_attn.cu) at head_dim d > 256: q [B, T, Hq, w], k/v
// [B, >=T, Hkv, w] with element strides (batch, token) given and heads
// and w contiguous; out [B, T, Hq, d] contiguous in the inputs' type; lse
// [B, Hq, T] f32 or null; scale 1/sqrt(d). f32 = 0: bf16 tensors read in
// place by TMA (w a multiple of 8 with zeros in columns d .. w, the
// strides multiples of 8 and the starts 16-byte aligned; the map's
// encoding failing returns cudaErrorInvalidValue); planes is not read.
// f32 = 1: float32 tensors, w = d; planes: bf16 scratch of 2 B T (Hq +
// 2 Hkv) W elements, W = d rounded up to a multiple of 64, for the split
// pass. Returns a cudaError_t.
extern "C" int flash_attn_wide(const void* q, const void* k, const void* v,
                               void* out, float* lse, long long qsb,
                               long long qst, long long ksb, long long kst,
                               long long vsb, long long vst, int B, int T,
                               int Hq, int Hkv, int w, int d, int f32,
                               float scale, void* planes, void* stream) {
  if (!shape_ok(B, T, Hq, Hkv, w, d, f32) || (f32 && planes == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  Params p = {};
  p.out0 = out;
  p.lse = lse;
  p.B = B;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  set_ranges(p, d);
  if (!f32)
    return launch_fwd<1>(p, {q, qsb, qst, Hq}, {k, ksb, kst, Hkv},
                         {v, vsb, vst, Hkv}, w, st);
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
  return launch_fwd<2>(p, {qp, 0, 0, Hq}, {kp, 0, 0, Hkv}, {vp, 0, 0, Hkv},
                       W, st);
}

// flash_attn_bwd (flash_attn_bwd.cu) at head_dim d > 256: q, k, v and
// dout as flash_attn_wide takes q, k and v (bf16 at width w, zeros past
// d), o [B, T, Hq, d] at its strides; lse [B, Hq, T] f32; dq [B, T, Hq,
// d] contiguous; dk, dv [B, S, Hkv, d] contiguous with batch stride kvsb
// = S Hkv d (rows < T written); ws: f32 scratch of 2 B Hq T floats (lse
// log2(e) and di); planes (f32 = 1, w = d): bf16 scratch of 2 B T (2 Hq +
// 2 Hkv) W elements, W = d rounded up to a multiple of 64. Launches the
// di pass, the split pass (float32), the dQ kernel, then the dK/dV
// kernel. Returns a cudaError_t.
extern "C" int flash_attn_bwd_wide(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* planes, void* dq, void* dk,
    void* dv, float* ws, long long qsb, long long qst, long long ksb,
    long long kst, long long vsb, long long vst, long long osb,
    long long ost, long long dsb, long long dst, long long kvsb, int B,
    int T, int Hq, int Hkv, int w, int d, int f32, float scale,
    void* stream) {
  if (!shape_ok(B, T, Hq, Hkv, w, d, f32) || ws == nullptr
      || (f32 && planes == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)B * Hq * T;
  DiParams dp{o, dout, osb, ost, dsb, dst, w, lse, ws, ws + rows, B, T, Hq,
              d, f32};
  const long long dblocks = (rows * 32 + 255) / 256;
  if (dblocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  flash_wide_di_kernel<<<(unsigned)dblocks, 256, 0, st>>>(dp);
  int err = (int)cudaGetLastError();
  if (err) return err;
  Params p = {};
  p.out0 = dq;
  p.lse2 = ws;
  p.di = ws + rows;
  p.kvsb = kvsb;
  p.B = B;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  set_ranges(p, d);
  if (!f32)
    return launch_bwd<1>(p, dk, dv, {q, qsb, qst, Hq}, {k, ksb, kst, Hkv},
                         {v, vsb, vst, Hkv}, {dout, dsb, dst, Hq}, w, st);
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
  return launch_bwd<2>(p, dk, dv, {qp, 0, 0, Hq}, {kp, 0, 0, Hkv},
                       {vp, 0, 0, Hkv}, {dp2, 0, 0, Hq}, W, st);
}
