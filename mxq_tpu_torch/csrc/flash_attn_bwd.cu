// K13-bwd: the backward of K13 (flash_attn.cu), causal self-attention from
// position 0. q [B, T, Hq, D] attended k, v [B, >=T, Hkv, D] (query row i
// saw keys j <= i), query head h reading kv head h / G (G = Hq / Hkv),
// scale 1/sqrt(D). Given K13's output o and row log-sum-exp lse and the
// output's gradient dO, it writes dQ [B, T, Hq, D] and dK, dV
// [B, S, Hkv, D] (rows < T; the wrapper zeroes rows >= T).
//
// Replaces the upstream Pallas TPU kernels of flash attention's VJP
// (jax/experimental/pallas/ops/tpu/flash_attention.py
// _flash_attention_bwd, :254-318), which mxq_tpu reaches when QAT
// differentiates mxq_tpu/models/llama.py attention's use_flash
// (:383-396): the dK/dV kernel (_flash_attention_bwd_dkv, pallas_call
// :1121, body :796-939) and the dQ kernel (_flash_attention_bwd_dq,
// pallas_call :1456, body :1146-1285). Upstream computes di = rowsum(o .
// dO) in jnp (:270-273). Per block of query rows and block of keys:
//   s  = (q . k^T) * scale, causal mask    p  = exp(s - lse)
//   dV = p^T . dO     (p in dO's type)     dP = dO . v^T
//   dS = (dP - di) * p * scale
//   dK = dS^T . q,  dQ = dS . k            (dS in the input type)
// every product accumulated in f32, the results written in the input
// type. With GQA the kernels sum dK and dV over the G query heads of a kv
// head; JAX repeats k and v before the call and its autograd sums the
// repeats, in another order.
//
// Bound on the H100: operations. Five products over the causal half (S
// and dP recomputed, dV, dK, dQ), 10 * B * Hq * D * T(T+1)/2: at T = 2048
// and 32 heads of 128 86 GFLOP a layer, 0.0869 ms at 989 TFLOP/s; the
// bytes (q, k, v, o, dO read once, dQ, dK, dV written) are 134 MB at
// bf16, 0.040 ms at 3.35 TB/s. Both designs below recompute S and dP in
// each of their two kernels: 7 products, 14 * B * Hq * D * T(T+1)/2, so
// their own floor is 0.122 ms there.
//
// bf16 (dq_wgmma_kernel, dkv_wgmma_kernel: FlashAttention-3's backward,
// kept deterministic). Only wgmma reaches the tensor cores' rate, and only
// with operands in shared memory that the multiplying threads spend no
// instructions copying. Each kernel is one persistent block of three
// warpgroups an SM walking work items longest first, in a snake (as
// K13's flash_wgmma_kernel): warpgroup 0 the producer (setmaxnreg gives
// its registers away; one thread starts every copy, by TMA through 4-D
// tensor maps over (D, heads, tokens, batch) on the strides the wrapper
// passes, tokens >= T filled with zeros), warpgroups 1 and 2 consumers of
// 64 rows each. Tiles lie in shared memory as TMA's 128-byte swizzle
// leaves them, the layout wgmma's descriptors name; a ring of stages with
// full and empty mbarriers runs ahead of the products.
// - dQ kernel: an item is 128 query rows of one (query head, batch row).
//   Q, dO and o come once an item. di = rowsum(o . dO) is computed in f32
//   from the o and dO tiles in shared memory (no PyTorch reduction), and
//   the kernel writes di and lse log2(e) into [B, Hq, Tp] f32 scratch
//   (Tp = T rounded up to 128; rows >= T get di 0 and lse +inf, so that
//   their p is 0) for the dK/dV kernel. K and V come in 64-key tiles up
//   to the diagonal. Per tile: S = Q K^T and dP = dO V^T, wgmma with both
//   operands in shared memory (m64n64k16); P = 2^(S scale log2(e) - lse
//   log2(e)), masked only on the diagonal tile; dS = (dP - di) P scale
//   rounded to bf16 pairs, which are wgmma's register-A operand of dQ +=
//   dS K (K read through the descriptor's transpose). dQ's product runs
//   under the next tile's S and dP; a warpgroup skips the tiles past its
//   rows (the second 64 keys of the diagonal block for the first 64
//   rows). 64-key tiles keep S, dP, dQ and dS in 160 registers of the
//   232 a consumer thread has; 128-key tiles would need 224 and spill.
// - dK/dV kernel: an item is 128 keys of one kv head (64 a consumer
//   warpgroup), K and V loaded once. Q, dO, lse and di come in 64-row
//   query tiles from the diagonal on, for each query head of the item's
//   heads. Per tile, keys as rows: S^T = K Q^T and dP^T = V dO^T (SS),
//   P^T and dS^T in registers, one pass that rounds each pair to bf16 as
//   it goes, then dV += P^T dO and dK += dS^T Q (RS, dO and Q read
//   transposed). dK and dV stay in registers for the whole item, 128
//   floats a thread at D = 128.
// - GQA: when (key tiles x kv heads x batch) items are fewer than the
//   SMs (G = 8, T = 512: 32 items), each kv head's G query heads are
//   split over S blocks (the largest divisor of G that keeps the items
//   in one wave: S = 4 there). Each block writes f32 partial dK and dV;
//   the last of the S blocks of a (key tile, kv head, batch row), found
//   by a ticket, sums the partials in split order and writes dK and dV.
// No atomics on a gradient and a fixed order of every sum: the same bits
// on every call.
// Shared memory at D = 128: dQ kernel 192 KB (Q, dO, o of 128 rows; three
// stages of K and V tiles of 64 keys), dK/dV kernel 194 KB (K, V of 128
// keys; four stages of Q and dO tiles of 64 rows, lse and di).
//
// float32 inputs (the float32 model, QAT's default) run the same two
// kernels (F32 = true) on bf16 hi and lo planes (flash_split.cuh): one
// launch of bwd_split_kernel first writes q's, k's, v's and dO's planes
// [2B, T, H, W] (zeros past the true head_dim D, so no padded copy is
// made) and, from the f32 o and dO, di = rowsum(o . dO) and lse log2(e)
// into the scratch the dK/dV kernel reads (the dQ kernel then reads them
// too, and loads no o). Every product is three wgmma (hi.lo + lo.hi +
// hi.hi, the small terms first), P^T and dS^T (dS) split into hi and lo
// pairs in registers, the gradients written in f32. Every plane doubles
// the tiles, so the ring's tiles are 32 rows: the dQ kernel holds Q and dO
// hi and lo of 128 rows (128 KB) and three stages of 32-key K and V tiles
// (96 KB): 224 KB; the dK/dV kernel K and V hi and lo of 128 keys (128
// KB) and three stages of 32-row Q and dO tiles with their lse and di
// (97 KB): 225 KB. Consumer registers at D = 128: dQ 64, S, dP 16 each,
// dS's pairs 16; dK, dV 128, S^T, dP^T 16 each, P^T's and dS^T's pairs 32.
// The design's floor is three times the bf16 design's (0.366 ms at T =
// 2048, 32 heads of 128) plus the split pass's bytes (q, k, v and dO
// split, o read: about 0.09 ms there).
//
// A head_dim D that is not a template width runs at the next one, W, with
// zeros past D in every tile, reading its rows in place (no padded copy)
// and writing dQ, dK and dV D columns wide (NARROW):
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
//   232, as with TMA); cp.async costs more than TMA (PERF.md), the price
//   of rows TMA cannot address; di = rowsum(o . dO) sums the zeros too;
// - float32: the split pass writes the planes W wide, zeros past D.
// An odd D, or a view whose rows start off 4 bytes, reaches the kernels
// on zero-padded copies at W (ops/attn_bf16.py load_route).
//
// head_dim 256 (D in 129..256 runs at it): dK and dV of 64 keys at D =
// 256 are 256 floats a thread, past a consumer's 232 registers, and Q, dO
// and o of 128 rows alone fill shared memory. So items are 64 rows (IM =
// 64), and the two consumer warpgroups of a block share an item's 64 rows
// (wgmma's M) and split the columns of every product over D.
// float32 (dq_wgmma_kernel, dkv_wgmma_kernel at F32):
// - the dQ kernel runs one consumer warpgroup (two warpgroups a block, no
//   register handover: each thread may hold 255), dQ 128 registers, K and
//   V in 16-key tiles through two stages (Q and dO hi and lo 128 KB, the
//   ring 64 KB);
// - the dK/dV kernel's two consumers each compute S^T and dP^T over all
//   of D (both of them: the products that D's halves do not split) and
//   hold dK and dV of their 128 columns (64 registers each); Q and dO in
//   16-row tiles through two stages (K, V hi and lo 128 KB, the ring 64
//   KB).
// bf16 (dq_d256_kernel, dkv_d256_kernel): no product is made twice. Every
// tile is 64 rows (keys of the dQ kernel's ring, query rows of the dK/dV
// kernel's), two stages. The consumers split the tile's 64 rows for S and
// dP and D's columns for the products over D:
// - consumer c computes S (dK/dV: S^T) and dP (dP^T) for rows 32 c .. 32 c
//   + 31 of the tile over all of D (m64n32k16, B at line 32 c of the
//   tile), then P and dS (P^T and dS^T) for them in f32 and their bf16
//   pairs, where upstream rounds them. A consumer's pairs for its 32 rows
//   are the k16 slices 2 c and 2 c + 1 of the A operand over the tile's
//   64 rows, in the very registers the other consumer would hold them in
//   (both take the item's same 64 rows as wgmma's M: thread t of each
//   holds the same elements). So each writes its pairs to shared memory
//   (16-byte stores, thread-major, a double buffer by tile parity), the
//   two meet at a named barrier, and each reads the four slices back
//   (its own too: fewer live registers than keeping them): slices 0 and
//   1 are consumer 0's, 2 and 3 consumer 1's, summed in that order by
//   both;
// - consumer c then adds its 128 columns (128 c ..) of dQ += dS K (dK/dV:
//   dV += P^T dO, dK += dS^T Q) over the tile's 64 rows, wgmma RS, the
//   tile read transposed; it holds dQ (dK and dV) of those columns, 64
//   (128) registers.
//   Of the two ways to share the products (each consumer S and dP over
//   half of D, the halves summed in f32; or one consumer S, the other
//   dP), this is the second's exchange of bf16 P^T and dS^T, with the
//   tile's rows split instead of the two products: dS needs P, so a
//   consumer making S alone would hold the other up for every tile, and
//   the f32 halves of S and dP would be 32 KB a tile through shared
//   memory where the bf16 pairs are 16 KB.
// - The dQ kernel's ring brings each item's o tile first, into a K slot:
//   both consumers compute di = rowsum(o . dO) of the item's rows from it
//   (the first writes di and lse log2(e) to the scratch) and free the
//   stage. Shared memory: Q, dO 64 KB, the ring 128 KB, the exchange 16
//   KB; registers: dQ 64, S and dP 16 each, the pairs 24.
// - The dK/dV kernel: K, V 64 KB, the ring 128 KB with lse and di, the
//   exchange 32 KB (with the barriers, the ticket's flag and the
//   alignment 231,480 bytes of the 232,448 a block may have); registers:
//   dK, dV 128, S^T and dP^T 16 each, the pairs 48. Registers by
//   setmaxnreg: with TMA the producer keeps 24 and the consumers 240,
//   with cp.async 56 and 224 (ptxas spilled 4-36 bytes at 40 and 232).
// - A stage is freed as soon as the last tile's products over it are
//   done (wgmma_wait<2> after the next tile's S and dP are issued), so the
//   producer's next copies start under that tile's S. What holds these
//   two kernels on the H100 is the tiles' copies from L2, not the
//   products: each 64-row tile (64 KB of Q and dO, or K and V) serves 2 x
//   64 x 64 x 256 products of S and dP and one of dV and dK (dQ), so at
//   T = 2048 the dK/dV kernel moves 270 MB through L2 for 34 GFLOP; copies
//   of the kernel without the dV and dK products ran 7% faster, without
//   dP^T 10%, without the exchange's barrier no faster (PERF.md).
// - dK/dV items of equal work. The item of key tile kt walks (nq - kt)
//   query tiles a query head: at Gemma-2B's widths (T = 2048, 8 query
//   heads over one kv head) key tile 0's item carries 32 times key tile
//   31's. So an item may take a unit of two key tiles, kt and nq - 1 - kt
//   (nq + 1 query tiles a head; the middle tile alone when nq is odd), one
//   after the other (each its own K and V, dK and dV); and each kv head's
//   G query heads may be split over S blocks. scratch_of picks pairing
//   and S from the item lengths: the least of max(longest item, all tiles
//   over the blocks), S > 1 only where the items fit one wave (a second
//   wave would add its partials' traffic to the imbalance). Gemma-2B at
//   T = 2048: 16 units x 8 splits, 128 items of 33 query tiles each
//   (unpaired: 64 at most; the parent's design 2 x 64 of 32 rows).
// - Split heads, as dkv_wgmma_kernel: each block writes its f32 partial
//   dK and dV of a key tile (8 splits there: 2 x 8 x 2048 x 256 floats,
//   33.5 MB) and takes a ticket; the last of the S blocks sums the tile's
//   partials in split order, writes dK and dV, and sets the ticket back
//   to 0. No block waits on another, so any residency is safe.
// Every sum keeps its fixed order, so the bits are the same on every call.

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

constexpr int WG = 128;                 // threads of a warpgroup
constexpr int WS_THREADS = 3 * WG;      // producer + two consumers
// the producer's loops over items, heads and tiles spill at 24 registers
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int CONSUMER_WARPS = 8;       // arrivals that empty a stage
constexpr int BAR_CONSUMERS = 1;        // named barrier of the consumers
constexpr int BAR_PRODUCER = 2;         // a cp.async producer's threads

// rows of an item at head_dim template D: query rows (dQ kernel) or keys
// (dK/dV kernel)
constexpr int item_rows(int D) { return D > 128 ? 64 : 128; }

// The tiles of each path: planes (hi, and lo for float32), rows of an
// item, rows of a ring tile (keys of the dQ kernel, query rows of the
// dK/dV kernel), stages; the dQ kernel's consumer warpgroups (64 rows
// each, or at bf16 D = 256 two on the same 64); the columns of dK and dV
// a dK/dV consumer holds (at D = 256, WIDE, half of them). D256: the bf16
// kernels of D = 256 (dq_d256_kernel, dkv_d256_kernel)
template <int D, bool F32>
struct Tiles {
  static constexpr bool WIDE = D > 128;
  static constexpr bool D256 = WIDE && !F32;
  static constexpr int NP = F32 ? 2 : 1;
  static constexpr int IM = item_rows(D);
  static constexpr int TN = WIDE ? (F32 ? 16 : 64) : (F32 ? 32 : 64);
  static constexpr int DQ_STAGES = WIDE ? 2 : 3;
  static constexpr int DKV_STAGES = WIDE ? 2 : (F32 ? 3 : 4);
  static constexpr int DQ_WGS = D256 ? 2 : IM / 64;
  static constexpr int DQ_THREADS = (1 + DQ_WGS) * WG;
  static constexpr int DA = WIDE ? D / 2 : D;
};

// rows a consumer of the D = 256 bf16 kernels takes of a tile's 64 for S
// and dP; those kernels' registers a producer and a consumer thread
// (setmaxnreg moves whole blocks: 128 P + 256 C = 384 x 168): with TMA
// one producer thread issues the copies (24), a cp.async producer's
// threads compute addresses (56). ptxas spilled 4-36 bytes at 40 and 232.
constexpr int HALF = 32;
template <bool CPA>
constexpr int D256_PRODUCER_REGS = CPA ? 56 : 24;
template <bool CPA>
constexpr int D256_CONSUMER_REGS = CPA ? 224 : 240;

struct DqParams {
  CUtensorMap q, dout, o;               // 4-D (d, heads, T, B), IM-row boxes
  CUtensorMap k, v;                     // TN-row boxes
  Rows qr, dor, orw, kr, vr;            // or bf16 rows read by cp.async
  const float* lse;                     // [B, Hq, T]
  float* lse2;                          // [B, Hq, Tp]: lse log2(e); +inf
  float* di;                            // and 0 at rows >= T
  void* dq;                             // [B, T, Hq, d] contiguous
  int nq, B, T, Tp, Hq, Hkv;            // nq = Tp / IM = ceil(T / IM)
  int d, gran;                          // head_dim, cp.async bytes
  float scale, scale_log2;
};

struct DkvParams {
  CUtensorMap k, v;                     // IM-row boxes
  CUtensorMap q, dout;                  // TN-row boxes
  Rows kr, vr, qr, dor;                 // or bf16 rows read by cp.async
  const float* lse2;                    // [B, Hq, Tp]
  const float* di;
  float* part;                          // [2][S][B][Hkv][Tp][D] when S > 1
  int* tickets;                         // [nq][Hkv][B] when S > 1
  void* dk;                             // [B, S rows, Hkv, d]
  void* dv;
  long long kvsb;                       // their batch stride
  int nq, B, T, Tp, Hq, Hkv, splits;
  int pairs;                            // D = 256 bf16: items of two key
                                        // tiles (scratch_of)
  int d, gran;                          // head_dim, cp.async bytes
  float scale, scale_log2;
};

// every tile 1024-byte aligned (each a multiple of 1024 bytes); o last,
// a placeholder at float32, which loads none
template <int D, bool F32>
struct DqSmem {
  using C = Tiles<D, F32>;
  __nv_bfloat16 q[C::NP * C::IM * D], dout[C::NP * C::IM * D];
  __nv_bfloat16 k[C::DQ_STAGES][C::NP * C::TN * D];
  __nv_bfloat16 v[C::DQ_STAGES][C::NP * C::TN * D];
  __nv_bfloat16 o[F32 ? 8 : C::IM * D];
  uint64_t q_full, q_empty, kv_full[C::DQ_STAGES], kv_empty[C::DQ_STAGES];
};

template <int D, bool F32>
struct DkvSmem {
  using C = Tiles<D, F32>;
  __nv_bfloat16 k[C::NP * C::IM * D], v[C::NP * C::IM * D];
  __nv_bfloat16 q[C::DKV_STAGES][C::NP * C::TN * D];
  __nv_bfloat16 dout[C::DKV_STAGES][C::NP * C::TN * D];
  float lse2[C::DKV_STAGES][C::TN], di[C::DKV_STAGES][C::TN];
  uint64_t kv_full, kv_empty, full[C::DKV_STAGES], empty[C::DKV_STAGES];
  int last;                             // this block sums the partials
};

// The D = 256 bf16 kernels' shared memory: tiles of 64 rows, two stages,
// and the consumers' bf16 pairs exchanged through x[tile parity][consumer]
// [slice][thread] (dQ: dS's two k16 slices; dK/dV: P^T's, then dS^T's)
struct Dq256Smem {
  using C = Tiles<256, false>;
  __nv_bfloat16 q[C::IM * 256], dout[C::IM * 256];
  __nv_bfloat16 k[C::DQ_STAGES][C::TN * 256];   // an item's o, then K
  __nv_bfloat16 v[C::DQ_STAGES][C::TN * 256];
  uint4 x[2][2][2][WG];
  uint64_t q_full, q_empty, kv_full[C::DQ_STAGES], kv_empty[C::DQ_STAGES];
};

struct Dkv256Smem {
  using C = Tiles<256, false>;
  __nv_bfloat16 k[C::IM * 256], v[C::IM * 256];
  __nv_bfloat16 q[C::DKV_STAGES][C::TN * 256];
  __nv_bfloat16 dout[C::DKV_STAGES][C::TN * 256];
  float lse2[C::DKV_STAGES][C::TN], di[C::DKV_STAGES][C::TN];
  uint4 x[2][2][4][WG];
  uint64_t kv_full, kv_empty, full[C::DKV_STAGES], empty[C::DKV_STAGES];
  int last;                             // this block sums a split tile
};

// Work item j of this block: items j G + i and j G + G - 1 - i in turn (G
// blocks, i its index), a snake over items ordered longest first
__device__ __forceinline__ int item_index(int j) {
  const int g = gridDim.x, i = blockIdx.x;
  return j * g + ((j & 1) ? g - 1 - i : i);
}

// one tile's NP planes through TMA: plane pl of batch row b is the map's
// batch row b + pl B
template <int D, int NP, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int h, int row,
                                          int b, int B) {
#pragma unroll
  for (int pl = 0; pl < NP; ++pl)
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      tma_load_4d(dst + (pl * (D / 64) + c) * ROWS * 64, map, bar, c * 64, h,
                  row, b + pl * B);
}

// this lane's element i of a 64 x N accumulator: row 16 warp + lane / 4
// + 8 ((i >> 1) & 1), column acc_col(i, lane)
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// the lane's two rows of a [64 x D] accumulator, rows < nrows, to dst +
// row * rstride in OutT; NARROW: only columns < ncols
template <int D, bool NARROW, typename OutT>
__device__ __forceinline__ void store_acc(OutT* dst, long long rstride,
                                          int row0, int nrows, int ncols,
                                          const float (&acc)[D / 2],
                                          int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= nrows) continue;
    if constexpr (NARROW) {
      OutT* out = dst + row * rstride;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int col = 8 * i + 2 * (lane & 3);
        store_cols(out + col, col, ncols, acc[4 * i + 2 * r],
                   acc[4 * i + 2 * r + 1]);
      }
    } else {
      OutT* out = dst + row * rstride + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        store2(out + 8 * i, acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
    }
  }
}


// key tiles of a dQ item (query rows qt IM ..): keys < min((qt + 1) IM, T)
template <int IM, int TN>
__device__ __forceinline__ int dq_key_tiles(int qt, int T) {
  return (min((qt + 1) * IM, T) + TN - 1) / TN;
}

// CPA: the producer warpgroup copies bf16 rows by cp.async (else one
// thread by TMA); NARROW: dQ is d < D columns wide (else the template's
// own code, d = D)
template <int D, bool F32, bool CPA, bool NARROW>
__global__ void __launch_bounds__(Tiles<D, F32>::DQ_THREADS, 1)
    dq_wgmma_kernel(const __grid_constant__ DqParams p) {
  using C = Tiles<D, F32>;
  using OutT = typename std::conditional<F32, float, __nv_bfloat16>::type;
  constexpr int NP = C::NP, TN = C::TN, STAGES = C::DQ_STAGES, IM = C::IM;
  // a full barrier's arrivals: TMA's one expect, or each producer thread's
  // cp.async arrival
  constexpr int FULL_ARRIVALS = CPA ? CP_THREADS : 1;
  // arrivals that empty a stage: the consumers' warps
  constexpr int EMPTY_ARRIVALS = 4 * C::DQ_WGS;
  constexpr uint32_t ROWS_BYTES = NP * IM * D * 2, TILE_BYTES = NP * TN * D * 2;
  extern __shared__ __align__(1024) unsigned char dq_smem[];
  DqSmem<D, F32>& sm = *reinterpret_cast<DqSmem<D, F32>*>(
      (reinterpret_cast<uintptr_t>(dq_smem) + 1023) & ~uintptr_t(1023));
  const int heads = p.B * p.Hq;
  const int items = p.nq * heads;
  const int wg = threadIdx.x / WG;
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, FULL_ARRIVALS);
    mbar_init(&sm.q_empty, EMPTY_ARRIVALS);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&sm.kv_full[st], FULL_ARRIVALS);
      mbar_init(&sm.kv_empty[st], EMPTY_ARRIVALS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {                        // producer
    if constexpr (C::DQ_WGS > 1) regs_dec<PRODUCER_REGS>();
    if constexpr (CPA) {                // every thread copies by cp.async
      const int t = threadIdx.x;
      int it = 0;
      for (int j = 0, w; (w = item_index(j)) < items; ++j) {
        const int qt = p.nq - 1 - w / heads, h = w % p.Hq;
        const int b = w % heads / p.Hq, hk = h / (p.Hq / p.Hkv);
        producer_wait(&sm.q_empty, (j & 1) ^ 1, t, BAR_PRODUCER);
        cp_rows<D, IM>(sm.q, p.qr, p.d, p.T, p.gran, h, qt * IM, b, t);
        cp_rows<D, IM>(sm.dout, p.dor, p.d, p.T, p.gran, h, qt * IM, b, t);
        cp_rows<D, IM>(sm.o, p.orw, p.d, p.T, p.gran, h, qt * IM, b, t);
        cp_async_arrive_noinc(&sm.q_full);
        const int nkt = dq_key_tiles<IM, TN>(qt, p.T);
        for (int kt = 0; kt < nkt; ++kt, ++it) {
          const int st = it % STAGES;
          producer_wait(&sm.kv_empty[st], ((it / STAGES) & 1) ^ 1, t,
                        BAR_PRODUCER);
          cp_rows<D, TN>(sm.k[st], p.kr, p.d, p.T, p.gran, hk, kt * TN, b,
                         t);
          cp_rows<D, TN>(sm.v[st], p.vr, p.d, p.T, p.gran, hk, kt * TN, b,
                         t);
          cp_async_arrive_noinc(&sm.kv_full[st]);
        }
      }
    } else if (threadIdx.x == 0) {      // one thread starts TMA
      int it = 0;                       // tiles loaded: the ring's position
      for (int j = 0, w; (w = item_index(j)) < items; ++j) {
        const int qt = p.nq - 1 - w / heads, h = w % p.Hq;
        const int b = w % heads / p.Hq, hk = h / (p.Hq / p.Hkv);
        mbar_wait(&sm.q_empty, (j & 1) ^ 1);   // the last item done
        mbar_expect(&sm.q_full, (F32 ? 2 : 3) * ROWS_BYTES);
        load_tile<D, NP, IM>(sm.q, &p.q, &sm.q_full, h, qt * IM, b, p.B);
        load_tile<D, NP, IM>(sm.dout, &p.dout, &sm.q_full, h, qt * IM, b,
                             p.B);
        if constexpr (!F32)
          load_tile<D, 1, IM>(sm.o, &p.o, &sm.q_full, h, qt * IM, b, p.B);
        const int nkt = dq_key_tiles<IM, TN>(qt, p.T);
        for (int kt = 0; kt < nkt; ++kt, ++it) {
          const int st = it % STAGES;
          mbar_wait(&sm.kv_empty[st], ((it / STAGES) & 1) ^ 1);
          mbar_expect(&sm.kv_full[st], 2 * TILE_BYTES);
          load_tile<D, NP, TN>(sm.k[st], &p.k, &sm.kv_full[st], hk, kt * TN,
                               b, p.B);
          load_tile<D, NP, TN>(sm.v[st], &p.v, &sm.kv_full[st], hk, kt * TN,
                               b, p.B);
        }
      }
    }
    return;
  }

  if constexpr (C::DQ_WGS > 1) regs_inc<CONSUMER_REGS>();
  const int cw = wg - 1;                // rows 64 cw .. 64 cw + 63
  const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
  const int row0 = 64 * cw + 16 * warp + lane / 4;    // and row0 + 8
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  float dq[D / 2], s[TN / 2], dp[TN / 2];
  uint32_t ds[NP][TN / 16][4];
  int it = 0;                           // tiles consumed: the ring's position
  for (int j = 0, w; (w = item_index(j)) < items; ++j) {
    const int qt = p.nq - 1 - w / heads, h = w % p.Hq;
    const int b = w % heads / p.Hq;
    const int nkt = dq_key_tiles<IM, TN>(qt, p.T);
    // the key tile that holds this warpgroup's first row (qt IM + 64 cw)
    // and the tiles that reach its rows (the first warpgroup skips the
    // item's last 64 keys)
    const int diag = qt * (IM / TN) + cw * (64 / TN);
    const int mine = min(diag + 64 / TN, nkt);
    const long long rows = ((long long)b * p.Hq + h);
    wait_tile<CPA>(&sm.q_full, j & 1);

    // di = rowsum(o . dO) and lse in base 2 of the lane's two rows: at
    // float32 the split pass wrote them; at bf16 from the o and dO tiles
    // (a quad's four lanes split D), into the scratch
    float di[2], lse2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = row0 + 8 * r, row = qt * IM + rr;
      if constexpr (F32) {
        di[r] = p.di[rows * p.Tp + row];
        lse2[r] = p.lse2[rows * p.Tp + row];
      } else {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          const int at = tile_at<IM>(rr, 8 * i + 2 * (lane & 3));
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sm.o + at));
          const float2 y = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sm.dout + at));
          acc = fmaf(x.x, y.x, acc);
          acc = fmaf(x.y, y.y, acc);
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        di[r] = row < p.T ? acc : 0.f;
        lse2[r] = row < p.T ? p.lse[rows * p.T + row] * LOG2E : INFINITY;
        if ((lane & 3) == 0) {
          p.lse2[rows * p.Tp + row] = lse2[r];
          p.di[rows * p.Tp + row] = di[r];
        }
      }
    }

#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    int pending = -1;                   // the stage dQ's product still reads
    for (int kt = 0; kt < nkt; ++kt, ++it) {
      const int st = it % STAGES;
      wait_tile<CPA>(&sm.kv_full[st], (it / STAGES) & 1);
      if (kt >= mine) {                 // all keys past this warpgroup's rows
        release(&sm.kv_empty[st]);
        continue;
      }
      reg_fence(s);
      reg_fence(dp);
      wgmma_fence();
      gemm_abt<D, IM, TN, NP>(s, sm.q, 64 * cw, sm.k[st]);
      wgmma_commit();
      gemm_abt<D, IM, TN, NP>(dp, sm.dout, 64 * cw, sm.v[st]);
      wgmma_commit();
      wgmma_wait<1>();                  // the last tile's dQ and S done
      reg_fence(s);
      reg_fence(dq);
      if (pending >= 0) release(&sm.kv_empty[pending]);
      // P = 2^(S scale log2(e) - lse log2(e)), masked where the key
      // follows the row (the 64 / TN tiles from the diagonal one), under
      // dP's product
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = ex2(fmaf(s[i], p.scale_log2, -lse2[r]));
        if (kt >= diag && kt * TN + acc_col(i, lane) > qt * IM + row0 + 8 * r)
          s[i] = 0.f;
      }
      wgmma_wait<0>();
      reg_fence(dp);
      if (kt == mine - 1) release(&sm.q_empty);   // Q, dO, o read for good
      // dS = (dP - di) P scale, as bf16 pairs (hi and lo at float32)
#pragma unroll
      for (int i = 0; i < TN / 2; ++i)
        dp[i] = (dp[i] - di[(i >> 1) & 1]) * s[i] * p.scale;
      to_pairs<NP, TN>(dp, ds);
      wgmma_fence();
      gemm_xb<D, TN, NP>(dq, ds, sm.k[st]);  // dQ += dS K, under the next
      wgmma_commit();                        // S and dP
      pending = st;
    }
    wgmma_wait<0>();
    reg_fence(dq);
    if (pending >= 0) release(&sm.kv_empty[pending]);
    const int dw = NARROW ? p.d : D;   // dQ's width
    store_acc<D, NARROW>(static_cast<OutT*>(p.dq)
                         + (((long long)b * p.T + qt * IM) * p.Hq + h) * dw,
                         (long long)p.Hq * dw, row0, p.T - qt * IM, dw, dq,
                         lane);
  }
}

// Work item w of the dK/dV kernel, longest first: key tile kt (keys kt IM
// ..) of kv head hk, batch row b, split s of its query heads
struct KvItem {
  int kt, hk, b, s;
};

__device__ __forceinline__ KvItem kv_item(const DkvParams& p, int w) {
  const int per = p.Hkv * p.B * p.splits;
  const int r = w % per;
  return {w / per, r % p.Hkv, r / p.Hkv % p.B, r / (p.Hkv * p.B)};
}

// CPA and NARROW as for dq_wgmma_kernel (dK and dV d columns wide)
template <int D, bool F32, bool CPA, bool NARROW>
__global__ void __launch_bounds__(WS_THREADS, 1)
    dkv_wgmma_kernel(const __grid_constant__ DkvParams p) {
  using C = Tiles<D, F32>;
  using OutT = typename std::conditional<F32, float, __nv_bfloat16>::type;
  constexpr int NP = C::NP, TN = C::TN, STAGES = C::DKV_STAGES, IM = C::IM;
  // a full barrier's arrivals: TMA's one expect, or each producer thread's
  // cp.async arrival (and for the ring's, its first thread's expect of lse
  // and di)
  constexpr int FULL_ARRIVALS = CPA ? CP_THREADS : 1;
  constexpr int DA = C::DA;             // columns of dK and dV a consumer
                                        // holds
  constexpr uint32_t ROWS_BYTES = NP * IM * D * 2, TILE_BYTES = NP * TN * D * 2;
  extern __shared__ __align__(1024) unsigned char dkv_smem[];
  DkvSmem<D, F32>& sm = *reinterpret_cast<DkvSmem<D, F32>*>(
      (reinterpret_cast<uintptr_t>(dkv_smem) + 1023) & ~uintptr_t(1023));
  const int items = p.nq * p.Hkv * p.B * p.splits;
  const int g_all = p.Hq / p.Hkv, g_split = g_all / p.splits;
  const int nqt = (p.T + TN - 1) / TN;  // query tiles
  const int wg = threadIdx.x / WG;
  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, FULL_ARRIVALS);
    mbar_init(&sm.kv_empty, CONSUMER_WARPS);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&sm.full[st], FULL_ARRIVALS + (CPA ? 1 : 0));
      mbar_init(&sm.empty[st], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {                        // producer
    regs_dec<PRODUCER_REGS>();
    if constexpr (CPA) {                // every thread copies by cp.async
      const int t = threadIdx.x;
      int it = 0;
      for (int j = 0, w; (w = item_index(j)) < items; ++j) {
        const KvItem e = kv_item(p, w);
        producer_wait(&sm.kv_empty, (j & 1) ^ 1, t, BAR_PRODUCER);
        cp_rows<D, IM>(sm.k, p.kr, p.d, p.T, p.gran, e.hk, e.kt * IM, e.b,
                       t);
        cp_rows<D, IM>(sm.v, p.vr, p.d, p.T, p.gran, e.hk, e.kt * IM, e.b,
                       t);
        cp_async_arrive_noinc(&sm.kv_full);
        for (int g = e.s * g_split; g < (e.s + 1) * g_split; ++g) {
          const int h = e.hk * g_all + g;
          for (int qt = e.kt * IM / TN; qt < nqt; ++qt, ++it) {
            const int st = it % STAGES;
            producer_wait(&sm.empty[st], ((it / STAGES) & 1) ^ 1, t,
                          BAR_PRODUCER);
            if (t == 0) {
              const long long rows = ((long long)e.b * p.Hq + h) * p.Tp;
              mbar_expect(&sm.full[st], 2 * TN * 4);
              bulk_load(sm.lse2[st], p.lse2 + rows + qt * TN, TN * 4,
                        &sm.full[st]);
              bulk_load(sm.di[st], p.di + rows + qt * TN, TN * 4,
                        &sm.full[st]);
            }
            cp_rows<D, TN>(sm.q[st], p.qr, p.d, p.T, p.gran, h, qt * TN,
                           e.b, t);
            cp_rows<D, TN>(sm.dout[st], p.dor, p.d, p.T, p.gran, h, qt * TN,
                           e.b, t);
            cp_async_arrive_noinc(&sm.full[st]);
          }
        }
      }
    } else if (threadIdx.x == 0) {      // one thread starts TMA
      int it = 0;
      for (int j = 0, w; (w = item_index(j)) < items; ++j) {
        const KvItem e = kv_item(p, w);
        mbar_wait(&sm.kv_empty, (j & 1) ^ 1);
        mbar_expect(&sm.kv_full, 2 * ROWS_BYTES);
        load_tile<D, NP, IM>(sm.k, &p.k, &sm.kv_full, e.hk, e.kt * IM, e.b,
                             p.B);
        load_tile<D, NP, IM>(sm.v, &p.v, &sm.kv_full, e.hk, e.kt * IM, e.b,
                             p.B);
        for (int g = e.s * g_split; g < (e.s + 1) * g_split; ++g) {
          const int h = e.hk * g_all + g;
          const long long rows = ((long long)e.b * p.Hq + h) * p.Tp;
          for (int qt = e.kt * IM / TN; qt < nqt; ++qt, ++it) {
            const int st = it % STAGES;
            mbar_wait(&sm.empty[st], ((it / STAGES) & 1) ^ 1);
            mbar_expect(&sm.full[st], 2 * TILE_BYTES + 2 * TN * 4);
            load_tile<D, NP, TN>(sm.q[st], &p.q, &sm.full[st], h, qt * TN,
                                 e.b, p.B);
            load_tile<D, NP, TN>(sm.dout[st], &p.dout, &sm.full[st], h,
                                 qt * TN, e.b, p.B);
            bulk_load(sm.lse2[st], p.lse2 + rows + qt * TN, TN * 4,
                      &sm.full[st]);
            bulk_load(sm.di[st], p.di + rows + qt * TN, TN * 4,
                      &sm.full[st]);
          }
        }
      }
    }
    return;
  }

  regs_inc<CONSUMER_REGS>();
  // keys 64 cw .. 64 cw + 63 of the item and every column of dK and dV;
  // WIDE: the item's 64 keys and columns 128 cw .. 128 cw + 127
  const int cw = wg - 1;
  const int kr0 = C::WIDE ? 0 : 64 * cw;   // the warpgroup's first key
  const int c0 = C::WIDE ? DA * cw : 0;    // and first column
  const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
  const int krow = 16 * warp + lane / 4;   // keys krow (+ 8) of the
  const int key0 = kr0 + krow;             // warpgroup's, key0 of the item
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  float dk[DA / 2], dv[DA / 2], s[TN / 2], dp[TN / 2];
  uint32_t pa[NP][TN / 16][4], da[NP][TN / 16][4];
  int it = 0;
  for (int j = 0, w; (w = item_index(j)) < items; ++j) {
    const KvItem e = kv_item(p, w);
    // the query tile on this warpgroup's diagonal (that holds its first
    // key, e.kt IM + kr0); the ones before it see none of its keys
    const int diag = e.kt * (IM / TN) + kr0 / TN;
    wait_tile<CPA>(&sm.kv_full, j & 1);
#pragma unroll
    for (int i = 0; i < DA / 2; ++i) dk[i] = dv[i] = 0.f;
    for (int g = 0; g < g_split; ++g) {
      for (int qt = e.kt * IM / TN; qt < nqt; ++qt, ++it) {
        const int st = it % STAGES;
        wait_tile<CPA>(&sm.full[st], (it / STAGES) & 1);
        if (qt < diag) {
          release(&sm.empty[st]);
          continue;
        }
        reg_fence(s);
        reg_fence(dp);
        wgmma_fence();
        gemm_abt<D, IM, TN, NP>(s, sm.k, kr0, sm.q[st]);         // S^T = K Q^T
        wgmma_commit();
        gemm_abt<D, IM, TN, NP>(dp, sm.v, kr0, sm.dout[st]);     // dP^T =
        wgmma_commit();                                          // V dO^T
        wgmma_wait<1>();
        reg_fence(s);
        // P^T = 2^(S^T scale log2(e) - lse log2(e)) (a query row's lse a
        // column) in f32, masked where a key follows the query row (the
        // 64 / TN tiles from the diagonal one), under dP^T's product
        const float* lse2 = sm.lse2[st];
        const float* dis = sm.di[st];
#pragma unroll
        for (int i = 0; i < TN / 2; ++i) {
          const int col = acc_col(i, lane), r = (i >> 1) & 1;
          s[i] = ex2(fmaf(s[i], p.scale_log2, -lse2[col]));
          if constexpr (TN < 64) {        // float32's tiles
            if (qt - diag < 64 / TN
                && krow + 8 * r > col + (qt - diag) * TN)
              s[i] = 0.f;
          } else if (qt == diag && krow + 8 * r > col) {
            s[i] = 0.f;
          }
        }
        wgmma_wait<0>();
        reg_fence(dp);
        // dS^T = (dP^T - di) P^T scale; P^T and dS^T to bf16 pairs (hi and
        // lo at float32) in one pass (each pair's four floats die as it is
        // made), the A operands of dV += P^T dO and dK += dS^T Q
#pragma unroll
        for (int kk = 0; kk < TN / 16; ++kk)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int i = 8 * kk + 2 * jj, col = acc_col(i, lane);
            if constexpr (F32) {
              split_bf2(s[i], s[i + 1], pa[0][kk][jj], pa[1][kk][jj]);
              split_bf2((dp[i] - dis[col]) * s[i] * p.scale,
                        (dp[i + 1] - dis[col + 1]) * s[i + 1] * p.scale,
                        da[0][kk][jj], da[1][kk][jj]);
            } else {
              pa[0][kk][jj] = pack_bf2(s[i], s[i + 1]);
              da[0][kk][jj] = pack_bf2(
                  (dp[i] - dis[col]) * s[i] * p.scale,
                  (dp[i + 1] - dis[col + 1]) * s[i + 1] * p.scale);
            }
          }
        reg_fence(dv);
        reg_fence(dk);
        wgmma_fence();
        // dV += P^T dO, dK += dS^T Q over the warpgroup's columns (boxes
        // c0 / 64 .. of the tiles)
        gemm_xb<DA, TN, NP, D>(dv, pa, sm.dout[st] + c0 * TN);
        gemm_xb<DA, TN, NP, D>(dk, da, sm.q[st] + c0 * TN);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dk);
        reg_fence(dv);
        release(&sm.empty[st]);
      }
    }
    release(&sm.kv_empty);

    const int keys = p.T - e.kt * IM;   // rows of the item below T
    const int dw = NARROW ? p.d : D;   // dK's and dV's width
    const long long out0 = (long long)e.b * p.kvsb
                           + ((long long)e.kt * IM * p.Hkv + e.hk) * dw + c0;
    const long long kst = (long long)p.Hkv * dw;
    const int ncols = dw - c0;          // of the warpgroup's columns
    OutT* const dk_out = static_cast<OutT*>(p.dk);
    OutT* const dv_out = static_cast<OutT*>(p.dv);
    if (p.splits == 1) {
      store_acc<DA, NARROW>(dk_out + out0, kst, key0, keys, ncols, dk, lane);
      store_acc<DA, NARROW>(dv_out + out0, kst, key0, keys, ncols, dv, lane);
      continue;
    }
    // split heads: this block's f32 partials, then the last block of the
    // (key tile, kv head, batch row) sums all of them in split order
    const long long plane = (long long)p.splits * p.B * p.Hkv * p.Tp * D;
    const long long own =
        ((((long long)e.s * p.B + e.b) * p.Hkv + e.hk) * p.Tp + e.kt * IM)
        * D + c0;
    const long long step = (long long)p.B * p.Hkv * p.Tp * D;  // a split
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long at = own + (long long)(key0 + 8 * r) * D
                           + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < DA / 8; ++i) {
        *reinterpret_cast<float2*>(p.part + at + 8 * i) =
            make_float2(dk[4 * i + 2 * r], dk[4 * i + 2 * r + 1]);
        *reinterpret_cast<float2*>(p.part + plane + at + 8 * i) =
            make_float2(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
      }
    }
    __threadfence();
    named_sync(BAR_CONSUMERS, 2 * WG);
    int* ticket = p.tickets + ((long long)e.kt * p.Hkv + e.hk) * p.B + e.b;
    if (threadIdx.x == WG)
      sm.last = atomicAdd(ticket, 1) == p.splits - 1;
    named_sync(BAR_CONSUMERS, 2 * WG);
    if (!sm.last) continue;
    __threadfence();
    // each of the lane's rows of dK, then of dV: split by split, the row's
    // DA / 4 values read at once (loads in flight, not one chain a value),
    // summed in split order
    const float* first = p.part + own - e.s * step;
#pragma unroll 1
    for (int pl = 0; pl < 2; ++pl) {
#pragma unroll 1
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        const float* row = first + pl * plane + key * D + 2 * (lane & 3);
        float2 acc[DA / 8];
#pragma unroll
        for (int i = 0; i < DA / 8; ++i) acc[i] = make_float2(0.f, 0.f);
        for (int sp = 0; sp < p.splits; ++sp) {
#pragma unroll
          for (int i = 0; i < DA / 8; ++i) {
            const float2 x = __ldcg(reinterpret_cast<const float2*>(
                row + sp * step + 8 * i));
            acc[i].x += x.x;
            acc[i].y += x.y;
          }
        }
        if (key >= keys) continue;
        OutT* out = (pl ? dv_out : dk_out) + out0 + key * kst;
#pragma unroll
        for (int i = 0; i < DA / 8; ++i) {
          const int col = 8 * i + 2 * (lane & 3);
          if constexpr (NARROW)
            store_cols(out + col, col, ncols, acc[i].x, acc[i].y);
          else
            store2(out + col, acc[i].x, acc[i].y);
        }
      }
    }
    if (threadIdx.x == WG) *ticket = 0;  // for the next call
  }
}

// ---------------------------------------------------------------------------
// bf16 at head_dim 256: the consumers share every tile (see the header)
// ---------------------------------------------------------------------------

// The consumers' bf16 pairs through shared memory: x[consumer][slot]
// [thread], 16 bytes a thread and slot. put_pairs writes this consumer's
// two k16 slices (its 32 rows of the tile) at slots s0, s0 + 1;
// take_pairs reads the A operand over the tile's 64 rows from both
// consumers' slots s0, s0 + 1: consumer 0's slices first, then consumer
// 1's, in that order in both
template <int SLOTS>
__device__ __forceinline__ void put_pairs(uint4 (*x)[SLOTS][WG], int cw,
                                          int s0,
                                          const uint32_t (&own)[1][2][4],
                                          int t) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    x[cw][s0 + kk][t] = make_uint4(own[0][kk][0], own[0][kk][1],
                                   own[0][kk][2], own[0][kk][3]);
}

template <int SLOTS>
__device__ __forceinline__ void take_pairs(uint32_t (&a)[1][4][4],
                                           uint4 (*x)[SLOTS][WG],
                                           int s0, int t) {
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint4 v = x[c][s0 + kk][t];
      a[0][2 * c + kk][0] = v.x;
      a[0][2 * c + kk][1] = v.y;
      a[0][2 * c + kk][2] = v.z;
      a[0][2 * c + kk][3] = v.w;
    }
}

// CPA and NARROW as for dq_wgmma_kernel. An item is 64 query rows of one
// (query head, batch row); the ring brings its o tile (into a K slot),
// then its K and V tiles of 64 keys up to the diagonal.
template <bool CPA, bool NARROW>
__global__ void __launch_bounds__(WS_THREADS, 1)
    dq_d256_kernel(const __grid_constant__ DqParams p) {
  using C = Tiles<256, false>;
  constexpr int D = 256, R = C::IM, ST = C::DQ_STAGES;
  static_assert(C::TN == R && C::DQ_WGS == 2 && C::NP == 1
                    && C::DA == D / 2,
                "64-row tiles, two consumers, 128 columns each");
  constexpr int FULL_ARRIVALS = CPA ? CP_THREADS : 1;
  constexpr uint32_t TILE_BYTES = R * D * 2;
  extern __shared__ __align__(1024) unsigned char dq256_smem[];
  Dq256Smem& sm = *reinterpret_cast<Dq256Smem*>(
      (reinterpret_cast<uintptr_t>(dq256_smem) + 1023) & ~uintptr_t(1023));
  const int heads = p.B * p.Hq;
  const int items = p.nq * heads;
  const int wg = threadIdx.x / WG;
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, FULL_ARRIVALS);
    mbar_init(&sm.q_empty, CONSUMER_WARPS);
#pragma unroll
    for (int st = 0; st < ST; ++st) {
      mbar_init(&sm.kv_full[st], FULL_ARRIVALS);
      mbar_init(&sm.kv_empty[st], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {                        // producer: kt = -1 is o's tile
    regs_dec<D256_PRODUCER_REGS<CPA>>();
    if constexpr (CPA) {
      const int t = threadIdx.x;
      int it = 0;
      for (int j = 0, w; (w = item_index(j)) < items; ++j) {
        const int qt = p.nq - 1 - w / heads, h = w % p.Hq;
        const int b = w % heads / p.Hq, hk = h / (p.Hq / p.Hkv);
        producer_wait(&sm.q_empty, (j & 1) ^ 1, t, BAR_PRODUCER);
        cp_rows<D, R>(sm.q, p.qr, p.d, p.T, p.gran, h, qt * R, b, t);
        cp_rows<D, R>(sm.dout, p.dor, p.d, p.T, p.gran, h, qt * R, b, t);
        cp_async_arrive_noinc(&sm.q_full);
        const int nkt = dq_key_tiles<R, R>(qt, p.T);
        for (int kt = -1; kt < nkt; ++kt, ++it) {
          const int st = it % ST;
          producer_wait(&sm.kv_empty[st], ((it / ST) & 1) ^ 1, t,
                        BAR_PRODUCER);
          if (kt < 0) {
            cp_rows<D, R>(sm.k[st], p.orw, p.d, p.T, p.gran, h, qt * R, b,
                          t);
          } else {
            cp_rows<D, R>(sm.k[st], p.kr, p.d, p.T, p.gran, hk, kt * R, b,
                          t);
            cp_rows<D, R>(sm.v[st], p.vr, p.d, p.T, p.gran, hk, kt * R, b,
                          t);
          }
          cp_async_arrive_noinc(&sm.kv_full[st]);
        }
      }
    } else if (threadIdx.x == 0) {
      int it = 0;
      for (int j = 0, w; (w = item_index(j)) < items; ++j) {
        const int qt = p.nq - 1 - w / heads, h = w % p.Hq;
        const int b = w % heads / p.Hq, hk = h / (p.Hq / p.Hkv);
        mbar_wait(&sm.q_empty, (j & 1) ^ 1);
        mbar_expect(&sm.q_full, 2 * TILE_BYTES);
        load_tile<D, 1, R>(sm.q, &p.q, &sm.q_full, h, qt * R, b, p.B);
        load_tile<D, 1, R>(sm.dout, &p.dout, &sm.q_full, h, qt * R, b, p.B);
        const int nkt = dq_key_tiles<R, R>(qt, p.T);
        for (int kt = -1; kt < nkt; ++kt, ++it) {
          const int st = it % ST;
          mbar_wait(&sm.kv_empty[st], ((it / ST) & 1) ^ 1);
          if (kt < 0) {
            mbar_expect(&sm.kv_full[st], TILE_BYTES);
            load_tile<D, 1, R>(sm.k[st], &p.o, &sm.kv_full[st], h, qt * R, b,
                               p.B);
          } else {
            mbar_expect(&sm.kv_full[st], 2 * TILE_BYTES);
            load_tile<D, 1, R>(sm.k[st], &p.k, &sm.kv_full[st], hk, kt * R,
                               b, p.B);
            load_tile<D, 1, R>(sm.v[st], &p.v, &sm.kv_full[st], hk, kt * R,
                               b, p.B);
          }
        }
      }
    }
    return;
  }

  regs_inc<D256_CONSUMER_REGS<CPA>>();
  const int cw = wg - 1;                // keys 32 cw .. of each tile; dQ's
  const int c0 = (D / 2) * cw;          // columns c0 .. c0 + 127
  const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
  const int row0 = 16 * warp + lane / 4;   // and row0 + 8, of the item's
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  float dq[D / 4], s[HALF / 2], dp[HALF / 2];
  uint32_t mine[1][2][4], ds[1][4][4];
  int it = 0, x = 0;                    // the ring's and the exchange's turns
  for (int j = 0, w; (w = item_index(j)) < items; ++j) {
    const int qt = p.nq - 1 - w / heads, h = w % p.Hq;
    const int b = w % heads / p.Hq;
    const int nkt = dq_key_tiles<R, R>(qt, p.T);
    const long long rows = ((long long)b * p.Hq + h);
    wait_tile<CPA>(&sm.q_full, j & 1);

    // di = rowsum(o . dO) and lse in base 2 of the lane's two rows, from
    // the o tile the ring brought first (a quad's four lanes split D;
    // both consumers, the first writes them to the scratch)
    float di[2], lse2[2];
    {
      const int st = it % ST;
      wait_tile<CPA>(&sm.kv_full[st], (it / ST) & 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = row0 + 8 * r, row = qt * R + rr;
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          const int at = tile_at<R>(rr, 8 * i + 2 * (lane & 3));
          const float2 a = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sm.k[st] + at));
          const float2 y = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sm.dout + at));
          acc = fmaf(a.x, y.x, acc);
          acc = fmaf(a.y, y.y, acc);
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        di[r] = row < p.T ? acc : 0.f;
        lse2[r] = row < p.T ? p.lse[rows * p.T + row] * LOG2E : INFINITY;
        if (cw == 0 && (lane & 3) == 0) {
          p.lse2[rows * p.Tp + row] = lse2[r];
          p.di[rows * p.Tp + row] = di[r];
        }
      }
      release(&sm.kv_empty[st]);
      ++it;
    }

#pragma unroll
    for (int i = 0; i < D / 4; ++i) dq[i] = 0.f;
    int pending = -1;                   // the stage dQ's product still reads
    for (int kt = 0; kt < nkt; ++kt, ++it) {
      const int st = it % ST;
      wait_tile<CPA>(&sm.kv_full[st], (it / ST) & 1);
      reg_fence(s);
      reg_fence(dp);
      wgmma_fence();
      // S = Q K^T, dP = dO V^T over this consumer's 32 keys
      gemm_abt<D, R, HALF, 1, R>(s, sm.q, 0, sm.k[st] + HALF * cw * 64);
      wgmma_commit();
      gemm_abt<D, R, HALF, 1, R>(dp, sm.dout, 0, sm.v[st] + HALF * cw * 64);
      wgmma_commit();
      wgmma_wait<2>();                  // the last tile's dQ: its K and V
      reg_fence(dq);                    // free for the producer
      if (pending >= 0) release(&sm.kv_empty[pending]);
      wgmma_wait<1>();                  // S
      reg_fence(s);
      // P = 2^(S scale log2(e) - lse log2(e)), masked on the diagonal
      // tile where the key follows the row, under dP's product
#pragma unroll
      for (int i = 0; i < HALF / 2; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = ex2(fmaf(s[i], p.scale_log2, -lse2[r]));
        if (kt == qt && HALF * cw + acc_col(i, lane) > row0 + 8 * r)
          s[i] = 0.f;
      }
      wgmma_wait<0>();
      reg_fence(dp);
      if (kt == nkt - 1) release(&sm.q_empty);   // Q, dO read for good
      // dS = (dP - di) P scale as bf16 pairs, exchanged: the A operand
      // over the tile's 64 keys
#pragma unroll
      for (int i = 0; i < HALF / 2; ++i)
        dp[i] = (dp[i] - di[(i >> 1) & 1]) * s[i] * p.scale;
      to_pairs<1, HALF>(dp, mine);
      put_pairs(sm.x[x & 1], cw, 0, mine, t);
      named_sync(BAR_CONSUMERS, 2 * WG);
      take_pairs(ds, sm.x[x & 1], 0, t);
      ++x;
      wgmma_fence();
      // dQ[:, c0 ..] += dS K, under the next S and dP
      gemm_xb<D / 2, R, 1, D>(dq, ds, sm.k[st] + c0 * R);
      wgmma_commit();
      pending = st;
    }
    wgmma_wait<0>();
    reg_fence(dq);
    if (pending >= 0) release(&sm.kv_empty[pending]);
    const int dw = NARROW ? p.d : D;   // dQ's width
    store_acc<D / 2, NARROW>(static_cast<__nv_bfloat16*>(p.dq)
                             + (((long long)b * p.T + qt * R) * p.Hq + h)
                                   * dw + c0,
                             (long long)p.Hq * dw, row0, p.T - qt * R,
                             dw - c0, dq, lane);
  }
}

// Key tiles of the dK/dV items' unit u (KvItem::kt): u, and with pairs nq
// - 1 - u where that is another tile
__device__ __forceinline__ int unit_tiles(const DkvParams& p, int u) {
  return p.pairs && p.nq - 1 - u != u ? 2 : 1;
}

__device__ __forceinline__ int unit_tile(const DkvParams& p, int u, int i) {
  return i ? p.nq - 1 - u : u;
}

// CPA and NARROW as for dq_wgmma_kernel. An item is split e.s of the
// query heads of kv head e.hk, batch row e.b, over the key tiles of unit
// e.kt; per key tile K and V come once, Q, dO, lse and di in 64-row tiles
// from the diagonal on, query head by query head.
template <bool CPA, bool NARROW>
__global__ void __launch_bounds__(WS_THREADS, 1)
    dkv_d256_kernel(const __grid_constant__ DkvParams p) {
  using C = Tiles<256, false>;
  constexpr int D = 256, R = C::IM, ST = C::DKV_STAGES;
  static_assert(C::TN == R, "64-row tiles");
  constexpr int FULL_ARRIVALS = CPA ? CP_THREADS : 1;
  constexpr uint32_t TILE_BYTES = R * D * 2;
  extern __shared__ __align__(1024) unsigned char dkv256_smem[];
  Dkv256Smem& sm = *reinterpret_cast<Dkv256Smem*>(
      (reinterpret_cast<uintptr_t>(dkv256_smem) + 1023) & ~uintptr_t(1023));
  const int units = p.pairs ? (p.nq + 1) / 2 : p.nq;
  const int items = units * p.Hkv * p.B * p.splits;
  const int g_all = p.Hq / p.Hkv, g_split = g_all / p.splits;
  const int wg = threadIdx.x / WG;
  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, FULL_ARRIVALS);
    mbar_init(&sm.kv_empty, CONSUMER_WARPS);
#pragma unroll
    for (int st = 0; st < ST; ++st) {
      mbar_init(&sm.full[st], FULL_ARRIVALS + (CPA ? 1 : 0));
      mbar_init(&sm.empty[st], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {                        // producer
    regs_dec<D256_PRODUCER_REGS<CPA>>();
    const int t = threadIdx.x;
    if (!CPA && t != 0) return;         // one thread starts TMA
    int it = 0, sub = 0;                // ring tiles, key tiles loaded
    for (int j = 0, w; (w = item_index(j)) < items; ++j) {
      const KvItem e = kv_item(p, w);
      for (int u = 0; u < unit_tiles(p, e.kt); ++u, ++sub) {
        const int kt = unit_tile(p, e.kt, u);
        if constexpr (CPA) {
          producer_wait(&sm.kv_empty, (sub & 1) ^ 1, t, BAR_PRODUCER);
          cp_rows<D, R>(sm.k, p.kr, p.d, p.T, p.gran, e.hk, kt * R, e.b, t);
          cp_rows<D, R>(sm.v, p.vr, p.d, p.T, p.gran, e.hk, kt * R, e.b, t);
          cp_async_arrive_noinc(&sm.kv_full);
        } else {
          mbar_wait(&sm.kv_empty, (sub & 1) ^ 1);
          mbar_expect(&sm.kv_full, 2 * TILE_BYTES);
          load_tile<D, 1, R>(sm.k, &p.k, &sm.kv_full, e.hk, kt * R, e.b,
                             p.B);
          load_tile<D, 1, R>(sm.v, &p.v, &sm.kv_full, e.hk, kt * R, e.b,
                             p.B);
        }
        for (int g = e.s * g_split; g < (e.s + 1) * g_split; ++g) {
          const int h = e.hk * g_all + g;
          const long long rows = ((long long)e.b * p.Hq + h) * p.Tp;
          for (int qt = kt; qt < p.nq; ++qt, ++it) {
            const int st = it % ST;
            if constexpr (CPA) {
              producer_wait(&sm.empty[st], ((it / ST) & 1) ^ 1, t,
                            BAR_PRODUCER);
              if (t == 0) mbar_expect(&sm.full[st], 2 * R * 4);
            } else {
              mbar_wait(&sm.empty[st], ((it / ST) & 1) ^ 1);
              mbar_expect(&sm.full[st], 2 * TILE_BYTES + 2 * R * 4);
            }
            if (t == 0) {
              bulk_load(sm.lse2[st], p.lse2 + rows + qt * R, R * 4,
                        &sm.full[st]);
              bulk_load(sm.di[st], p.di + rows + qt * R, R * 4,
                        &sm.full[st]);
            }
            if constexpr (CPA) {
              cp_rows<D, R>(sm.q[st], p.qr, p.d, p.T, p.gran, h, qt * R,
                            e.b, t);
              cp_rows<D, R>(sm.dout[st], p.dor, p.d, p.T, p.gran, h, qt * R,
                            e.b, t);
              cp_async_arrive_noinc(&sm.full[st]);
            } else {
              load_tile<D, 1, R>(sm.q[st], &p.q, &sm.full[st], h, qt * R,
                                 e.b, p.B);
              load_tile<D, 1, R>(sm.dout[st], &p.dout, &sm.full[st], h,
                                 qt * R, e.b, p.B);
            }
          }
        }
      }
    }
    return;
  }

  regs_inc<D256_CONSUMER_REGS<CPA>>();
  const int cw = wg - 1;                // query rows 32 cw .. of each tile;
  const int c0 = (D / 2) * cw;          // dK's, dV's columns c0 .. c0 + 127
  const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
  const int krow = 16 * warp + lane / 4;   // keys krow (+ 8) of the tile
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  float dk[D / 4], dv[D / 4], s[HALF / 2], dp[HALF / 2];
  uint32_t mp[1][2][4], md[1][2][4], pa[1][4][4], da[1][4][4];
  int it = 0, sub = 0, x = 0;
  __nv_bfloat16* const dk_out = static_cast<__nv_bfloat16*>(p.dk);
  __nv_bfloat16* const dv_out = static_cast<__nv_bfloat16*>(p.dv);
  const int dw = NARROW ? p.d : D;     // dK's and dV's width
  const long long kst = (long long)p.Hkv * dw;
  for (int j = 0, w; (w = item_index(j)) < items; ++j) {
    const KvItem e = kv_item(p, w);
    for (int u = 0; u < unit_tiles(p, e.kt); ++u, ++sub) {
      const int kt = unit_tile(p, e.kt, u);
      wait_tile<CPA>(&sm.kv_full, sub & 1);
#pragma unroll
      for (int i = 0; i < D / 4; ++i) dk[i] = dv[i] = 0.f;
      const int n = g_split * (p.nq - kt);   // query tiles of the key tile
      int pending = -1;
      for (int i = 0; i < n; ++i, ++it) {
        const int st = it % ST, qt = kt + i % (p.nq - kt);
        wait_tile<CPA>(&sm.full[st], (it / ST) & 1);
        reg_fence(s);
        reg_fence(dp);
        wgmma_fence();
        // S^T = K Q^T, dP^T = V dO^T over this consumer's 32 query rows
        gemm_abt<D, R, HALF, 1, R>(s, sm.k, 0, sm.q[st] + HALF * cw * 64);
        wgmma_commit();
        gemm_abt<D, R, HALF, 1, R>(dp, sm.v, 0,
                                   sm.dout[st] + HALF * cw * 64);
        wgmma_commit();
        wgmma_wait<2>();                // the last tile's dV, dK: its Q
        reg_fence(dk);                  // and dO free for the producer
        reg_fence(dv);
        if (pending >= 0) release(&sm.empty[pending]);
        wgmma_wait<1>();                // S^T
        reg_fence(s);
        // P^T = 2^(S^T scale log2(e) - lse log2(e)) (a query row's lse a
        // column), masked on the diagonal tile where a key follows the
        // query row, under dP^T's product
        const float* lse2 = sm.lse2[st] + HALF * cw;
        const float* dis = sm.di[st] + HALF * cw;
#pragma unroll
        for (int ii = 0; ii < HALF / 2; ++ii) {
          const int col = acc_col(ii, lane), r = (ii >> 1) & 1;
          s[ii] = ex2(fmaf(s[ii], p.scale_log2, -lse2[col]));
          if (qt == kt && krow + 8 * r > HALF * cw + col) s[ii] = 0.f;
        }
        wgmma_wait<0>();
        reg_fence(dp);
        // P^T and dS^T = (dP^T - di) P^T scale as bf16 pairs, exchanged:
        // the A operands over the tile's 64 query rows
#pragma unroll
        for (int kk = 0; kk < HALF / 16; ++kk)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int ii = 8 * kk + 2 * jj, col = acc_col(ii, lane);
            mp[0][kk][jj] = pack_bf2(s[ii], s[ii + 1]);
            md[0][kk][jj] = pack_bf2(
                (dp[ii] - dis[col]) * s[ii] * p.scale,
                (dp[ii + 1] - dis[col + 1]) * s[ii + 1] * p.scale);
          }
        put_pairs(sm.x[x & 1], cw, 0, mp, t);
        put_pairs(sm.x[x & 1], cw, 2, md, t);
        named_sync(BAR_CONSUMERS, 2 * WG);
        take_pairs(pa, sm.x[x & 1], 0, t);
        take_pairs(da, sm.x[x & 1], 2, t);
        ++x;
        wgmma_fence();
        // dV += P^T dO, dK += dS^T Q over this consumer's columns, under
        // the next S^T and dP^T
        gemm_xb<D / 2, R, 1, D>(dv, pa, sm.dout[st] + c0 * R);
        gemm_xb<D / 2, R, 1, D>(dk, da, sm.q[st] + c0 * R);
        wgmma_commit();
        pending = st;
      }
      wgmma_wait<0>();
      reg_fence(dk);
      reg_fence(dv);
      if (pending >= 0) release(&sm.empty[pending]);
      release(&sm.kv_empty);

      const int keys = p.T - kt * R;   // rows of the tile below T
      const long long out0 = (long long)e.b * p.kvsb
                             + ((long long)kt * R * p.Hkv + e.hk) * dw;
      if (p.splits == 1) {
        store_acc<D / 2, NARROW>(dk_out + out0 + c0, kst, krow, keys,
                                 dw - c0, dk, lane);
        store_acc<D / 2, NARROW>(dv_out + out0 + c0, kst, krow, keys,
                                 dw - c0, dv, lane);
        continue;
      }
      // split heads: this block's f32 partials, then the last block of the
      // (key tile, kv head, batch row) sums all of them in split order
      const long long plane = (long long)p.splits * p.B * p.Hkv * p.Tp * D;
      const long long step = (long long)p.B * p.Hkv * p.Tp * D;  // a split
      const long long first =
          (((long long)e.b * p.Hkv + e.hk) * p.Tp + kt * R) * D;
      const long long own = first + e.s * step + c0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long at = own + (long long)(krow + 8 * r) * D
                             + 2 * (lane & 3);
#pragma unroll
        for (int i = 0; i < D / 16; ++i) {
          *reinterpret_cast<float2*>(p.part + at + 8 * i) =
              make_float2(dk[4 * i + 2 * r], dk[4 * i + 2 * r + 1]);
          *reinterpret_cast<float2*>(p.part + plane + at + 8 * i) =
              make_float2(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
        }
      }
      __threadfence();
      named_sync(BAR_CONSUMERS, 2 * WG);
      int* ticket = p.tickets + ((long long)kt * p.Hkv + e.hk) * p.B + e.b;
      if (threadIdx.x == WG)
        sm.last = atomicAdd(ticket, 1) == p.splits - 1;
      named_sync(BAR_CONSUMERS, 2 * WG);
      if (!sm.last) continue;
      __threadfence();
      // the tile's 2 x 64 x 256 sums, four columns a thread at a time and
      // eight of them at once: 64 KB of loads in flight, not one chain a
      // value (one block reads all S partials, 1 MB a tile at S = 8)
      constexpr int TILE4 = R * D / 4, ILP = 8;  // a plane's quads
#pragma unroll 1
      for (int q0 = threadIdx.x - WG; q0 < 2 * TILE4; q0 += ILP * 2 * WG) {
        float4 acc[ILP];
#pragma unroll
        for (int u = 0; u < ILP; ++u)
          acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
        for (int sp = 0; sp < p.splits; ++sp) {
#pragma unroll
          for (int u = 0; u < ILP; ++u) {
            const int qd = q0 + u * 2 * WG;
            const float4 v = __ldcg(reinterpret_cast<const float4*>(
                p.part + first + sp * step + (qd / TILE4) * plane
                + 4 * (qd % TILE4)));
            acc[u].x += v.x;
            acc[u].y += v.y;
            acc[u].z += v.z;
            acc[u].w += v.w;
          }
        }
#pragma unroll
        for (int u = 0; u < ILP; ++u) {
          const int qd = q0 + u * 2 * WG, pl = qd / TILE4;
          const int row = qd % TILE4 / (D / 4), col = 4 * (qd % (D / 4));
          if (row >= keys) continue;
          __nv_bfloat16* out = (pl ? dv_out : dk_out) + out0 + row * kst;
          if constexpr (NARROW) {
            store_cols(out + col, col, dw, acc[u].x, acc[u].y);
            store_cols(out + col + 2, col + 2, dw, acc[u].z, acc[u].w);
          } else {
            store2(out + col, acc[u].x, acc[u].y);
            store2(out + col + 2, acc[u].z, acc[u].w);
          }
        }
      }
      if (threadIdx.x == WG) *ticket = 0;  // for the next call
    }
  }
}

int sm_count(int* sms) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

// The scratch of both paths: lse log2(e) and di [B, Hq, Tp], and with S >
// 1 the partial dK and dV [2][S][B][Hkv][Tp][D] (floats) and the tickets
// [nq][Hkv][B]. S splits each kv head's query heads. dq_wgmma_kernel's
// and dkv_wgmma_kernel's plan: the largest divisor of G for which S x the
// items (key tiles x kv heads x batch) still fit the SMs in one wave, else
// 1. (At G = 8, T = 512, D = 128: S = 4, 128 items; S = 8 took two waves
// and twice the partials, and was slower than S = 1.) The D = 256 bf16
// kernels': plan_d256.
struct Scratch {
  int nq, Tp, splits, pairs;
  long long floats, tickets;
};

// dkv_d256_kernel's items (see the header): with or without pairs of key
// tiles, and S, the plan whose estimate of the busiest block's query tiles
// is least, max(the longest item, all tiles over the blocks), S > 1 only
// where the items fit the SMs; ties to no pairs and the fewer splits.
// tests/flash_bwd_plan.py bwd_plan_d256 is this plan for the tests.
void plan_d256(Scratch& s, int B, int Hq, int Hkv, int sms) {
  const long long nk = s.nq, g = Hq / Hkv, kv = (long long)Hkv * B;
  const long long tiles = g * kv * nk * (nk + 1) / 2;
  long long best = -1;
  for (int pair = 0; pair < 2; ++pair) {
    const long long units = pair ? (nk + 1) / 2 : nk;
    const long long len = pair && nk > 1 ? nk + 1 : nk;  // a head's tiles
    for (int d = 1; d <= g; ++d) {
      if (g % d) continue;
      const long long items = units * kv * d;
      if (d > 1 && items > sms) break;
      const long long blocks = items < sms ? items : sms;
      const long long longest = len * (g / d);
      const long long spread = (tiles + blocks - 1) / blocks;
      const long long est = longest > spread ? longest : spread;
      if (best < 0 || est < best) {
        best = est;
        s.pairs = pair;
        s.splits = d;
      }
    }
  }
}

Scratch scratch_of(int B, int T, int Hq, int Hkv, int D, int f32,
                   int sms) {
  Scratch s;
  const int im = item_rows(D);
  s.nq = (T + im - 1) / im;
  s.Tp = s.nq * im;
  const long long items = (long long)s.nq * Hkv * B;
  const int g = Hq / Hkv;
  s.splits = 1;
  s.pairs = 0;
  if (D > 128 && !f32) {
    plan_d256(s, B, Hq, Hkv, sms);
  } else {
    for (int d = 2; d <= g; ++d)        // the largest divisor of G that
      if (g % d == 0 && items * d <= sms) s.splits = d;  // keeps one wave
  }
  s.floats = 2LL * B * Hq * s.Tp
             + (s.splits > 1 ? 2LL * s.splits * B * Hkv * s.Tp * D : 0);
  s.tickets = s.splits > 1 ? items : 0;
  return s;
}

// The tensors the two kernels read, as the maps see them: bf16 rows on
// their strides, heads d apart, or float32's planes ([2B, T, H, D],
// contiguous, d = D)
struct Operand {
  const void* x;
  long long sb, st;
  int heads, batch, d;

  Rows rows() const {
    return {static_cast<const __nv_bfloat16*>(x), sb, st};
  }
};

// The two kernels over bf16 rows of head_dim d <= D (or the planes, d =
// D), read by TMA (CPA false: maps of column extent d, zeros past it) or
// the producers' cp.async of `gran` bytes (CPA); dQ, dK and dV written at
// width d
template <int D, bool F32, bool CPA>
int launch_wgmma(const Operand& q, const Operand& k, const Operand& v,
                 const Operand& o, const Operand& dout, const float* lse,
                 void* dq, void* dk, void* dv, float* ws, int* tickets,
                 long long kvsb, int B, int T, int Hq, int Hkv, int d,
                 int gran, float scale, int sms, cudaStream_t stream) {
  using C = Tiles<D, F32>;
  constexpr int IM = C::IM;
  const Scratch sc = scratch_of(B, T, Hq, Hkv, D, F32, sms);
  if (ws == nullptr || (sc.splits > 1 && tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long dq_items = (long long)sc.nq * Hq * B;
  const long long units = sc.pairs ? (sc.nq + 1) / 2 : sc.nq;
  const long long kv_items = units * Hkv * B * sc.splits;
  if (dq_items > 0x7fffffff || kv_items > 0x7fffffff)
    return (int)cudaErrorInvalidValue;

  auto map = [&](CUtensorMap* m, const Operand& x, int rows) {
    return tensor_map_rows(m, x.x, x.d, x.heads, T, x.batch, x.st, x.sb,
                           rows);
  };
  DqParams a;
  DkvParams c;
  if constexpr (CPA) {
    a.qr = c.qr = q.rows();
    a.dor = c.dor = dout.rows();
    a.orw = o.rows();
    a.kr = c.kr = k.rows();
    a.vr = c.vr = v.rows();
  } else if (!map(&a.q, q, IM) || !map(&a.dout, dout, IM)
             || (!F32 && !map(&a.o, o, IM)) || !map(&a.k, k, C::TN)
             || !map(&a.v, v, C::TN) || !map(&c.k, k, IM)
             || !map(&c.v, v, IM) || !map(&c.q, q, C::TN)
             || !map(&c.dout, dout, C::TN)) {
    return (int)cudaErrorInvalidValue;
  }
  a.d = c.d = d;
  a.gran = c.gran = gran;
  const long long rows = (long long)B * Hq * sc.Tp;
  a.lse = lse;
  a.lse2 = ws;
  a.di = ws + rows;
  a.dq = dq;
  c.lse2 = ws;
  c.di = ws + rows;
  c.part = ws + 2 * rows;
  c.tickets = tickets;
  c.dk = dk;
  c.dv = dv;
  c.kvsb = kvsb;
  a.nq = c.nq = sc.nq;
  a.B = c.B = B;
  a.T = c.T = T;
  a.Tp = c.Tp = sc.Tp;
  a.Hq = c.Hq = Hq;
  a.Hkv = c.Hkv = Hkv;
  c.splits = sc.splits;
  c.pairs = sc.pairs;
  a.scale = c.scale = scale;
  a.scale_log2 = c.scale_log2 = scale * LOG2E;

  size_t dq_smem, kv_smem;              // + 1024 for the alignment
  void (*kq)(DqParams);                 // cp.async only at NARROW
  void (*kkv)(DkvParams);
  if constexpr (C::D256) {
    dq_smem = sizeof(Dq256Smem) + 1024;
    kv_smem = sizeof(Dkv256Smem) + 1024;
    if constexpr (CPA) {
      kq = dq_d256_kernel<true, true>;
      kkv = dkv_d256_kernel<true, true>;
    } else if (d < D) {
      kq = dq_d256_kernel<false, true>;
      kkv = dkv_d256_kernel<false, true>;
    } else {
      kq = dq_d256_kernel<false, false>;
      kkv = dkv_d256_kernel<false, false>;
    }
  } else {
    dq_smem = sizeof(DqSmem<D, F32>) + 1024;
    kv_smem = sizeof(DkvSmem<D, F32>) + 1024;
    if constexpr (CPA) {
      kq = dq_wgmma_kernel<D, F32, true, true>;
      kkv = dkv_wgmma_kernel<D, F32, true, true>;
    } else if (d < D) {
      kq = dq_wgmma_kernel<D, F32, false, true>;
      kkv = dkv_wgmma_kernel<D, F32, false, true>;
    } else {
      kq = dq_wgmma_kernel<D, F32, false, false>;
      kkv = dkv_wgmma_kernel<D, F32, false, false>;
    }
  }
  cudaError_t e = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
  if (e != cudaSuccess) return (int)e;
  kq<<<(int)(dq_items > sms ? sms : dq_items), C::DQ_THREADS, dq_smem,
       stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kkv<<<(int)(kv_items > sms ? sms : kv_items), WS_THREADS, kv_smem,
        stream>>>(c);
  return (int)cudaGetLastError();
}

// float32: the split pass (q's, k's, v's and dO's planes, in that order in
// `planes`; di and lse log2(e) into ws), then the kernels over the planes
template <int W>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, void* dq, void* dk,
               void* dv, float* ws, int* tickets, __nv_bfloat16* planes,
               long long qsb, long long qst, long long ksb, long long kst,
               long long vsb, long long vst, long long osb, long long ost,
               long long dsb, long long dst, long long kvsb, int B, int T,
               int Hq, int Hkv, int d, float scale, int sms,
               cudaStream_t stream) {
  const Scratch sc = scratch_of(B, T, Hq, Hkv, W, 1, sms);
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  __nv_bfloat16* qp = planes;
  __nv_bfloat16* kp = qp + 2LL * B * T * Hq * W;
  __nv_bfloat16* vp = kp + 2LL * B * T * Hkv * W;
  __nv_bfloat16* dp = vp + 2LL * B * T * Hkv * W;
  SplitParams sp{};
  sp.job[0] = split_job(q, qsb, qst, qp, Hq, d);
  sp.job[1] = split_job(k, ksb, kst, kp, Hkv, d);
  sp.job[2] = split_job(v, vsb, vst, vp, Hkv, d);
  sp.job[3] = split_job(dout, dsb, dst, dp, Hq, d);
  sp.B = B;
  sp.T = T;
  sp.D = d;
  sp.o = static_cast<const float*>(o);
  sp.osb = osb;
  sp.ost = ost;
  sp.ovec = split_vec(o, osb, ost, d);
  sp.lse = lse;
  sp.lse2 = ws;
  sp.di = ws + (long long)B * Hq * sc.Tp;
  sp.Tp = sc.Tp;
  sp.di_job = 3;
  int err = launch_split<W, true>(sp, 4, (long long)B * sc.Tp * Hq, stream);
  if (err) return err;
  const long long pst = (long long)Hq * W, kvst = (long long)Hkv * W;
  const Operand qo{qp, T * pst, pst, Hq, 2 * B, W};
  const Operand ko{kp, T * kvst, kvst, Hkv, 2 * B, W};
  const Operand vo{vp, T * kvst, kvst, Hkv, 2 * B, W};
  const Operand doo{dp, T * pst, pst, Hq, 2 * B, W};
  return launch_wgmma<W, true, false>(qo, ko, vo, qo, doo, lse, dq, dk, dv,
                                      ws, tickets, kvsb, B, T, Hq, Hkv, d, 0,
                                      scale, sms, stream);
}

// bf16 rows read in place: by TMA (load 0) or cp.async of `load` bytes
template <int W>
int launch_bf16(const Operand& q, const Operand& k, const Operand& v,
                const Operand& o, const Operand& dout, const float* lse,
                void* dq, void* dk, void* dv, float* ws, int* tickets,
                long long kvsb, int B, int T, int Hq, int Hkv, int d,
                int load, float scale, int sms, cudaStream_t stream) {
  if (load)
    return launch_wgmma<W, false, true>(q, k, v, o, dout, lse, dq, dk, dv,
                                        ws, tickets, kvsb, B, T, Hq, Hkv, d,
                                        load, scale, sms, stream);
  return launch_wgmma<W, false, false>(q, k, v, o, dout, lse, dq, dk, dv, ws,
                                       tickets, kvsb, B, T, Hq, Hkv, d, 0,
                                       scale, sms, stream);
}

// Whether x's rows start and step on multiples of `bytes`
inline bool rows_aligned(const Operand& x, int bytes) {
  return reinterpret_cast<uintptr_t>(x.x) % bytes == 0
         && x.sb * 2 % bytes == 0 && x.st * 2 % bytes == 0
         && x.d * 2 % bytes == 0;
}

}  // namespace

// The floats of f32 scratch and the int32 tickets flash_attn_bwd takes for
// these shapes and type on the current device, the splits of each kv
// head's query heads, and whether the dK/dV items pair key tiles (the
// D = 256 bf16 plan): out[0] .. out[3] (the float32 path's bf16 planes
// are the caller's too, 2 B T (2 Hq + 2 Hkv) D elements). Returns a
// cudaError_t.
extern "C" int flash_attn_bwd_scratch(int B, int T, int Hq, int Hkv, int D,
                                      int f32, long long* out) {
  out[0] = out[1] = out[2] = out[3] = 0;
  if (B < 0 || T < 0 || Hkv < 1 || Hq < Hkv || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  int sms;
  const int err = sm_count(&sms);
  if (err) return err;
  const Scratch s = scratch_of(B, T, Hq, Hkv, D, f32, sms);
  out[0] = s.floats;
  out[1] = s.tickets;
  out[2] = s.splits;
  out[3] = s.pairs;
  return 0;
}

// q [B, T, Hq, d], k/v [B, >=T, Hkv, d], o and dout [B, T, Hq, d] with
// element strides (batch, token) given and heads and d contiguous; lse
// (K13's, flash_attn with its lse) f32 [B, Hq, T]; dq [B, T, Hq, d]
// contiguous; dk, dv [B, S, Hkv, d] contiguous with batch stride kvsb = S
// * Hkv * d (rows < T written), all in the inputs' type. W (64, 128 or
// 256) is the kernels' head_dim template, d <= W the true head_dim (the
// kernels' tiles hold zeros in columns d .. W), scale 1/sqrt(d); ws and
// tickets as flash_attn_bwd_scratch sizes them (tickets 0 on entry, left
// at 0). f32 = 0: bf16 tensors read in place, `load` says how: 0 by TMA
// (d % 8 == 0, 16-byte aligned rows and strides), 8 or 4 by the
// producers' cp.async of that many bytes (d even, d % 4 == 0 for 8; rows
// and strides aligned to them); planes is not read. f32 = 1: float32
// tensors; planes: bf16 scratch of 2 B T (2 Hq + 2 Hkv) W elements,
// 16-byte aligned, for the split pass; load is not read. Launches the
// split pass (float32), the dQ kernel, then the dK/dV kernel. Returns a
// cudaError_t.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const float* lse, void* planes, void* dq,
                              void* dk, void* dv, float* ws, int* tickets,
                              long long qsb, long long qst, long long ksb,
                              long long kst, long long vsb, long long vst,
                              long long osb, long long ost, long long dsb,
                              long long dst, long long kvsb, int B, int T,
                              int Hq, int Hkv, int W, int d, int f32,
                              int load, float scale, void* stream) {
  if (B < 0 || T < 0 || Hkv < 1 || Hq < Hkv || Hq % Hkv || B > 65535
      || Hq > 65535 || d < 1 || d > W)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  int sms;
  const int err = sm_count(&sms);
  if (err) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  if (f32) {
    auto* pl = static_cast<__nv_bfloat16*>(planes);
    if (pl == nullptr) return (int)cudaErrorInvalidValue;
    if (W == 64)
      return launch_f32<64>(q, k, v, o, dout, lse, dq, dk, dv, ws, tickets,
                            pl, qsb, qst, ksb, kst, vsb, vst, osb, ost, dsb,
                            dst, kvsb, B, T, Hq, Hkv, d, scale, sms, st);
    if (W == 128)
      return launch_f32<128>(q, k, v, o, dout, lse, dq, dk, dv, ws, tickets,
                             pl, qsb, qst, ksb, kst, vsb, vst, osb, ost, dsb,
                             dst, kvsb, B, T, Hq, Hkv, d, scale, sms, st);
    if (W == 256)
      return launch_f32<256>(q, k, v, o, dout, lse, dq, dk, dv, ws, tickets,
                             pl, qsb, qst, ksb, kst, vsb, vst, osb, ost, dsb,
                             dst, kvsb, B, T, Hq, Hkv, d, scale, sms, st);
    return (int)cudaErrorInvalidValue;
  }
  const Operand qo{q, qsb, qst, Hq, B, d}, ko{k, ksb, kst, Hkv, B, d},
      vo{v, vsb, vst, Hkv, B, d}, oo{o, osb, ost, Hq, B, d},
      doo{dout, dsb, dst, Hq, B, d};
  if (load && ((load != 4 && load != 8) || !rows_aligned(qo, load)
               || !rows_aligned(ko, load) || !rows_aligned(vo, load)
               || !rows_aligned(oo, load) || !rows_aligned(doo, load)))
    return (int)cudaErrorInvalidValue;
  if (W == 64)
    return launch_bf16<64>(qo, ko, vo, oo, doo, lse, dq, dk, dv, ws, tickets,
                           kvsb, B, T, Hq, Hkv, d, load, scale, sms, st);
  if (W == 128)
    return launch_bf16<128>(qo, ko, vo, oo, doo, lse, dq, dk, dv, ws,
                            tickets, kvsb, B, T, Hq, Hkv, d, load, scale, sms,
                            st);
  if (W == 256)
    return launch_bf16<256>(qo, ko, vo, oo, doo, lse, dq, dk, dv, ws,
                            tickets, kvsb, B, T, Hq, Hkv, d, load, scale, sms,
                            st);
  return (int)cudaErrorInvalidValue;
}
