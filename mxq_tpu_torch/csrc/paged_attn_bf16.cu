// K12: one-token GQA decode attention over the bf16 paged KV pool.
//
// Replaces the upstream Pallas TPU kernel that mxq_tpu/serving/paged.py
// paged_attend (:265) calls for a bf16 pool with head_dim % 128 == 0
// (:287-298): jax/experimental/pallas/ops/tpu/paged_attention/
// paged_attention_kernel.py paged_attention (:376, pallas_call :628),
// once per layer per decode substep of PagedEngine at --kv_bits 32. It
// computes what mxq_tpu's reference (_paged_attend_reference, :301-318)
// computes, per batch row b and query head:
//   s   = (q . k[r]) / sqrt(D)      f32, rows r < lengths[b] of b's pages
//   p   = softmax(s)                f32
//   ctx = sum_r p[r] * v[r]         f32, written in q's type
// mxq_tpu's TPU route pre-scales q by 1/sqrt(D) and rounds it to q's type
// before the kernel; its CPU reference, which this follows, divides the
// f32 scores.
//
// Pool layout (serving/paged.py, folded): k/v pages [Hkv, LP, ps, d]
// bf16, tables [B, pps] int32 physical page ids, any page size. q and the
// output are [B, Hkv * Gtot, d] in one type, bf16 or float32, read and
// written at their width d; a launch takes Gtot's heads g0 .. g0 + G - 1
// of each kv head (G <= 16; G <= 8 at D = 256). The kernel is a template
// at D = 64, 128 or 256 (d <= D) and at GT = 1, 2, 4, 8 or 16 query heads
// (G <= GT, the heads past G masked; GT <= 8 at D = 256, where a lane
// group holds GT x D of q and of the context in registers, 128 floats a
// lane at GT = 8): its shared tiles are zero past column d, so narrower
// pages are read in place and give zero context columns past d. At D =
// 256 a tile is 16 rows and a lane group one warp (8 columns a lane).
//
// Bound on the H100: bytes. Every K and V row below the length is read
// once (2 * d * 2 bytes per (b, kv head, row)) for 4 * G * d operations:
// at G = 1 one flop per byte, far below the card's ~295. What decides is
// the bytes in flight, and each work item's chain of latencies kept out
// of the copies' way.
//
// Design:
// - Persistent blocks over a work list. The host sizes the grid from the
//   built kernel's occupancy (fixed under graph capture); each block walks
//   the items blockIdx.x, + gridDim.x, ... of a list it derives on the
//   device from lengths: per (b, kv head) ceil(n / SPLIT) splits of SPLIT
//   history rows, n = min(max(lengths[b], 0), pps * ps), or one item that
//   writes zeros where n is 0. Only live splits are visited. Split
//   boundaries follow from the row's own length alone.
// - A ring of STAGES tiles of TR rows of K and V (8 KB each) under
//   mbarriers, filled by one producer warp while four consumer warps work
//   on earlier tiles, across item boundaries. A tile's rows go by 1-D bulk
//   copies: one per run of rows within a page where the pages are D wide,
//   one per row where they are narrower; where d is not a multiple of 8
//   or the pool's start is not 16-byte aligned, by cp.async (8 or 4
//   bytes) or plain loads, the same ladder of widths as before. Only rows
//   below the length are copied, so no page past ceil(n / ps) is touched.
//   The item's q comes with its first tile, by cp.async in q's type.
//   Consumers take their rows of a tile into registers and release the
//   stage before they compute, so the ring turns over at the copies'
//   pace, not the arithmetic's.
// - Consumers: a lane group of D / CPL lanes takes a row (16-byte shared
//   loads, bf16 pairs unpacked to f32) and dots it with the GT heads of q
//   held in registers; the RG rows x GT heads of a step are
//   reduce-scattered over the group's lanes, so each lane divides by
//   sqrt(D) and exponentiates one or two (row, head) scores and the
//   probabilities go back by shuffles. Each lane group keeps its own
//   online softmax over rows lg, lg + NLG, ... of every tile; rows at or
//   past the tile's live rows (stale or never copied) are selected away,
//   never multiplied by 0 (NaN * 0 is NaN). At the item's end the lane
//   groups of a warp merge by a butterfly, the warps in order, so a
//   split's partial is the same bits wherever and whenever it runs.
// - A single split writes ctx / l. Otherwise each split writes its (m_j,
//   l_j, partial context) to a scratch, and the last of the (b, kv head)'s
//   splits to finish (an atomic ticket, reset to 0 by that block, as
//   attn_split.cuh's values_kernel) combines them in split order, one warp
//   a head, lanes over the splits: ctx = sum_j exp(m_j - M) ctx_j / sum_j
//   exp(m_j - M) l_j, M = max_j m_j. The result is the same bits on every
//   run, in a replayed graph too, and does not depend on the other rows'
//   lengths, the batch or the grid.
// expf and IEEE division, no fast math: the float32 gate is 1e-5.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "device_util.cuh"
#include "hopper_util.cuh"

constexpr int NCW = 4;                   // consumer warps
constexpr int THREADS = 32 * (NCW + 1);  // and one producer warp
constexpr int SPLIT = 256;               // history rows per work item
constexpr int STAGES = 2;                // tiles of the ring
constexpr int TILE_BYTES = 8192;         // one K (or V) tile
constexpr int GMAX = 16;                 // query heads of a launch
constexpr int GMAX_256 = 8;              // and at D = 256
// a full barrier's arrivals per phase: the producer's lane 0 (with the
// bulk copies' bytes) and then each of its 32 lanes
constexpr int FULL_ARRIVALS = 33;
constexpr int HDR = 8;                   // ints of a tile's header

struct Args {
  const void* q;                         // [B, Hkv * Gtot, d]
  const __nv_bfloat16* kp;               // [Hkv, LP, ps, d]
  const __nv_bfloat16* vp;
  const int* lengths;                    // [B]
  const int* tables;                     // [B, pps]
  void* out;                             // [B, Hkv * Gtot, d], q's type
  float* ws;      // maxima [BHG, NS], sums [BHG, NS], contexts [BHG, NS, D]
  int* tickets;                          // [B * Hkv], 0 between calls
  int B, Hkv, Gtot, g0, G, d, LP, ps, pps, NS;
  int qf32;                              // q and out float32, else bf16
  int copy;                              // 0: bulk copies; else the ladder's
                                         // elements a copy (4, 2 or 1)
  int qcopy;                             // bytes a cp.async of q: 16 or 4
                                         // (0: plain loads)
  float sqrt_d;
};

// dynamic shared memory of the <D, GT> kernel, in bytes from its start
template <int D, int GT>
struct Layout {
  static constexpr int TR = TILE_BYTES / (2 * D);          // tile rows
  static constexpr size_t K = 0;                           // [STAGES][TR][D]
  static constexpr size_t V = K + (size_t)STAGES * TILE_BYTES;
  // [STAGES][GT * D] elements of q's type (4 bytes each at most)
  static constexpr size_t Q = V + (size_t)STAGES * TILE_BYTES;
  // [NCW][GT][D] f32, then [NCW][GT] twice
  static constexpr size_t RED = Q + (size_t)STAGES * GT * D * 4;
  static constexpr size_t MRED = RED + (size_t)NCW * GT * D * 4;  // [NCW][GT]
  static constexpr size_t LRED = MRED + (size_t)NCW * GT * 4;
  static constexpr size_t HEAD = LRED + (size_t)NCW * GT * 4;  // [STAGES][HDR]
  static constexpr size_t BAR = HEAD + (size_t)STAGES * HDR * 4;  // full, empty
  static constexpr size_t LAST = BAR + (size_t)2 * STAGES * 8;
  static constexpr size_t BYTES = LAST + 16;
};

// a tile's header: batch row, kv head, split, tile of the split, tiles of
// the split, live rows of the tile, splits of (b, kv head), done
enum { H_B, H_H, H_J, H_T, H_NT, H_NV, H_NS, H_DONE };

__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::
                   "r"(smem_addr(bar)) : "memory");
}

// V bf16 elements (2V bytes) from global to shared memory: cp.async for 8
// and 4 bytes, a plain load for one element
template <int V>
__device__ __forceinline__ void cp_elems(__nv_bfloat16* dst,
                                         const __nv_bfloat16* src) {
  if constexpr (V == 1) {
    *dst = *src;
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::
                     "r"(smem_addr(dst)), "l"(src), "n"(2 * V) : "memory");
  }
}

__device__ __forceinline__ int live_rows(const Args& a, int b) {
  return min(max(__ldg(a.lengths + b), 0), a.pps * a.ps);
}

// q and out element offset of (b, kv head h, head g of the launch, 0)
__device__ __forceinline__ size_t head_off(const Args& a, int b, int h,
                                           int g) {
  return (((size_t)b * a.Hkv + h) * a.Gtot + a.g0 + g) * a.d;
}

__device__ __forceinline__ void store_out(const Args& a, size_t i, float x) {
  if (a.qf32)
    static_cast<float*>(a.out)[i] = x;
  else
    static_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16_rn(x);
}

// The producer warp's decode of item `it`: 32 lengths at a time (from
// chunk cb0, whose rows' items start at cbase; both move on and stay, as
// `it` grows), an inclusive scan of each row's items, the first row whose
// running count passes `it`. False past the last item.
__device__ bool find_item(const Args& a, int it, int& cb0, int& cbase,
                          int& b, int& first, int& cnt) {
  const int lane = threadIdx.x & 31;
  while (cb0 < a.B) {
    const int bb = cb0 + lane;
    const int c = bb < a.B
        ? a.Hkv * max(1, (live_rows(a, bb) + SPLIT - 1) / SPLIT) : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    if (it < cbase + total) {
      const int at = __ffs(__ballot_sync(0xffffffffu, cbase + incl > it)) - 1;
      b = cb0 + at;
      cnt = __shfl_sync(0xffffffffu, c, at);
      first = cbase + __shfl_sync(0xffffffffu, incl, at) - cnt;
      return true;
    }
    cb0 += 32;
    cbase += total;
  }
  return false;
}

// rows [ra, rb) of b's history, kv head h, into tiles tk, tv by the
// ladder (V elements a copy, every lane)
template <int D, int V>
__device__ void ladder(const Args& a, __nv_bfloat16* tk, __nv_bfloat16* tv,
                       const int* tab, size_t hbase, int ra, int rb) {
  const int cpr = a.d / V;
  for (int i = threadIdx.x & 31; i < (rb - ra) * cpr; i += 32) {
    const int u = i / cpr, c = i % cpr, r = ra + u;
    const size_t off = ((hbase + __ldg(tab + r / a.ps)) * a.ps + r % a.ps)
                       * a.d + c * V;
    cp_elems<V>(tk + u * D + c * V, a.kp + off);
    cp_elems<V>(tv + u * D + c * V, a.vp + off);
  }
}

// An item of the work list: row b, kv head h, split j of ns, n live rows
// of row b (0: the item writes zeros).
struct Item {
  int b, h, j, ns, n;
};

// item `it` from the scan's cursor (cb0, cbase); false past the last
__device__ __forceinline__ bool decode(const Args& a, int it, int& cb0,
                                       int& cbase, Item& w) {
  int first, cnt;
  if (!find_item(a, it, cb0, cbase, w.b, first, cnt)) return false;
  w.ns = cnt / a.Hkv;
  w.h = (it - first) / w.ns;
  w.j = (it - first) % w.ns;
  w.n = live_rows(a, w.b);
  return true;
}

template <int D, int GT>
__device__ __forceinline__ void produce(const Args& a, unsigned char* smem) {
  using L = Layout<D, GT>;
  constexpr int TR = L::TR;
  const int lane = threadIdx.x & 31;
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem + L::K);
  __nv_bfloat16* sv = reinterpret_cast<__nv_bfloat16*>(smem + L::V);
  int* head = reinterpret_cast<int*>(smem + L::HEAD);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;
  int cb0 = 0, cbase = 0, k = 0;
  Item w;
  for (int it = blockIdx.x; decode(a, it, cb0, cbase, w); it += gridDim.x) {
    const int b = w.b, h = w.h, j = w.j, ns = w.ns, n = w.n;
    if (n == 0) {                        // a row of length <= 0: zeros
      const size_t o = head_off(a, b, h, 0);
      for (int i = lane; i < a.G * a.d; i += 32) store_out(a, o + i, 0.f);
      continue;
    }
    const int r0 = j * SPLIT, nv = min(n - r0, SPLIT);
    const int ntiles = (nv + TR - 1) / TR;
    const int* tab = a.tables + (size_t)b * a.pps;
    const size_t hbase = (size_t)h * a.LP;
    for (int t = 0; t < ntiles; ++t, ++k) {
      const int st = k % STAGES;
      mbar_wait(empty + st, ((k / STAGES) & 1) ^ 1);
      const int ra = r0 + t * TR, rb = min(ra + TR, r0 + nv);
      __nv_bfloat16* tk = sk + (size_t)st * TR * D;
      __nv_bfloat16* tv = sv + (size_t)st * TR * D;
      if (a.copy == 0) {
        if (lane == 0) mbar_expect(full + st, 4u * (rb - ra) * a.d);
        __syncwarp();
        if (a.d == D) {                  // a copy per run within a page
          const int p0 = ra / a.ps, np = (rb - 1) / a.ps - p0 + 1;
          for (int u = lane; u < np; u += 32) {
            const int p = p0 + u;
            const int sa = max(ra, p * a.ps), sb = min(rb, p * a.ps + a.ps);
            const size_t off = ((hbase + __ldg(tab + p)) * a.ps + sa
                                - p * a.ps) * D;
            const uint32_t bytes = 2u * (sb - sa) * D;
            bulk_load(tk + (sa - ra) * D, a.kp + off, bytes, full + st);
            bulk_load(tv + (sa - ra) * D, a.vp + off, bytes, full + st);
          }
        } else {                         // a copy per row
          for (int r = ra + lane; r < rb; r += 32) {
            const size_t off = ((hbase + __ldg(tab + r / a.ps)) * a.ps
                                + r % a.ps) * a.d;
            bulk_load(tk + (r - ra) * D, a.kp + off, 2u * a.d, full + st);
            bulk_load(tv + (r - ra) * D, a.vp + off, 2u * a.d, full + st);
          }
        }
      } else {
        if (lane == 0) mbar_arrive(full + st);
        if (a.copy == 4)
          ladder<D, 4>(a, tk, tv, tab, hbase, ra, rb);
        else if (a.copy == 2)
          ladder<D, 2>(a, tk, tv, tab, hbase, ra, rb);
        else
          ladder<D, 1>(a, tk, tv, tab, hbase, ra, rb);
      }
      if (t == 0) {                      // the item's q, in its own type
        const int es = a.qf32 ? 4 : 2;
        const char* src = static_cast<const char*>(a.q)
                          + head_off(a, b, h, 0) * es;
        char* dst = reinterpret_cast<char*>(smem + L::Q)
                    + (size_t)st * GT * D * 4;
        const int nb = a.G * a.d * es;
        if (a.qcopy == 16) {
          for (int i = lane * 16; i < nb; i += 32 * 16)
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
                             "r"(smem_addr(dst + i)), "l"(src + i)
                             : "memory");
        } else if (a.qcopy == 4) {
          for (int i = lane * 4; i < nb; i += 32 * 4)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
                             "r"(smem_addr(dst + i)), "l"(src + i)
                             : "memory");
        } else {
          for (int i = lane * 2; i < nb; i += 32 * 2)
            *reinterpret_cast<uint16_t*>(dst + i) =
                *reinterpret_cast<const uint16_t*>(src + i);
        }
      }
      cp_async_arrive(full + st);
      if (lane == 0) {
        int* hd = head + st * HDR;
        hd[H_B] = b; hd[H_H] = h; hd[H_J] = j; hd[H_T] = t;
        hd[H_NT] = ntiles; hd[H_NV] = rb - ra; hd[H_NS] = ns;
        hd[H_DONE] = 0;
      }
      mbar_arrive(full + st);
    }
  }
  const int st = k % STAGES;             // the consumers' stop
  mbar_wait(empty + st, ((k / STAGES) & 1) ^ 1);
  if (lane == 0) {
    head[st * HDR + H_DONE] = 1;
    mbar_arrive(full + st);
  }
  mbar_arrive(full + st);
}

// CPL bf16 of shared memory (a 16- or 8-byte load) as bf16 pairs
template <int CPL>
__device__ __forceinline__ void load_raw(uint32_t (&u)[CPL / 2],
                                         const __nv_bfloat16* p) {
  if constexpr (CPL == 8) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    u[0] = w.x; u[1] = w.y; u[2] = w.z; u[3] = w.w;
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    u[0] = w.x; u[1] = w.y;
  }
}

// bf16 pairs as f32
template <int CPL>
__device__ __forceinline__ void unpack(float (&x)[CPL],
                                       const uint32_t (&u)[CPL / 2]) {
#pragma unroll
  for (int i = 0; i < CPL / 2; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// x[U] summed over the lanes of a lane group (O = half its lanes) and
// scattered: while two or more units are left, a lane keeps one half and
// adds its partner's copy of that half (the upper half where its lane bit
// O is set), then the last unit goes by a butterfly. Lane li of the group
// ends with the sums of units (li / REP) * NF .. + NF - 1 in x[0 .. NF),
// NF = max(1, U / lanes), REP = max(1, lanes / U), each sum in a fixed
// order, so every copy of a unit has the same bits.
template <int O, int N, int U>
__device__ __forceinline__ void reduce_scatter(float (&x)[U], int li) {
  if constexpr (O >= 1) {
    if constexpr (N > 1) {
      const bool up = li & O;
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        const float send = up ? x[k] : x[k + N / 2];
        const float keep = up ? x[k + N / 2] : x[k];
        x[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      reduce_scatter<O / 2, N / 2, U>(x, li);
    } else {
      x[0] += __shfl_xor_sync(0xffffffffu, x[0], O);
      reduce_scatter<O / 2, 1, U>(x, li);
    }
  }
}

// ctx[b, h, g, c] of a row of ns > 1 splits from their partials, by one
// warp per head g: each lane takes splits lane, lane + 32, ...: M = the
// splits' max, f_j = exp(m_j - M), l = sum_j f_j l_j (the lanes' sums in
// a fixed butterfly), then column c's sum_j f_j ctx_j[c] in split order
// with f_j from its lane, the loads of 8 splits in flight at once.
template <int D>
__device__ __forceinline__ void combine(const Args& a, int b, int h, int g,
                                        int c, int ns) {
  const int lane = threadIdx.x & 31;
  const size_t bhg = (size_t)a.B * a.Hkv * a.G;
  const size_t br = ((size_t)b * a.Hkv + h) * a.G + g;
  const float* mj = a.ws + br * a.NS;
  const float* lj = a.ws + bhg * a.NS + br * a.NS;
  const float* cj = a.ws + 2 * bhg * a.NS + br * a.NS * D + c;
  float mx = -INFINITY;
  for (int j = lane; j < ns; j += 32) mx = fmaxf(mx, __ldcg(mj + j));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float x = 0.f, y = 0.f;
  for (int j0 = 0; j0 < ns; j0 += 32) {
    const int j = j0 + lane, nj = min(32, ns - j0);
    const float f = j < ns && mx > -INFINITY
        ? expf(__ldcg(mj + j) - mx) : 0.f;
    if (j < ns) y = fmaf(__ldcg(lj + j), f, y);
#pragma unroll 8
    for (int k = 0; k < nj; ++k)
      x = fmaf(__ldcg(cj + (size_t)(j0 + k) * D),
               __shfl_sync(0xffffffffu, f, k), x);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) y += __shfl_xor_sync(0xffffffffu, y, o);
  if (c < a.d) store_out(a, head_off(a, b, h, g) + c, y > 0.f ? x / y : 0.f);
}

// The end of an item: the lane groups' online softmaxes merged (a warp's
// by a butterfly over their lane bits, then the warps in order), then
// ctx / l written, or the split's partial to the scratch and, by the last
// split of (b, h), the splits combined in order.
template <int D, int GT, int CPL, int LPR>
__device__ __forceinline__ void finish(const Args& a, unsigned char* smem,
                                       int b, int h, int j, int ns,
                                       float (&acc)[GT][CPL], float (&m)[GT],
                                       float (&l)[GT]) {
  using L = Layout<D, GT>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mn = fmaxf(m[g], __shfl_xor_sync(0xffffffffu, m[g], o));
      const float f = m[g] == -INFINITY ? 0.f : expf(m[g] - mn);
      m[g] = mn;
      l[g] *= f;
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        acc[g][c] *= f;
        acc[g][c] += __shfl_xor_sync(0xffffffffu, acc[g][c], o);
      }
    }
  }
  float* red = reinterpret_cast<float*>(smem + L::RED);
  float* mred = reinterpret_cast<float*>(smem + L::MRED);
  float* lred = reinterpret_cast<float*>(smem + L::LRED);
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        red[(warp * GT + g) * D + lane * CPL + c] = acc[g][c];
      if (lane == 0) {
        mred[warp * GT + g] = m[g];
        lred[warp * GT + g] = l[g];
      }
    }
  }
  named_sync(1, NCW * 32);
  const size_t bh = (size_t)b * a.Hkv + h;
  const size_t bhg = (size_t)a.B * a.Hkv * a.G;
  float* wmax = a.ws;
  float* wsum = wmax + bhg * a.NS;
  float* wctx = wsum + bhg * a.NS;
  for (int i = tid; i < a.G * D; i += NCW * 32) {
    const int g = i / D, c = i % D;
    float mw = -INFINITY;
#pragma unroll
    for (int w = 0; w < NCW; ++w) mw = fmaxf(mw, mred[w * GT + g]);
    float x = 0.f, y = 0.f;
#pragma unroll
    for (int w = 0; w < NCW; ++w) {
      const float mv = mred[w * GT + g];
      const float f = mv == -INFINITY ? 0.f : expf(mv - mw);
      x = fmaf(red[(w * GT + g) * D + c], f, x);
      y = fmaf(lred[w * GT + g], f, y);
    }
    if (ns == 1) {
      if (c < a.d)
        store_out(a, head_off(a, b, h, g) + c, y > 0.f ? x / y : 0.f);
    } else {
      const size_t br = bh * a.G + g;
      wctx[(br * a.NS + j) * D + c] = x;
      if (c == 0) {
        wmax[br * a.NS + j] = mw;
        wsum[br * a.NS + j] = y;
      }
    }
  }
  if (ns > 1) {
    int* last = reinterpret_cast<int*>(smem + L::LAST);
    __threadfence();
    named_sync(1, NCW * 32);
    if (tid == 0) *last = atomicAdd(a.tickets + bh, 1) == ns - 1;
    named_sync(1, NCW * 32);
    if (*last) {
      __threadfence();
      for (int i0 = 0; i0 < a.G * D; i0 += NCW * 32) {
        const int i = i0 + tid, g = i / D, c = i % D;   // g: one a warp
        if (g < a.G) combine<D>(a, b, h, g, c, ns);
      }
      if (tid == 0) a.tickets[bh] = 0;
    }
  }
  named_sync(1, NCW * 32);               // red and last free again
}

template <int D, int GT>
__device__ __forceinline__ void consume(const Args& a, unsigned char* smem) {
  using L = Layout<D, GT>;
  constexpr int TR = L::TR;
  // columns a lane reads: 8, or 4 where GT heads of q and the context
  // would outgrow the registers (GT >= 8 at D <= 128)
  constexpr int CPL = GT >= 8 && D <= 128 ? 4 : 8;
  constexpr int LPR = D / CPL;           // lanes of a row (a lane group)
  constexpr int NLG = NCW * 32 / LPR;    // lane groups
  constexpr int R = TR / NLG;            // rows of a lane group per tile
  constexpr int RG = R < 16 / GT ? R : (16 / GT > 1 ? 16 / GT : 1);
  static_assert(R % RG == 0 && TR % NLG == 0, "rows split evenly");
  const int tid = threadIdx.x, lane = tid & 31;
  const int lg = tid / LPR, c0 = (lane % LPR) * CPL;
  const __nv_bfloat16* sk = reinterpret_cast<const __nv_bfloat16*>(smem + L::K);
  const __nv_bfloat16* sv = reinterpret_cast<const __nv_bfloat16*>(smem + L::V);
  const int* head = reinterpret_cast<const int*>(smem + L::HEAD);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;
  // a step's units u = i * GT + g (row i of the step, head g), U of them;
  // after the reduce-scatter lane li of a group holds units u0 .. u0 + NF
  // - 1, u0 = (li / REP) * NF: one row, NF heads; lanes SR apart hold the
  // same heads of the step's other rows
  constexpr int U = RG * GT;
  constexpr int NF = U >= LPR ? U / LPR : 1;
  constexpr int REP = U >= LPR ? 1 : LPR / U;
  constexpr int SR = GT * REP / NF;
  const int li = lane % LPR, base = lane - li;
  const int u0 = (li / REP) * NF, i0 = u0 / GT;
  // the state: context columns of every head; the max and the partial sum
  // of exp over this lane's rows, of its NF heads
  float q[GT][CPL], acc[GT][CPL], m[NF], l[NF];
  for (int k = 0;; ++k) {
    const int st = k % STAGES;
    mbar_wait(full + st, (k / STAGES) & 1);
    const int* hd = head + st * HDR;
    if (hd[H_DONE]) break;
    const int b = hd[H_B], h = hd[H_H], j = hd[H_J], t = hd[H_T];
    const int ntiles = hd[H_NT], nvt = hd[H_NV], ns = hd[H_NS];
    if (t == 0) {                        // the item's q, zero past d and G
      const char* qs = reinterpret_cast<const char*>(smem + L::Q)
                       + (size_t)st * GT * D * 4;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int i = g * a.d + c0 + c;
          q[g][c] = g >= a.G || c0 + c >= a.d ? 0.f
              : a.qf32 ? reinterpret_cast<const float*>(qs)[i]
                       : __bfloat162float(
                             reinterpret_cast<const __nv_bfloat16*>(qs)[i]);
          acc[g][c] = 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < NF; ++e) {
        m[e] = -INFINITY;
        l[e] = 0.f;
      }
    }
    // the lane's rows of the tile into registers, then the stage released
    uint32_t kr[R][CPL / 2], vr[R][CPL / 2];
    {
      const __nv_bfloat16* tk = sk + (size_t)st * TR * D + c0;
      const __nv_bfloat16* tv = sv + (size_t)st * TR * D + c0;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        load_raw<CPL>(kr[i], tk + (lg + NLG * i) * D);
        load_raw<CPL>(vr[i], tv + (lg + NLG * i) * D);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
#pragma unroll
    for (int sg = 0; sg < R; sg += RG) {
      float x[U];                        // the lane's partial dots
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        float kf[CPL];
        unpack<CPL>(kf, kr[sg + i]);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float p = 0.f;
#pragma unroll
          for (int c = 0; c < CPL; ++c) p = fmaf(q[g][c], kf[c], p);
          x[i * GT + g] = p;
        }
      }
      reduce_scatter<LPR / 2, U, U>(x, li);
      // the lane's scores (stale rows -inf), the step's max of each head,
      // the online softmax step of the lane's heads
      const bool live = lg + NLG * (sg + i0) < nvt;
      float f[NF], p[NF];
#pragma unroll
      for (int e = 0; e < NF; ++e) {
        const float sc = live ? x[e] / a.sqrt_d : -INFINITY;
        float mt = sc;
#pragma unroll
        for (int o = SR; o < LPR; o <<= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        const float mn = fmaxf(m[e], mt);
        f[e] = mn == -INFINITY ? 1.f : expf(m[e] - mn);
        p[e] = mn == -INFINITY ? 0.f : expf(sc - mn);
        m[e] = mn;
        l[e] = fmaf(l[e], f[e], p[e]);
      }
      // every head's factor and every unit's probability to every lane
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float fg = __shfl_sync(0xffffffffu, f[g % NF],
                                     base + (g / NF) * REP);
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[g][c] *= fg;
      }
#pragma unroll
      for (int i = 0; i < RG; ++i) {     // P . V over the live rows
        float pu[GT];
#pragma unroll
        for (int g = 0; g < GT; ++g)
          pu[g] = __shfl_sync(0xffffffffu, p[(i * GT + g) % NF],
                              base + ((i * GT + g) / NF) * REP);
        const int r = lg + NLG * (sg + i);
        if (r < nvt) {
          float vf[CPL];
          unpack<CPL>(vf, vr[sg + i]);
#pragma unroll
          for (int g = 0; g < GT; ++g)
#pragma unroll
            for (int c = 0; c < CPL; ++c)
              acc[g][c] = fmaf(pu[g], vf[c], acc[g][c]);
        }
      }
    }
    if (t == ntiles - 1) {
      // the lane group's sums over its rows, then every head's max and
      // sum to every lane of the group
      float ma[GT], la[GT];
#pragma unroll
      for (int e = 0; e < NF; ++e)
#pragma unroll
        for (int o = SR; o < LPR; o <<= 1)
          l[e] += __shfl_xor_sync(0xffffffffu, l[e], o);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        ma[g] = __shfl_sync(0xffffffffu, m[g % NF], base + (g / NF) * REP);
        la[g] = __shfl_sync(0xffffffffu, l[g % NF], base + (g / NF) * REP);
      }
      finish<D, GT, CPL, LPR>(a, smem, b, h, j, ns, acc, ma, la);
    }
  }
}

template <int D, int GT>
__global__ void __launch_bounds__(THREADS) paged_bf16_kernel(const Args a) {
  using L = Layout<D, GT>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  const int tid = threadIdx.x;
  if (tid < STAGES) {
    mbar_init(full + tid, FULL_ARRIVALS);
    mbar_init(full + STAGES + tid, NCW);
  }
  if (a.d < D) {   // columns d.. of every tile, which no copy writes
    __nv_bfloat16* t = reinterpret_cast<__nv_bfloat16*>(smem + L::K);
    const int w = D - a.d;
    for (int i = tid; i < 2 * STAGES * L::TR * w; i += THREADS)
      t[(i / w) * D + a.d + i % w] = __float2bfloat16(0.f);
  }
  mbar_init_fence();
  __syncthreads();
  if (tid >= NCW * 32)
    produce<D, GT>(a, smem);
  else
    consume<D, GT>(a, smem);
}

// blocks of the <D, GT> kernel one SM holds at once
template <int D, int GT>
int blocks_per_sm(int* n) {
  auto kern = paged_bf16_kernel<D, GT>;
  const int bytes = (int)Layout<D, GT>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kern, THREADS,
                                                        bytes);
  return (int)err;
}

template <int D, int GT>
int launch(const Args& a, void* stream) {
  static int resident = 0;               // blocks the card holds at once
  auto kern = paged_bf16_kernel<D, GT>;
  constexpr int bytes = (int)Layout<D, GT>::BYTES;
  int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = (int)cudaGetDevice(&dev))
        || (err = (int)cudaDeviceGetAttribute(
                &sms, cudaDevAttrMultiProcessorCount, dev))
        || (err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kern, THREADS, bytes)))
      return err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident = per_sm * sms;
  }
  const long long most = (long long)a.B * a.Hkv * a.NS;
  const int grid = (int)(most < resident ? most : resident);
  kern<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_heads(const Args& a, void* stream) {
  if (a.G <= 1) return launch<D, 1>(a, stream);
  if (a.G <= 2) return launch<D, 2>(a, stream);
  if (a.G <= 4) return launch<D, 4>(a, stream);
  if constexpr (D > 128) {
    return launch<D, 8>(a, stream);
  } else {
    if (a.G <= 8) return launch<D, 8>(a, stream);
    return launch<D, 16>(a, stream);
  }
}

}  // namespace

// q [B, Hkv * Gtot, d] (float32 if qf32, else bf16), contiguous; k/v pages
// [Hkv, LP, ps, d] bf16, d <= D; lengths [B]; tables [B, pps] physical
// page ids; query heads g0 .. g0 + G - 1 of each kv head (G <= 16, and
// G <= 8 at D = 256); D the template (64, 128 or 256); ws
// the scratch of B * Hkv * G * NS * (D + 2) floats, NS = ceil(pps * ps /
// 256); tickets [B * Hkv] int32, 0 between calls; out shaped and typed as
// q (only the launch's heads written). Returns a cudaError_t.
extern "C" int paged_attn_bf16(const void* q, int qf32, const void* kp,
                               const void* vp, const void* lengths,
                               const void* tables, int B, int Hkv, int Gtot,
                               int g0, int G, int D, int d, int LP, int ps,
                               int pps, float sqrt_d, void* ws, void* tickets,
                               void* out, void* stream) {
  if (B < 0 || Hkv < 1 || G < 1 || G > (D > 128 ? GMAX_256 : GMAX)
      || g0 < 0 || g0 + G > Gtot
      || d < 1 || d > D || LP < 1 || ps < 1 || pps < 1
      || (long long)pps * ps > (1 << 30)
      || (long long)B * Hkv * ((pps * (long long)ps + SPLIT - 1) / SPLIT)
             > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a{q, (const __nv_bfloat16*)kp, (const __nv_bfloat16*)vp,
         (const int*)lengths, (const int*)tables, out, (float*)ws,
         (int*)tickets, B, Hkv, Gtot, g0, G, d, LP, ps, pps,
         (pps * ps + SPLIT - 1) / SPLIT, qf32 != 0, 0, 0, sqrt_d};
  // bulk copies where rows are 16-byte multiples on a 16-byte aligned
  // pool; else the widest cp.async that divides a row and keeps both
  // pools aligned to it
  const uintptr_t starts = (uintptr_t)kp | (uintptr_t)vp;
  if (d % 8 || starts % 16) {
    int v = 4;
    while (v > 1 && (d % v || starts % (2 * v))) v >>= 1;
    a.copy = v;
  }
  // q's heads by 16- or 4-byte cp.async where its rows and start allow
  const int row = d * (qf32 ? 4 : 2);
  const uintptr_t qs = (uintptr_t)q;
  a.qcopy = row % 16 == 0 && qs % 16 == 0 ? 16
            : row % 4 == 0 && qs % 4 == 0 ? 4 : 0;
  switch (D) {
    case 64: return launch_heads<64>(a, stream);
    case 128: return launch_heads<128>(a, stream);
    case 256: return launch_heads<256>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// blocks of the kernel at head_dim template D and G query heads that one
// SM holds at once (the wrapper's and chip_smoke's report; G past a
// launch's most, 16 or at D = 256 8, counts as that most). Returns a
// cudaError_t.
extern "C" int paged_attn_bf16_blocks(int D, int G, int* blocks) {
  if (G < 1 || G > GMAX || (D != 64 && D != 128 && D != 256))
    return (int)cudaErrorInvalidValue;
  if (D == 256) {
    if (G <= 1) return blocks_per_sm<256, 1>(blocks);
    if (G <= 2) return blocks_per_sm<256, 2>(blocks);
    if (G <= 4) return blocks_per_sm<256, 4>(blocks);
    return blocks_per_sm<256, 8>(blocks);
  }
  const int gt = G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : G <= 8 ? 8 : 16;
  switch (D * 32 + gt) {
    case 64 * 32 + 1: return blocks_per_sm<64, 1>(blocks);
    case 64 * 32 + 2: return blocks_per_sm<64, 2>(blocks);
    case 64 * 32 + 4: return blocks_per_sm<64, 4>(blocks);
    case 64 * 32 + 8: return blocks_per_sm<64, 8>(blocks);
    case 64 * 32 + 16: return blocks_per_sm<64, 16>(blocks);
    case 128 * 32 + 1: return blocks_per_sm<128, 1>(blocks);
    case 128 * 32 + 2: return blocks_per_sm<128, 2>(blocks);
    case 128 * 32 + 4: return blocks_per_sm<128, 4>(blocks);
    case 128 * 32 + 8: return blocks_per_sm<128, 8>(blocks);
    default: return blocks_per_sm<128, 16>(blocks);
  }
}
