// K4 family: GQA decode attention over the int8 KV cache of one layer of
// the stacked cache, one template with two compile-time flags:
//   CUR=1, WRITE=1  K4   the current token folded in out of cache and its
//                        K/V code rows written into the cache in place
//   CUR=0, WRITE=0  K4a  rows s <= pos + t for query token t of T, no
//                        current token (K4c: the same launch, the layer
//                        read out of the stack); T > 1 is the speculative
//                        verify, all of its queries in one launch
//   CUR=1, WRITE=0  K4b  rows s < pos plus the current token, no write
//                        (K4d: the same launch on the stack)
//
// Replaces the TPU kernels in mxq_tpu/ops/attn_int8.py: _kernel_cur_write
// (:318) via int8_decode_attention_fused_write (:449), dispatched by
// decode_attend_update (:1149); _kernel (:97, int8_decode_attention :491)
// and _stacked_kernel (:232, int8_decode_attention_stacked :287), which the
// engine's speculative verify runs once per query (here: once for all T);
// _kernel_cur (:154, int8_decode_attention_cur :201) and the kernel of
// _attn_call_cur_folded (:1045, int8_decode_attention_cur_folded :1123).
// The TPU's 8-row octet write windows, aliased outputs, g8 = max(8, G)
// padding and folded-stack reshapes were Mosaic devices; here a layer of
// the stack is a pointer offset and the code rows are stored directly at
// row pos[b].
//
// Math per (batch b, kv head h), query row (t, g), p = pos[b] (_attend,
// attn_int8.py:50-94):
//   st[s] = (q . kc[s]) * (ks[s] * scale)   rows s < p (CUR) or <= p + t
//   stc   = (q . kcur)  * (kscur * scale)   the current token (CUR)
//   m = max(st, stc); e = exp(st - m); ec = exp(stc - m)
//   ctx = (sum_s bf16(e*vs[s]) * vc[s] + bf16(ec*vscur) * vcur)
//         / (sum_s e + ec)
// q is bf16; p*v_scale is rounded to bf16 against the GLOBAL max before
// the V sum for cache rows and the current row alike (attn_int8.py:81,91).
// expf, not fast math.
//
// Bound on the H100: bytes — every attended code row is read once (2*D
// bytes per row per (b, h)), with two multiply-adds per byte. The design
// (attn_split.cuh): the history is split over blocks of 128 rows, pass A
// writes every score and each split's max, pass B rounds against the
// global max of all splits (known only then) and forms the split's
// partial sums, and the last block of each (b, h) adds the splits in
// order. 16-byte code loads, all in flight before the arithmetic. The K4
// write is a direct store by split 0's block: row pos is never read.

#include "attn_split.cuh"

// q [B, Tq, Hkv, Gq, D] bf16, of which the launch attends tokens t0 ..
// t0 + T - 1 and query heads g0 .. g0 + G - 1 of each kv head (G T <=
// 64), their context written into the same rows of out; kc/vc
// [B, Hkv, S, D] int8 and ks/vs [B, Hkv, S] bf16 (one layer); kcur/vcur
// [B, Hkv, D], kscur/vscur [B, Hkv] (read only when cur); positions [B]
// (of token t0); ws the scratch of attn_split::carve with NS = ceil(S /
// 128); tickets [B * Hkv] int32, 0 between calls; out [B, Tq, Hkv, Gq, D]
// f32. cur, write: K4 1, 1; K4a/K4c 0, 0; K4b/K4d 1, 0.
// D: any head_dim 1..256 (attn_split.cuh: 64, 128 and 256 at their
// templates, the others in place at the next); vec: bytes a code load
// (16, 4 or 1), dividing D and the alignment of every code tensor's start
// (16 at D = 64, 128, 256).
extern "C" int attn_int8(const void* q, void* kc, void* ks, void* vc,
                         void* vs, const void* kcur, const void* kscur,
                         const void* vcur, const void* vscur,
                         const void* positions, int B, int Hkv, int G, int T,
                         int Gq, int g0, int Tq, int t0, int S, int D,
                         int cur, int write, int vec,
                         float scale, void* ws, void* tickets, void* out,
                         void* stream) {
  if (S < 1) return (int)cudaErrorInvalidValue;
  attn_split::Args a{
      (const __nv_bfloat16*)q, (int8_t*)kc, (__nv_bfloat16*)ks,
      (int8_t*)vc, (__nv_bfloat16*)vs, (const int8_t*)kcur,
      (const __nv_bfloat16*)kscur, (const int8_t*)vcur,
      (const __nv_bfloat16*)vscur, (const int*)positions, nullptr,
      B, Hkv, G, T, S, 0, (S + attn_split::CHUNK - 1) / attn_split::CHUNK,
      scale, (float*)ws, (int*)tickets, (float*)out, D, vec, Gq, g0, Tq,
      t0};
  return attn_split::dispatch<false>(a, cur, write, stream);
}
