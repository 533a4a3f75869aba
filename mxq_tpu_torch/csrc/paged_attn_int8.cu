// K9 / K10 / K11: one-token GQA decode attention over the int8 paged KV
// pool, one template with two compile-time flags:
//   K9  (CUR=0, WRITE=0)  rows < lengths[b]
//   K10 (CUR=1, WRITE=0)  rows < positions[b], plus the current token
//                         (out of the pool) folded in after the last page
//   K11 (CUR=1, WRITE=1)  K10, plus the current token's code row and scale
//                         lane written into its pool page in place
//
// Replaces the TPU kernels mxq_tpu/ops/attn_int8.py _kernel_paged (:559,
// via _paged_attn_call :604 / int8_paged_decode_attention :1016),
// _kernel_paged_cur (:658, via int8_paged_decode_attention_cur :990) and
// _kernel_paged_cur_write (:773, via int8_paged_decode_attend_update :957,
// which serving/paged.py's decode step calls once per layer). The TPU's
// g8 = max(8, G) padding, 8-row octet write windows, aliased outputs and
// null-page parking were Mosaic devices: here the write is a direct store
// of D codes and one scale lane per (b, head), and no other pool byte is
// touched.
//
// Pool layout (serving/paged.py, folded): codes [Hkv, LP, PAGE, D] int8,
// scales [Hkv, LP, 1, PAGE] bf16; tables [B, pps] int32 physical page ids.
//
// Math per (batch b, kv head h), its G query heads, bound n = bound[b]:
// the TPU kernel folds its pages in table order into a running (m, l, acc)
// (attn_int8.py:575-600):
//   st    = (q . kc[s]) * (ks[s] * scale)            rows s < n of the page
//   m_new = max(m, max_s st); alpha = exp(m - m_new); pexp = exp(st - m_new)
//   l     = l * alpha + sum_s pexp
//   acc   = acc * alpha + sum_s bf16(pexp * vs[s]) * vc[s]
// bf16(pexp * vs) is rounded against the RUNNING max of each page, not the
// global max as K4 does. Page j's running max is the prefix max m_j of the
// page maxima 0..j (from NEG), so with every page's max known (pass A of
// attn_split.cuh) the pages are formed in parallel against their own m_j,
// with the same bf16 inputs, and combined as sum_j (.)_j * exp(m_j - m_J):
// the sequential fold's product of alphas in one exp. With CUR the current
// token folds in last (:701-717), gated on nothing: with no cache rows
// m = NEG and alpha2 = exp(NEG - stc) = 0. ctx = acc / max(l, 1e-30). A
// page wholly past n is never read, so neither is the null page. expf, not
// fast math.
//
// Bound on the H100: bytes. Every code row below n is read once (2*D bytes
// per (b, h, row)) with its two bf16 scales, at two multiply-adds per code
// byte. One block per (page, h, b) and pass, 16-byte code loads, no
// barrier per page (attn_split.cuh).

#include "attn_split.cuh"

// q [B, Hkv, G, D] bf16; kp/vp [Hkv, LP, 128, D] int8; ks/vs [Hkv, LP, 128]
// bf16; kcur/vcur [B, Hkv, D], kscur/vscur [B, Hkv] (may be null when cur is
// 0); bound [B]; tables [B, pps]; ws the scratch of attn_split::carve with
// T = 1, NS = pps; tickets [B * Hkv] int32, 0 between calls; out
// [B, Hkv, G, D] f32. cur = 0: K9 (bound = lengths); cur = 1: K10 (bound =
// positions); cur = 1, write = 1: K11.
extern "C" int paged_attn_int8(const void* q, void* kp, void* ks, void* vp,
                               void* vs, const void* kcur, const void* kscur,
                               const void* vcur, const void* vscur,
                               const void* bound, const void* tables, int B,
                               int Hkv, int G, int D, int LP, int pps, int cur,
                               int write, float scale, void* ws,
                               void* tickets, void* out, void* stream) {
  attn_split::Args a{
      (const __nv_bfloat16*)q, (int8_t*)kp, (__nv_bfloat16*)ks,
      (int8_t*)vp, (__nv_bfloat16*)vs, (const int8_t*)kcur,
      (const __nv_bfloat16*)kscur, (const int8_t*)vcur,
      (const __nv_bfloat16*)vscur, (const int*)bound, (const int*)tables,
      B, Hkv, G, 1, 0, LP, pps, scale, (float*)ws, (int*)tickets,
      (float*)out};
  return attn_split::dispatch<true>(a, D, cur, write, stream);
}
