// Device helpers shared by the kernels of this directory: cp.async
// copies, ldmatrix, mma.sync, bf16x2 arithmetic with one rounding per step, and
// bfexp's weight pairs.
// Each source includes it inside its anonymous namespace, after
// <cuda_bf16.h> and <stdint.h>.

#pragma once

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled when !valid (src is not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// all but the newest group of copies complete
__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// all but the newest N groups of copies complete
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void ldmatrix(uint32_t (&a)[N], const void* p) {
  static_assert(N == 2 || N == 4, "ldmatrix .x2 or .x4");
  if constexpr (N == 4)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
        : "r"(smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(a[0]), "=r"(a[1])
                 : "r"(smem_addr(p)));
}

// c += a . b: mma.sync m16n8k16, bf16 in, f32 out (a: the A
// fragment's 4 registers, b0/b1: the B fragment's 2)
__device__ __forceinline__ void mma_acc(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b (C = 0)
__device__ __forceinline__ void mma_zero(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// bf16x2 a*b and a-b, each rounded once, in PTX so that ptxas cannot
// contract the pair into one fma (bfexp's arithmetic)
__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d)
      : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}
__device__ __forceinline__ uint32_t bf2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d)
      : "r"(b), "r"(0xBF80BF80u), "r"(a));
  return d;
}

// one bf16 value repeated in both halves
__device__ __forceinline__ uint32_t bf2_splat(float v) {
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  return h | (h << 16);
}

__device__ __forceinline__ uint32_t rotl(uint32_t w, int n) {
  return __funnelshift_l(w, w, n);
}

// K6's bfexp layout (gemv_bfexp_plain in ops/mxq_matmul.py), shared by the
// one-row kernel (mxq_gemv.cu) and the tensor-core template
// (mxq_gemv_tc.cu). A group's operands packed in one word: bf16(4s) |
// bf16(4s + s*z) << 16, each rounded once from f32 as the plain version
// rounds them (the 4-bit plane's: bf16(16*s4) | bf16(16*s4 + s4*z4) << 16).
__device__ __forceinline__ uint32_t bfexp_entry(float s4x, float sz) {
  const __nv_bfloat162 e = __floats2bfloat162_rn(s4x, __fadd_rn(s4x, sz));
  return *reinterpret_cast<const uint32_t*>(&e);
}

// Two weights as bf16x2 from a packed word w: rotl(w, rot) & mask puts a
// code at the top of bf16 1.0's mantissa in each half, so that p reads as
// (1 + c/4, 1 + c'/4) (2-bit: mask 0x00600060) or (1 + c/16, 1 + c'/16)
// (4-bit: 0x00780078); e0 and e1 are the entry's halves, each in both
// halves. The weights are bf16(bf16(e0 * p) - e1): two roundings, a
// multiply then a subtract, as gemv_bfexp_plain.
__device__ __forceinline__ uint32_t bfexp_pair(uint32_t w, int rot,
                                               uint32_t mask, uint32_t e0,
                                               uint32_t e1) {
  const uint32_t p = (rotl(w, rot) & mask) | 0x3F803F80u;
  return bf2_sub(bf2_mul(e0, p), e1);
}
