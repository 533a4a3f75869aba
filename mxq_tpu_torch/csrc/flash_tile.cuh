// Tiles of flash attention in shared memory, shared by the float32
// kernels of K13's forward (flash_attn.cu) and its backward, K13-bwd
// (flash_attn_bwd.cu): the swizzled [rows][D] bf16 layout, bf16 pairs and
// the hi + lo split of float32 values, and the tile loader.
// Each source includes it inside its anonymous namespace, after
// device_util.cuh.

#pragma once

// element offset of 16-byte chunk c of row r in a [rows][D] bf16 tile:
// chunk c of row r sits at chunk c ^ (r % 8), so that ldmatrix's eight
// row addresses fall in eight different bank groups
template <int D>
__device__ __forceinline__ int sw(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x = hi + lo, hi = bf16(x), lo = bf16(x - hi), for a pair of values
__device__ __forceinline__ void split_bf2(float x, float y, uint32_t& hi,
                                          uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf2(x - f.x, y - f.y);
}

// rows [0, ROWS) of a tile from f32 src (row r at src + r * rstride), by
// NT threads, split into bf16 hi and lo planes through registers; rows >=
// nrows are zero and read nothing
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(__nv_bfloat16* hi,
                                          __nv_bfloat16* lo, const float* src,
                                          long long rstride, int nrows,
                                          int tid) {
  constexpr int CPR = D / 8;            // 16-byte bf16 chunks per row
  for (int i = tid; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR;
    float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
    if (r < nrows) {
      const float4* g = reinterpret_cast<const float4*>(src + r * rstride
                                                        + c * 8);
      x0 = __ldg(g);
      x1 = __ldg(g + 1);
    }
    uint4 h, l;
    split_bf2(x0.x, x0.y, h.x, l.x);
    split_bf2(x0.z, x0.w, h.y, l.y);
    split_bf2(x1.x, x1.y, h.z, l.z);
    split_bf2(x1.z, x1.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + sw<D>(r, c)) = h;
    *reinterpret_cast<uint4*>(lo + sw<D>(r, c)) = l;
  }
}
