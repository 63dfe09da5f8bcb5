// Device helpers shared by kernel L1's forward (flash_attn_fwd.cu) and its
// backward (flash_attn_bwd.cu).
#pragma once

#include "common.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

namespace gvd {
namespace fa {

constexpr int DT = 32;       // head dims per thread in the FMA kernels
constexpr int NC = DT / 4;   // float4 chunks per thread
constexpr int THREADS_MMA = 128;  // 4 warps of 16 rows in the tensor-core kernels

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
// x rounded to the type T (the plain versions round the softmax weights to
// the input type before the product with v or dO)
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// c += a b, m16n8k16, bf16 inputs, f32 accumulators. Fragments (g = lane/4,
// t4 = lane%4): a[0] rows g, cols 2t4..2t4+1; a[1] row g+8; a[2] row g,
// cols +8; a[3] row g+8, cols +8. b0: k rows 2t4..2t4+1 of column g; b1 the
// same +8. c[0..1] row g, cols 2t4..2t4+1; c[2..3] row g+8.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// two neighbouring bf16 at `p` (a 4-byte aligned address)
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of k-step kk from a row-major bf16 tile in shared memory whose
// warp rows start at `row0` (stride `ld` elements)
__device__ __forceinline__ void ld_a_frag(uint32_t* a, const __nv_bfloat16* tile, int ld, int row0, int kk,
                                          int g, int t4) {
  const __nv_bfloat16* p = tile + (row0 + g) * ld + kk * 16 + t4 * 2;
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * ld);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * ld + 8);
}

// Stage rows [r0, r0 + rows) of a (n, D) bf16 matrix into shared memory:
// row-major into `rm` (row stride D + 8) and, when `tr` is not null,
// transposed into `tr` (row stride rows + 8). Rows past n are zero.
template <int D>
__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* __restrict__ src, int r0, int rows, int n,
                                           __nv_bfloat16* rm, __nv_bfloat16* tr) {
  for (int i = threadIdx.x; i < rows * D / 8; i += blockDim.x) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 v4 = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n) v4 = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(rm + r * (D + 8) + c) = v4;
    if (tr != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v4);
#pragma unroll
      for (int j = 0; j < 8; ++j) tr[(c + j) * (rows + 8) + r] = e[j];
    }
  }
}

}  // namespace fa
}  // namespace gvd
