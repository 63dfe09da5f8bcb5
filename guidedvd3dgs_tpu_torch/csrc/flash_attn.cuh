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

}  // namespace fa
}  // namespace gvd
