// Device helpers shared by kernel L1's forward (flash_attn_fwd.cu) and its
// backward (flash_attn_bwd.cu): the FMA kernels' row split, mma.sync, and
// the swizzled-slab tiles that TMA fills and wgmma reads.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

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

constexpr float LOG2E = 1.4426950408889634f;

// ---- bf16 tiles of D-dim rows for TMA and wgmma ----
//
// TMA writes a tile of R rows in slabs of CW columns, [slab][row][SW
// bytes], each in the swizzle of its span (128 bytes; 64 at D = 32): the
// canonical layout `wgmma` reads in either major. Every slab starts 1024-
// byte aligned, so a descriptor's base offset is 0.
template <int D>
struct Slabs {
  static constexpr int DIM = D;                  // elements of a row in global memory
  static constexpr int CW = D >= 64 ? 64 : 32;   // columns of a swizzled slab
  static constexpr int SW = CW * 2;              // bytes of a slab row: the swizzle span
  static constexpr int NS = D / CW;              // slabs of a row
  static constexpr int KSTEPS = CW / 16;         // wgmma k-steps inside a slab
};

// TMA of rows [r0, r0 + R) of one head into a tile of all its slabs
template <int D, int R>
__device__ __forceinline__ void tma_rows(unsigned char* dst, const CUtensorMap& map, uint64_t* bar, int r0,
                                         int head) {
  using S = Slabs<D>;
#pragma unroll
  for (int s = 0; s < S::NS; ++s) tma_load_3d(dst + s * R * S::SW, &map, bar, s * S::CW, r0, head);
}

// The products below read T::NS slabs from the given start: a warpgroup
// that owns part of the dims passes the start of its first slab. T: a
// Slabs<D> with BM (rows of the owned tile) and BN (rows of a streamed
// tile).

// S (+)= A B^T over T::NS slabs of dims: A the owned tile, B a streamed
// one, both K-major (rows of dims). S: 64 x BN.
template <class T>
__device__ __forceinline__ void wg_rows_dot(float* s, const unsigned char* a, const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < T::NS * T::KSTEPS; ++kk) {
    const int slab = kk / T::KSTEPS, in = (kk % T::KSTEPS) * 2;  // 32 bytes = 2 descriptor units
    wgmma_ss<T::BN>(s, smem_desc<T::SW>(a + slab * T::BM * T::SW) + in,
                    smem_desc<T::SW>(b + slab * T::BN * T::SW) + in, kk > 0);
  }
}

// acc[slab] += A X over the BN streamed rows: A (64 x BN) the bf16 register
// fragments `a`, X the streamed tile read MN-major (BN x T::NS slabs)
template <class T>
__device__ __forceinline__ void wg_acc_rows(float (*acc)[T::CW / 2], const uint32_t (*a)[4],
                                            const unsigned char* x) {
#pragma unroll
  for (int s = 0; s < T::NS; ++s) {
#pragma unroll
    for (int kk = 0; kk < T::BN / 16; ++kk)
      wgmma_rs<T::CW>(acc[s], a[kk], smem_desc<T::SW>(x + s * T::BN * T::SW + kk * 16 * T::SW), 1);
  }
}

// write a 64-row accumulator of T::NS slabs (rows row0 + the thread's
// rows; `out` at the first dim, rows T::DIM apart) times `mul`
template <class T>
__device__ __forceinline__ void wg_store(bf16* out, const float (*acc)[T::CW / 2], int row0, int n, float mul) {
  const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int r = row0 + warp * 16 + (lane >> 2), c = (lane & 3) * 2;
#pragma unroll
  for (int s = 0; s < T::NS; ++s) {
#pragma unroll
    for (int i = 0; i < T::CW / 8; ++i) {
      const int d = s * T::CW + i * 8 + c;
      if (r < n)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * T::DIM + d) =
            __floats2bfloat162_rn(acc[s][i * 4 + 0] * mul, acc[s][i * 4 + 1] * mul);
      if (r + 8 < n)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(r + 8) * T::DIM + d) =
            __floats2bfloat162_rn(acc[s][i * 4 + 2] * mul, acc[s][i * 4 + 3] * mul);
    }
  }
}

}  // namespace fa
}  // namespace gvd
