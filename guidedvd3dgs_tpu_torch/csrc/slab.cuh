// Slabs of per-Gaussian rows between device memory and shared memory,
// shared by kernels K1 (preprocess_fwd.cu) and K2 (preprocess_bwd.cu):
// a block copies the rows of its consecutive Gaussians into shared memory
// with cp.async, consecutive floats by consecutive threads (coalesced,
// any 4-byte alignment), and stores rows back with 16-byte stores.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace gvd {

// Row stride in shared memory of a row of w floats read one float at a
// time: odd, so the 32 lanes of a warp reading one column hit 32 banks.
__host__ __device__ inline int odd_stride(int w) { return w | 1; }

// Floats before the first 16-byte boundary at or after p, at most len.
__device__ __forceinline__ int head_floats(const float* p, int len) {
  return min(len, (int)(((16u - ((unsigned)(uintptr_t)p & 15u)) & 15u) >> 2));
}

// result[u] = a[(u + r) & 3]
__device__ __forceinline__ float4 rotl4(float4 a, int r) {
  const float4 b = (r & 1) ? make_float4(a.y, a.z, a.w, a.x) : a;
  return (r & 2) ? make_float4(b.z, b.w, b.x, b.y) : b;
}

// The row and column of float e0 = head + 4 threadIdx.x in rows of w, and
// the rows and columns a thread's next vector lies further on.
struct SlabWalk {
  int r, c, dr, dc;
  __device__ SlabWalk(int head, int w) {
    const int e0 = head + 4 * (int)threadIdx.x, step = 4 * (int)blockDim.x;
    r = e0 / w, c = e0 - r * w, dr = step / w, dc = step - dr * w;
  }
  __device__ void next(int w) {
    r += dr, c += dc;
    if (c >= w) c -= w, ++r;
  }
  // shared index of float u (0-3) of the current vector, rows of stride ss
  __device__ int index(int u, int w, int ss) const {
    const int cu = c + u;
    return cu >= w ? (r + 1) * ss + cu - w : r * ss + cu;
  }
};

// Start the asynchronous copy of `rows` rows of w >= 1 floats, row r at
// src + r * sstride, into shared memory rows of stride ss: the block's
// threads copy consecutive floats of the rows (4 bytes each, so any
// alignment; where sstride == w a warp's 32 copies are one coalesced
// 128-byte read), each walking its rows and columns. Contiguous rows take
// the shorter loop (a copy's few instructions are much of K2's time).
__device__ inline void fetch_rows(const float* __restrict__ src, int sstride, float* dst, int rows,
                                  int w, int ss) {
  const int len = rows * w, step = blockDim.x, dr = step / w, dc = step - dr * w;
  int r = threadIdx.x / w, c = threadIdx.x - r * w;
  if (sstride == w) {
    for (int e = threadIdx.x; e < len; e += step) {
      cp_async4(dst + r * ss + c, src + e, true);
      r += dr, c += dc;
      if (c >= w) c -= w, ++r;
    }
    return;
  }
  const float* row = src + (size_t)r * sstride;  // the source row of r
  for (int e = threadIdx.x; e < len; e += step) {
    cp_async4(dst + r * ss + c, row + c, true);
    r += dr, c += dc, row += (size_t)dr * sstride;
    if (c >= w) c -= w, ++r, row += sstride;
  }
}

// Shared rows of stride ss (rows of w >= 3 floats) to the len floats at
// dst, with the block's threads: 16-byte stores from the first aligned
// float on, single floats before and after. A lane gathers the four
// floats of its vector in an order rotated by (lane / 8) % 4, so the 32
// lanes of each 4-byte shared read hit 32 banks. With acc, each float is
// added to the one dst holds (dst + src, read by the same 16-byte access).
__device__ inline void store_slab(const float* src, float* __restrict__ dst, int len, int w, int ss,
                                  bool acc = false) {
  const int head = head_floats(dst, len);
  const int nvec = (len - head) >> 2;
  const int rot = (threadIdx.x >> 3) & 3;
  for (int e = threadIdx.x; e < head; e += blockDim.x) {
    const float x = src[(e / w) * ss + e % w];
    dst[e] = acc ? dst[e] + x : x;
  }
  float4* v = reinterpret_cast<float4*>(dst + head);
  SlabWalk pos(head, w);
  for (int q = threadIdx.x; q < nvec; q += blockDim.x, pos.next(w)) {
    float xs[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) xs[u] = src[pos.index((u + rot) & 3, w, ss)];
    float4 x = rotl4(make_float4(xs[0], xs[1], xs[2], xs[3]), (4 - rot) & 3);
    if (acc) {
      const float4 o = v[q];
      x = make_float4(o.x + x.x, o.y + x.y, o.z + x.z, o.w + x.w);
    }
    v[q] = x;
  }
  for (int e = head + 4 * nvec + threadIdx.x; e < len; e += blockDim.x) {
    const float x = src[(e / w) * ss + e % w];
    dst[e] = acc ? dst[e] + x : x;
  }
}

}  // namespace gvd
