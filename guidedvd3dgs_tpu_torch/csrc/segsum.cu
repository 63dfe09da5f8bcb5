// Kernel K6: deterministic per-Gaussian sum of the per-instance gradients.
//
// Replaces the Pallas kernel guidedvd3dgs_tpu/ops/segsum.py::
// segment_sum_sorted (body _segsum_kernel), which sums the id-sorted
// per-instance gradient rows of the tile backward into one row per
// Gaussian: the CUDA original's atomicAdd reduction, made deterministic.
//
// No sort is needed here. K3 wrote Gaussian g's instances to the
// contiguous expansion slots [offsets[g], offsets[g] + count[g]), in
// ascending tile order, and K5 wrote each instance's 10 gradients to its
// slot (rows of 10 floats; slots of culled instances and of instances the
// blend never reached hold zero).
//
// What bounds it on the H100: memory, 40 bytes read per instance and 40
// written per Gaussian (with the 8 bytes of offset and count read); the
// adds are free. One thread summing its own slots reads 40-byte rows far
// from its neighbours' (each load of a warp touches 32 rows in as many
// places: the L1 serves 32 requests for 128 bytes) and waits for them one
// after another. A block copying its slab for its threads to sum, and a
// warp per Gaussian with nothing else in flight, both measured slower
// than this (PERF.md). The design:
//   - a block owns K6_THREADS consecutive Gaussians, one a thread for
//     their offsets and counts; a Gaussian without slots gets zeros;
//   - the others are the block's tasks, which its warps take in turn. A
//     warp's lane l adds the rows of slots l, l + 32, ... of its Gaussian
//     in order (consecutive lanes read consecutive rows, 8 bytes a load),
//     then lanes 0-9 each add one field's 32 lane sums in lane order
//     through shared memory: the same order in every run, within count
//     2^-23 sum |g| of the exact sum (and a Gaussian of one slot gets its
//     row, as the thread-per-Gaussian sum did);
//   - while a warp adds up one task it has the first 64 rows of its next
//     task in flight, so the wait for memory overlaps the adds;
//   - the block's 10 x K6_THREADS sums are staged in shared memory and
//     stored row by row, coalesced.

#include "common.cuh"

namespace gvd {
namespace {

constexpr int NF = 10;
// Gaussians (and threads) a block (PERF.md)
constexpr int K6_THREADS = 128;
constexpr int K6_WARPS = K6_THREADS / 32;

struct Row {
  float2 v[5];
};

// the row of slot s (10 floats at an 8-byte boundary), or zeros
__device__ __forceinline__ Row load_row(const float* __restrict__ grad, int s, bool ok) {
  Row r;
  const float2* p = reinterpret_cast<const float2*>(grad + (size_t)s * NF);
#pragma unroll
  for (int k = 0; k < 5; ++k) r.v[k] = ok ? __ldg(p + k) : make_float2(0.0f, 0.0f);
  return r;
}

__device__ __forceinline__ void add_row(float (&acc)[NF], const Row& r) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    acc[2 * k] = acc[2 * k] + r.v[k].x;
    acc[2 * k + 1] = acc[2 * k + 1] + r.v[k].y;
  }
}

__global__ void __launch_bounds__(K6_THREADS)
    segsum_kernel(const float* __restrict__ grad, const int* __restrict__ offsets,
                  const int* __restrict__ count, int n, float* __restrict__ out) {
  __shared__ float s_out[NF][K6_THREADS];             // the block's sums
  __shared__ float s_lane[K6_WARPS][32][NF + 1];      // a warp's lane sums (odd stride)
  __shared__ int s_task[K6_THREADS], s_lo[K6_THREADS], s_cnt[K6_THREADS];
  __shared__ int s_ntask;
  const int t = threadIdx.x, g0 = blockIdx.x * K6_THREADS, g = g0 + t;
  const int rows = min(K6_THREADS, n - g0);
  if (t == 0) s_ntask = 0;
  __syncthreads();
  if (t < rows) {
    const int c = __ldg(count + g);
    if (c > 0) {
      const int k = atomicAdd(&s_ntask, 1);
      s_task[k] = t, s_lo[k] = __ldg(offsets + g), s_cnt[k] = c;
    }
#pragma unroll
    for (int f = 0; f < NF; ++f) s_out[f][t] = 0.0f;
  }
  __syncthreads();

  const int ntask = s_ntask, warp = t >> 5, lane = t & 31;
  float(*lanes)[NF + 1] = s_lane[warp];
  // the first 64 rows of a task: slots lo + lane and lo + lane + 32
  auto first = [&](int k, Row& a, Row& b) {
    const int lo = s_lo[k], c = s_cnt[k];
    a = load_row(grad, lo + lane, lane < c);
    b = load_row(grad, lo + lane + 32, lane + 32 < c);
  };
  Row a, b;
  if (warp < ntask) first(warp, a, b);
  for (int k = warp; k < ntask; k += K6_WARPS) {
    const int lo = s_lo[k], c = s_cnt[k];
    float acc[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[f] = 0.0f;
    add_row(acc, a);
    add_row(acc, b);
    for (int s = lo + lane + 64; s < lo + c; s += 64) {
      const Row x = load_row(grad, s, true), y = load_row(grad, s + 32, s + 32 < lo + c);
      add_row(acc, x);
      add_row(acc, y);
    }
    if (k + K6_WARPS < ntask) first(k + K6_WARPS, a, b);  // in flight under the adds below
#pragma unroll
    for (int f = 0; f < NF; ++f) lanes[lane][f] = acc[f];
    __syncwarp();
    if (lane < NF) {
      float sum = lanes[0][lane];
#pragma unroll
      for (int l = 1; l < 32; ++l) sum = sum + lanes[l][lane];
      s_out[lane][s_task[k]] = sum;
    }
    __syncwarp();
  }
  __syncthreads();
  for (int e = t; e < NF * rows; e += K6_THREADS) {
    const int f = e / rows, q = e - f * rows;
    out[(size_t)f * n + g0 + q] = s_out[f][q];
  }
}

}  // namespace
}  // namespace gvd

// grad: rows of 10 floats starting at an 8-byte boundary
GVD_API int gvd_segsum(const float* grad, const int* offsets, const int* count, int n, float* out,
                       cudaStream_t stream) {
  if (n > 0) {
    const int blocks = (n + gvd::K6_THREADS - 1) / gvd::K6_THREADS;
    gvd::segsum_kernel<<<blocks, gvd::K6_THREADS, 0, stream>>>(grad, offsets, count, n, out);
  }
  return (int)cudaGetLastError();
}
