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
// blend never reached hold zero). So one thread per Gaussian sums its own
// slots in slot order: the same order for every run, and the tile order of
// the reference's stable sort.
//
// What bounds it on the card: memory, 40 bytes read per instance and 40
// written per Gaussian; the adds are free. Design: one thread per
// Gaussian, its slots read as contiguous 40-byte rows; the output is
// written row-major (10, N), so a warp's stores of one row are coalesced.
// The load is uneven (a large Gaussian has many slots), which the timings
// in PERF.md show.

#include "common.cuh"

namespace gvd {
namespace {

constexpr int NF = 10;

__global__ void segsum_kernel(const float* __restrict__ grad, const int* __restrict__ offsets,
                              const int* __restrict__ count, int n, float* __restrict__ out) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  float acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f] = 0.0f;
  const float* row = grad + (size_t)offsets[g] * NF;
  const int c = count[g];
  for (int s = 0; s < c; ++s, row += NF) {
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[f] = acc[f] + __ldg(row + f);
  }
  const size_t N = (size_t)n;
#pragma unroll
  for (int f = 0; f < NF; ++f) out[f * N + g] = acc[f];
}

}  // namespace
}  // namespace gvd

GVD_API int gvd_segsum(const float* grad, const int* offsets, const int* count, int n, float* out,
                       cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    gvd::segsum_kernel<<<blocks, threads, 0, stream>>>(grad, offsets, count, n, out);
  }
  return (int)cudaGetLastError();
}
