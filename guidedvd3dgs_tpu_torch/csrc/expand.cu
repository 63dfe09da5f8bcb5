// Kernel K3: expand each Gaussian into its (Gaussian, tile) instances.
//
// Replaces the Pallas kernel guidedvd3dgs_tpu/ops/expand.py::
// expand_instances (body _expand_kernel). It computes what that kernel
// computes, in the form of the CUDA original's duplicateWithKeys: for each
// instance the 64-bit sort key (tile id << 32 | f32 depth bits) and the
// owner id, at the Gaussian's exclusive offset; and the per-tile instance
// histogram. Instances whose maximum alpha over their tile is provably
// below 1/255 (the reference's conservative tile cull) get the key of the
// past-the-end tile `num_tiles` and stay out of the histogram, so the
// histogram equals the TPU kernel's.
//
// What bounds it on the card: memory writes, 12 bytes per instance, and
// the load imbalance of one thread per Gaussian (a large Gaussian walks
// many tiles). The TPU kernel also copied the 16 render fields into every
// instance, to avoid slow gathers there; on the card K4 gathers the fields
// by owner id from K1's table instead, which saves 64 bytes per instance.
// Design: one thread per Gaussian walks its tile rectangle row by row;
// the histogram is built with atomicAdd on int counters (order-free, so
// deterministic).

#include "common.cuh"

namespace gvd {
namespace {

// rows of the K1 table (ops/tiling.py F_*)
constexpr int F_MX = 0, F_MY = 1, F_CA = 2, F_CB = 3, F_CC = 4, F_OP = 5, F_D = 9;

__global__ void expand_kernel(const float* __restrict__ tab, int n,
                              const int* __restrict__ rect_min_x,
                              const int* __restrict__ rect_min_y,
                              const int* __restrict__ rect_w, const int* __restrict__ count,
                              const int* __restrict__ offsets, int gx, int num_tiles,
                              int64_t* __restrict__ keys, int* __restrict__ owners,
                              int* __restrict__ hist) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const int c = count[g];
  if (c == 0) return;
  const size_t N = (size_t)n;
  const float mx = tab[F_MX * N + g], my = tab[F_MY * N + g];
  const float ca = tab[F_CA * N + g], cb = tab[F_CB * N + g], cc = tab[F_CC * N + g];
  const float op = tab[F_OP * N + g];
  const int64_t dbits = (int64_t)__float_as_uint(tab[F_D * N + g]);
  const float lvl = logf(clamp_min(op, 1e-12f) * 255.0f);
  const float caf = clamp_min(ca, 1e-12f), ccf = clamp_min(cc, 1e-12f);
  const int w = rect_w[g], x0 = rect_min_x[g], y0 = rect_min_y[g];
  const int h = c / w;
  auto qv = [&](float dx, float dy) { return 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy; };

  int64_t* k = keys + offsets[g];
  int* o = owners + offsets[g];
  for (int q = 0; q < h; ++q) {
    const int ty = y0 + q;
    const float ey0 = (float)ty * 16.0f - my;
    const float ey1 = ey0 + 15.0f;
    for (int rem = 0; rem < w; ++rem) {
      const int tx = x0 + rem;
      const int tile = ty * gx + tx;
      const float ex0 = (float)tx * 16.0f - mx;
      const float ex1 = ex0 + 15.0f;
      // minimum of the conic quadratic over the tile's pixel rectangle:
      // the mean itself when inside, else the clamped per-edge minima
      const bool inside = (ex0 <= 0.0f) && (0.0f <= ex1) && (ey0 <= 0.0f) && (0.0f <= ey1);
      const float qe0 = qv(ex0, clamp_f(-cb * ex0 / ccf, ey0, ey1));
      const float qe1 = qv(ex1, clamp_f(-cb * ex1 / ccf, ey0, ey1));
      const float qe2 = qv(clamp_f(-cb * ey0 / caf, ex0, ex1), ey0);
      const float qe3 = qv(clamp_f(-cb * ey1 / caf, ex0, ex1), ey1);
      const float minq = inside ? 0.0f : fminf(fminf(qe0, qe1), fminf(qe2, qe3));
      const bool cull = minq > lvl;
      *k++ = ((int64_t)(cull ? num_tiles : tile) << 32) | dbits;
      *o++ = g;
      if (!cull) atomicAdd(hist + tile, 1);
    }
  }
}

}  // namespace
}  // namespace gvd

GVD_API int gvd_expand(const float* tab, int n, const int* rect_min_x, const int* rect_min_y,
                       const int* rect_w, const int* count, const int* offsets, int gx,
                       int num_tiles, int64_t* keys, int* owners, int* hist,
                       cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    gvd::expand_kernel<<<blocks, threads, 0, stream>>>(tab, n, rect_min_x, rect_min_y, rect_w,
                                                       count, offsets, gx, num_tiles, keys,
                                                       owners, hist);
  }
  return (int)cudaGetLastError();
}
