// Kernel K4: front-to-back alpha blend of each 16x16 tile.
//
// Replaces the Pallas kernel guidedvd3dgs_tpu/ops/raster_tiles.py::_run_fwd
// (body _fwd_kernel). For each pixel, over its tile's depth-sorted
// instances: power = -0.5 (a dx^2 + c dy^2) - b dx dy, skipped if > 0;
// alpha = min(0.99, op exp(power)), skipped if < 1/255; if
// T (1 - alpha) < 1e-4 the pixel stops without this instance; otherwise
// color, depth and 1 accumulate with weight alpha T and T *= 1 - alpha.
// Output: color = acc + T bg, depth, alpha, straight into (3, H, W) and
// (H, W) planes with the ragged image edge masked.
//
// What bounds it on the card: the per-(instance, pixel) arithmetic (one
// expf and ~15 flops) and, for the instance fields, the gather from K1's
// table (40 bytes per instance, read once per tile). The TPU kernel
// rewrote the sequential recurrence as chunk-local cumulative products on
// its matrix unit; on the card the CUDA original's per-pixel loop is the
// natural form. Design: one block of 256 threads per tile, one pixel per
// thread. Rounds of 256 instances are gathered cooperatively by owner id
// into shared memory, then every thread walks the round. The block leaves
// early once all 256 pixels are done (__syncthreads_count).

#include "common.cuh"

namespace gvd {
namespace {

constexpr int F_MX = 0, F_MY = 1, F_CA = 2, F_CB = 3, F_CC = 4, F_OP = 5, F_R = 6, F_G = 7,
              F_B = 8, F_D = 9;
constexpr int NF = 10;

__global__ void __launch_bounds__(TILE_PIX)
    blend_fwd_kernel(const float* __restrict__ tab, int n, const int* __restrict__ inst_gauss,
                     const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                     const float* __restrict__ bg, int gx, int width, int height,
                     float* __restrict__ out_color, float* __restrict__ out_depth,
                     float* __restrict__ out_alpha) {
  __shared__ float s_f[NF][TILE_PIX];
  const int t = blockIdx.x;
  const int lin = threadIdx.x;
  const int px = (t % gx) * TILE + lin % TILE;
  const int py = (t / gx) * TILE + lin / TILE;
  const bool inside = px < width && py < height;
  const float pxf = (float)px, pyf = (float)py;
  const int start = tile_start[t];
  const int cnt = tile_count[t];
  const size_t N = (size_t)n;

  float T = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f, acc_a = 0.0f;
  bool done = !inside;
  for (int base = 0; base < cnt; base += TILE_PIX) {
    // also the barrier before this round's loads overwrite the last round
    if (__syncthreads_count(done) == TILE_PIX) break;
    const int j = base + lin;
    if (j < cnt) {
      const size_t g = (size_t)inst_gauss[start + j];
#pragma unroll
      for (int f = 0; f < NF; ++f) s_f[f][lin] = __ldg(tab + f * N + g);
    }
    __syncthreads();
    const int nb = min(TILE_PIX, cnt - base);
    for (int k = 0; !done && k < nb; ++k) {
      const float dx = s_f[F_MX][k] - pxf;
      const float dy = s_f[F_MY][k] - pyf;
      const float power =
          -0.5f * (s_f[F_CA][k] * dx * dx + s_f[F_CC][k] * dy * dy) - s_f[F_CB][k] * dx * dy;
      if (!(power <= 0.0f)) continue;
      const float araw = s_f[F_OP][k] * expf(power);
      if (!(araw >= ALPHA_EPS)) continue;
      const float alpha = fminf(ALPHA_MAX, araw);
      const float test_t = T * (1.0f - alpha);
      if (test_t < T_EPS) {
        done = true;
        break;
      }
      const float w = alpha * T;
      acc_r = acc_r + w * s_f[F_R][k];
      acc_g = acc_g + w * s_f[F_G][k];
      acc_b = acc_b + w * s_f[F_B][k];
      acc_d = acc_d + w * s_f[F_D][k];
      acc_a = acc_a + w;
      T = test_t;
    }
  }
  if (inside) {
    const size_t hw = (size_t)height * width;
    const size_t p = (size_t)py * width + px;
    out_color[p] = acc_r + T * bg[0];
    out_color[hw + p] = acc_g + T * bg[1];
    out_color[2 * hw + p] = acc_b + T * bg[2];
    out_depth[p] = acc_d;
    out_alpha[p] = acc_a;
  }
}

}  // namespace
}  // namespace gvd

GVD_API int gvd_blend_fwd(const float* tab, int n, const int* inst_gauss, const int* tile_start,
                          const int* tile_count, const float* bg, int gx, int gy, int width,
                          int height, float* out_color, float* out_depth, float* out_alpha,
                          cudaStream_t stream) {
  const int num_tiles = gx * gy;
  if (num_tiles > 0) {
    gvd::blend_fwd_kernel<<<num_tiles, gvd::TILE_PIX, 0, stream>>>(
        tab, n, inst_gauss, tile_start, tile_count, bg, gx, width, height, out_color, out_depth,
        out_alpha);
  }
  return (int)cudaGetLastError();
}
