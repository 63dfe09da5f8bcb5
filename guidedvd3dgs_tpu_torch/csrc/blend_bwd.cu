// Kernel K5: per-instance gradients of the tile blend.
//
// Replaces the Pallas kernel guidedvd3dgs_tpu/ops/raster_tiles.py::_run_bwd
// (body _bwd_kernel). Each pixel walks its tile's depth-sorted instances
// front to back with K4's rule (same f32 operations, so it stops at the
// instance K4 stopped at), rebuilding the transmittance T. With the
// cotangents dC (3), dD, dA of the pixel and U = C.dC + D dD + A dA from
// K4's outputs, instance i with blend weight w = alpha T and
// u = rgb.dC + d dD + dA gives
//   prefix += w u,  S = U - prefix         (suffix sum after i, bg included)
//   dalpha = T u - S / max(1 - alpha, 1e-3)
//   g = dalpha * op * exp(power)           (the 0.99 clamp is passed through)
// and the instance's sums over the tile's pixels: S0 = sum g, the moments
// Mx, My, Mxx, Mxy, Myy of g against (dx, dy) = mean - pixel, and
// sum w dC, sum w dD. Its gradients are
//   d_mx = -(a Mx + b My), d_my = -(c My + b Mx), d_a = -Mxx / 2,
//   d_b = -Mxy, d_c = -Myy / 2, d_op = S0 / max(op, 1e-12),
//   d_rgb = sum w dC, d_depth = sum w dD,
// written as one row of 10 floats at the instance's expansion slot
// perm[i] (K6 then sums each Gaussian's contiguous slots).
//
// What bounds it on the card: the per-(instance, pixel) arithmetic (one
// expf, ~40 flops) and the reduction of 10 sums over 256 pixels for every
// instance. The TPU kernel did the per-pixel work as (CHUNK, 256) matrix
// algebra and its sums as MXU moment products; here, as in the CUDA
// original, one thread is one pixel. Design: one block of 256 threads per
// 16x16 tile. Instances come in rounds of 256, their fields gathered by
// owner id from K1's table into shared memory; each round is walked in
// sub-rounds of 32 instances. Per instance, every warp sums its 32 pixels'
// 10 values with shuffles (skipped when no lane of the warp contributes,
// which is common: a Gaussian covers part of the tile), lane 0 parks the
// warp's sums in shared memory, and after the sub-round the 8 warp sums are
// added in warp order. No atomics: an instance belongs to one tile, so the
// result is deterministic. The block stops when every pixel is done;
// instances it never reaches keep the zero the caller wrote.

#include "common.cuh"

namespace gvd {
namespace {

constexpr int F_MX = 0, F_MY = 1, F_CA = 2, F_CB = 3, F_CC = 4, F_OP = 5, F_R = 6, F_G = 7,
              F_B = 8, F_D = 9;
constexpr int NF = 10;     // fields per instance, and gradient values per instance
constexpr int NWARP = TILE_PIX / 32;
constexpr int SUB = 32;    // instances per sub-round
// per-pixel sums: S0, Mx, My, Mxx, Mxy, Myy, w dC (3), w dD
constexpr int NS = 10;

__global__ void __launch_bounds__(TILE_PIX)
    blend_bwd_kernel(const float* __restrict__ tab, int n, const int* __restrict__ inst_gauss,
                     const int* __restrict__ perm, const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, const float* __restrict__ fwd_color,
                     const float* __restrict__ fwd_depth, const float* __restrict__ fwd_alpha,
                     const float* __restrict__ d_color, const float* __restrict__ d_depth,
                     const float* __restrict__ d_alpha, int gx, int width, int height,
                     float* __restrict__ grad) {
  __shared__ float s_f[NF][TILE_PIX];
  __shared__ float s_part[NWARP][SUB][NS];
  __shared__ float s_sum[SUB][NS];
  const int t = blockIdx.x;
  const int lin = threadIdx.x;
  const int lane = lin & 31, warp = lin >> 5;
  const int px = (t % gx) * TILE + lin % TILE;
  const int py = (t / gx) * TILE + lin / TILE;
  const bool inside = px < width && py < height;
  const float pxf = (float)px, pyf = (float)py;
  const int start = tile_start[t];
  const int cnt = tile_count[t];
  const size_t N = (size_t)n;

  float dcr = 0.0f, dcg = 0.0f, dcb = 0.0f, dd = 0.0f, da = 0.0f, U = 0.0f;
  if (inside) {
    const size_t hw = (size_t)height * width;
    const size_t p = (size_t)py * width + px;
    dcr = d_color[p];
    dcg = d_color[hw + p];
    dcb = d_color[2 * hw + p];
    dd = d_depth[p];
    da = d_alpha[p];
    U = fwd_color[p] * dcr + fwd_color[hw + p] * dcg + fwd_color[2 * hw + p] * dcb;
    U = U + fwd_depth[p] * dd + fwd_alpha[p] * da;
  }

  float T = 1.0f, prefix = 0.0f;
  bool done = !inside;
  bool all_done = false;
  for (int base = 0; base < cnt && !all_done; base += TILE_PIX) {
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
    for (int sub = 0; sub < nb; sub += SUB) {
      if (sub > 0 && __syncthreads_count(done) == TILE_PIX) {
        all_done = true;
        break;
      }
      const int ns = min(SUB, nb - sub);
      for (int kk = 0; kk < ns; ++kk) {
        const int k = sub + kk;
        float s[NS];
#pragma unroll
        for (int f = 0; f < NS; ++f) s[f] = 0.0f;
        bool live = false;
        if (!done) {
          const float dx = s_f[F_MX][k] - pxf;
          const float dy = s_f[F_MY][k] - pyf;
          const float power =
              -0.5f * (s_f[F_CA][k] * dx * dx + s_f[F_CC][k] * dy * dy) - s_f[F_CB][k] * dx * dy;
          if (power <= 0.0f) {
            const float araw = s_f[F_OP][k] * expf(power);
            if (araw >= ALPHA_EPS) {
              const float alpha = fminf(ALPHA_MAX, araw);
              const float test_t = T * (1.0f - alpha);
              if (test_t < T_EPS) {
                done = true;
              } else {
                const float w = alpha * T;
                const float u = s_f[F_R][k] * dcr + s_f[F_G][k] * dcg + s_f[F_B][k] * dcb +
                                s_f[F_D][k] * dd + da;
                prefix = prefix + w * u;
                const float S = U - prefix;
                const float dalpha = T * u - S / fmaxf(1.0f - alpha, 1e-3f);
                const float gp = dalpha * araw;
                s[0] = gp;
                s[1] = gp * dx;
                s[2] = gp * dy;
                s[3] = gp * dx * dx;
                s[4] = gp * dx * dy;
                s[5] = gp * dy * dy;
                s[6] = w * dcr;
                s[7] = w * dcg;
                s[8] = w * dcb;
                s[9] = w * dd;
                T = test_t;
                live = true;
              }
            }
          }
        }
        // one warp-uniform branch: every lane takes part in the shuffles
        if (__ballot_sync(0xffffffffu, live)) {
#pragma unroll
          for (int f = 0; f < NS; ++f) {
            float v = s[f];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
            s[f] = v;
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int f = 0; f < NS; ++f) s_part[warp][kk][f] = s[f];
        }
      }
      __syncthreads();
      // the 8 warp sums of each (instance, value), added in warp order
      for (int idx = lin; idx < ns * NS; idx += TILE_PIX) {
        const int kk = idx / NS, f = idx % NS;
        float v = s_part[0][kk][f];
#pragma unroll
        for (int w = 1; w < NWARP; ++w) v = v + s_part[w][kk][f];
        s_sum[kk][f] = v;
      }
      __syncthreads();
      if (lin < ns) {
        const int k = sub + lin;
        const float* m = s_sum[lin];
        const float ca = s_f[F_CA][k], cb = s_f[F_CB][k], cc = s_f[F_CC][k];
        const float op = s_f[F_OP][k];
        float* o = grad + (size_t)perm[start + base + k] * NF;
        o[F_MX] = -(ca * m[1] + cb * m[2]);
        o[F_MY] = -(cc * m[2] + cb * m[1]);
        o[F_CA] = -0.5f * m[3];
        o[F_CB] = -m[4];
        o[F_CC] = -0.5f * m[5];
        o[F_OP] = m[0] / fmaxf(op, 1e-12f);
        o[F_R] = m[6];
        o[F_G] = m[7];
        o[F_B] = m[8];
        o[F_D] = m[9];
      }
    }
  }
}

}  // namespace
}  // namespace gvd

GVD_API int gvd_blend_bwd(const float* tab, int n, const int* inst_gauss, const int* perm,
                          const int* tile_start, const int* tile_count, const float* fwd_color,
                          const float* fwd_depth, const float* fwd_alpha, const float* d_color,
                          const float* d_depth, const float* d_alpha, int gx, int gy, int width,
                          int height, float* grad, cudaStream_t stream) {
  const int num_tiles = gx * gy;
  if (num_tiles > 0) {
    gvd::blend_bwd_kernel<<<num_tiles, gvd::TILE_PIX, 0, stream>>>(
        tab, n, inst_gauss, perm, tile_start, tile_count, fwd_color, fwd_depth, fwd_alpha,
        d_color, d_depth, d_alpha, gx, width, height, grad);
  }
  return (int)cudaGetLastError();
}
