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
// The TPU kernel did the per-pixel work as (CHUNK, 256) matrix algebra and
// its sums as MXU moment products; here one thread is one pixel. Layout:
// one block of 256 threads per 16x16 tile. Instances come in rounds of
// 256, their fields gathered by owner id from K1's table into shared
// memory as one 16-byte-aligned row of 12 floats per instance (three
// broadcast 16-byte reads per instance, not ten 4-byte ones); each round
// is walked in sub-rounds of SUB instances.
//
// What bounds it on the H100: not the ~56 flops of a blended pair but, for
// every instance, the reduction of 10 sums over each warp's 32 pixels and
// the latency of one pixel's walk, which is sequential in T and the prefix
// sum. Ten separate xor butterflies cost 50 shuffles (and their selects
// and adds) for each (instance, warp with a live lane), issued one
// instance after another. The design:
//   - one transposed butterfly for two instances at a time: at offset 16
//     each lane keeps 10 of its 20 values and sends the other 10 to its
//     partner, then 10 -> 5 at offset 8, 6 -> 3 at 4 (one slot padded),
//     4 -> 2 at 2 (one padded) and 2 -> 1 at 1: 21 shuffles for 20 sums,
//     one chain of five dependent steps for two instances. Twenty lanes
//     then hold one finished sum each and store it at once;
//   - the geometry of both instances (offset, quadratic form, exp) first,
//     then their sequential part, so the two exps overlap;
//   - sub-rounds of 64 instances: half the block barriers of 32;
//   - the tiles with the longest lists start first (`tile_order`, from the
//     wrapper): a block walks its tile alone, so a long list that starts
//     late sets the kernel's end.
// Each sum is formed from the same pairs in the same order as the xor
// butterfly: at every level a lane adds its own partial sum of a value to
// its partner's partial sum of the same value, as both lanes did before,
// and a + b == b + a bitwise. The exp is taken where the kernel used to
// skip it (power > 0) but its value is used only where it was. So every
// output row is bitwise equal to the ten-butterfly kernel's. A warp with
// no live lane in either instance skips the shuffles and stores zeros.
//
// After a sub-round the 8 warp sums of each (instance, value) are added in
// warp order. No atomics: an instance belongs to one tile, so the result
// is deterministic and the tile order does not change it. The block stops
// when every pixel is done; instances it never reaches keep the zero the
// caller wrote.

#include "common.cuh"

namespace gvd {
namespace {

constexpr int NF = 10;     // fields per instance, and gradient values per instance
constexpr int NWARP = TILE_PIX / 32;
constexpr int SUB = 64;    // instances per sub-round
// per-pixel sums: S0, Mx, My, Mxx, Mxy, Myy, w dC (3), w dD
constexpr int NS = 10;
constexpr unsigned FULL = 0xffffffffu;

// The warp's sums of the 2 NS values s[] (two instances) over its 32
// lanes, by the transposed butterfly: 20 -> 10 at offset 16, 10 -> 5 at 8,
// 6 -> 3 at 4 (one slot padded), 4 -> 2 at 2 (one padded), 2 -> 1 at 1.
// Lane l ends with the sum of value pair_slot(l).
__device__ __forceinline__ float warp_sums2(const float (&s)[2 * NS], int lane) {
  const bool b16 = lane & 16, b8 = lane & 8, b4 = lane & 4, b2 = lane & 2, b1 = lane & 1;
  float a[NS];
#pragma unroll
  for (int f = 0; f < NS; ++f) {
    const float send = b16 ? s[f] : s[f + NS];
    const float keep = b16 ? s[f + NS] : s[f];
    a[f] = keep + __shfl_xor_sync(FULL, send, 16);
  }
  float b[6];
#pragma unroll
  for (int f = 0; f < 5; ++f) {
    const float send = b8 ? a[f] : a[f + 5];
    const float keep = b8 ? a[f + 5] : a[f];
    b[f] = keep + __shfl_xor_sync(FULL, send, 8);
  }
  b[5] = 0.0f;
  float c[4];
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const float send = b4 ? b[f] : b[f + 3];
    const float keep = b4 ? b[f + 3] : b[f];
    c[f] = keep + __shfl_xor_sync(FULL, send, 4);
  }
  c[3] = 0.0f;
  float d[2];
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const float send = b2 ? c[f] : c[f + 2];
    const float keep = b2 ? c[f + 2] : c[f];
    d[f] = keep + __shfl_xor_sync(FULL, send, 2);
  }
  const float send = b1 ? d[0] : d[1];
  return (b1 ? d[1] : d[0]) + __shfl_xor_sync(FULL, send, 1);
}

// The value (instance * NS + sum) whose sum a lane holds after
// warp_sums2, or -1 (the padded slots).
__device__ __forceinline__ int pair_slot(int lane) {
  const int ci = ((lane & 2) ? 2 : 0) + (lane & 1);  // slot of c[]
  const int bj = ((lane & 4) ? 3 : 0) + ci;          // slot of b[]
  if (ci >= 3 || bj >= 5) return -1;
  return ((lane & 16) ? NS : 0) + ((lane & 8) ? 5 : 0) + bj;
}

__global__ void __launch_bounds__(TILE_PIX)
    blend_bwd_kernel(const float* __restrict__ tab, int n, const int* __restrict__ inst_gauss,
                     const int* __restrict__ perm, const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, const int* __restrict__ tile_order,
                     const float* __restrict__ fwd_color, const float* __restrict__ fwd_depth,
                     const float* __restrict__ fwd_alpha,
                     const float* __restrict__ d_color, const float* __restrict__ d_depth,
                     const float* __restrict__ d_alpha, int gx, int width, int height,
                     float* __restrict__ grad, int gy_cam) {
  // per instance: (mx, my, a, b) (c, op, r, g) (b, d, -, -)
  __shared__ float4 s_f[TILE_PIX][3];
  __shared__ float s_part[NWARP][SUB][NS];
  __shared__ float s_sum[SUB][NS];
  const int t = tile_order[blockIdx.x];
  const int lin = threadIdx.x;
  const int lane = lin & 31, warp = lin >> 5;
  const int slot = pair_slot(lane);
  // the tile's camera (band) and its pixel in that camera's image
  const int cam = t / (gx * gy_cam), tl = t - cam * (gx * gy_cam);
  const int px = (tl % gx) * TILE + lin % TILE;
  const int py = (tl / gx) * TILE + lin / TILE;
  const bool inside = px < width && py < height;
  const float pxf = (float)px, pyf = (float)py;
  const int start = tile_start[t];
  const int cnt = tile_count[t];
  const size_t N = (size_t)n;

  float dcr = 0.0f, dcg = 0.0f, dcb = 0.0f, dd = 0.0f, da = 0.0f, U = 0.0f;
  if (inside) {
    const size_t hw = (size_t)height * width;
    const size_t p = (size_t)cam * 3 * hw + (size_t)py * width + px;
    const size_t pa = (size_t)cam * hw + (size_t)py * width + px;
    dcr = d_color[p];
    dcg = d_color[hw + p];
    dcb = d_color[2 * hw + p];
    dd = d_depth[pa];
    da = d_alpha[pa];
    U = fwd_color[p] * dcr + fwd_color[hw + p] * dcg + fwd_color[2 * hw + p] * dcb;
    U = U + fwd_depth[pa] * dd + fwd_alpha[pa] * da;
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
      float v[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) v[f] = __ldg(tab + f * N + g);
      s_f[lin][0] = make_float4(v[0], v[1], v[2], v[3]);
      s_f[lin][1] = make_float4(v[4], v[5], v[6], v[7]);
      s_f[lin][2] = make_float4(v[8], v[9], 0.0f, 0.0f);
    }
    __syncthreads();
    const int nb = min(TILE_PIX, cnt - base);
    for (int sub = 0; sub < nb; sub += SUB) {
      if (sub > 0 && __syncthreads_count(done) == TILE_PIX) {
        all_done = true;
        break;
      }
      const int ns = min(SUB, nb - sub);
      // two instances a butterfly; the geometry of both first
      for (int kk = 0; kk < ns; kk += 2) {
        float4 f0[2], f1[2], f2[2];
        float dx[2], dy[2], power[2], araw[2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int k = sub + kk + p;  // past ns only as a value never used (k < TILE_PIX)
          f0[p] = s_f[k][0];
          f1[p] = s_f[k][1];
          f2[p] = s_f[k][2];
          dx[p] = f0[p].x - pxf;
          dy[p] = f0[p].y - pyf;
          power[p] = -0.5f * (f0[p].z * dx[p] * dx[p] + f1[p].x * dy[p] * dy[p]) -
                     f0[p].w * dx[p] * dy[p];
          araw[p] = f1[p].y * expf(power[p]);
        }
        float s[2 * NS];
#pragma unroll
        for (int f = 0; f < 2 * NS; ++f) s[f] = 0.0f;
        bool live = false;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          if (!done && kk + p < ns && power[p] <= 0.0f && araw[p] >= ALPHA_EPS) {
            const float alpha = fminf(ALPHA_MAX, araw[p]);
            const float test_t = T * (1.0f - alpha);
            if (test_t < T_EPS) {
              done = true;
            } else {
              const float w = alpha * T;
              const float u = f1[p].z * dcr + f1[p].w * dcg + f2[p].x * dcb + f2[p].y * dd + da;
              prefix = prefix + w * u;
              const float S = U - prefix;
              const float dalpha = T * u - S / fmaxf(1.0f - alpha, 1e-3f);
              const float gp = dalpha * araw[p];
              float* o = s + p * NS;
              o[0] = gp;
              o[1] = gp * dx[p];
              o[2] = gp * dy[p];
              o[3] = gp * dx[p] * dx[p];
              o[4] = gp * dx[p] * dy[p];
              o[5] = gp * dy[p] * dy[p];
              o[6] = w * dcr;
              o[7] = w * dcg;
              o[8] = w * dcb;
              o[9] = w * dd;
              T = test_t;
              live = true;
            }
          }
        }
        // one warp-uniform branch: every lane takes part in the shuffles
        float sum = 0.0f;
        if (__ballot_sync(FULL, live)) sum = warp_sums2(s, lane);
        if (slot >= 0 && kk + slot / NS < ns) s_part[warp][kk + slot / NS][slot % NS] = sum;
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
        const float4 f0 = s_f[k][0], f1 = s_f[k][1];
        const float ca = f0.z, cb = f0.w, cc = f1.x, op = f1.y;
        // a row is 40 bytes: five aligned 8-byte stores
        float2* o = reinterpret_cast<float2*>(grad + (size_t)perm[start + base + k] * NF);
        o[0] = make_float2(-(ca * m[1] + cb * m[2]), -(cc * m[2] + cb * m[1]));
        o[1] = make_float2(-0.5f * m[3], -m[4]);
        o[2] = make_float2(-0.5f * m[5], m[0] / fmaxf(op, 1e-12f));
        o[3] = make_float2(m[6], m[7]);
        o[4] = make_float2(m[8], m[9]);
      }
    }
  }
}

}  // namespace
}  // namespace gvd

// tile_order: the tiles in the order their blocks start (a permutation)
// gy_cam: the tile rows of one camera; gy = B gy_cam stacks B cameras' grids
// as bands, with the images and cotangents (B, 3, height, width) and
// (B, height, width) (one camera: gy_cam = gy)
GVD_API int gvd_blend_bwd(const float* tab, int n, const int* inst_gauss, const int* perm,
                          const int* tile_start, const int* tile_count, const int* tile_order,
                          const float* fwd_color, const float* fwd_depth, const float* fwd_alpha,
                          const float* d_color, const float* d_depth, const float* d_alpha, int gx,
                          int gy, int width, int height, float* grad, int gy_cam,
                          cudaStream_t stream) {
  const int num_tiles = gx * gy;
  if (gy_cam <= 0 || gy % gy_cam) return (int)cudaErrorInvalidValue;
  if (num_tiles > 0) {
    gvd::blend_bwd_kernel<<<num_tiles, gvd::TILE_PIX, 0, stream>>>(
        tab, n, inst_gauss, perm, tile_start, tile_count, tile_order, fwd_color, fwd_depth,
        fwd_alpha, d_color, d_depth, d_alpha, gx, width, height, grad, gy_cam);
  }
  return (int)cudaGetLastError();
}
