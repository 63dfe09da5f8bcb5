// Kernel K1: per-Gaussian preprocess forward.
//
// Replaces the Pallas kernel guidedvd3dgs_tpu/ops/preprocess_pallas.py::
// preprocess_fused_fwd (body _fwd_kernel). Per Gaussian: view transform and
// near cull, 3D covariance from scale and rotation, EWA 2D covariance with
// the 0.3 low-pass, conic, 3-sigma radius, the tight alpha level-set
// extents, the screen mean (plus the optional screen offset of
// densification), and SH -> RGB up to `active_degree`. Output is the
// (16, N) f32 table of ops/preprocess_fused.py (rows 0-9 render fields, 10
// radius, 11 visible, 12/13 ext_x/ext_y, 14/15 zero).
//
// What bounds it on the H100: memory. A Gaussian reads 44 bytes of
// geometry (means, scales, rotation, opacity) and, at SH degree 3, 192 of
// SH, and writes 64; the few hundred flops are far below the card's ~20
// f32 flops per byte. One thread per Gaussian reading its own rows in the
// (N, k) layout the model holds reads 12 to 192 bytes apart from its
// neighbour (a warp's load of one coefficient touches 32 sectors for 4
// bytes of each), and most of a view's Gaussians fall in no tile, so
// their colour is never read. The design:
//   - a template on sh_degree (0-3), dispatched in the C entry: the basis
//     and the SH products are unrolled in registers, no array indexed at
//     run time, no stack; active_degree and scale_modifier stay runtime
//     arguments;
//   - a block of K1_THREADS consecutive Gaussians copies its contiguous
//     rows of rotations, means, scales and opacities into shared memory
//     with cp.async (slab.cuh: consecutive floats, coalesced), and each
//     thread reads its Gaussian's values there;
//   - the SH is read in place from two row sources, band 0 (features_dc,
//     (N, 1, 3)) and bands 1.. (features_rest, (N, K-1, 3)), each a
//     pointer and a row stride (a concatenated (N, K, 3) tensor is the
//     pointers shs and shs + 3 with stride 3K), so no concatenation is
//     made in front of the kernel;
//   - with `skip` (the tile rasterizer's call), each thread counts its
//     Gaussian's tiles as ops/tiling.py::tile_rects does (tile_count
//     below); a Gaussian without a tile has its SH not read and rows 6-8
//     written as 0 (K3, K4 and K5 read no row of it, and K2 computes its
//     colour itself). The block lists the Gaussians whose colour it
//     computes and copies their SH rows, (sh_degree + 1)^2 coefficients
//     each, into shared memory, consecutive floats by consecutive
//     threads; without `skip` every Gaussian is listed (the JAX kernel's
//     full table);
//   - output stays row-major (16, N): a warp's stores of one row are
//     coalesced. The camera constants are one small array read through
//     the read-only cache.
// Each thread's arithmetic is that of the thread-per-Gaussian kernel
// before it, in the same order (IEEE, -fmad=false; the double-rounded
// band constants), so the table is bitwise the same, rows 6-8 of the
// skipped Gaussians aside. The safe-where guards of the reference are
// kept: a culled row is still finite.

#include "slab.cuh"

namespace gvd {
namespace {

// scalar constexprs (arrays of them are not visible in device code)
constexpr double SH_C0 = 0.28209479177387814;
constexpr double SH_C1 = 0.4886025119029199;
constexpr double SH_C2_0 = 1.0925484305920792, SH_C2_1 = -1.0925484305920792,
                 SH_C2_2 = 0.31539156525252005, SH_C2_3 = -1.0925484305920792,
                 SH_C2_4 = 0.5462742152960396;
constexpr double SH_C3_0 = -0.5900435899266435, SH_C3_1 = 2.890611442640554,
                 SH_C3_2 = -0.4570457994644658, SH_C3_3 = 0.3731763325901154,
                 SH_C3_4 = -0.4570457994644658, SH_C3_5 = 1.445305721320277,
                 SH_C3_6 = -0.5900435899266435;

// Camera constant layout (ops/preprocess_fused.py::cam_consts):
// V[16] P[16] campos[3] focal_x focal_y limx limy
constexpr int CAM_V = 0, CAM_P = 16, CAM_POS = 32, CAM_FX = 35, CAM_FY = 36, CAM_LX = 37,
              CAM_LY = 38;

// Gaussians a block (PERF.md)
constexpr int K1_THREADS = 128;

// ops/tiling.py::_to_i32: clamp to +-2^30 (NaN stays NaN), then truncate
// toward zero (a NaN gives 0, as torch's cast does on the card)
__device__ __forceinline__ int to_i32(float v) {
  return (int)clamp_f(v, -1073741824.0f, 1073741824.0f);
}
__device__ __forceinline__ int clamp_grid(int v, int hi) { return min(max(v, 0), hi); }

// The number of tiles of one Gaussian: ops/tiling.py::tile_rects op by op
// in f32, at the screen mean (x, y) the binning reads (row 0-1, offset
// added) with the extents of rows 12-13 and radius = the int32 radius of
// preprocess_fused.visible_radii (0 when culled): the tight level-set
// rectangle (floor / floor + 1 tile bounds of x -+ ext), clamped to the
// gx x gy grid, intersected with the reference getRect of the radius; 0
// where the radius is 0.
__device__ __forceinline__ int tile_count(float x, float y, float ext_x, float ext_y, int radius,
                                          int gx, int gy) {
  const float T = (float)TILE;
  int min_x = clamp_grid(to_i32(floorf((x - ext_x) / T)), gx);
  int min_y = clamp_grid(to_i32(floorf((y - ext_y) / T)), gy);
  int max_x = clamp_grid(to_i32(floorf((x + ext_x) / T)) + 1, gx);
  int max_y = clamp_grid(to_i32(floorf((y + ext_y) / T)) + 1, gy);
  const float r = (float)radius;
  min_x = max(min_x, clamp_grid(to_i32((x - r) / T), gx));
  min_y = max(min_y, clamp_grid(to_i32((y - r) / T), gy));
  // x + r + TILE - 1, left to right as the Python expression
  max_x = min(max_x, clamp_grid(to_i32((((x + r) + T) - 1.0f) / T), gx));
  max_y = min(max_y, clamp_grid(to_i32((((y + r) + T) - 1.0f) / T), gy));
  const int w = max(max_x - min_x, 0), h = max(max_y - min_y, 0);
  return radius > 0 ? w * h : 0;
}

template <int D>
__global__ void __launch_bounds__(K1_THREADS)
    preprocess_fwd_kernel(const float* __restrict__ means, const float* __restrict__ scales,
                          const float* __restrict__ rots, const float* __restrict__ opac,
                          const float* __restrict__ sh_dc, int dc_stride,
                          const float* __restrict__ sh_rest, int rest_stride,
                          const float* __restrict__ cam, const float* __restrict__ offset,
                          float* __restrict__ out, int n, int active_degree, float scale_modifier,
                          int width, int height, int skip, int ld) {
  constexpr int n_coef = (D + 1) * (D + 1);
  constexpr int SHW = 3 * n_coef;   // SH floats a Gaussian's colour reads
  constexpr int SHS = SHW | 1;      // their row stride in shared memory (odd)
  __shared__ __align__(16) float s_rot[4 * K1_THREADS];
  __shared__ float s_mean[3 * K1_THREADS], s_scale[3 * K1_THREADS], s_op[K1_THREADS];
  __shared__ float s_sh[K1_THREADS * SHS];
  __shared__ int s_list[K1_THREADS];  // the block's Gaussians whose colour is computed
  __shared__ int s_count;

  const int i0 = blockIdx.x * K1_THREADS, rows = min(K1_THREADS, n - i0);
  fetch_rows(rots + 4 * (size_t)i0, 4, s_rot, rows, 4, 4);
  fetch_rows(means + 3 * (size_t)i0, 3, s_mean, rows, 3, 3);
  fetch_rows(scales + 3 * (size_t)i0, 3, s_scale, rows, 3, 3);
  fetch_rows(opac + i0, 1, s_op, rows, 1, 1);
  cp_async_commit();
  if (threadIdx.x == 0) s_count = 0;
  cp_async_wait<0>();
  __syncthreads();

  const int t = threadIdx.x, i = i0 + t;
  const size_t N = (size_t)ld;  // the table's row stride: n, or B n in a B-camera chain
  float* o = out + i;
  int slot = -1;                      // this Gaussian's row of s_sh, if it has one
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;  // its unit view direction
  if (t < rows) {
    const float* V = cam + CAM_V;
    const float* P = cam + CAM_P;
    const float mx = s_mean[3 * t], my = s_mean[3 * t + 1], mz = s_mean[3 * t + 2];
    // xform(mat, col) = mx*mat[0][col] + my*mat[1][col] + mz*mat[2][col] + mat[3][col]
    auto xform = [&](const float* M, int c) {
      return mx * __ldg(M + c) + my * __ldg(M + 4 + c) + mz * __ldg(M + 8 + c) + __ldg(M + 12 + c);
    };
    const float tvx = xform(V, 0), tvy = xform(V, 1), tvz = xform(V, 2);
    const float ph_x = xform(P, 0), ph_y = xform(P, 1), ph_w = xform(P, 3);

    const bool in_front = tvz > NEAR_CLIP;
    const float tz = in_front ? tvz : 1.0f;
    const float p_w = 1.0f / (in_front ? ph_w + 1e-7f : 1.0f);

    // 3D covariance: Sigma = R diag(s^2) R^T
    const float4 qv = reinterpret_cast<const float4*>(s_rot)[t];
    const float q0 = qv.x, q1 = qv.y, q2 = qv.z, q3 = qv.w;
    const float norm = sqrtf(clamp_min(q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3, 1e-20f));
    const float r = q0 / norm, x = q1 / norm, y = q2 / norm, z = q3 / norm;
    const float R[3][3] = {
        {1.0f - 2.0f * (y * y + z * z), 2.0f * (x * y - r * z), 2.0f * (x * z + r * y)},
        {2.0f * (x * y + r * z), 1.0f - 2.0f * (x * x + z * z), 2.0f * (y * z - r * x)},
        {2.0f * (x * z - r * y), 2.0f * (y * z + r * x), 1.0f - 2.0f * (x * x + y * y)}};
    float s2[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float s = clamp_max(scale_modifier * s_scale[3 * t + k], 1e9f);
      s2[k] = s * s;
    }
    auto sig = [&](int a, int b) {
      return s2[0] * R[a][0] * R[b][0] + s2[1] * R[a][1] * R[b][1] + s2[2] * R[a][2] * R[b][2];
    };
    const float c0 = sig(0, 0), c1 = sig(0, 1), c2 = sig(0, 2), c3 = sig(1, 1), c4 = sig(1, 2),
                c5 = sig(2, 2);

    // EWA projection
    const float focal_x = __ldg(cam + CAM_FX), focal_y = __ldg(cam + CAM_FY);
    const float limx = __ldg(cam + CAM_LX), limy = __ldg(cam + CAM_LY);
    const float txtz = clamp_f(tvx / tz, -limx, limx) * tz;
    const float tytz = clamp_f(tvy / tz, -limy, limy) * tz;
    const float j00 = focal_x / tz;
    const float j11 = focal_y / tz;
    const float j20 = -(focal_x * txtz) / (tz * tz);
    const float j21 = -(focal_y * tytz) / (tz * tz);
    float u[3], v[3];
#pragma unroll
    for (int row = 0; row < 3; ++row) {
      const float w0 = __ldg(V + 4 * row), w1 = __ldg(V + 4 * row + 1), w2 = __ldg(V + 4 * row + 2);
      u[row] = w0 * j00 + w2 * j20;
      v[row] = w1 * j11 + w2 * j21;
    }
    auto quad = [&](const float* a, const float* b) {
      return c0 * a[0] * b[0] + c3 * a[1] * b[1] + c5 * a[2] * b[2] +
             c1 * (a[0] * b[1] + a[1] * b[0]) + c2 * (a[0] * b[2] + a[2] * b[0]) +
             c4 * (a[1] * b[2] + a[2] * b[1]);
    };
    const float cxx = quad(u, u) + COV2D_DILATION;
    const float cxy = quad(u, v);
    const float cyy = quad(v, v) + COV2D_DILATION;

    const float det = cxx * cyy - cxy * cxy;
    const bool det_ok = (det != 0.0f) && isfinite(det);
    const float cxx_s = det_ok ? cxx : 1.0f;
    const float cxy_s = det_ok ? cxy : 0.0f;
    const float cyy_s = det_ok ? cyy : 1.0f;
    const float det_s = cxx_s * cyy_s - cxy_s * cxy_s;
    const float det_inv = 1.0f / det_s;
    const float conic_a = cyy_s * det_inv, conic_b = -cxy_s * det_inv, conic_c = cxx_s * det_inv;

    const float mid = 0.5f * (cxx_s + cyy_s);
    const float lambda1 = mid + sqrtf(clamp_min(mid * mid - det_s, 0.1f));
    const float radius =
        clamp_max(ceilf(3.0f * sqrtf(clamp_min(lambda1, 1e-12f))), 1073741824.0f);

    const float op = s_op[t];
    const float lvl = logf(clamp_min(op, 1e-12f) * 255.0f);
    float ext_x = fminf(sqrtf(clamp_min(2.0f * lvl * cxx_s, 0.0f)) * 1.001f, radius);
    float ext_y = fminf(sqrtf(clamp_min(2.0f * lvl * cyy_s, 0.0f)) * 1.001f, radius);
    if (!(lvl > 0.0f)) {
      ext_x = -16.0f;
      ext_y = -16.0f;
    }

    float mx2d = ((ph_x * p_w + 1.0f) * (float)width - 1.0f) * 0.5f;
    float my2d = ((ph_y * p_w + 1.0f) * (float)height - 1.0f) * 0.5f;
    if (offset != nullptr) {
      // the screen-space hook of densification: means2d + offset * (W/2, H/2)
      mx2d = mx2d + offset[2 * (size_t)i] * (0.5f * (float)width);
      my2d = my2d + offset[2 * (size_t)i + 1] * (0.5f * (float)height);
    }
    const bool visible = in_front && det_ok;

    o[0 * N] = mx2d;
    o[1 * N] = my2d;
    o[2 * N] = conic_a;
    o[3 * N] = conic_b;
    o[4 * N] = conic_c;
    o[5 * N] = op;
    o[9 * N] = tvz;
    o[10 * N] = radius;
    o[11 * N] = visible ? 1.0f : 0.0f;
    o[12 * N] = ext_x;
    o[13 * N] = ext_y;
    o[14 * N] = 0.0f;
    o[15 * N] = 0.0f;

    const int gx = (width + TILE - 1) / TILE, gy = (height + TILE - 1) / TILE;
    if (!skip || tile_count(mx2d, my2d, ext_x, ext_y, visible ? (int)radius : 0, gx, gy) > 0) {
      slot = atomicAdd(&s_count, 1);
      s_list[slot] = t;
      // the view direction of the SH
      dx = mx - __ldg(cam + CAM_POS);
      dy = my - __ldg(cam + CAM_POS + 1);
      dz = mz - __ldg(cam + CAM_POS + 2);
      const float inv_n = 1.0f / sqrtf(clamp_min(dx * dx + dy * dy + dz * dz, 1e-20f));
      dx = dx * inv_n;
      dy = dy * inv_n;
      dz = dz * inv_n;
    }
  }
  __syncthreads();

  // the listed Gaussians' SH rows: float c of row r is band c / 3's channel
  // c % 3, band 0 from sh_dc, the others from sh_rest
  const int listed = s_count;
  for (int e = threadIdx.x; e < listed * SHW; e += K1_THREADS) {
    const int row = e / SHW, c = e - row * SHW;
    const size_t g = (size_t)(i0 + s_list[row]);
    const float* src = c < 3 ? sh_dc + g * dc_stride + c : sh_rest + g * rest_stride + (c - 3);
    cp_async4(s_sh + row * SHS + c, src, true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (t >= rows) return;

  float rgb[3] = {0.0f, 0.0f, 0.0f};
  if (slot >= 0) {
    // SH -> RGB; bands above active_degree get a zero basis
    const double b1 = active_degree >= 1 ? 1.0 : 0.0;
    const double b2 = active_degree >= 2 ? 1.0 : 0.0;
    const double b3 = active_degree >= 3 ? 1.0 : 0.0;
    float basis[n_coef];
    basis[0] = (float)SH_C0;
    if constexpr (D > 0) {
      basis[1] = (float)(b1 * -SH_C1) * dy;
      basis[2] = (float)(b1 * SH_C1) * dz;
      basis[3] = (float)(b1 * -SH_C1) * dx;
      if constexpr (D > 1) {
        const float xx = dx * dx, yy = dy * dy, zz = dz * dz;
        const float xy = dx * dy, yz = dy * dz, xz = dx * dz;
        basis[4] = (float)(b2 * SH_C2_0) * xy;
        basis[5] = (float)(b2 * SH_C2_1) * yz;
        basis[6] = (float)(b2 * SH_C2_2) * (2.0f * zz - xx - yy);
        basis[7] = (float)(b2 * SH_C2_3) * xz;
        basis[8] = (float)(b2 * SH_C2_4) * (xx - yy);
        if constexpr (D > 2) {
          basis[9] = (float)(b3 * SH_C3_0) * dy * (3.0f * xx - yy);
          basis[10] = (float)(b3 * SH_C3_1) * xy * dz;
          basis[11] = (float)(b3 * SH_C3_2) * dy * (4.0f * zz - xx - yy);
          basis[12] = (float)(b3 * SH_C3_3) * dz * (2.0f * zz - 3.0f * xx - 3.0f * yy);
          basis[13] = (float)(b3 * SH_C3_4) * dx * (4.0f * zz - xx - yy);
          basis[14] = (float)(b3 * SH_C3_5) * dz * (xx - yy);
          basis[15] = (float)(b3 * SH_C3_6) * dx * (xx - 3.0f * yy);
        }
      }
    }
    const float* sh = s_sh + slot * SHS;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float acc = basis[0] * sh[ch];
#pragma unroll
      for (int k = 1; k < n_coef; ++k) acc = acc + basis[k] * sh[3 * k + ch];
      rgb[ch] = clamp_min(acc + 0.5f, 0.0f);
    }
  }
  o[6 * N] = rgb[0];
  o[7 * N] = rgb[1];
  o[8 * N] = rgb[2];
}

}  // namespace
}  // namespace gvd

// SH rows: band 0 at sh_dc, bands 1..(sh_degree + 1)^2 - 1 at sh_rest,
// dc_stride and rest_stride floats from one Gaussian's row to the next.
// offset: (n, 2) screen offsets or null. skip: rows 6-8 of the Gaussians
// without a tile are 0 and their SH is not read. ld >= n: the floats from
// one row of the table at out to the next (a camera's columns of a B-camera
// table start at out = table + c n, with ld = B n).
GVD_API int gvd_preprocess_fwd(const float* means, const float* scales, const float* rots,
                               const float* opac, const float* sh_dc, int dc_stride,
                               const float* sh_rest, int rest_stride, const float* cam,
                               const float* offset, float* out, int n, int sh_degree,
                               int active_degree, float scale_modifier, int width, int height,
                               int skip, int ld, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (ld < n) return (int)cudaErrorInvalidValue;
  decltype(&gvd::preprocess_fwd_kernel<0>) kernel;
  switch (sh_degree) {
    case 0: kernel = gvd::preprocess_fwd_kernel<0>; break;
    case 1: kernel = gvd::preprocess_fwd_kernel<1>; break;
    case 2: kernel = gvd::preprocess_fwd_kernel<2>; break;
    case 3: kernel = gvd::preprocess_fwd_kernel<3>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n + gvd::K1_THREADS - 1) / gvd::K1_THREADS;
  kernel<<<blocks, gvd::K1_THREADS, 0, stream>>>(means, scales, rots, opac, sh_dc, dc_stride,
                                                   sh_rest, rest_stride, cam, offset, out, n,
                                                   active_degree, scale_modifier, width, height,
                                                   skip, ld);
  return (int)cudaGetLastError();
}
