// Kernel K1: per-Gaussian preprocess forward.
//
// Replaces the Pallas kernel guidedvd3dgs_tpu/ops/preprocess_pallas.py::
// preprocess_fused_fwd (body _fwd_kernel). Per Gaussian: view transform and
// near cull, 3D covariance from scale and rotation, EWA 2D covariance with
// the 0.3 low-pass, conic, 3-sigma radius, the tight alpha level-set
// extents, the screen mean, and SH -> RGB up to `active_degree`. Output is
// the (16, N) f32 table of ops/preprocess_fused.py (rows 0-9 render
// fields, 10 radius, 11 visible, 12/13 ext_x/ext_y, 14/15 zero).
//
// What bounds it on the card: memory. At SH degree 3 a Gaussian reads
// 4 * (3 + 3 + 4 + 1 + 48) = 236 bytes and writes 64; the arithmetic is a
// few hundred flops, far below the H100's ratio of ~20 f32 flops per byte.
// Design: one thread per Gaussian, as the CUDA original's preprocessCUDA.
// Reads are in the (N, 3) / (N, 4) / (N, K, 3) row layout the model holds
// (the TPU kernel transposed to rows to fill its lanes); writes are
// row-major (16, N), so a warp's stores of one row are coalesced. The
// camera constants are one small array every thread reads through the
// read-only cache. The safe-where guards of the reference are kept: a
// culled row is still finite.

#include "common.cuh"

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

__global__ void preprocess_fwd_kernel(const float* __restrict__ means,
                                      const float* __restrict__ scales,
                                      const float* __restrict__ rots,
                                      const float* __restrict__ opac,
                                      const float* __restrict__ shs,
                                      const float* __restrict__ cam, float* __restrict__ out,
                                      int n, int k_total, int sh_degree, int active_degree,
                                      float scale_modifier, int width, int height) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* V = cam + CAM_V;
  const float* P = cam + CAM_P;

  const float mx = means[3 * i], my = means[3 * i + 1], mz = means[3 * i + 2];
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
  const float q0 = rots[4 * i], q1 = rots[4 * i + 1], q2 = rots[4 * i + 2], q3 = rots[4 * i + 3];
  const float norm = sqrtf(clamp_min(q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3, 1e-20f));
  const float r = q0 / norm, x = q1 / norm, y = q2 / norm, z = q3 / norm;
  const float R[3][3] = {
      {1.0f - 2.0f * (y * y + z * z), 2.0f * (x * y - r * z), 2.0f * (x * z + r * y)},
      {2.0f * (x * y + r * z), 1.0f - 2.0f * (x * x + z * z), 2.0f * (y * z - r * x)},
      {2.0f * (x * z - r * y), 2.0f * (y * z + r * x), 1.0f - 2.0f * (x * x + y * y)}};
  float s2[3];
  for (int k = 0; k < 3; ++k) {
    const float s = clamp_max(scale_modifier * scales[3 * i + k], 1e9f);
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
  const float radius = clamp_max(ceilf(3.0f * sqrtf(clamp_min(lambda1, 1e-12f))), 1073741824.0f);

  const float op = opac[i];
  const float lvl = logf(clamp_min(op, 1e-12f) * 255.0f);
  float ext_x = fminf(sqrtf(clamp_min(2.0f * lvl * cxx_s, 0.0f)) * 1.001f, radius);
  float ext_y = fminf(sqrtf(clamp_min(2.0f * lvl * cyy_s, 0.0f)) * 1.001f, radius);
  if (!(lvl > 0.0f)) {
    ext_x = -16.0f;
    ext_y = -16.0f;
  }

  const float mx2d = ((ph_x * p_w + 1.0f) * (float)width - 1.0f) * 0.5f;
  const float my2d = ((ph_y * p_w + 1.0f) * (float)height - 1.0f) * 0.5f;

  // SH -> RGB; bands above active_degree get a zero basis
  float dx = mx - __ldg(cam + CAM_POS), dy = my - __ldg(cam + CAM_POS + 1),
        dz = mz - __ldg(cam + CAM_POS + 2);
  const float inv_n = 1.0f / sqrtf(clamp_min(dx * dx + dy * dy + dz * dz, 1e-20f));
  dx = dx * inv_n;
  dy = dy * inv_n;
  dz = dz * inv_n;
  const double b1 = active_degree >= 1 ? 1.0 : 0.0;
  const double b2 = active_degree >= 2 ? 1.0 : 0.0;
  const double b3 = active_degree >= 3 ? 1.0 : 0.0;
  float basis[16];
  const int n_coef = (sh_degree + 1) * (sh_degree + 1);
  basis[0] = (float)SH_C0;
  if (sh_degree > 0) {
    basis[1] = (float)(b1 * -SH_C1) * dy;
    basis[2] = (float)(b1 * SH_C1) * dz;
    basis[3] = (float)(b1 * -SH_C1) * dx;
    if (sh_degree > 1) {
      const float xx = dx * dx, yy = dy * dy, zz = dz * dz;
      const float xy = dx * dy, yz = dy * dz, xz = dx * dz;
      basis[4] = (float)(b2 * SH_C2_0) * xy;
      basis[5] = (float)(b2 * SH_C2_1) * yz;
      basis[6] = (float)(b2 * SH_C2_2) * (2.0f * zz - xx - yy);
      basis[7] = (float)(b2 * SH_C2_3) * xz;
      basis[8] = (float)(b2 * SH_C2_4) * (xx - yy);
      if (sh_degree > 2) {
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
  const float* sh = shs + (size_t)i * k_total * 3;
  float rgb[3];
  for (int ch = 0; ch < 3; ++ch) {
    float acc = basis[0] * sh[ch];
    for (int k = 1; k < n_coef; ++k) acc = acc + basis[k] * sh[3 * k + ch];
    rgb[ch] = clamp_min(acc + 0.5f, 0.0f);
  }

  const bool visible = in_front && det_ok;
  const size_t N = (size_t)n;
  float* o = out + i;
  o[0 * N] = mx2d;
  o[1 * N] = my2d;
  o[2 * N] = conic_a;
  o[3 * N] = conic_b;
  o[4 * N] = conic_c;
  o[5 * N] = op;
  o[6 * N] = rgb[0];
  o[7 * N] = rgb[1];
  o[8 * N] = rgb[2];
  o[9 * N] = tvz;
  o[10 * N] = radius;
  o[11 * N] = visible ? 1.0f : 0.0f;
  o[12 * N] = ext_x;
  o[13 * N] = ext_y;
  o[14 * N] = 0.0f;
  o[15 * N] = 0.0f;
}

}  // namespace
}  // namespace gvd

GVD_API int gvd_preprocess_fwd(const float* means, const float* scales, const float* rots,
                               const float* opac, const float* shs, const float* cam,
                               float* out, int n, int k_total, int sh_degree,
                               int active_degree, float scale_modifier, int width, int height,
                               cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    gvd::preprocess_fwd_kernel<<<blocks, threads, 0, stream>>>(
        means, scales, rots, opac, shs, cam, out, n, k_total, sh_degree, active_degree,
        scale_modifier, width, height);
  }
  return (int)cudaGetLastError();
}
