// Kernel K2: per-Gaussian preprocess backward (the VJP of K1).
//
// Replaces the Pallas kernel guidedvd3dgs_tpu/ops/preprocess_pallas.py::
// preprocess_fused_bwd (body _bwd_kernel), which is jax.vjp of
// projection.preprocess_field_rows traced inside the kernel. Given the
// cotangents of the 10 render fields (mx2d, my2d, conic a/b/c, opacity,
// r/g/b, depth) it returns the gradients of the post-activation means
// (N,3), scales (N,3), rotations (N,4), opacity (N) and SH (N,K,3). Like
// the TPU kernel it keeps no residuals: each thread recomputes its
// Gaussian's forward (K1's formulas, op by op) and then runs the reverse
// sweep written out by hand. It follows the autodiff semantics of the
// plain version (ops/projection.py::preprocess_field_rows under
// torch.autograd):
//   - the safe-where guards are constants on culled rows (tz = 1, p_w = 1;
//     a non-invertible cov2D keeps the identity), so no gradient flows
//     through them;
//   - a clamp passes the gradient only where its input is inside the
//     bounds (inclusive), so an active clip of t.x/t.z or t.y/t.z to
//     +-1.3 tanfov, an RGB clamped at 0, a scale above 1e9 or a quaternion
//     norm^2 below 1e-20 passes none;
//   - SH bands above active_degree have a zero basis, hence zero gradient
//     for their coefficients and for the view direction;
//   - the view direction of the SH carries gradient into the means;
//   - the quaternion normalisation, the 0.3 low-pass and the conic inverse
//     are differentiated as written.
//
// What bounds it on the card: memory. A Gaussian reads 236 bytes of
// parameters and 40 of cotangents and writes 236 bytes of gradients (SH
// degree 3); the ~600 flops of the sweep are below the H100's ~20 f32
// flops per byte. Design: one thread per Gaussian in the (N, k) row layout
// the model holds, as K1; the camera row through the read-only cache. The
// cov3D part is the matrix form of the CUDA original's
// computeCov3D backward (backward.cu:603-669).

#include "common.cuh"

namespace gvd {
namespace {

constexpr double SH_C0 = 0.28209479177387814;
constexpr double SH_C1 = 0.4886025119029199;
constexpr double SH_C2_0 = 1.0925484305920792, SH_C2_1 = -1.0925484305920792,
                 SH_C2_2 = 0.31539156525252005, SH_C2_3 = -1.0925484305920792,
                 SH_C2_4 = 0.5462742152960396;
constexpr double SH_C3_0 = -0.5900435899266435, SH_C3_1 = 2.890611442640554,
                 SH_C3_2 = -0.4570457994644658, SH_C3_3 = 0.3731763325901154,
                 SH_C3_4 = -0.4570457994644658, SH_C3_5 = 1.445305721320277,
                 SH_C3_6 = -0.5900435899266435;

// camera row (ops/preprocess_fused.py::cam_consts)
constexpr int CAM_V = 0, CAM_P = 16, CAM_POS = 32, CAM_FX = 35, CAM_FY = 36, CAM_LX = 37,
              CAM_LY = 38;

__device__ __forceinline__ bool inside(float x, float lo, float hi) { return x >= lo && x <= hi; }

__global__ void preprocess_bwd_kernel(const float* __restrict__ means,
                                      const float* __restrict__ scales,
                                      const float* __restrict__ rots,
                                      const float* __restrict__ shs,
                                      const float* __restrict__ cam,
                                      const float* __restrict__ cot, int n, int k_total,
                                      int sh_degree, int active_degree, float scale_modifier,
                                      int width, int height, float* __restrict__ g_means,
                                      float* __restrict__ g_scales, float* __restrict__ g_rots,
                                      float* __restrict__ g_opac, float* __restrict__ g_shs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* V = cam + CAM_V;
  const float* P = cam + CAM_P;
  const size_t N = (size_t)n;
  const float c_mx = cot[i], c_my = cot[N + i], c_ca = cot[2 * N + i], c_cb = cot[3 * N + i],
              c_cc = cot[4 * N + i], c_op = cot[5 * N + i], c_r = cot[6 * N + i],
              c_g = cot[7 * N + i], c_b = cot[8 * N + i], c_dep = cot[9 * N + i];

  // ---------------- forward recompute (K1's formulas) ----------------
  const float mx = means[3 * i], my = means[3 * i + 1], mz = means[3 * i + 2];
  auto xform = [&](const float* M, int c) {
    return mx * __ldg(M + c) + my * __ldg(M + 4 + c) + mz * __ldg(M + 8 + c) + __ldg(M + 12 + c);
  };
  const float tvx = xform(V, 0), tvy = xform(V, 1), tvz = xform(V, 2);
  const float ph_x = xform(P, 0), ph_y = xform(P, 1), ph_w = xform(P, 3);
  const bool in_front = tvz > NEAR_CLIP;
  const float tz = in_front ? tvz : 1.0f;
  const float p_w = 1.0f / (in_front ? ph_w + 1e-7f : 1.0f);

  const float q0 = rots[4 * i], q1 = rots[4 * i + 1], q2 = rots[4 * i + 2], q3 = rots[4 * i + 3];
  const float qq = q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3;
  const float norm = sqrtf(clamp_min(qq, 1e-20f));
  const float r = q0 / norm, x = q1 / norm, y = q2 / norm, z = q3 / norm;
  const float R[3][3] = {
      {1.0f - 2.0f * (y * y + z * z), 2.0f * (x * y - r * z), 2.0f * (x * z + r * y)},
      {2.0f * (x * y + r * z), 1.0f - 2.0f * (x * x + z * z), 2.0f * (y * z - r * x)},
      {2.0f * (x * z - r * y), 2.0f * (y * z + r * x), 1.0f - 2.0f * (x * x + y * y)}};
  float s_in[3], s[3], s2[3];
  for (int k = 0; k < 3; ++k) {
    s_in[k] = scale_modifier * scales[3 * i + k];
    s[k] = clamp_max(s_in[k], 1e9f);
    s2[k] = s[k] * s[k];
  }
  auto sig = [&](int a, int b) {
    return s2[0] * R[a][0] * R[b][0] + s2[1] * R[a][1] * R[b][1] + s2[2] * R[a][2] * R[b][2];
  };
  // Sigma as a full symmetric matrix (c0 xx, c1 xy, c2 xz, c3 yy, c4 yz, c5 zz)
  const float c0 = sig(0, 0), c1 = sig(0, 1), c2 = sig(0, 2), c3 = sig(1, 1), c4 = sig(1, 2),
              c5 = sig(2, 2);
  const float Sg[3][3] = {{c0, c1, c2}, {c1, c3, c4}, {c2, c4, c5}};

  const float focal_x = __ldg(cam + CAM_FX), focal_y = __ldg(cam + CAM_FY);
  const float limx = __ldg(cam + CAM_LX), limy = __ldg(cam + CAM_LY);
  const float qx = tvx / tz, qy = tvy / tz;
  const float cqx = clamp_f(qx, -limx, limx), cqy = clamp_f(qy, -limy, limy);
  const float txtz = cqx * tz;
  const float tytz = cqy * tz;
  const float tz2 = tz * tz;
  const float j00 = focal_x / tz;
  const float j11 = focal_y / tz;
  const float j20 = -(focal_x * txtz) / tz2;
  const float j21 = -(focal_y * tytz) / tz2;
  float W[3][3];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) W[a][b] = __ldg(V + 4 * a + b);
  float u[3], v[3];
  for (int row = 0; row < 3; ++row) {
    u[row] = W[row][0] * j00 + W[row][2] * j20;
    v[row] = W[row][1] * j11 + W[row][2] * j21;
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

  float dx0 = mx - __ldg(cam + CAM_POS), dy0 = my - __ldg(cam + CAM_POS + 1),
        dz0 = mz - __ldg(cam + CAM_POS + 2);
  const float nn = dx0 * dx0 + dy0 * dy0 + dz0 * dz0;
  const float sq = sqrtf(clamp_min(nn, 1e-20f));
  const float inv_n = 1.0f / sq;
  const float dx = dx0 * inv_n, dy = dy0 * inv_n, dz = dz0 * inv_n;
  const double b1 = active_degree >= 1 ? 1.0 : 0.0;
  const double b2 = active_degree >= 2 ? 1.0 : 0.0;
  const double b3 = active_degree >= 3 ? 1.0 : 0.0;
  // basis scalers (band mask times constant), as the forward multiplies them
  const float K1c = (float)(b1 * -SH_C1), K2c = (float)(b1 * SH_C1), K3c = (float)(b1 * -SH_C1);
  const float K4c = (float)(b2 * SH_C2_0), K5c = (float)(b2 * SH_C2_1), K6c = (float)(b2 * SH_C2_2),
              K7c = (float)(b2 * SH_C2_3), K8c = (float)(b2 * SH_C2_4);
  const float K9c = (float)(b3 * SH_C3_0), K10c = (float)(b3 * SH_C3_1),
              K11c = (float)(b3 * SH_C3_2), K12c = (float)(b3 * SH_C3_3),
              K13c = (float)(b3 * SH_C3_4), K14c = (float)(b3 * SH_C3_5),
              K15c = (float)(b3 * SH_C3_6);
  const float xx = dx * dx, yy = dy * dy, zz = dz * dz;
  const float xy = dx * dy, yz = dy * dz, xz = dx * dz;
  float basis[16];
  const int n_coef = (sh_degree + 1) * (sh_degree + 1);
  basis[0] = (float)SH_C0;
  if (sh_degree > 0) {
    basis[1] = K1c * dy;
    basis[2] = K2c * dz;
    basis[3] = K3c * dx;
    if (sh_degree > 1) {
      basis[4] = K4c * xy;
      basis[5] = K5c * yz;
      basis[6] = K6c * (2.0f * zz - xx - yy);
      basis[7] = K7c * xz;
      basis[8] = K8c * (xx - yy);
      if (sh_degree > 2) {
        basis[9] = K9c * dy * (3.0f * xx - yy);
        basis[10] = K10c * xy * dz;
        basis[11] = K11c * dy * (4.0f * zz - xx - yy);
        basis[12] = K12c * dz * (2.0f * zz - 3.0f * xx - 3.0f * yy);
        basis[13] = K13c * dx * (4.0f * zz - xx - yy);
        basis[14] = K14c * dz * (xx - yy);
        basis[15] = K15c * dx * (xx - 3.0f * yy);
      }
    }
  }
  const float* sh = shs + (size_t)i * k_total * 3;
  const float c_rgb[3] = {c_r, c_g, c_b};
  float g_rgb[3];
  for (int ch = 0; ch < 3; ++ch) {
    float acc = basis[0] * sh[ch];
    for (int k = 1; k < n_coef; ++k) acc = acc + basis[k] * sh[3 * k + ch];
    g_rgb[ch] = (acc + 0.5f >= 0.0f) ? c_rgb[ch] : 0.0f;  // clamp(min=0) passes at >= 0
  }

  // ---------------- reverse sweep ----------------
  // SH coefficients and the basis
  float* gsh = g_shs + (size_t)i * k_total * 3;
  float gb[16];
  for (int k = 0; k < k_total; ++k) {
    for (int ch = 0; ch < 3; ++ch) gsh[3 * k + ch] = k < n_coef ? basis[k] * g_rgb[ch] : 0.0f;
  }
  for (int k = 0; k < n_coef; ++k)
    gb[k] = sh[3 * k] * g_rgb[0] + sh[3 * k + 1] * g_rgb[1] + sh[3 * k + 2] * g_rgb[2];
  float gdx = 0.0f, gdy = 0.0f, gdz = 0.0f;  // gradient of the unit direction
  if (sh_degree > 0) {
    gdy += K1c * gb[1];
    gdz += K2c * gb[2];
    gdx += K3c * gb[3];
    if (sh_degree > 1) {
      gdx += K4c * dy * gb[4];
      gdy += K4c * dx * gb[4];
      gdy += K5c * dz * gb[5];
      gdz += K5c * dy * gb[5];
      gdx += K6c * (-2.0f * dx) * gb[6];
      gdy += K6c * (-2.0f * dy) * gb[6];
      gdz += K6c * (4.0f * dz) * gb[6];
      gdx += K7c * dz * gb[7];
      gdz += K7c * dx * gb[7];
      gdx += K8c * (2.0f * dx) * gb[8];
      gdy += K8c * (-2.0f * dy) * gb[8];
      if (sh_degree > 2) {
        gdx += K9c * (6.0f * xy) * gb[9];
        gdy += K9c * (3.0f * xx - 3.0f * yy) * gb[9];
        gdx += K10c * yz * gb[10];
        gdy += K10c * xz * gb[10];
        gdz += K10c * xy * gb[10];
        gdx += K11c * (-2.0f * xy) * gb[11];
        gdy += K11c * (4.0f * zz - xx - 3.0f * yy) * gb[11];
        gdz += K11c * (8.0f * yz) * gb[11];
        gdx += K12c * (-6.0f * xz) * gb[12];
        gdy += K12c * (-6.0f * yz) * gb[12];
        gdz += K12c * (6.0f * zz - 3.0f * xx - 3.0f * yy) * gb[12];
        gdx += K13c * (4.0f * zz - 3.0f * xx - yy) * gb[13];
        gdy += K13c * (-2.0f * xy) * gb[13];
        gdz += K13c * (8.0f * xz) * gb[13];
        gdx += K14c * (2.0f * xz) * gb[14];
        gdy += K14c * (-2.0f * yz) * gb[14];
        gdz += K14c * (xx - yy) * gb[14];
        gdx += K15c * (3.0f * xx - 3.0f * yy) * gb[15];
        gdy += K15c * (-6.0f * xy) * gb[15];
      }
    }
  }
  // d = d0 * inv_n, inv_n = 1 / sqrt(clamp_min(|d0|^2, 1e-20))
  const float g_inv = gdx * dx0 + gdy * dy0 + gdz * dz0;
  const float g_sq = -g_inv * inv_n * inv_n;
  const float g_nn = nn >= 1e-20f ? g_sq * 0.5f / sq : 0.0f;
  float gm[3] = {gdx * inv_n + 2.0f * dx0 * g_nn, gdy * inv_n + 2.0f * dy0 * g_nn,
                 gdz * inv_n + 2.0f * dz0 * g_nn};

  // screen mean: mx2d = ((ph_x p_w + 1) W - 1) / 2
  const float a_x = c_mx * (0.5f * (float)width);
  const float a_y = c_my * (0.5f * (float)height);
  const float g_phx = a_x * p_w, g_phy = a_y * p_w;
  const float g_pw = a_x * ph_x + a_y * ph_y;
  const float g_phw = in_front ? -g_pw * p_w * p_w : 0.0f;

  // conic = (cyy, -cxy, cxx) / det_s
  float g_cxx = c_cc * det_inv, g_cxy = -c_cb * det_inv, g_cyy = c_ca * det_inv;
  const float g_dinv = c_ca * cyy_s - c_cb * cxy_s + c_cc * cxx_s;
  const float g_det = -g_dinv * det_inv * det_inv;
  g_cxx += g_det * cyy_s;
  g_cyy += g_det * cxx_s;
  g_cxy += -2.0f * cxy_s * g_det;
  if (!det_ok) g_cxx = g_cxy = g_cyy = 0.0f;

  // cov2D: cxx = u'Su + 0.3, cxy = u'Sv, cyy = v'Sv + 0.3
  float Su[3], Sv[3];
  for (int a = 0; a < 3; ++a) {
    Su[a] = Sg[a][0] * u[0] + Sg[a][1] * u[1] + Sg[a][2] * u[2];
    Sv[a] = Sg[a][0] * v[0] + Sg[a][1] * v[1] + Sg[a][2] * v[2];
  }
  float gu[3], gv[3];
  for (int a = 0; a < 3; ++a) {
    gu[a] = 2.0f * g_cxx * Su[a] + g_cxy * Sv[a];
    gv[a] = g_cxy * Su[a] + 2.0f * g_cyy * Sv[a];
  }
  // gradient of Sigma as a symmetric matrix G (dL = sum_ab G_ab dSigma_ab)
  float G[3][3];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b)
      G[a][b] = g_cxx * u[a] * u[b] + 0.5f * g_cxy * (u[a] * v[b] + v[a] * u[b]) +
                g_cyy * v[a] * v[b];

  // Jacobian columns through u, v
  const float g_j00 = gu[0] * W[0][0] + gu[1] * W[1][0] + gu[2] * W[2][0];
  const float g_j20 = gu[0] * W[0][2] + gu[1] * W[1][2] + gu[2] * W[2][2];
  const float g_j11 = gv[0] * W[0][1] + gv[1] * W[1][1] + gv[2] * W[2][1];
  const float g_j21 = gv[0] * W[0][2] + gv[1] * W[1][2] + gv[2] * W[2][2];
  float g_tz = -g_j00 * focal_x / tz2 - g_j11 * focal_y / tz2;
  const float g_txtz = -g_j20 * focal_x / tz2;
  const float g_tytz = -g_j21 * focal_y / tz2;
  g_tz += g_j20 * 2.0f * focal_x * txtz / (tz2 * tz) + g_j21 * 2.0f * focal_y * tytz / (tz2 * tz);
  g_tz += g_txtz * cqx + g_tytz * cqy;
  const float g_qx = inside(qx, -limx, limx) ? g_txtz * tz : 0.0f;
  const float g_qy = inside(qy, -limy, limy) ? g_tytz * tz : 0.0f;
  const float g_tvx = g_qx / tz;
  const float g_tvy = g_qy / tz;
  g_tz += -g_qx * tvx / tz2 - g_qy * tvy / tz2;
  const float g_tvz = (in_front ? g_tz : 0.0f) + c_dep;

  // means through the view and projection transforms
  for (int a = 0; a < 3; ++a) {
    gm[a] += g_tvx * __ldg(V + 4 * a) + g_tvy * __ldg(V + 4 * a + 1) + g_tvz * __ldg(V + 4 * a + 2);
    gm[a] += g_phx * __ldg(P + 4 * a) + g_phy * __ldg(P + 4 * a + 1) + g_phw * __ldg(P + 4 * a + 3);
    g_means[3 * i + a] = gm[a];
  }

  // Sigma = sum_j s2_j R[:, j] R[:, j]^T
  float gR[3][3];
  for (int j = 0; j < 3; ++j) {
    float GR[3];
    for (int a = 0; a < 3; ++a) GR[a] = G[a][0] * R[0][j] + G[a][1] * R[1][j] + G[a][2] * R[2][j];
    const float g_s2 = R[0][j] * GR[0] + R[1][j] * GR[1] + R[2][j] * GR[2];
    for (int a = 0; a < 3; ++a) gR[a][j] = 2.0f * s2[j] * GR[a];
    const float g_s = 2.0f * s[j] * g_s2;
    g_scales[3 * i + j] = s_in[j] <= 1e9f ? g_s * scale_modifier : 0.0f;
  }
  // rotation matrix of the unit quaternion (r, x, y, z)
  const float g_r = 2.0f * (-z * gR[0][1] + y * gR[0][2] + z * gR[1][0] - x * gR[1][2] -
                            y * gR[2][0] + x * gR[2][1]);
  const float g_x = 2.0f * (y * gR[0][1] + z * gR[0][2] + y * gR[1][0] - 2.0f * x * gR[1][1] -
                            r * gR[1][2] + z * gR[2][0] + r * gR[2][1] - 2.0f * x * gR[2][2]);
  const float g_y = 2.0f * (-2.0f * y * gR[0][0] + x * gR[0][1] + r * gR[0][2] + x * gR[1][0] +
                            z * gR[1][2] - r * gR[2][0] + z * gR[2][1] - 2.0f * y * gR[2][2]);
  const float g_z = 2.0f * (-2.0f * z * gR[0][0] - r * gR[0][1] + x * gR[0][2] + r * gR[1][0] -
                            2.0f * z * gR[1][1] + y * gR[1][2] + x * gR[2][0] + y * gR[2][1]);
  // normalisation q / sqrt(clamp_min(|q|^2, 1e-20))
  const float g_norm = -(g_r * q0 + g_x * q1 + g_y * q2 + g_z * q3) / (norm * norm);
  const float g_qq = qq >= 1e-20f ? g_norm * 0.5f / norm : 0.0f;
  g_rots[4 * i] = g_r / norm + 2.0f * q0 * g_qq;
  g_rots[4 * i + 1] = g_x / norm + 2.0f * q1 * g_qq;
  g_rots[4 * i + 2] = g_y / norm + 2.0f * q2 * g_qq;
  g_rots[4 * i + 3] = g_z / norm + 2.0f * q3 * g_qq;

  g_opac[i] = c_op;
}

}  // namespace
}  // namespace gvd

GVD_API int gvd_preprocess_bwd(const float* means, const float* scales, const float* rots,
                               const float* shs, const float* cam, const float* cot, int n,
                               int k_total, int sh_degree, int active_degree,
                               float scale_modifier, int width, int height, float* g_means,
                               float* g_scales, float* g_rots, float* g_opac, float* g_shs,
                               cudaStream_t stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    gvd::preprocess_bwd_kernel<<<blocks, threads, 0, stream>>>(
        means, scales, rots, shs, cam, cot, n, k_total, sh_degree, active_degree,
        scale_modifier, width, height, g_means, g_scales, g_rots, g_opac, g_shs);
  }
  return (int)cudaGetLastError();
}
