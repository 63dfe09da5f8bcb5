// Kernel K2: per-Gaussian preprocess backward (the VJP of K1).
//
// Replaces the Pallas kernel guidedvd3dgs_tpu/ops/preprocess_pallas.py::
// preprocess_fused_bwd (body _bwd_kernel), which is jax.vjp of
// projection.preprocess_field_rows traced inside the kernel. Given the
// cotangents of the 10 render fields (mx2d, my2d, conic a/b/c, opacity,
// r/g/b, depth) it returns the gradients of the post-activation means
// (N,3), scales (N,3), rotations (N,4), opacity (N) and SH (N,K,3), the
// SH read and its gradient written as band 0 (features_dc, (N,1,3)) and
// bands 1..K-1 (features_rest, (N,K-1,3)), each a pointer and a row stride
// on the way in (a concatenated (N,K,3) tensor is the same rows at
// pointers shs and shs + 3, stride 3K), two contiguous tensors out. Like
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
// The cov3D part is the matrix form of the CUDA original's computeCov3D
// backward (backward.cu:603-669).
//
// What bounds it on the H100: memory. A Gaussian reads 236 bytes of
// parameters and 40 of cotangents and writes 236 bytes of gradients (SH
// degree 3); the ~1000 flops of the recompute and the sweep are below the
// card's ~20 f32 flops per byte. One thread per Gaussian in the (N, k)
// row layout the model holds would read and write its rows with scalar
// accesses 12 to 192 bytes apart from its neighbour's, which wastes most
// of each memory transaction, and a basis indexed by a runtime degree
// lives on the stack. The design:
//   - the kernel is a template on sh_degree (0-3), dispatched in the C
//     entry, so every loop over coefficients has a compile-time bound and
//     the basis and its gradient stay in registers (no stack);
//     active_degree, k_total and scale_modifier stay runtime arguments,
//     and coefficients (sh_degree + 1)^2 .. k_total - 1 get zeros;
//   - a slab of K2_THREADS consecutive Gaussians is staged whole: the
//     block copies its rows of rotations, means, scales and SH (band 0
//     and the rest from their two sources into one shared row) into
//     shared memory (slab.cuh: consecutive floats, coalesced), each thread
//     reads its rows there (row strides odd, or 16 bytes read as one
//     vector, so without bank conflicts) and writes its gradient rows over
//     them, and the block stores the slab with 16-byte stores (the SH
//     gradient's band 0 and the rest to their two outputs). The
//     cotangents (10, N) and the opacity gradient (N) are rows already and
//     stay direct, coalesced;
//   - a block's copy and its sweep would otherwise take turns (the sweep
//     is latency-bound): each block walks slabs blockIdx.x, + gridDim.x,
//     ..., with two buffers, and the next slab's rows arrive by cp.async
//     while this slab is swept. The grid is the number of blocks resident
//     at once (3 of 128 an SM, by the two buffers' shared memory; asked of
//     the runtime once per device and shared memory size), so the launch
//     bounds leave a thread up to 168 registers and nothing spills;
//   - each thread's arithmetic is the unstaged kernel's, in the same
//     order (IEEE, -fmad=false), so the gradients are bitwise equal to it.

#include "slab.cuh"

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

// Gaussians a block, and blocks an SM (the registers a thread may take;
// shared memory allows 3): chosen by measurement (PERF.md)
constexpr int K2_THREADS = 128;
constexpr int K2_MIN_BLOCKS = 3;

__device__ __forceinline__ bool inside(float x, float lo, float hi) { return x >= lo && x <= hi; }

// Shared floats of one Gaussian: rotation (4, read as one vector), mean and
// scale (3 each), SH row (odd stride of 3 k_total floats).
__host__ __device__ inline int smem_floats_per_row(int k_total) { return 10 + odd_stride(3 * k_total); }

// One Gaussian's recompute and reverse sweep. Its rows in shared memory
// (mean, scale, rotation, SH) are read first and overwritten with their
// gradients.
template <int D>
__device__ __forceinline__ void grad_one(float* mean, float* scale, float4* rot, float* sh,
                                         const float* __restrict__ cam,
                                         const float* __restrict__ cot, int ld, int i, int k_total,
                                         int active_degree, float scale_modifier, int width,
                                         int height) {
  constexpr int n_coef = (D + 1) * (D + 1);
  const float* V = cam + CAM_V;
  const float* P = cam + CAM_P;
  const size_t N = (size_t)ld;
  const float c_mx = cot[i], c_my = cot[N + i], c_ca = cot[2 * N + i], c_cb = cot[3 * N + i],
              c_cc = cot[4 * N + i], c_op = cot[5 * N + i], c_r = cot[6 * N + i],
              c_g = cot[7 * N + i], c_b = cot[8 * N + i], c_dep = cot[9 * N + i];

  // ---------------- forward recompute (K1's formulas) ----------------
  const float mx = mean[0], my = mean[1], mz = mean[2];
  auto xform = [&](const float* M, int c) {
    return mx * __ldg(M + c) + my * __ldg(M + 4 + c) + mz * __ldg(M + 8 + c) + __ldg(M + 12 + c);
  };
  const float tvx = xform(V, 0), tvy = xform(V, 1), tvz = xform(V, 2);
  const float ph_x = xform(P, 0), ph_y = xform(P, 1), ph_w = xform(P, 3);
  const bool in_front = tvz > NEAR_CLIP;
  const float tz = in_front ? tvz : 1.0f;
  const float p_w = 1.0f / (in_front ? ph_w + 1e-7f : 1.0f);

  const float4 qv = *rot;
  const float q0 = qv.x, q1 = qv.y, q2 = qv.z, q3 = qv.w;
  const float qq = q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3;
  const float norm = sqrtf(clamp_min(qq, 1e-20f));
  const float r = q0 / norm, x = q1 / norm, y = q2 / norm, z = q3 / norm;
  const float R[3][3] = {
      {1.0f - 2.0f * (y * y + z * z), 2.0f * (x * y - r * z), 2.0f * (x * z + r * y)},
      {2.0f * (x * y + r * z), 1.0f - 2.0f * (x * x + z * z), 2.0f * (y * z - r * x)},
      {2.0f * (x * z - r * y), 2.0f * (y * z + r * x), 1.0f - 2.0f * (x * x + y * y)}};
  float s_in[3], s[3], s2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s_in[k] = scale_modifier * scale[k];
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
  float basis[n_coef];
  basis[0] = (float)SH_C0;
  if constexpr (D > 0) {
    basis[1] = K1c * dy;
    basis[2] = K2c * dz;
    basis[3] = K3c * dx;
    if constexpr (D > 1) {
      basis[4] = K4c * xy;
      basis[5] = K5c * yz;
      basis[6] = K6c * (2.0f * zz - xx - yy);
      basis[7] = K7c * xz;
      basis[8] = K8c * (xx - yy);
      if constexpr (D > 2) {
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
  const float c_rgb[3] = {c_r, c_g, c_b};
  float g_rgb[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float acc = basis[0] * sh[ch];
#pragma unroll
    for (int k = 1; k < n_coef; ++k) acc = acc + basis[k] * sh[3 * k + ch];
    g_rgb[ch] = (acc + 0.5f >= 0.0f) ? c_rgb[ch] : 0.0f;  // clamp(min=0) passes at >= 0
  }

  // ---------------- reverse sweep ----------------
  // SH: the basis gradient gb_k of coefficient k (its values dotted with
  // g_rgb) is formed where the direction's gradient takes it, then the
  // coefficient's gradient is written over its values. The row is read
  // here through a volatile pointer, so no value is held in registers from
  // the forward to this point (fewer live registers).
  volatile float* shv = sh;
  auto gb = [&](int k) {
    return shv[3 * k] * g_rgb[0] + shv[3 * k + 1] * g_rgb[1] + shv[3 * k + 2] * g_rgb[2];
  };
  auto put = [&](int k) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) shv[3 * k + ch] = basis[k] * g_rgb[ch];
  };
  put(0);
  float gdx = 0.0f, gdy = 0.0f, gdz = 0.0f;  // gradient of the unit direction
  if constexpr (D > 0) {
    const float gb1 = gb(1), gb2 = gb(2), gb3 = gb(3);
    put(1), put(2), put(3);
    gdy += K1c * gb1;
    gdz += K2c * gb2;
    gdx += K3c * gb3;
    if constexpr (D > 1) {
      const float gb4 = gb(4), gb5 = gb(5), gb6 = gb(6), gb7 = gb(7), gb8 = gb(8);
      put(4), put(5), put(6), put(7), put(8);
      gdx += K4c * dy * gb4;
      gdy += K4c * dx * gb4;
      gdy += K5c * dz * gb5;
      gdz += K5c * dy * gb5;
      gdx += K6c * (-2.0f * dx) * gb6;
      gdy += K6c * (-2.0f * dy) * gb6;
      gdz += K6c * (4.0f * dz) * gb6;
      gdx += K7c * dz * gb7;
      gdz += K7c * dx * gb7;
      gdx += K8c * (2.0f * dx) * gb8;
      gdy += K8c * (-2.0f * dy) * gb8;
      if constexpr (D > 2) {
        const float gb9 = gb(9), gb10 = gb(10), gb11 = gb(11), gb12 = gb(12), gb13 = gb(13),
                    gb14 = gb(14), gb15 = gb(15);
        put(9), put(10), put(11), put(12), put(13), put(14), put(15);
        gdx += K9c * (6.0f * xy) * gb9;
        gdy += K9c * (3.0f * xx - 3.0f * yy) * gb9;
        gdx += K10c * yz * gb10;
        gdy += K10c * xz * gb10;
        gdz += K10c * xy * gb10;
        gdx += K11c * (-2.0f * xy) * gb11;
        gdy += K11c * (4.0f * zz - xx - 3.0f * yy) * gb11;
        gdz += K11c * (8.0f * yz) * gb11;
        gdx += K12c * (-6.0f * xz) * gb12;
        gdy += K12c * (-6.0f * yz) * gb12;
        gdz += K12c * (6.0f * zz - 3.0f * xx - 3.0f * yy) * gb12;
        gdx += K13c * (4.0f * zz - 3.0f * xx - yy) * gb13;
        gdy += K13c * (-2.0f * xy) * gb13;
        gdz += K13c * (8.0f * xz) * gb13;
        gdx += K14c * (2.0f * xz) * gb14;
        gdy += K14c * (-2.0f * yz) * gb14;
        gdz += K14c * (xx - yy) * gb14;
        gdx += K15c * (3.0f * xx - 3.0f * yy) * gb15;
        gdy += K15c * (-6.0f * xy) * gb15;
      }
    }
  }
  for (int k = n_coef; k < k_total; ++k) {
    for (int ch = 0; ch < 3; ++ch) shv[3 * k + ch] = 0.0f;
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
    mean[a] = gm[a];
  }

  // Sigma = sum_j s2_j R[:, j] R[:, j]^T
  float gR[3][3];
  for (int j = 0; j < 3; ++j) {
    float GR[3];
    for (int a = 0; a < 3; ++a) GR[a] = G[a][0] * R[0][j] + G[a][1] * R[1][j] + G[a][2] * R[2][j];
    const float g_s2 = R[0][j] * GR[0] + R[1][j] * GR[1] + R[2][j] * GR[2];
    for (int a = 0; a < 3; ++a) gR[a][j] = 2.0f * s2[j] * GR[a];
    const float g_s = 2.0f * s[j] * g_s2;
    scale[j] = s_in[j] <= 1e9f ? g_s * scale_modifier : 0.0f;
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
  *rot = make_float4(g_r / norm + 2.0f * q0 * g_qq, g_x / norm + 2.0f * q1 * g_qq,
                     g_y / norm + 2.0f * q2 * g_qq, g_z / norm + 2.0f * q3 * g_qq);
}

// The block's slabs of K2_THREADS Gaussians, slab, slab + gridDim.x, ...:
// the next slab's rows are copied into one buffer while the Gaussians of
// this one are swept in the other, then stored.
template <int D>
__global__ void __launch_bounds__(K2_THREADS, K2_MIN_BLOCKS)
    preprocess_bwd_kernel(const float* __restrict__ means, const float* __restrict__ scales,
                          const float* __restrict__ rots, const float* __restrict__ sh_dc,
                          int dc_stride, const float* __restrict__ sh_rest, int rest_stride,
                          const float* __restrict__ cam, const float* __restrict__ cot, int n,
                          int k_total, int active_degree, float scale_modifier, int width,
                          int height, float* __restrict__ g_means, float* __restrict__ g_scales,
                          float* __restrict__ g_rots, float* __restrict__ g_opac,
                          float* __restrict__ g_dc, float* __restrict__ g_rest, int cot_ld,
                          bool acc) {
  extern __shared__ float4 smem4[];
  const int kw = 3 * k_total, ssh = odd_stride(kw), rw = kw - 3;
  const int nslab = (n + K2_THREADS - 1) / K2_THREADS;
  // a buffer: the rows of rotations, means, scales, SH (stride ssh)
  const int buf_floats = K2_THREADS * smem_floats_per_row(k_total);
  float* const bufs = reinterpret_cast<float*>(smem4);
  auto fetch = [&](int slab, float* b) {
    const int i0 = slab * K2_THREADS, rows = min(K2_THREADS, n - i0);
    fetch_rows(rots + 4 * (size_t)i0, 4, b, rows, 4, 4);
    fetch_rows(means + 3 * (size_t)i0, 3, b + 4 * K2_THREADS, rows, 3, 3);
    fetch_rows(scales + 3 * (size_t)i0, 3, b + 7 * K2_THREADS, rows, 3, 3);
    fetch_rows(sh_dc + (size_t)i0 * dc_stride, dc_stride, b + 10 * K2_THREADS, rows, 3, ssh);
    if (rw > 0)
      fetch_rows(sh_rest + (size_t)i0 * rest_stride, rest_stride, b + 10 * K2_THREADS + 3, rows, rw,
                 ssh);
  };
  int it = 0;
  if (blockIdx.x < nslab) fetch(blockIdx.x, bufs);
  cp_async_commit();
  for (int slab = blockIdx.x; slab < nslab; slab += gridDim.x, ++it) {
    float* b = bufs + (it & 1) * buf_floats;
    if (slab + gridDim.x < nslab) fetch(slab + gridDim.x, bufs + ((it + 1) & 1) * buf_floats);
    cp_async_commit();
    cp_async_wait<1>();  // this slab's copies (all but the newest group)
    __syncthreads();
    float* s_rot = b;
    float* s_mean = b + 4 * K2_THREADS;
    float* s_scale = b + 7 * K2_THREADS;
    float* s_sh = b + 10 * K2_THREADS;
    const int i0 = slab * K2_THREADS, rows = min(K2_THREADS, n - i0);
    const int t = threadIdx.x;
    if (t < rows) {
      const int i = i0 + t;
      grad_one<D>(s_mean + 3 * t, s_scale + 3 * t, reinterpret_cast<float4*>(s_rot) + t,
                  s_sh + t * ssh, cam, cot, cot_ld, i, k_total, active_degree, scale_modifier,
                  width, height);
      const float g_op = cot[5 * (size_t)cot_ld + i];
      g_opac[i] = acc ? g_opac[i] + g_op : g_op;
    }
    __syncthreads();
    store_slab(s_rot, g_rots + 4 * (size_t)i0, 4 * rows, 4, 4, acc);
    store_slab(s_mean, g_means + 3 * (size_t)i0, 3 * rows, 3, 3, acc);
    store_slab(s_scale, g_scales + 3 * (size_t)i0, 3 * rows, 3, 3, acc);
    store_slab(s_sh, g_dc + 3 * (size_t)i0, rows * 3, 3, ssh, acc);
    if (rw > 0) store_slab(s_sh + 3, g_rest + (size_t)i0 * rw, rows * rw, rw, ssh, acc);
    __syncthreads();  // before this buffer takes the slab after next
  }
}

}  // namespace
}  // namespace gvd

// SH rows: band 0 at sh_dc, bands 1..k_total-1 at sh_rest, dc_stride and
// rest_stride floats from one Gaussian's row to the next; the SH gradient
// goes to g_dc (n, 1, 3) and g_rest (n, k_total - 1, 3), contiguous.
// cot_ld >= n: the floats from one row of the cotangents at cot to the
// next (a camera's columns of a B-camera chain's (10, B n) sums). With
// accumulate, every gradient is added to what its output holds (old + new,
// the sum over a chain's cameras in camera order), else written.
GVD_API int gvd_preprocess_bwd(const float* means, const float* scales, const float* rots,
                               const float* sh_dc, int dc_stride, const float* sh_rest,
                               int rest_stride, const float* cam, const float* cot, int n,
                               int k_total, int sh_degree, int active_degree,
                               float scale_modifier, int width, int height, float* g_means,
                               float* g_scales, float* g_rots, float* g_opac, float* g_dc,
                               float* g_rest, int cot_ld, int accumulate, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (cot_ld < n) return (int)cudaErrorInvalidValue;
  decltype(&gvd::preprocess_bwd_kernel<0>) kernel;
  switch (sh_degree) {
    case 0: kernel = gvd::preprocess_bwd_kernel<0>; break;
    case 1: kernel = gvd::preprocess_bwd_kernel<1>; break;
    case 2: kernel = gvd::preprocess_bwd_kernel<2>; break;
    case 3: kernel = gvd::preprocess_bwd_kernel<3>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  const int threads = gvd::K2_THREADS;
  const int smem = 2 * threads * gvd::smem_floats_per_row(k_total) * (int)sizeof(float);
  // as many blocks as are resident at once, each walking its slabs (a
  // k_total past the card's 227 KB of shared memory fails here)
  int64_t resident = 1;
  const cudaError_t err = gvd::resident_blocks((const void*)kernel, threads, smem, &resident);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  const int nslab = (n + threads - 1) / threads;
  kernel<<<nslab < resident ? nslab : (int)resident, threads, smem, stream>>>(
      means, scales, rots, sh_dc, dc_stride, sh_rest, rest_stride, cam, cot, n, k_total,
      active_degree, scale_modifier, width, height, g_means, g_scales, g_rots, g_opac, g_dc,
      g_rest, cot_ld, accumulate != 0);
  return (int)cudaGetLastError();
}
