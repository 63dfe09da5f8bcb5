// A variant of kernel K4 (csrc/blend_fwd.cu) for scripts/gaussian_kernel_ab.py:
// two pixels a thread (PP = 2, 128 threads a tile), each thread holding
// pixels lin and lin + 128, so each broadcast field read feeds two
// independent recurrences. Measured slower than one pixel a thread
// (PERF.md): it lengthens the walk of the longest tile, which sets
// K4's end at trained density. Not built into the package. The code is
// general over PP and takes the package's C entry name, so the script
// builds it in place of csrc/blend_fwd.cu.

#include "common.cuh"
#include "hopper.cuh"

namespace gvd {
namespace {

constexpr int PP = 2;                       // pixels per thread
constexpr int NT = TILE_PIX / PP;           // threads per tile
constexpr int U = 4;                        // instances whose geometry is taken together
constexpr int ROUND = 128;                  // instances per round (a multiple of U)
constexpr int CPT = (ROUND + NT - 1) / NT;  // instances each thread copies a round
// rows of the K1 table (ops/tiling.py F_*) in the order of the shared row
// (mx, my, a, b) (c, op, r, g) (b, d): the table's rows 0-9 as they are
constexpr int NF = 10;

// Copy instance `g`'s 10 fields from the (16, N) table into its shared row
// (zeros where !ok: past the list).
__device__ __forceinline__ void copy_fields(float4 (&dst)[3], const float* __restrict__ tab,
                                            size_t N, int g, bool ok) {
  float* d = reinterpret_cast<float*>(dst);
  const float* src = tab + (ok ? (size_t)g : 0);
#pragma unroll
  for (int f = 0; f < NF; ++f) cp_async4(d + f, src + f * N, ok);
}

__global__ void __launch_bounds__(NT)
    blend_fwd_kernel(const float* __restrict__ tab, int n, const int* __restrict__ inst_gauss,
                     const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                     const int* __restrict__ tile_order, const float* __restrict__ bg, int gx,
                     int width, int height, float* __restrict__ out_color,
                     float* __restrict__ out_depth, float* __restrict__ out_alpha) {
  __shared__ float4 s_f[2][ROUND][3];
  const int t = tile_order[blockIdx.x];
  const int lin = threadIdx.x;
  const int start = tile_start[t];
  const int cnt = tile_count[t];
  const size_t N = (size_t)n;

  int px[PP], py[PP];
  float pxf[PP], pyf[PP], T[PP], acc_r[PP], acc_g[PP], acc_b[PP], acc_d[PP], acc_a[PP];
  bool inside[PP], done[PP];
#pragma unroll
  for (int p = 0; p < PP; ++p) {
    const int l = lin + p * NT;
    px[p] = (t % gx) * TILE + l % TILE;
    py[p] = (t / gx) * TILE + l / TILE;
    inside[p] = px[p] < width && py[p] < height;
    pxf[p] = (float)px[p];
    pyf[p] = (float)py[p];
    T[p] = 1.0f;
    acc_r[p] = acc_g[p] = acc_b[p] = acc_d[p] = acc_a[p] = 0.0f;
    done[p] = !inside[p];
  }

  // the owner ids of the round fetched next
  int ids[CPT];
  auto load_ids = [&](int base) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = base + lin + c * NT;
      ids[c] = j < cnt ? inst_gauss[start + j] : 0;
    }
  };
  auto fetch = [&](int base, int buf) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int k = lin + c * NT;
      if (k < ROUND) copy_fields(s_f[buf][k], tab, N, ids[c], base + k < cnt);
    }
  };
  if (cnt > 0) {
    load_ids(0);
    fetch(0, 0);
  }
  cp_async_commit();
  load_ids(ROUND);

  for (int base = 0, buf = 0; base < cnt; base += ROUND, buf ^= 1) {
    bool all_done = true;
#pragma unroll
    for (int p = 0; p < PP; ++p) all_done = all_done && done[p];
    // also the barrier before the next round's copies overwrite the last round
    if (__syncthreads_count(all_done) == NT) break;
    if (base + ROUND < cnt) fetch(base + ROUND, buf ^ 1);
    cp_async_commit();
    if (base + 2 * ROUND < cnt) load_ids(base + 2 * ROUND);
    cp_async_wait<1>();  // this thread's copies of this round
    __syncthreads();     // and everyone's
    const int nb = min(ROUND, cnt - base);
    for (int k = 0; k < nb && !all_done; k += U) {
      // the geometry of U instances (and PP pixels) first: their exps
      // overlap; a slot past nb holds zeros and its values go unused
      float4 f0[U], f1[U];
      float power[U][PP], araw[U][PP];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        f0[u] = s_f[buf][k + u][0];
        f1[u] = s_f[buf][k + u][1];
#pragma unroll
        for (int p = 0; p < PP; ++p) {
          const float dx = f0[u].x - pxf[p];
          const float dy = f0[u].y - pyf[p];
          power[u][p] = -0.5f * (f0[u].z * dx * dx + f1[u].x * dy * dy) - f0[u].w * dx * dy;
          araw[u][p] = f1[u].y * expf(power[u][p]);  // used only where power <= 0
        }
      }
      // then each pixel's sequential part, instance by instance
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k + u >= nb) break;
#pragma unroll
        for (int p = 0; p < PP; ++p) {
          if (done[p] || !(power[u][p] <= 0.0f) || !(araw[u][p] >= ALPHA_EPS)) continue;
          const float alpha = fminf(ALPHA_MAX, araw[u][p]);
          const float test_t = T[p] * (1.0f - alpha);
          if (test_t < T_EPS) {
            done[p] = true;
            continue;
          }
          const float4 f2 = s_f[buf][k + u][2];
          const float w = alpha * T[p];
          acc_r[p] = acc_r[p] + w * f1[u].z;
          acc_g[p] = acc_g[p] + w * f1[u].w;
          acc_b[p] = acc_b[p] + w * f2.x;
          acc_d[p] = acc_d[p] + w * f2.y;
          acc_a[p] = acc_a[p] + w;
          T[p] = test_t;
        }
      }
      all_done = true;
#pragma unroll
      for (int p = 0; p < PP; ++p) all_done = all_done && done[p];
    }
  }
  cp_async_wait<0>();  // no copy may land after the block has left

  const size_t hw = (size_t)height * width;
#pragma unroll
  for (int p = 0; p < PP; ++p) {
    if (!inside[p]) continue;
    const size_t q = (size_t)py[p] * width + px[p];
    out_color[q] = acc_r[p] + T[p] * bg[0];
    out_color[hw + q] = acc_g[p] + T[p] * bg[1];
    out_color[2 * hw + q] = acc_b[p] + T[p] * bg[2];
    out_depth[q] = acc_d[p];
    out_alpha[q] = acc_a[p];
  }
}

}  // namespace
}  // namespace gvd

// tile_order: the tiles in the order their blocks start (a permutation)
GVD_API int gvd_blend_fwd(const float* tab, int n, const int* inst_gauss, const int* tile_start,
                          const int* tile_count, const int* tile_order, const float* bg, int gx,
                          int gy, int width, int height, float* out_color, float* out_depth,
                          float* out_alpha, cudaStream_t stream) {
  const int num_tiles = gx * gy;
  if (num_tiles > 0) {
    gvd::blend_fwd_kernel<<<num_tiles, gvd::NT, 0, stream>>>(
        tab, n, inst_gauss, tile_start, tile_count, tile_order, bg, gx, width, height, out_color,
        out_depth, out_alpha);
  }
  return (int)cudaGetLastError();
}
