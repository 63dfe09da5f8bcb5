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
// expf and ~15 flops, sequential in T for each pixel), and at trained
// density the latency of the longest lists (a tile's block walks its list
// alone); the fields are gathered from K1's table by owner id (10
// scattered 4-byte reads per instance, once per tile). The TPU kernel
// rewrote the sequential recurrence as chunk-local cumulative products on
// its matrix unit; on the card the CUDA original's per-pixel loop is the
// natural form. The design:
//   - one block of 256 threads per tile, one pixel a thread. A thread
//     takes U = 4 instances a step: the geometry (offset, quadratic form,
//     exp) of all four first, then their sequential part, so four exps are
//     in flight and the next instances' geometry does not wait on this
//     one's T. Two pixels a thread (128 threads; kept for comparison as
//     scripts/ab_variants/blend_fwd_two_pixels.cu) lengthen each tile's
//     walk and were slower. Five blocks share an SM (48 registers);
//   - instances come in rounds of ROUND. Their fields sit in shared
//     memory as three 16-byte rows per instance (mx, my, a, b) (c, op, r,
//     g) (b, d, -, -), read by broadcast 16-byte loads;
//   - two buffers: while a round is walked, the next round's fields are
//     copied from the table's rows into the other buffer by cp.async
//     (4-byte copies, zero-filled past the list; thread k copies instance
//     k of the round), and the owner ids of the round after it are loaded
//     into registers. The walk waits on a gather only at the first round;
//   - the tiles start in the order `tile_order` gives (the longest lists
//     first, from the binning), so a long list does not start late;
//   - the block leaves once all its pixels are done (__syncthreads_count
//     before each round); a pixel outside the ragged image edge is done
//     from the start.
// Each pixel runs the same f32 operations in the same order as the
// row-order kernel that took one instance at a time before it (IEEE,
// -fmad=false), so its outputs are bitwise equal to that kernel's whatever
// U or the tile order.

#include "common.cuh"
#include "hopper.cuh"

namespace gvd {
namespace {

constexpr int U = 4;        // instances whose geometry is taken together
constexpr int ROUND = 128;  // instances per round, one copying thread each
// blocks an SM: at most 48 registers a thread (registers go to a warp in
// 256s, so 49-56 would hold an SM to 4 blocks)
constexpr int K4_MIN_BLOCKS = 5;
static_assert(ROUND <= TILE_PIX && ROUND % U == 0, "a round is copied by one thread an instance");
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

__global__ void __launch_bounds__(TILE_PIX, K4_MIN_BLOCKS)
    blend_fwd_kernel(const float* __restrict__ tab, int n, const int* __restrict__ inst_gauss,
                     const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                     const int* __restrict__ tile_order, const float* __restrict__ bg, int gx,
                     int width, int height, float* __restrict__ out_color,
                     float* __restrict__ out_depth, float* __restrict__ out_alpha, int gy_cam) {
  __shared__ float4 s_f[2][ROUND][3];
  const int t = tile_order[blockIdx.x];
  const int lin = threadIdx.x;
  const int start = tile_start[t];
  const int cnt = tile_count[t];
  const size_t N = (size_t)n;

  // the tile's camera (band) and its pixel in that camera's image
  const int cam = t / (gx * gy_cam), tl = t - cam * (gx * gy_cam);
  const int px = (tl % gx) * TILE + lin % TILE;
  const int py = (tl / gx) * TILE + lin / TILE;
  const bool inside = px < width && py < height;
  const float pxf = (float)px, pyf = (float)py;
  float T = 1.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f, acc_a = 0.0f;
  bool done = !inside;

  // the owner id of the instance this thread copies in the round fetched next
  int id = 0;
  auto load_id = [&](int base) {
    if (lin < ROUND) id = base + lin < cnt ? inst_gauss[start + base + lin] : 0;
  };
  auto fetch = [&](int base, int buf) {
    if (lin < ROUND) copy_fields(s_f[buf][lin], tab, N, id, base + lin < cnt);
  };
  if (cnt > 0) {
    load_id(0);
    fetch(0, 0);
  }
  cp_async_commit();
  load_id(ROUND);

  for (int base = 0, buf = 0; base < cnt; base += ROUND, buf ^= 1) {
    // also the barrier before the next round's copies overwrite the last round
    if (__syncthreads_count(done) == TILE_PIX) break;
    if (base + ROUND < cnt) fetch(base + ROUND, buf ^ 1);
    cp_async_commit();
    if (base + 2 * ROUND < cnt) load_id(base + 2 * ROUND);
    cp_async_wait<1>();  // this thread's copies of this round
    __syncthreads();     // and everyone's
    const int nb = min(ROUND, cnt - base);
    for (int k = 0; k < nb && !done; k += U) {
      // the geometry of U instances first: their exps overlap; a slot past
      // nb holds zeros and its values go unused
      float4 f0[U], f1[U];
      float power[U], araw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        f0[u] = s_f[buf][k + u][0];
        f1[u] = s_f[buf][k + u][1];
        const float dx = f0[u].x - pxf;
        const float dy = f0[u].y - pyf;
        power[u] = -0.5f * (f0[u].z * dx * dx + f1[u].x * dy * dy) - f0[u].w * dx * dy;
        araw[u] = f1[u].y * expf(power[u]);  // used only where power <= 0
      }
      // then the sequential part, instance by instance
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k + u >= nb) break;
        if (done || !(power[u] <= 0.0f) || !(araw[u] >= ALPHA_EPS)) continue;
        const float alpha = fminf(ALPHA_MAX, araw[u]);
        const float test_t = T * (1.0f - alpha);
        if (test_t < T_EPS) {
          done = true;
          continue;
        }
        const float4 f2 = s_f[buf][k + u][2];
        const float w = alpha * T;
        acc_r = acc_r + w * f1[u].z;
        acc_g = acc_g + w * f1[u].w;
        acc_b = acc_b + w * f2.x;
        acc_d = acc_d + w * f2.y;
        acc_a = acc_a + w;
        T = test_t;
      }
    }
  }
  cp_async_wait<0>();  // no copy may land after the block has left

  if (inside) {
    const size_t hw = (size_t)height * width;
    const size_t q = (size_t)cam * 3 * hw + (size_t)py * width + px;
    const size_t qa = (size_t)cam * hw + (size_t)py * width + px;
    out_color[q] = acc_r + T * bg[0];
    out_color[hw + q] = acc_g + T * bg[1];
    out_color[2 * hw + q] = acc_b + T * bg[2];
    out_depth[qa] = acc_d;
    out_alpha[qa] = acc_a;
  }
}

}  // namespace
}  // namespace gvd

// tile_order: the tiles in the order their blocks start (a permutation)
// gy_cam: the tile rows of one camera; gy = B gy_cam stacks B cameras' grids
// as bands, and the outputs are (B, 3, height, width), (B, height, width)
// and (B, height, width) (one camera: gy_cam = gy)
GVD_API int gvd_blend_fwd(const float* tab, int n, const int* inst_gauss, const int* tile_start,
                          const int* tile_count, const int* tile_order, const float* bg, int gx,
                          int gy, int width, int height, float* out_color, float* out_depth,
                          float* out_alpha, int gy_cam, cudaStream_t stream) {
  const int num_tiles = gx * gy;
  if (gy_cam <= 0 || gy % gy_cam) return (int)cudaErrorInvalidValue;
  if (num_tiles > 0) {
    gvd::blend_fwd_kernel<<<num_tiles, gvd::TILE_PIX, 0, stream>>>(
        tab, n, inst_gauss, tile_start, tile_count, tile_order, bg, gx, width, height, out_color,
        out_depth, out_alpha, gy_cam);
  }
  return (int)cudaGetLastError();
}
