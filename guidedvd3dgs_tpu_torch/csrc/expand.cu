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
// What bounds it on the card: memory writes, 12 bytes per instance. The
// TPU kernel also copied the 16 render fields into every instance, to
// avoid slow gathers there; on the card K4 gathers the fields by owner id
// from K1's table instead, which saves 64 bytes per instance. One thread
// per Gaussian walking its tile rectangle (the CUDA original's form) is
// far from that bound: a Gaussian over hundreds of tiles keeps its warp
// for hundreds of iterations, each lane stores at its own offset (a warp
// store touches up to 32 sectors), and every kept instance is a global
// atomic on one of ~1,200 bins. The design is instance-parallel, as the
// TPU kernel is:
//   - a block takes a contiguous range of instance slots (the grid is the
//     number of blocks resident at once: the launch bounds hold a thread
//     to 40 registers, so 3 blocks of 512 fit an SM) and walks it in
//     windows of K3_THREADS slots, one thread per slot;
//   - a window's first owner is the first Gaussian whose inclusive end
//     offsets[g] + count[g] exceeds the window's first slot (Gaussians of
//     count 0 end where they start, so the search steps over them). A warp
//     finds it by a 32-way search: each step, its lanes probe 32 evenly
//     spaced ends of the remaining range and the first lane past the slot
//     narrows it 32-fold (4 steps at 1M Gaussians). The warps of a block
//     search the boundaries of up to 16 windows at once;
//   - the Gaussians between a window's first and last owner are staged in
//     shared memory at the position of their first slot in the window (the
//     first owner at 0), with the per-Gaussian part of the cull (log of
//     255 op) computed once; each slot's owner is the nearest staged
//     position at or below it, found by a warp ballot. The block scans
//     that range of Gaussians, each thread's 4 loads in flight together.
//     Where it is SCAN_MAX (2,048) or longer (Gaussians out of
//     view come in runs: a wall behind the camera is a run of ~100,000 in
//     a room of 1M, and a wall seen edge-on is mostly out of view), the
//     block samples the range at 512 evenly spaced Gaussians in one round
//     of loads, and each slot finds its owner by binary search among the
//     samples, then between two of them;
//   - each thread writes its slot's key and owner, so the stores coalesce;
//   - the histogram is built in shared memory when num_tiles <= HIST_CAP
//     (8,160 tiles at 1920x1080) and flushed with one global atomicAdd per
//     nonzero bin; larger grids add to the global histogram directly;
//   - two staging buffers, so a window takes one barrier.
// The cull is the same expressions in the same order as the one thread
// per Gaussian kernel before it (IEEE, -fmad=false), so keys, owners and
// histogram are bitwise equal to it and to the plain version.

#include "common.cuh"

namespace gvd {
namespace {

// rows of the K1 table (ops/tiling.py F_*)
constexpr int F_MX = 0, F_MY = 1, F_CA = 2, F_CB = 3, F_CC = 4, F_OP = 5, F_D = 9;
constexpr int K3_THREADS = 512;
constexpr int K3_MIN_BLOCKS = 3;
constexpr int NWARP = K3_THREADS / 32;
constexpr int HIST_CAP = 12288;  // bins of the shared histogram (48 KB)
// a window scans owner ranges of fewer than SCAN_MAX Gaussians (each
// thread's SCAN_ITERS counts and offsets loaded together); a longer range
// is sampled and searched
constexpr int SCAN_ITERS = 4;
constexpr int SCAN_MAX = SCAN_ITERS * K3_THREADS;
constexpr unsigned FULL = 0xffffffffu;

// The Gaussians that own slots of one window, each at the position of its
// first slot there (the window's first owner at 0); `tag` says which
// window wrote the position.
struct Staged {
  int g[K3_THREADS], x0[K3_THREADS], y0[K3_THREADS], w[K3_THREADS], off[K3_THREADS];
  int tag[K3_THREADS];
  unsigned dbits[K3_THREADS];
  float mx[K3_THREADS], my[K3_THREADS], ca[K3_THREADS], cb[K3_THREADS], cc[K3_THREADS];
  float lvl[K3_THREADS];
};

// The first Gaussian g in [lo, n) with offsets[g] + count[g] > s, for a
// slot s < total (the last Gaussian ends at total, so one exists). The
// whole warp calls it and every lane gets the answer.
__device__ __forceinline__ int find_owner(const int* __restrict__ offsets,
                                          const int* __restrict__ count, int n, int lo, int s,
                                          int lane) {
  int hi = n;  // the answer is in [lo, hi)
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int idx = min(lo + (lane + 1) * step - 1, hi - 1);
    const bool past = __ldg(offsets + idx) + __ldg(count + idx) > s;
    // lane 31 probes hi - 1, which is past s
    const unsigned m = __ballot_sync(FULL, past);
    const int f = __ffs(m) - 1;
    const int below = __shfl_sync(FULL, idx, f > 0 ? f - 1 : 0);
    hi = __shfl_sync(FULL, idx, f) + 1;
    lo = f > 0 ? below + 1 : lo;
  }
  return lo;
}

__global__ void __launch_bounds__(K3_THREADS, K3_MIN_BLOCKS)
    expand_kernel(const float* __restrict__ tab, int n, const int* __restrict__ rect_min_x,
                  const int* __restrict__ rect_min_y, const int* __restrict__ rect_w,
                  const int* __restrict__ count, const int* __restrict__ offsets, int gx,
                  int num_tiles, int total, int chunk, bool shared_hist,
                  int64_t* __restrict__ keys, int* __restrict__ owners, int* __restrict__ hist,
                  int gy_cam) {
  extern __shared__ __align__(16) unsigned char smem[];
  Staged* s_win = reinterpret_cast<Staged*>(smem);  // two buffers
  int* s_hist = reinterpret_cast<int*>(smem + 2 * sizeof(Staged));
  __shared__ int s_bnd[NWARP + 1];  // the owners of window boundaries
  __shared__ int s_ends[K3_THREADS];  // sampled ends of a long owner range
  const int lin = threadIdx.x, lane = lin & 31, warp = lin >> 5;
  const int64_t first = (int64_t)blockIdx.x * chunk;
  if (first >= total) return;
  const int s0 = (int)first;
  const int s_end = (int)min((int64_t)total, first + chunk);
  const int nw = (s_end - s0 + K3_THREADS - 1) / K3_THREADS;
  const size_t N = (size_t)n;

  s_win[0].tag[lin] = s_win[1].tag[lin] = -1;
  if (shared_hist)
    for (int i = lin; i < num_tiles; i += K3_THREADS) s_hist[i] = 0;
  if (warp == 0) {
    const int g = find_owner(offsets, count, n, 0, s0, lane);
    if (lane == 0) s_bnd[0] = g;
  }
  for (int w0 = 0; w0 < nw; w0 += NWARP) {
    const int nwg = min(NWARP, nw - w0);
    __syncthreads();  // s_bnd[0] is set; the last group's windows are done
    // boundary i + 1 of the group: the owner of the first slot of window
    // w0 + i + 1, or of the block's last slot
    if (warp < nwg) {
      const int s = (int)min((int64_t)s0 + (int64_t)(w0 + warp + 1) * K3_THREADS, (int64_t)s_end - 1);
      const int g = find_owner(offsets, count, n, s_bnd[0], s, lane);
      if (lane == 0) s_bnd[warp + 1] = g;
    }
    __syncthreads();
    for (int w = w0; w < w0 + nwg; ++w) {
      Staged& sw = s_win[w & 1];
      const int ws = s0 + w * K3_THREADS;
      const int nwin = min(K3_THREADS, s_end - ws);
      const int a = s_bnd[w - w0], b = s_bnd[w - w0 + 1];
      auto stage = [&](int g, int pos, int o) {
        sw.g[pos] = g;
        sw.x0[pos] = __ldg(rect_min_x + g);
        sw.y0[pos] = __ldg(rect_min_y + g);
        sw.w[pos] = __ldg(rect_w + g);
        sw.off[pos] = o;
        sw.dbits[pos] = __float_as_uint(__ldg(tab + F_D * N + g));
        sw.mx[pos] = __ldg(tab + F_MX * N + g);
        sw.my[pos] = __ldg(tab + F_MY * N + g);
        sw.ca[pos] = __ldg(tab + F_CA * N + g);
        sw.cb[pos] = __ldg(tab + F_CB * N + g);
        sw.cc[pos] = __ldg(tab + F_CC * N + g);
        sw.lvl[pos] = logf(clamp_min(__ldg(tab + F_OP * N + g), 1e-12f) * 255.0f);
        sw.tag[pos] = w;
      };
      if (b - a < SCAN_MAX) {
        // stage the window's owners: a (it owns slot ws), then every g in
        // (a, b] whose first slot lies in the window
        int pc[SCAN_ITERS], po[SCAN_ITERS];  // loaded together
#pragma unroll
        for (int i = 0; i < SCAN_ITERS; ++i) {
          const int g = a + lin + i * K3_THREADS;
          pc[i] = g <= b ? __ldg(count + g) : 0;
          po[i] = g <= b ? __ldg(offsets + g) : 0;
        }
#pragma unroll
        for (int i = 0; i < SCAN_ITERS; ++i) {
          const int g = a + lin + i * K3_THREADS;
          if (pc[i] == 0 || (g != a && po[i] >= ws + nwin)) continue;
          stage(g, g == a ? 0 : po[i] - ws, po[i]);
        }
      } else {
        // a long range, mostly Gaussians out of view: sample the ends of
        // K3_THREADS evenly spaced Gaussians of [a, b] (the last one b,
        // which ends past the window), then each slot finds its owner by
        // binary search, first among the samples, then between two of
        // them; the first slot of each owner stages it
        const int step = (b - a + K3_THREADS) / K3_THREADS;
        const int si = min(a + (lin + 1) * step - 1, b);
        s_ends[lin] = __ldg(offsets + si) + __ldg(count + si);
        __syncthreads();
        if (lin < nwin) {
          const int slot = ws + lin;
          int k = 0, kh = K3_THREADS - 1;  // the first sample ending past slot
          while (k < kh) {
            const int mid = (k + kh) / 2;
            if (s_ends[mid] > slot)
              kh = mid;
            else
              k = mid + 1;
          }
          int lo = a + k * step, hi = min(lo + step - 1, b);
          while (lo < hi) {
            const int mid = lo + (hi - lo) / 2;
            if (__ldg(offsets + mid) + __ldg(count + mid) > slot)
              hi = mid;
            else
              lo = mid + 1;
          }
          const int o = __ldg(offsets + lo);
          if (lin == 0 || o == slot) stage(lo, lin, o);
        }
      }
      __syncthreads();
      // this slot's owner: the last staged position at or below it
      const unsigned mw = __ballot_sync(FULL, sw.tag[lin] == w);
      int prev = -1;  // the last staged position of an earlier word
      if ((mw & 1u) == 0) {
        for (int k = warp - 1; k >= 0; --k) {
          const unsigned mk = __ballot_sync(FULL, sw.tag[k * 32 + lane] == w);
          if (mk) {
            prev = k * 32 + 31 - __clz(mk);
            break;
          }
        }
      }
      const unsigned mine = mw & (FULL >> (31 - lane));
      const int p = mine ? warp * 32 + 31 - __clz(mine) : prev;
      if (lin < nwin) {
        const int slot = ws + lin;
        const float mx = sw.mx[p], my = sw.my[p];
        const float ca = sw.ca[p], cb = sw.cb[p], cc = sw.cc[p];
        const float lvl = sw.lvl[p];
        const float caf = clamp_min(ca, 1e-12f), ccf = clamp_min(cc, 1e-12f);
        const int wd = sw.w[p];
        const int q = (slot - sw.off[p]) / wd;
        const int rem = slot - sw.off[p] - q * wd;
        auto qv = [&](float dx, float dy) {
          return 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
        };
        const int ty = sw.y0[p] + q;
        // the row within the camera's band: the table's means are the camera's own
        const float ey0 = (float)(ty - (ty / gy_cam) * gy_cam) * 16.0f - my;
        const float ey1 = ey0 + 15.0f;
        const int tx = sw.x0[p] + rem;
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
        keys[slot] = ((int64_t)(cull ? num_tiles : tile) << 32) | (int64_t)sw.dbits[p];
        owners[slot] = sw.g[p];
        if (!cull) {
          if (shared_hist)
            atomicAdd(s_hist + tile, 1);
          else
            atomicAdd(hist + tile, 1);
        }
      }
    }
    __syncthreads();  // every thread has read s_bnd
    if (lin == 0) s_bnd[0] = s_bnd[nwg];
  }
  if (shared_hist) {
    __syncthreads();
    for (int i = lin; i < num_tiles; i += K3_THREADS) {
      const int v = s_hist[i];
      if (v) atomicAdd(hist + i, v);
    }
  }
}

}  // namespace
}  // namespace gvd

// total: the sum of count (the number of slots); hist must be zeroed.
// gy_cam: the tile rows of one camera. A B-camera chain stacks its cameras'
// grids as bands of gy_cam rows (num_tiles = gx gy_cam B): Gaussian rows
// and tile rows are the chain's, each Gaussian's means its own camera's, so
// the cull reads the tile's row within its band (one camera: gy_cam = gy).
GVD_API int gvd_expand(const float* tab, int n, const int* rect_min_x, const int* rect_min_y,
                       const int* rect_w, const int* count, const int* offsets, int gx,
                       int num_tiles, int total, int64_t* keys, int* owners, int* hist,
                       int gy_cam, cudaStream_t stream) {
  if (n <= 0 || total <= 0) return (int)cudaGetLastError();
  if (gy_cam <= 0) return (int)cudaErrorInvalidValue;
  const bool shared_hist = num_tiles <= gvd::HIST_CAP;
  const int threads = gvd::K3_THREADS;
  const int smem = (int)(2 * sizeof(gvd::Staged)) + (shared_hist ? num_tiles * (int)sizeof(int) : 0);
  // as many blocks as are resident at once, each taking a range of slots
  // (the shared histogram's size follows the image size: a process sees
  // few of them)
  int64_t resident = 1;
  const cudaError_t err = gvd::resident_blocks((const void*)gvd::expand_kernel, threads, smem, &resident);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  const int64_t windows = (total + threads - 1) / threads;
  const int64_t blocks = windows < resident ? windows : resident;
  const int chunk = (int)((windows + blocks - 1) / blocks) * threads;
  gvd::expand_kernel<<<(int)((total + (int64_t)chunk - 1) / chunk), threads, smem, stream>>>(
      tab, n, rect_min_x, rect_min_y, rect_w, count, offsets, gx, num_tiles, total, chunk,
      shared_hist, keys, owners, hist, gy_cam);
  return (int)cudaGetLastError();
}
