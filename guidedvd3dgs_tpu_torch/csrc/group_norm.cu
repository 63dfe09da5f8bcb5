// Kernel N1: GroupNorm, with the SiLU after it where asked, over
// channels-last bf16 activations, forward and backward.
//
// Replaces no Pallas kernel: the JAX package leaves GroupNorm to XLA
// (guidedvd3dgs_tpu/diffusion/nnops.py::group_norm, whose half-precision
// form folds the statistics into x * scale + shift in f32). In eager
// PyTorch that fold is a chain of elementwise and reduction kernels over
// an f32 copy of the activation, and autograd's backward of it another;
// together with the SiLU after most calls it was the largest block of
// device time in the guided DDIM step (PERF.md). The UNet calls it 166
// times an application (1.45 G elements for 25 frames), the VAE decoder
// 30 times a chunk of frames (6.3 G elements for 25).
//
// What bounds it on the H100: memory. The function needs x read and y
// written, 4 bytes an element in bf16, and backward x and dy read and dx
// written, 6 bytes. This design moves more: the forward reads x twice (the
// statistics, then the output), 6 bytes an element, and the backward x
// and dy twice (the group sums, then dx), 10 bytes. The arithmetic
// (Welford's update, one expf for SiLU) is a few operations an element.
//
// Layout: x is (N, P, C) with P the pixels of a sample (T*H*W) and G
// groups of C/G consecutive channels; a sample's pixels [r0, r1) are one
// contiguous span of memory. The design:
//   - every launch is a grid (S, N): block (s, n) owns rows [s*chunk,
//     min((s+1)*chunk, P)) of sample n; the host picks chunk and S from P,
//     N and the number of SMs, so the same code serves 10 channels x
//     2,240 pixels and 4 channels x 143,360 pixels;
//   - a thread always loads the same 8 channels (16 bytes) of a row, at
//     row slot j of R = threads / (C/8) slots: the block's threads read
//     R whole rows a step, coalesced, and a thread keeps its 8 channels'
//     constants and sums in registers;
//   - stats: each thread runs Welford's update over its rows, the slots
//     merge by Chan's formula in slot order through shared memory, then
//     the channels of each group in channel order; the block stores its
//     groups' (mean, M2) to a workspace (N, S, G);
//   - apply: a warp per group merges the sample's S partials (lane l
//     takes partials l, l + 32, ... in order, then a shuffle tree in a
//     fixed order), forms scale = rstd * w and shift = b - mean * scale
//     in f32 as the fold does, and writes fma(x, scale, shift), through
//     SiLU where asked, rounded once to x's type; block 0 of each sample
//     stores mean and rstd for the backward;
//   - backward sums: each thread recomputes pre = fma(x, scale, shift),
//     g = dy * silu'(pre) (or dy), and adds g and g * (x - mean) per
//     channel (the latter times rstd at the end: g * x_hat); slots and
//     channels are summed in order as above (times w), partials (S1, S2)
//     per group to the workspace;
//   - backward apply: a warp per group sums the S partials as above, and
//     dx = rstd * (w * g - S1 / n - x_hat * S2 / n), written as
//     scale * g - rstd * S1 / n - (x - mean) * rstd^2 * S2 / n, in x's type.
// No atomics: every sum is taken in the same order in every run, so two
// runs give the same bits.

#include <cuda_bf16.h>

#include "common.cuh"

namespace gvd {
namespace {

constexpr int GN_VEC = 8;  // channels a thread loads at once: 16 bytes of bf16
// threads a block at most: 128 registers a thread, 32 KB of shared memory
constexpr int GN_MAX_THREADS = 512;

using T = __nv_bfloat16;  // the activations' type

// 8 bf16 values, 16 bytes, to and from f32
struct Bf16x8 {
  static __device__ __forceinline__ uint4 raw(const T* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }
  static __device__ __forceinline__ void unpack(const uint4& u, float (&v)[GN_VEC]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < GN_VEC / 2; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x, v[2 * k + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void load(const T* p, float (&v)[GN_VEC]) { unpack(raw(p), v); }
  static __device__ __forceinline__ void store(T* p, const float (&v)[GN_VEC]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < GN_VEC / 2; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// weight / bias element c (bf16, as the activations)
__device__ __forceinline__ float param_at(const T* p, int c) { return __bfloat162float(p[c]); }

// (n, mean, m2) += (nb, meanb, m2b), Chan's formula; an empty side is
// skipped. The weight nb / (n + nb) by the fast division (2 ulps): the
// merges of a sample's partials are the serial part of the apply kernels.
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb, float meanb,
                                           float m2b) {
  if (nb == 0.0f) return;
  if (n == 0.0f) {
    n = nb, mean = meanb, m2 = m2b;
    return;
  }
  const float nn = n + nb;
  const float d = meanb - mean;
  const float fb = __fdividef(nb, nn);
  mean = mean + d * fb;
  m2 = m2 + m2b + d * d * n * fb;
  n = nn;
}

// rows of a chunk that row slot j of R visits
__device__ __forceinline__ int slot_rows(int nr, int j, int R) { return j < nr ? (nr - 1 - j) / R + 1 : 0; }

// SiLU by the fast exponential and division (a few f32 ulps, far below the
// bf16 rounding of the result; past |v| = 87 the division gives 0
// where SiLU is below 1e-36)
__device__ __forceinline__ float sigmoid_f(float v) { return __fdividef(1.0f, 1.0f + __expf(-v)); }
__device__ __forceinline__ float silu_f(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

// dy * d silu(pre) / d pre
__device__ __forceinline__ float silu_grad(float dy, float pre) {
  const float sg = sigmoid_f(pre);
  return dy * (sg * (1.0f + pre * (1.0f - sg)));
}

// The geometry every kernel of the pair shares (module comment).
struct Geo {
  int P, C, G, chunk;
  __device__ __forceinline__ int cg() const { return C / G; }
  __device__ __forceinline__ int vpr() const { return C / GN_VEC; }
  __device__ __forceinline__ int rows(int s) const { return min(chunk, P - s * chunk); }
};

// The threads' per-channel pairs (s_a, s_b: [R][C] in shared memory) ->
// per channel in slot order -> per group in channel order; `emit(g, a, b)`
// gets each group's pair. With MOMENTS the pairs are (mean, M2) of
// slot_rows rows each and merge by Chan's formula; else they are sums,
// added, and each channel's is multiplied by its weight.
template <bool MOMENTS, typename Emit>
__device__ __forceinline__ void reduce_block(float* s_a, float* s_b, const Geo& geo, int R, int nr,
                                             const T* w, Emit emit) {
  const int t = threadIdx.x, C = geo.C;
  for (int c = t; c < C; c += blockDim.x) {
    float n = 0.0f, a = 0.0f, b = 0.0f;
    for (int j = 0; j < R; ++j) {
      if (MOMENTS) {
        chan_merge(n, a, b, (float)slot_rows(nr, j, R), s_a[j * C + c], s_b[j * C + c]);
      } else {
        a = a + s_a[j * C + c];
        b = b + s_b[j * C + c];
      }
    }
    if (!MOMENTS) {
      const float wc = param_at(w, c);
      a = a * wc, b = b * wc;
    }
    s_a[c] = a, s_b[c] = b;  // slot 0's row: only this thread reads channel c
  }
  __syncthreads();
  const int cg = geo.cg();
  for (int g = t; g < geo.G; g += blockDim.x) {
    float n = 0.0f, a = 0.0f, b = 0.0f;
    for (int c = g * cg; c < (g + 1) * cg; ++c) {
      if (MOMENTS) {
        chan_merge(n, a, b, (float)nr, s_a[c], s_b[c]);
      } else {
        a = a + s_a[c];
        b = b + s_b[c];
      }
    }
    emit(g, a, b);
  }
}

// A warp's merge of sample n's S partials of group g (ws: (N, S, G) float2):
// lane l takes partials l, l + 32, ... in order (loaded AHEAD at a time),
// then a shuffle tree. Lane 0 holds (count, a, b).
template <bool MOMENTS>
__device__ __forceinline__ void merge_partials(const float2* __restrict__ ws, const Geo& geo, int n, int g,
                                               float& cnt, float& a, float& b) {
  constexpr int AHEAD = 8;  // partials a lane has in flight
  const int S = gridDim.x, lane = threadIdx.x & 31, cg = geo.cg();
  cnt = 0.0f, a = 0.0f, b = 0.0f;
  for (int q0 = lane; q0 < S; q0 += 32 * AHEAD) {
    float2 v[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int q = q0 + 32 * u;
      v[u] = q < S ? ws[((size_t)n * S + q) * geo.G + g] : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int q = q0 + 32 * u;
      const float nq = q < S ? (float)geo.rows(q) * (float)cg : 0.0f;
      if (MOMENTS) {
        chan_merge(cnt, a, b, nq, v[u].x, v[u].y);
      } else {
        cnt = cnt + nq, a = a + v[u].x, b = b + v[u].y;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float on = __shfl_down_sync(0xffffffffu, cnt, off);
    const float oa = __shfl_down_sync(0xffffffffu, a, off);
    const float ob = __shfl_down_sync(0xffffffffu, b, off);
    if (MOMENTS) {
      chan_merge(cnt, a, b, on, oa, ob);
    } else {
      cnt = cnt + on, a = a + oa, b = b + ob;
    }
  }
}

__global__ void __launch_bounds__(GN_MAX_THREADS)
    gn_stats_kernel(const T* __restrict__ x, Geo geo, float2* __restrict__ ws) {
  extern __shared__ float smem[];  // [2][R][C]
  const int C = geo.C, vpr = geo.vpr(), R = blockDim.x / vpr;
  const int t = threadIdx.x, v = t % vpr, j = t / vpr;
  const int n = blockIdx.y, s = blockIdx.x, nr = geo.rows(s);
  const T* base = x + ((size_t)n * geo.P + (size_t)s * geo.chunk) * C + v * GN_VEC;
  float mean[GN_VEC], m2[GN_VEC];
#pragma unroll
  for (int i = 0; i < GN_VEC; ++i) mean[i] = 0.0f, m2[i] = 0.0f;
  float k = 0.0f;
  auto update = [&](const float(&xv)[GN_VEC]) {
    k = k + 1.0f;
    const float inv = 1.0f / k;
#pragma unroll
    for (int i = 0; i < GN_VEC; ++i) {
      const float d = xv[i] - mean[i];
      mean[i] = mean[i] + d * inv;
      m2[i] = m2[i] + d * (xv[i] - mean[i]);
    }
  };
  int r = j;
  for (; r + 3 * R < nr; r += 4 * R) {  // four rows' loads in flight, held packed
    uint4 u[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) u[q] = Bf16x8::raw(base + (size_t)(r + q * R) * C);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float a[GN_VEC];
      Bf16x8::unpack(u[q], a);
      update(a);
    }
  }
  for (; r < nr; r += R) {
    float a[GN_VEC];
    Bf16x8::load(base + (size_t)r * C, a);
    update(a);
  }
  float* s_a = smem;
  float* s_b = smem + R * C;
#pragma unroll
  for (int i = 0; i < GN_VEC; ++i) s_a[j * C + v * GN_VEC + i] = mean[i], s_b[j * C + v * GN_VEC + i] = m2[i];
  __syncthreads();
  reduce_block<true>(s_a, s_b, geo, R, nr, nullptr, [&](int g, float a, float b) {
    ws[((size_t)n * gridDim.x + s) * geo.G + g] = make_float2(a, b);
  });
}

// a thread's scale and shift of its 8 channels
struct Consts {
  float scale[GN_VEC], shift[GN_VEC];
};

__device__ __forceinline__ void channel_consts(const float* s_mean, const float* s_rstd, const T* w,
                                               const T* b, int c0, int cg, Consts& k) {
#pragma unroll
  for (int i = 0; i < GN_VEC; ++i) {
    const int c = c0 + i, g = c / cg;
    const float sc = s_rstd[g] * param_at(w, c);
    k.scale[i] = sc;
    k.shift[i] = param_at(b, c) - s_mean[g] * sc;
  }
}

template <bool SILU>
__global__ void __launch_bounds__(GN_MAX_THREADS)
    gn_apply_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b, Geo geo, float eps,
                    const float2* __restrict__ ws, float* __restrict__ mean_out, float* __restrict__ rstd_out,
                    T* __restrict__ y) {
  extern __shared__ float smem[];  // [2][G]: the sample's mean and rstd
  const int G = geo.G, n = blockIdx.y, s = blockIdx.x, t = threadIdx.x;
  float* s_mean = smem;
  float* s_rstd = smem + G;
  for (int g = t >> 5; g < G; g += blockDim.x >> 5) {
    float cnt, mean, m2;
    merge_partials<true>(ws, geo, n, g, cnt, mean, m2);
    if ((t & 31) == 0) {
      const float rstd = rsqrtf(m2 / cnt + eps);  // the population variance, as var_mean(correction=0)
      s_mean[g] = mean, s_rstd[g] = rstd;
      if (s == 0) mean_out[n * G + g] = mean, rstd_out[n * G + g] = rstd;
    }
  }
  __syncthreads();
  const int C = geo.C, vpr = geo.vpr(), R = blockDim.x / vpr, v = t % vpr, j = t / vpr;
  Consts k;
  channel_consts(s_mean, s_rstd, w, b, v * GN_VEC, geo.cg(), k);
  const size_t off = ((size_t)n * geo.P + (size_t)s * geo.chunk) * C + v * GN_VEC;
  const T* xb = x + off;
  T* yb = y + off;
  const int nr = geo.rows(s);
  auto apply = [&](float(&xv)[GN_VEC]) {
#pragma unroll
    for (int i = 0; i < GN_VEC; ++i) {
      const float pre = __fmaf_rn(xv[i], k.scale[i], k.shift[i]);
      xv[i] = SILU ? silu_f(pre) : pre;
    }
  };
  int r = j;
  for (; r + 3 * R < nr; r += 4 * R) {  // four rows' loads in flight
    float a[4][GN_VEC];
#pragma unroll
    for (int u = 0; u < 4; ++u) Bf16x8::load(xb + (size_t)(r + u * R) * C, a[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      apply(a[u]);
      Bf16x8::store(yb + (size_t)(r + u * R) * C, a[u]);
    }
  }
  for (; r < nr; r += R) {
    float a[GN_VEC];
    Bf16x8::load(xb + (size_t)r * C, a);
    apply(a);
    Bf16x8::store(yb + (size_t)r * C, a);
  }
}

// The backward's per-channel constants of a thread's 8 channels (its
// groups' mean and rstd, and scale and shift as the forward formed them)
struct BwdConsts {
  float scale[GN_VEC], shift[GN_VEC], mu[GN_VEC], rs[GN_VEC];
};

__device__ __forceinline__ void bwd_consts(const float* __restrict__ mean, const float* __restrict__ rstd,
                                           const T* w, const T* b, int n, int G, int c0, int cg,
                                           BwdConsts& k) {
#pragma unroll
  for (int i = 0; i < GN_VEC; ++i) {
    const int g = (c0 + i) / cg;
    k.mu[i] = mean[n * G + g], k.rs[i] = rstd[n * G + g];
    k.scale[i] = k.rs[i] * param_at(w, c0 + i);
    k.shift[i] = param_at(b, c0 + i) - k.mu[i] * k.scale[i];
  }
}

// g = dy * silu'(pre), or dy, of channel i
template <bool SILU>
__device__ __forceinline__ float grad_in(float xv, float dv, const BwdConsts& k, int i) {
  return SILU ? silu_grad(dv, __fmaf_rn(xv, k.scale[i], k.shift[i])) : dv;
}

template <bool SILU>
__global__ void __launch_bounds__(GN_MAX_THREADS)
    gn_bwd_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ w,
                       const T* __restrict__ b, Geo geo, const float* __restrict__ mean,
                       const float* __restrict__ rstd, float2* __restrict__ ws) {
  extern __shared__ float smem[];  // [2][R][C]
  const int C = geo.C, G = geo.G, vpr = geo.vpr(), R = blockDim.x / vpr;
  const int t = threadIdx.x, v = t % vpr, j = t / vpr;
  const int n = blockIdx.y, s = blockIdx.x, nr = geo.rows(s), c0 = v * GN_VEC;
  BwdConsts k;
  bwd_consts(mean, rstd, w, b, n, G, c0, geo.cg(), k);
  const size_t off = ((size_t)n * geo.P + (size_t)s * geo.chunk) * C + c0;
  const T* xb = x + off;
  const T* db = dy + off;
  // sums of g and of g * (x - mean) per channel; times rstd at the end
  float s1[GN_VEC], s2[GN_VEC];
#pragma unroll
  for (int i = 0; i < GN_VEC; ++i) s1[i] = 0.0f, s2[i] = 0.0f;
  auto add = [&](const float(&xv)[GN_VEC], const float(&dv)[GN_VEC]) {
#pragma unroll
    for (int i = 0; i < GN_VEC; ++i) {
      const float gg = grad_in<SILU>(xv[i], dv[i], k, i);
      s1[i] = s1[i] + gg, s2[i] = s2[i] + gg * (xv[i] - k.mu[i]);
    }
  };
  int r = j;
  for (; r + R < nr; r += 2 * R) {  // two rows' loads in flight
    float xa[GN_VEC], da[GN_VEC], xc[GN_VEC], dc[GN_VEC];
    Bf16x8::load(xb + (size_t)r * C, xa);
    Bf16x8::load(db + (size_t)r * C, da);
    Bf16x8::load(xb + (size_t)(r + R) * C, xc);
    Bf16x8::load(db + (size_t)(r + R) * C, dc);
    add(xa, da), add(xc, dc);
  }
  if (r < nr) {
    float xa[GN_VEC], da[GN_VEC];
    Bf16x8::load(xb + (size_t)r * C, xa);
    Bf16x8::load(db + (size_t)r * C, da);
    add(xa, da);
  }
  float* s_a = smem;
  float* s_b = smem + R * C;
#pragma unroll
  for (int i = 0; i < GN_VEC; ++i) s_a[j * C + c0 + i] = s1[i], s_b[j * C + c0 + i] = s2[i] * k.rs[i];
  __syncthreads();
  reduce_block<false>(s_a, s_b, geo, R, nr, w, [&](int g, float a, float bb) {
    ws[((size_t)n * gridDim.x + s) * G + g] = make_float2(a, bb);
  });
}

template <bool SILU>
__global__ void __launch_bounds__(GN_MAX_THREADS)
    gn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ w,
                        const T* __restrict__ b, Geo geo, const float* __restrict__ mean,
                        const float* __restrict__ rstd, const float2* __restrict__ ws, T* __restrict__ dx) {
  extern __shared__ float smem[];  // [2][G]: S1 / n and S2 / n of the sample's groups
  const int C = geo.C, G = geo.G, n = blockIdx.y, s = blockIdx.x, t = threadIdx.x;
  float* s_k1 = smem;
  float* s_k2 = smem + G;
  for (int g = t >> 5; g < G; g += blockDim.x >> 5) {
    float cnt, a, bb;
    merge_partials<false>(ws, geo, n, g, cnt, a, bb);
    if ((t & 31) == 0) s_k1[g] = a / cnt, s_k2[g] = bb / cnt;
  }
  __syncthreads();
  const int vpr = geo.vpr(), R = blockDim.x / vpr, v = t % vpr, j = t / vpr, c0 = v * GN_VEC, cg = geo.cg();
  BwdConsts k;
  bwd_consts(mean, rstd, w, b, n, G, c0, cg, k);
  // dx = rstd * (w g - S1/n - x_hat S2/n) = scale g - K1 - (x - mean) K2
  // with K1 = rstd S1/n and K2 = rstd^2 S2/n
  float k1[GN_VEC], k2[GN_VEC];
#pragma unroll
  for (int i = 0; i < GN_VEC; ++i) {
    const int g = (c0 + i) / cg;
    k1[i] = k.rs[i] * s_k1[g];
    k2[i] = k.rs[i] * (k.rs[i] * s_k2[g]);
  }
  const size_t off = ((size_t)n * geo.P + (size_t)s * geo.chunk) * C + c0;
  const T* xb = x + off;
  const T* db = dy + off;
  T* ob = dx + off;
  const int nr = geo.rows(s);
  auto grad = [&](const float(&xv)[GN_VEC], const float(&dv)[GN_VEC], float(&out)[GN_VEC]) {
#pragma unroll
    for (int i = 0; i < GN_VEC; ++i)
      out[i] = k.scale[i] * grad_in<SILU>(xv[i], dv[i], k, i) - k1[i] - (xv[i] - k.mu[i]) * k2[i];
  };
  int r = j;
  for (; r + R < nr; r += 2 * R) {  // two rows' loads in flight
    float xa[GN_VEC], da[GN_VEC], xc[GN_VEC], dc[GN_VEC];
    Bf16x8::load(xb + (size_t)r * C, xa);
    Bf16x8::load(db + (size_t)r * C, da);
    Bf16x8::load(xb + (size_t)(r + R) * C, xc);
    Bf16x8::load(db + (size_t)(r + R) * C, dc);
    grad(xa, da, xa), grad(xc, dc, xc);
    Bf16x8::store(ob + (size_t)r * C, xa);
    Bf16x8::store(ob + (size_t)(r + R) * C, xc);
  }
  if (r < nr) {
    float xa[GN_VEC], da[GN_VEC];
    Bf16x8::load(xb + (size_t)r * C, xa);
    Bf16x8::load(db + (size_t)r * C, da);
    grad(xa, da, xa);
    Bf16x8::store(ob + (size_t)r * C, xa);
  }
}

// The launch shape the host chose, checked: threads a multiple of 32 and of
// C/8, from 32 to GN_MAX_THREADS; chunks covering P with none empty.
inline bool geometry_ok(int N, int P, int C, int G, int chunk, int S, int threads) {
  if (N <= 0 || P <= 0 || C <= 0 || G <= 0 || C % GN_VEC || C % G || chunk <= 0 || S <= 0) return false;
  const int vpr = C / GN_VEC;
  if (threads < 32 || threads > GN_MAX_THREADS || threads % 32 || threads % vpr) return false;
  if (N > 65535 || (long long)S * chunk < P || (long long)(S - 1) * chunk >= P) return false;
  return true;
}

template <bool SILU>
cudaError_t fwd(const void* x, const void* w, const void* b, int N, Geo geo, int S, int threads, float eps,
                float* ws, float* mean, float* rstd, void* y, cudaStream_t stream) {
  const dim3 grid(S, N);
  const int vpr = geo.C / GN_VEC, R = threads / vpr;
  gn_stats_kernel<<<grid, threads, 2 * R * geo.C * sizeof(float), stream>>>(
      static_cast<const T*>(x), geo, reinterpret_cast<float2*>(ws));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply_kernel<SILU><<<grid, threads, 2 * geo.G * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b), geo, eps,
      reinterpret_cast<const float2*>(ws), mean, rstd, static_cast<T*>(y));
  return cudaGetLastError();
}

template <bool SILU>
cudaError_t bwd(const void* x, const void* dy, const void* w, const void* b, int N, Geo geo, int S, int threads,
                const float* mean, const float* rstd, float* ws, void* dx, cudaStream_t stream) {
  const dim3 grid(S, N);
  const int vpr = geo.C / GN_VEC, R = threads / vpr;
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  gn_bwd_sums_kernel<SILU><<<grid, threads, 2 * R * geo.C * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), wt, bt, geo, mean, rstd, reinterpret_cast<float2*>(ws));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_bwd_apply_kernel<SILU><<<grid, threads, 2 * geo.G * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), wt, bt, geo, mean, rstd,
      reinterpret_cast<const float2*>(ws), static_cast<T*>(dx));
  return cudaGetLastError();
}

}  // namespace
}  // namespace gvd

// Forward: x (N, P, C) bf16, weight and bias (C,) bf16; writes y (N, P, C)
// bf16, mean and rstd (N, G) f32, using ws (N, S, G, 2) f32. Two launches:
// statistics, then apply.
GVD_API int gvd_group_norm_fwd(const void* x, const void* w, const void* b, int N, int P, int C, int G, int chunk,
                               int S, int threads, float eps, int silu, float* ws, float* mean, float* rstd, void* y,
                               cudaStream_t stream) {
  if (!gvd::geometry_ok(N, P, C, G, chunk, S, threads)) return (int)cudaErrorInvalidValue;
  const gvd::Geo geo{P, C, G, chunk};
  return (int)(silu ? gvd::fwd<true>(x, w, b, N, geo, S, threads, eps, ws, mean, rstd, y, stream)
                    : gvd::fwd<false>(x, w, b, N, geo, S, threads, eps, ws, mean, rstd, y, stream));
}

// Backward: dx (N, P, C) bf16 from dy, x and the forward's mean and rstd,
// using ws (N, S, G, 2) f32. Two launches: the group sums, then dx.
GVD_API int gvd_group_norm_bwd(const void* x, const void* dy, const void* w, const void* b, int N, int P, int C,
                               int G, int chunk, int S, int threads, int silu, const float* mean, const float* rstd,
                               float* ws, void* dx, cudaStream_t stream) {
  if (!gvd::geometry_ok(N, P, C, G, chunk, S, threads)) return (int)cudaErrorInvalidValue;
  const gvd::Geo geo{P, C, G, chunk};
  return (int)(silu ? gvd::bwd<true>(x, dy, w, b, N, geo, S, threads, mean, rstd, ws, dx, stream)
                    : gvd::bwd<false>(x, dy, w, b, N, geo, S, threads, mean, rstd, ws, dx, stream));
}
