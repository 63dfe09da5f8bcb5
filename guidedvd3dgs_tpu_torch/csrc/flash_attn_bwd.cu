// Kernel L1's backward: dq, dk, dv of softmax(q k^T * scale) v from the
// output cotangent dO, recomputing the softmax weights from the row
// log-sum-exp that the forward wrote (flash_attn_fwd.cu):
//
//   S = q k^T * scale,  P = exp(S - lse),  Delta_i = sum_d dO_id O_id
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Delta),
//   dK = dS^T Q * scale,  dQ = dS K * scale.
//
// Replaces the two Pallas calls of the backward of JAX's library TPU flash
// attention (jax/experimental/pallas/ops/tpu/flash_attention.py,
// `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`), which
// guidedvd3dgs_tpu/diffusion/nnops.py::_flash_attention_padded reaches
// under jax.vjp. As there, the work is split in two kernels, one that owns
// a tile of keys and walks the queries (dK, dV) and one that owns a tile of
// queries and walks the keys (dQ): every output element is summed by one
// thread in a fixed order, so the result is deterministic and needs no
// atomics. Delta is a row reduction the caller computes (the JAX VJP does
// so outside its kernels too). The ragged tail is masked as in the forward:
// keys >= n get P = 0, rows >= n are read as zero and never written.
//
// Layout: q, k, v, dO and the outputs are contiguous (B*H, n, D) in one
// type, float32 or bfloat16; lse and Delta are (B*H, n) float32. Every
// accumulator is float32; P is rounded to the input type before the
// product with dO, as the plain version rounds the forward's weights.
//
// What bounds it on this card: operations. At the UNet's shape in the
// guided step (B*H = 25*5, n = 2240, D = 64, bf16; one CFG branch, whose
// VJP runs alone) one n x n product is 2 * 125 * 2240^2 * 64 = 8.03e10
// FLOP. dK/dV does four (S, dP, dV, dK): 3.21e11 FLOP, 0.325 ms at 989
// TFLOP/s; dQ three (S, dP, dQ): 2.41e11 FLOP, 0.244 ms; q, k, v and dO are
// 36 MB each (0.05 ms at 3.35 TB/s). So bf16 at D <= 128 runs on the
// tensor cores (mma.sync m16n8k16, below): S and dP are recomputed per
// tile in f32 fragments and never leave registers, and P and dS become the
// bf16 A fragments of the next product directly (the forward's trick), so
// no n x n matrix touches memory. The tiles are staged with plain loads and no pipeline; the
// operands that a product needs transposed (Q, dO for dK/dV; K for dQ) are
// staged twice, once per layout. float32, and bf16 at D = 512 (the VAE's
// single head), take every product as a float32 FMA (__fmaf_rn: the library
// is built with -fmad=false), the forward's FMA design: G = D/32 threads
// own a row with 32 dims each in registers, the other side's rows stream
// through dynamic shared memory, and each pair of rows meets by a butterfly
// shuffle; its ceiling is the 67 TFLOP/s float32 rate.

#include "flash_attn.cuh"

#include <math.h>

namespace gvd {
namespace {

using bf16 = __nv_bfloat16;
using fa::ld_pair;
using fa::mma_bf16;
using fa::pack_bf16;

// ---- bf16 tensor-core path (D <= 128) ----

template <int D>
struct BwdMma {
  static constexpr int KP = D + 8;                // padded row of a row-major tile
  // dK/dV: 64 keys per block (4 warps x 16), queries in tiles of BQ
  static constexpr int BK = 64;
  static constexpr int BQ = D <= 64 ? 64 : 32;
  static constexpr int QTP = BQ + 8;              // padded row of Q^T, dO^T
  static constexpr int DKV_SMEM = (2 * BK * KP + 2 * BQ * KP + 2 * D * QTP) * 2 + 2 * BQ * 4;
  // dQ: 64 queries per block (4 warps x 16), keys in tiles of BK2
  static constexpr int BQ2 = 64;
  static constexpr int BK2 = D <= 64 ? 64 : 32;
  static constexpr int KTP = BK2 + 8;             // padded row of K^T
  static constexpr int DQ_SMEM = (2 * BK2 * KP + D * KTP) * 2;
};

// dK/dV. Each warp owns 16 keys and computes the transposed products
// S^T = K Q^T and dP^T = V dO^T (rows = its keys), so that P^T and dS^T
// are A fragments of dV += P^T dO and dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(fa::THREADS_MMA)
flash_attn_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, int n, float scale) {
  using S = BwdMma<D>;
  constexpr int KP = S::KP, BK = S::BK, BQ = S::BQ, QTP = S::QTP;
  constexpr int KD = D / 16;  // k-steps over the head dims
  constexpr int NQ = BQ / 8;  // n-tiles over the queries
  constexpr int ND = D / 8;   // n-tiles over the head dims
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][KP]
  bf16* vs = ks + BK * KP;                       // [BK][KP]
  bf16* qs = vs + BK * KP;                       // [BQ][KP]
  bf16* dos = qs + BQ * KP;                      // [BQ][KP]
  bf16* qt = dos + BQ * KP;                      // [D][QTP]
  bf16* dot = qt + D * QTP;                      // [D][QTP]
  float* lse_s = reinterpret_cast<float*>(dot + D * QTP);
  float* delta_s = lse_s + BQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int w16 = warp * 16;
  const int k0 = blockIdx.x * BK;
  const size_t head = (size_t)blockIdx.y * (size_t)n * D;
  const float* lse_h = lse + (size_t)blockIdx.y * n;
  const float* delta_h = delta + (size_t)blockIdx.y * n;

  fa::stage_bf16<D>(k + head, k0, BK, n, ks, nullptr);
  fa::stage_bf16<D>(v + head, k0, BK, n, vs, nullptr);

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.0f;
  }

  for (int q0 = 0; q0 < n; q0 += BQ) {
    __syncthreads();  // every warp is done with the previous tile (and K, V are staged)
    fa::stage_bf16<D>(q + head, q0, BQ, n, qs, qt);
    fa::stage_bf16<D>(dout + head, q0, BQ, n, dos, dot);
    for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
      const bool ok = q0 + i < n;
      lse_s[i] = ok ? lse_h[q0 + i] : 0.0f;
      delta_s[i] = ok ? delta_h[q0 + i] : 0.0f;
    }
    __syncthreads();

    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      fa::ld_a_frag(ka, ks, KP, w16, kk, g, t4);
      fa::ld_a_frag(va, vs, KP, w16, kk, g, t4);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
        const bf16* qb = qs + (nt * 8 + g) * KP + kk * 16 + t4 * 2;
        mma_bf16(s[nt], ka, ld_pair(qb), ld_pair(qb + 8));
        const bf16* db = dos + (nt * 8 + g) * KP + kk * 16 + t4 * 2;
        mma_bf16(dp[nt], va, ld_pair(db), ld_pair(db + 8));
      }
    }
    // P^T (0 for queries past n) and dS^T, packed as bf16 A fragments:
    // query n-tiles 2kk and 2kk+1 are the two halves of k-step kk
    uint32_t pa[NQ / 2][4], dsa[NQ / 2][4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + t4 * 2 + e;
        const bool ok = q0 + col < n;
        const float l = lse_s[col], dl = delta_s[col];
        const float p0 = ok ? expf(s[nt][e] * scale - l) : 0.0f;      // key row g
        const float p1 = ok ? expf(s[nt][2 + e] * scale - l) : 0.0f;  // key row g + 8
        s[nt][e] = p0;
        s[nt][2 + e] = p1;
        dp[nt][e] = p0 * (dp[nt][e] - dl);
        dp[nt][2 + e] = p1 * (dp[nt][2 + e] - dl);
      }
      pa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(s[nt][0], s[nt][1]);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(s[nt][2], s[nt][3]);
      dsa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(dp[nt][0], dp[nt][1]);
      dsa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(dp[nt][2], dp[nt][3]);
    }
    // dV += P^T dO and dK += dS^T Q (the scale at the end)
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) {
        const bf16* ob = dot + (dt * 8 + g) * QTP + kk * 16 + t4 * 2;
        mma_bf16(dva[dt], pa[kk], ld_pair(ob), ld_pair(ob + 8));
        const bf16* qb = qt + (dt * 8 + g) * QTP + kk * 16 + t4 * 2;
        mma_bf16(dka[dt], dsa[kk], ld_pair(qb), ld_pair(qb + 8));
      }
    }
  }

  const int r0 = k0 + w16 + g;  // this thread's keys: r0 and r0 + 8
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) {
    const int d = dt * 8 + t4 * 2;
    if (r0 < n) {
      const size_t at = head + (size_t)r0 * D + d;
      *reinterpret_cast<__nv_bfloat162*>(dv + at) = __floats2bfloat162_rn(dva[dt][0], dva[dt][1]);
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(dka[dt][0] * scale, dka[dt][1] * scale);
    }
    if (r0 + 8 < n) {
      const size_t at = head + (size_t)(r0 + 8) * D + d;
      *reinterpret_cast<__nv_bfloat162*>(dv + at) = __floats2bfloat162_rn(dva[dt][2], dva[dt][3]);
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(dka[dt][2] * scale, dka[dt][3] * scale);
    }
  }
}

// dQ. Each warp owns 16 queries (q and dO as A fragments in registers)
// and walks the keys: S = Q K^T, dP = dO V^T, dS as the A fragment of
// dQ += dS K (K staged transposed as its B operand).
template <int D>
__global__ void __launch_bounds__(fa::THREADS_MMA)
flash_attn_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             bf16* __restrict__ dq, int n, float scale) {
  using S = BwdMma<D>;
  constexpr int KP = S::KP, BK = S::BK2, KTP = S::KTP;
  constexpr int KD = D / 16;  // k-steps over the head dims
  constexpr int NK = BK / 8;  // n-tiles over the keys
  constexpr int ND = D / 8;   // n-tiles over the head dims
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][KP]
  bf16* vs = ks + BK * KP;                       // [BK][KP]
  bf16* kt = vs + BK * KP;                       // [D][KTP]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t head = (size_t)blockIdx.y * (size_t)n * D;
  const int r0 = blockIdx.x * S::BQ2 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const bf16* qh = q + head;
  const bf16* oh = dout + head;

  auto pair_at = [&](const bf16* base, int row, int d) -> uint32_t {
    return row < n ? ld_pair(base + (size_t)row * D + d) : 0u;
  };
  uint32_t qf[KD][4], of[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int d0 = kk * 16 + t4 * 2;
    qf[kk][0] = pair_at(qh, r0, d0);
    qf[kk][1] = pair_at(qh, r0 + 8, d0);
    qf[kk][2] = pair_at(qh, r0, d0 + 8);
    qf[kk][3] = pair_at(qh, r0 + 8, d0 + 8);
    of[kk][0] = pair_at(oh, r0, d0);
    of[kk][1] = pair_at(oh, r0 + 8, d0);
    of[kk][2] = pair_at(oh, r0, d0 + 8);
    of[kk][3] = pair_at(oh, r0 + 8, d0 + 8);
  }
  const float* lse_h = lse + (size_t)blockIdx.y * n;
  const float* delta_h = delta + (size_t)blockIdx.y * n;
  const float l0 = r0 < n ? lse_h[r0] : 0.0f, l1 = r0 + 8 < n ? lse_h[r0 + 8] : 0.0f;
  const float dl0 = r0 < n ? delta_h[r0] : 0.0f, dl1 = r0 + 8 < n ? delta_h[r0 + 8] : 0.0f;

  float dqa[ND][4];
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) dqa[dt][0] = dqa[dt][1] = dqa[dt][2] = dqa[dt][3] = 0.0f;

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // every warp is done with the previous tile
    fa::stage_bf16<D>(k + head, k0, BK, n, ks, kt);
    fa::stage_bf16<D>(v + head, k0, BK, n, vs, nullptr);
    __syncthreads();

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const bf16* kb = ks + (nt * 8 + g) * KP + kk * 16 + t4 * 2;
        mma_bf16(s[nt], qf[kk], ld_pair(kb), ld_pair(kb + 8));
        const bf16* vb = vs + (nt * 8 + g) * KP + kk * 16 + t4 * 2;
        mma_bf16(dp[nt], of[kk], ld_pair(vb), ld_pair(vb + 8));
      }
    }
    // dS = P o (dP - Delta), P = 0 for keys past n; key n-tiles 2kk and
    // 2kk+1 are the two halves of k-step kk of the A fragment
    uint32_t dsa[NK / 2][4];
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = k0 + nt * 8 + t4 * 2 + e < n;
        const float p0 = ok ? expf(s[nt][e] * scale - l0) : 0.0f;      // row g
        const float p1 = ok ? expf(s[nt][2 + e] * scale - l1) : 0.0f;  // row g + 8
        dp[nt][e] = p0 * (dp[nt][e] - dl0);
        dp[nt][2 + e] = p1 * (dp[nt][2 + e] - dl1);
      }
      dsa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(dp[nt][0], dp[nt][1]);
      dsa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(dp[nt][2], dp[nt][3]);
    }
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk) {
        const bf16* kb = kt + (dt * 8 + g) * KTP + kk * 16 + t4 * 2;
        mma_bf16(dqa[dt], dsa[kk], ld_pair(kb), ld_pair(kb + 8));
      }
    }
  }

  bf16* dqh = dq + head;
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) {
    const int d = dt * 8 + t4 * 2;
    if (r0 < n)
      *reinterpret_cast<__nv_bfloat162*>(dqh + (size_t)r0 * D + d) =
          __floats2bfloat162_rn(dqa[dt][0] * scale, dqa[dt][1] * scale);
    if (r0 + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(dqh + (size_t)(r0 + 8) * D + d) =
          __floats2bfloat162_rn(dqa[dt][2] * scale, dqa[dt][3] * scale);
  }
}

// ---- float32 FMA path (float32, and bf16 at D = 512) ----

template <int D>
struct BwdFma {
  static constexpr int G = D / fa::DT;                  // threads per row
  static constexpr int THREADS = G >= 8 ? 256 : 128;
  static constexpr int ROWS = THREADS / G;              // rows owned per block
  static constexpr int BT = D >= 512 ? 16 : 32;         // rows of the other side per shared tile
  static constexpr int SMEM = 2 * BT * D * (int)sizeof(float) + 2 * BT * (int)sizeof(float);
};

// this thread's dims of a row: chunk c holds d = (c * G + g) * 4 + e, e < 4
template <int D, typename T>
__device__ __forceinline__ void load_row(float* r, const T* __restrict__ src, bool live, int g) {
  constexpr int G = BwdFma<D>::G;
#pragma unroll
  for (int c = 0; c < fa::NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) r[c * 4 + e] = live ? fa::to_f32(src[(c * G + g) * 4 + e]) : 0.0f;
  }
}

template <int D, typename T>
__device__ __forceinline__ void store_row(T* dst, const float* r, float mul, int g) {
  constexpr int G = BwdFma<D>::G;
#pragma unroll
  for (int c = 0; c < fa::NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) fa::store_out(dst + (c * G + g) * 4 + e, r[c * 4 + e] * mul);
  }
}

// the dot product of a row held in registers with a shared row, summed over
// the G threads of the row
template <int G>
__device__ __forceinline__ float row_dot(const float* r, const float* tile_row, int g) {
  const float4* t = reinterpret_cast<const float4*>(tile_row);
  float part = 0.0f;
#pragma unroll
  for (int c = 0; c < fa::NC; ++c) {
    const float4 x = t[c * G + g];
    part = __fmaf_rn(r[c * 4 + 0], x.x, part);
    part = __fmaf_rn(r[c * 4 + 1], x.y, part);
    part = __fmaf_rn(r[c * 4 + 2], x.z, part);
    part = __fmaf_rn(r[c * 4 + 3], x.w, part);
  }
#pragma unroll
  for (int off = 1; off < G; off <<= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  return part;
}

// acc += a * (this thread's dims of a shared row)
template <int G>
__device__ __forceinline__ void row_axpy(float* acc, float a, const float* tile_row, int g) {
  const float4* t = reinterpret_cast<const float4*>(tile_row);
#pragma unroll
  for (int c = 0; c < fa::NC; ++c) {
    const float4 x = t[c * G + g];
    acc[c * 4 + 0] = __fmaf_rn(a, x.x, acc[c * 4 + 0]);
    acc[c * 4 + 1] = __fmaf_rn(a, x.y, acc[c * 4 + 1]);
    acc[c * 4 + 2] = __fmaf_rn(a, x.z, acc[c * 4 + 2]);
    acc[c * 4 + 3] = __fmaf_rn(a, x.w, acc[c * 4 + 3]);
  }
}

// stage rows [r0, r0 + BT) of two (n, D) matrices as float32 (zero past n)
template <int D, typename T>
__device__ __forceinline__ void stage_f32(const T* __restrict__ a, const T* __restrict__ b, int r0, int n,
                                          float* as, float* bs) {
  constexpr int BT = BwdFma<D>::BT;
  for (int i = threadIdx.x; i < BT * D; i += blockDim.x) {
    const bool ok = r0 + i / D < n;
    const size_t idx = (size_t)r0 * D + i;
    as[i] = ok ? fa::to_f32(a[idx]) : 0.0f;
    bs[i] = ok ? fa::to_f32(b[idx]) : 0.0f;
  }
}

// dK/dV: a block owns ROWS keys (K, V, dK, dV rows in registers) and walks
// the queries in shared tiles of BT rows of Q and dO
template <int D, typename T>
__global__ void __launch_bounds__(BwdFma<D>::THREADS)
flash_attn_bwd_dkv_fma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                              const T* __restrict__ dout, const float* __restrict__ lse,
                              const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                              int n, float scale) {
  using S = BwdFma<D>;
  constexpr int G = S::G, BT = S::BT;
  extern __shared__ float4 fa_bwd_smem[];
  float* qs = reinterpret_cast<float*>(fa_bwd_smem);  // [BT][D]
  float* dos = qs + BT * D;                           // [BT][D]
  float* lse_s = dos + BT * D;                        // [BT]
  float* delta_s = lse_s + BT;                        // [BT]

  const int g = threadIdx.x % G;
  const int row = blockIdx.x * S::ROWS + threadIdx.x / G;
  const bool live = row < n;
  const size_t head = (size_t)blockIdx.y * (size_t)n * D;
  const float* lse_h = lse + (size_t)blockIdx.y * n;
  const float* delta_h = delta + (size_t)blockIdx.y * n;

  float kr[fa::DT], vr[fa::DT], dka[fa::DT], dva[fa::DT];
  load_row<D>(kr, k + head + (size_t)row * D, live, g);
  load_row<D>(vr, v + head + (size_t)row * D, live, g);
#pragma unroll
  for (int i = 0; i < fa::DT; ++i) dka[i] = dva[i] = 0.0f;

  for (int q0 = 0; q0 < n; q0 += BT) {
    __syncthreads();  // every thread is done with the previous tile
    stage_f32<D>(q + head, dout + head, q0, n, qs, dos);
    for (int i = threadIdx.x; i < BT; i += blockDim.x) {
      const bool ok = q0 + i < n;
      lse_s[i] = ok ? lse_h[q0 + i] : 0.0f;
      delta_s[i] = ok ? delta_h[q0 + i] : 0.0f;
    }
    __syncthreads();
    const int jn = min(BT, n - q0);
    for (int j = 0; j < jn; ++j) {
      const float p = expf(row_dot<G>(kr, qs + j * D, g) * scale - lse_s[j]);
      const float ds = p * (row_dot<G>(vr, dos + j * D, g) - delta_s[j]);
      row_axpy<G>(dva, fa::round_to(p, T()), dos + j * D, g);
      row_axpy<G>(dka, ds, qs + j * D, g);
    }
  }
  if (live) {
    store_row<D>(dk + head + (size_t)row * D, dka, scale, g);
    store_row<D>(dv + head + (size_t)row * D, dva, 1.0f, g);
  }
}

// dQ: a block owns ROWS queries (q, dO, dQ rows in registers) and walks
// the keys in shared tiles of BT rows of K and V
template <int D, typename T>
__global__ void __launch_bounds__(BwdFma<D>::THREADS)
flash_attn_bwd_dq_fma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                             const T* __restrict__ dout, const float* __restrict__ lse,
                             const float* __restrict__ delta, T* __restrict__ dq, int n, float scale) {
  using S = BwdFma<D>;
  constexpr int G = S::G, BT = S::BT;
  extern __shared__ float4 fa_bwd_smem[];
  float* ks = reinterpret_cast<float*>(fa_bwd_smem);  // [BT][D]
  float* vs = ks + BT * D;                            // [BT][D]

  const int g = threadIdx.x % G;
  const int row = blockIdx.x * S::ROWS + threadIdx.x / G;
  const bool live = row < n;
  const size_t head = (size_t)blockIdx.y * (size_t)n * D;
  const float l = live ? lse[(size_t)blockIdx.y * n + row] : 0.0f;
  const float dl = live ? delta[(size_t)blockIdx.y * n + row] : 0.0f;

  float qr[fa::DT], dor[fa::DT], dqa[fa::DT];
  load_row<D>(qr, q + head + (size_t)row * D, live, g);
  load_row<D>(dor, dout + head + (size_t)row * D, live, g);
#pragma unroll
  for (int i = 0; i < fa::DT; ++i) dqa[i] = 0.0f;

  for (int k0 = 0; k0 < n; k0 += BT) {
    __syncthreads();  // every thread is done with the previous tile
    stage_f32<D>(k + head, v + head, k0, n, ks, vs);
    __syncthreads();
    const int jn = min(BT, n - k0);
    for (int j = 0; j < jn; ++j) {
      const float p = expf(row_dot<G>(qr, ks + j * D, g) * scale - l);
      const float ds = p * (row_dot<G>(dor, vs + j * D, g) - dl);
      row_axpy<G>(dqa, ds, ks + j * D, g);
    }
  }
  if (live) store_row<D>(dq + head + (size_t)row * D, dqa, scale, g);
}

// ---- launchers ----

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int bh, n;
  float scale;
  cudaStream_t stream;
};

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int dkv_mma(const BwdArgs& a) {
  using S = BwdMma<D>;
  auto kernel = flash_attn_bwd_dkv_mma_kernel<D>;
  cudaError_t err = set_smem(kernel, S::DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + S::BK - 1) / S::BK, a.bh);
  kernel<<<grid, fa::THREADS_MMA, S::DKV_SMEM, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.n, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int dq_mma(const BwdArgs& a) {
  using S = BwdMma<D>;
  auto kernel = flash_attn_bwd_dq_mma_kernel<D>;
  cudaError_t err = set_smem(kernel, S::DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + S::BQ2 - 1) / S::BQ2, a.bh);
  kernel<<<grid, fa::THREADS_MMA, S::DQ_SMEM, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), a.lse, a.delta, static_cast<bf16*>(a.dq), a.n, a.scale);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int dkv_fma(const BwdArgs& a) {
  using S = BwdFma<D>;
  auto kernel = flash_attn_bwd_dkv_fma_kernel<D, T>;
  cudaError_t err = set_smem(kernel, S::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + S::ROWS - 1) / S::ROWS, a.bh);
  kernel<<<grid, S::THREADS, S::SMEM, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.n,
      a.scale);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int dq_fma(const BwdArgs& a) {
  using S = BwdFma<D>;
  auto kernel = flash_attn_bwd_dq_fma_kernel<D, T>;
  cudaError_t err = set_smem(kernel, S::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + S::ROWS - 1) / S::ROWS, a.bh);
  kernel<<<grid, S::THREADS, S::SMEM, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dq), a.n, a.scale);
  return (int)cudaGetLastError();
}

// which: 0 dK/dV, 1 dQ. bf16 at D <= 128 on the tensor cores; float32,
// and bf16 at D = 512, on float32 FMAs.
int dispatch(int which, const BwdArgs& a, int d, int dtype) {
  if (dtype == 0) {
    switch (d) {
      case 32: return which == 0 ? dkv_fma<32, float>(a) : dq_fma<32, float>(a);
      case 64: return which == 0 ? dkv_fma<64, float>(a) : dq_fma<64, float>(a);
      case 128: return which == 0 ? dkv_fma<128, float>(a) : dq_fma<128, float>(a);
      case 512: return which == 0 ? dkv_fma<512, float>(a) : dq_fma<512, float>(a);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (d) {
      case 32: return which == 0 ? dkv_mma<32>(a) : dq_mma<32>(a);
      case 64: return which == 0 ? dkv_mma<64>(a) : dq_mma<64>(a);
      case 128: return which == 0 ? dkv_mma<128>(a) : dq_mma<128>(a);
      case 512: return which == 0 ? dkv_fma<512, bf16>(a) : dq_fma<512, bf16>(a);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace gvd

// dtype: 0 float32, 1 bfloat16. lse, delta: (bh, n) float32. Each returns
// cudaGetLastError() of its launch.
GVD_API int gvd_flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                   const float* lse, const float* delta, void* dk, void* dv, int bh, int n,
                                   int d, int dtype, float scale, cudaStream_t stream) {
  if (bh <= 0 || n <= 0) return 0;
  if (bh > 65535) return (int)cudaErrorInvalidValue;
  const gvd::BwdArgs a{q, k, v, dout, lse, delta, nullptr, dk, dv, bh, n, scale, stream};
  return gvd::dispatch(0, a, d, dtype);
}

GVD_API int gvd_flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* delta, void* dq, int bh, int n, int d,
                                  int dtype, float scale, cudaStream_t stream) {
  if (bh <= 0 || n <= 0) return 0;
  if (bh > 65535) return (int)cudaErrorInvalidValue;
  const gvd::BwdArgs a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, bh, n, scale, stream};
  return gvd::dispatch(1, a, d, dtype);
}
