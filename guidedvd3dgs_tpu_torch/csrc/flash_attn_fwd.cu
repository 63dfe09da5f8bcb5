// Kernel L1: flash-attention forward, softmax(q k^T * scale) v without an
// N x N matrix of logits in memory.
//
// Replaces guidedvd3dgs_tpu/diffusion/nnops.py::_flash_attention_padded
// (:193), which calls JAX's library Pallas TPU flash attention
// (jax.experimental.pallas.ops.tpu.flash_attention, :214) after padding the
// sequence to a multiple of 128 and masking the pad keys with segment ids.
// Here the ragged tail is masked in the kernel: keys >= n score -inf and
// query rows >= n are not written, so nothing is padded.
//
// Layout: q, k, v, o are contiguous (B*H, n, D) in float32 or bfloat16, one
// type for all four. Logits, softmax statistics and the output accumulator
// are float32; the scale multiplies the float32 logit; the output is
// written in the input type. Under autograd the caller also passes `lse`
// (B*H, n) float32, and each query row writes m + log(l) of its online
// softmax there (the backward's P = exp(S - lse), flash_attn_bwd.cu); a
// null `lse` writes nothing.
//
// What bounds it on this card: operations. At the UNet's level-0 shape
// (B*H = 25*5, n = 2240, D = 64, bf16) it does 4 * 125 * 2240^2 * 64 =
// 1.61e11 FLOP, 0.162 ms at the tensor cores' 989 TFLOP/s, against 143 MB
// of q, k, v and o (0.043 ms at 3.35 TB/s). Two kernels:
//  * bf16 with D <= 128 (the UNet's shape) runs on the tensor cores with
//    mma.sync (below, flash_attn_fwd_mma_kernel): f32 accumulators, P
//    rounded to bf16 for the second product as the plain version rounds
//    its weights. It stages tiles with plain loads and no pipeline; the
//    wgmma/TMA form that reaches the bf16 bound is later work (PERF.md).
//  * float32 (and bf16 at D = 512: the VAE's single head) takes
//    every product as a float32 FMA (__fmaf_rn, written out, since the
//    library is built with -fmad=false), whose ceiling is the 67 TFLOP/s
//    float32 rate.
//
// Design of the FMA kernel. One block per (query tile, batch*head). A query row is owned by
// G = D/32 neighbouring threads, each holding 32 of its head dims (chunks
// of 4, interleaved by thread so that a warp's shared-memory reads of one
// key row are contiguous): its slice of q and of the output accumulator
// stay in registers. The block walks the keys in tiles of BK rows staged
// in shared memory as float32 (dynamic shared memory: 2 * BK * D * 4
// bytes, 64 KB at D = 512). For each key a thread takes the dot product of
// its slice, the G partial sums meet by butterfly shuffles, and the row
// keeps an online softmax (running max m and sum l): a tile's logits live
// in registers, the accumulator is rescaled once per tile by exp(m - m'),
// and each key adds p * v. A row's 32 dims per thread keep the accumulator
// in registers for every D (no spill at D = 512).

#include "flash_attn.cuh"

#include <math.h>

namespace gvd {
namespace {

using fa::mma_bf16;
using fa::pack_bf16;
using fa::store_out;
using fa::to_f32;
constexpr int FA_DT = fa::DT;  // head dims per thread
constexpr int FA_NC = fa::NC;  // float4 chunks per thread

template <int D>
struct FaShape {
  static constexpr int G = D / FA_DT;               // threads per query row
  static constexpr int THREADS = G >= 8 ? 256 : 128;
  static constexpr int BQ = THREADS / G;            // query rows per block
  static constexpr int BK = D >= 512 ? 16 : 32;     // keys per shared tile
  static constexpr int SMEM = 2 * BK * D * (int)sizeof(float);
};

template <int D, typename T>
__global__ void __launch_bounds__(FaShape<D>::THREADS)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, float* __restrict__ lse, int n, float scale) {
  constexpr int G = FaShape<D>::G;
  constexpr int THREADS = FaShape<D>::THREADS;
  constexpr int BQ = FaShape<D>::BQ;
  constexpr int BK = FaShape<D>::BK;
  extern __shared__ float4 fa_smem[];
  float* ks = reinterpret_cast<float*>(fa_smem);  // [BK][D]
  float* vs = ks + BK * D;                        // [BK][D]

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int row = blockIdx.x * BQ + tid / G;
  const bool live = row < n;
  const size_t head = (size_t)blockIdx.y * (size_t)n * D;

  // this thread's dims: chunk c holds d = (c * G + g) * 4 + e, e < 4
  float qr[FA_DT], acc[FA_DT];
#pragma unroll
  for (int c = 0; c < FA_NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = (c * G + g) * 4 + e;
      qr[c * 4 + e] = live ? to_f32(q[head + (size_t)row * D + d]) : 0.0f;
      acc[c * 4 + e] = 0.0f;
    }
  }
  float m = -INFINITY, l = 0.0f;

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < BK * D; i += THREADS) {
      const bool ok = k0 + i / D < n;
      const size_t idx = head + (size_t)k0 * D + i;
      ks[i] = ok ? to_f32(k[idx]) : 0.0f;
      vs[i] = ok ? to_f32(v[idx]) : 0.0f;
    }
    __syncthreads();

    float s[BK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * D);
      float part = 0.0f;
#pragma unroll
      for (int c = 0; c < FA_NC; ++c) {
        const float4 kk = kr[c * G + g];
        part = __fmaf_rn(qr[c * 4 + 0], kk.x, part);
        part = __fmaf_rn(qr[c * 4 + 1], kk.y, part);
        part = __fmaf_rn(qr[c * 4 + 2], kk.z, part);
        part = __fmaf_rn(qr[c * 4 + 3], kk.w, part);
      }
#pragma unroll
      for (int off = 1; off < G; off <<= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      s[j] = (k0 + j < n) ? part * scale : -INFINITY;  // the ragged tail
      tile_max = fmaxf(tile_max, s[j]);
    }
    // every tile holds key k0 < n, so m_new is finite; exp(-inf) = 0 at the first
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < FA_DT; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(vs + j * D);
#pragma unroll
      for (int c = 0; c < FA_NC; ++c) {
        const float4 vv = vr[c * G + g];
        acc[c * 4 + 0] = __fmaf_rn(p, vv.x, acc[c * 4 + 0]);
        acc[c * 4 + 1] = __fmaf_rn(p, vv.y, acc[c * 4 + 1]);
        acc[c * 4 + 2] = __fmaf_rn(p, vv.z, acc[c * 4 + 2]);
        acc[c * 4 + 3] = __fmaf_rn(p, vv.w, acc[c * 4 + 3]);
      }
    }
    m = m_new;
  }

  if (live) {
    const float inv = 1.0f / l;
    T* out = o + head + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < FA_NC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) store_out(out + (c * G + g) * 4 + e, acc[c * 4 + e] * inv);
    }
    // the G threads of a row hold the same m and l
    if (lse != nullptr && g == 0) lse[(size_t)blockIdx.y * n + row] = m + logf(l);
  }
}

// ---- bf16 tensor-core path (D <= 128): mma.sync m16n8k16, f32 accumulators ----
//
// One block of 4 warps per (64 query rows, batch*head); each warp owns 16
// rows. Q stays in registers as mma A fragments. Per tile of 64 keys the
// block stages K as [key][d] and V transposed as [d][key] in shared memory
// (rows padded by 8 bf16, so the fragment reads of a warp hit 32 banks),
// then each warp computes S = Q K^T (f32), masks keys >= n, updates its
// online softmax (the 4 lanes that share a row meet by shuffles), rounds P
// to bf16 straight from the S fragments into A fragments, and adds P V.

constexpr int MMA_BQ = 64;       // query rows per block (4 warps x 16)
constexpr int MMA_BK = 64;       // keys per shared tile
constexpr int MMA_THREADS = 128;

// two neighbouring bf16 of row `row` (zero past the ragged tail)
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base, int row, int d, int n, int D) {
  return row < n ? *reinterpret_cast<const uint32_t*>(base + (size_t)row * D + d) : 0u;
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_attn_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int n, float scale) {
  constexpr int KP = D + 8;       // padded K row
  constexpr int VP = MMA_BK + 8;  // padded V^T row
  constexpr int KD = D / 16;      // k-steps of Q K^T
  constexpr int NT = MMA_BK / 8;  // n-tiles of S
  __shared__ __align__(16) __nv_bfloat16 ks[MMA_BK * KP];
  __shared__ __align__(16) __nv_bfloat16 vt[D * VP];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row and column pair
  const size_t head = (size_t)blockIdx.y * (size_t)n * D;
  const __nv_bfloat16* qh = q + head;
  const __nv_bfloat16* kh = k + head;
  const __nv_bfloat16* vh = v + head;
  const int r0 = blockIdx.x * MMA_BQ + warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int d0 = kk * 16 + t4 * 2;
    qf[kk][0] = load_pair(qh, r0, d0, n, D);
    qf[kk][1] = load_pair(qh, r0 + 8, d0, n, D);
    qf[kk][2] = load_pair(qh, r0, d0 + 8, n, D);
    qf[kk][3] = load_pair(qh, r0 + 8, d0 + 8, n, D);
  }
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  for (int k0 = 0; k0 < n; k0 += MMA_BK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < MMA_BK * D / 8; i += MMA_THREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      uint4 kk4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kk4;
      if (k0 + r < n) {
        kk4 = *reinterpret_cast<const uint4*>(kh + (size_t)(k0 + r) * D + c);
        vv4 = *reinterpret_cast<const uint4*>(vh + (size_t)(k0 + r) * D + c);
      }
      *reinterpret_cast<uint4*>(ks + r * KP + c) = kk4;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c + j) * VP + r] = ve[j];
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const __nv_bfloat16* kb = ks + (nt * 8 + g) * KP + kk * 16 + t4 * 2;
        mma_bf16(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kb),
                 *reinterpret_cast<const uint32_t*>(kb + 8));
      }
    }
    // scale the f32 logits, mask the ragged tail, row maxima
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = k0 + nt * 8 + t4 * 2 + e < n;
        s[nt][e] = ok ? s[nt][e] * scale : -INFINITY;
        s[nt][2 + e] = ok ? s[nt][2 + e] * scale : -INFINITY;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // every tile holds key k0 < n, so the new maxima are finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= c0;
      acc[dt][1] *= c0;
      acc[dt][2] *= c1;
      acc[dt][3] *= c1;
    }
    // P in bf16 as A fragments: S n-tiles 2kk and 2kk+1 are the two key halves of k-step kk
    uint32_t pf[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p00 = expf(s[nt][0] - mn0), p01 = expf(s[nt][1] - mn0);
      const float p10 = expf(s[nt][2] - mn1), p11 = expf(s[nt][3] - mn1);
      l0 += p00 + p01;
      l1 += p10 + p11;
      pf[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(p00, p01);
      pf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p10, p11);
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        const __nv_bfloat16* vb = vt + (dt * 8 + g) * VP + kk * 16 + t4 * 2;
        mma_bf16(acc[dt], pf[kk], *reinterpret_cast<const uint32_t*>(vb),
                 *reinterpret_cast<const uint32_t*>(vb + 8));
      }
    }
    m0 = mn0;
    m1 = mn1;
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  if (lse != nullptr && t4 == 0) {  // the 4 lanes of a row hold the same m and l
    float* lh = lse + (size_t)blockIdx.y * n;
    if (r0 < n) lh[r0] = m0 + logf(l0);
    if (r0 + 8 < n) lh[r0 + 8] = m1 + logf(l1);
  }
  __nv_bfloat16* oh = o + head;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int d = dt * 8 + t4 * 2;
    if (r0 < n)
      *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)r0 * D + d) =
          __floats2bfloat162_rn(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (r0 + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)(r0 + 8) * D + d) =
          __floats2bfloat162_rn(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

template <int D>
int launch_fa_mma(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int n,
                  float scale, cudaStream_t stream) {
  const dim3 grid((n + MMA_BQ - 1) / MMA_BQ, bh);
  flash_attn_fwd_mma_kernel<D><<<grid, MMA_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, n, scale);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_fa(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int n,
              float scale, cudaStream_t stream) {
  using S = FaShape<D>;
  auto kernel = flash_attn_fwd_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + S::BQ - 1) / S::BQ, bh);
  kernel<<<grid, S::THREADS, S::SMEM, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                static_cast<const T*>(v), static_cast<T*>(o), lse, n, scale);
  return (int)cudaGetLastError();
}

int dispatch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int n,
                 int d, float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_fa<32, float>(q, k, v, o, lse, bh, n, scale, stream);
    case 64: return launch_fa<64, float>(q, k, v, o, lse, bh, n, scale, stream);
    case 128: return launch_fa<128, float>(q, k, v, o, lse, bh, n, scale, stream);
    case 512: return launch_fa<512, float>(q, k, v, o, lse, bh, n, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16: the tensor cores up to D = 128, the float32-FMA kernel at D = 512
int dispatch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int n,
                  int d, float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_fa_mma<32>(q, k, v, o, lse, bh, n, scale, stream);
    case 64: return launch_fa_mma<64>(q, k, v, o, lse, bh, n, scale, stream);
    case 128: return launch_fa_mma<128>(q, k, v, o, lse, bh, n, scale, stream);
    case 512: return launch_fa<512, __nv_bfloat16>(q, k, v, o, lse, bh, n, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace gvd

// dtype: 0 float32, 1 bfloat16; lse: (bh, n) float32 or null. Returns
// cudaGetLastError() of the launch.
GVD_API int gvd_flash_attn_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                               int n, int d, int dtype, float scale, cudaStream_t stream) {
  if (bh <= 0 || n <= 0) return 0;
  if (bh > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return gvd::dispatch_f32(q, k, v, o, lse, bh, n, d, scale, stream);
  if (dtype == 1) return gvd::dispatch_bf16(q, k, v, o, lse, bh, n, d, scale, stream);
  return (int)cudaErrorInvalidValue;
}
