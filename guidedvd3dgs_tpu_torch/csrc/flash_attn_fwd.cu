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
// type for all four; bf16 ones start 16-byte aligned (TMA). Logits, softmax statistics and the output accumulator
// are float32; the scale multiplies the float32 logit; the output is
// written in the input type. Under autograd the caller also passes `lse`
// (B*H, n) float32, and each query row writes m + log(l) of its online
// softmax there (the backward's P = exp(S - lse), flash_attn_bwd.cu); a
// null `lse` writes nothing.
//
// What bounds it on this card: operations. One n x n product is 2 * B*H *
// n^2 * D FLOP and the forward does two. At the UNet's level-0 shape
// (B*H = 25*5, n = 2240, D = 64, bf16) that is 1.61e11 FLOP, 0.162 ms at
// the tensor cores' 989 TFLOP/s, against 143 MB of q, k, v and o (0.043 ms
// at 3.35 TB/s); at the VAE decode chunk's (B*H = 5, D = 512) 5.1e10 FLOP,
// 0.052 ms. Two kernels:
//
//  * bf16 at every D (below, flash_attn_fwd_wg_kernel): one warpgroup (128
//    threads) owns 64 query rows, TMA brings them once into shared memory,
//    and K and V stream through a two-stage ring that TMA fills
//    (cp.async.bulk.tensor, completion on an mbarrier per stage): the next
//    tile's copy runs under this tile's products, and a key past n arrives
//    as a zero row from TMA's out-of-bounds fill (the kernel still scores it
//    -inf: a zero key scores 0). Every tile lands in the swizzled slabs
//    `wgmma` reads in either major (flash_attn.cuh): S = Q K^T is a `wgmma`
//    from shared memory with both operands K-major; the online softmax runs
//    on S's m64nN accumulator in registers (base 2, the 4 lanes of a row
//    meet by shuffles), rounds P to bf16 in place as the register A operand
//    of O += P V, and V is read MN-major from the same staged tile, so
//    nothing is staged twice and P never leaves the registers. Several
//    blocks share an SM (five at D = 64: 100 registers a thread, 41 KB of
//    shared memory), so one block's exp runs beside another's products. At the VAE's D = 512 a 64-row accumulator of 512
//    dims (128 KB) is half the register file, so two warpgroups each own
//    256 of the dims: each contracts its half of Q K^T, the two add each
//    other's half through shared memory (the same sums in both, so both
//    hold the same S, softmax and P), and each accumulates its 256 dims of
//    O; 32-key tiles keep the ring at 128 KB beside Q's 64 KB.
//  * float32 at every D: every product a float32 FMA (__fmaf_rn, written
//    out, since the library is built with -fmad=false), whose ceiling is
//    the 67 TFLOP/s float32 rate. It is the exact yardstick of the bf16
//    kernels' arithmetic (chip_smoke.py phases 7c and 8c).
//
// P is rounded to bf16 before the product with V, as the plain version
// rounds its weights. No atomics: each output row has one owner that walks
// the keys in a fixed order, so two launches are bitwise equal.
//
// Measured (chip_smoke.py phase 7a, median of 10 launches, host clock;
// NVIDIA H100 80GB HBM3, 700.00 W): at (25, 5, 2240, 64) bf16 0.494-0.543
// ms, 1.05-1.17x torch's scaled_dot_product_attention and 30-33% of the
// bound (the mma.sync kernel with plain staging took 1.563-1.598); at
// (50, 5, 2240, 64) 0.922-0.927, 1.08-1.09x; at (25, 1, 2240, 512) 1.097-
// 1.100 ms, 0.47x sdpa's (the FMA kernel took 32.27-32.35) and at the
// decode chunk (5, 1, 2240, 512) 0.310-0.326, 0.75-0.78x. Issuing the next
// tile's S before this tile's P V, so that the softmax runs under the
// product, measured 23-40% slower at D <= 128 (140 registers at D = 64,
// and ptxas serialises the two wgmma groups); three ring stages measured
// no faster than two.
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

using fa::LOG2E;
using fa::pack_bf16;
using fa::Slabs;
using fa::store_out;
using fa::tma_rows;
using fa::to_f32;
using fa::wg_acc_rows;
using fa::wg_rows_dot;
using fa::wg_store;
constexpr int FA_DT = fa::DT;  // head dims per thread
constexpr int FA_NC = fa::NC;  // float4 chunks per thread
constexpr float LN2 = 0.6931471805599453f;

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

// ---- bf16 at every D: TMA ring and wgmma ----

template <int D>
struct FwdWg : Slabs<D> {
  static constexpr int WGS = D == 512 ? 2 : 1;     // warpgroups; at D = 512 each owns half the dims
  static constexpr int THREADS = 128 * WGS;
  static constexpr int NS = Slabs<D>::NS / WGS;    // slabs of one warpgroup's products
  static constexpr int BM = 64;                    // query rows of a block
  static constexpr int BN = D == 512 ? 32 : 64;    // keys of a streamed tile
  static constexpr int STAGES = 2;
  static constexpr int OWN = BM * D * 2;           // bytes of the Q tile
  static constexpr int TILE = BN * D * 2;          // bytes of a K or V tile
  static constexpr int XS = WGS == 2 ? WGS * 128 * (BN / 2) * 4 : 0;  // bytes of the S partials
  // Q | K, V per stage | S partials | barriers (+1024 to align)
  static constexpr int SMEM = 1024 + OWN + STAGES * 2 * TILE + XS + 8 * (1 + STAGES);
  static constexpr int MIN_BLOCKS = D == 512 ? 1 : (D == 128 ? 2 : 3);
};

// The tensor maps of one launch: rows of q (a box of one slab by BM rows),
// k and v (BN rows) as (B*H, n, D)
struct FwdMaps {
  CUtensorMap q, k, v;
};

// One block of WGS warpgroups owns 64 queries (Q resident) and walks the
// keys: S = Q K^T, the online softmax in registers, P as the A operand of
// O += P V. At D = 512 warpgroup w contracts and accumulates dims
// [256 w, 256 w + 256): each adds the other's half of S from shared memory,
// so both hold the same S, softmax and P.
template <int D>
__global__ void __launch_bounds__(FwdWg<D>::THREADS, FwdWg<D>::MIN_BLOCKS)
flash_attn_fwd_wg_kernel(const __grid_constant__ FwdMaps maps, bf16* __restrict__ o, float* __restrict__ lse,
                         int n, float scale) {
  using S = FwdWg<D>;
  constexpr int BN = S::BN, NT = BN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* ks = qs + S::OWN;                // [STAGES] tiles
  unsigned char* vs = ks + S::STAGES * S::TILE;   // [STAGES] tiles
  float4* xs = reinterpret_cast<float4*>(vs + S::STAGES * S::TILE);                 // [WGS][BN / 8][128]
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + S::STAGES * S::TILE + S::XS);  // Q, then per stage

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int warp = t / 32, g = (t % 32) >> 2, t4 = t & 3;
  const int head = blockIdx.y, q0 = blockIdx.x * S::BM;
  const int ntiles = (n + BN - 1) / BN;
  const float sl2 = scale * LOG2E;
  const int slab0 = wg * S::NS;  // this warpgroup's first slab of dims

  auto load_tile = [&](int st, int k0) {
    mbar_expect_tx(&bars[1 + st], 2 * S::TILE);
    tma_rows<D, BN>(ks + st * S::TILE, maps.k, &bars[1 + st], k0, head);
    tma_rows<D, BN>(vs + st * S::TILE, maps.v, &bars[1 + st], k0, head);
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + S::STAGES; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], S::OWN);
    tma_rows<D, S::BM>(qs, maps.q, &bars[0], q0, head);
    for (int st = 0; st < S::STAGES && st < ntiles; ++st) load_tile(st, st * BN);
  }

  float acc[S::NS][S::CW / 2];
#pragma unroll
  for (int s2 = 0; s2 < S::NS; ++s2) {
#pragma unroll
    for (int i = 0; i < S::CW / 2; ++i) acc[s2][i] = 0.0f;
  }
  // the online softmax of this thread's rows g and g + 8 (of its warp's
  // 16), in base 2: running max of the scaled logits times log2(e), sum
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  const unsigned char* qw = qs + slab0 * S::BM * S::SW;
  mbar_wait(&bars[0], 0);

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % S::STAGES, k0 = j * BN;
    mbar_wait(&bars[1 + st], (j / S::STAGES) & 1);
    const unsigned char* kt = ks + st * S::TILE + slab0 * BN * S::SW;
    const unsigned char* vt = vs + st * S::TILE + slab0 * BN * S::SW;

    float s[BN / 2];
    wg_fence();
    wg_rows_dot<S>(s, qw, kt);
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    if constexpr (S::WGS == 2) {
      // add the other warpgroup's half of the dims (a + b == b + a: both
      // warpgroups hold the same sums)
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
        xs[(wg * (BN / 8) + i) * 128 + t] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const float4 x = xs[((1 - wg) * (BN / 8) + i) * 128 + t];
        s[4 * i] += x.x;
        s[4 * i + 1] += x.y;
        s[4 * i + 2] += x.z;
        s[4 * i + 3] += x.w;
      }
    }
    // scaled base-2 logits; keys past n score -inf (zero rows from TMA
    // would score 0); row maxima over the 4 lanes of a row
    const bool tail = k0 + BN > n;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = !tail || k0 + nt * 8 + t4 * 2 + e < n;
        s[nt * 4 + e] = ok ? s[nt * 4 + e] * sl2 : -INFINITY;
        s[nt * 4 + 2 + e] = ok ? s[nt * 4 + 2 + e] * sl2 : -INFINITY;
        mx0 = fmaxf(mx0, s[nt * 4 + e]);
        mx1 = fmaxf(mx1, s[nt * 4 + 2 + e]);
      }
    }
#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
    }
    // every tile holds key k0 < n, so the new maxima are finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int s2 = 0; s2 < S::NS; ++s2) {
#pragma unroll
      for (int i = 0; i < S::CW / 8; ++i) {
        acc[s2][i * 4 + 0] *= c0;
        acc[s2][i * 4 + 1] *= c0;
        acc[s2][i * 4 + 2] *= c1;
        acc[s2][i * 4 + 3] *= c1;
      }
    }
    // P in bf16 as A fragments: key n-tiles 2kk and 2kk+1 are the two
    // halves of k-step kk
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p00 = exp2f(s[nt * 4 + 0] - mn0), p01 = exp2f(s[nt * 4 + 1] - mn0);  // row g
      const float p10 = exp2f(s[nt * 4 + 2] - mn1), p11 = exp2f(s[nt * 4 + 3] - mn1);  // row g + 8
      l0 += p00 + p01;
      l1 += p10 + p11;
      pa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(p00, p01);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p10, p11);
    }
    m0 = mn0;
    m1 = mn1;
    wg_fence();
    wg_acc_rows<S>(acc, pa, vt);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int s2 = 0; s2 < S::NS; ++s2) fence_regs(acc[s2]);
    __syncthreads();  // every warp is done with stage st and the S partials
    if (tid == 0 && j + S::STAGES < ntiles) load_tile(st, k0 + S::STAGES * BN);
  }

#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const int r0 = q0 + warp * 16 + g;
  if (lse != nullptr && wg == 0 && t4 == 0) {  // the 4 lanes of a row hold the same m and l
    float* lh = lse + (size_t)head * n;
    if (r0 < n) lh[r0] = m0 * LN2 + logf(l0);
    if (r0 + 8 < n) lh[r0 + 8] = m1 * LN2 + logf(l1);
  }
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
#pragma unroll
  for (int s2 = 0; s2 < S::NS; ++s2) {
#pragma unroll
    for (int i = 0; i < S::CW / 8; ++i) {
      acc[s2][i * 4 + 0] *= inv0;
      acc[s2][i * 4 + 1] *= inv0;
      acc[s2][i * 4 + 2] *= inv1;
      acc[s2][i * 4 + 3] *= inv1;
    }
  }
  wg_store<S>(o + (size_t)head * n * D + slab0 * S::CW, acc, q0, n, 1.0f);
}

template <int D>
int launch_fa_wg(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int n, float scale,
                 cudaStream_t stream) {
  using S = FwdWg<D>;
  FwdMaps m = {};
  if (encoder() == nullptr || !rows_map(&m.q, q, bh, n, D, S::BM) || !rows_map(&m.k, k, bh, n, D, S::BN) ||
      !rows_map(&m.v, v, bh, n, D, S::BN))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_attn_fwd_wg_kernel<D>;
  cudaError_t err = set_smem(kernel, S::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + S::BM - 1) / S::BM, bh);
  kernel<<<grid, S::THREADS, S::SMEM, stream>>>(m, static_cast<bf16*>(o), lse, n, scale);
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

// bf16 at every D on the tensor cores (16-byte aligned q, k, v, o; B*H*n
// below 2^31)
int dispatch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int n,
                  int d, float scale, cudaStream_t stream) {
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o))) return (int)cudaErrorMisalignedAddress;
  if ((long long)bh * n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch_fa_wg<32>(q, k, v, o, lse, bh, n, scale, stream);
    case 64: return launch_fa_wg<64>(q, k, v, o, lse, bh, n, scale, stream);
    case 128: return launch_fa_wg<128>(q, k, v, o, lse, bh, n, scale, stream);
    case 512: return launch_fa_wg<512>(q, k, v, o, lse, bh, n, scale, stream);
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
