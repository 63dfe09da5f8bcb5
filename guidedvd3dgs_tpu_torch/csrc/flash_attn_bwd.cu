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
// owner in a fixed order, so the result is deterministic and needs no
// atomics. Delta is a row reduction the caller computes (the JAX VJP does
// so outside its kernels too). The ragged tail: keys >= n get P = 0, rows
// >= n are read as zero and never written.
//
// Layout: q, k, v, dO and the outputs are contiguous (B*H, n, D) in one
// type, float32 or bfloat16, 16-byte aligned; lse and Delta are (B*H, n)
// float32. Every accumulator is float32; P is rounded to the input type
// before the product with dO, as the plain version rounds the forward's
// weights, and the bf16 kernels round dS to bf16 for its two products.
//
// What bounds it on this card: operations. One n x n product is 2 * B*H *
// n^2 * D FLOP; dK/dV does four (S, dP, dV, dK), dQ three (S, dP, dQ).
// At the UNet's shape in the guided step (B*H = 25*5, n = 2240, D = 64,
// bf16; one CFG branch, whose VJP runs alone) that is 3.21e11 and 2.41e11
// FLOP, 0.325 and 0.244 ms at 989 TFLOP/s, against 36 MB for each of q, k,
// v, dO (0.05 ms at 3.35 TB/s). At the VAE decode chunk's (B*H = 5, n =
// 2240, D = 512, bf16) 1.03e11 and 7.7e10 FLOP, 0.104 and 0.078 ms. Three
// designs:
//
//  * bf16, D in {32, 64, 128} (the UNet): one warpgroup (128 threads)
//    owns 64 rows (keys for dK/dV, queries for dQ), resident in shared
//    memory, and streams the other side's rows (Q, dO, lse, Delta; or K,
//    V) through a two-stage ring that TMA fills (cp.async.bulk.tensor,
//    completion on an mbarrier per stage): the next tile's copy runs
//    while this tile's products do, and a row past n arrives as zero from
//    TMA's out-of-bounds fill. TMA writes each tile in the 128-byte
//    swizzle (64-byte at D = 32), in slabs of 64 (32) columns, which is
//    the canonical layout `wgmma` reads in either major. The products are
//    `wgmma.mma_async` (Hopper's only path to the full tensor-core rate):
//    S^T = K Q^T and dP^T = V dO^T (dK/dV; S = Q K^T and dP = dO V^T for
//    dQ) from shared memory with both operands K-major; then P^T and dS^T
//    are converted in registers into the bf16 A operand of dV += P^T dO and
//    dK += dS^T Q (dQ += dS K), whose B operand is the same staged tile
//    read MN-major, so nothing is staged twice and no n x n matrix leaves
//    the registers. Several blocks share an SM, so one block's exp runs
//    beside another's products.
//  * bf16, D = 512 (the VAE's single head): 64 keys' dK and dV
//    accumulators would take the whole register file, so a block of 8
//    warps owns 32 rows, resident in shared memory (padded rows, 64 KB),
//    and streams 32-row tiles of the other side through a two-stage
//    cp.async ring (128 KB). The 8 warps compute the tile's 32 x 32 S^T and
//    dP^T once (one m16n8 tile each, contracting all 512 dims with
//    mma.sync m16n8k16 from ldmatrix), pass P^T and dS^T through shared
//    memory as bf16, and each warp then accumulates its own 64 dims of dK
//    and dV (dQ) with B read by ldmatrix.trans from the staged tile. The
//    decode chunk's 5 heads give 70 * 5 = 350 blocks, 2.7 waves of 132
//    SMs. mma.sync rather than wgmma: a 64-row warpgroup tile does not fit
//    beside the 512-dim accumulators.
//  * float32 at every D: every product a float32 FMA (__fmaf_rn: the
//    library is built with -fmad=false), the forward's FMA design: G = D/32
//    threads own a row with 32 dims each in registers, the other side's
//    rows stream through dynamic shared memory, and each pair of rows meets
//    by a butterfly shuffle; its ceiling is the 67 TFLOP/s float32 rate.
//    It is the exact yardstick of the bf16 kernels' arithmetic.
//
// The bf16 kernels take P = exp2(S * scale * log2(e) - lse * log2(e)), the
// same value as exp(S * scale - lse) within a few float32 ulps.
//
// Measured (chip_smoke.py phase 8a, median of 10 launches; NVIDIA H100
// 80GB HBM3, 700.00 W): at (25, 5, 2240, 64) bf16 dK/dV 0.812 ms and dQ
// 0.620 ms, 40% of their bounds and 1.27x the backward of torch's
// scaled_dot_product_attention (the mma.sync design with plain staging
// took 3.147 and 2.292); at (5, 1, 2240, 512) bf16 0.81-0.83 and 0.70-0.72
// ms, 12% of the bounds and 0.2x sdpa's backward (the FMA design took
// 15.6-16.4 and 15.0-15.6). Two wgmma groups per tile (the exp under
// dP's product) measured slower for dK/dV (1.000 ms), so each phase is
// one group.

#include "flash_attn.cuh"

#include <math.h>

namespace gvd {
namespace {

using fa::LOG2E;
using fa::mma_bf16;
using fa::pack_bf16;
using fa::Slabs;
using fa::tma_rows;
using fa::wg_acc_rows;
using fa::wg_rows_dot;
using fa::wg_store;

// ---- bf16, D <= 128: TMA ring and wgmma ----

template <int D>
struct BwdWg : Slabs<D> {
  static constexpr int BM = 64;                 // rows the warpgroup owns
  static constexpr int BN = D <= 64 ? 64 : 32;  // rows of a streamed tile
  static constexpr int STAGES = 2;
  static constexpr int OWN = BM * D * 2;        // bytes of the owned tile
  static constexpr int TILE = BN * D * 2;       // bytes of a streamed tile
  // a streamed lse or Delta tile: BN + 4 floats from the 16-byte aligned
  // start at or below the tile's first row (TMA takes no other start),
  // 128-byte aligned in shared memory
  static constexpr int VLEN = BN + 4;
  static constexpr int VEC = (VLEN * 4 + 127) / 128 * 128;
  // dK/dV: K, V | Q, dO per stage | lse, Delta per stage | barriers (+1024 to align)
  static constexpr int DKV_BARS = 2 * OWN + STAGES * (2 * TILE + 2 * VEC);
  static constexpr int DKV_SMEM = 1024 + DKV_BARS + 8 * (1 + STAGES);
  // dQ: Q, dO | K, V per stage | barriers
  static constexpr int DQ_BARS = 2 * OWN + STAGES * 2 * TILE;
  static constexpr int DQ_SMEM = 1024 + DQ_BARS + 8 * (1 + STAGES);
};

// The tensor maps of one launch: rows of q, k, v, dO as (B*H, n, D) with a
// box of one slab by BM or BN rows; lse and Delta as one flat vector.
struct WgMaps {
  CUtensorMap q, k, v, dout, lse, delta;
};

// dK/dV. The warpgroup owns 64 keys (K, V resident) and walks the queries:
// S^T = K Q^T and dP^T = V dO^T (rows = keys), so that P^T and dS^T are
// the A operands of dV += P^T dO and dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(128, 2)
flash_attn_bwd_dkv_wg_kernel(const __grid_constant__ WgMaps maps, bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int n, float scale) {
  using S = BwdWg<D>;
  constexpr int BN = S::BN, NT = BN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ks = align1024(smem_raw);
  unsigned char* vs = ks + S::OWN;
  unsigned char* qs = vs + S::OWN;                 // [STAGES] tiles
  unsigned char* dos = qs + S::STAGES * S::TILE;   // [STAGES] tiles
  float* lse_s = reinterpret_cast<float*>(dos + S::STAGES * S::TILE);      // [STAGES][VEC / 4]
  float* delta_s = lse_s + S::STAGES * S::VEC / 4;                         // [STAGES][VEC / 4]
  uint64_t* bars = reinterpret_cast<uint64_t*>(delta_s + S::STAGES * S::VEC / 4);  // K/V, then per stage

  const int tid = threadIdx.x, t4 = tid & 3;
  const int head = blockIdx.y, k0 = blockIdx.x * S::BM;
  const int ntiles = (n + BN - 1) / BN;
  const float sl2 = scale * LOG2E;

  auto load_tile = [&](int st, int q0) {
    const int at = (head * n + q0) & ~3;  // lse and Delta of rows q0.. start (head * n + q0) % 4 floats in
    mbar_expect_tx(&bars[1 + st], 2 * S::TILE + 2 * S::VLEN * 4);
    tma_rows<D, BN>(qs + st * S::TILE, maps.q, &bars[1 + st], q0, head);
    tma_rows<D, BN>(dos + st * S::TILE, maps.dout, &bars[1 + st], q0, head);
    tma_load_1d(lse_s + st * S::VEC / 4, &maps.lse, &bars[1 + st], at);
    tma_load_1d(delta_s + st * S::VEC / 4, &maps.delta, &bars[1 + st], at);
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + S::STAGES; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * S::OWN);
    tma_rows<D, S::BM>(ks, maps.k, &bars[0], k0, head);
    tma_rows<D, S::BM>(vs, maps.v, &bars[0], k0, head);
    for (int st = 0; st < S::STAGES && st < ntiles; ++st) load_tile(st, st * BN);
  }

  float dka[S::NS][S::CW / 2], dva[S::NS][S::CW / 2];
#pragma unroll
  for (int s = 0; s < S::NS; ++s) {
#pragma unroll
    for (int i = 0; i < S::CW / 2; ++i) dka[s][i] = dva[s][i] = 0.0f;
  }
  mbar_wait(&bars[0], 0);

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % S::STAGES, q0 = j * BN;
    mbar_wait(&bars[1 + st], (j / S::STAGES) & 1);
    const unsigned char* qt = qs + st * S::TILE;
    const unsigned char* ot = dos + st * S::TILE;

    float s[BN / 2], dp[BN / 2];
    wg_fence();
    wg_rows_dot<S>(s, ks, qt);
    wg_rows_dot<S>(dp, vs, ot);
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T (0 for queries past n) and dS^T as bf16 A fragments: query
    // n-tiles 2kk and 2kk+1 are the two halves of k-step kk
    const int off = (head * n + q0) & 3;
    const float* lt = lse_s + st * S::VEC / 4 + off;
    const float* dt = delta_s + st * S::VEC / 4 + off;
    uint32_t pa[BN / 16][4], dsa[BN / 16][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + t4 * 2;
      const bool ok0 = q0 + col < n, ok1 = q0 + col + 1 < n;
      const float l0 = lt[col] * LOG2E, l1 = lt[col + 1] * LOG2E;
      const float dl0 = dt[col], dl1 = dt[col + 1];
      const float p00 = ok0 ? exp2f(s[nt * 4 + 0] * sl2 - l0) : 0.0f;  // key row g
      const float p01 = ok1 ? exp2f(s[nt * 4 + 1] * sl2 - l1) : 0.0f;
      const float p10 = ok0 ? exp2f(s[nt * 4 + 2] * sl2 - l0) : 0.0f;  // key row g + 8
      const float p11 = ok1 ? exp2f(s[nt * 4 + 3] * sl2 - l1) : 0.0f;
      pa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(p00, p01);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p10, p11);
      dsa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(p00 * (dp[nt * 4 + 0] - dl0), p01 * (dp[nt * 4 + 1] - dl1));
      dsa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p10 * (dp[nt * 4 + 2] - dl0), p11 * (dp[nt * 4 + 3] - dl1));
    }
    // dV += P^T dO and dK += dS^T Q (the scale at the end)
    wg_fence();
    wg_acc_rows<S>(dva, pa, ot);
    wg_acc_rows<S>(dka, dsa, qt);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int s2 = 0; s2 < S::NS; ++s2) {
      fence_regs(dka[s2]);
      fence_regs(dva[s2]);
    }
    __syncthreads();  // every warp is done with stage st
    if (tid == 0 && j + S::STAGES < ntiles) load_tile(st, q0 + S::STAGES * BN);
  }

  const size_t base = (size_t)head * n * D;
  wg_store<S>(dk + base, dka, k0, n, scale);
  wg_store<S>(dv + base, dva, k0, n, 1.0f);
}

// dQ. The warpgroup owns 64 queries (Q, dO resident) and walks the keys:
// S = Q K^T, dP = dO V^T, dS as the A operand of dQ += dS K.
template <int D>
__global__ void __launch_bounds__(128, 2)
flash_attn_bwd_dq_wg_kernel(const __grid_constant__ WgMaps maps, const float* __restrict__ lse,
                            const float* __restrict__ delta, bf16* __restrict__ dq, int n, float scale) {
  using S = BwdWg<D>;
  constexpr int BN = S::BN, NT = BN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* dos = qs + S::OWN;
  unsigned char* ks = dos + S::OWN;               // [STAGES] tiles
  unsigned char* vs = ks + S::STAGES * S::TILE;   // [STAGES] tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + S::STAGES * S::TILE);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int head = blockIdx.y, q0 = blockIdx.x * S::BM;
  const int ntiles = (n + BN - 1) / BN;
  const float sl2 = scale * LOG2E;

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
    mbar_expect_tx(&bars[0], 2 * S::OWN);
    tma_rows<D, S::BM>(qs, maps.q, &bars[0], q0, head);
    tma_rows<D, S::BM>(dos, maps.dout, &bars[0], q0, head);
    for (int st = 0; st < S::STAGES && st < ntiles; ++st) load_tile(st, st * BN);
  }

  // this thread's query rows r0 and r0 + 8
  const int r0 = q0 + warp * 16 + g;
  const float* lse_h = lse + (size_t)head * n;
  const float* delta_h = delta + (size_t)head * n;
  const float l0 = r0 < n ? lse_h[r0] * LOG2E : 0.0f, l1 = r0 + 8 < n ? lse_h[r0 + 8] * LOG2E : 0.0f;
  const float dl0 = r0 < n ? delta_h[r0] : 0.0f, dl1 = r0 + 8 < n ? delta_h[r0 + 8] : 0.0f;

  float dqa[S::NS][S::CW / 2];
#pragma unroll
  for (int s = 0; s < S::NS; ++s) {
#pragma unroll
    for (int i = 0; i < S::CW / 2; ++i) dqa[s][i] = 0.0f;
  }
  mbar_wait(&bars[0], 0);

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % S::STAGES, k0 = j * BN;
    mbar_wait(&bars[1 + st], (j / S::STAGES) & 1);
    const unsigned char* kt = ks + st * S::TILE;
    const unsigned char* vt = vs + st * S::TILE;

    float s[BN / 2], dp[BN / 2];
    wg_fence();
    wg_rows_dot<S>(s, qs, kt);
    wg_rows_dot<S>(dp, dos, vt);
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // dS = P o (dP - Delta), P = 0 for keys past n; key n-tiles 2kk and
    // 2kk+1 are the two halves of k-step kk of the A operand
    uint32_t dsa[BN / 16][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = k0 + nt * 8 + t4 * 2;
      const bool ok0 = col < n, ok1 = col + 1 < n;
      const float p00 = ok0 ? exp2f(s[nt * 4 + 0] * sl2 - l0) : 0.0f;  // row g
      const float p01 = ok1 ? exp2f(s[nt * 4 + 1] * sl2 - l0) : 0.0f;
      const float p10 = ok0 ? exp2f(s[nt * 4 + 2] * sl2 - l1) : 0.0f;  // row g + 8
      const float p11 = ok1 ? exp2f(s[nt * 4 + 3] * sl2 - l1) : 0.0f;
      dsa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(p00 * (dp[nt * 4 + 0] - dl0), p01 * (dp[nt * 4 + 1] - dl0));
      dsa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p10 * (dp[nt * 4 + 2] - dl1), p11 * (dp[nt * 4 + 3] - dl1));
    }
    wg_fence();
    wg_acc_rows<S>(dqa, dsa, kt);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int s2 = 0; s2 < S::NS; ++s2) fence_regs(dqa[s2]);
    __syncthreads();  // every warp is done with stage st
    if (tid == 0 && j + S::STAGES < ntiles) load_tile(st, k0 + S::STAGES * BN);
  }
  wg_store<S>(dq + (size_t)head * n * D, dqa, q0, n, scale);
}

// ---- bf16, D = 512: cp.async ring and mma.sync ----

struct Bwd512 {
  static constexpr int D = 512;
  static constexpr int THREADS = 256;           // 8 warps, 64 head dims of the accumulators each
  static constexpr int BR = 32;                 // rows a block owns
  static constexpr int BT = 32;                 // rows of a streamed tile
  static constexpr int LD = D + 8;              // padded row: the 8 rows of an ldmatrix hit distinct banks
  static constexpr int PLD = BT + 8;            // padded row of the P^T, dS^T (dS) tiles
  static constexpr int TILE = BR * LD * 2;      // bytes of a staged tile of rows
  static constexpr int PT = BR * PLD * 2;       // bytes of a P^T or dS^T tile
  // dK/dV: K, V | Q, dO per stage | lse, Delta per stage | P^T, dS^T
  static constexpr int DKV_SMEM = 2 * TILE + 2 * 2 * TILE + 2 * 2 * BT * 4 + 2 * PT;
  // dQ: Q, dO | K, V per stage | dS
  static constexpr int DQ_SMEM = 2 * TILE + 2 * 2 * TILE + PT;
};

// cp.async rows [r0, r0 + 32) of a (n, 512) head into a padded tile (zero past n)
__device__ __forceinline__ void cp_rows512(bf16* dst, const bf16* __restrict__ src, int r0, int n) {
  using S = Bwd512;
#pragma unroll
  for (int i = threadIdx.x; i < S::BT * S::D / 8; i += S::THREADS) {
    const int r = i / (S::D / 8), c = (i % (S::D / 8)) * 8;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * S::LD + c, src + (ok ? (size_t)(r0 + r) * S::D + c : 0), ok);
  }
}

// cp.async values [r0, r0 + 32) of a length-n row vector (zero past n)
__device__ __forceinline__ void cp_vec32(float* dst, const float* __restrict__ src, int r0, int n) {
  const int i = threadIdx.x;
  if (i < Bwd512::BT) cp_async4(dst + i, src + (r0 + i < n ? r0 + i : 0), r0 + i < n);
}

// c += A B over the 512 dims for one m16n8 tile: A rows a0.. of `a`, B^T
// rows b0.. of `b` (both padded row-major tiles, K-major)
__device__ __forceinline__ void mma_rows512(float* c, const bf16* a, int a0, const bf16* b, int b0) {
  using S = Bwd512;
  const int lane = threadIdx.x % 32;
  const bf16* pa = a + (a0 + (lane & 7) + ((lane >> 3) & 1) * 8) * S::LD + (lane >> 4) * 8;
  const bf16* pb = b + (b0 + (lane & 7)) * S::LD + (lane >> 3) * 8;
#pragma unroll 4
  for (int kk = 0; kk < S::D / 16; kk += 2) {
    uint32_t af0[4], af1[4], bf[4];
    ldsm_x4(af0, pa + kk * 16);
    ldsm_x4(af1, pa + kk * 16 + 16);
    ldsm_x4(bf, pb + kk * 16);  // k-steps kk (bf[0], bf[1]) and kk + 1 (bf[2], bf[3])
    mma_bf16(c, af0, bf[0], bf[1]);
    mma_bf16(c, af1, bf[2], bf[3]);
  }
}

// acc[mt][nt] += X T over the 32 streamed rows, for the warp's 64 dims:
// X (32 x 32 bf16, row-major with row PLD) the P^T / dS^T (dS) tile, T the
// staged tile (32 x 512, read transposed by ldmatrix)
__device__ __forceinline__ void mma_acc512(float (*acc)[8][4], const bf16* x, const bf16* t) {
  using S = Bwd512;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ar = (lane & 7) + ((lane >> 3) & 1) * 8, ac = (lane >> 4) * 8;
#pragma unroll
  for (int kq = 0; kq < S::BT / 16; ++kq) {
    uint32_t xa[2][4];
    ldsm_x4(xa[0], x + ar * S::PLD + kq * 16 + ac);
    ldsm_x4(xa[1], x + (16 + ar) * S::PLD + kq * 16 + ac);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t tb[4];  // n-tiles 2np (tb[0], tb[1]) and 2np + 1 (tb[2], tb[3])
      ldsm_x4_t(tb, t + (kq * 16 + ar) * S::LD + warp * 64 + np * 16 + ac);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(acc[mt][2 * np], xa[mt], tb[0], tb[1]);
        mma_bf16(acc[mt][2 * np + 1], xa[mt], tb[2], tb[3]);
      }
    }
  }
}

__device__ __forceinline__ void store512(bf16* out, const float (*acc)[8][4], int row0, int n, float mul) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = row0 + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int d = warp * 64 + nt * 8 + c;
      if (r < n)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * Bwd512::D + d) =
            __floats2bfloat162_rn(acc[mt][nt][0] * mul, acc[mt][nt][1] * mul);
      if (r + 8 < n)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(r + 8) * Bwd512::D + d) =
            __floats2bfloat162_rn(acc[mt][nt][2] * mul, acc[mt][nt][3] * mul);
    }
  }
}

// dK/dV at D = 512: the block owns 32 keys and walks the queries. Warp w
// computes the (key m-tile w % 2, query n-tile w / 2) tile of S^T and dP^T
// and writes its P^T and dS^T; then accumulates dims [64 w, 64 w + 64) of
// dV += P^T dO and dK += dS^T Q.
__global__ void __launch_bounds__(Bwd512::THREADS, 1)
flash_attn_bwd_dkv_512_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                              const bf16* __restrict__ dout, const float* __restrict__ lse,
                              const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int n,
                              float scale) {
  using S = Bwd512;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + S::BR * S::LD;
  bf16* qs = vs + S::BR * S::LD;        // [2] tiles
  bf16* dos = qs + 2 * S::BT * S::LD;   // [2] tiles
  float* lse_s = reinterpret_cast<float*>(dos + 2 * S::BT * S::LD);  // [2][BT]
  float* delta_s = lse_s + 2 * S::BT;                                // [2][BT]
  bf16* pt = reinterpret_cast<bf16*>(delta_s + 2 * S::BT);           // [BR][PLD]
  bf16* dst = pt + S::BR * S::PLD;                                   // [BR][PLD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp & 1, nt = warp >> 1;
  const int k0 = blockIdx.x * S::BR;
  const size_t head = (size_t)blockIdx.y * (size_t)n * S::D;
  const float* lse_h = lse + (size_t)blockIdx.y * n;
  const float* delta_h = delta + (size_t)blockIdx.y * n;
  const int ntiles = (n + S::BT - 1) / S::BT;
  const float sl2 = scale * LOG2E;

  auto load_tile = [&](int st, int q0) {
    cp_rows512(qs + st * S::BT * S::LD, q + head, q0, n);
    cp_rows512(dos + st * S::BT * S::LD, dout + head, q0, n);
    cp_vec32(lse_s + st * S::BT, lse_h, q0, n);
    cp_vec32(delta_s + st * S::BT, delta_h, q0, n);
  };
  cp_rows512(ks, k + head, k0, n);
  cp_rows512(vs, v + head, k0, n);
  load_tile(0, 0);
  cp_async_commit();
  if (ntiles > 1) load_tile(1, S::BT);
  cp_async_commit();

  float dka[2][8][4], dva[2][8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 8; ++b) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[a][b][e] = dva[a][b][e] = 0.0f;
    }
  }

  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1, q0 = j * S::BT;
    cp_async_wait<1>();  // tile j (and K, V) have landed; tile j + 1 may be in flight
    __syncthreads();
    const bf16* qt = qs + st * S::BT * S::LD;
    const bf16* ot = dos + st * S::BT * S::LD;

    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_rows512(s, ks, mt * 16, qt, nt * 8);
    mma_rows512(dp, vs, mt * 16, ot, nt * 8);
    {
      const int col = nt * 8 + t4 * 2;  // this thread's queries col, col + 1; keys g, g + 8 of m-tile mt
      const float* lt = lse_s + st * S::BT;
      const float* dt = delta_s + st * S::BT;
      const bool ok0 = q0 + col < n, ok1 = q0 + col + 1 < n;
      const float l0 = lt[col] * LOG2E, l1 = lt[col + 1] * LOG2E;
      const float p00 = ok0 ? exp2f(s[0] * sl2 - l0) : 0.0f, p01 = ok1 ? exp2f(s[1] * sl2 - l1) : 0.0f;
      const float p10 = ok0 ? exp2f(s[2] * sl2 - l0) : 0.0f, p11 = ok1 ? exp2f(s[3] * sl2 - l1) : 0.0f;
      const int r = mt * 16 + g;
      *reinterpret_cast<uint32_t*>(pt + r * S::PLD + col) = pack_bf16(p00, p01);
      *reinterpret_cast<uint32_t*>(pt + (r + 8) * S::PLD + col) = pack_bf16(p10, p11);
      *reinterpret_cast<uint32_t*>(dst + r * S::PLD + col) =
          pack_bf16(p00 * (dp[0] - dt[col]), p01 * (dp[1] - dt[col + 1]));
      *reinterpret_cast<uint32_t*>(dst + (r + 8) * S::PLD + col) =
          pack_bf16(p10 * (dp[2] - dt[col]), p11 * (dp[3] - dt[col + 1]));
    }
    __syncthreads();  // P^T and dS^T are complete
    mma_acc512(dva, pt, ot);
    mma_acc512(dka, dst, qt);
    __syncthreads();  // every warp is done with stage st, P^T and dS^T
    if (j + 2 < ntiles) load_tile(st, q0 + 2 * S::BT);
    cp_async_commit();
  }
  store512(dk + head, dka, k0, n, scale);
  store512(dv + head, dva, k0, n, 1.0f);
}

// dQ at D = 512: the block owns 32 queries and walks the keys. Warp w
// computes the (query m-tile w % 2, key n-tile w / 2) tile of S and dP and
// writes its dS; then accumulates dims [64 w, 64 w + 64) of dQ += dS K.
__global__ void __launch_bounds__(Bwd512::THREADS, 1)
flash_attn_bwd_dq_512_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                             const bf16* __restrict__ dout, const float* __restrict__ lse,
                             const float* __restrict__ delta, bf16* __restrict__ dq, int n, float scale) {
  using S = Bwd512;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + S::BR * S::LD;
  bf16* ks = dos + S::BR * S::LD;       // [2] tiles
  bf16* vs = ks + 2 * S::BT * S::LD;    // [2] tiles
  bf16* dss = vs + 2 * S::BT * S::LD;   // [BR][PLD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp & 1, nt = warp >> 1;
  const int q0 = blockIdx.x * S::BR;
  const size_t head = (size_t)blockIdx.y * (size_t)n * S::D;
  const int ntiles = (n + S::BT - 1) / S::BT;
  const float sl2 = scale * LOG2E;

  // this thread's query rows r0 and r0 + 8 of S
  const int r0 = q0 + mt * 16 + g;
  const float* lse_h = lse + (size_t)blockIdx.y * n;
  const float* delta_h = delta + (size_t)blockIdx.y * n;
  const float l0 = r0 < n ? lse_h[r0] * LOG2E : 0.0f, l1 = r0 + 8 < n ? lse_h[r0 + 8] * LOG2E : 0.0f;
  const float dl0 = r0 < n ? delta_h[r0] : 0.0f, dl1 = r0 + 8 < n ? delta_h[r0 + 8] : 0.0f;

  auto load_tile = [&](int st, int k0) {
    cp_rows512(ks + st * S::BT * S::LD, k + head, k0, n);
    cp_rows512(vs + st * S::BT * S::LD, v + head, k0, n);
  };
  cp_rows512(qs, q + head, q0, n);
  cp_rows512(dos, dout + head, q0, n);
  load_tile(0, 0);
  cp_async_commit();
  if (ntiles > 1) load_tile(1, S::BT);
  cp_async_commit();

  float dqa[2][8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 8; ++b) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[a][b][e] = 0.0f;
    }
  }

  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1, k0 = j * S::BT;
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = ks + st * S::BT * S::LD;
    const bf16* vt = vs + st * S::BT * S::LD;

    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_rows512(s, qs, mt * 16, kt, nt * 8);
    mma_rows512(dp, dos, mt * 16, vt, nt * 8);
    {
      const int col = nt * 8 + t4 * 2;  // this thread's keys col, col + 1 of the tile
      const bool ok0 = k0 + col < n, ok1 = k0 + col + 1 < n;
      const float p00 = ok0 ? exp2f(s[0] * sl2 - l0) : 0.0f, p01 = ok1 ? exp2f(s[1] * sl2 - l0) : 0.0f;
      const float p10 = ok0 ? exp2f(s[2] * sl2 - l1) : 0.0f, p11 = ok1 ? exp2f(s[3] * sl2 - l1) : 0.0f;
      const int r = mt * 16 + g;
      *reinterpret_cast<uint32_t*>(dss + r * S::PLD + col) = pack_bf16(p00 * (dp[0] - dl0), p01 * (dp[1] - dl0));
      *reinterpret_cast<uint32_t*>(dss + (r + 8) * S::PLD + col) =
          pack_bf16(p10 * (dp[2] - dl1), p11 * (dp[3] - dl1));
    }
    __syncthreads();  // dS is complete
    mma_acc512(dqa, dss, kt);
    __syncthreads();  // every warp is done with stage st and dS
    if (j + 2 < ntiles) load_tile(st, k0 + 2 * S::BT);
    cp_async_commit();
  }
  store512(dq + head, dqa, q0, n, scale);
}

// ---- float32: FMA ----

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

// a float32 vector of `len` values, boxes of `box_len`; past its end reads zero
bool vec_map(CUtensorMap* m, const float* base, size_t len, int box_len) {  // box_len * 4: a multiple of 16
  const cuuint64_t dims[1] = {(cuuint64_t)len};
  const cuuint64_t strides[1] = {(cuuint64_t)len * 4};  // not read at rank 1
  const cuuint32_t box[1] = {(cuuint32_t)box_len};
  const cuuint32_t unit[1] = {1};
  return encoder()(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int dkv_wg(const BwdArgs& a) {
  using S = BwdWg<D>;
  WgMaps m = {};
  if (encoder() == nullptr || !rows_map(&m.q, a.q, a.bh, a.n, D, S::BN) ||
      !rows_map(&m.dout, a.dout, a.bh, a.n, D, S::BN) || !rows_map(&m.k, a.k, a.bh, a.n, D, S::BM) ||
      !rows_map(&m.v, a.v, a.bh, a.n, D, S::BM) || !vec_map(&m.lse, a.lse, (size_t)a.bh * a.n, S::VLEN) ||
      !vec_map(&m.delta, a.delta, (size_t)a.bh * a.n, S::VLEN))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_attn_bwd_dkv_wg_kernel<D>;
  cudaError_t err = set_smem(kernel, S::DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + S::BM - 1) / S::BM, a.bh);
  kernel<<<grid, 128, S::DKV_SMEM, a.stream>>>(m, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.n,
                                                a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int dq_wg(const BwdArgs& a) {
  using S = BwdWg<D>;
  WgMaps m = {};
  if (encoder() == nullptr || !rows_map(&m.q, a.q, a.bh, a.n, D, S::BM) ||
      !rows_map(&m.dout, a.dout, a.bh, a.n, D, S::BM) || !rows_map(&m.k, a.k, a.bh, a.n, D, S::BN) ||
      !rows_map(&m.v, a.v, a.bh, a.n, D, S::BN))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_attn_bwd_dq_wg_kernel<D>;
  cudaError_t err = set_smem(kernel, S::DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + S::BM - 1) / S::BM, a.bh);
  kernel<<<grid, 128, S::DQ_SMEM, a.stream>>>(m, a.lse, a.delta, static_cast<bf16*>(a.dq), a.n, a.scale);
  return (int)cudaGetLastError();
}

int dkv_512(const BwdArgs& a) {
  using S = Bwd512;
  cudaError_t err = set_smem(flash_attn_bwd_dkv_512_kernel, S::DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + S::BR - 1) / S::BR, a.bh);
  flash_attn_bwd_dkv_512_kernel<<<grid, S::THREADS, S::DKV_SMEM, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.n,
      a.scale);
  return (int)cudaGetLastError();
}

int dq_512(const BwdArgs& a) {
  using S = Bwd512;
  cudaError_t err = set_smem(flash_attn_bwd_dq_512_kernel, S::DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + S::BR - 1) / S::BR, a.bh);
  flash_attn_bwd_dq_512_kernel<<<grid, S::THREADS, S::DQ_SMEM, a.stream>>>(
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

// which: 0 dK/dV, 1 dQ. float32 on FMAs; bf16 at D <= 128 on wgmma with a
// TMA ring, at D = 512 on mma.sync with a cp.async ring (16-byte aligned
// inputs, B*H*n below 2^31).
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
    if (!(aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && aligned16(a.dout) && aligned16(a.lse) &&
          aligned16(a.delta)))
      return (int)cudaErrorMisalignedAddress;
    if ((long long)a.bh * a.n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    switch (d) {
      case 32: return which == 0 ? dkv_wg<32>(a) : dq_wg<32>(a);
      case 64: return which == 0 ? dkv_wg<64>(a) : dq_wg<64>(a);
      case 128: return which == 0 ? dkv_wg<128>(a) : dq_wg<128>(a);
      case 512: return which == 0 ? dkv_512(a) : dq_512(a);
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
