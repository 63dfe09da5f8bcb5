// Kernel L2: softmax attention over 64-dim heads in bf16 for the calls
// kernel L1 does not take: the diffusion UNets' temporal self-attention
// (25 frames), their cross-attention (1-77 keys) and their spatial
// self-attention under 1,024 tokens; forward and backward.
//
// Replaces no Pallas kernel of its own: the JAX package sends these calls
// to its einsum form (guidedvd3dgs_tpu/diffusion/nnops.py::attention, and
// `_grouped_small_attention`'s block-diagonal grouping of sequences of up
// to 32). In eager PyTorch that form upcasts q and k, writes an f32 score
// tensor, scales it, takes an f32 softmax, casts it to bf16 and multiplies
// by v, and autograd's backward of it runs each step again: the scores
// cross device memory four or five times a call.
//
// What bounds it on the H100: memory. At D = 64 and 1-640 keys a call
// does 2-160 operations a byte of q, k, v and o, below the card's ridge
// (~295), so the least time is q, k, v read once and o written once (and
// backward q, k, v, o, dO read and dq, dk, dv written). This design keeps
// scores, probabilities and their gradients in registers:
//   - a block is 4 warps; a warp owns 16 query rows (or, in the dK/dV
//     pass, 16 keys). A problem (one head of one batch entry) takes a slot
//     of `wp` warps: wp = 2 for up to 32 query rows (two problems a block:
//     the 25-frame temporal attention fills 25 of 32 rows), else 4 (the
//     slot's 64 rows a block, the blocks of a problem side by side in x);
//   - q, k, v, o and dO are read through their strides (batch, head, row;
//     dims unit-stride), so the transposed views of `split_heads` are read
//     in place, and the output is written where the caller's layout puts
//     it (rows of heads side by side: `merge_heads` reshapes it free);
//   - rows are staged by cp.async (16 bytes a thread, zero past the end)
//     into padded shared tiles (72 bf16 a row: an ldmatrix's 8 rows hit
//     distinct banks) and multiplied by mma.sync m16n8k16 with f32 sums
//     (wgmma's 64-row tile would sit mostly empty at 25 rows);
//   - forward: keys in tiles of KT (32, 64 or 128, the smallest that holds
//     them, so up to 128 keys take one pass) with the online softmax
//     rescaling of flash attention beyond; S = q k^T * scale and the
//     softmax in f32; in one pass P = exp(S - max) / l is rounded to bf16
//     before P V, as the plain version's `attn.to(v.dtype)`, and o = P V;
//     streamed, the unnormalised P is rounded and o = (P V) / l, as in
//     kernel L1; o in bf16, and the row log-sum-exp (f32) kept for the
//     backward;
//   - backward, one launch: blocks [0, kv_chunks) of a problem group own
//     16 keys a warp and walk the queries in tiles of 32 for dK and dV;
//     the rest own 16 queries a warp and walk the keys for dQ. P is
//     recomputed from the log-sum-exp, Delta = sum(dO o) per row from the
//     staged rows, dS = P (dO v^T - Delta) in f32 and rounded to bf16 for
//     its two products, as kernel L1 does. dK/dV blocks run only where
//     autograd asks for those gradients.
// No atomics: every sum is taken in one fixed order, so two runs give the
// same bits.

#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"
#include "flash_attn.cuh"
#include "hopper.cuh"

namespace gvd {
namespace sa {

using fa::mma_bf16;
using fa::pack_bf16;

constexpr int D = 64;
constexpr int LD = D + 8;  // padded row of a shared tile, in bf16
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int QT = 32;  // query rows a dK/dV block stages at a time

// An operand's rows: element (bh, r, d) at p + (bh / heads) * sb + (bh % heads) * sh + r * sn + d
struct Rows {
  bf16* p;
  long long sb, sh, sn;
  __device__ __forceinline__ bf16* at(int bh, int heads, int r) const {
    return p + (long long)(bh / heads) * sb + (long long)(bh % heads) * sh + (long long)r * sn;
  }
};

struct Params {
  Rows q, k, v, o, dout, dq, dk, dv;  // o: the output (forward) or the saved output (backward)
  float* lse;                         // (bh, lq): written by the forward where not null, read by the backward
  int bh, heads, lq, lk;
  int wp;                             // warps a problem
  int chunks;                         // blocks a problem group
  int kv_chunks;                      // backward: the first kv_chunks of them are dK/dV blocks
  float scale;
};

// keys a staged tile holds: the KT of the launch, or fewer where all keys fit
__device__ __forceinline__ int tile_rows(int lk, int kt) {
  const int r = (lk + 15) & ~15;
  return r < kt ? r : kt;
}

// cp.async rows [r0, r0 + rows) of operand t, problem bh, into a padded
// tile (zero past `len` and for a problem past the end), by the threads
// i0, i0 + step, ... of the calling group
__device__ __forceinline__ void stage_rows(bf16* dst, const Rows& t, int bh, int heads, bool live, int r0, int rows,
                                           int len, int i0, int step) {
  for (int i = i0; i < rows * (D / 8); i += step) {
    const int r = i >> 3, c = (i & 7) * 8;
    const bool ok = live && r0 + r < len;
    cp_async16(dst + r * LD + c, ok ? t.at(bh, heads, r0 + r) + c : t.p, ok);
  }
}

// the 4 A fragments (k-steps over the 64 dims) of the 16 rows at `tile`
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* tile, int lane) {
  const bf16* p = tile + (lane & 15) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[kk], p + kk * 16);
}

// c[j] += A X^T for the n-tiles j of 8 rows of X below `rows` (a multiple
// of 16): A the caller's 16 rows (fragments `a`), X a padded tile
template <int NT>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], const uint32_t (&a)[4][4], const bf16* x, int rows,
                                        int lane) {
#pragma unroll
  for (int jp = 0; jp < NT / 2; ++jp) {
    if (16 * jp < rows) {
      const bf16* p = x + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b[4];  // n-tile 2 jp (b[0], b[1]) and 2 jp + 1 (b[2], b[3])
        ldsm_x4(b, p + kk * 16);
        mma_bf16(c[2 * jp], a[kk], b[0], b[1]);
        mma_bf16(c[2 * jp + 1], a[kk], b[2], b[3]);
      }
    }
  }
}

// acc[d-tile] += bf16(P) X over the rows of X below `rows`: P the caller's
// (16 x 8 NT) accumulator fragments, rounded to bf16 as A fragments; X a
// padded tile (rows = the contraction), read transposed
template <int NT>
__device__ __forceinline__ void mma_px(float (&acc)[8][4], const float (&pf)[NT][4], const bf16* x, int rows,
                                       int lane) {
#pragma unroll
  for (int s = 0; s < NT / 2; ++s) {
    if (16 * s < rows) {
      const uint32_t a[4] = {pack_bf16(pf[2 * s][0], pf[2 * s][1]), pack_bf16(pf[2 * s][2], pf[2 * s][3]),
                             pack_bf16(pf[2 * s + 1][0], pf[2 * s + 1][1]),
                             pack_bf16(pf[2 * s + 1][2], pf[2 * s + 1][3])};
      const bf16* p = x + (16 * s + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b[4];  // d-tile 2 dp (b[0], b[1]) and 2 dp + 1 (b[2], b[3])
        ldsm_x4_t(b, p + dp * 16);
        mma_bf16(acc[2 * dp], a, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }
}

// sum over the 4 threads of a row quad, in one fixed order
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// sum over the 64 dims of a * b of one staged row, in dim order
__device__ __forceinline__ float row_dot(const bf16* a, const bf16* b) {
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < D; c += 8) {
    const uint4 ua = *reinterpret_cast<const uint4*>(a + c), ub = *reinterpret_cast<const uint4*>(b + c);
    const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&ua);
    const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&ub);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fa2 = __bfloat1622float2(ha[e]), fb2 = __bfloat1622float2(hb[e]);
      s += fa2.x * fb2.x;
      s += fa2.y * fb2.y;
    }
  }
  return s;
}

// write the warp's 16 x 64 accumulator times `mul` to rows r0 + (0..15) of operand t, rows below `len`
__device__ __forceinline__ void store_rows(const Rows& t, int bh, int heads, bool live, int r0, int len,
                                           const float (&acc)[8][4], float mul0, float mul1, int lane) {
  const int g = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (!live || r >= len) continue;
    bf16* row = t.at(bh, heads, r);
    const float mul = h ? mul1 : mul0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * i + c) =
          __floats2bfloat162_rn(acc[i][2 * h] * mul, acc[i][2 * h + 1] * mul);
  }
}

// The block's place: its problem slot, the warp's index in the slot, the problem, and the chunk of it
struct Place {
  int warp, lane, slot, wi, bh, chunk, stid, sstep;
  bool live;
  __device__ __forceinline__ explicit Place(const Params& p) {
    warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    slot = warp / p.wp, wi = warp % p.wp;
    const int slots = WARPS / p.wp, group = blockIdx.x / p.chunks;
    chunk = blockIdx.x % p.chunks;
    bh = group * slots + slot;
    live = bh < p.bh;
    stid = threadIdx.x - slot * p.wp * 32, sstep = p.wp * 32;  // the slot's threads
  }
};

// ---- forward ----
// shared: the warps' query rows [WARPS][16][LD], then each slot's K and V tiles [slots][2][kt][LD]
template <int KT>
__global__ void __launch_bounds__(THREADS) short_attn_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Place w(p);
  const int lane = w.lane, t4 = lane & 3;
  const int kt = tile_rows(p.lk, KT);
  const bool one = p.lk <= KT;  // one tile: the softmax in one pass
  bf16* qw = reinterpret_cast<bf16*>(smem_raw) + w.warp * 16 * LD;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw) + WARPS * 16 * LD + w.slot * 2 * kt * LD;
  bf16* vs = ks + kt * LD;
  const int q0 = (w.chunk * p.wp + w.wi) * 16;
  stage_rows(qw, p.q, w.bh, p.heads, w.live, q0, 16, p.lq, lane, 32);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  uint32_t qa[4][4];
  for (int k0 = 0; k0 < p.lk; k0 += KT) {
    if (k0 > 0) __syncthreads();  // every warp is done with the last tile
    stage_rows(ks, p.k, w.bh, p.heads, w.live, k0, kt, p.lk, w.stid, w.sstep);
    stage_rows(vs, p.v, w.bh, p.heads, w.live, k0, kt, p.lk, w.stid, w.sstep);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (k0 == 0) load_a(qa, qw, lane);

    float s[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    mma_abt(s, qa, ks, kt, lane);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      if (8 * j >= kt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = k0 + 8 * j + 2 * t4 + (e & 1) < p.lk ? s[j][e] * p.scale : -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);  // finite: the first tile holds key 0
      alpha[h] = expf(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      if (8 * j >= kt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = expf(s[j][e] - m[e >> 1]);
        s[j][e] = x;
        rs[e >> 1] += x;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(rs[h]);
    if (one) {  // all keys in this tile: normalise before the rounding, as the plain version does
      const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= inv[e >> 1];
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[i][0] *= alpha[0], acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1], acc[i][3] *= alpha[1];
    }
    mma_px(acc, s, vs, kt, lane);
  }
  store_rows(p.o, w.bh, p.heads, w.live, q0, p.lq, acc, one ? 1.0f : 1.0f / l[0], one ? 1.0f : 1.0f / l[1], lane);
  if (p.lse != nullptr && w.live && t4 == 0) {
    const int g = lane >> 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + g + 8 * h;
      if (r < p.lq) p.lse[(size_t)w.bh * p.lq + r] = m[h] + logf(l[h]);
    }
  }
}

// ---- backward: dK and dV ----
// shared, per slot: K and V of its keys [2][16 wp][LD], the query tile's
// Q, dO and O rows [3][QT][LD], its log-sum-exp and Delta [2][QT]
__device__ __forceinline__ int dkdv_slot_bytes(int wp) { return (2 * 16 * wp + 3 * QT) * LD * 2 + 2 * QT * 4; }

__device__ __forceinline__ void dkdv_pass(const Params& p, const Place& w, unsigned char* smem) {
  const int lane = w.lane, t4 = lane & 3;
  bf16* ks = reinterpret_cast<bf16*>(smem + w.slot * dkdv_slot_bytes(p.wp));
  bf16* vs = ks + 16 * p.wp * LD;
  bf16* qs = vs + 16 * p.wp * LD;
  bf16* dos = qs + QT * LD;
  bf16* os = dos + QT * LD;
  float* lse_s = reinterpret_cast<float*>(os + QT * LD);
  float* dl_s = lse_s + QT;
  const int kb = (w.chunk * p.wp + w.wi) * 16;  // the warp's first key
  bf16* kw = ks + w.wi * 16 * LD;
  bf16* vw = vs + w.wi * 16 * LD;
  stage_rows(kw, p.k, w.bh, p.heads, w.live, kb, 16, p.lk, lane, 32);
  stage_rows(vw, p.v, w.bh, p.heads, w.live, kb, 16, p.lk, lane, 32);
  const float* lse_h = p.lse + (size_t)(w.live ? w.bh : 0) * p.lq;

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.0f;
  }
  uint32_t ka[4][4], va[4][4];
  for (int q0 = 0; q0 < p.lq; q0 += QT) {
    if (q0 > 0) __syncthreads();
    stage_rows(qs, p.q, w.bh, p.heads, w.live, q0, QT, p.lq, w.stid, w.sstep);
    stage_rows(dos, p.dout, w.bh, p.heads, w.live, q0, QT, p.lq, w.stid, w.sstep);
    stage_rows(os, p.o, w.bh, p.heads, w.live, q0, QT, p.lq, w.stid, w.sstep);
    for (int i = w.stid; i < QT; i += w.sstep) {
      const bool ok = w.live && q0 + i < p.lq;
      cp_async4(lse_s + i, ok ? lse_h + q0 + i : p.lse, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (q0 == 0) {
      load_a(ka, kw, lane);
      load_a(va, vw, lane);
    }
    for (int i = w.stid; i < QT; i += w.sstep) dl_s[i] = row_dot(dos + i * LD, os + i * LD);
    __syncthreads();

    float st[QT / 8][4], dpt[QT / 8][4];
#pragma unroll
    for (int j = 0; j < QT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
    }
    mma_abt(st, ka, qs, QT, lane);   // S^T: the warp's keys x the tile's queries
    mma_abt(dpt, va, dos, QT, lane);  // dP^T
#pragma unroll
    for (int j = 0; j < QT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t4 + (e & 1);
        const float pt = q0 + qi < p.lq ? expf(st[j][e] * p.scale - lse_s[qi]) : 0.0f;
        st[j][e] = pt;
        dpt[j][e] = pt * (dpt[j][e] - dl_s[qi]);
      }
    }
    mma_px(dv, st, dos, QT, lane);  // dV += P^T dO
    mma_px(dk, dpt, qs, QT, lane);  // dK += dS^T Q
  }
  store_rows(p.dk, w.bh, p.heads, w.live, kb, p.lk, dk, p.scale, p.scale, lane);
  store_rows(p.dv, w.bh, p.heads, w.live, kb, p.lk, dv, 1.0f, 1.0f, lane);
}

// ---- backward: dQ ----
// shared: the warps' Q, dO and O rows [WARPS][3][16][LD] and their
// log-sum-exp and Delta [WARPS][2][16], then each slot's K and V tiles
// [slots][2][kt][LD]
template <int KT>
__device__ __forceinline__ void dq_pass(const Params& p, const Place& w, unsigned char* smem) {
  const int lane = w.lane, t4 = lane & 3, g = lane >> 2;
  const int kt = tile_rows(p.lk, KT);
  bf16* qw = reinterpret_cast<bf16*>(smem) + w.warp * 3 * 16 * LD;
  bf16* dow = qw + 16 * LD;
  bf16* ow = dow + 16 * LD;
  float* lse_w = reinterpret_cast<float*>(smem + WARPS * 3 * 16 * LD * 2) + w.warp * 32;
  float* dl_w = lse_w + 16;
  bf16* ks = reinterpret_cast<bf16*>(smem + WARPS * (3 * 16 * LD * 2 + 32 * 4)) + w.slot * 2 * kt * LD;
  bf16* vs = ks + kt * LD;
  const int q0 = ((w.chunk - p.kv_chunks) * p.wp + w.wi) * 16;  // the warp's first query
  stage_rows(qw, p.q, w.bh, p.heads, w.live, q0, 16, p.lq, lane, 32);
  stage_rows(dow, p.dout, w.bh, p.heads, w.live, q0, 16, p.lq, lane, 32);
  stage_rows(ow, p.o, w.bh, p.heads, w.live, q0, 16, p.lq, lane, 32);
  if (lane < 16) {
    const bool ok = w.live && q0 + lane < p.lq;
    cp_async4(lse_w + lane, ok ? p.lse + (size_t)w.bh * p.lq + q0 + lane : p.lse, ok);
  }

  float dq[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.0f;
  uint32_t qa[4][4], doa[4][4];
  float lse_r[2], dl_r[2];
  for (int k0 = 0; k0 < p.lk; k0 += KT) {
    if (k0 > 0) __syncthreads();
    stage_rows(ks, p.k, w.bh, p.heads, w.live, k0, kt, p.lk, w.stid, w.sstep);
    stage_rows(vs, p.v, w.bh, p.heads, w.live, k0, kt, p.lk, w.stid, w.sstep);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (k0 == 0) {
      load_a(qa, qw, lane);
      load_a(doa, dow, lane);
      if (lane < 16) dl_w[lane] = row_dot(dow + lane * LD, ow + lane * LD);
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h) lse_r[h] = lse_w[g + 8 * h], dl_r[h] = dl_w[g + 8 * h];
    }

    float s[KT / 8][4], dp[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    }
    mma_abt(s, qa, ks, kt, lane);
    mma_abt(dp, doa, vs, kt, lane);
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      if (8 * j >= kt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float pv = k0 + 8 * j + 2 * t4 + (e & 1) < p.lk ? expf(s[j][e] * p.scale - lse_r[h]) : 0.0f;
        dp[j][e] = pv * (dp[j][e] - dl_r[h]);
      }
    }
    mma_px(dq, dp, ks, kt, lane);  // dQ += dS K
  }
  store_rows(p.dq, w.bh, p.heads, w.live, q0, p.lq, dq, p.scale, p.scale, lane);
}

template <int KT>
__global__ void __launch_bounds__(THREADS) short_attn_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Place w(p);
  if (w.chunk < p.kv_chunks)
    dkdv_pass(p, w, smem_raw);
  else
    dq_pass<KT>(p, w, smem_raw);
}

template <class K>
cudaError_t launch(K kernel, const Params& p, int blocks, int smem, cudaStream_t stream) {
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

inline Rows rows_of(const void* t, const long long* s) {
  return Rows{const_cast<bf16*>(static_cast<const bf16*>(t)), s[0], s[1], s[2]};
}

}  // namespace sa
}  // namespace gvd

// strides: (batch, head, row) element strides of q, k, v, out. The host
// (ops/short_attention.py::plan) picks wp, kt, chunks, blocks and smem.
GVD_API int gvd_short_attn_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                               const long long* strides, int bh, int heads, int lq, int lk, int wp, int kt,
                               int chunks, int blocks, int smem, float scale, cudaStream_t stream) {
  using namespace gvd::sa;
  if (bh <= 0 || lq <= 0 || blocks <= 0) return 0;
  if (lk <= 0 || (wp != 2 && wp != 4) || chunks <= 0) return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = rows_of(q, strides), p.k = rows_of(k, strides + 3), p.v = rows_of(v, strides + 6);
  p.o = rows_of(out, strides + 9);
  p.lse = lse, p.bh = bh, p.heads = heads, p.lq = lq, p.lk = lk, p.wp = wp, p.chunks = chunks;
  p.kv_chunks = 0, p.scale = scale;
  if (kt == 32) return (int)launch(short_attn_fwd_kernel<32>, p, blocks, smem, stream);
  if (kt == 64) return (int)launch(short_attn_fwd_kernel<64>, p, blocks, smem, stream);
  if (kt == 128) return (int)launch(short_attn_fwd_kernel<128>, p, blocks, smem, stream);
  return (int)cudaErrorInvalidValue;
}

// strides: those of q, k, v, o, dout, dq, dk, dv; dk and dv null where no
// dK/dV block runs (kv_chunks 0)
GVD_API int gvd_short_attn_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                               void* dq, void* dk, void* dv, const float* lse, const long long* strides, int bh,
                               int heads, int lq, int lk, int wp, int kt, int chunks, int kv_chunks, int blocks,
                               int smem, float scale, cudaStream_t stream) {
  using namespace gvd::sa;
  if (bh <= 0 || lq <= 0 || blocks <= 0) return 0;
  if (lk <= 0 || (wp != 2 && wp != 4) || kv_chunks < 0 || chunks <= kv_chunks ||
      (kv_chunks > 0 && (dk == nullptr || dv == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = rows_of(q, strides), p.k = rows_of(k, strides + 3), p.v = rows_of(v, strides + 6);
  p.o = rows_of(o, strides + 9), p.dout = rows_of(dout, strides + 12), p.dq = rows_of(dq, strides + 15);
  p.dk = rows_of(dk, strides + 18), p.dv = rows_of(dv, strides + 21);
  p.lse = const_cast<float*>(lse), p.bh = bh, p.heads = heads, p.lq = lq, p.lk = lk, p.wp = wp;
  p.chunks = chunks, p.kv_chunks = kv_chunks, p.scale = scale;
  if (kt == 32) return (int)launch(short_attn_bwd_kernel<32>, p, blocks, smem, stream);
  if (kt == 64) return (int)launch(short_attn_bwd_kernel<64>, p, blocks, smem, stream);
  return (int)cudaErrorInvalidValue;
}
