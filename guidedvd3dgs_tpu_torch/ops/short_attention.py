"""Kernel L2: softmax attention over 64-dim heads for the calls kernel L1
does not take, forward and backward, and its plain version.

Counterpart of the einsum form of `guidedvd3dgs_tpu/diffusion/nnops.py::
attention` (and of `_grouped_small_attention`, its block-diagonal grouping
of short sequences on the TPU). `takes_kernel` says what the kernels
take: CUDA bf16 q, k, v of 64 dims, no mask and no bias, at any lengths
(keys stream), outside `_build.plain_versions()`.
`diffusion/nnops.py::attention` gives kernel L1 its case
first and sends here the rest that `takes_kernel` accepts: in the UNets
the temporal self-attention (25 frames), the text and image
cross-attention (77, 16 or 1 keys) and the spatial self-attention under
nnops' FLASH_MIN_SEQ tokens. Cross-attention whose k or v needs a gradient keeps
the plain version (the port never asks for one: k and v are projections
of a constant context), as kernel N1 refuses a weight that needs one.

`attention_plain` is the einsum form: f32 logits times `scale`, the
relative-position bias, the bias and the mask where given, f32 softmax,
the weights cast to v's type, then the products with v and the
relative-position table. It runs for everything the kernel does not take.

The CUDA kernels (csrc/short_attn.cu) read q, k, v (and, backward, o and
dO) through their strides, so `split_heads`'s views are read in place;
the output is laid out as (B, N, H, D) memory viewed as (B, H, N, D), so
`merge_heads` reshapes it without a copy. Forward: one launch, which also
writes the row log-sum-exp under autograd. Backward: one launch of dQ
blocks and, where autograd asks for dK and dV, dK/dV blocks. `plan` picks
the launch shape from (Lq, Lk, B*H) alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from guidedvd3dgs_tpu_torch.ops import _build
from guidedvd3dgs_tpu_torch.utils.tracing import count

HEAD_DIM = 64
WARPS = 4  # csrc/short_attn.cu: 4 warps a block, 16 rows a warp
ROW_BYTES = (HEAD_DIM + 8) * 2  # a padded shared row
QT = 32  # query rows a dK/dV block stages at a time
FWD_TILES = (32, 64, 128)  # key tiles of the forward's instantiations
BWD_TILES = (32, 64)  # and of the dQ pass's


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    bias: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
                    rel: Optional[tuple] = None) -> torch.Tensor:
    """The einsum form (reference nnops.py:317-323); q: (B, H, Nq, D), k, v:
    (B, H, Nk, D); `bias` added to the scaled logits, `mask` (True keeps)
    applied before the f32 softmax; `rel`, the relative-position tables
    (k2, v2) (Nq, Nk, D), adds their bias and their output term (reference
    lvdm/modules/attention.py:100-127)."""
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if rel is not None:
        k2, v2 = rel
        sim = sim + torch.einsum("bhtd,tsd->bhts", q.float(), k2.float()) * scale
    if bias is not None:
        sim = sim + bias
    if mask is not None:
        sim = torch.where(mask, sim, torch.finfo(sim.dtype).min)
    attn = torch.softmax(sim, dim=-1)
    out = torch.matmul(attn.to(v.dtype), v)
    if rel is not None:
        out = out + torch.einsum("bhts,tsd->bhtd", attn.to(v2.dtype), v2).to(out.dtype)
    return out


def _kv_grad(k: torch.Tensor, v: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and (k.requires_grad or v.requires_grad)


def takes_kernel(q, k, v, mask=None, bias=None) -> bool:
    """Whether the kernels take this call (module docstring): decided from
    what the tensors show and `_build.plain_versions()`, nothing else."""
    if _build.forced_plain() or mask is not None or bias is not None:
        return False
    if not (q.is_cuda and q.dtype == k.dtype == v.dtype == torch.bfloat16):
        return False
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        return False
    if q.shape[-1] != HEAD_DIM or k.shape[-1] != HEAD_DIM or v.shape[-1] != HEAD_DIM:
        return False
    if q.shape[:2] != k.shape[:2] or k.shape[:3] != v.shape[:3]:
        return False
    lq, lk = q.shape[2], k.shape[2]
    if lq == 0 or lk == 0:
        return False
    return lq == lk or not _kv_grad(k, v)


class Plan(NamedTuple):
    """A launch shape (csrc/short_attn.cu): `wp` warps a problem, `slots`
    problems a block, key tiles of `kt_fwd` / `kt_bwd` rows (the kernels'
    template; `rows_fwd` / `rows_bwd` staged), `q_chunks` blocks of 16 wp
    query rows and `kv_chunks` dK/dV blocks of 16 wp keys a problem group,
    `groups` groups, the blocks and dynamic shared bytes of each launch."""
    wp: int
    slots: int
    kt_fwd: int
    kt_bwd: int
    rows_fwd: int
    rows_bwd: int
    q_chunks: int
    kv_chunks: int
    groups: int
    blocks_fwd: int
    blocks_bwd: int
    smem_fwd: int
    smem_bwd: int


@functools.lru_cache(maxsize=1024)
def plan(lq: int, lk: int, bh: int, need_kv: bool) -> Plan:
    """The launch shape of a call (module docstring): up to 32 query rows a
    problem take two warps, two problems a block; longer problems four
    warps and several blocks. Keys stream in the smallest tile that holds
    them all, or in the largest."""
    wp = 2 if lq <= 32 else 4
    slots = WARPS // wp
    padded = -(-lk // 16) * 16
    kt_fwd = next((t for t in FWD_TILES if padded <= t), FWD_TILES[-1])
    kt_bwd = next((t for t in BWD_TILES if padded <= t), BWD_TILES[-1])
    rows_fwd, rows_bwd = min(kt_fwd, padded), min(kt_bwd, padded)
    q_chunks = -(-lq // (16 * wp))
    kv_chunks = -(-lk // (16 * wp)) if need_kv else 0
    groups = -(-bh // slots)
    smem_fwd = (WARPS * 16 + slots * 2 * rows_fwd) * ROW_BYTES
    smem_dq = WARPS * (3 * 16 * ROW_BYTES + 2 * 16 * 4) + slots * 2 * rows_bwd * ROW_BYTES
    smem_dkdv = slots * ((2 * 16 * wp + 3 * QT) * ROW_BYTES + 2 * QT * 4) if need_kv else 0
    return Plan(wp, slots, kt_fwd, kt_bwd, rows_fwd, rows_bwd, q_chunks, kv_chunks, groups, groups * q_chunks,
                groups * (q_chunks + kv_chunks), smem_fwd, max(smem_dq, smem_dkdv))


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t as the kernels read it (unit-stride dims, 16-byte aligned rows and
    start): t itself where it is, else a contiguous copy."""
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % 8 for n, s in zip(t.shape[:3], t.stride()[:3]) if n > 1):
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
    return t


def _strides(*ts) -> list:
    """(batch, head, row) element strides of each tensor (0 for an axis of
    one entry, which is never stepped); zeros for None."""
    out = []
    for t in ts:
        out += [0, 0, 0] if t is None else [s if n > 1 else 0 for n, s in zip(t.shape[:3], t.stride()[:3])]
    return out


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _heads_last(q: torch.Tensor) -> torch.Tensor:
    """An empty (B, H, N, D) tensor laid out as (B, N, H, D): the rows of a
    token's heads side by side, as `merge_heads` wants them."""
    b, h, n, d = q.shape
    return torch.empty_strided((b, h, n, d), (n * h * d, d, h * d, 1), dtype=q.dtype, device=q.device)


def _check(q, k, v) -> None:
    if not takes_kernel(q, k, v):
        raise ValueError(f"no short-attention kernel for q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} "
                         f"{k.dtype}, v {tuple(v.shape)} {v.dtype} on {q.device}")


def _forward(q, k, v, scale: float, with_lse: bool):
    """The forward launch: (o, row log-sum-exp (B, H, Nq) f32 or None)."""
    b, h, lq, _ = q.shape
    lk = k.shape[2]
    q, k, v = _rows(q), _rows(k), _rows(v)
    pl = plan(lq, lk, b * h, False)
    out = _heads_last(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device) if with_lse else None
    strides = (ctypes.c_longlong * 12)(*_strides(q, k, v, out))
    _build.launch("short_attn_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(lse),
                  ctypes.addressof(strides), b * h, h, lq, lk, pl.wp, pl.kt_fwd, pl.q_chunks, pl.blocks_fwd,
                  pl.smem_fwd, float(scale), _build.stream_of(q))
    return out, lse


def _backward(q, k, v, o, lse, do, scale: float, need_kv: bool):
    """The backward launch: (dq, dk, dv), dk and dv None unless `need_kv`."""
    b, h, lq, _ = q.shape
    lk = k.shape[2]
    q, k, v, o, do = (_rows(t) for t in (q, k, v, o, do))
    pl = plan(lq, lk, b * h, need_kv)
    dq = torch.empty_like(q)
    dk, dv = (torch.empty_like(k), torch.empty_like(v)) if need_kv else (None, None)
    strides = (ctypes.c_longlong * 24)(*_strides(q, k, v, o, do, dq, dk, dv))
    _build.launch("short_attn_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                  dq.data_ptr(), _ptr(dk), _ptr(dv), lse.data_ptr(), ctypes.addressof(strides), b * h, h, lq, lk,
                  pl.wp, pl.kt_bwd, pl.q_chunks + pl.kv_chunks, pl.kv_chunks, pl.blocks_bwd, pl.smem_bwd,
                  float(scale), _build.stream_of(q))
    return dq, dk, dv


class _ShortAttention(torch.autograd.Function):
    """The kernels under autograd. Saves q, k, v, the output and its row
    log-sum-exp; the backward computes dK and dV only where asked."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = _forward(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        count("nn.attention.l2_bwd")
        need_kv = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dq, dk, dv = _backward(q, k, v, o, lse, do, ctx.scale, need_kv)
        return dq if ctx.needs_input_grad[0] else None, dk, dv, None


def short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v by kernel L2 (under autograd where q, k or
    v needs a gradient), counted under "nn.attention.l2"; raises on what
    `takes_kernel` refuses."""
    _check(q, k, v)
    count("nn.attention.l2")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _ShortAttention.apply(q, k, v, scale)
    return _forward(q, k, v, scale, with_lse=False)[0]
