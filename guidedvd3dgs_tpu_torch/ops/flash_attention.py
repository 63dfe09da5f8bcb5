"""Kernel L1: flash attention, forward and backward, and their plain versions.

Counterpart of `guidedvd3dgs_tpu/diffusion/nnops.py::_flash_attention_padded`
(JAX's library Pallas TPU flash attention, a `jax.custom_vjp` whose forward
is `_flash_attention_impl` and whose backward is the two Pallas calls
`_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`). `nnops.attention`
sends long unmasked self-attention here: the UNet's level-0 spatial
attention (q, k, v (25, 5, 2240, 64) per CFG branch, also under autograd
in the guided sampler's VJP; (50, 5, 2240, 64) for its batched pair's
forward) and the VAE's mid-block attention (one
head of 512 dims over 2240 tokens per frame). The CUDA kernels are
csrc/flash_attn_fwd.cu, which also writes the row log-sum-exp under
autograd, and csrc/flash_attn_bwd.cu (dK/dV and dQ), behind the autograd
Function `FlashAttention`.
"""

from __future__ import annotations

import torch

from guidedvd3dgs_tpu_torch.ops import _build

HEAD_DIMS = (32, 64, 128, 512)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BATCH_HEADS = 65535  # the grid's y extent


def _plain(q, k, v, scale: float, with_lse: bool):
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    out = torch.matmul(torch.softmax(sim, dim=-1).to(v.dtype), v)
    return out, (torch.logsumexp(sim, dim=-1) if with_lse else None)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """Plain version of L1 (reference nnops.py:317-323): float32 logits
    times `scale`, float32 softmax, the weights cast to v's type, then the
    second product. q: (B, H, Nq, D); k, v: (B, H, Nk, D)."""
    return _plain(q, k, v, scale, with_lse=False)[0]


def flash_attention_plain_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """flash_attention_plain and the log-sum-exp of each row of the scaled
    float32 logits, (B, H, Nq) float32: what the kernel writes for the
    backward."""
    return _plain(q, k, v, scale, with_lse=True)


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale: float):
    """Plain version of L1's backward: (dq, dk, dv) in the inputs' type
    from the output `o`, its row log-sum-exp `lse` and the cotangent `do`.
    P = exp(q k^T * scale - lse) is recomputed in float32 and rounded to v's
    type for dV (as the forward rounds it); dP = dO V^T, Delta = sum(dO o),
    dS = P (dP - Delta), and the products for dq and dk are float32."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse[..., None])
    delta = (dof * o.float()).sum(-1, keepdim=True)
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *more) -> tuple:
    """Raise unless q, k, v (and `more`: (name, tensor) pairs of the same
    shape) are what the kernels take; returns (B, H, N, D)."""
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention takes float32 or bfloat16, not {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q has shape {tuple(q.shape)}, expected (B, H, N, D)")
    b, h, n, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if b * h > _MAX_BATCH_HEADS:
        raise ValueError(f"B*H = {b * h} exceeds {_MAX_BATCH_HEADS}")
    for name, t in (("q", q), ("k", k), ("v", v)) + more:
        _build.check_cuda(name, t, q.dtype, q.device, (b, h, n, d))
    return b, h, n, d


def _check_aligned(*named) -> None:
    """Raise unless each (name, tensor) starts at a 16-byte aligned address:
    the bf16 kernels copy 16-byte pieces (TMA, cp.async)."""
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start at a 16-byte aligned address for the bf16 kernels")


def _launch_fwd(q, k, v, scale: float, with_lse: bool):
    b, h, n, d = _check(q, k, v)
    if q.dtype == torch.bfloat16:
        _check_aligned(("q", q), ("k", k), ("v", v))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device) if with_lse else None
    _build.launch("flash_attn_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  None if lse is None else lse.data_ptr(), b * h, n, d, _DTYPE_CODE[q.dtype],
                  float(scale), _build.stream_of(q))
    return out, lse


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(output, row log-sum-exp (B, H, N) float32): kernel L1 with its
    log-sum-exp output on CUDA tensors, flash_attention_plain_lse on CPU
    tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain_lse(q, k, v, scale)
    return _launch_fwd(q, k, v, scale, with_lse=True)


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Delta = sum_d dO o per row, float32 (B, H, N): the JAX VJP computes it
    outside its kernels too (flash_attention.py:273-275)."""
    return (do.float() * o.float()).sum(-1)


def _bwd_args(q, k, v, do, lse, delta):
    b, h, n, d = _check(q, k, v, ("do", do))
    for name, t in (("lse", lse), ("delta", delta)):
        _build.check_cuda(name, t, torch.float32, q.device, (b, h, n))
    if q.dtype == torch.bfloat16:
        _check_aligned(("q", q), ("k", k), ("v", v), ("do", do), ("lse", lse), ("delta", delta))
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr()), (b * h, n, d, _DTYPE_CODE[q.dtype])


def bwd_dkv_kernel(q, k, v, do, lse, delta, scale: float):
    """(dk, dv) by the dK/dV kernel; CUDA tensors only."""
    ptrs, dims = _bwd_args(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.launch("flash_attn_bwd_dkv", *ptrs, dk.data_ptr(), dv.data_ptr(), *dims, float(scale),
                  _build.stream_of(q))
    return dk, dv


def bwd_dq_kernel(q, k, v, do, lse, delta, scale: float):
    """dq by the dQ kernel; CUDA tensors only."""
    ptrs, dims = _bwd_args(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    _build.launch("flash_attn_bwd_dq", *ptrs, dq.data_ptr(), *dims, float(scale), _build.stream_of(q))
    return dq


def flash_attention_bwd(q, k, v, o, lse, do, scale: float):
    """L1's backward, (dq, dk, dv): the plain version on CPU tensors, the
    dK/dV and dQ kernels on CUDA tensors (raising on what they do not
    take)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    delta = attention_delta(o, do)
    dk, dv = bwd_dkv_kernel(q, k, v, do, lse, delta, scale)
    return bwd_dq_kernel(q, k, v, do, lse, delta, scale), dk, dv


class FlashAttention(torch.autograd.Function):
    """L1 under autograd. The forward keeps q, k, v, the output and its row
    log-sum-exp; the backward is `flash_attention_bwd`. With `plain` both
    directions take the plain versions, on any device."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, plain: bool):
        fwd = flash_attention_plain_lse if plain else flash_attention_lse
        out, lse = fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.plain = scale, plain
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_plain if ctx.plain else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), ctx.scale)
        return dq, dk, dv, None, None


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v for self-attention: q, k, v contiguous
    (B, H, N, D) of one shape, float32 or bfloat16. CPU tensors take the
    plain version; CUDA tensors launch kernel L1 and raise on what it does
    not take. Under autograd the forward also writes the row log-sum-exp
    and the backward launches the dK/dV and dQ kernels (the plain backward
    for CPU tensors)."""
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, scale, False)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    return _launch_fwd(q, k, v, scale, with_lse=False)[0]


def flash_attention_plain_autograd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   scale: float) -> torch.Tensor:
    """L1's plain version on any device: flash_attention_plain, and under
    autograd the plain forward/backward pair (flash_attention_plain_lse,
    flash_attention_bwd_plain). What `nnops.attention(..., plain=True)`
    runs; chosen by that argument only, never in place of a kernel."""
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, scale, True)
    return flash_attention_plain(q, k, v, scale)
