"""Kernel L1: flash-attention forward, and its plain version.

Counterpart of `guidedvd3dgs_tpu/diffusion/nnops.py::_flash_attention_padded`
(JAX's library Pallas TPU flash attention). `nnops.attention` sends long
unmasked self-attention here: the UNet's level-0 spatial attention
(q, k, v (25, 5, 2240, 64) per CFG branch) and the VAE's mid-block
attention (one head of 512 dims over 2240 tokens per frame). The CUDA
kernel is csrc/flash_attn_fwd.cu; it is forward only (the guided sampler,
which differentiates through the UNet, brings its backward kernel).
"""

from __future__ import annotations

import torch

from guidedvd3dgs_tpu_torch.ops import _build

HEAD_DIMS = (32, 64, 128, 512)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BATCH_HEADS = 65535  # the grid's y extent


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """Plain version of L1 (reference nnops.py:317-323): float32 logits
    times `scale`, float32 softmax, the weights cast to v's type, then the
    second product. q: (B, H, Nq, D); k, v: (B, H, Nk, D)."""
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    attn = torch.softmax(sim, dim=-1)
    return torch.matmul(attn.to(v.dtype), v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v for self-attention: q, k, v contiguous
    (B, H, N, D) of one shape, float32 or bfloat16. CPU tensors take the
    plain version; CUDA tensors launch kernel L1 and raise on what it does
    not take. Forward only: an input that requires grad raises."""
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward only; its backward kernel comes with the guided "
            "sampler slice (samplers/ddim_guidance.py)")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_cuda(name, t, q.dtype, q.device, (b, h, n, d))
    out = torch.empty_like(q)
    _build.launch("flash_attn_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b * h, n, d, _DTYPE_CODE[q.dtype], float(scale), _build.stream_of(q))
    return out
