"""Functional NN primitives over torch-named parameter dicts: the plain
reference's copy of the port's `diffusion/nnops.py`, frozen, with every
attention in its einsum form (no kernel), no sharded weights, and the
control's precision switch (`lowered`).

Counterpart of `guidedvd3dgs_tpu/diffusion/nnops.py`. Parameters are a flat
dict keyed by the source checkpoint's state_dict names, in torch layouts
(Linear (out, in), Conv2d OIHW, Conv3d OIDHW). Activations are channels-last
at every public function: (N, H, W, C) and (B, T, H, W, C), as in the JAX
package. A convolution permutes them to NCHW / NCDHW views, which are
channels-last strided, so cuDNN runs its channels-last kernels and nothing
is copied. `plain` arguments are kept for the copy's signatures and
change nothing here.

Reference semantics: third_party/ViewCrafter/lvdm/basics.py (GroupNorm32 in
f32), lvdm/models/utils_diffusion.py:8-28 (timestep_embedding, [cos, sin]
order).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

Params = dict  # flat {torch_name: tensor}

# the control's format of every linear and convolution input and weight
# (None: the reference's own precision); set only by `lowered`
_LOWERED = {"dtype": None}
FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


@contextlib.contextmanager
def lowered(dtype):
    """Within it every linear and convolution rounds its input and weight
    to `dtype` (float8_e4m3fn: per-tensor scaled to its range), then
    computes in the input's type: the control of the bf16 configuration."""
    prev = _LOWERED["dtype"]
    _LOWERED["dtype"] = dtype
    try:
        yield
    finally:
        _LOWERED["dtype"] = prev


# activation checkpointing of the UNet's blocks and the decoder's levels
# under autograd (unet3d.py, vae.py); off only to count operations once
_RECOMPUTE = {"on": True}


@contextlib.contextmanager
def no_recompute():
    prev = _RECOMPUTE["on"]
    _RECOMPUTE["on"] = False
    try:
        yield
    finally:
        _RECOMPUTE["on"] = prev


def recompute(h: torch.Tensor) -> bool:
    """Whether a block of `h` is to be recomputed in the backward."""
    return _RECOMPUTE["on"] and torch.is_grad_enabled() and h.requires_grad


def _round_to(t: torch.Tensor, dtype) -> torch.Tensor:
    """t rounded to `dtype` at a per-tensor scale; the gradient passes
    straight through the rounding."""
    with torch.no_grad():
        s = t.abs().amax().float().clamp(min=1e-30) / FP8_MAX
        q = ((t.float() / s).to(dtype).float() * s).to(t.dtype)
    return t + (q - t).detach() if t.requires_grad else q


def _bias(p: Params, name: str, dtype: torch.dtype):
    b = p.get(f"{name}.bias")
    return None if b is None else b.to(dtype)


def _layer(p: Params, name: str, x: torch.Tensor, fn) -> torch.Tensor:
    """fn(x, weight, bias) with the weight in x's dtype (both rounded to
    the control's format inside `lowered`)."""
    w = p[f"{name}.weight"].to(x.dtype)
    low = _LOWERED["dtype"]
    if low is not None:
        x, w = _round_to(x, low), _round_to(w, low)
    return fn(x, w, _bias(p, name, x.dtype))


def linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return _layer(p, name, x, F.linear)


def conv2d(p: Params, name: str, x: torch.Tensor, stride: int = 1, padding=1) -> torch.Tensor:
    """x: (N, H, W, C); weight: torch OIHW; padding an int or ((top,
    bottom), (left, right))."""

    def fn(x, w, b, padding=padding):
        xc = x.permute(0, 3, 1, 2)
        if not isinstance(padding, int):
            (t, bo), (l, r) = padding
            xc, padding = F.pad(xc, (l, r, t, bo)), 0
        return F.conv2d(xc, w, b, stride=stride, padding=padding).permute(0, 2, 3, 1)

    return _layer(p, name, x, fn)


def conv3d(p: Params, name: str, x: torch.Tensor, padding=(1, 0, 0)) -> torch.Tensor:
    """x: (N, T, H, W, C); weight: torch OIDHW (D = time)."""
    return _layer(p, name, x, lambda x, w, b: F.conv3d(x.permute(0, 4, 1, 2, 3), w, b, padding=tuple(padding))
                  .permute(0, 2, 3, 4, 1))


def conv1d_k1(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """Pointwise Conv1d (kernel_size=1) as a matmul. x: (..., C_in)."""
    return _layer(p, name, x, lambda x, w, b: F.linear(x, w[:, :, 0], b))


def embedding(p: Params, name: str, ids: torch.Tensor) -> torch.Tensor:
    """The rows `ids` of table `name`."""
    return p[name][ids]


def group_norm(p: Params, name: str, x: torch.Tensor, num_groups: int = 32,
               eps: float = 1e-5) -> torch.Tensor:
    """Channels-last GroupNorm with f32 statistics (reference nnops.py:77-110).
    f32 inputs take the two-pass form; half-precision inputs take the
    reference's folded form x*scale + shift in f32, cast back, with the
    statistics from one var_mean pass over the f32 copy and the fold as
    one addcmul (the activation is read and written as few times as the
    f32 form allows)."""
    c = x.shape[-1]
    g = num_groups
    xg = x.reshape(x.shape[:-1] + (g, c // g))
    red = tuple(range(1, x.dim() - 1)) + (x.dim(),)
    w = p[f"{name}.weight"].float()
    b = p[f"{name}.bias"].float()
    if x.dtype == torch.float32:
        mean = xg.mean(dim=red, keepdim=True)
        var = xg.var(dim=red, keepdim=True, correction=0)
        xg = (xg - mean) * torch.rsqrt(var + eps)
        return xg.reshape(x.shape) * w + b
    xf = xg.float()
    var, mean = torch.var_mean(xf, dim=red, keepdim=True, correction=0)
    scale = torch.rsqrt(var + eps) * w.reshape(g, c // g)
    shift = b.reshape(g, c // g) - mean * scale
    return torch.addcmul(shift, xf, scale).reshape(x.shape).to(x.dtype)


def layer_norm(p: Params, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"].to(x.dtype),
                        p[f"{name}.bias"].to(x.dtype), eps)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # the exact erf form, as torch's default


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """[cos | sin] sinusoidal embedding (reference utils_diffusion.py:8-28)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsampling on (..., H, W, C)."""
    return x.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean with stride 2 on (..., H, W, C); an odd edge is dropped."""
    h, w, c = x.shape[-3] // 2, x.shape[-2] // 2, x.shape[-1]
    x = x[..., : 2 * h, : 2 * w, :].reshape(x.shape[:-3] + (h, 2, w, 2, c))
    return x.sum(dim=(-4, -2)) / 4.0


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              bias: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
              plain: bool = False) -> torch.Tensor:
    """Softmax attention; q, k, v: (B, H, N, D); softmax in f32 (reference
    nnops.py:317-323, and kernel L1's plain version)."""
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        sim = sim + bias
    if mask is not None:
        sim = torch.where(mask, sim, torch.finfo(sim.dtype).min)
    attn = torch.softmax(sim, dim=-1)
    return torch.matmul(attn.to(v.dtype), v)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, c = x.shape
    return x.reshape(b, n, heads, c // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)
