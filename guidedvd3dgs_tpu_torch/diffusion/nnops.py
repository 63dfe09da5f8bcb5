"""Functional NN primitives over torch-named parameter dicts.

Counterpart of `guidedvd3dgs_tpu/diffusion/nnops.py`. Parameters are a flat
dict keyed by the source checkpoint's state_dict names, in torch layouts
(Linear (out, in), Conv2d OIHW, Conv3d OIDHW). Activations are channels-last
at every public function: (N, H, W, C) and (B, T, H, W, C), as in the JAX
package. A convolution permutes them to NCHW / NCDHW views, which are
channels-last strided, so cuDNN runs its channels-last kernels and nothing
is copied. A weight may be a `Sharded` holder (parallel/model_parallel.py):
the layer then runs over the mesh's model axis and returns its output on
the input's device.

Reference semantics: third_party/ViewCrafter/lvdm/basics.py (GroupNorm32 in
f32), lvdm/models/utils_diffusion.py:8-28 (timestep_embedding, [cos, sin]
order).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from guidedvd3dgs_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain_autograd
from guidedvd3dgs_tpu_torch.parallel import model_parallel
from guidedvd3dgs_tpu_torch.parallel.model_parallel import Sharded, column_apply, row_apply
from guidedvd3dgs_tpu_torch.utils.tracing import span

Params = dict  # flat {torch_name: tensor}

# self-attention at least this long takes kernel L1 (reference nnops.py:162)
FLASH_MIN_SEQ = 1024


def _bias(p: Params, name: str, dtype: torch.dtype):
    b = p.get(f"{name}.bias")
    return None if b is None else b.to(dtype)


def _layer(p: Params, name: str, x: torch.Tensor, fn, label: str) -> torch.Tensor:
    """fn(x, weight, bias) with the weight in x's dtype, inside the range
    "span:<label>"; a `Sharded` weight runs column- or row-parallel
    (parallel/model_parallel.py)."""
    with span(label):
        w = p[f"{name}.weight"]
        if isinstance(w, Sharded):
            apply = column_apply if w.dim == 0 else row_apply
            return apply(w, x, fn, p.get(f"{name}.bias"))
        return fn(x, w.to(x.dtype), _bias(p, name, x.dtype))


def linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return _layer(p, name, x, F.linear, "nn.linear")


def conv2d(p: Params, name: str, x: torch.Tensor, stride: int = 1, padding=1) -> torch.Tensor:
    """x: (N, H, W, C); weight: torch OIHW; padding an int or ((top,
    bottom), (left, right))."""

    def fn(x, w, b, padding=padding):
        xc = x.permute(0, 3, 1, 2)
        if not isinstance(padding, int):
            (t, bo), (l, r) = padding
            xc, padding = F.pad(xc, (l, r, t, bo)), 0
        return F.conv2d(xc, w, b, stride=stride, padding=padding).permute(0, 2, 3, 1)

    return _layer(p, name, x, fn, "nn.conv")


def conv3d(p: Params, name: str, x: torch.Tensor, padding=(1, 0, 0)) -> torch.Tensor:
    """x: (N, T, H, W, C); weight: torch OIDHW (D = time)."""
    return _layer(p, name, x, lambda x, w, b: F.conv3d(x.permute(0, 4, 1, 2, 3), w, b, padding=tuple(padding))
                  .permute(0, 2, 3, 4, 1), "nn.conv")


def conv1d_k1(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """Pointwise Conv1d (kernel_size=1) as a matmul. x: (..., C_in)."""
    return _layer(p, name, x, lambda x, w, b: F.linear(x, w[:, :, 0], b), "nn.linear")


def embedding(p: Params, name: str, ids: torch.Tensor) -> torch.Tensor:
    """The rows `ids` of table `name` (split or not)."""
    w = p[name]
    return model_parallel.embedding(w, ids) if isinstance(w, Sharded) else w[ids]


def group_norm(p: Params, name: str, x: torch.Tensor, num_groups: int = 32,
               eps: float = 1e-5) -> torch.Tensor:
    """Channels-last GroupNorm with f32 statistics (reference nnops.py:77-110).
    f32 inputs take the two-pass form; half-precision inputs take the
    reference's folded form x*scale + shift in f32, cast back, with the
    statistics from one var_mean pass over the f32 copy and the fold as
    one addcmul (the activation is read and written as few times as the
    f32 form allows)."""
    with span("nn.group_norm"):
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
    """Softmax attention; q, k, v: (B, H, N, D); softmax in f32.

    Unmasked self-attention of at least FLASH_MIN_SEQ tokens takes kernel L1
    (`ops.flash_attention`, reference nnops.py:295-303); `plain=True` sends
    it to L1's plain version instead, whose backward under autograd is L1's
    plain backward. Everything else (cross-attention,
    masked or biased attention, shorter sequences) takes the einsum form of
    reference nnops.py:317-323."""
    with span("nn.attention"):
        if bias is None and mask is None and q.shape[2] == k.shape[2] and q.shape[2] >= FLASH_MIN_SEQ:
            args = (q.contiguous(), k.contiguous(), v.contiguous(), scale)
            return flash_attention_plain_autograd(*args) if plain else flash_attention(*args)
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
