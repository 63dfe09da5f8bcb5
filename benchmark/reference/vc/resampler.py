"""Perceiver-style image-token Resampler (image_proj_model).

Counterpart of `guidedvd3dgs_tpu/diffusion/resampler.py` (reference
lvdm/modules/encoders/resampler.py:47-144): learned queries cross-attend to
the projected CLIP image tokens. guidedvd config: dim 1024, depth 4, 12
heads of 64, 16 queries per frame over 16 frames, 1280 -> 1024.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .nnops import Params, gelu, layer_norm, linear


@dataclass(frozen=True)
class ResamplerConfig:
    dim: int = 1024
    depth: int = 4
    dim_head: int = 64
    heads: int = 12
    num_queries: int = 16
    embedding_dim: int = 1280
    output_dim: int = 1024
    ff_mult: int = 4
    video_length: int = 16


def _perceiver_attention(p: Params, prefix: str, x: torch.Tensor, latents: torch.Tensor,
                         heads: int, dim_head: int) -> torch.Tensor:
    """reference resampler.py:48-95."""
    x = layer_norm(p, f"{prefix}.norm1", x)
    latents = layer_norm(p, f"{prefix}.norm2", latents)
    b, n_lat, _ = latents.shape
    q = linear(p, f"{prefix}.to_q", latents)
    k, v = linear(p, f"{prefix}.to_kv", torch.cat([x, latents], dim=-2)).chunk(2, dim=-1)

    def heads_split(t):
        return t.reshape(t.shape[0], t.shape[1], heads, -1).transpose(1, 2)

    q, k, v = heads_split(q), heads_split(k), heads_split(v)
    scale = 1.0 / (dim_head ** 0.25)
    w = torch.matmul(q * scale, (k * scale).transpose(-1, -2))
    w = torch.softmax(w.float(), dim=-1).to(v.dtype)
    out = torch.matmul(w, v).transpose(1, 2).reshape(b, n_lat, -1)
    return linear(p, f"{prefix}.to_out", out)


def _ff(p: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    return linear(p, f"{prefix}.3", gelu(linear(p, f"{prefix}.1", layer_norm(p, f"{prefix}.0", x))))


def resampler_apply(p: Params, cfg: ResamplerConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, N_img_tokens, embedding_dim) -> (B, video_length*num_queries, output_dim)."""
    latents = p["latents"].to(x.dtype).expand((x.shape[0],) + p["latents"].shape[1:])
    x = linear(p, "proj_in", x)
    for d in range(cfg.depth):
        latents = _perceiver_attention(p, f"layers.{d}.0", x, latents, cfg.heads, cfg.dim_head) + latents
        latents = _ff(p, f"layers.{d}.1", latents) + latents
    return layer_norm(p, "norm_out", linear(p, "proj_out", latents))
