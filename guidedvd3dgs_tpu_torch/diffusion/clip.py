"""OpenCLIP ViT-H-14 text and vision towers (the conditioning encoders).

Counterpart of `guidedvd3dgs_tpu/diffusion/clip.py` (reference
lvdm/modules/encoders/condition.py:174-236 FrozenOpenCLIPEmbedder, text at
the penultimate layer; :295-373 FrozenOpenCLIPImageEmbedderV2, vision
tokens without ln_post). Parameters use open_clip state-dict names
without the checkpoint's "model." / "model.visual." prefixes. The
reference's antialiased bicubic resize to 224x224 is torch's
`interpolate(..., antialias=True)`.

ViT-H-14: text width 1024, 24 layers, 16 heads, context 77, vocab 49408;
vision width 1280, 32 layers, 16 heads, patch 14, 224 input (257 tokens).

`image_embed` is the same vision tower as Stable Video Diffusion reads it
(transformers' `CLIPVisionModelWithProjection.image_embeds`, sgm's
`FrozenOpenCLIPImageEmbedder`): the class token after ln_post, projected
1280 -> 1024 by `proj.weight` (diffusion/convert.py renames SVD's
image_encoder to these names). Departure: the resize to 224x224 is this
module's antialiased bicubic (align_corners False), not kornia's
(align_corners True) or diffusers' blur-then-bicubic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from guidedvd3dgs_tpu_torch.diffusion.nnops import Params, attention, conv2d, embedding, layer_norm, linear

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 49408
    width: int = 1024
    heads: int = 16
    layers: int = 24
    context_length: int = 77
    penultimate: bool = True  # layer="penultimate": skip the last resblock


@dataclass(frozen=True)
class VisionConfig:
    width: int = 1280
    heads: int = 16
    layers: int = 32
    patch_size: int = 14
    image_size: int = 224


def _mha(p: Params, prefix: str, x: torch.Tensor, heads: int,
         causal_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch nn.MultiheadAttention with the packed in_proj. x: (B, N, C)."""
    b, n, c = x.shape
    qkv = F.linear(x, p[f"{prefix}.in_proj_weight"].to(x.dtype), p[f"{prefix}.in_proj_bias"].to(x.dtype))
    q, k, v = (t.reshape(b, n, heads, c // heads).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    out = attention(q, k, v, (c // heads) ** -0.5, bias=causal_mask)
    return linear(p, f"{prefix}.out_proj", out.transpose(1, 2).reshape(b, n, c))


def _resblock(p: Params, prefix: str, x: torch.Tensor, heads: int,
              causal_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = x + _mha(p, f"{prefix}.attn", layer_norm(p, f"{prefix}.ln_1", x), heads, causal_mask)
    h = F.gelu(linear(p, f"{prefix}.mlp.c_fc", layer_norm(p, f"{prefix}.ln_2", x)))
    return x + linear(p, f"{prefix}.mlp.c_proj", h)


def text_encode(p: Params, cfg: TextConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, 77) int -> (B, 77, width) float32 features of the
    penultimate layer with ln_final (reference condition.py:213-231)."""
    x = embedding(p, "token_embedding.weight", tokens).float()
    x = x + p["positional_embedding"].float()
    n = tokens.shape[1]
    causal = torch.triu(torch.full((n, n), float("-inf"), device=x.device), diagonal=1)[None, None]
    for i in range(cfg.layers - (1 if cfg.penultimate else 0)):
        x = _resblock(p, f"transformer.resblocks.{i}", x, cfg.heads, causal)
    return layer_norm(p, "ln_final", x)


def image_preprocess(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """images: (B, H, W, 3) in [-1, 1] -> CLIP-normalised (B, size, size, 3)
    (reference condition.py:321-329)."""
    x = F.interpolate(images.permute(0, 3, 1, 2), size=(size, size), mode="bicubic",
                      align_corners=False, antialias=True).permute(0, 2, 3, 1)
    x = (x + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def image_encode(p: Params, cfg: VisionConfig, images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, 3) in [-1, 1] -> (B, 1 + grid^2, width) token
    features without ln_post (reference condition.py:341-373)."""
    x = image_preprocess(images, cfg.image_size)
    x = conv2d(p, "conv1", x, stride=cfg.patch_size, padding=0)  # OIHW, stride = patch, no bias
    b, gh, gw, c = x.shape
    x = x.reshape(b, gh * gw, c)
    cls = p["class_embedding"].to(x.dtype).expand(b, 1, c)
    x = torch.cat([cls, x], dim=1) + p["positional_embedding"].to(x.dtype)
    x = layer_norm(p, "ln_pre", x)
    for i in range(cfg.layers):
        x = _resblock(p, f"transformer.resblocks.{i}", x, cfg.heads)
    return x


def image_embed(p: Params, cfg: VisionConfig, images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, 3) in [-1, 1] -> (B, proj_dim): the pooled class
    token after ln_post, projected."""
    x = layer_norm(p, "ln_post", image_encode(p, cfg, images)[:, 0])
    return linear(p, "proj", x)
