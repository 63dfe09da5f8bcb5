"""Transformer blocks of the video diffusion UNet.

Counterpart of `guidedvd3dgs_tpu/diffusion/attention.py` (reference
lvdm/modules/attention.py): CrossAttention with the image cross-attention
(separate K/V over the image tokens; :42-210), BasicTransformerBlock
(:212-247), SpatialTransformer (:249-311) and TemporalTransformer
(:313-413). Activations are channels-last; `prefix` strings are the torch
module paths. `plain=True` sends every attention that would take kernel L1
to its plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from guidedvd3dgs_tpu_torch.diffusion.nnops import (
    Params,
    attention,
    conv1d_k1,
    conv2d,
    gelu,
    group_norm,
    layer_norm,
    linear,
    merge_heads,
    split_heads,
)


def cross_attention(p: Params, prefix: str, x: torch.Tensor, context: Optional[torch.Tensor],
                    heads: int, dim_head: int, mask: Optional[torch.Tensor] = None,
                    image_cross_attention: bool = False,
                    image_cross_attention_scale: float = 1.0, text_context_len: int = 77,
                    plain: bool = False) -> torch.Tensor:
    """reference attention.py:81-144. x: (B, N, C)."""
    scale = dim_head ** -0.5
    spatial_self_attn = context is None
    q = linear(p, f"{prefix}.to_q", x)
    ctx = x if context is None else context
    k_ip = v_ip = None
    if image_cross_attention and not spatial_self_attn:
        ctx_text, ctx_img = ctx[:, :text_context_len], ctx[:, text_context_len:]
        k = linear(p, f"{prefix}.to_k", ctx_text)
        v = linear(p, f"{prefix}.to_v", ctx_text)
        k_ip = linear(p, f"{prefix}.to_k_ip", ctx_img)
        v_ip = linear(p, f"{prefix}.to_v_ip", ctx_img)
    else:
        if not spatial_self_attn:
            ctx = ctx[:, :text_context_len]
        k = linear(p, f"{prefix}.to_k", ctx)
        v = linear(p, f"{prefix}.to_v", ctx)

    qh = split_heads(q, heads)
    m = None if mask is None else mask[:, None] > 0.5  # (B, 1, N, N)
    out = merge_heads(attention(qh, split_heads(k, heads), split_heads(v, heads), scale, mask=m,
                                plain=plain))
    if k_ip is not None:
        out_ip = merge_heads(attention(qh, split_heads(k_ip, heads), split_heads(v_ip, heads), scale,
                                       plain=plain))
        if f"{prefix}.alpha" in p:  # the learnable gate (reference attention.py:115-118)
            gate = (torch.tanh(p[f"{prefix}.alpha"]) + 1.0).to(out.dtype)
            out = out + image_cross_attention_scale * out_ip * gate
        else:
            out = out + image_cross_attention_scale * out_ip
    return linear(p, f"{prefix}.to_out.0", out)


def feed_forward(p: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """GEGLU feed-forward (reference attention.py:415-442, glu=True)."""
    a, gate = linear(p, f"{prefix}.net.0.proj", x).chunk(2, dim=-1)
    return linear(p, f"{prefix}.net.2", a * gelu(gate))


def basic_transformer_block(p: Params, prefix: str, x: torch.Tensor,
                            context: Optional[torch.Tensor], heads: int, dim_head: int,
                            mask: Optional[torch.Tensor] = None,
                            image_cross_attention: bool = False,
                            plain: bool = False) -> torch.Tensor:
    """reference attention.py:240-247: self-attention, cross-attention, FF."""
    x = cross_attention(p, f"{prefix}.attn1", layer_norm(p, f"{prefix}.norm1", x), None, heads,
                        dim_head, mask=mask, plain=plain) + x
    x = cross_attention(p, f"{prefix}.attn2", layer_norm(p, f"{prefix}.norm2", x), context, heads,
                        dim_head, mask=mask, image_cross_attention=image_cross_attention,
                        plain=plain) + x
    return feed_forward(p, f"{prefix}.ff", layer_norm(p, f"{prefix}.norm3", x)) + x


def spatial_transformer(p: Params, prefix: str, x: torch.Tensor, context: Optional[torch.Tensor],
                        heads: int, dim_head: int, depth: int = 1, use_linear: bool = True,
                        image_cross_attention: bool = False, plain: bool = False) -> torch.Tensor:
    """reference attention.py:294-311. x: (B, H, W, C)."""
    b, h, w, _ = x.shape
    x_in = x
    x = group_norm(p, f"{prefix}.norm", x, eps=1e-6)
    if not use_linear:
        x = conv2d(p, f"{prefix}.proj_in", x, padding=0)
    x = x.reshape(b, h * w, x.shape[-1])
    if use_linear:
        x = linear(p, f"{prefix}.proj_in", x)
    for d in range(depth):
        x = basic_transformer_block(p, f"{prefix}.transformer_blocks.{d}", x, context, heads,
                                    dim_head, image_cross_attention=image_cross_attention,
                                    plain=plain)
    if use_linear:
        x = linear(p, f"{prefix}.proj_out", x)
    x = x.reshape(b, h, w, x.shape[-1])
    if not use_linear:
        x = conv2d(p, f"{prefix}.proj_out", x, padding=0)
    return x + x_in


def temporal_transformer(p: Params, prefix: str, x: torch.Tensor, heads: int, dim_head: int,
                         depth: int = 1, use_linear: bool = False,
                         causal_attention: bool = False, plain: bool = False) -> torch.Tensor:
    """reference attention.py:366-413, self-attention only: the tokens are
    the T frames of each (b, h, w). x: (B, T, H, W, C)."""
    b, t, h, w, c = x.shape
    x_in = x
    x = group_norm(p, f"{prefix}.norm", x, eps=1e-6)
    x = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
    x = linear(p, f"{prefix}.proj_in", x) if use_linear else conv1d_k1(p, f"{prefix}.proj_in", x)
    mask = None
    if causal_attention:
        mask = torch.tril(torch.ones((1, t, t), dtype=torch.float32, device=x.device))
        mask = mask.expand(b * h * w, t, t)
    for d in range(depth):
        x = basic_transformer_block(p, f"{prefix}.transformer_blocks.{d}", x, None, heads, dim_head,
                                    mask=mask, plain=plain)
    x = linear(p, f"{prefix}.proj_out", x) if use_linear else conv1d_k1(p, f"{prefix}.proj_out", x)
    x = x.reshape(b, h, w, t, x.shape[-1]).permute(0, 3, 1, 2, 4)
    return x + x_in
