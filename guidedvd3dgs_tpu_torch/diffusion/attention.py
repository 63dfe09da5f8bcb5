"""Transformer blocks of the video diffusion UNet.

Counterpart of `guidedvd3dgs_tpu/diffusion/attention.py` (reference
lvdm/modules/attention.py): CrossAttention with the image cross-attention
(separate K/V over the image tokens; :42-210), BasicTransformerBlock
(:212-247), SpatialTransformer (:249-311) and TemporalTransformer
(:313-413) with the optional relative-position tables. Activations are
channels-last; `prefix` strings are the torch module paths. `plain=True`
sends every attention that would take kernel L1 to its plain version.
Weights may be sharded over a mesh's model axis (`cross_attention`).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

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
from guidedvd3dgs_tpu_torch.parallel.mesh import device_scope
from guidedvd3dgs_tpu_torch.parallel.model_parallel import Sharded, shard_call, sum_partials
from guidedvd3dgs_tpu_torch.utils.tracing import span


def relative_position_bias(p: Params, name: str, length_q: int, length_k: int,
                           max_rel: int) -> torch.Tensor:
    """(Lq, Lk, D) rows of the embedding table at each clipped distance
    k - q (reference attention.py:20-39)."""
    table = p[f"{name}.embeddings_table"]
    ar = functools.partial(torch.arange, device=table.device)
    idx = torch.clamp(ar(length_k)[None, :] - ar(length_q)[:, None], -max_rel, max_rel) + max_rel
    return table[idx]


def _attend(qh, kh, vh, scale: float, mask, rel, plain: bool) -> torch.Tensor:
    """Attention over (B, H, N, D) heads; with `rel`, the relative-position
    tables (k2, v2) (Lq, Lk, D): their bias on the logits and their term on
    the output need the weights explicitly (reference attention.py:
    100-127)."""
    if rel is None:
        return attention(qh, kh, vh, scale, mask=mask, plain=plain)  # its own "nn.attention"
    k2, v2 = rel
    with span("nn.attention"):
        sim = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
        sim = sim + torch.einsum("bhtd,tsd->bhts", qh.float(), k2.float()) * scale
        if mask is not None:
            sim = torch.where(mask, sim, torch.finfo(sim.dtype).min)
        attn = torch.softmax(sim, dim=-1)
        out = torch.matmul(attn.to(vh.dtype), vh)
        return out + torch.einsum("bhts,tsd->bhtd", attn.to(v2.dtype), v2).to(out.dtype)


def _head_parallel(p: Params, prefix: str, names, heads: int) -> Optional[Sharded]:
    """The row-sharded `to_out.0` weight when the attention's projections
    are column-sharded over the same devices and its heads split evenly
    over them, else None."""
    wo = p[f"{prefix}.to_out.0.weight"]
    if not isinstance(wo, Sharded) or wo.dim != 1 or heads % len(wo.shards):
        return None
    for nm in names:
        w = p[f"{prefix}.{nm}.weight"]
        if not isinstance(w, Sharded) or w.dim != 0 or w.devices != wo.devices:
            return None
    return wo


def cross_attention(p: Params, prefix: str, x: torch.Tensor, context: Optional[torch.Tensor],
                    heads: int, dim_head: int, mask: Optional[torch.Tensor] = None,
                    image_cross_attention: bool = False,
                    image_cross_attention_scale: float = 1.0, text_context_len: int = 77,
                    relative_position: bool = False, temporal_length: Optional[int] = None,
                    plain: bool = False) -> torch.Tensor:
    """reference attention.py:81-144. x: (B, N, C). With sharded weights
    whose heads split over the model axis (`_head_parallel`), each device
    projects, attends and multiplies by its row piece of `to_out.0` for
    its own heads (L1 with heads / n_model heads where the sequence takes
    it), and the partial outputs are summed on x's device; otherwise q, k
    and v meet on x's device (a sharded projection gathers its output
    there) and the attention runs there."""
    scale = dim_head ** -0.5
    image = image_cross_attention and context is not None
    ctx = x if context is None else context[:, :text_context_len]
    ctx_img = context[:, text_context_len:] if image else None
    names = ("to_q", "to_k", "to_v") + (("to_k_ip", "to_v_ip") if image else ())
    m = None if mask is None else mask[:, None] > 0.5  # (B, 1, N, N)
    rel = None
    if relative_position:
        if temporal_length is None:
            raise ValueError("relative_position needs temporal_length")
        rel = tuple(relative_position_bias(p, f"{prefix}.relative_position_{kv}", x.shape[1], ctx.shape[1],
                                           temporal_length) for kv in "kv")

    def attend(proj, n_heads: int, dev: torch.device) -> torch.Tensor:
        """The merged (B, N, n_heads * dim_head) output of the heads whose
        projections `proj(name, input)` gives, on `dev`."""
        qh = split_heads(proj("to_q", x), n_heads)
        r = None if rel is None else tuple(t.to(dev) for t in rel)
        mm = None if m is None else m.to(dev)
        out = merge_heads(_attend(qh, split_heads(proj("to_k", ctx), n_heads),
                                  split_heads(proj("to_v", ctx), n_heads), scale, mm, r, plain))
        if image:
            out_ip = merge_heads(attention(qh, split_heads(proj("to_k_ip", ctx_img), n_heads),
                                           split_heads(proj("to_v_ip", ctx_img), n_heads), scale,
                                           plain=plain))
            if f"{prefix}.alpha" in p:  # the learnable gate (reference attention.py:115-118)
                gate = (torch.tanh(p[f"{prefix}.alpha"].to(dev)) + 1.0).to(out.dtype)
                out = out + image_cross_attention_scale * out_ip * gate
            else:
                out = out + image_cross_attention_scale * out_ip
        return out

    wo = _head_parallel(p, prefix, names, heads)
    if wo is None:
        out = attend(lambda nm, inp: linear(p, f"{prefix}.{nm}", inp), heads, x.device)
        return linear(p, f"{prefix}.to_out.0", out)
    n = len(wo.shards)
    parts = []
    for i, dev in enumerate(wo.devices):
        with device_scope(dev):
            def proj(nm, inp, i=i):
                return shard_call(p[f"{prefix}.{nm}.weight"], i, inp, F.linear, p.get(f"{prefix}.{nm}.bias"))

            parts.append(F.linear(attend(proj, heads // n, dev), wo.shards[i].to(x.dtype)))
    return sum_partials(parts, x.device, x.dtype, p.get(f"{prefix}.to_out.0.bias"))


def feed_forward(p: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """GEGLU feed-forward (reference attention.py:415-442, glu=True)."""
    a, gate = linear(p, f"{prefix}.net.0.proj", x).chunk(2, dim=-1)
    return linear(p, f"{prefix}.net.2", a * gelu(gate))


def basic_transformer_block(p: Params, prefix: str, x: torch.Tensor,
                            context: Optional[torch.Tensor], heads: int, dim_head: int,
                            mask: Optional[torch.Tensor] = None,
                            image_cross_attention: bool = False,
                            relative_position: bool = False, temporal_length: Optional[int] = None,
                            plain: bool = False) -> torch.Tensor:
    """reference attention.py:240-247: self-attention, cross-attention, FF."""
    rel = dict(relative_position=relative_position, temporal_length=temporal_length, plain=plain)
    x = cross_attention(p, f"{prefix}.attn1", layer_norm(p, f"{prefix}.norm1", x), None, heads,
                        dim_head, mask=mask, **rel) + x
    x = cross_attention(p, f"{prefix}.attn2", layer_norm(p, f"{prefix}.norm2", x), context, heads,
                        dim_head, mask=mask, image_cross_attention=image_cross_attention, **rel) + x
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
                         causal_attention: bool = False, relative_position: bool = False,
                         temporal_length: Optional[int] = None, plain: bool = False) -> torch.Tensor:
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
                                    mask=mask, relative_position=relative_position,
                                    temporal_length=temporal_length, plain=plain)
    x = linear(p, f"{prefix}.proj_out", x) if use_linear else conv1d_k1(p, f"{prefix}.proj_out", x)
    x = x.reshape(b, h, w, t, x.shape[-1]).permute(0, 3, 1, 2, 4)
    return x + x_in
