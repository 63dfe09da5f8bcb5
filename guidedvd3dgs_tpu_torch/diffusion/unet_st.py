"""Stable Video Diffusion's spatio-temporal UNet (SVD-XT, image-to-video).

The equations of diffusers' `UNetSpatioTemporalConditionModel`
(unets/unet_spatio_temporal_condition.py) and its blocks
(unets/unet_3d_blocks.py: `CrossAttnDownBlockSpatioTemporal`,
`DownBlockSpatioTemporal`, `UNetMidBlockSpatioTemporal`,
`UpBlockSpatioTemporal`, `CrossAttnUpBlockSpatioTemporal`;
resnet.py: `SpatioTemporalResBlock`, `TemporalResnetBlock`,
`AlphaBlender`; transformers/transformer_temporal.py:
`TransformerSpatioTemporalModel`; attention.py:
`TemporalBasicTransformerBlock`), the same functions as sgm's
`VideoUNet`, `VideoResBlock` and `SpatialVideoTransformer`
(Stability-AI/generative-models, scripts/sampling/configs/svd_xt.yaml).
Parameters are a flat dict under the diffusers state dict's names
(`down_blocks.0.resnets.0.spatial_res_block.conv1.weight`, ...), so a
checkpoint loads by name (diffusion/convert.py). Activations are
channels-last, frames flattened into the batch as the source does:

    x: (B, T, H, W, C)   [diffusers: (B, T, C, H, W)]

Every GroupNorm, attention, convolution and linear goes through the
`nnops` module (kernels N1 and L1 on the card, the `nn.*` spans). Every
temporal ResBlock, temporal transformer block and frame-position
embedding, with the blend that joins it to the spatial path, runs under
the span "svd.temporal".

Departures from the source:
  * No image-only frames: `AlphaBlender("learned_with_images")` takes
    sigmoid(mix_factor) everywhere (SVD's sampling passes an all-zero
    `image_only_indicator`); the mix factor's sigmoid is taken in float32.
  * The added time ids (fps id, motion bucket, noise augmentation) stay
    float32 into their sinusoid (diffusers casts them to the UNet's type
    first).
  * The temporal transformer's cross-attention attends every (frame,
    pixel) query of a video to that video's first-frame context at once
    instead of broadcasting the context over the pixels first: the same
    products.
  * GroupNorm eps as diffusers' blocks set it: 1e-6 in the down blocks with
    attention and in every up block, 1e-5 in the down block without
    attention and in the middle block (sgm's GroupNorm32 takes 1e-5
    throughout).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from guidedvd3dgs_tpu_torch.diffusion import nnops
from guidedvd3dgs_tpu_torch.utils.tracing import span

Params = dict

TEMPORAL = "svd.temporal"


@dataclass(frozen=True)
class STUNetConfig:
    """SVD-XT's unet/config.json under sgm's keys (svd_xt.yaml): widths
    model_channels * channel_mult = 320/640/1280/1280, heads of
    num_head_channels (5/10/20/20), attention at the levels whose
    downsampling factor is in attention_resolutions (all but the last)."""

    in_channels: int = 8
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    num_head_channels: int = 64
    transformer_depth: int = 1
    context_dim: int = 1024
    adm_in_channels: int = 768  # three added time ids, each an addition_time_embed_dim sinusoid
    addition_time_embed_dim: int = 256

    def widths(self):
        return [self.model_channels * m for m in self.channel_mult]

    def has_attention(self, level: int) -> bool:
        return 2 ** level in self.attention_resolutions

    def heads(self, ch: int) -> int:
        return ch // self.num_head_channels


def mlp_embedding(p: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """diffusers `TimestepEmbedding`: linear_2(silu(linear_1(x)))."""
    return nnops.linear(p, f"{prefix}.linear_2", nnops.silu(nnops.linear(p, f"{prefix}.linear_1", x)))


def blend(p: Params, prefix: str, x_spatial: torch.Tensor, x_temporal: torch.Tensor,
          switch: bool = False) -> torch.Tensor:
    """`AlphaBlender` with a learned factor: a * spatial + (1 - a) * temporal,
    a = sigmoid(mix_factor), or 1 - that with `switch`
    (switch_spatial_to_temporal_mix, the temporal decoder's)."""
    a = torch.sigmoid(p[f"{prefix}.mix_factor"].float())
    if switch:
        a = 1.0 - a
    a = a.to(x_spatial.dtype)
    return a * x_spatial + (1.0 - a) * x_temporal


def resnet2d(p: Params, prefix: str, x: torch.Tensor, emb: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """diffusers `ResnetBlock2D`. x: (N, H, W, C); emb: (N, E) or None."""
    h = nnops.conv2d(p, f"{prefix}.conv1", nnops.group_norm(p, f"{prefix}.norm1", x, eps=eps, silu=True))
    if emb is not None:
        h = h + nnops.linear(p, f"{prefix}.time_emb_proj", nnops.silu(emb))[:, None, None, :]
    h = nnops.conv2d(p, f"{prefix}.conv2", nnops.group_norm(p, f"{prefix}.norm2", h, eps=eps, silu=True))
    if f"{prefix}.conv_shortcut.weight" in p:
        x = nnops.conv2d(p, f"{prefix}.conv_shortcut", x, padding=0)
    return x + h


def temporal_resnet(p: Params, prefix: str, x: torch.Tensor, emb: Optional[torch.Tensor],
                    eps: float) -> torch.Tensor:
    """diffusers `TemporalResnetBlock`: (3, 1, 1) convolutions over the
    frames, GroupNorm over (T, H, W). x: (B, T, H, W, C); emb: (B, T, E)."""
    h = nnops.conv3d(p, f"{prefix}.conv1", nnops.group_norm(p, f"{prefix}.norm1", x, eps=eps, silu=True))
    if emb is not None:
        h = h + nnops.linear(p, f"{prefix}.time_emb_proj", nnops.silu(emb))[:, :, None, None, :]
    h = nnops.conv3d(p, f"{prefix}.conv2", nnops.group_norm(p, f"{prefix}.norm2", h, eps=eps, silu=True))
    return x + h


def st_res_block(p: Params, prefix: str, x: torch.Tensor, emb: Optional[torch.Tensor], batch: int,
                 eps: float, temporal_eps: Optional[float] = None, switch: bool = False) -> torch.Tensor:
    """diffusers `SpatioTemporalResBlock` (sgm `VideoResBlock`): the spatial
    ResBlock on every frame, the temporal one over the frames, blended.
    x: ((B T), H, W, C_in); emb: ((B T), E) or None."""
    h = resnet2d(p, f"{prefix}.spatial_res_block", x, emb, eps)
    bt, hh, ww, c = h.shape
    with span(TEMPORAL):
        hv = h.reshape(batch, bt // batch, hh, ww, c)
        e = None if emb is None else emb.reshape(batch, bt // batch, -1)
        tv = temporal_resnet(p, f"{prefix}.temporal_res_block", hv, e,
                             eps if temporal_eps is None else temporal_eps)
        return blend(p, f"{prefix}.time_mixer", hv, tv, switch).reshape(bt, hh, ww, c)


def attention_layer(p: Params, prefix: str, x: torch.Tensor, context: Optional[torch.Tensor],
                    heads: int) -> torch.Tensor:
    """diffusers `Attention` (no q/k/v bias, to_out with bias). x: (B, N,
    C); context: (B, M, C_ctx) or None (self-attention)."""
    ctx = x if context is None else context
    q = nnops.split_heads(nnops.linear(p, f"{prefix}.to_q", x), heads)
    k = nnops.split_heads(nnops.linear(p, f"{prefix}.to_k", ctx), heads)
    v = nnops.split_heads(nnops.linear(p, f"{prefix}.to_v", ctx), heads)
    out = nnops.attention(q, k, v, q.shape[-1] ** -0.5)
    return nnops.linear(p, f"{prefix}.to_out.0", nnops.merge_heads(out))


def feed_forward(p: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """diffusers `FeedForward` with GEGLU."""
    a, gate = nnops.linear(p, f"{prefix}.net.0.proj", x).chunk(2, dim=-1)
    return nnops.linear(p, f"{prefix}.net.2", a * nnops.gelu(gate))


def basic_block(p: Params, prefix: str, x: torch.Tensor, context: torch.Tensor, heads: int) -> torch.Tensor:
    """diffusers `BasicTransformerBlock`: self-attention, cross-attention to
    the frame's image embedding, GEGLU feed-forward. x: ((B T), HW, C)."""
    x = attention_layer(p, f"{prefix}.attn1", nnops.layer_norm(p, f"{prefix}.norm1", x), None, heads) + x
    x = attention_layer(p, f"{prefix}.attn2", nnops.layer_norm(p, f"{prefix}.norm2", x), context, heads) + x
    return feed_forward(p, f"{prefix}.ff", nnops.layer_norm(p, f"{prefix}.norm3", x)) + x


def temporal_block(p: Params, prefix: str, x: torch.Tensor, batch: int, time_context: torch.Tensor,
                   heads: int) -> torch.Tensor:
    """diffusers `TemporalBasicTransformerBlock` (its inner width the
    block's): a feed-forward in, self-attention over the T frames of each
    pixel, cross-attention to the video's first-frame context, GEGLU
    feed-forward. x: ((B T), S, C); time_context: (B, M, C_ctx)."""
    bt, s, c = x.shape
    t = bt // batch
    h = x.reshape(batch, t, s, c).permute(0, 2, 1, 3).reshape(batch * s, t, c)
    h = feed_forward(p, f"{prefix}.ff_in", nnops.layer_norm(p, f"{prefix}.norm_in", h)) + h
    h = attention_layer(p, f"{prefix}.attn1", nnops.layer_norm(p, f"{prefix}.norm1", h), None, heads) + h
    q = nnops.layer_norm(p, f"{prefix}.norm2", h).reshape(batch, s * t, c)
    h = attention_layer(p, f"{prefix}.attn2", q, time_context, heads).reshape(batch * s, t, c) + h
    h = feed_forward(p, f"{prefix}.ff", nnops.layer_norm(p, f"{prefix}.norm3", h)) + h
    return h.reshape(batch, s, t, c).permute(0, 2, 1, 3).reshape(bt, s, c)


def st_transformer(p: Params, prefix: str, x: torch.Tensor, context: torch.Tensor, batch: int, heads: int,
                   depth: int) -> torch.Tensor:
    """diffusers `TransformerSpatioTemporalModel` (sgm
    `SpatialVideoTransformer`). x: ((B T), H, W, C); context: ((B T), M,
    C_ctx), the image embedding repeated per frame."""
    bt, hh, ww, c = x.shape
    t = bt // batch
    h = nnops.group_norm(p, f"{prefix}.norm", x, eps=1e-6)
    h = nnops.linear(p, f"{prefix}.proj_in", h.reshape(bt, hh * ww, c))
    time_context = context[::t]  # each video's first frame
    with span(TEMPORAL):
        frames = torch.arange(t, device=x.device).repeat(batch)
        pos = mlp_embedding(p, f"{prefix}.time_pos_embed", nnops.timestep_embedding(frames, c).to(h.dtype))
    for d in range(depth):
        h = basic_block(p, f"{prefix}.transformer_blocks.{d}", h, context, heads)
        with span(TEMPORAL):
            hm = temporal_block(p, f"{prefix}.temporal_transformer_blocks.{d}", h + pos[:, None, :], batch,
                                time_context, heads)
            h = blend(p, f"{prefix}.time_mixer", h, hm)
    h = nnops.linear(p, f"{prefix}.proj_out", h)
    return h.reshape(bt, hh, ww, c) + x


def unet_st_apply(p: Params, cfg: STUNetConfig, x: torch.Tensor, timesteps: torch.Tensor,
                  context: torch.Tensor, added_time_ids: torch.Tensor) -> torch.Tensor:
    """The v prediction F(c_in x, c_noise). x: (B, T, H, W, in_channels)
    (the scaled latent and the conditioning latent on channels);
    timesteps: (B,) c_noise; context: (B, M, context_dim) the image
    embedding; added_time_ids: (B, 3). Returns (B, T, H, W, out_channels)."""
    b, t, hh, ww, _ = x.shape
    mc = cfg.model_channels
    emb = mlp_embedding(p, "time_embedding", nnops.timestep_embedding(timesteps, mc).to(x.dtype))
    ids = nnops.timestep_embedding(added_time_ids.flatten(), cfg.addition_time_embed_dim).reshape(b, -1)
    emb = emb + mlp_embedding(p, "add_embedding", ids.to(emb.dtype))
    emb = emb.repeat_interleave(t, dim=0)
    context = context.repeat_interleave(t, dim=0)

    h = nnops.conv2d(p, "conv_in", x.reshape(b * t, hh, ww, x.shape[-1]))
    skips = [h]
    widths = cfg.widths()
    n = len(widths)
    for i, ch in enumerate(widths):
        attn = cfg.has_attention(i)
        for j in range(cfg.num_res_blocks):
            h = st_res_block(p, f"down_blocks.{i}.resnets.{j}", h, emb, b, 1e-6 if attn else 1e-5)
            if attn:
                h = st_transformer(p, f"down_blocks.{i}.attentions.{j}", h, context, b, cfg.heads(ch),
                                   cfg.transformer_depth)
            skips.append(h)
        if i != n - 1:
            h = nnops.conv2d(p, f"down_blocks.{i}.downsamplers.0.conv", h, stride=2, padding=1)
            skips.append(h)

    h = st_res_block(p, "mid_block.resnets.0", h, emb, b, 1e-5)
    h = st_transformer(p, "mid_block.attentions.0", h, context, b, cfg.heads(widths[-1]), cfg.transformer_depth)
    h = st_res_block(p, "mid_block.resnets.1", h, emb, b, 1e-5)

    for i, ch in enumerate(reversed(widths)):
        level = n - 1 - i
        attn = cfg.has_attention(level)
        for j in range(cfg.num_res_blocks + 1):
            h = st_res_block(p, f"up_blocks.{i}.resnets.{j}", torch.cat([h, skips.pop()], dim=-1), emb, b, 1e-6)
            if attn:
                h = st_transformer(p, f"up_blocks.{i}.attentions.{j}", h, context, b, cfg.heads(ch),
                                   cfg.transformer_depth)
        if level != 0:
            h = nnops.conv2d(p, f"up_blocks.{i}.upsamplers.0.conv", nnops.upsample_nearest_2x(h))
    y = nnops.conv2d(p, "conv_out", nnops.group_norm(p, "conv_norm_out", h, eps=1e-5, silu=True))
    return y.reshape(b, t, hh, ww, cfg.out_channels)
