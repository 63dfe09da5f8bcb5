"""AutoencoderKL (first-stage VAE).

Counterpart of `guidedvd3dgs_tpu/diffusion/vae.py` (reference
lvdm/models/autoencoder.py:13-200, lvdm/modules/networks/ae_modules.py:
26-77 AttnBlock, :90-133 Down/Upsample with the asymmetric (0,1,0,1)
downsample padding, :151-210 ResnetBlock, :364-560 Encoder/Decoder).
Channels-last activations (B, H, W, C), torch-named flat parameters. The
guidedvd config: ch 128, ch_mult (1,2,4,4), 2 res blocks, no attention
resolutions (the mid block's attention only), z 4, double_z.

Beside it, Stable Video Diffusion's temporal decoder (`temporal_decode`:
diffusers `AutoencoderKLTemporalDecoder`'s `TemporalDecoder`, sgm's
`VideoDecoder`): the same KL-f8 encoder (SVD's encoder weights, renamed
to the names here by diffusion/convert.py), and a decoder whose ResBlocks
are spatio-temporal (`unet_st.st_res_block` with a learned blend and
switch_spatial_to_temporal_mix) and whose output passes a (3, 1, 1)
`time_conv_out` over the frames, so the frames decoded together are one
video: diffusers names (`decoder.mid_block.resnets.0...`), no
post_quant_conv. Its temporal parts run under the span "svd.temporal".
The mid-block attention (one head of 512 over h*w tokens) is diffusers'
`Attention` with its GroupNorm and residual.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from guidedvd3dgs_tpu_torch.diffusion import nnops
from guidedvd3dgs_tpu_torch.diffusion.unet_st import TEMPORAL, st_res_block
from guidedvd3dgs_tpu_torch.diffusion.nnops import (
    Params,
    attention,
    conv2d,
    group_norm,
    upsample_nearest_2x,
)
from guidedvd3dgs_tpu_torch.utils.tracing import span


@dataclass(frozen=True)
class VAEConfig:
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = ()
    in_channels: int = 3
    out_ch: int = 3
    z_channels: int = 4
    double_z: bool = True
    resolution: int = 256
    embed_dim: int = 4
    scale_factor: float = 0.18215


def _resnet_block(p: Params, prefix: str, x: torch.Tensor, in_ch: int, out_ch: int) -> torch.Tensor:
    h = conv2d(p, f"{prefix}.conv1", group_norm(p, f"{prefix}.norm1", x, eps=1e-6, silu=True))
    h = conv2d(p, f"{prefix}.conv2", group_norm(p, f"{prefix}.norm2", h, eps=1e-6, silu=True))
    if in_ch != out_ch:
        x = conv2d(p, f"{prefix}.nin_shortcut", x, padding=0)
    return x + h


def _attn_block(p: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """Single-head spatial self-attention (reference ae_modules.py:26-77);
    at full size 40*56 = 2240 tokens of 512 dims, which takes kernel L1."""
    b, hh, ww, c = x.shape
    h = group_norm(p, f"{prefix}.norm", x, eps=1e-6)
    q, k, v = (conv2d(p, f"{prefix}.{nm}", h, padding=0).reshape(b, 1, hh * ww, c)
               for nm in ("q", "k", "v"))
    out = attention(q, k, v, c ** -0.5).reshape(b, hh, ww, c)
    return x + conv2d(p, f"{prefix}.proj_out", out, padding=0)


def encoder_apply(p: Params, cfg: VAEConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, 3) -> moments (B, H/f, W/f, 2z), f = 2^(levels-1)."""
    n = len(cfg.ch_mult)
    in_mult = (1,) + tuple(cfg.ch_mult)
    curr_res = cfg.resolution
    h = conv2d(p, "conv_in", x)
    for i in range(n):
        block_in, block_out = cfg.ch * in_mult[i], cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks):
            h = _resnet_block(p, f"down.{i}.block.{j}", h, block_in, block_out)
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                h = _attn_block(p, f"down.{i}.attn.{j}", h)
        if i != n - 1:
            # asymmetric pad (top 0, bottom 1, left 0, right 1), stride-2 conv
            h = conv2d(p, f"down.{i}.downsample.conv", h, stride=2, padding=((0, 1), (0, 1)))
            curr_res //= 2
    ch = cfg.ch * cfg.ch_mult[-1]
    h = _resnet_block(p, "mid.block_1", h, ch, ch)
    h = _attn_block(p, "mid.attn_1", h)
    h = _resnet_block(p, "mid.block_2", h, ch, ch)
    return conv2d(p, "conv_out", group_norm(p, "norm_out", h, eps=1e-6, silu=True))


def decoder_apply(p: Params, cfg: VAEConfig, z: torch.Tensor) -> torch.Tensor:
    """z: (B, h, w, z_channels) -> (B, f*h, f*w, 3)."""
    n = len(cfg.ch_mult)
    block_in = cfg.ch * cfg.ch_mult[-1]
    h = conv2d(p, "conv_in", z)
    h = _resnet_block(p, "mid.block_1", h, block_in, block_in)
    h = _attn_block(p, "mid.attn_1", h)
    h = _resnet_block(p, "mid.block_2", h, block_in, block_in)
    for i in reversed(range(n)):
        block_out = cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks + 1):
            h = _resnet_block(p, f"up.{i}.block.{j}", h, block_in, block_out)
            block_in = block_out
        if i != 0:
            h = conv2d(p, f"up.{i}.upsample.conv", upsample_nearest_2x(h))
    return conv2d(p, "conv_out", group_norm(p, "norm_out", h, eps=1e-6, silu=True))


def _sub(p: Params, prefix: str) -> Params:
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def vae_encode_moments(p: Params, cfg: VAEConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, h, w, 2z) mean | logvar (reference autoencoder.py:59-63)."""
    return conv2d(p, "quant_conv", encoder_apply(_sub(p, "encoder."), cfg, x), padding=0)


def vae_encode(p: Params, cfg: VAEConfig, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The scale_factor-multiplied sampled latent mean + std * eps
    (reference ddpm3d.py:611-644): `eps` of the mean's shape when given,
    else standard normal noise from `generator`."""
    mean, logvar = vae_encode_moments(p, cfg, x).chunk(2, dim=-1)
    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype, device=mean.device)
    return cfg.scale_factor * (mean + std * eps.to(mean.dtype))


def vae_decode(p: Params, cfg: VAEConfig, z: torch.Tensor, unscale: bool = True) -> torch.Tensor:
    """(B, h, w, z) latent -> (B, H, W, 3) pixels (reference ddpm3d.py:646-675)."""
    if unscale:
        z = z / cfg.scale_factor
    return decoder_apply(_sub(p, "decoder."), cfg, conv2d(p, "post_quant_conv", z, padding=0))


@dataclass(frozen=True)
class TemporalDecoderConfig:
    """SVD-XT's vae/config.json decoder: block_out_channels (128, 256, 512,
    512), layers_per_block 2, latent 4, out 3, scaling factor 0.18215."""

    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    out_channels: int = 3
    scaling_factor: float = 0.18215


def _st_res(p: Params, prefix: str, h: torch.Tensor) -> torch.Tensor:
    """The decoder's SpatioTemporalResBlock: no time embedding, spatial eps
    1e-6, temporal eps 1e-5, learned blend with the switch."""
    return st_res_block(p, prefix, h, None, 1, 1e-6, temporal_eps=1e-5, switch=True)


def _mid_attention(p: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """diffusers `Attention(heads=1, dim_head=C, norm_num_groups=32,
    bias=True, residual_connection=True)` over the h*w tokens of a frame."""
    b, hh, ww, c = x.shape
    h = nnops.group_norm(p, f"{prefix}.group_norm", x, eps=1e-6).reshape(b, hh * ww, c)
    q, k, v = (nnops.linear(p, f"{prefix}.{nm}", h)[:, None] for nm in ("to_q", "to_k", "to_v"))
    out = nnops.attention(q, k, v, c ** -0.5)[:, 0]
    return nnops.linear(p, f"{prefix}.to_out.0", out).reshape(b, hh, ww, c) + x


def temporal_decoder_apply(p: Params, cfg: TemporalDecoderConfig, z: torch.Tensor) -> torch.Tensor:
    """diffusers `TemporalDecoder.forward` with num_frames = z.shape[0]: z
    (N, h, w, latent) the N frames of one video -> (N, f*h, f*w, 3)."""
    widths = tuple(cfg.block_out_channels)
    n = len(widths)
    h = nnops.conv2d(p, "conv_in", z)
    h = _st_res(p, "mid_block.resnets.0", h)
    h = _mid_attention(p, "mid_block.attentions.0", h)
    h = _st_res(p, "mid_block.resnets.1", h)
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            h = _st_res(p, f"up_blocks.{i}.resnets.{j}", h)
        if i != n - 1:
            h = nnops.conv2d(p, f"up_blocks.{i}.upsamplers.0.conv", upsample_nearest_2x(h))
    h = nnops.conv2d(p, "conv_out", nnops.group_norm(p, "conv_norm_out", h, eps=1e-6, silu=True))
    with span(TEMPORAL):
        return nnops.conv3d(p, "time_conv_out", h[None])[0]


def temporal_decode(p: Params, cfg: TemporalDecoderConfig, z: torch.Tensor, unscale: bool = True) -> torch.Tensor:
    """(N, h, w, 4) latents of N consecutive frames -> (N, H, W, 3) pixels,
    decoded together (diffusers `AutoencoderKLTemporalDecoder.decode` of
    one chunk)."""
    if unscale:
        z = z / cfg.scaling_factor
    return temporal_decoder_apply(_sub(p, "decoder."), cfg, z)
