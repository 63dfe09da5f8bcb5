"""AutoencoderKL (first-stage VAE).

Counterpart of `guidedvd3dgs_tpu/diffusion/vae.py` (reference
lvdm/models/autoencoder.py:13-200, lvdm/modules/networks/ae_modules.py:
26-77 AttnBlock, :90-133 Down/Upsample with the asymmetric (0,1,0,1)
downsample padding, :151-210 ResnetBlock, :364-560 Encoder/Decoder).
Channels-last activations (B, H, W, C), torch-named flat parameters. The
guidedvd config: ch 128, ch_mult (1,2,4,4), 2 res blocks, no attention
resolutions (the mid block's attention only), z 4, double_z.

The plain reference's frozen copy of the port's module: under autograd
each level of the decoder is recomputed in the backward (activation
checkpointing); the values are the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.utils.checkpoint

from .nnops import (
    Params,
    attention,
    conv2d,
    group_norm,
    recompute,
    silu,
    upsample_nearest_2x,
)


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
    h = conv2d(p, f"{prefix}.conv1", silu(group_norm(p, f"{prefix}.norm1", x, eps=1e-6)))
    h = conv2d(p, f"{prefix}.conv2", silu(group_norm(p, f"{prefix}.norm2", h, eps=1e-6)))
    if in_ch != out_ch:
        x = conv2d(p, f"{prefix}.nin_shortcut", x, padding=0)
    return x + h


def _attn_block(p: Params, prefix: str, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Single-head spatial self-attention (reference ae_modules.py:26-77);
    at full size 40*56 = 2240 tokens of 512 dims, which takes kernel L1
    (its plain version with `plain`)."""
    b, hh, ww, c = x.shape
    h = group_norm(p, f"{prefix}.norm", x, eps=1e-6)
    q, k, v = (conv2d(p, f"{prefix}.{nm}", h, padding=0).reshape(b, 1, hh * ww, c)
               for nm in ("q", "k", "v"))
    out = attention(q, k, v, c ** -0.5, plain=plain).reshape(b, hh, ww, c)
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
    return conv2d(p, "conv_out", silu(group_norm(p, "norm_out", h, eps=1e-6)))


def _up_level(p: Params, i: int, h: torch.Tensor, block_in: int, block_out: int,
              num_res_blocks: int) -> torch.Tensor:
    for j in range(num_res_blocks + 1):
        h = _resnet_block(p, f"up.{i}.block.{j}", h, block_in, block_out)
        block_in = block_out
    if i != 0:
        h = conv2d(p, f"up.{i}.upsample.conv", upsample_nearest_2x(h))
    return h


def _level(fn, p: Params, *args) -> torch.Tensor:
    """fn(p, *args), recomputed in the backward where a gradient flows."""
    if recompute(args[1]):
        return torch.utils.checkpoint.checkpoint(fn, p, *args, use_reentrant=False)
    return fn(p, *args)


def decoder_apply(p: Params, cfg: VAEConfig, z: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """z: (B, h, w, z_channels) -> (B, f*h, f*w, 3)."""
    n = len(cfg.ch_mult)
    block_in = cfg.ch * cfg.ch_mult[-1]
    h = conv2d(p, "conv_in", z)
    h = _resnet_block(p, "mid.block_1", h, block_in, block_in)
    h = _attn_block(p, "mid.attn_1", h, plain)
    h = _resnet_block(p, "mid.block_2", h, block_in, block_in)
    for i in reversed(range(n)):
        block_out = cfg.ch * cfg.ch_mult[i]
        h = _level(_up_level, p, i, h, block_in, block_out, cfg.num_res_blocks)
        block_in = block_out
    return conv2d(p, "conv_out", silu(group_norm(p, "norm_out", h, eps=1e-6)))


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


def vae_decode(p: Params, cfg: VAEConfig, z: torch.Tensor, unscale: bool = True,
               plain: bool = False) -> torch.Tensor:
    """(B, h, w, z) latent -> (B, H, W, 3) pixels (reference ddpm3d.py:646-675)."""
    if unscale:
        z = z / cfg.scale_factor
    return decoder_apply(_sub(p, "decoder."), cfg, conv2d(p, "post_quant_conv", z, padding=0), plain)
