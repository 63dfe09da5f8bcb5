"""Video diffusion UNet.

Counterpart of `guidedvd3dgs_tpu/diffusion/unet3d.py` (reference
lvdm/modules/networks/openaimodel3d.py:281-602): ResBlocks with temporal
conv blocks, spatial transformers with image cross-attention, temporal
transformers over the frames, fps conditioning and the init temporal
transformer. Parameters are a flat torch-named dict; activations are
channels-last at the public function:

    x: (B, T, H, W, C)   [reference torch: (B, C, T, H, W)]

The block layout is computed from the config as the reference constructor
does (openaimodel3d.py:383-545), so that prefixes like "input_blocks.4.1"
match the checkpoint.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from guidedvd3dgs_tpu_torch.diffusion.attention import spatial_transformer, temporal_transformer
from guidedvd3dgs_tpu_torch.diffusion.nnops import (
    Params,
    conv2d,
    conv3d,
    group_norm,
    linear,
    silu,
    timestep_embedding,
    upsample_nearest_2x,
)


@dataclass(frozen=True)
class UNetConfig:
    """configs/inference_pvd_1024.yaml unet_config params."""

    in_channels: int = 8
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_head_channels: int = 64
    transformer_depth: int = 1
    context_dim: int = 1024
    use_linear: bool = True
    temporal_conv: bool = True
    temporal_attention: bool = True
    use_relative_position: bool = False
    temporal_length: int = 16
    addition_attention: bool = True
    image_cross_attention: bool = True
    default_fs: int = 10
    fs_condition: bool = True
    text_context_len: int = 77
    image_tokens_per_frame: int = 16


# block descriptors: (kind, prefix, meta)
Block = Tuple[str, str, dict]


def build_layout(cfg: UNetConfig):
    """(input_blocks, middle, output_blocks) descriptor lists with the
    checkpoint's prefixes (reference openaimodel3d.py:383-545)."""
    mc = cfg.model_channels

    def heads_dims(ch):
        return dict(heads=ch // cfg.num_head_channels, dim_head=cfg.num_head_channels)

    input_blocks: List[List[Block]] = [[("conv_in", "input_blocks.0.0", {})]]
    input_chans = [mc]
    ch, ds = mc, 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            idx = len(input_blocks)
            layers: List[Block] = [("res", f"input_blocks.{idx}.0",
                                    dict(in_ch=ch, out_ch=mult * mc, temporal=cfg.temporal_conv))]
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                layers.append(("spatial", f"input_blocks.{idx}.1", heads_dims(ch)))
                if cfg.temporal_attention:
                    layers.append(("temporal", f"input_blocks.{idx}.2", heads_dims(ch)))
            input_blocks.append(layers)
            input_chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            idx = len(input_blocks)
            input_blocks.append([("down", f"input_blocks.{idx}.0", {})])
            input_chans.append(ch)
            ds *= 2

    middle: List[Block] = [
        ("res", "middle_block.0", dict(in_ch=ch, out_ch=ch, temporal=cfg.temporal_conv)),
        ("spatial", "middle_block.1", heads_dims(ch)),
    ]
    mi = 2
    if cfg.temporal_attention:
        middle.append(("temporal", f"middle_block.{mi}", heads_dims(ch)))
        mi += 1
    middle.append(("res", f"middle_block.{mi}", dict(in_ch=ch, out_ch=ch, temporal=cfg.temporal_conv)))

    output_blocks: List[List[Block]] = []
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = input_chans.pop()
            idx = len(output_blocks)
            layers = [("res", f"output_blocks.{idx}.0",
                       dict(in_ch=ch + ich, out_ch=mult * mc, temporal=cfg.temporal_conv))]
            ch = mult * mc
            li = 1
            if ds in cfg.attention_resolutions:
                layers.append(("spatial", f"output_blocks.{idx}.{li}", heads_dims(ch)))
                li += 1
                if cfg.temporal_attention:
                    layers.append(("temporal", f"output_blocks.{idx}.{li}", heads_dims(ch)))
                    li += 1
            if level and i == cfg.num_res_blocks:
                layers.append(("up", f"output_blocks.{idx}.{li}", {}))
                ds //= 2
            output_blocks.append(layers)

    return input_blocks, middle, output_blocks


def temporal_conv_block(p: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """The identity-initialised 3D conv stack (reference openaimodel3d.py:239-279).
    x: (B, T, H, W, C); kernels (3, 1, 1), padding (1, 0, 0)."""
    h = conv3d(p, f"{prefix}.conv1.2", group_norm(p, f"{prefix}.conv1.0", x, silu=True))
    for i in (2, 3, 4):
        h = conv3d(p, f"{prefix}.conv{i}.3", group_norm(p, f"{prefix}.conv{i}.0", h, silu=True))
    return x + h


def res_block(p: Params, prefix: str, x: torch.Tensor, emb: torch.Tensor, in_ch: int, out_ch: int,
              temporal: bool, batch: int) -> torch.Tensor:
    """reference openaimodel3d.py:210-237. x: ((B T), H, W, C); emb: ((B T), E)."""
    h = conv2d(p, f"{prefix}.in_layers.2", group_norm(p, f"{prefix}.in_layers.0", x, silu=True))
    h = h + linear(p, f"{prefix}.emb_layers.1", silu(emb))[:, None, None, :]
    h = conv2d(p, f"{prefix}.out_layers.3", group_norm(p, f"{prefix}.out_layers.0", h, silu=True))
    if out_ch == in_ch:
        skip = x
    else:
        k1 = p[f"{prefix}.skip_connection.weight"].shape[-1] == 1
        skip = conv2d(p, f"{prefix}.skip_connection", x, padding=0 if k1 else 1)
    h = skip + h
    if temporal:
        bt, hh, ww, c = h.shape
        # the checkpoint's key keeps the upstream typo "temopral_conv"
        hv = temporal_conv_block(p, f"{prefix}.temopral_conv", h.reshape(batch, bt // batch, hh, ww, c))
        h = hv.reshape(bt, hh, ww, c)
    return h


def _temporal(p: Params, prefix: str, h: torch.Tensor, batch: int, heads: int, dim_head: int,
              cfg: UNetConfig, use_linear: bool) -> torch.Tensor:
    bt, hh, ww, c = h.shape
    hv = temporal_transformer(p, prefix, h.reshape(batch, bt // batch, hh, ww, c), heads, dim_head,
                              depth=cfg.transformer_depth, use_linear=use_linear,
                              relative_position=cfg.use_relative_position,
                              temporal_length=cfg.temporal_length)
    return hv.reshape(bt, hh, ww, c)


def _apply_layers(p: Params, layers: List[Block], h: torch.Tensor, emb: torch.Tensor,
                  context: torch.Tensor, cfg: UNetConfig, batch: int) -> torch.Tensor:
    for kind, prefix, meta in layers:
        if kind == "conv_in":
            h = conv2d(p, prefix, h)
        elif kind == "res":
            h = res_block(p, prefix, h, emb, meta["in_ch"], meta["out_ch"], meta["temporal"], batch)
        elif kind == "spatial":
            h = spatial_transformer(p, prefix, h, context, meta["heads"], meta["dim_head"],
                                    depth=cfg.transformer_depth, use_linear=cfg.use_linear,
                                    image_cross_attention=cfg.image_cross_attention)
        elif kind == "temporal":
            h = _temporal(p, prefix, h, batch, meta["heads"], meta["dim_head"], cfg, cfg.use_linear)
        elif kind == "down":
            h = conv2d(p, f"{prefix}.op", h, stride=2, padding=1)
        elif kind == "up":
            h = conv2d(p, f"{prefix}.conv", upsample_nearest_2x(h))
        else:
            raise ValueError(kind)
    return h


def unet_apply(p: Params, cfg: UNetConfig, x: torch.Tensor, timesteps: torch.Tensor,
               context: torch.Tensor, fs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """reference openaimodel3d.py:548-601. x: (B, T, H, W, C_in);
    timesteps: (B,); context: (B, 77 [+ T*16], context_dim); fs: (B,) int.
    Returns (B, T, H, W, out_channels)."""
    b, t, hh, ww, _ = x.shape
    emb = linear(p, "time_embed.2",
                 silu(linear(p, "time_embed.0", timestep_embedding(timesteps, cfg.model_channels).to(x.dtype))))

    # the per-frame image-token split (reference :555-563, hard-coded 77 + t*16)
    if context.shape[1] == cfg.text_context_len + t * cfg.image_tokens_per_frame:
        ctx_text = context[:, : cfg.text_context_len].repeat_interleave(t, dim=0)
        ctx_img = context[:, cfg.text_context_len:].reshape(b * t, cfg.image_tokens_per_frame, -1)
        context = torch.cat([ctx_text, ctx_img], dim=1)
    else:
        context = context.repeat_interleave(t, dim=0)
    emb = emb.repeat_interleave(t, dim=0)

    if cfg.fs_condition:
        if fs is None:
            fs = torch.full((b,), cfg.default_fs, dtype=torch.int64, device=x.device)
        fs_emb = timestep_embedding(fs, cfg.model_channels).to(x.dtype)
        fs_embed = linear(p, "fps_embedding.2", silu(linear(p, "fps_embedding.0", fs_emb)))
        emb = emb + fs_embed.repeat_interleave(t, dim=0)

    h = x.reshape(b * t, hh, ww, x.shape[-1])
    input_blocks, middle, output_blocks = build_layout(cfg)
    hs = []
    for i, layers in enumerate(input_blocks):
        h = _apply_layers(p, layers, h, emb, context, cfg, b)
        if i == 0 and cfg.addition_attention:
            # init_attn: a temporal transformer with conv1d projections
            # (reference :389-400; use_linear defaults to False there)
            h = _temporal(p, "init_attn.0", h, b, 8, cfg.num_head_channels, cfg, False)
        hs.append(h)
    h = _apply_layers(p, middle, h, emb, context, cfg, b)
    for layers in output_blocks:
        h = _apply_layers(p, layers, torch.cat([h, hs.pop()], dim=-1), emb, context, cfg, b)
    y = conv2d(p, "out.2", group_norm(p, "out.0", h, silu=True))
    return y.reshape(b, t, hh, ww, cfg.out_channels)
