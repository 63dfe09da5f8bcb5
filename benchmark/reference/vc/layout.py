"""The parameter layout of the diffusion stack: every torch-named key,
its shape and its kind (a weight drawn N(0, 0.02), a norm's one, a bias's
zero).

A frozen copy of the port's `diffusion/init.py` (counterpart of
`guidedvd3dgs_tpu/diffusion/init.py`: the checkpoint converter's key set
and shapes), which records each parameter instead of drawing it, so that
benchmark/inputs/vc_weights.py can draw all of a sub-model's weights in
one call on the card.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .unet3d import UNetConfig, build_layout

# key -> (shape, kind): kind "normal" (N(0, 0.02)), or the fill value
Layout = Dict[str, Tuple[tuple, object]]


class _Init:
    def __init__(self):
        self.p: Layout = {}

    def normal(self, shape):
        return (tuple(shape), "normal")

    def _fill(self, shape, value: float):
        return (tuple(shape), float(value))

    def linear(self, name, out_d, in_d, bias=True):
        self.p[f"{name}.weight"] = self.normal((out_d, in_d))
        if bias:
            self.p[f"{name}.bias"] = self._fill((out_d,), 0.0)

    def conv(self, name, out_c, in_c, kshape):
        self.p[f"{name}.weight"] = self.normal((out_c, in_c) + tuple(kshape))
        self.p[f"{name}.bias"] = self._fill((out_c,), 0.0)

    def conv2d(self, name, out_c, in_c, k=3):
        self.conv(name, out_c, in_c, (k, k))

    def norm(self, name, c):
        self.p[f"{name}.weight"] = self._fill((c,), 1.0)
        self.p[f"{name}.bias"] = self._fill((c,), 0.0)


def _attn_block(ini: _Init, pre: str, dim: int, ctx: int, image_cross: bool):
    for i in (1, 2, 3):
        ini.norm(f"{pre}.norm{i}", dim)
    for nm in ("q", "k", "v"):
        ini.linear(f"{pre}.attn1.to_{nm}", dim, dim, bias=False)
    ini.linear(f"{pre}.attn1.to_out.0", dim, dim)
    ini.linear(f"{pre}.attn2.to_q", dim, dim, bias=False)
    ini.linear(f"{pre}.attn2.to_k", dim, ctx, bias=False)
    ini.linear(f"{pre}.attn2.to_v", dim, ctx, bias=False)
    if image_cross:
        ini.linear(f"{pre}.attn2.to_k_ip", dim, ctx, bias=False)
        ini.linear(f"{pre}.attn2.to_v_ip", dim, ctx, bias=False)
    ini.linear(f"{pre}.attn2.to_out.0", dim, dim)
    ini.linear(f"{pre}.ff.net.0.proj", 8 * dim, dim)
    ini.linear(f"{pre}.ff.net.2", dim, 4 * dim)


def _spatial(ini: _Init, pre: str, ch: int, cfg: UNetConfig):
    ini.norm(f"{pre}.norm", ch)
    ini.linear(f"{pre}.proj_in", ch, ch)
    _attn_block(ini, f"{pre}.transformer_blocks.0", ch, cfg.context_dim, cfg.image_cross_attention)
    ini.linear(f"{pre}.proj_out", ch, ch)


def _temporal(ini: _Init, pre: str, ch: int, use_linear: bool = True, inner: int = 0):
    inner = inner or ch
    ini.norm(f"{pre}.norm", ch)
    if use_linear:
        ini.linear(f"{pre}.proj_in", inner, ch)
        ini.linear(f"{pre}.proj_out", ch, inner)
    else:
        ini.conv(f"{pre}.proj_in", inner, ch, (1,))
        ini.conv(f"{pre}.proj_out", ch, inner, (1,))
    # self-attention only: attn2's context is the query width
    _attn_block(ini, f"{pre}.transformer_blocks.0", inner, inner, False)


def _res(ini: _Init, pre: str, in_ch: int, out_ch: int, temb: int, temporal: bool):
    ini.norm(f"{pre}.in_layers.0", in_ch)
    ini.conv2d(f"{pre}.in_layers.2", out_ch, in_ch)
    ini.linear(f"{pre}.emb_layers.1", out_ch, temb)
    ini.norm(f"{pre}.out_layers.0", out_ch)
    ini.conv2d(f"{pre}.out_layers.3", out_ch, out_ch)
    if in_ch != out_ch:
        ini.conv2d(f"{pre}.skip_connection", out_ch, in_ch, k=1)
    if temporal:
        tc = f"{pre}.temopral_conv"
        ini.norm(f"{tc}.conv1.0", out_ch)
        ini.conv(f"{tc}.conv1.2", out_ch, out_ch, (3, 1, 1))
        for i in (2, 3, 4):
            ini.norm(f"{tc}.conv{i}.0", out_ch)
            ini.conv(f"{tc}.conv{i}.3", out_ch, out_ch, (3, 1, 1))


def init_unet_params(cfg: UNetConfig, ini: _Init) -> Layout:
    mc = cfg.model_channels
    temb = 4 * mc
    ini.linear("time_embed.0", temb, mc)
    ini.linear("time_embed.2", temb, temb)
    if cfg.fs_condition:
        ini.linear("fps_embedding.0", temb, mc)
        ini.linear("fps_embedding.2", temb, temb)
    input_blocks, middle, output_blocks = build_layout(cfg)
    ch = mc
    for kind, prefix, meta in [blk for layers in input_blocks for blk in layers] + middle + \
            [blk for layers in output_blocks for blk in layers]:
        if kind == "conv_in":
            ini.conv2d(prefix, mc, cfg.in_channels)
        elif kind == "res":
            _res(ini, prefix, meta["in_ch"], meta["out_ch"], temb, meta["temporal"])
            ch = meta["out_ch"]
        elif kind == "spatial":
            _spatial(ini, prefix, ch, cfg)
        elif kind == "temporal":
            _temporal(ini, prefix, ch)
        elif kind == "down":
            ini.conv2d(f"{prefix}.op", ch, ch)
        elif kind == "up":
            ini.conv2d(f"{prefix}.conv", ch, ch)
    if cfg.addition_attention:
        _temporal(ini, "init_attn.0", mc, use_linear=False, inner=8 * cfg.num_head_channels)
    ini.norm("out.0", mc)
    ini.conv2d("out.2", cfg.out_channels, mc)
    return ini.p


def init_vae_params(cfg, ini: _Init) -> Layout:
    def res(prefix, cin, cout):
        ini.norm(f"{prefix}.norm1", cin)
        ini.conv2d(f"{prefix}.conv1", cout, cin)
        ini.norm(f"{prefix}.norm2", cout)
        ini.conv2d(f"{prefix}.conv2", cout, cout)
        if cin != cout:
            ini.conv2d(f"{prefix}.nin_shortcut", cout, cin, k=1)

    def attn(prefix, c):
        ini.norm(f"{prefix}.norm", c)
        for nm in ("q", "k", "v", "proj_out"):
            ini.conv2d(f"{prefix}.{nm}", c, c, k=1)

    n = len(cfg.ch_mult)
    in_mult = (1,) + tuple(cfg.ch_mult)
    ini.conv2d("encoder.conv_in", cfg.ch, cfg.in_channels)
    for i in range(n):
        cin, cout = cfg.ch * in_mult[i], cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks):
            res(f"encoder.down.{i}.block.{j}", cin, cout)
            cin = cout
        if i != n - 1:
            ini.conv2d(f"encoder.down.{i}.downsample.conv", cout, cout)
    ch = cfg.ch * cfg.ch_mult[-1]
    res("encoder.mid.block_1", ch, ch)
    attn("encoder.mid.attn_1", ch)
    res("encoder.mid.block_2", ch, ch)
    ini.norm("encoder.norm_out", ch)
    zc = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
    ini.conv2d("encoder.conv_out", zc, ch)
    ini.conv2d("quant_conv", 2 * cfg.embed_dim, zc, k=1)
    ini.conv2d("post_quant_conv", cfg.z_channels, cfg.embed_dim, k=1)
    block_in = cfg.ch * cfg.ch_mult[-1]
    ini.conv2d("decoder.conv_in", block_in, cfg.z_channels)
    res("decoder.mid.block_1", block_in, block_in)
    attn("decoder.mid.attn_1", block_in)
    res("decoder.mid.block_2", block_in, block_in)
    for i in reversed(range(n)):
        block_out = cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks + 1):
            res(f"decoder.up.{i}.block.{j}", block_in, block_out)
            block_in = block_out
        if i != 0:
            ini.conv2d(f"decoder.up.{i}.upsample.conv", block_in, block_in)
    ini.norm("decoder.norm_out", block_in)
    ini.conv2d("decoder.conv_out", cfg.out_ch, block_in)
    return ini.p


def _clip_resblocks(ini: _Init, width: int, layers: int):
    for i in range(layers):
        pre = f"transformer.resblocks.{i}"
        ini.norm(f"{pre}.ln_1", width)
        ini.norm(f"{pre}.ln_2", width)
        ini.p[f"{pre}.attn.in_proj_weight"] = ini.normal((3 * width, width))
        ini.p[f"{pre}.attn.in_proj_bias"] = ini._fill((3 * width,), 0.0)
        ini.linear(f"{pre}.attn.out_proj", width, width)
        ini.linear(f"{pre}.mlp.c_fc", 4 * width, width)
        ini.linear(f"{pre}.mlp.c_proj", width, 4 * width)


def init_clip_text_params(cfg, ini: _Init) -> Layout:
    ini.p["token_embedding.weight"] = ini.normal((cfg.vocab_size, cfg.width))
    ini.p["positional_embedding"] = ini.normal((cfg.context_length, cfg.width))
    _clip_resblocks(ini, cfg.width, cfg.layers)
    ini.norm("ln_final", cfg.width)
    return ini.p


def init_clip_image_params(cfg, ini: _Init) -> Layout:
    grid = cfg.image_size // cfg.patch_size
    ini.p["conv1.weight"] = ini.normal((cfg.width, 3, cfg.patch_size, cfg.patch_size))
    ini.p["class_embedding"] = ini.normal((cfg.width,))
    ini.p["positional_embedding"] = ini.normal((grid * grid + 1, cfg.width))
    ini.norm("ln_pre", cfg.width)
    _clip_resblocks(ini, cfg.width, cfg.layers)
    return ini.p


def init_resampler_params(cfg, ini: _Init) -> Layout:
    inner = cfg.dim_head * cfg.heads
    ini.p["latents"] = ini.normal((1, cfg.num_queries * cfg.video_length, cfg.dim))
    ini.linear("proj_in", cfg.dim, cfg.embedding_dim)
    for d in range(cfg.depth):
        a = f"layers.{d}.0"
        ini.norm(f"{a}.norm1", cfg.dim)
        ini.norm(f"{a}.norm2", cfg.dim)
        ini.linear(f"{a}.to_q", inner, cfg.dim, bias=False)
        ini.linear(f"{a}.to_kv", 2 * inner, cfg.dim, bias=False)
        ini.linear(f"{a}.to_out", cfg.dim, inner, bias=False)
        f = f"layers.{d}.1"
        ini.norm(f"{f}.0", cfg.dim)
        ini.linear(f"{f}.1", cfg.dim * cfg.ff_mult, cfg.dim, bias=False)
        ini.linear(f"{f}.3", cfg.dim, cfg.dim * cfg.ff_mult, bias=False)
    ini.linear("proj_out", cfg.output_dim, cfg.dim)
    ini.norm("norm_out", cfg.output_dim)
    return ini.p


def diffusion_layout(unet_cfg, vae_cfg, resampler_cfg, text_cfg, vision_cfg) -> Tuple[Layout, ...]:
    """The five sub-models' layouts, in DiffusionParams' order (unet, vae,
    resampler, clip_text, clip_image)."""
    parts = ((init_unet_params, unet_cfg), (init_vae_params, vae_cfg), (init_resampler_params, resampler_cfg),
             (init_clip_text_params, text_cfg), (init_clip_image_params, vision_cfg))
    return tuple(fn(cfg, _Init()) for fn, cfg in parts)
