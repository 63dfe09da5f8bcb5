"""Plain reference of Stable Video Diffusion XT (image-to-video) as a guided
video prior, in float32 PyTorch alone (torch and numpy; nothing of the
port or of JAX).

Written after diffusers, module for module and in its NCHW layout, under
its state-dict names: `UNetSpatioTemporalConditionModel` with
`SpatioTemporalResBlock`, `TemporalResnetBlock`, `AlphaBlender`,
`TransformerSpatioTemporalModel`, `BasicTransformerBlock`,
`TemporalBasicTransformerBlock`; `AutoencoderKLTemporalDecoder` (the KL-f8
`Encoder`, `TemporalDecoder`); transformers' `CLIPVisionModelWithProjection`
(`image_embeds`); `EulerDiscreteScheduler` with SVD-XT's
scheduler_config.json (Karras sigmas 700 -> 0.002, rho 7, v-prediction,
c_noise = 0.25 ln sigma, s_churn 0) and the pipeline's per-frame linear
CFG (1 -> 3 over the frames). Then the guided step of the port's guided
sampler as an Euler EDM step (the paper's Algorithm 1 on D(x)): the CFG
pair at batch 2, D and the Euler update, the guidance loss's gradient
through the temporal decode of each chunk of `decode_chunk` frames, the
pair's VJP (the CFG combination, then each branch at batch 1), and the
adaptive step rho = RMS(s_f (D_cond - D_uncond)) / RMS(dL/dx) * rho_scale
* w.

Every public function computes with TF32 off (`torch.backends.cuda.matmul.
allow_tf32` and `torch.backends.cudnn.allow_tf32` False) and restores the
flags after. Under autograd each UNet block and each decoder level is
recomputed in the backward (activation checkpointing), so that a float32
VJP at full width fits on one card; `no_recompute()` turns that off (to
count operations once). `lowered(dtype)` rounds every linear and
convolution input and weight to `dtype` (float8: per-tensor scaled), the
control one precision below a bfloat16 configuration. Attention is the
explicit softmax(q k^T / sqrt(d)) v with the softmax in float32.

A configuration is the benchmark's JSON dict (benchmark/configs/svd-xt.json):
"unet" under sgm's keys, "vae" the encoder's, "decoder", "clip_vision".
The CLIP resize to 224x224 is torch's antialiased bicubic (align_corners
False); the added time ids and the mix factors' sigmoids stay float32.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
FP8_MAX = 448.0
_STATE = {"low": None, "recompute": True}


def f32_exact(fn):
    """fn with TF32 off for its duration."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

    return run


@contextlib.contextmanager
def lowered(dtype):
    prev = _STATE["low"]
    _STATE["low"] = dtype
    try:
        yield
    finally:
        _STATE["low"] = prev


@contextlib.contextmanager
def no_recompute():
    prev = _STATE["recompute"]
    _STATE["recompute"] = False
    try:
        yield
    finally:
        _STATE["recompute"] = prev


def _ckpt(fn, *args):
    if _STATE["recompute"] and torch.is_grad_enabled() and any(
            torch.is_tensor(a) and a.requires_grad for a in args):
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _round(t: torch.Tensor, dtype) -> torch.Tensor:
    with torch.no_grad():
        s = t.abs().amax().float().clamp(min=1e-30) / FP8_MAX
        q = ((t.float() / s).to(dtype).float() * s).to(t.dtype)
    return t + (q - t).detach() if t.requires_grad else q


# ---------------------------------------------------------------- layers

def linear(p, name, x):
    w = p[f"{name}.weight"].to(x.dtype)
    b = p.get(f"{name}.bias")
    if _STATE["low"] is not None:
        x, w = _round(x, _STATE["low"]), _round(w, _STATE["low"])
    return F.linear(x, w, None if b is None else b.to(x.dtype))


def conv(p, name, x, stride=1, padding=1):
    """Conv2d or Conv3d by the weight's rank."""
    w = p[f"{name}.weight"].to(x.dtype)
    b = p[f"{name}.bias"].to(x.dtype) if f"{name}.bias" in p else None
    if _STATE["low"] is not None:
        x, w = _round(x, _STATE["low"]), _round(w, _STATE["low"])
    fn = F.conv3d if w.dim() == 5 else F.conv2d
    return fn(x, w, b, stride=stride, padding=padding)


def gn(p, name, x, eps):
    return F.group_norm(x.float(), 32, p[f"{name}.weight"].float(), p[f"{name}.bias"].float(), eps).to(x.dtype)


def ln(p, name, x, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"].to(x.dtype), p[f"{name}.bias"].to(x.dtype), eps)


def sinusoid(t, dim):
    """diffusers get_timestep_embedding(flip_sin_to_cos=True,
    downscale_freq_shift=0): [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    e = t.float()[:, None] * freqs[None]
    e = torch.cat([torch.sin(e), torch.cos(e)], dim=-1)
    return torch.cat([e[:, half:], e[:, :half]], dim=-1)


def mlp_embed(p, pre, x):
    return linear(p, f"{pre}.linear_2", F.silu(linear(p, f"{pre}.linear_1", x)))


def softmax_attention(q, k, v, heads):
    """q (B, N, C), k, v (B, M, C) -> (B, N, C); the batch in chunks of at
    most 2^28 logits."""
    b, n, c = q.shape
    d = c // heads
    chunk = max(1, 2 ** 28 // (heads * n * k.shape[1]))
    outs = []
    for i in range(0, b, chunk):
        qh, kh, vh = (t[i:i + chunk].reshape(t[i:i + chunk].shape[0], t.shape[1], heads, d).transpose(1, 2)
                      for t in (q, k, v))
        sim = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * d ** -0.5
        o = torch.matmul(sim.softmax(dim=-1).to(vh.dtype), vh)
        outs.append(o.transpose(1, 2).reshape(o.shape[0], n, c))
    return torch.cat(outs)


def attn(p, pre, x, ctx, heads):
    ctx = x if ctx is None else ctx
    o = softmax_attention(linear(p, f"{pre}.to_q", x), linear(p, f"{pre}.to_k", ctx), linear(p, f"{pre}.to_v", ctx),
                          heads)
    return linear(p, f"{pre}.to_out.0", o)


def geglu_ff(p, pre, x):
    a, g = linear(p, f"{pre}.net.0.proj", x).chunk(2, dim=-1)
    return linear(p, f"{pre}.net.2", a * F.gelu(g))


def mix(p, pre, spatial, temporal, switch):
    a = torch.sigmoid(p[f"{pre}.mix_factor"].float())
    if switch:
        a = 1.0 - a
    a = a.to(spatial.dtype)
    return a * spatial + (1.0 - a) * temporal


# ---------------------------------------------------------------- UNet

def resnet2d(p, pre, x, temb, eps):
    h = conv(p, f"{pre}.conv1", F.silu(gn(p, f"{pre}.norm1", x, eps)))
    if temb is not None:
        h = h + linear(p, f"{pre}.time_emb_proj", F.silu(temb))[:, :, None, None]
    h = conv(p, f"{pre}.conv2", F.silu(gn(p, f"{pre}.norm2", h, eps)))
    if f"{pre}.conv_shortcut.weight" in p:
        x = conv(p, f"{pre}.conv_shortcut", x, padding=0)
    return x + h


def temporal_resnet(p, pre, x, temb, eps):
    """x (B, C, T, H, W); temb (B, T, E) or None."""
    h = conv(p, f"{pre}.conv1", F.silu(gn(p, f"{pre}.norm1", x, eps)), padding=(1, 0, 0))
    if temb is not None:
        h = h + linear(p, f"{pre}.time_emb_proj", F.silu(temb)).permute(0, 2, 1)[:, :, :, None, None]
    h = conv(p, f"{pre}.conv2", F.silu(gn(p, f"{pre}.norm2", h, eps)), padding=(1, 0, 0))
    return x + h


def st_resnet(p, pre, x, temb, frames, eps, teps, switch):
    """SpatioTemporalResBlock on ((B T), C, H, W)."""
    x = resnet2d(p, f"{pre}.spatial_res_block", x, temb, eps)
    bt, c, h, w = x.shape
    xs = x.reshape(bt // frames, frames, c, h, w).permute(0, 2, 1, 3, 4)
    tt = None if temb is None else temb.reshape(bt // frames, frames, -1)
    xt = temporal_resnet(p, f"{pre}.temporal_res_block", xs, tt, teps)
    return mix(p, f"{pre}.time_mixer", xs, xt, switch).permute(0, 2, 1, 3, 4).reshape(bt, c, h, w)


def basic_block(p, pre, x, ctx, heads):
    x = attn(p, f"{pre}.attn1", ln(p, f"{pre}.norm1", x), None, heads) + x
    x = attn(p, f"{pre}.attn2", ln(p, f"{pre}.norm2", x), ctx, heads) + x
    return geglu_ff(p, f"{pre}.ff", ln(p, f"{pre}.norm3", x)) + x


def temporal_basic_block(p, pre, x, frames, time_ctx, heads):
    """x ((B T), S, C); time_ctx ((B S), M, C_ctx)."""
    bt, s, c = x.shape
    b = bt // frames
    x = x.reshape(b, frames, s, c).permute(0, 2, 1, 3).reshape(b * s, frames, c)
    x = geglu_ff(p, f"{pre}.ff_in", ln(p, f"{pre}.norm_in", x)) + x
    x = attn(p, f"{pre}.attn1", ln(p, f"{pre}.norm1", x), None, heads) + x
    x = attn(p, f"{pre}.attn2", ln(p, f"{pre}.norm2", x), time_ctx, heads) + x
    x = geglu_ff(p, f"{pre}.ff", ln(p, f"{pre}.norm3", x)) + x
    return x.reshape(b, s, frames, c).permute(0, 2, 1, 3).reshape(bt, s, c)


def st_transformer(p, pre, x, ctx, frames, heads, depth):
    """TransformerSpatioTemporalModel on ((B T), C, H, W); ctx ((B T), M, C_ctx)."""
    bt, c, h, w = x.shape
    b = bt // frames
    first = ctx.reshape(b, frames, ctx.shape[1], ctx.shape[2])[:, 0]
    time_ctx = first[:, None].expand(b, h * w, ctx.shape[1], ctx.shape[2]).reshape(b * h * w, ctx.shape[1], -1)
    hs = gn(p, f"{pre}.norm", x, 1e-6).permute(0, 2, 3, 1).reshape(bt, h * w, c)
    hs = linear(p, f"{pre}.proj_in", hs)
    pos = mlp_embed(p, f"{pre}.time_pos_embed",
                    sinusoid(torch.arange(frames, device=x.device).repeat(b), c).to(hs.dtype))[:, None]
    for d in range(depth):
        hs = basic_block(p, f"{pre}.transformer_blocks.{d}", hs, ctx, heads)
        hm = temporal_basic_block(p, f"{pre}.temporal_transformer_blocks.{d}", hs + pos, frames, time_ctx, heads)
        hs = mix(p, f"{pre}.time_mixer", hs, hm, False)
    hs = linear(p, f"{pre}.proj_out", hs).reshape(bt, h, w, c).permute(0, 3, 1, 2)
    return hs + x


def _widths(u):
    return [u["model_channels"] * m for m in u["channel_mult"]]


def _has_attn(u, level):
    return 2 ** level in u["attention_resolutions"]


@f32_exact
def unet_forward(p, u: dict, sample, timesteps, ctx, time_ids):
    """sample (B, T, C_in, H, W); timesteps (B,) c_noise; ctx (B, M, C_ctx);
    time_ids (B, 3) -> (B, T, C_out, H, W)."""
    b, frames = sample.shape[:2]
    dt = sample.dtype
    emb = mlp_embed(p, "time_embedding", sinusoid(timesteps, u["model_channels"]).to(dt))
    aug = sinusoid(time_ids.flatten(), u["addition_time_embed_dim"]).reshape(b, -1).to(dt)
    emb = (emb + mlp_embed(p, "add_embedding", aug)).repeat_interleave(frames, dim=0)
    ctx = ctx.repeat_interleave(frames, dim=0)
    x = conv(p, "conv_in", sample.flatten(0, 1))
    res = [x]
    widths = _widths(u)
    n, depth = len(widths), u["transformer_depth"]

    def resblock(pre, eps):
        return lambda h, e: st_resnet(p, pre, h, e, frames, eps, eps, False)

    def transformer(pre, ch):
        return lambda h, c: st_transformer(p, pre, h, c, frames, ch // u["num_head_channels"], depth)

    for i, ch in enumerate(widths):
        a = _has_attn(u, i)
        for j in range(u["num_res_blocks"]):
            x = _ckpt(resblock(f"down_blocks.{i}.resnets.{j}", 1e-6 if a else 1e-5), x, emb)
            if a:
                x = _ckpt(transformer(f"down_blocks.{i}.attentions.{j}", ch), x, ctx)
            res.append(x)
        if i < n - 1:
            x = conv(p, f"down_blocks.{i}.downsamplers.0.conv", x, stride=2, padding=1)
            res.append(x)
    x = _ckpt(resblock("mid_block.resnets.0", 1e-5), x, emb)
    x = _ckpt(transformer("mid_block.attentions.0", widths[-1]), x, ctx)
    x = _ckpt(resblock("mid_block.resnets.1", 1e-5), x, emb)
    for i, ch in enumerate(widths[::-1]):
        level = n - 1 - i
        for j in range(u["num_res_blocks"] + 1):
            x = _ckpt(resblock(f"up_blocks.{i}.resnets.{j}", 1e-6), torch.cat([x, res.pop()], dim=1), emb)
            if _has_attn(u, level):
                x = _ckpt(transformer(f"up_blocks.{i}.attentions.{j}", ch), x, ctx)
        if level > 0:
            x = conv(p, f"up_blocks.{i}.upsamplers.0.conv", F.interpolate(x, scale_factor=2.0, mode="nearest"))
    x = conv(p, "conv_out", F.silu(gn(p, "conv_norm_out", x, 1e-5)))
    return x.reshape(b, frames, *x.shape[1:])


# ---------------------------------------------------------------- VAE

def vae_attention(p, pre, x):
    """diffusers Attention(heads=1, norm_num_groups=32, residual_connection)."""
    b, c, h, w = x.shape
    hs = gn(p, f"{pre}.group_norm", x, 1e-6).reshape(b, c, h * w).transpose(1, 2)
    o = softmax_attention(linear(p, f"{pre}.to_q", hs), linear(p, f"{pre}.to_k", hs), linear(p, f"{pre}.to_v", hs), 1)
    return linear(p, f"{pre}.to_out.0", o).transpose(1, 2).reshape(b, c, h, w) + x


@f32_exact
def encode_mode(p, v: dict, x):
    """diffusers Encoder + quant_conv, the posterior's mode: x (N, 3, H, W)
    in [-1, 1] -> (N, z, h, w)."""
    widths = [v["ch"] * m for m in v["ch_mult"]]
    h = conv(p, "encoder.conv_in", x)
    for i in range(len(widths)):
        for j in range(v["num_res_blocks"]):
            h = resnet2d(p, f"encoder.down_blocks.{i}.resnets.{j}", h, None, 1e-6)
        if i < len(widths) - 1:
            h = conv(p, f"encoder.down_blocks.{i}.downsamplers.0.conv", F.pad(h, (0, 1, 0, 1)), stride=2, padding=0)
    h = resnet2d(p, "encoder.mid_block.resnets.0", h, None, 1e-6)
    h = vae_attention(p, "encoder.mid_block.attentions.0", h)
    h = resnet2d(p, "encoder.mid_block.resnets.1", h, None, 1e-6)
    h = conv(p, "encoder.conv_out", F.silu(gn(p, "encoder.conv_norm_out", h, 1e-6)))
    return conv(p, "quant_conv", h, padding=0).chunk(2, dim=1)[0]


@f32_exact
def temporal_decode(p, d: dict, z):
    """diffusers AutoencoderKLTemporalDecoder.decode of one chunk: z (N, 4, h,
    w) scaled latents of N consecutive frames -> (N, 3, H, W)."""
    n = z.shape[0]
    widths = list(d["block_out_channels"])[::-1]

    def st(pre):
        return lambda h: st_resnet(p, pre, h, None, n, 1e-6, 1e-5, True)

    def mid(h):
        h = st("decoder.mid_block.resnets.0")(h)
        h = vae_attention(p, "decoder.mid_block.attentions.0", h)
        return st("decoder.mid_block.resnets.1")(h)

    def up(i):
        def run(h):
            for j in range(d["layers_per_block"] + 1):
                h = st(f"decoder.up_blocks.{i}.resnets.{j}")(h)
            if i < len(widths) - 1:
                h = conv(p, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                         F.interpolate(h, scale_factor=2.0, mode="nearest"))
            return h
        return run

    h = conv(p, "decoder.conv_in", z / d["scaling_factor"])
    h = _ckpt(mid, h)
    for i in range(len(widths)):
        h = _ckpt(up(i), h)
    h = conv(p, "decoder.conv_out", F.silu(gn(p, "decoder.conv_norm_out", h, 1e-6)))
    h = conv(p, "decoder.time_conv_out", h.reshape(1, n, *h.shape[1:]).permute(0, 2, 1, 3, 4), padding=(1, 0, 0))
    return h.permute(0, 2, 1, 3, 4).reshape(n, *h.shape[1:2], *h.shape[3:])


# ---------------------------------------------------------------- CLIP

@f32_exact
def image_embed(p, c: dict, img):
    """CLIPVisionModelWithProjection.image_embeds of img (B, 3, H, W) in [-1, 1]."""
    x = F.interpolate(img, size=(c["image_size"], c["image_size"]), mode="bicubic", align_corners=False,
                      antialias=True)
    mean = torch.tensor(CLIP_MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(CLIP_STD, device=x.device)[None, :, None, None]
    x = ((x + 1.0) / 2.0 - mean) / std
    x = F.conv2d(x, p["vision_model.embeddings.patch_embedding.weight"].to(x.dtype), stride=c["patch_size"])
    x = x.flatten(2).transpose(1, 2)
    cls = p["vision_model.embeddings.class_embedding"].to(x.dtype).expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + p["vision_model.embeddings.position_embedding.weight"].to(x.dtype)
    x = ln(p, "vision_model.pre_layrnorm", x)
    for i in range(c["layers"]):
        pre = f"vision_model.encoder.layers.{i}"
        h = ln(p, f"{pre}.layer_norm1", x)
        o = softmax_attention(linear(p, f"{pre}.self_attn.q_proj", h), linear(p, f"{pre}.self_attn.k_proj", h),
                              linear(p, f"{pre}.self_attn.v_proj", h), c["heads"])
        x = x + linear(p, f"{pre}.self_attn.out_proj", o)
        x = x + linear(p, f"{pre}.mlp.fc2", F.gelu(linear(p, f"{pre}.mlp.fc1", ln(p, f"{pre}.layer_norm2", x))))
    return linear(p, "visual_projection", ln(p, "vision_model.post_layernorm", x[:, 0]))


# ---------------------------------------------------------------- layout

def layout(cfg: dict) -> Dict[str, tuple]:
    """{prefixed diffusers name: (shape, "normal" or fill value)} of the
    checkpoint: "unet.", "vae.", "image_encoder."."""
    out = {}

    def lin(n, o, i, bias=True):
        out[f"{n}.weight"] = ((o, i), "normal")
        if bias:
            out[f"{n}.bias"] = ((o,), 0.0)

    def cv(n, o, i, *k):
        out[f"{n}.weight"] = ((o, i) + k, "normal")
        out[f"{n}.bias"] = ((o,), 0.0)

    def nm(n, c):
        out[f"{n}.weight"], out[f"{n}.bias"] = ((c,), 1.0), ((c,), 0.0)

    def res(n, i, o, temb):
        nm(f"{n}.norm1", i)
        cv(f"{n}.conv1", o, i, 3, 3)
        if temb:
            lin(f"{n}.time_emb_proj", o, temb)
        nm(f"{n}.norm2", o)
        cv(f"{n}.conv2", o, o, 3, 3)
        if i != o:
            cv(f"{n}.conv_shortcut", o, i, 1, 1)

    def st_res(n, i, o, temb, m):
        res(f"{n}.spatial_res_block", i, o, temb)
        t = f"{n}.temporal_res_block"
        nm(f"{t}.norm1", o)
        cv(f"{t}.conv1", o, o, 3, 1, 1)
        if temb:
            lin(f"{t}.time_emb_proj", o, temb)
        nm(f"{t}.norm2", o)
        cv(f"{t}.conv2", o, o, 3, 1, 1)
        out[f"{n}.time_mixer.mix_factor"] = ((1,), m)

    def att(n, c, ctx, qkv_bias=False):
        for k, i in (("to_q", c), ("to_k", ctx), ("to_v", ctx)):
            lin(f"{n}.{k}", c, i, bias=qkv_bias)
        lin(f"{n}.to_out.0", c, c)

    def ff(n, c):
        lin(f"{n}.net.0.proj", 8 * c, c)
        lin(f"{n}.net.2", c, 4 * c)

    def transformer(n, c, ctx, depth):
        nm(f"{n}.norm", c)
        lin(f"{n}.proj_in", c, c)
        for d in range(depth):
            sb, tb = f"{n}.transformer_blocks.{d}", f"{n}.temporal_transformer_blocks.{d}"
            nm(f"{sb}.norm1", c), att(f"{sb}.attn1", c, c), nm(f"{sb}.norm2", c), att(f"{sb}.attn2", c, ctx)
            nm(f"{sb}.norm3", c), ff(f"{sb}.ff", c)
            nm(f"{tb}.norm_in", c), ff(f"{tb}.ff_in", c), nm(f"{tb}.norm1", c), att(f"{tb}.attn1", c, c)
            nm(f"{tb}.norm2", c), att(f"{tb}.attn2", c, ctx), nm(f"{tb}.norm3", c), ff(f"{tb}.ff", c)
        lin(f"{n}.time_pos_embed.linear_1", 4 * c, c)
        lin(f"{n}.time_pos_embed.linear_2", c, 4 * c)
        out[f"{n}.time_mixer.mix_factor"] = ((1,), 0.5)
        lin(f"{n}.proj_out", c, c)

    u = cfg["unet"]
    w = _widths(u)
    te, ctx, dep = 4 * w[0], u["context_dim"], u["transformer_depth"]
    cv("unet.conv_in", w[0], u["in_channels"], 3, 3)
    lin("unet.time_embedding.linear_1", te, w[0])
    lin("unet.time_embedding.linear_2", te, te)
    lin("unet.add_embedding.linear_1", te, u["adm_in_channels"])
    lin("unet.add_embedding.linear_2", te, te)
    chans, ch = [w[0]], w[0]
    for i, c in enumerate(w):
        for j in range(u["num_res_blocks"]):
            st_res(f"unet.down_blocks.{i}.resnets.{j}", ch, c, te, 0.5)
            ch = c
            if _has_attn(u, i):
                transformer(f"unet.down_blocks.{i}.attentions.{j}", c, ctx, dep)
            chans.append(c)
        if i < len(w) - 1:
            cv(f"unet.down_blocks.{i}.downsamplers.0.conv", c, c, 3, 3)
            chans.append(c)
    st_res("unet.mid_block.resnets.0", ch, ch, te, 0.5)
    transformer("unet.mid_block.attentions.0", ch, ctx, dep)
    st_res("unet.mid_block.resnets.1", ch, ch, te, 0.5)
    for i, c in enumerate(w[::-1]):
        for j in range(u["num_res_blocks"] + 1):
            st_res(f"unet.up_blocks.{i}.resnets.{j}", ch + chans.pop(), c, te, 0.5)
            ch = c
            if _has_attn(u, len(w) - 1 - i):
                transformer(f"unet.up_blocks.{i}.attentions.{j}", c, ctx, dep)
        if i < len(w) - 1:
            cv(f"unet.up_blocks.{i}.upsamplers.0.conv", c, c, 3, 3)
    nm("unet.conv_norm_out", w[0])
    cv("unet.conv_out", u["out_channels"], w[0], 3, 3)

    v, d = cfg["vae"], cfg["decoder"]
    vw = [v["ch"] * m for m in v["ch_mult"]]
    cv("vae.encoder.conv_in", vw[0], v["in_channels"], 3, 3)
    ch = vw[0]
    for i, c in enumerate(vw):
        for j in range(v["num_res_blocks"]):
            res(f"vae.encoder.down_blocks.{i}.resnets.{j}", ch, c, 0)
            ch = c
        if i < len(vw) - 1:
            cv(f"vae.encoder.down_blocks.{i}.downsamplers.0.conv", c, c, 3, 3)
    res("vae.encoder.mid_block.resnets.0", ch, ch, 0)
    nm("vae.encoder.mid_block.attentions.0.group_norm", ch)
    att("vae.encoder.mid_block.attentions.0", ch, ch, qkv_bias=True)
    res("vae.encoder.mid_block.resnets.1", ch, ch, 0)
    nm("vae.encoder.conv_norm_out", ch)
    cv("vae.encoder.conv_out", 2 * v["z_channels"], ch, 3, 3)
    cv("vae.quant_conv", 2 * v["embed_dim"], 2 * v["z_channels"], 1, 1)
    dw = list(d["block_out_channels"])[::-1]
    ch = dw[0]
    cv("vae.decoder.conv_in", ch, d["latent_channels"], 3, 3)
    st_res("vae.decoder.mid_block.resnets.0", ch, ch, 0, 0.0)
    nm("vae.decoder.mid_block.attentions.0.group_norm", ch)
    att("vae.decoder.mid_block.attentions.0", ch, ch, qkv_bias=True)
    st_res("vae.decoder.mid_block.resnets.1", ch, ch, 0, 0.0)
    for i, c in enumerate(dw):
        for j in range(d["layers_per_block"] + 1):
            st_res(f"vae.decoder.up_blocks.{i}.resnets.{j}", ch, c, 0, 0.0)
            ch = c
        if i < len(dw) - 1:
            cv(f"vae.decoder.up_blocks.{i}.upsamplers.0.conv", c, c, 3, 3)
    nm("vae.decoder.conv_norm_out", ch)
    cv("vae.decoder.conv_out", d["out_channels"], ch, 3, 3)
    cv("vae.decoder.time_conv_out", d["out_channels"], d["out_channels"], 3, 1, 1)

    c = cfg["clip_vision"]
    cw, grid = c["width"], c["image_size"] // c["patch_size"]
    e = "image_encoder.vision_model"
    out[f"{e}.embeddings.class_embedding"] = ((cw,), "normal")
    out[f"{e}.embeddings.patch_embedding.weight"] = ((cw, 3, c["patch_size"], c["patch_size"]), "normal")
    out[f"{e}.embeddings.position_embedding.weight"] = ((grid * grid + 1, cw), "normal")
    nm(f"{e}.pre_layrnorm", cw)
    for i in range(c["layers"]):
        pre = f"{e}.encoder.layers.{i}"
        for k in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(f"{pre}.self_attn.{k}", cw, cw)
        nm(f"{pre}.layer_norm1", cw)
        lin(f"{pre}.mlp.fc1", 4 * cw, cw)
        lin(f"{pre}.mlp.fc2", cw, 4 * cw)
        nm(f"{pre}.layer_norm2", cw)
    nm(f"{e}.post_layernorm", cw)
    lin("image_encoder.visual_projection", c["projection_dim"], cw, bias=False)
    return out


def split(sd: Dict[str, torch.Tensor]):
    """(unet, vae, image_encoder) dicts of a prefixed state dict."""
    parts = ({}, {}, {})
    for k, v in sd.items():
        for i, pre in enumerate(("unet.", "vae.", "image_encoder.")):
            if k.startswith(pre):
                parts[i][k[len(pre):]] = v
    return parts


# ---------------------------------------------------------------- sampling

class Cond(NamedTuple):
    context: torch.Tensor  # (1, 1, C_ctx)
    concat: torch.Tensor  # (1, T, 4, h, w)
    time_ids: torch.Tensor  # (1, 3)


class EDM(NamedTuple):
    sigmas: torch.Tensor  # (S + 1,)
    c_skip: torch.Tensor
    c_out: torch.Tensor
    c_in: torch.Tensor
    c_noise: torch.Tensor


def karras(steps, sigma_min, sigma_max, rho, device) -> EDM:
    """EulerDiscreteScheduler's Karras sigmas (float64, then float32) with the
    final 0, and VScalingWithEDMcNoise's scalings of each step's sigma."""
    ramp = np.linspace(0.0, 1.0, steps)
    sig = (sigma_max ** (1 / rho) + ramp * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
    s2 = sig ** 2 + 1.0
    t = [np.append(sig, 0.0), 1.0 / s2, -sig / np.sqrt(s2), 1.0 / np.sqrt(s2), 0.25 * np.log(sig)]
    return EDM(*(torch.tensor(a, dtype=torch.float32, device=device) for a in t))


def frame_scales(min_cfg, max_cfg, frames, device):
    return torch.linspace(min_cfg, max_cfg, frames, device=device).reshape(1, frames, 1, 1, 1)


@f32_exact
def conditioning(params, cfg, traffic, video, aug_noise):
    """(cond, uncond) of renders `video` (T, 3, H, W) in [-1, 1];
    aug_noise (1, 3, H, W)."""
    unet, vae, enc = params
    frame0 = video[:1]
    emb = image_embed(enc, cfg["clip_vision"], frame0)[:, None]
    mean = encode_mode(vae, cfg["vae"], frame0 + traffic["noise_aug_strength"] * aug_noise)
    concat = mean[:, None].repeat(1, video.shape[0], 1, 1, 1)
    ids = torch.tensor([[traffic["fps"] - 1, traffic["motion_bucket_id"], traffic["noise_aug_strength"]]],
                       dtype=torch.float32, device=video.device)
    return Cond(emb, concat, ids), Cond(torch.zeros_like(emb), torch.zeros_like(concat), ids)


def model(params, cfg, dtype, x, k, edm: EDM, c: Cond):
    """F(c_in x, c_noise) in `dtype`, returned float32; x (B, T, 4, h, w)."""
    xc = torch.cat([x * edm.c_in[k], c.concat.to(x.dtype)], dim=2)
    b = x.shape[0]
    return unet_forward(params[0], cfg["unet"], xc.to(dtype), edm.c_noise[k].expand(b), c.context.to(dtype),
                        c.time_ids).float()


@f32_exact
def pair(params, cfg, dtype, x, k, edm, cond, uncond):
    """(v_cond, v_uncond) as one application at batch 2, without autograd."""
    cu = Cond(*(torch.cat([a, b]) for a, b in zip(cond, uncond)))
    with torch.no_grad():
        v = model(params, cfg, dtype, torch.cat([x, x]), k, edm, cu)
    return v[:1], v[1:]


def denoised(x, k, edm, scales, vc, vu):
    return edm.c_skip[k] * x + edm.c_out[k] * (vu + scales * (vc - vu))


def euler(x, k, edm, d):
    return x + (x - d) / edm.sigmas[k] * (edm.sigmas[k + 1] - edm.sigmas[k])


def guidance_loss(images, masks, w_recon):
    """The scene-grounding loss: frames (c, 3, H, W) in [-1, 1] of frames
    `idx` -> (per-frame sum of w_recon (x - guide)^2 mask, per-frame mask sum);
    images (T, 3, H, W) in [0, 1], masks (T, 1, H, W)."""
    def fn(frames, idx):
        d = torch.clamp((frames + 1.0) / 2.0, 0.0, 1.0)
        m = masks[idx].expand_as(d)
        return (w_recon * (d - images[idx]) ** 2 * m).sum(dim=(1, 2, 3)), m.sum(dim=(1, 2, 3))
    return fn


@f32_exact
def guided_step(params, cfg, dtype, traffic, x, k, edm, scales, cond, uncond, loss_fn, vc, vu):
    """The guided Euler EDM step from x (1, T, 4, h, w) at step k and the
    pair (vc, vu): x_next - rho dL/dx."""
    d = denoised(x, k, edm, scales, vc, vu)
    x_next = euler(x, k, edm, d)
    z0 = d[0].detach()
    grads = torch.zeros_like(z0)
    chunk = traffic["decode_chunk"]
    for c0 in range(0, z0.shape[0], chunk):
        with torch.enable_grad():
            z = z0[c0:c0 + chunk].clone().requires_grad_()
            frames = temporal_decode(params[1], cfg["decoder"], z.to(dtype)).float()
            loss, numel = loss_fn(frames, torch.arange(c0, c0 + z.shape[0], device=x.device))
            (g,) = torch.autograd.grad(loss.sum(), z)
        nm = numel.reshape(-1, 1, 1, 1)
        grads[c0:c0 + chunk] = torch.where(nm > 0, g / nm, torch.zeros_like(g))
    with torch.enable_grad():
        xl, vcl, vul = (a.detach().clone().requires_grad_() for a in (x, vc, vu))
        gx, g_c, g_u = torch.autograd.grad(denoised(xl, k, edm, scales, vcl, vul), (xl, vcl, vul), grads[None])
        for c, g in ((cond, g_c), (uncond, g_u)):
            xg = x.detach().clone().requires_grad_()
            v = model(params, cfg, dtype, xg, k, edm, c)
            gx = gx + torch.autograd.grad(v, xg, g)[0]
    corr = scales * (edm.c_out[k] * (vc - vu))
    rms_g = torch.sqrt(torch.mean(gx ** 2))
    rho = torch.where(rms_g == 0, torch.zeros_like(rms_g),
                      torch.sqrt(torch.mean(corr ** 2)) / rms_g * traffic.get("rho_scale", 0.2))
    return x_next - rho * gx
