"""DUSt3R's two-view pointmap network as torch modules.

Counterpart of `guidedvd3dgs_tpu/geometry/dust3r.py` (the reference's
AsymmetricCroCo3DStereo: extern/dust3r/dust3r/model.py, croco/models/
blocks.py, croco/models/pos_embed.py RoPE2D, croco/models/dpt_block.py and
dust3r/heads/postprocess.py). The modules are named as the reference's
state dict, so a DUSt3R checkpoint's tensors load by name unchanged, and
`init_params` draws random weights with exactly that key set.

The shipped DUSt3R_ViTLarge_BaseDecoder_512_dpt (`Dust3rConfig()`): a
ViT-L encoder (1024 x 24 layers, 16 heads) shared by both views, a base
decoder per view (768 x 12 layers, 12 heads) that cross-attends to the
other view, RoPE2D positions (frequency 100), and one DPT head per view on
the hooked layers (0, 6, 9, 12) with the exp depth and 1 + exp confidence.
Activations go in and out channels-last: images (B, H, W, 3), pointmaps
(B, H, W, 3), confidences (B, H, W). The attention is the JAX package's
plain product, softmax and product (float32 scores), not a kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6
LAYER_DIMS = (96, 192, 384, 768)  # the DPT head's per-hook widths


@dataclass(frozen=True)
class Dust3rConfig:
    patch_size: int = 16
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    mlp_ratio: float = 4.0
    rope_freq: float = 100.0
    feature_dim: int = 256  # DPT
    last_dim: int = 128
    has_conf: bool = True

    @property
    def hooks(self) -> Tuple[int, int, int, int]:
        l2 = self.dec_depth
        return (0, l2 * 2 // 4, l2 * 3 // 4, l2)


# --- RoPE2D -------------------------------------------------------------------


def _rope_cos_sin(d_half: int, positions: torch.Tensor, freq: float):
    inv_freq = 1.0 / (freq ** (torch.arange(0, d_half, 2, dtype=torch.float32,
                                            device=positions.device) / d_half))
    fr = positions.to(torch.float32)[..., None] * inv_freq  # (B, N, d_half / 2)
    fr = torch.cat([fr, fr], dim=-1)
    return torch.cos(fr), torch.sin(fr)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rope2d(tokens: torch.Tensor, positions: torch.Tensor, freq: float) -> torch.Tensor:
    """tokens (B, H, N, D), positions (B, N, 2) as (y, x): the first half of
    each head rotated by y, the second by x."""
    d = tokens.shape[-1] // 2
    y, x = tokens.split(d, dim=-1)

    def one(tok, pos1d):
        cos, sin = _rope_cos_sin(d, pos1d, freq)
        return tok * cos[:, None] + _rotate_half(tok) * sin[:, None]

    return torch.cat([one(y, positions[:, :, 0]), one(x, positions[:, :, 1])], dim=-1)


# --- transformer blocks ---------------------------------------------------------


def _heads(t: torch.Tensor, n: int) -> torch.Tensor:
    b, s, c = t.shape
    return t.reshape(b, s, n, c // n).transpose(1, 2)


def _unheads(t: torch.Tensor) -> torch.Tensor:
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


def _attn(q, k, v, scale: float) -> torch.Tensor:
    sim = torch.matmul(q, k.transpose(-1, -2)).to(torch.float32) * scale
    return torch.matmul(torch.softmax(sim, dim=-1).to(v.dtype), v)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    """Self-attention with a fused qkv and RoPE on q and k (blocks.py:81-112)."""

    def __init__(self, dim: int, heads: int, freq: float):
        super().__init__()
        self.heads, self.freq = heads, freq
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, xpos):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q, k = rope2d(q, xpos, self.freq), rope2d(k, xpos, self.freq)
        return self.proj(_unheads(_attn(q, k, v, (c // self.heads) ** -0.5)))


class CrossAttention(nn.Module):
    """blocks.py:132-169."""

    def __init__(self, dim: int, heads: int, freq: float):
        super().__init__()
        self.heads, self.freq = heads, freq
        self.projq = nn.Linear(dim, dim)
        self.projk = nn.Linear(dim, dim)
        self.projv = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, y, xpos, ypos):
        c = x.shape[-1]
        q = rope2d(_heads(self.projq(x), self.heads), xpos, self.freq)
        k = rope2d(_heads(self.projk(y), self.heads), ypos, self.freq)
        v = _heads(self.projv(y), self.heads)
        return self.proj(_unheads(_attn(q, k, v, (c // self.heads) ** -0.5)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float, freq: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads, freq)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, xpos):
        x = x + self.attn(self.norm1(x), xpos)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    """blocks.py:171-191."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float, freq: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads, freq)
        self.cross_attn = CrossAttention(dim, heads, freq)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.norm_y = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x, y, xpos, ypos):
        x = x + self.attn(self.norm1(x), xpos)
        x = x + self.cross_attn(self.norm2(x), self.norm_y(y), xpos, ypos)
        return x + self.mlp(self.norm3(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)

    def forward(self, img):
        """img (B, H, W, 3) -> tokens (B, N, C), positions (B, N, 2), grid."""
        x = self.proj(img.permute(0, 3, 1, 2))
        b, c, nh, nw = x.shape
        tokens = x.flatten(2).transpose(1, 2)
        yy, xx = torch.meshgrid(torch.arange(nh, device=img.device), torch.arange(nw, device=img.device),
                                indexing="ij")
        pos = torch.stack([yy, xx], -1).reshape(1, nh * nw, 2).expand(b, nh * nw, 2)
        return tokens, pos, (nh, nw)


# --- the DPT head (croco/models/dpt_block.py, dust3r/heads/dpt_head.py) --------------


def resize_align_corners(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Bilinear with align_corners=True on NCHW (the DPT upsamples)."""
    return F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=True)


class Interpolate2x(nn.Module):
    def forward(self, x):
        return resize_align_corners(x, 2 * x.shape[2], 2 * x.shape[3])


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FusionBlock(nn.Module):
    """FeatureFusionBlock_custom (dpt_block.py:144-218)."""

    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = resize_align_corners(x, 2 * x.shape[2], 2 * x.shape[3])
        return self.out_conv(x)


class Scratch(nn.Module):
    def __init__(self, feature_dim: int):
        super().__init__()
        for i, d in enumerate(LAYER_DIMS):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(d, feature_dim, 3, padding=1, bias=False))
        for i in range(4):
            setattr(self, f"refinenet{i + 1}", FusionBlock(feature_dim))


class DPTAdapter(nn.Module):
    def __init__(self, cfg: Dust3rConfig, out_channels: int):
        super().__init__()
        dims_in = (cfg.enc_embed_dim,) + (cfg.dec_embed_dim,) * 3
        d = LAYER_DIMS
        self.act_postprocess = nn.ModuleList([
            nn.Sequential(nn.Conv2d(dims_in[0], d[0], 1), nn.ConvTranspose2d(d[0], d[0], 4, stride=4)),
            nn.Sequential(nn.Conv2d(dims_in[1], d[1], 1), nn.ConvTranspose2d(d[1], d[1], 2, stride=2)),
            nn.Sequential(nn.Conv2d(dims_in[2], d[2], 1)),
            nn.Sequential(nn.Conv2d(dims_in[3], d[3], 1), nn.Conv2d(d[3], d[3], 3, stride=2, padding=1)),
        ])
        self.scratch = Scratch(cfg.feature_dim)
        f = cfg.feature_dim
        self.head = nn.Sequential(nn.Conv2d(f, f // 2, 3, padding=1), Interpolate2x(),
                                  nn.Conv2d(f // 2, cfg.last_dim, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(cfg.last_dim, out_channels, 1))
        self.hooks = cfg.hooks

    def forward(self, tokens: List[torch.Tensor], grid: Tuple[int, int]) -> torch.Tensor:
        """The hooked layers' (B, N, C) tokens -> (B, H, W, out_channels)."""
        nh, nw = grid
        layers = []
        for idx, hook in enumerate(self.hooks):
            t = tokens[hook]
            fm = t.transpose(1, 2).reshape(t.shape[0], t.shape[2], nh, nw)
            fm = self.act_postprocess[idx](fm)
            layers.append(getattr(self.scratch, f"layer{idx + 1}_rn")(fm))
        s = self.scratch
        path4 = s.refinenet4(layers[3])[:, :, : layers[2].shape[2], : layers[2].shape[3]]
        path3 = s.refinenet3(path4, layers[2])
        path2 = s.refinenet2(path3, layers[1])
        path1 = s.refinenet1(path2, layers[0])
        return self.head(path1).permute(0, 2, 3, 1)


class DPTHead(nn.Module):
    def __init__(self, cfg: Dust3rConfig):
        super().__init__()
        self.dpt = DPTAdapter(cfg, 3 + int(cfg.has_conf))


def postprocess(out: torch.Tensor, has_conf: bool = True) -> Dict[str, torch.Tensor]:
    """The shipped activations (postprocess.py:10-58): depth mode ('exp',
    -inf, inf) scales the xyz direction to expm1 of its norm; conf mode
    ('exp', 1, inf) is 1 + exp."""
    xyz = out[..., 0:3]
    d = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    res = {"pts3d": xyz / torch.clamp(d, min=1e-8) * torch.expm1(d)}
    if has_conf:
        res["conf"] = 1.0 + torch.exp(out[..., 3])
    return res


class AsymmetricCroCo3DStereo(nn.Module):
    """The two-view network (model.py:20-170)."""

    def __init__(self, cfg: Dust3rConfig = Dust3rConfig()):
        super().__init__()
        self.cfg = cfg
        mr, fq = cfg.mlp_ratio, cfg.rope_freq
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.enc_embed_dim)
        self.enc_blocks = nn.ModuleList([Block(cfg.enc_embed_dim, cfg.enc_num_heads, mr, fq)
                                         for _ in range(cfg.enc_depth)])
        self.enc_norm = nn.LayerNorm(cfg.enc_embed_dim, eps=LN_EPS)
        self.decoder_embed = nn.Linear(cfg.enc_embed_dim, cfg.dec_embed_dim)
        self.dec_blocks = nn.ModuleList([DecoderBlock(cfg.dec_embed_dim, cfg.dec_num_heads, mr, fq)
                                         for _ in range(cfg.dec_depth)])
        self.dec_blocks2 = nn.ModuleList([DecoderBlock(cfg.dec_embed_dim, cfg.dec_num_heads, mr, fq)
                                          for _ in range(cfg.dec_depth)])
        self.dec_norm = nn.LayerNorm(cfg.dec_embed_dim, eps=LN_EPS)
        self.downstream_head1 = DPTHead(cfg)
        self.downstream_head2 = DPTHead(cfg)

    def encode_image(self, img: torch.Tensor):
        """model.py:83-95: (tokens, positions, grid)."""
        x, pos, grid = self.patch_embed(img)
        for blk in self.enc_blocks:
            x = blk(x, pos)
        return self.enc_norm(x), pos, grid

    def decode_pair(self, f1, pos1, f2, pos2):
        """The cross-attending twin decoders: each view's token list, the
        encoder's tokens first (model.py:127-146)."""
        outs1, outs2 = [f1], [f2]
        f1, f2 = self.decoder_embed(f1), self.decoder_embed(f2)
        for blk1, blk2 in zip(self.dec_blocks, self.dec_blocks2):
            f1, f2 = blk1(f1, f2, pos1, pos2), blk2(f2, f1, pos2, pos1)
            outs1.append(f1)
            outs2.append(f2)
        outs1[-1] = self.dec_norm(outs1[-1])
        outs2[-1] = self.dec_norm(outs2[-1])
        return outs1, outs2

    def forward(self, img1: torch.Tensor, img2: torch.Tensor):
        """Normalised (B, H, W, 3) image pairs -> ({pts3d, conf} of view 1,
        of view 2), both pointmaps in view 1's frame (model.py:160-170)."""
        f1, pos1, grid = self.encode_image(img1)
        f2, pos2, _ = self.encode_image(img2)
        outs1, outs2 = self.decode_pair(f1, pos1, f2, pos2)
        o1 = self.downstream_head1.dpt(outs1, grid)
        o2 = self.downstream_head2.dpt(outs2, grid)
        return postprocess(o1, self.cfg.has_conf), postprocess(o2, self.cfg.has_conf)


def dust3r_apply(model: AsymmetricCroCo3DStereo, img1: torch.Tensor, img2: torch.Tensor):
    """The two-view forward without autograd."""
    with torch.no_grad():
        return model(img1, img2)


def init_params(cfg: Dust3rConfig = Dust3rConfig(), seed: int = 0) -> Dict[str, np.ndarray]:
    """Random float32 weights under the state dict's names, drawn as the
    reference's constructor draws them: Linear weights Xavier-uniform with
    zero bias (croco's _init_weights), LayerNorm one and zero, convolutions
    PyTorch's default U(+-1/sqrt(fan_in)) for weight and bias."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        model = AsymmetricCroCo3DStereo(cfg)
    kinds = {}
    for name, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            kinds[f"{name}.{pname}" if name else pname] = mod
    out = {}

    def uniform(shape, bound):
        return ((rng.random(shape, dtype=np.float32) * 2.0 - 1.0) * bound).astype(np.float32)

    for key, t in model.state_dict().items():
        mod, shape = kinds[key], tuple(t.shape)
        leaf = key.rsplit(".", 1)[1]
        if isinstance(mod, nn.LayerNorm):
            out[key] = np.full(shape, 1.0 if leaf == "weight" else 0.0, np.float32)
        elif isinstance(mod, nn.Linear):
            out[key] = (uniform(shape, np.sqrt(6.0 / (shape[0] + shape[1]))) if leaf == "weight"
                        else np.zeros(shape, np.float32))
        else:  # Conv2d (out, in, k, k) / ConvTranspose2d (in, out, k, k): fan_in of dim 1
            w_shape = tuple(mod.weight.shape)
            fan_in = w_shape[1] * int(np.prod(w_shape[2:]))
            out[key] = uniform(shape, 1.0 / np.sqrt(fan_in))
    return out


def from_params(params: Dict[str, np.ndarray], cfg: Dust3rConfig = Dust3rConfig(), device="cpu",
                dtype: torch.dtype = torch.float32) -> AsymmetricCroCo3DStereo:
    """The network with `params` (numpy arrays or tensors by state-dict
    name) on `device`, in eval mode. Every key of the network must be
    there; a checkpoint's other keys are ignored."""
    with torch.device("meta"):
        model = AsymmetricCroCo3DStereo(cfg)
    names = model.state_dict().keys()
    missing = [k for k in names if k not in params]
    if missing:
        raise KeyError(f"DUSt3R weights lack {len(missing)} keys, e.g. {missing[:3]}")
    sd = {k: torch.as_tensor(params[k]).to(device, dtype) for k in names}
    model.load_state_dict(sd, strict=True, assign=True)
    return model.eval()
