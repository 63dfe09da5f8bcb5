"""ViewCrafter and Stable Video Diffusion checkpoints -> the port's parameter dicts.

Counterpart of `guidedvd3dgs_tpu/diffusion/convert.py`. The diffusion
modules read torch names and layouts directly, so loading is a split of the
state dict by sub-model prefix plus the checkpoint's renames:

  * "framestride_embed" -> "fps_embedding" (reference
    utils_vc/diffusion_utils.py:84-109);
  * Lightning's "state_dict" nesting and deepspeed's "module" nesting;
  * the open_clip towers' own prefixes ("model." of the text embedder,
    "model.visual." of the image embedder), which `clip.py` reads without
    (the reference's loader keeps them, so its CLI hands the towers names
    they do not read; ROADMAP queue 3).

Stable Video Diffusion XT (`load_svd_checkpoint`): the diffusers layout of
stabilityai/stable-video-diffusion-img2vid-xt, either that repository's
directory (unet/diffusion_pytorch_model*.safetensors|.bin,
vae/diffusion_pytorch_model*.safetensors|.bin,
image_encoder/model*.safetensors|pytorch_model*.bin) or one torch file of
the three state dicts under the prefixes "unet.", "vae." and
"image_encoder.". The UNet and the temporal decoder keep diffusers'
names; the KL-f8 encoder is renamed to vae.py's (the encoder ViewCrafter
shares) and the CLIP vision tower to clip.py's (q/k/v packed as
in_proj). `svd_layout` is the diffusers key set with each shape, and
`write_random_svd_checkpoint` writes random weights in it (the weights are
not in the repository).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Tuple

import numpy as np
import torch

from guidedvd3dgs_tpu_torch.diffusion.model import SVDConfig, SVDParams

SUBMODEL_PREFIXES = {
    "unet": "model.diffusion_model.",
    "vae": "first_stage_model.",
    "clip_text": "cond_stage_model.",
    "clip_image": "embedder.",
    "resampler": "image_proj_model.",
}
# inside a sub-model: the open_clip model of each CLIP embedder
CLIP_PREFIXES = {"clip_text": "model.", "clip_image": "model.visual."}


def load_viewcrafter_checkpoint(path: str, device="cpu", dtype=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The checkpoint split into {unet, vae, clip_text, clip_image,
    resampler, buffers} dicts of tensors on `device`, named as the port's
    modules read them; floating tensors of the five sub-models are cast to
    `dtype` when given. `buffers` holds every other entry (schedule arrays
    such as scale_arr)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    if isinstance(sd.get("module"), dict):  # deepspeed layout
        sd = {k.replace("module.", "", 1): v for k, v in sd["module"].items()}
    split: Dict[str, Dict[str, torch.Tensor]] = {name: {} for name in SUBMODEL_PREFIXES}
    buffers: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        k = k.replace("framestride_embed", "fps_embedding")
        v = torch.as_tensor(v)
        for name, prefix in SUBMODEL_PREFIXES.items():
            if k.startswith(prefix):
                if dtype is not None and v.is_floating_point():
                    v = v.to(dtype)
                k = k[len(prefix):]
                inner = CLIP_PREFIXES.get(name, "")
                split[name][k[len(inner):] if k.startswith(inner) else k] = v.to(device)
                break
        else:
            buffers[k] = v.to(device)
    split["buffers"] = buffers
    return split


# --------------------------------------------------------------------------
# Stable Video Diffusion XT
# --------------------------------------------------------------------------

SVD_PREFIXES = {"unet": "unet.", "vae": "vae.", "clip_image": "image_encoder."}
Layout = Dict[str, Tuple[tuple, object]]  # name -> (shape, "normal" or a fill value)


class _Lay:
    def __init__(self):
        self.d: Layout = {}

    def lin(self, name, out_d, in_d, bias=True):
        self.d[f"{name}.weight"] = ((out_d, in_d), "normal")
        if bias:
            self.d[f"{name}.bias"] = ((out_d,), 0.0)

    def conv(self, name, out_c, in_c, k):
        self.d[f"{name}.weight"] = ((out_c, in_c) + tuple(k), "normal")
        self.d[f"{name}.bias"] = ((out_c,), 0.0)

    def norm(self, name, c):
        self.d[f"{name}.weight"] = ((c,), 1.0)
        self.d[f"{name}.bias"] = ((c,), 0.0)


def _st_res(lay: _Lay, pre: str, cin: int, cout: int, temb: int, mix: float):
    s, t = f"{pre}.spatial_res_block", f"{pre}.temporal_res_block"
    lay.norm(f"{s}.norm1", cin)
    lay.conv(f"{s}.conv1", cout, cin, (3, 3))
    if temb:
        lay.lin(f"{s}.time_emb_proj", cout, temb)
    lay.norm(f"{s}.norm2", cout)
    lay.conv(f"{s}.conv2", cout, cout, (3, 3))
    if cin != cout:
        lay.conv(f"{s}.conv_shortcut", cout, cin, (1, 1))
    lay.norm(f"{t}.norm1", cout)
    lay.conv(f"{t}.conv1", cout, cout, (3, 1, 1))
    if temb:
        lay.lin(f"{t}.time_emb_proj", cout, temb)
    lay.norm(f"{t}.norm2", cout)
    lay.conv(f"{t}.conv2", cout, cout, (3, 1, 1))
    lay.d[f"{pre}.time_mixer.mix_factor"] = ((1,), mix)


def _attn(lay: _Lay, pre: str, c: int, ctx: int):
    for nm, d in (("to_q", c), ("to_k", ctx), ("to_v", ctx)):
        lay.lin(f"{pre}.{nm}", c, d, bias=False)
    lay.lin(f"{pre}.to_out.0", c, c)


def _ff(lay: _Lay, pre: str, c: int):
    lay.lin(f"{pre}.net.0.proj", 8 * c, c)
    lay.lin(f"{pre}.net.2", c, 4 * c)


def _st_transformer(lay: _Lay, pre: str, c: int, ctx: int, depth: int):
    lay.norm(f"{pre}.norm", c)
    lay.lin(f"{pre}.proj_in", c, c)
    for d in range(depth):
        b = f"{pre}.transformer_blocks.{d}"
        for i in (1, 2, 3):
            lay.norm(f"{b}.norm{i}", c)
        _attn(lay, f"{b}.attn1", c, c)
        _attn(lay, f"{b}.attn2", c, ctx)
        _ff(lay, f"{b}.ff", c)
        tb = f"{pre}.temporal_transformer_blocks.{d}"
        for nm in ("norm_in", "norm1", "norm2", "norm3"):
            lay.norm(f"{tb}.{nm}", c)
        _ff(lay, f"{tb}.ff_in", c)
        _attn(lay, f"{tb}.attn1", c, c)
        _attn(lay, f"{tb}.attn2", c, ctx)
        _ff(lay, f"{tb}.ff", c)
    lay.lin(f"{pre}.time_pos_embed.linear_1", 4 * c, c)
    lay.lin(f"{pre}.time_pos_embed.linear_2", c, 4 * c)
    lay.d[f"{pre}.time_mixer.mix_factor"] = ((1,), 0.5)
    lay.lin(f"{pre}.proj_out", c, c)


def svd_unet_layout(cfg) -> Layout:
    """diffusers `UNetSpatioTemporalConditionModel`'s state dict at an
    `STUNetConfig` (mix factors at their initial 0.5)."""
    lay = _Lay()
    widths = cfg.widths()
    mc, temb, n = cfg.model_channels, 4 * cfg.model_channels, len(widths)
    lay.conv("conv_in", mc, cfg.in_channels, (3, 3))
    lay.lin("time_embedding.linear_1", temb, mc)
    lay.lin("time_embedding.linear_2", temb, temb)
    lay.lin("add_embedding.linear_1", temb, cfg.adm_in_channels)
    lay.lin("add_embedding.linear_2", temb, temb)
    skips, ch = [mc], mc
    for i, w in enumerate(widths):
        for j in range(cfg.num_res_blocks):
            _st_res(lay, f"down_blocks.{i}.resnets.{j}", ch, w, temb, 0.5)
            ch = w
            if cfg.has_attention(i):
                _st_transformer(lay, f"down_blocks.{i}.attentions.{j}", ch, cfg.context_dim, cfg.transformer_depth)
            skips.append(ch)
        if i != n - 1:
            lay.conv(f"down_blocks.{i}.downsamplers.0.conv", ch, ch, (3, 3))
            skips.append(ch)
    _st_res(lay, "mid_block.resnets.0", ch, ch, temb, 0.5)
    _st_transformer(lay, "mid_block.attentions.0", ch, cfg.context_dim, cfg.transformer_depth)
    _st_res(lay, "mid_block.resnets.1", ch, ch, temb, 0.5)
    for i, w in enumerate(reversed(widths)):
        level = n - 1 - i
        for j in range(cfg.num_res_blocks + 1):
            _st_res(lay, f"up_blocks.{i}.resnets.{j}", ch + skips.pop(), w, temb, 0.5)
            ch = w
            if cfg.has_attention(level):
                _st_transformer(lay, f"up_blocks.{i}.attentions.{j}", ch, cfg.context_dim, cfg.transformer_depth)
        if level != 0:
            lay.conv(f"up_blocks.{i}.upsamplers.0.conv", ch, ch, (3, 3))
    lay.norm("conv_norm_out", mc)
    lay.conv("conv_out", cfg.out_channels, mc, (3, 3))
    return lay.d


def _vae_attn(lay: _Lay, pre: str, c: int):
    lay.norm(f"{pre}.group_norm", c)
    for nm in ("to_q", "to_k", "to_v", "to_out.0"):
        lay.lin(f"{pre}.{nm}", c, c)


def svd_vae_layout(enc, dec) -> Layout:
    """diffusers `AutoencoderKLTemporalDecoder`'s state dict: the KL-f8
    encoder of a vae.VAEConfig, quant_conv, the temporal decoder of a
    TemporalDecoderConfig (mix factors at their initial 0.0)."""
    lay = _Lay()

    def res(pre, cin, cout):
        lay.norm(f"{pre}.norm1", cin)
        lay.conv(f"{pre}.conv1", cout, cin, (3, 3))
        lay.norm(f"{pre}.norm2", cout)
        lay.conv(f"{pre}.conv2", cout, cout, (3, 3))
        if cin != cout:
            lay.conv(f"{pre}.conv_shortcut", cout, cin, (1, 1))

    widths = [enc.ch * m for m in enc.ch_mult]
    n = len(widths)
    lay.conv("encoder.conv_in", widths[0], enc.in_channels, (3, 3))
    ch = widths[0]
    for i, w in enumerate(widths):
        for j in range(enc.num_res_blocks):
            res(f"encoder.down_blocks.{i}.resnets.{j}", ch, w)
            ch = w
        if i != n - 1:
            lay.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", ch, ch, (3, 3))
    res("encoder.mid_block.resnets.0", ch, ch)
    _vae_attn(lay, "encoder.mid_block.attentions.0", ch)
    res("encoder.mid_block.resnets.1", ch, ch)
    lay.norm("encoder.conv_norm_out", ch)
    lay.conv("encoder.conv_out", 2 * enc.z_channels, ch, (3, 3))
    lay.conv("quant_conv", 2 * enc.embed_dim, 2 * enc.z_channels, (1, 1))
    dw = list(reversed(dec.block_out_channels))
    ch = dw[0]
    lay.conv("decoder.conv_in", ch, dec.latent_channels, (3, 3))
    _st_res(lay, "decoder.mid_block.resnets.0", ch, ch, 0, 0.0)
    _vae_attn(lay, "decoder.mid_block.attentions.0", ch)
    _st_res(lay, "decoder.mid_block.resnets.1", ch, ch, 0, 0.0)
    for i, w in enumerate(dw):
        for j in range(dec.layers_per_block + 1):
            _st_res(lay, f"decoder.up_blocks.{i}.resnets.{j}", ch, w, 0, 0.0)
            ch = w
        if i != len(dw) - 1:
            lay.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", ch, ch, (3, 3))
    lay.norm("decoder.conv_norm_out", ch)
    lay.conv("decoder.conv_out", dec.out_channels, ch, (3, 3))
    lay.conv("decoder.time_conv_out", dec.out_channels, dec.out_channels, (3, 1, 1))
    return lay.d


def svd_image_encoder_layout(vision, proj_dim: int = 1024) -> Layout:
    """transformers `CLIPVisionModelWithProjection`'s state dict (no
    position_ids buffer) of a clip.VisionConfig."""
    lay = _Lay()
    w, grid = vision.width, vision.image_size // vision.patch_size
    lay.d["vision_model.embeddings.class_embedding"] = ((w,), "normal")
    lay.d["vision_model.embeddings.patch_embedding.weight"] = ((w, 3, vision.patch_size, vision.patch_size), "normal")
    lay.d["vision_model.embeddings.position_embedding.weight"] = ((grid * grid + 1, w), "normal")
    lay.norm("vision_model.pre_layrnorm", w)
    for i in range(vision.layers):
        pre = f"vision_model.encoder.layers.{i}"
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lay.lin(f"{pre}.self_attn.{nm}", w, w)
        lay.norm(f"{pre}.layer_norm1", w)
        lay.lin(f"{pre}.mlp.fc1", 4 * w, w)
        lay.lin(f"{pre}.mlp.fc2", w, 4 * w)
        lay.norm(f"{pre}.layer_norm2", w)
    lay.norm("vision_model.post_layernorm", w)
    lay.lin("visual_projection", proj_dim, w, bias=False)
    return lay.d


def svd_layout(cfg: SVDConfig) -> Layout:
    """The whole checkpoint's key set and shapes, under SVD_PREFIXES."""
    parts = {"unet": svd_unet_layout(cfg.unet), "vae": svd_vae_layout(cfg.vae, cfg.decoder),
             "clip_image": svd_image_encoder_layout(cfg.vision, cfg.unet.context_dim)}
    return {SVD_PREFIXES[part] + k: v for part, lay in parts.items() for k, v in lay.items()}


def random_svd_state_dict(cfg: SVDConfig, seed: int = 0, device="cpu", dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Random weights in `svd_layout`: N(0, 0.02) from one seeded generator
    in the layout's order, norms one, biases zero, mix factors at their
    initial values."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for k, (shape, kind) in svd_layout(cfg).items():
        if kind == "normal":
            out[k] = (torch.randn(shape, generator=gen, device=device) * 0.02).to(dtype)
        else:
            out[k] = torch.full(shape, float(kind), device=device, dtype=dtype)
    return out


def write_random_svd_checkpoint(path: str, cfg: SVDConfig, seed: int = 0, dtype=torch.float32) -> None:
    """One torch file of random weights in the diffusers layout (prefixed)."""
    torch.save(random_svd_state_dict(cfg, seed, "cpu", dtype), path)


_ENC_RENAMES = [
    (r"^encoder\.down_blocks\.(\d+)\.resnets\.(\d+)\.conv_shortcut\.", r"encoder.down.\1.block.\2.nin_shortcut."),
    (r"^encoder\.down_blocks\.(\d+)\.resnets\.(\d+)\.", r"encoder.down.\1.block.\2."),
    (r"^encoder\.down_blocks\.(\d+)\.downsamplers\.0\.conv\.", r"encoder.down.\1.downsample.conv."),
    (r"^encoder\.mid_block\.resnets\.0\.conv_shortcut\.", "encoder.mid.block_1.nin_shortcut."),
    (r"^encoder\.mid_block\.resnets\.0\.", "encoder.mid.block_1."),
    (r"^encoder\.mid_block\.resnets\.1\.", "encoder.mid.block_2."),
    (r"^encoder\.mid_block\.attentions\.0\.group_norm\.", "encoder.mid.attn_1.norm."),
    (r"^encoder\.mid_block\.attentions\.0\.to_q\.", "encoder.mid.attn_1.q."),
    (r"^encoder\.mid_block\.attentions\.0\.to_k\.", "encoder.mid.attn_1.k."),
    (r"^encoder\.mid_block\.attentions\.0\.to_v\.", "encoder.mid.attn_1.v."),
    (r"^encoder\.mid_block\.attentions\.0\.to_out\.0\.", "encoder.mid.attn_1.proj_out."),
    (r"^encoder\.conv_norm_out\.", "encoder.norm_out."),
]


def _vae_names(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The encoder's diffusers names -> vae.py's (its attention's linear
    weights as 1x1 convolutions); the decoder and quant_conv as they are."""
    out = {}
    for k, v in sd.items():
        if k.startswith("encoder."):
            for pat, rep in _ENC_RENAMES:
                k2 = re.sub(pat, rep, k)
                if k2 != k:
                    k = k2
                    break
            if ".mid.attn_1." in k and k.endswith(".weight") and v.dim() == 2:
                v = v[:, :, None, None]
        out[k] = v
    return out


def _clip_names(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """transformers' CLIP vision names -> clip.py's (open_clip's)."""
    out = {}
    for k, v in sd.items():
        if k.endswith("position_ids"):
            continue
        m = re.match(r"^vision_model\.encoder\.layers\.(\d+)\.(.*)$", k)
        if m:
            i, rest = m.groups()
            pre = f"transformer.resblocks.{i}"
            if rest.startswith("self_attn.") and rest.split(".")[1] in ("q_proj", "k_proj", "v_proj"):
                continue  # packed below
            rest = (rest.replace("self_attn.out_proj", "attn.out_proj").replace("layer_norm1", "ln_1")
                    .replace("layer_norm2", "ln_2").replace("mlp.fc1", "mlp.c_fc").replace("mlp.fc2", "mlp.c_proj"))
            out[f"{pre}.{rest}"] = v
            continue
        out[{"vision_model.embeddings.class_embedding": "class_embedding",
             "vision_model.embeddings.patch_embedding.weight": "conv1.weight",
             "vision_model.embeddings.position_embedding.weight": "positional_embedding",
             "vision_model.pre_layrnorm.weight": "ln_pre.weight",
             "vision_model.pre_layrnorm.bias": "ln_pre.bias",
             "vision_model.post_layernorm.weight": "ln_post.weight",
             "vision_model.post_layernorm.bias": "ln_post.bias",
             "visual_projection.weight": "proj.weight"}[k]] = v
    layers = {int(m.group(1)) for k in sd for m in [re.match(r"^vision_model\.encoder\.layers\.(\d+)\.", k)] if m}
    for i in sorted(layers):
        pre = f"vision_model.encoder.layers.{i}.self_attn"
        for kind in ("weight", "bias"):
            out[f"transformer.resblocks.{i}.attn.in_proj_{kind}"] = torch.cat(
                [sd[f"{pre}.{nm}_proj.{kind}"] for nm in "qkv"])
    return out


def convert_svd_state_dict(sd: Dict[str, torch.Tensor], device="cpu", dtype=None) -> SVDParams:
    """A prefixed diffusers-layout state dict (`svd_layout`) -> SVDParams on
    `device`, floating tensors cast to `dtype` when given."""
    parts: Dict[str, Dict[str, torch.Tensor]] = {name: {} for name in SVD_PREFIXES}
    for k, v in sd.items():
        for name, prefix in SVD_PREFIXES.items():
            if k.startswith(prefix):
                parts[name][k[len(prefix):]] = v
                break
    parts["vae"] = _vae_names(parts["vae"])
    parts["clip_image"] = _clip_names(parts["clip_image"])

    def place(d):
        return {k: (v.to(device, dtype) if dtype is not None and v.is_floating_point() else v.to(device))
                for k, v in d.items()}

    return SVDParams(unet=place(parts["unet"]), vae=place(parts["vae"]), clip_image=place(parts["clip_image"]))


def _read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        from guidedvd3dgs_tpu_torch.guidance.dpt import read_safetensors

        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in read_safetensors(path).items()}
    return torch.load(path, map_location="cpu", weights_only=True)


def _repo_file(directory: str) -> str:
    """The weights file of a diffusers sub-folder: .safetensors first."""
    names = sorted(os.listdir(directory))
    for ext in (".safetensors", ".bin"):
        found = [n for n in names if n.endswith(ext)]
        if found:
            return os.path.join(directory, found[0])
    raise FileNotFoundError(f"no .safetensors or .bin weights in {directory}")


def load_svd_checkpoint(path: str, device="cpu", dtype=None) -> SVDParams:
    """SVD-XT's weights (module docstring) as SVDParams on `device`."""
    if os.path.isdir(path):
        sd = {}
        for name, folder in (("unet", "unet"), ("vae", "vae"), ("clip_image", "image_encoder")):
            for k, v in _read_state_dict(_repo_file(os.path.join(path, folder))).items():
                sd[SVD_PREFIXES[name] + k] = v
    else:
        sd = _read_state_dict(path)
    return convert_svd_state_dict(sd, device, dtype)
