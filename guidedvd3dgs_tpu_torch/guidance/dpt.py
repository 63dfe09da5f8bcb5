"""The DPT monocular depth network (MiDaS v3 "dpt_large") over a
torch-named parameter dict.

Counterpart of `guidedvd3dgs_tpu/guidance/dpt.py` (the reference's
utils/midas_depth_estimator.py:9-39, whose relative depth lifts the
diffusion frames to points on the append_pcd_from_video_diffusion path).
The parameter names are HuggingFace `DPTForDepthEstimation`'s state dict,
so Intel/dpt-large weights load unchanged (`load_hf_dpt_weights`, from
.safetensors without the safetensors package, or from a torch .bin).

  ViT backbone (patch-16 conv, cls token, resized position embedding,
  pre-LN blocks, LayerNorm eps 1e-12) -> 4 tapped hidden states ->
  reassemble (readout projection, 1x1 projection, resize by 4, 2, 1, 1/2)
  -> neck 3x3 convs -> fusion (pre-activation residual units, align-corners
  2x upsampling) -> head (conv, 2x upsample, conv, relu, 1x1, relu).

Activations are channels-last at the public functions, as in the JAX
package. The attention is its plain product, softmax and product.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from guidedvd3dgs_tpu_torch.utils.general import resize_bilinear

Params = Dict[str, torch.Tensor]

MIDAS_MEAN = (0.5, 0.5, 0.5)
MIDAS_STD = (0.5, 0.5, 0.5)
LN_EPS = 1e-12


@dataclass(frozen=True)
class DPTConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    patch_size: int = 16
    pos_grid: int = 24  # the trained position-embedding grid (384 / 16)
    out_indices: Tuple[int, ...] = (5, 11, 17, 23)
    neck_hidden: Tuple[int, ...] = (256, 512, 1024, 1024)
    reassemble_factors: Tuple[float, ...] = (4.0, 2.0, 1.0, 0.5)
    fusion_hidden: int = 256


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _conv(p: Params, name: str, x: torch.Tensor, stride: int = 1, padding="same") -> torch.Tensor:
    """NHWC conv with an OIHW weight; 'same' pads (k - 1) / 2 (k odd)."""
    w = p[f"{name}.weight"]
    pad = (w.shape[-1] - 1) // 2 if padding == "same" else 0
    return _nhwc(F.conv2d(_nchw(x), w, p.get(f"{name}.bias"), stride=stride, padding=pad))


def _conv_transpose(p: Params, name: str, x: torch.Tensor, stride: int) -> torch.Tensor:
    return _nhwc(F.conv_transpose2d(_nchw(x), p[f"{name}.weight"], p[f"{name}.bias"], stride=stride))


def _linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def _ln(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], LN_EPS)


def _vit_layer(p: Params, pre: str, x: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, c = x.shape
    h = _ln(p, f"{pre}.layernorm_before", x)

    def split(t):
        return t.reshape(b, n, heads, c // heads).transpose(1, 2)

    q, k, v = (split(_linear(p, f"{pre}.attention.attention.{nm}", h)) for nm in ("query", "key", "value"))
    att = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * (c // heads) ** -0.5, dim=-1)
    o = torch.matmul(att, v).transpose(1, 2).reshape(b, n, c)
    x = x + _linear(p, f"{pre}.attention.output.dense", o)
    h = F.gelu(_linear(p, f"{pre}.intermediate.dense", _ln(p, f"{pre}.layernorm_after", x)))
    return x + _linear(p, f"{pre}.output.dense", h)


def _resize_pos_embed(pos: torch.Tensor, gh: int, gw: int, grid0: int) -> torch.Tensor:
    """The trained grid's position embedding bilinearly resized (no
    antialiasing) to the input's patch grid."""
    tok, grid = pos[:, :1], pos[0, 1:].reshape(1, grid0, grid0, -1)
    if (gh, gw) != (grid0, grid0):
        grid = _nhwc(F.interpolate(_nchw(grid), size=(gh, gw), mode="bilinear", align_corners=False))
    return torch.cat([tok, grid.reshape(1, gh * gw, -1)], dim=1)


def _upsample_align_corners(x: torch.Tensor, h2: int, w2: int) -> torch.Tensor:
    return _nhwc(F.interpolate(_nchw(x), size=(h2, w2), mode="bilinear", align_corners=True))


def _residual_unit(p: Params, pre: str, x: torch.Tensor) -> torch.Tensor:
    h = _conv(p, f"{pre}.convolution1", F.relu(x))
    return x + _conv(p, f"{pre}.convolution2", F.relu(h))


def dpt_forward(p: Params, cfg: DPTConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """pixel_values (B, H, W, 3), MiDaS-normalised, H and W multiples of the
    patch size -> relative inverse depth (B, H, W)."""
    b, H, W, _ = pixel_values.shape
    ps = cfg.patch_size
    gh, gw = H // ps, W // ps
    x = _conv(p, "dpt.embeddings.patch_embeddings.projection", pixel_values, stride=ps, padding="valid")
    x = x.reshape(b, gh * gw, cfg.hidden_size)
    cls = p["dpt.embeddings.cls_token"].expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    x = x + _resize_pos_embed(p["dpt.embeddings.position_embeddings"], gh, gw, cfg.pos_grid)

    taps: List[torch.Tensor] = []
    for i in range(cfg.num_layers):
        x = _vit_layer(p, f"dpt.encoder.layer.{i}", x, cfg.num_heads)
        if i in cfg.out_indices:
            taps.append(x)

    feats = []
    for i, t in enumerate(taps):  # reassemble (readout "project") and the neck convs
        tok = t[:, 1:]
        h = torch.cat([tok, t[:, :1].expand_as(tok)], dim=-1)
        h = F.gelu(_linear(p, f"neck.reassemble_stage.readout_projects.{i}.0", h))
        h = _conv(p, f"neck.reassemble_stage.layers.{i}.projection", h.reshape(b, gh, gw, cfg.hidden_size))
        f = cfg.reassemble_factors[i]
        if f > 1:
            h = _conv_transpose(p, f"neck.reassemble_stage.layers.{i}.resize", h, int(f))
        elif f < 1:
            h = _conv(p, f"neck.reassemble_stage.layers.{i}.resize", h, stride=int(round(1 / f)))
        feats.append(_conv(p, f"neck.convs.{i}", h))

    fused = None
    for k, h in enumerate(feats[::-1]):  # coarsest first
        pre = f"neck.fusion_stage.layers.{k}"
        fused = h if fused is None else fused + _residual_unit(p, f"{pre}.residual_layer1", h)
        fused = _residual_unit(p, f"{pre}.residual_layer2", fused)
        fused = _upsample_align_corners(fused, fused.shape[1] * 2, fused.shape[2] * 2)
        fused = _conv(p, f"{pre}.projection", fused)

    h = _conv(p, "head.head.0", fused)
    h = _upsample_align_corners(h, h.shape[1] * 2, h.shape[2] * 2)
    h = F.relu(_conv(p, "head.head.2", h))
    return F.relu(_conv(p, "head.head.4", h))[..., 0]


def midas_preprocess(frames: torch.Tensor, height: int = 384, width: int = 512) -> torch.Tensor:
    """(T, H, W, 3) in [-1, 1] -> MiDaS-normalised (T, height, width, 3)
    (midas_depth_estimator.py:16-39)."""
    x = torch.clamp((frames + 1.0) / 2.0, 0.0, 1.0)
    x = resize_bilinear(x, height, width)
    mean = torch.tensor(MIDAS_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(MIDAS_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def make_depth_estimator(params: Params, cfg: DPTConfig = DPTConfig(), height: int = 384,
                         width: int = 512) -> Callable[[torch.Tensor], torch.Tensor]:
    """`estimator(frames (T, H, W, 3) in [-1, 1])` -> (T, H, W) relative
    inverse depth at the frames' size, on the parameters' device, without
    autograd: the guided trainer's depth_estimator."""
    dev = next(iter(params.values())).device

    @torch.no_grad()
    def estimator(frames: torch.Tensor) -> torch.Tensor:
        frames = torch.as_tensor(frames, dtype=torch.float32).to(dev)
        t, h0, w0 = frames.shape[:3]
        d = dpt_forward(params, cfg, midas_preprocess(frames, height, width))
        return resize_bilinear(d[..., None], h0, w0)[..., 0]

    return estimator


def init_dpt_params(cfg: DPTConfig = DPTConfig(), seed: int = 0) -> Dict[str, np.ndarray]:
    """Random float32 weights with HuggingFace's exact key set: the JAX
    package's draws, in its order (N(0, 0.02) weights, zero biases, unit
    LayerNorm)."""
    rng = np.random.default_rng(seed)
    p: Dict[str, np.ndarray] = {}

    def normal(shape, scale=0.02):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def zeros(n):
        return np.zeros((n,), np.float32)

    c = cfg.hidden_size
    p["dpt.embeddings.cls_token"] = normal((1, 1, c))
    p["dpt.embeddings.position_embeddings"] = normal((1, cfg.pos_grid ** 2 + 1, c))
    p["dpt.embeddings.patch_embeddings.projection.weight"] = normal((c, 3, cfg.patch_size, cfg.patch_size))
    p["dpt.embeddings.patch_embeddings.projection.bias"] = zeros(c)
    for i in range(cfg.num_layers):
        pre = f"dpt.encoder.layer.{i}"
        for nm in ("query", "key", "value"):
            p[f"{pre}.attention.attention.{nm}.weight"] = normal((c, c))
            p[f"{pre}.attention.attention.{nm}.bias"] = zeros(c)
        p[f"{pre}.attention.output.dense.weight"] = normal((c, c))
        p[f"{pre}.attention.output.dense.bias"] = zeros(c)
        p[f"{pre}.intermediate.dense.weight"] = normal((cfg.mlp_dim, c))
        p[f"{pre}.intermediate.dense.bias"] = zeros(cfg.mlp_dim)
        p[f"{pre}.output.dense.weight"] = normal((c, cfg.mlp_dim))
        p[f"{pre}.output.dense.bias"] = zeros(c)
        for ln in ("layernorm_before", "layernorm_after"):
            p[f"{pre}.{ln}.weight"] = np.ones((c,), np.float32)
            p[f"{pre}.{ln}.bias"] = zeros(c)
    for i, (nh, f) in enumerate(zip(cfg.neck_hidden, cfg.reassemble_factors)):
        p[f"neck.reassemble_stage.readout_projects.{i}.0.weight"] = normal((c, 2 * c))
        p[f"neck.reassemble_stage.readout_projects.{i}.0.bias"] = zeros(c)
        p[f"neck.reassemble_stage.layers.{i}.projection.weight"] = normal((nh, c, 1, 1))
        p[f"neck.reassemble_stage.layers.{i}.projection.bias"] = zeros(nh)
        if f != 1:
            k = int(f) if f > 1 else 3
            p[f"neck.reassemble_stage.layers.{i}.resize.weight"] = normal((nh, nh, k, k))
            p[f"neck.reassemble_stage.layers.{i}.resize.bias"] = zeros(nh)
        p[f"neck.convs.{i}.weight"] = normal((cfg.fusion_hidden, nh, 3, 3))
    fh = cfg.fusion_hidden
    for k in range(len(cfg.neck_hidden)):
        pre = f"neck.fusion_stage.layers.{k}"
        p[f"{pre}.projection.weight"] = normal((fh, fh, 1, 1))
        p[f"{pre}.projection.bias"] = zeros(fh)
        for r in (1, 2):
            for cv in (1, 2):
                p[f"{pre}.residual_layer{r}.convolution{cv}.weight"] = normal((fh, fh, 3, 3))
                p[f"{pre}.residual_layer{r}.convolution{cv}.bias"] = zeros(fh)
    p["head.head.0.weight"] = normal((fh // 2, fh, 3, 3))
    p["head.head.0.bias"] = zeros(fh // 2)
    p["head.head.2.weight"] = normal((32, fh // 2, 3, 3))
    p["head.head.2.bias"] = zeros(32)
    p["head.head.4.weight"] = normal((1, 32, 1, 1))
    p["head.head.4.bias"] = zeros(1)
    return p


_SAFETENSORS_DTYPES = {"F32": np.float32, "F16": np.float16, "F64": np.float64, "I64": np.int64,
                       "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A .safetensors file without the safetensors package: an 8-byte
    little-endian header length, the JSON header (name -> dtype, shape,
    data_offsets into the byte buffer after it; '__metadata__' skipped),
    then the raw little-endian tensors. BF16 becomes float32."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n).decode("utf-8"))
        buf = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        raw = buf[start:end]
        if info["dtype"] == "BF16":
            bits = np.frombuffer(raw, "<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        else:
            arr = np.frombuffer(raw, np.dtype(_SAFETENSORS_DTYPES[info["dtype"]]).newbyteorder("<"))
        out[name] = arr.reshape(info["shape"]).copy()
    return out


def load_hf_dpt_weights(path: str) -> Dict[str, np.ndarray]:
    """An HF DPTForDepthEstimation checkpoint (.safetensors, or a torch .bin
    through torch.load(weights_only=True)), keys verbatim."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() if v.is_floating_point() else v.numpy() for k, v in sd.items()}


def params_to_device(params: Dict[str, np.ndarray], device) -> Params:
    """float32 tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device) for k, v in params.items()}
