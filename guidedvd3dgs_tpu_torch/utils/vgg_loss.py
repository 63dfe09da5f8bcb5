"""VGG19 perceptual loss.

Counterpart of `guidedvd3dgs_tpu/utils/vgg_loss.py` (reference VggLoss,
utils/vgg_loss.py:4-53): VGG19 features split after each block's last
ReLU before a pool (torchvision `features` indices [:4], [4:9], [9:18],
[18:27], [27:36]); the inputs ImageNet-normalised and resized to 224x224
(optionally masked); the loss is the sum over blocks of the feature MSE.

Weights are a torchvision vgg19 state dict (its `features.*` entries, torch
layouts, read as they are). None ships with the repository: `load_vgg19`
returns None when no file is found, and callers announce the term as off.
`random_vgg19` draws the JAX package's random weights (same generator, same
order) for tests and timing; they are no substitute for the real ones.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

VGG_MEAN = (0.485, 0.456, 0.406)
VGG_STD = (0.229, 0.224, 0.225)

# torchvision vgg19.features conv indices per block (a ReLU after each;
# pools at 4, 9, 18, 27, 36)
_BLOCK_CONVS = [
    [0, 2],  # block 1 (features[:4])
    [5, 7],  # block 2 (features[4:9])
    [10, 12, 14, 16],  # block 3
    [19, 21, 23, 25],  # block 4
    [28, 30, 32, 34],  # block 5
]
_CHANNELS = {0: (3, 64), 2: (64, 64), 5: (64, 128), 7: (128, 128),
             10: (128, 256), 12: (256, 256), 14: (256, 256), 16: (256, 256),
             19: (256, 512), 21: (512, 512), 23: (512, 512), 25: (512, 512),
             28: (512, 512), 30: (512, 512), 32: (512, 512), 34: (512, 512)}


def vgg19_block_features(p: Params, x: torch.Tensor):
    """x: (N, 3, H, W) normalised. The 5 block outputs, NCHW."""
    feats = []
    for bi, convs in enumerate(_BLOCK_CONVS):
        if bi > 0:
            x = F.max_pool2d(x, 2)
        for ci in convs:
            x = F.relu(F.conv2d(x, p[f"features.{ci}.weight"], p[f"features.{ci}.bias"], padding=1))
        feats.append(x)
    return feats


def vgg_perceptual_loss(p: Params, x: torch.Tensor, y: torch.Tensor, mask: Optional[torch.Tensor] = None,
                        resize: bool = True, per_sample: bool = False) -> torch.Tensor:
    """x, y: (N, 3, H, W) in [0, 1]; mask (N, 1, H, W). The resize is
    bilinear, antialiased where it shrinks, as jax.image.resize; the mask's
    is nearest with the pixel-centre rule ("nearest-exact"). An image no
    larger than 224 in either dimension is enlarged by the plain bilinear
    (the same weights as the antialiased one there, fewer roundings: the
    max-pools' gradients switch on rounding-sized changes). A scalar, the
    mean of each block over the batch; with `per_sample`, (N,) losses, each
    sample's own means (the loss of each image alone)."""
    mean = torch.tensor(VGG_MEAN, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(VGG_STD, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    xi, yi = (x - mean) / std, (y - mean) / std
    if resize:
        shrink = x.shape[-2] > 224 or x.shape[-1] > 224
        xi, yi = (F.interpolate(t, size=(224, 224), mode="bilinear", align_corners=False, antialias=shrink)
                  for t in (xi, yi))
        if mask is not None:
            m = F.interpolate(mask.to(xi.dtype), size=(224, 224), mode="nearest-exact")
            xi, yi = xi * m, yi * m
    dims = (1, 2, 3) if per_sample else (0, 1, 2, 3)
    loss = 0.0
    for fx, fy in zip(vgg19_block_features(p, xi), vgg19_block_features(p, yi)):
        loss = loss + torch.mean(torch.square(fx - fy), dim=dims)
    return loss


def _hub_candidates():
    hub = os.path.join(torch.hub.get_dir(), "checkpoints")
    if not os.path.isdir(hub):
        return []
    return [os.path.join(hub, f) for f in sorted(os.listdir(hub)) if f.startswith("vgg19")]


def load_vgg19(path: Optional[str] = None, device="cpu") -> Optional[Params]:
    """The `features.*` tensors of a torchvision vgg19 state dict (.pth),
    float32 on `device`, from `path`, else the VGG19_WEIGHTS environment
    variable, else a vgg19 file in the torch hub cache; None when there is
    none. Nothing is downloaded."""
    for c in [path, os.environ.get("VGG19_WEIGHTS")] + _hub_candidates():
        if c and os.path.exists(c):
            sd = torch.load(c, map_location="cpu", weights_only=False)
            sd = sd.get("state_dict", sd)
            return {k: torch.as_tensor(v).to(device, torch.float32) for k, v in sd.items()
                    if k.startswith("features.")}
    return None


def random_vgg19(seed: int = 0, device="cpu") -> Params:
    """Random VGG19 feature weights, the JAX package's draw (He-normal
    convolutions from numpy's default_rng(seed) in layer order, zero
    biases): the real architecture at its real cost, for tests and timing."""
    rng = np.random.default_rng(seed)
    p: Params = {}
    for ci, (cin, cout) in _CHANNELS.items():
        w = rng.normal(scale=(2.0 / (9 * cin)) ** 0.5, size=(cout, cin, 3, 3))
        p[f"features.{ci}.weight"] = torch.as_tensor(w, dtype=torch.float32, device=device)
        p[f"features.{ci}.bias"] = torch.zeros((cout,), dtype=torch.float32, device=device)
    return p


def make_vgg_loss_fn(path: Optional[str] = None, random_init: bool = False) -> Optional[Callable]:
    """fn(x, y, mask=None, per_sample=False) -> vgg_perceptual_loss, with
    the weights of `load_vgg19(path)` (random_vgg19() if none is found and
    `random_init`), copied once to each device the inputs come on; None
    when there are no weights."""
    p = load_vgg19(path)
    if p is None and random_init:
        p = random_vgg19()
    if p is None:
        return None
    on_device = {torch.device("cpu"): p}

    def fn(x, y, mask=None, per_sample=False):
        pd = on_device.get(x.device)
        if pd is None:
            pd = on_device[x.device] = {k: v.to(x.device) for k, v in p.items()}
        return vgg_perceptual_loss(pd, x, y, mask, per_sample=per_sample)

    return fn


def frame_lpips_fn(vgg_fn: Callable) -> Callable:
    """The guidance's perceptual term from a make_vgg_loss_fn function:
    lpips_fn(d, g, mask) of (c, H, W, 3) frames in [0, 1] -> (c,), each
    frame's VGG loss alone, as the JAX CLI's call on one frame (its mask
    unused there too, JAX train_guidedvd.py:223-228)."""
    return lambda d, g, mask: vgg_fn(d.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2), per_sample=True)
