"""LPIPS (alex / vgg16 / squeeze) as torch modules.

Counterpart of `guidedvd3dgs_tpu/metrics/lpips.py` (reference
lpipsPyTorch): z-score the input with the LPIPS shift and scale, run the
backbone, unit-normalise each tapped activation over channels, square the
difference, weight the channels by the learned 1x1 `lin` weights, average
over space and sum over the taps. The eval conventions are the callers':
vgg on [0, 1] inputs, alex on [-1, 1] (metrics.py). The backbones are
library convolutions (`F.conv2d`), as the JAX package's are XLA's. (It
lives under utils/ because `metrics` is the name of the port's CLI
module.)

Weights: a torchvision alexnet / vgg16 / squeezenet1_1 state dict (its
`features.*` entries) and the LPIPS v0.1 `lin` weights. None ships with
the repository: `load_lpips` returns None when no file is found, and
metrics.py then writes null. `random_lpips_state_dicts` draws random
weights in those layouts for tests and timing; they are no substitute for
the real ones.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)

# torchvision `features` convolutions: index -> (out, in, kernel, stride, padding)
_ALEX = {0: (64, 3, 11, 4, 2), 3: (192, 64, 5, 1, 2), 6: (384, 192, 3, 1, 1), 8: (256, 384, 3, 1, 1),
         10: (256, 256, 3, 1, 1)}
_VGG16_BLOCKS = [[0, 2], [5, 7], [10, 12, 14], [17, 19, 21], [24, 26, 28]]
_VGG16 = {0: (64, 3), 2: (64, 64), 5: (128, 64), 7: (128, 128), 10: (256, 128), 12: (256, 256),
          14: (256, 256), 17: (512, 256), 19: (512, 512), 21: (512, 512), 24: (512, 512),
          26: (512, 512), 28: (512, 512)}
# squeezenet1_1 Fire modules: index -> (in, squeeze, expand1x1, expand3x3)
_FIRES = {3: (64, 16, 64, 64), 4: (128, 16, 64, 64), 6: (128, 32, 128, 128), 7: (256, 32, 128, 128),
          9: (256, 48, 192, 192), 10: (384, 48, 192, 192), 11: (384, 64, 256, 256),
          12: (512, 64, 256, 256)}
TAP_CHANNELS = {"alex": (64, 192, 384, 256, 256), "vgg": (64, 128, 256, 512, 512),
                "squeeze": (64, 128, 256, 384, 384, 512, 512)}
_FILES = {"alex": "alexnet*", "vgg": "vgg16*", "squeeze": "squeezenet*"}


def _conv(p, name, x, stride=1, padding=0):
    return F.conv2d(x, p[f"{name}.weight"], p[f"{name}.bias"], stride=stride, padding=padding)


def _alex_features(p, x) -> List[torch.Tensor]:
    """alexnet.features' ReLU outputs at layers 1, 4, 7, 9, 11."""
    feats = []
    for i, (idx, (_, _, _, stride, pad)) in enumerate(_ALEX.items()):
        if i in (1, 2):
            x = F.max_pool2d(x, 3, 2)
        x = F.relu(_conv(p, str(idx), x, stride, pad))
        feats.append(x)
    return feats


def _vgg16_features(p, x) -> List[torch.Tensor]:
    """vgg16.features' last ReLU of each block (layers 3, 8, 15, 22, 29)."""
    feats = []
    for bi, convs in enumerate(_VGG16_BLOCKS):
        if bi > 0:
            x = F.max_pool2d(x, 2, 2)
        for ci in convs:
            x = F.relu(_conv(p, str(ci), x, padding=1))
        feats.append(x)
    return feats


def _fire(p, idx: int, x):
    s = F.relu(_conv(p, f"{idx}.squeeze", x))
    return torch.cat([F.relu(_conv(p, f"{idx}.expand1x1", s)),
                      F.relu(_conv(p, f"{idx}.expand3x3", s, padding=1))], dim=1)


def _squeeze_features(p, x) -> List[torch.Tensor]:
    """squeezenet1_1.features in LPIPS' 7 slices."""
    feats = [F.relu(_conv(p, "0", x, stride=2))]
    x = F.max_pool2d(feats[-1], 3, 2, ceil_mode=True)
    feats.append(_fire(p, 4, _fire(p, 3, x)))
    x = F.max_pool2d(feats[-1], 3, 2, ceil_mode=True)
    feats.append(_fire(p, 7, _fire(p, 6, x)))
    x = F.max_pool2d(feats[-1], 3, 2, ceil_mode=True)
    for idx in (9, 10, 11, 12):
        feats.append(_fire(p, idx, feats[-1] if idx > 9 else x))
    return feats


_FEATURE_FNS = {"alex": _alex_features, "vgg": _vgg16_features, "squeeze": _squeeze_features}


def _normalize_activation(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """LPIPS of one backbone. `backbone`: the `features.*` tensors with the
    prefix dropped ('0.weight', '3.squeeze.bias', ...); `lin`: {'<i>.weight':
    (1, C, 1, 1)} per tap."""

    def __init__(self, net_type: str, backbone: Dict[str, torch.Tensor], lin: Dict[str, torch.Tensor]):
        super().__init__()
        self.net_type = net_type
        self.backbone = nn.ParameterDict({k.replace(".", "_"): nn.Parameter(v, requires_grad=False)
                                          for k, v in backbone.items()})
        self.lin = nn.ParameterList([nn.Parameter(lin[f"{i}.weight"], requires_grad=False)
                                     for i in range(len(TAP_CHANNELS[net_type]))])
        self.register_buffer("shift", torch.tensor(SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(SCALE).view(1, 3, 1, 1))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y: (N, 3, H, W). Returns the (N,) distances."""
        p = {k.replace("_", "."): v for k, v in self.backbone.items()}
        feat = _FEATURE_FNS[self.net_type]
        fx = feat(p, (x - self.shift) / self.scale)
        fy = feat(p, (y - self.shift) / self.scale)
        total = 0.0
        for a, b, w in zip(fx, fy, self.lin):
            d = (_normalize_activation(a) - _normalize_activation(b)) ** 2
            total = total + torch.mean(torch.sum(d * w, dim=1), dim=(1, 2))
        return total


def _search_dirs(weights_dir: Optional[str]) -> List[str]:
    dirs = [d for d in [weights_dir, os.environ.get("LPIPS_WEIGHTS_DIR")] if d]
    return dirs + [os.path.join(torch.hub.get_dir(), "checkpoints")]


def load_lpips(net_type: str = "alex", weights_dir: Optional[str] = None) -> Optional[LPIPS]:
    """LPIPS with a torchvision backbone file (`alexnet*`, `vgg16*`,
    `squeezenet*`) and an LPIPS v0.1 `lin` file (`*<net_type>*.pth` whose
    keys name `lin`), searched in `weights_dir`, $LPIPS_WEIGHTS_DIR and the
    torch hub cache (the last match wins); None when either is missing.
    Nothing is downloaded. On the CPU: move it with `.to(device)`."""
    backbone_sd = lin_sd = None
    for d in _search_dirs(weights_dir):
        if not os.path.isdir(d):
            continue
        for f in sorted(glob.glob(os.path.join(d, _FILES[net_type]))):
            backbone_sd = torch.load(f, map_location="cpu", weights_only=True)
        for f in sorted(glob.glob(os.path.join(d, f"*{net_type}*.pth"))):
            sd = torch.load(f, map_location="cpu", weights_only=True)
            if any("lin" in k for k in sd):
                lin_sd = sd
    if backbone_sd is None or lin_sd is None:
        return None
    backbone = {k[len("features."):]: v.float() for k, v in backbone_sd.items() if k.startswith("features.")}
    # 'lin0.model.1.weight' -> '0.weight'
    lin = {f"{k.split('lin')[1].split('.')[0]}.weight": v.float() for k, v in lin_sd.items()
           if "lin" in k and k.endswith("weight")}
    return LPIPS(net_type, backbone, lin)


def random_lpips_state_dicts(net_type: str, seed: int = 0) -> Tuple[dict, dict]:
    """(torchvision backbone state dict, LPIPS v0.1 lin state dict) of
    random weights: He-normal convolutions and zero biases in layer order,
    then lin weights uniform in [0, 0.2), all from numpy's
    default_rng(seed)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, cout, cin, k):
        w = rng.normal(scale=(2.0 / (k * k * cin)) ** 0.5, size=(cout, cin, k, k))
        sd[f"features.{name}.weight"] = torch.tensor(w, dtype=torch.float32)
        sd[f"features.{name}.bias"] = torch.zeros(cout)

    if net_type == "alex":
        for idx, (cout, cin, k, _, _) in _ALEX.items():
            conv(idx, cout, cin, k)
    elif net_type == "vgg":
        for idx, (cout, cin) in _VGG16.items():
            conv(idx, cout, cin, 3)
    else:
        conv(0, 64, 3, 3)
        for idx, (cin, sq, e1, e3) in _FIRES.items():
            conv(f"{idx}.squeeze", sq, cin, 1)
            conv(f"{idx}.expand1x1", e1, sq, 1)
            conv(f"{idx}.expand3x3", e3, sq, 3)
    lin = {f"lin{i}.model.1.weight": torch.tensor(rng.uniform(0.0, 0.2, (1, c, 1, 1)), dtype=torch.float32)
           for i, c in enumerate(TAP_CHANNELS[net_type])}
    return sd, lin


LPIPS_FILES = {"alex": ("alexnet-owt-7be5be79.pth", "alex.pth"), "vgg": ("vgg16-397923af.pth", "vgg.pth"),
               "squeeze": ("squeezenet1_1-b8a52dc0.pth", "squeeze.pth")}


def write_random_lpips(weights_dir: str, seed: int = 0, nets=("alex", "vgg")) -> None:
    """Write random_lpips_state_dicts of each net to `weights_dir` under
    the torchvision and LPIPS v0.1 file names that load_lpips finds."""
    os.makedirs(weights_dir, exist_ok=True)
    for i, net in enumerate(nets):
        backbone, lin = random_lpips_state_dicts(net, seed + i)
        for sd, name in zip((backbone, lin), LPIPS_FILES[net]):
            torch.save(sd, os.path.join(weights_dir, name))
