"""VGG19 perceptual loss: the plain reference's frozen copy of the port's
`utils/vgg_loss.py::vgg19_block_features` and `vgg_perceptual_loss`
(reference VggLoss, utils/vgg_loss.py:4-53): features after each block's
last ReLU before a pool, the inputs ImageNet-normalised and resized to
224 x 224, the sum over blocks of the feature MSE."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

VGG_MEAN = (0.485, 0.456, 0.406)
VGG_STD = (0.229, 0.224, 0.225)
BLOCK_CONVS = [[0, 2], [5, 7], [10, 12, 14, 16], [19, 21, 23, 25], [28, 30, 32, 34]]
CHANNELS = {0: (3, 64), 2: (64, 64), 5: (64, 128), 7: (128, 128), 10: (128, 256), 12: (256, 256),
            14: (256, 256), 16: (256, 256), 19: (256, 512), 21: (512, 512), 23: (512, 512),
            25: (512, 512), 28: (512, 512), 30: (512, 512), 32: (512, 512), 34: (512, 512)}


def features(p: Dict[str, torch.Tensor], x: torch.Tensor):
    feats = []
    for bi, convs in enumerate(BLOCK_CONVS):
        if bi > 0:
            x = F.max_pool2d(x, 2)
        for ci in convs:
            x = F.relu(F.conv2d(x, p[f"features.{ci}.weight"].to(x.dtype), p[f"features.{ci}.bias"].to(x.dtype),
                                padding=1))
        feats.append(x)
    return feats


def perceptual_loss(p: Dict[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x, y: (N, 3, H, W) in [0, 1]; the mean of each block over the batch."""
    mean = torch.tensor(VGG_MEAN, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(VGG_STD, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    xi, yi = (x - mean) / std, (y - mean) / std
    shrink = x.shape[-2] > 224 or x.shape[-1] > 224
    xi, yi = (F.interpolate(t, size=(224, 224), mode="bilinear", align_corners=False, antialias=shrink)
              for t in (xi, yi))
    loss = 0.0
    for fx, fy in zip(features(p, xi), features(p, yi)):
        loss = loss + torch.mean(torch.square(fx - fy))
    return loss
