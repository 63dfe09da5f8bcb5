"""Binary mask morphology: erosion and dilation with a square window.

Counterpart of `guidedvd3dgs_tpu/guidance/morphology.py` (reference
utils/viewcrafter_wrapper.py:602-651, scipy.ndimage binary_erosion /
binary_dilation). scipy pads with border_value 0 for both, so a border
pixel erodes: the mask is padded with 0 (`size // 2` before, the rest
after, so an even window is off centre as scipy's) and the window runs
unpadded, as max_pool2d (erosion as -max_pool2d(-x)). max_pool2d's own
padding would pad with -inf instead of 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _window(x: torch.Tensor, size: int, sign: float) -> torch.Tensor:
    """sign * max over a size x size window of sign * x, x (..., H, W)
    zero-padded first (sign -1: the window's min)."""
    lo = size // 2
    hi = size - 1 - lo
    shape = x.shape
    xp = F.pad(x.to(torch.float32).reshape(-1, 1, *shape[-2:]), (lo, hi, lo, hi), value=0.0)
    return (sign * F.max_pool2d(sign * xp, size, stride=1)).reshape(shape)


def erode(mask: torch.Tensor, size: int = 3) -> torch.Tensor:
    """Binary erosion of (..., H, W) masks in {0, 1} (float or bool):
    float32 out."""
    return _window(mask, size, -1.0)


def dilate(mask: torch.Tensor, size: int = 5) -> torch.Tensor:
    return _window(mask, size, 1.0)


def unobserved_regions(renders: torch.Tensor) -> torch.Tensor:
    """(N, 3, H, W) renders in [0, 1] -> (N, 1, H, W) masks of the pixels
    no point reached: (sum == 0) eroded by 3, then dilated by 5."""
    empty = (renders.sum(dim=1) == 0.0).to(torch.float32)
    return dilate(erode(empty, 3), 5)[:, None]


def process_mask(masks: torch.Tensor, erode_size: int = 5) -> torch.Tensor:
    """(N, 1, H, W) masks eroded by `erode_size`."""
    return erode(masks, erode_size)
