"""General math helpers: the opacity activation's inverse, the position
learning-rate schedule, the guidance-weight warmup, quaternion -> rotation
matrix, and `jax.image.resize`'s bilinear resize.

Counterpart of `guidedvd3dgs_tpu/utils/general.py`. Quaternions are
(w, x, y, z) throughout.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def inverse_sigmoid(x):
    return torch.log(x / (1 - x))


def get_expon_lr_func(
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1000000,
):
    """Log-linear interpolation from lr_init to lr_final over max_steps,
    with an optional sine delay; a host-side callable of the step."""

    def helper(step):
        if lr_init == 0.0 and lr_final == 0.0:
            return 0.0
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
                0.5 * np.pi * np.clip(step / lr_delay_steps, 0, 1)
            )
        else:
            delay_rate = 1.0
        t = np.clip(step / max_steps, 0, 1)
        log_lerp = np.exp(np.log(lr_init) * (1 - t) + np.log(lr_final) * t)
        return 0.0 if step < 0 else float(delay_rate * log_lerp)

    return helper


def learning_rate_decay(step, lr_init, lr_final, max_steps, lr_delay_steps=0, lr_delay_mult=1):
    """mip-NeRF style log-lerp decay (reference utils/viewcrafter_wrapper.py
    :663-691 learning_rate_decay/log_lerp; used for the optional
    guidance-weight warmup)."""
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
            0.5 * np.pi * np.clip(step / lr_delay_steps, 0, 1)
        )
    else:
        delay_rate = 1.0
    t = np.clip(step / max_steps, 0, 1)
    return delay_rate * np.exp(t * (np.log(lr_final) - np.log(lr_init)) + np.log(lr_init))


def build_rotation(q: torch.Tensor) -> torch.Tensor:
    """Quaternions (..., 4) -> rotation matrices (..., 3, 3), normalizing
    first."""
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack(
        [
            1 - 2 * (y * y + z * z),
            2 * (x * y - r * z),
            2 * (x * z + r * y),
            2 * (x * y + r * z),
            1 - 2 * (x * x + z * z),
            2 * (y * z - r * x),
            2 * (x * z - r * y),
            2 * (y * z + r * x),
            1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return R.reshape(*q.shape[:-1], 3, 3)


def resize_bilinear(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(..., H, W, C) at (height, width) as `jax.image.resize(...,
    "bilinear")`: half-pixel centres, one axis at a time, antialiased (the
    triangle widened by the scale) on an axis that shrinks and the plain
    triangle on one that grows (torch's antialiased kernel is 1.5e-5 off
    JAX's when it enlarges 384 -> 480)."""
    lead, (h, w, c) = img.shape[:-3], img.shape[-3:]
    x = img.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    if height != h:
        x = F.interpolate(x, size=(height, w), mode="bilinear", align_corners=False, antialias=height < h)
    if width != w:
        x = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False,
                          antialias=width < w)
    return x.permute(0, 2, 3, 1).reshape(*lead, height, width, c)


def chamfer_dist(array1: torch.Tensor, array2: torch.Tensor) -> torch.Tensor:
    """Symmetric mean nearest-neighbour distance between (N, D) and (M, D)
    points, O(N M) (reference utils/general_utils.py:179-181)."""
    d = torch.linalg.norm(array1[:, None, :] - array2[None, :, :], dim=-1)
    return d.min(dim=1).values.mean() + d.min(dim=0).values.mean()
