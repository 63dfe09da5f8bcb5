"""General math helpers: the opacity activation's inverse, the position
learning-rate schedule, quaternion -> rotation matrix.

Counterpart of `guidedvd3dgs_tpu/utils/general.py`. Quaternions are
(w, x, y, z) throughout.
"""

from __future__ import annotations

import numpy as np
import torch


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
