"""The DDIM step: the plain reference's frozen copy of the port's
`diffusion/samplers/ddim.py::ddim_step`.

Counterpart of `guidedvd3dgs_tpu/diffusion/samplers/ddim.py` (reference
lvdm/models/samplers/ddim.py, used with --no_guidance, and the CFG +
dynamic-rescale step math shared with ddim_guidance.py:205-291):
v-parameterization, classifier-free guidance with rescale_noise_cfg, the
dynamic-rescale correction of pred_x0 and the eta-sigma noise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .schedules import (
    DDIMParams,
    DiffusionSchedule,
    predict_eps_from_z_and_v,
    predict_start_from_z_and_v,
)

class DDIMStepOut(NamedTuple):
    x_prev: torch.Tensor
    pred_x0: torch.Tensor
    e_t: torch.Tensor
    correction: torch.Tensor  # the model output (v-space)


def ddim_step(sched: DiffusionSchedule, pr: DDIMParams, index: int, x: torch.Tensor,
              model_output: torch.Tensor, noise: torch.Tensor, temperature: float = 1.0) -> DDIMStepOut:
    """x_t -> x_{t-1} at DDIM index `index` (reference ddim_guidance.py:274-291)."""
    t = pr.timesteps[index].expand(x.shape[0])
    a_prev = pr.alphas_prev[index]
    sigma_t = pr.sigmas[index]
    e_t = predict_eps_from_z_and_v(sched, x, t, model_output)
    pred_x0 = predict_start_from_z_and_v(sched, x, t, model_output)
    pred_x0 = pred_x0 * (pr.scale_arr_prev[index] / pr.scale_arr[index])
    dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma_t ** 2, min=0.0)) * e_t
    x_prev = torch.sqrt(a_prev) * pred_x0 + dir_xt + sigma_t * noise * temperature
    return DDIMStepOut(x_prev, pred_x0, e_t, model_output)
