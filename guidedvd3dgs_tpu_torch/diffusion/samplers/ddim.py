"""Plain DDIM sampler, a Python loop over the steps.

Counterpart of `guidedvd3dgs_tpu/diffusion/samplers/ddim.py` (reference
lvdm/models/samplers/ddim.py, used with --no_guidance, and the CFG +
dynamic-rescale step math shared with ddim_guidance.py:205-291):
v-parameterization, classifier-free guidance with rescale_noise_cfg, the
dynamic-rescale correction of pred_x0 and the eta-sigma noise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from guidedvd3dgs_tpu_torch.diffusion.schedules import (
    DDIMParams,
    DiffusionSchedule,
    predict_eps_from_z_and_v,
    predict_start_from_z_and_v,
    rescale_noise_cfg,
)
from guidedvd3dgs_tpu_torch.utils.tracing import span

# apply_fn(x, t_batch) -> v prediction; the conditioning is closed over
ApplyFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class DDIMStepOut(NamedTuple):
    x_prev: torch.Tensor
    pred_x0: torch.Tensor
    e_t: torch.Tensor
    correction: torch.Tensor  # the model output (v-space)


def cfg_model_output(apply_cond: ApplyFn, apply_uncond: ApplyFn, x: torch.Tensor, t: torch.Tensor,
                     cfg_scale: float, guidance_rescale: float):
    """reference ddim_guidance.py:266-272: (CFG output, v_cond - v_uncond)."""
    with span("ddim.pair_forward"):
        v_cond = apply_cond(x, t)
        v_uncond = apply_uncond(x, t)
    with span("ddim.update"):
        out = v_uncond + cfg_scale * (v_cond - v_uncond)
        correction = v_cond - v_uncond
        return rescale_noise_cfg(out, v_cond, guidance_rescale), correction


def ddim_step(sched: DiffusionSchedule, pr: DDIMParams, index: int, x: torch.Tensor,
              model_output: torch.Tensor, noise: torch.Tensor, temperature: float = 1.0) -> DDIMStepOut:
    """x_t -> x_{t-1} at DDIM index `index` (reference ddim_guidance.py:274-291)."""
    with span("ddim.update"):
        t = pr.timesteps[index].expand(x.shape[0])
        a_prev = pr.alphas_prev[index]
        sigma_t = pr.sigmas[index]
        e_t = predict_eps_from_z_and_v(sched, x, t, model_output)
        pred_x0 = predict_start_from_z_and_v(sched, x, t, model_output)
        pred_x0 = pred_x0 * (pr.scale_arr_prev[index] / pr.scale_arr[index])
        dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma_t ** 2, min=0.0)) * e_t
        x_prev = torch.sqrt(a_prev) * pred_x0 + dir_xt + sigma_t * noise * temperature
        return DDIMStepOut(x_prev, pred_x0, e_t, model_output)


def ddim_sample(sched: DiffusionSchedule, pr: DDIMParams, apply_cond: ApplyFn,
                apply_uncond: ApplyFn, x_T: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, cfg_scale: float = 7.5,
                guidance_rescale: float = 0.7) -> torch.Tensor:
    """The S-step reverse process (reference ddim.py:206-260). `noise`:
    (S, *x_T.shape), the step noise in the loop's order; else each step
    draws standard normal noise from `generator`."""
    s = pr.num_steps
    x = x_T
    for i in range(s):
        index = s - 1 - i
        t = pr.timesteps[index].expand(x.shape[0])
        mo, _ = cfg_model_output(apply_cond, apply_uncond, x, t, cfg_scale, guidance_rescale)
        if noise is not None:
            nz = noise[i]
        else:
            nz = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        x = ddim_step(sched, pr, index, x, mo, nz).x_prev
    return x
