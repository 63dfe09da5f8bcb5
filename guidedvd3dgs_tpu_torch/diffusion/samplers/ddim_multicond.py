"""The two-scale CFG DDIM sampler (the reference's --multiple_cond_cfg).

Counterpart of `guidedvd3dgs_tpu/diffusion/samplers/ddim_multicond.py`
(reference lvdm/models/samplers/ddim_multiplecond.py:212-240): three UNet
evaluations a step (full conditioning, unconditional, and "image yes, text
empty") combined as

    out = e_uncond + cfg_img  * (e_uncond_img - e_uncond)
                   + cfg_text * (e_cond       - e_uncond_img)

then rescale_noise_cfg against e_cond and the plain sampler's v-param DDIM
update. As in the JAX package it shares the fixed schedule arrays of the
other samplers (the reference's multiplecond make_schedule keeps the
pre-fix dynamic-rescale array, ddim_multiplecond.py:33, which inflates the
last step's pred_x0; tests/test_ddim_sampler_parity.py pins that
divergence). Sampling only: the reference's multicond sampler runs under
no_grad and takes no scene-grounding guidance.
"""

from __future__ import annotations

from typing import Optional

import torch

from guidedvd3dgs_tpu_torch.diffusion.samplers.ddim import ApplyFn, ddim_step
from guidedvd3dgs_tpu_torch.diffusion.schedules import DDIMParams, DiffusionSchedule, rescale_noise_cfg


def multicond_model_output(apply_cond: ApplyFn, apply_uncond: ApplyFn, apply_uncond_img: ApplyFn,
                           x: torch.Tensor, t: torch.Tensor, cfg_text: float, cfg_img: float,
                           guidance_rescale: float) -> torch.Tensor:
    """The two-scale CFG combination (ddim_multiplecond.py:227-237)."""
    v_cond = apply_cond(x, t)
    v_uncond = apply_uncond(x, t)
    v_uncond_img = apply_uncond_img(x, t)
    out = v_uncond + cfg_img * (v_uncond_img - v_uncond) + cfg_text * (v_cond - v_uncond_img)
    if guidance_rescale > 0.0:
        out = rescale_noise_cfg(out, v_cond, guidance_rescale)
    return out


def ddim_sample_multicond(sched: DiffusionSchedule, pr: DDIMParams, apply_cond: ApplyFn,
                          apply_uncond: ApplyFn, apply_uncond_img: ApplyFn, x_T: torch.Tensor,
                          noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
                          cfg_text: float = 7.5, cfg_img: float = 1.0, guidance_rescale: float = 0.7,
                          temperature: float = 1.0) -> torch.Tensor:
    """The S-step reverse process (ddim_multiplecond.py:146-207). `noise`
    (S, *x_T.shape) is the step noise in the loop's order, else drawn from
    `generator` step by step."""
    s = pr.num_steps
    x = x_T
    for i in range(s):
        index = s - 1 - i
        t = pr.timesteps[index].expand(x.shape[0])
        mo = multicond_model_output(apply_cond, apply_uncond, apply_uncond_img, x, t,
                                    cfg_text, cfg_img, guidance_rescale)
        nz = noise[i] if noise is not None else torch.randn(x.shape, generator=generator, dtype=x.dtype,
                                                            device=x.device)
        x = ddim_step(sched, pr, index, x, mo, nz, temperature).x_prev
    return x
