"""Euler EDM sampler of Stable Video Diffusion, plain and guided.

SVD-XT's sampling (diffusers `EulerDiscreteScheduler` with its
scheduler_config.json and `StableVideoDiffusionPipeline`; sgm
`EulerEDMSampler` with s_churn 0, `VScalingWithEDMcNoise` and
`LinearPredictionGuider`): Karras sigmas from 700 to 0.002 (rho 7), the
v-prediction denoiser

    D(x) = c_skip x + c_out F(c_in x, c_noise),   c_noise = 0.25 ln sigma

classifier-free guidance rising linearly over the frames,

    D = D_uncond + s_f (D_cond - D_uncond),   s_f = linspace(min_cfg, max_cfg, T)

(the same on F, D being affine in it) and the Euler step

    x <- x + (x - D) / sigma * (sigma_next - sigma).

x_T is standard normal times sqrt(1 + sigma_max^2). With s_churn 0 no step
draws noise.

`EulerEDMRule` is this sampler's side of the shared guided step
(ddim_guidance.rule_step), the port's own application of the paper's
Algorithm 1 to an EDM sampler (no published SVD setting): pred_x0 is D of
the CFG'd pair, the guidance gradient dL/dx is taken through D(x), and the
adaptive step's size is RMS(s_f (D_cond - D_uncond)) / RMS(dL/dx) *
rho_scale * w, which with one scale s for every frame is the DDIM step's
s * RMS(v_cond - v_uncond) in D's units. Time travel (recur_steps > 1,
DDPM's re-noise) is not defined for it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from guidedvd3dgs_tpu_torch.diffusion.samplers import ddim_guidance
from guidedvd3dgs_tpu_torch.diffusion.samplers.ddim_guidance import GuidedSampleConfig
from guidedvd3dgs_tpu_torch.diffusion.schedules import EDMParams, make_edm_params
from guidedvd3dgs_tpu_torch.utils.tracing import span


@dataclass(frozen=True)
class EulerConfig:
    """SVD-XT's sampling: 25 steps, sigma 700 -> 0.002, rho 7, CFG 1 -> 3."""

    num_steps: int = 25
    sigma_min: float = 0.002
    sigma_max: float = 700.0
    rho: float = 7.0
    min_cfg: float = 1.0
    max_cfg: float = 3.0

    def params(self, device="cpu") -> EDMParams:
        return make_edm_params(self.num_steps, self.sigma_min, self.sigma_max, self.rho, device)


def frame_scales(ecfg: EulerConfig, frames: int, device="cpu") -> torch.Tensor:
    """(1, T, 1, 1, 1) per-frame CFG scales."""
    s = torch.linspace(ecfg.min_cfg, ecfg.max_cfg, frames, dtype=torch.float32, device=device)
    return s.reshape(1, frames, 1, 1, 1)


def init_noise_sigma(edm: EDMParams) -> torch.Tensor:
    return torch.sqrt(1.0 + edm.sigmas[0] ** 2)


def cfg_denoised(edm: EDMParams, scales: torch.Tensor, x: torch.Tensor, index: int, v_cond: torch.Tensor,
                 v_uncond: torch.Tensor):
    """(D, the CFG'd F) of the pair's v predictions at step `index`."""
    mo = v_uncond + scales * (v_cond - v_uncond)
    return edm.c_skip[index] * x + edm.c_out[index] * mo, mo


def euler_step(edm: EDMParams, index: int, x: torch.Tensor, denoised: torch.Tensor) -> torch.Tensor:
    with span("ddim.update"):
        sigma = edm.sigmas[index]
        return x + (x - denoised) / sigma * (edm.sigmas[index + 1] - sigma)


class EulerEDMRule:
    """The Euler EDM side of a guided step (module docstring). `scfg` gives
    the guidance's settings; its cfg_scale is taken as 1 (the scales are in
    the correction)."""

    step_noise = False

    def __init__(self, edm: EDMParams, scales: torch.Tensor, scfg: GuidedSampleConfig):
        if scfg.recur_steps != 1:
            raise ValueError(f"the Euler EDM sampler takes recur_steps 1, got {scfg.recur_steps}")
        self.edm, self.scales = edm, scales
        self.scfg = dataclasses.replace(scfg, cfg_scale=1.0)

    @property
    def num_steps(self) -> int:
        return self.edm.num_steps

    def index(self, i: int) -> int:
        return i

    def model_args(self, x: torch.Tensor, index: int):
        return x * self.edm.c_in[index], self.edm.c_noise[index].expand(x.shape[0])

    def pred_x0(self, x, index: int, v_cond, v_uncond):
        return cfg_denoised(self.edm, self.scales, x, index, v_cond, v_uncond)

    def update(self, x, index: int, pred_x0, mo, noise=None):
        return euler_step(self.edm, index, x, pred_x0), pred_x0

    def correction(self, index: int, v_cond, v_uncond):
        """s_f (D_cond - D_uncond) = s_f c_out (v_cond - v_uncond)."""
        return self.scales * (self.edm.c_out[index] * (v_cond - v_uncond))


def euler_edm_sample(params, mcfg, edm: EDMParams, scales: torch.Tensor, cond, uncond,
                     x_T: torch.Tensor) -> torch.Tensor:
    """The plain S-step Euler EDM reverse process from x_T (already times
    `init_noise_sigma`): the CFG pair as one application at batch 2 a
    step (ddim_guidance.pair_forward), without autograd."""
    rule = EulerEDMRule(edm, scales, GuidedSampleConfig())
    x = x_T
    for i in range(edm.num_steps):
        vc, vu = ddim_guidance.pair_forward(params, mcfg, rule, cond, uncond, x, i)
        with span("ddim.update"):
            denoised = rule.pred_x0(x, i, vc, vu)[0]
        x = euler_step(edm, i, x, denoised)
    return x
