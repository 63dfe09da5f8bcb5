"""The guided DDIM step's parts (the paper's Algorithm 1): the plain
reference's frozen copy of the port's `diffusion/samplers/ddim_guidance.py`,
without the sampling loop, which the benchmark drives step by step.

Counterpart of `guidedvd3dgs_tpu/diffusion/samplers/ddim_guidance.py`
(reference DDIMSamplerGuidance, lvdm/models/samplers/ddim_guidance.py:
205-363). Per step, the gradient of the scene-grounding loss with respect
to the latent x is

    dL/dx = J^T_{x -> pred_x0} . dL/dpred_x0

with dL/dpred_x0 taken through the VAE decode of the detached pred_x0
(the reference's clone().detach() per frame, :305-327; JAX's
stop_gradient) and the VJP through the CFG'd UNet pair seeded with it (the
reference's pred_x0.backward(grad, inputs=x), :337-339). Then the
adaptive step

    rho = RMS(v_cond - v_uncond) * cfg_scale / RMS(dL/dx) * rho_scale * w
    x_prev <- x_prev - rho * dL/dx                          (:346-354)

The CFG pair runs as one UNet application at batch 2 (cond ++ uncond),
without autograd, for the CFG output and pred_x0. At full width the
pair's autograd graph holds 67.8 GB (bf16, 25 frames; measured by
scripts/guided_step_memory.py on an H100), one branch's 34.0 GB. So once
the decode gradients are in, each branch runs again under autograd for
its VJP, one after the other (JAX's pair_mode "batched_ckpt" recomputes
the pair at batch 2: the same result, one extra forward either way); the
step's peak is one branch's VJP. The decode gradients take
`decode_chunk` frames per batched decode, which is exact: the VAE treats
frames independently and each frame's gradient is divided by its own mask
numel. A frame whose mask is empty (numel 0) gets a zero gradient; the
JAX package divides 0 by 0 there and the NaN spreads over the whole latent
(ROADMAP queue 3).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .model import (
    Conditioning,
    DiffusionParams,
    LatentDiffusionConfig,
    apply_model,
    decode_video_frames,
)
from .schedules import (
    DDIMParams,
    DiffusionSchedule,
    predict_start_from_z_and_v,
    rescale_noise_cfg,
)
from .loss_guidance import GuidanceFn


@dataclass(frozen=True)
class GuidedSampleConfig:
    cfg_scale: float = 7.5
    guidance_rescale: float = 0.7
    temperature: float = 1.0
    rho_scale: float = 0.2  # reference :351 `rho_scale = 0.2 * scale_w`
    recur_steps: int = 1
    mean_loss: bool = False
    # frames per batched decode of the guidance gradient (1 = the
    # reference's per-frame loop, ddim_guidance.py:299-327)
    decode_chunk: int = 5


def per_frame_guidance_grads(params: DiffusionParams, mcfg: LatentDiffusionConfig,
                             guidance_fn: GuidanceFn, zs: torch.Tensor, index: int,
                             scfg: GuidedSampleConfig, plain: bool = False) -> torch.Tensor:
    """dL/dpred_x0 of every frame through the VAE decode: zs (T, h, w, 4)
    pred_x0 latents -> (T, h, w, 4), `decode_chunk` frames per decode (the
    last chunk takes what is left). Each frame's gradient is divided by its
    numel unless mean_loss; an empty mask gives a zero gradient."""
    n = zs.shape[0]
    ck = max(1, min(int(scfg.decode_chunk), n))
    grads = torch.empty_like(zs)
    for c0 in range(0, n, ck):
        with torch.enable_grad():
            z = zs[c0:c0 + ck].detach().requires_grad_()
            frames = decode_video_frames(params, mcfg, z, plain=plain)
            idx = torch.arange(c0, c0 + z.shape[0], device=zs.device)
            loss, numel = guidance_fn(frames, index, idx)
            (g,) = torch.autograd.grad(loss.sum(), z)
        if not scfg.mean_loss:
            nm = numel.detach().reshape(-1, 1, 1, 1)
            g = torch.where(nm > 0, g / nm, torch.zeros_like(g))
        grads[c0:c0 + ck] = g
    return grads


def cfg_pred_x0(sched: DiffusionSchedule, pr: DDIMParams, scfg: GuidedSampleConfig, x: torch.Tensor,
                index: int, v_cond: torch.Tensor, v_uncond: torch.Tensor):
    """The CFG output of the pair's v predictions with its rescale, and
    pred_x0 from it: (pred_x0, mo)."""
    t = pr.timesteps[index].expand(x.shape[0])
    mo = v_uncond + scfg.cfg_scale * (v_cond - v_uncond)
    mo = rescale_noise_cfg(mo, v_cond, scfg.guidance_rescale)
    rescale = pr.scale_arr_prev[index] / pr.scale_arr[index]
    return predict_start_from_z_and_v(sched, x, t, mo) * rescale, mo


def pair_forward(params: DiffusionParams, mcfg: LatentDiffusionConfig, pr: DDIMParams, cond: Conditioning,
                 uncond: Conditioning, x: torch.Tensor, index: int, plain: bool = False):
    """The CFG pair as one UNet application at batch 2b, without autograd:
    (v_cond, v_uncond)."""
    b = x.shape[0]
    t = pr.timesteps[index].expand(b)
    cu = Conditioning(*(torch.cat([c, u]) for c, u in zip(cond, uncond)))
    with torch.no_grad():
        vs = apply_model(params, mcfg, torch.cat([x, x]), torch.cat([t, t]), cu, plain=plain)
    return vs[:b], vs[b:]


def pair_vjp(params: DiffusionParams, mcfg: LatentDiffusionConfig, sched: DiffusionSchedule,
             pr: DDIMParams, cond: Conditioning, uncond: Conditioning, scfg: GuidedSampleConfig,
             x: torch.Tensor, index: int, v_cond: torch.Tensor, v_uncond: torch.Tensor,
             grads: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """dL/dx for pred_x0(x) of the pair, `grads` = dL/dpred_x0. The VJP of
    the CFG combination gives the cotangents of x itself and of each
    branch's v; each branch then runs again under autograd at batch b and
    its VJP is added, so that one branch's graph is held at a time."""
    t = pr.timesteps[index].expand(x.shape[0])
    with torch.enable_grad():
        xl, vc, vu = (a.detach().requires_grad_() for a in (x, v_cond, v_uncond))
        pred_x0 = cfg_pred_x0(sched, pr, scfg, xl, index, vc, vu)[0]
        gx, g_cond, g_uncond = torch.autograd.grad(pred_x0, (xl, vc, vu), grads.to(pred_x0.dtype))
        for c, g in ((cond, g_cond), (uncond, g_uncond)):
            xg = x.detach().requires_grad_()
            v = apply_model(params, mcfg, xg, t, c, plain=plain)
            gx = gx + torch.autograd.grad(v, xg, g)[0]
    return gx


def guidance_update(x_prev: torch.Tensor, gx: torch.Tensor, correction: torch.Tensor,
                    scfg: GuidedSampleConfig, scale_guidance_weight):
    """The adaptive step (reference :346-354): (x_prev - rho gx, rho); rho
    is 0 where the gradient is 0."""
    rms_g = torch.sqrt(torch.mean(gx.float() ** 2))
    rms_corr = torch.sqrt(torch.mean(correction.float() ** 2))
    rho = torch.where(rms_g == 0.0, torch.zeros_like(rms_g),
                      rms_corr * scfg.cfg_scale / rms_g * scfg.rho_scale * scale_guidance_weight)
    return x_prev - rho * gx, rho
