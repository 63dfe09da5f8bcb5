"""Scene-grounding guided DDIM sampler (the paper's Algorithm 1).

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

and, for recur_steps > 1, the time-travel re-noise (:360).

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
from typing import Optional

import torch

from guidedvd3dgs_tpu_torch.diffusion.model import (
    Conditioning,
    DiffusionParams,
    LatentDiffusionConfig,
    apply_model,
    decode_video_frames,
)
from guidedvd3dgs_tpu_torch.diffusion.samplers.ddim import ddim_step
from guidedvd3dgs_tpu_torch.diffusion.schedules import (
    DDIMParams,
    DiffusionSchedule,
    predict_start_from_z_and_v,
    rescale_noise_cfg,
)
from guidedvd3dgs_tpu_torch.guidance.loss_guidance import GuidanceFn
from guidedvd3dgs_tpu_torch.utils.tracing import span


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
    with span("ddim.decode_grads"):
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
    with span("ddim.pair_forward"), torch.no_grad():
        cu = Conditioning(*(torch.cat([c, u]) for c, u in zip(cond, uncond)))
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
    with span("ddim.pair_vjp"), torch.enable_grad():
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


def check_pair_batch(cond: Conditioning, uncond: Conditioning, b: int) -> None:
    """The batched pair splits its output at row b: both halves must hold
    b rows (the JAX package checks only cond's context, :160)."""
    for name, c in (("cond", cond), ("uncond", uncond)):
        sizes = {f: getattr(c, f).shape[0] for f in c._fields}
        if any(s != b for s in sizes.values()):
            raise ValueError(f"the batched CFG pair needs {name} batch == latent batch {b}, got {sizes}")


def guided_step(params: DiffusionParams, mcfg: LatentDiffusionConfig, sched: DiffusionSchedule,
                pr: DDIMParams, cond: Conditioning, uncond: Conditioning, scfg: GuidedSampleConfig,
                guidance_fn: GuidanceFn, scale_guidance_weight, x: torch.Tensor, index: int,
                noise: torch.Tensor, plain: bool = False):
    """One guided DDIM step x_t -> x_{t-1} (JAX `_guided_step`): x (1, T, h,
    w, 4); noise the step's eta noise. Returns (x_prev, pred_x0, rho).
    `plain=True` runs L1's plain forward and backward where its kernels
    would run."""
    b = x.shape[0]
    if b != 1:
        raise ValueError(f"the guided sampler takes one video, got a latent batch of {b}")
    check_pair_batch(cond, uncond, b)
    v_cond, v_uncond = pair_forward(params, mcfg, pr, cond, uncond, x, index, plain)
    with span("ddim.update"):
        pred_x0, mo = cfg_pred_x0(sched, pr, scfg, x, index, v_cond, v_uncond)
    out = ddim_step(sched, pr, index, x, mo, noise, scfg.temperature)  # its own "ddim.update"
    # the decode gradients start from pred_x0 without its graph: the
    # reference's detach, JAX's stop_gradient (:221)
    grads = per_frame_guidance_grads(params, mcfg, guidance_fn, pred_x0[0], index, scfg, plain)
    gx = pair_vjp(params, mcfg, sched, pr, cond, uncond, scfg, x, index, v_cond, v_uncond, grads[None],
                  plain)
    with span("ddim.update"):
        x_prev, rho = guidance_update(out.x_prev, gx, v_cond - v_uncond, scfg, scale_guidance_weight)
    return x_prev, out.pred_x0, rho


def guided_ddim_sample(params: DiffusionParams, mcfg: LatentDiffusionConfig, sched: DiffusionSchedule,
                       pr: DDIMParams, cond: Conditioning, uncond: Conditioning, x_T: torch.Tensor,
                       guidance_fn: GuidanceFn, scfg: GuidedSampleConfig = GuidedSampleConfig(),
                       scale_guidance_weight: float = 1.0, noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       return_trace: bool = False):
    """The guided reverse process (reference ddim_guidance.py:136-202,
    :205-363): x_0 latents (1, T, h, w, 4). `noise`: (draws, *x_T.shape) in
    the loop's order, S * (2 recur_steps - 1) draws (each step's eta noise,
    and between two repeats of a step its re-noise); else each draw is
    standard normal from `generator`. With `return_trace`, (x_0, the
    pred_x0 latents of each step (S, T, h, w, 4)), the reference's
    save_pred_x0 (:330-331)."""
    s = pr.num_steps
    draws = s * (2 * scfg.recur_steps - 1)
    if noise is not None and noise.shape[0] != draws:
        raise ValueError(f"noise holds {noise.shape[0]} draws, the sampler takes {draws}")
    injected = None if noise is None else iter(noise)

    def draw():
        if injected is not None:
            return next(injected)
        return torch.randn(x_T.shape, generator=generator, dtype=x_T.dtype, device=x_T.device)

    x, trace = x_T, []
    for i in range(s):
        index = s - 1 - i
        for r in range(scfg.recur_steps):
            x_prev, pred_x0, _ = guided_step(params, mcfg, sched, pr, cond, uncond, scfg, guidance_fn,
                                             scale_guidance_weight, x, index, draw())
            if r + 1 < scfg.recur_steps:
                # time travel: re-noise x_prev back to t (reference :360)
                beta_t = pr.alphas[index] / pr.alphas_prev[index]
                x = torch.sqrt(beta_t) * x_prev + torch.sqrt(1.0 - beta_t) * draw()
        x = x_prev
        if return_trace:
            trace.append(pred_x0[0])
    return (x, torch.stack(trace)) if return_trace else x
