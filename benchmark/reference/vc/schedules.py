"""DDPM / DDIM schedule math.

Counterpart of `guidedvd3dgs_tpu/diffusion/schedules.py` (reference
ddpm3d.py:123-187 register_schedule, :239-250 v-parameterization
identities; utils_diffusion.py:31-158). The tables are computed in float64
numpy, exactly as the reference does, and held as float32 tensors on the
device the caller names.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Zero terminal SNR (arXiv:2305.08891 Alg. 1; reference
    utils_diffusion.py:113-145)."""
    abs_sqrt = np.sqrt(np.cumprod(1.0 - betas))
    a0, aT = abs_sqrt[0].copy(), abs_sqrt[-1].copy()
    abs_sqrt = (abs_sqrt - aT) * a0 / (a0 - aT)
    alphas_bar = abs_sqrt ** 2
    alphas = np.concatenate([alphas_bar[0:1], alphas_bar[1:] / alphas_bar[:-1]])
    return 1.0 - alphas


def make_ddim_timesteps(method: str, num_ddim: int, num_ddpm: int) -> np.ndarray:
    if method == "uniform":
        return np.asarray(list(range(0, num_ddpm, num_ddpm // num_ddim))) + 1
    if method == "uniform_trailing":
        c = num_ddpm / num_ddim
        return np.flip(np.round(np.arange(num_ddpm, 0, -c))).astype(np.int64) - 1
    raise ValueError(method)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


@dataclass(frozen=True)
class DiffusionSchedule:
    """Schedule tables of T DDPM steps (f32)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    scale_arr: torch.Tensor  # dynamic rescale (ones if disabled)

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def make_schedule(timesteps: int = 1000, linear_start: float = 0.00085, linear_end: float = 0.012,
                  rescale_betas_zero_snr: bool = True, use_dynamic_rescale: bool = True,
                  base_scale: float = 0.3, turning_step: int = 400,
                  device="cpu") -> DiffusionSchedule:
    """The "linear" beta schedule of the ViewCrafter config (reference
    utils_diffusion.py:31-54), optionally rescaled to zero terminal SNR."""
    betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, timesteps, dtype=np.float64) ** 2
    if rescale_betas_zero_snr:
        betas = rescale_zero_terminal_snr(betas)
    alphas_cumprod = np.cumprod(1.0 - betas)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    if use_dynamic_rescale:
        scale_arr = np.concatenate(
            [np.linspace(1.0, base_scale, turning_step), np.full(timesteps, base_scale)])[:timesteps]
    else:
        scale_arr = np.ones(timesteps)
    return DiffusionSchedule(
        betas=_f32(betas, device),
        alphas_cumprod=_f32(alphas_cumprod, device),
        alphas_cumprod_prev=_f32(alphas_cumprod_prev, device),
        sqrt_alphas_cumprod=_f32(np.sqrt(alphas_cumprod), device),
        sqrt_one_minus_alphas_cumprod=_f32(np.sqrt(1.0 - alphas_cumprod), device),
        scale_arr=_f32(scale_arr, device),
    )


@dataclass(frozen=True)
class DDIMParams:
    """Per-DDIM-step tables of length S, selected from the DDPM schedule."""

    timesteps: torch.Tensor  # (S,) int64 DDPM step of each DDIM index
    alphas: torch.Tensor
    alphas_prev: torch.Tensor
    sqrt_one_minus_alphas: torch.Tensor
    sigmas: torch.Tensor
    scale_arr: torch.Tensor
    scale_arr_prev: torch.Tensor

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]


def make_ddim_params(sched: DiffusionSchedule, num_steps: int, eta: float = 1.0,
                     method: str = "uniform_trailing") -> DDIMParams:
    """reference ddim_guidance.py:23-58 make_schedule; on the schedule's device."""
    dev = sched.betas.device
    ts = make_ddim_timesteps(method, num_steps, sched.num_timesteps)
    ac = sched.alphas_cumprod.cpu().numpy()
    alphas = ac[ts]
    alphas_prev = np.asarray([ac[0]] + ac[ts[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    sa = sched.scale_arr.cpu().numpy()
    scale_arr = sa[ts]
    scale_arr_prev = np.concatenate([sa[0:1], scale_arr[:-1]])
    return DDIMParams(
        timesteps=torch.as_tensor(ts, dtype=torch.int64, device=dev),
        alphas=_f32(alphas, dev),
        alphas_prev=_f32(alphas_prev, dev),
        sqrt_one_minus_alphas=_f32(np.sqrt(1.0 - alphas), dev),
        sigmas=_f32(sigmas, dev),
        scale_arr=_f32(scale_arr, dev),
        scale_arr_prev=_f32(scale_arr_prev, dev),
    )


# v-parameterization identities (reference ddpm3d.py:239-250)


def _at(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    return table[t].reshape((-1,) + (1,) * (ndim - 1))


def predict_start_from_z_and_v(sched: DiffusionSchedule, x_t, t, v):
    a = _at(sched.sqrt_alphas_cumprod, t, x_t.dim())
    b = _at(sched.sqrt_one_minus_alphas_cumprod, t, x_t.dim())
    return a * x_t - b * v


def predict_eps_from_z_and_v(sched: DiffusionSchedule, x_t, t, v):
    a = _at(sched.sqrt_alphas_cumprod, t, x_t.dim())
    b = _at(sched.sqrt_one_minus_alphas_cumprod, t, x_t.dim())
    return a * v + b * x_t


def q_sample(sched: DiffusionSchedule, x0, t, noise):
    """The forward process: x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) noise
    (reference ddpm3d.py q_sample)."""
    a = _at(sched.sqrt_alphas_cumprod, t, x0.dim())
    b = _at(sched.sqrt_one_minus_alphas_cumprod, t, x0.dim())
    return a * x0 + b * noise


def rescale_noise_cfg(noise_cfg, noise_pred_text, guidance_rescale: float = 0.0):
    """reference utils_diffusion.py:147-158; torch.std is Bessel-corrected,
    as the reference's."""
    dims = tuple(range(1, noise_cfg.dim()))
    std_text = noise_pred_text.std(dim=dims, keepdim=True)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1 - guidance_rescale) * noise_cfg
