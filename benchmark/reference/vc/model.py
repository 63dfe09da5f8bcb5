"""Latent video diffusion: UNet + VAE + the conditioning glue.

Counterpart of `guidedvd3dgs_tpu/diffusion/model.py` (reference
lvdm/models/ddpm3d.py:464-1028, 1250+): hybrid conditioning (per-frame
latents concatenated on channels + the cross-attention context,
DiffusionWrapper ddpm3d.py:1420-1492), per-frame VAE encode and decode
(perframe_ae, ddpm3d.py:620-666) and the v-parameterization schedule.
The frames of a video go through the VAE as one batch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

from .schedules import DiffusionSchedule, make_schedule
from .unet3d import UNetConfig, unet_apply
from .vae import VAEConfig, vae_decode, vae_encode


class DiffusionParams(NamedTuple):
    """The five sub-models' flat torch-named parameter dicts."""

    unet: dict
    vae: dict
    resampler: dict
    clip_text: dict
    clip_image: dict


@dataclass(frozen=True)
class LatentDiffusionConfig:
    unet: UNetConfig = field(default_factory=UNetConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.012
    rescale_betas_zero_snr: bool = True
    use_dynamic_rescale: bool = True
    base_scale: float = 0.3
    # the UNet's and the decode's compute type ("bfloat16" as the
    # reference's fp16 autocast, viewcrafter.py:101); the sampler and the
    # schedule stay float32
    compute_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def schedule(self, device="cpu") -> DiffusionSchedule:
        return make_schedule(timesteps=self.timesteps, linear_start=self.linear_start,
                             linear_end=self.linear_end,
                             rescale_betas_zero_snr=self.rescale_betas_zero_snr,
                             use_dynamic_rescale=self.use_dynamic_rescale,
                             base_scale=self.base_scale, device=device)


class Conditioning(NamedTuple):
    """c_crossattn context + c_concat latents (hybrid conditioning)."""

    context: torch.Tensor  # (B, 77 + tokens, 1024)
    concat: torch.Tensor  # (B, T, h, w, 4) per-frame latents of the renders
    fs: torch.Tensor  # (B,) int


def apply_model(params: DiffusionParams, cfg: LatentDiffusionConfig, x_noisy: torch.Tensor,
                t: torch.Tensor, cond: Conditioning, plain: bool = False) -> torch.Tensor:
    """The v prediction under hybrid conditioning (reference ddpm3d.py:723-738,
    :1447-1452), the UNet in cfg.compute_dtype, returned at x_noisy's dtype."""
    xc = torch.cat([x_noisy, cond.concat.to(x_noisy.dtype)], dim=-1)
    v = unet_apply(params.unet, cfg.unet, xc.to(cfg.dtype), t, cond.context.to(cfg.dtype),
                   fs=cond.fs, plain=plain)
    return v.to(x_noisy.dtype)


def encode_video_frames(params: DiffusionParams, cfg: LatentDiffusionConfig, frames: torch.Tensor,
                        eps: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """VAE encode of every frame (reference ddpm3d.py:620-644), at the
    frames' dtype. frames: (T, H, W, 3) in [-1, 1]; eps: (T, h, w, 4)
    sampling noise, else drawn from `generator`. Returns (T, h, w, 4)
    scaled latents."""
    return vae_encode(params.vae, cfg.vae, frames, eps=eps, generator=generator)


def decode_video_frames(params: DiffusionParams, cfg: LatentDiffusionConfig,
                        zs: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """(T, h, w, 4) -> (T, H, W, 3), the frames decoded as one batch in
    cfg.compute_dtype and returned at zs's dtype. `plain=True` runs L1's
    plain version where the kernel would run."""
    return vae_decode(params.vae, cfg.vae, zs.to(cfg.dtype), plain=plain).to(zs.dtype)
