"""Latent video diffusion: UNet + VAE + the conditioning glue.

Counterpart of `guidedvd3dgs_tpu/diffusion/model.py` (reference
lvdm/models/ddpm3d.py:464-1028, 1250+): hybrid conditioning (per-frame
latents concatenated on channels + the cross-attention context,
DiffusionWrapper ddpm3d.py:1420-1492), per-frame VAE encode and decode
(perframe_ae, ddpm3d.py:620-666) and the v-parameterization schedule.
The frames of a video go through the VAE as one batch.

Stable Video Diffusion beside it (`SVDConfig`, `SVDParams`,
`SVDConditioning`; diffusers `StableVideoDiffusionPipeline`, sgm
`DiffusionEngine` with svd_xt.yaml): the spatio-temporal UNet on the noisy
latent (scaled by c_in) with the conditioning latent on channels, the
image embedding as its context and the three added time ids; the
temporal VAE decoder over a chunk of consecutive frames. `apply_model`
and `decode_video_frames` take either model by its config's type, so the
guided sampler (samplers/ddim_guidance.py) drives both.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

from guidedvd3dgs_tpu_torch.diffusion.schedules import DiffusionSchedule, make_schedule
from guidedvd3dgs_tpu_torch.diffusion.clip import VisionConfig
from guidedvd3dgs_tpu_torch.diffusion.unet3d import UNetConfig, unet_apply
from guidedvd3dgs_tpu_torch.diffusion.unet_st import STUNetConfig, unet_st_apply
from guidedvd3dgs_tpu_torch.diffusion.vae import (
    TemporalDecoderConfig,
    VAEConfig,
    temporal_decode,
    vae_decode,
    vae_encode,
)


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


class SVDParams(NamedTuple):
    """SVD-XT's three sub-models' flat parameter dicts (diffusion/convert.py):
    the UNet and the temporal decoder under diffusers' names, the encoder
    under vae.py's, the image encoder under clip.py's."""

    unet: dict
    vae: dict
    clip_image: dict


@dataclass(frozen=True)
class SVDConfig:
    unet: STUNetConfig = field(default_factory=STUNetConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)  # the KL-f8 encoder
    decoder: TemporalDecoderConfig = field(default_factory=TemporalDecoderConfig)
    vision: VisionConfig = field(default_factory=VisionConfig)
    compute_dtype: str = "float32"  # the UNet's and the decoder's

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


class SVDConditioning(NamedTuple):
    """One CFG branch of an SVD request."""

    context: torch.Tensor  # (B, 1, 1024) the image embedding (zeros: unconditional)
    concat: torch.Tensor  # (B, T, h, w, 4) the noise-augmented first frame's latent (zeros: unconditional)
    time_ids: torch.Tensor  # (B, 3) float32: fps - 1, motion bucket id, noise augmentation strength


def apply_model(params, cfg, x_noisy: torch.Tensor, t: torch.Tensor, cond) -> torch.Tensor:
    """The v prediction under hybrid conditioning (reference ddpm3d.py:723-738,
    :1447-1452), the UNet in cfg.compute_dtype, returned at x_noisy's dtype.
    With an `SVDConfig`, SVD's UNet on the model input x_noisy (already
    c_in x) at c_noise `t` (`svd_apply_model`)."""
    if isinstance(cfg, SVDConfig):
        return svd_apply_model(params, cfg, x_noisy, t, cond)
    xc = torch.cat([x_noisy, cond.concat.to(x_noisy.dtype)], dim=-1)
    v = unet_apply(params.unet, cfg.unet, xc.to(cfg.dtype), t, cond.context.to(cfg.dtype),
                   fs=cond.fs)
    return v.to(x_noisy.dtype)


def encode_video_frames(params: DiffusionParams, cfg: LatentDiffusionConfig, frames: torch.Tensor,
                        eps: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """VAE encode of every frame (reference ddpm3d.py:620-644), at the
    frames' dtype. frames: (T, H, W, 3) in [-1, 1]; eps: (T, h, w, 4)
    sampling noise, else drawn from `generator`. Returns (T, h, w, 4)
    scaled latents."""
    return vae_encode(params.vae, cfg.vae, frames, eps=eps, generator=generator)


def decode_frame(params: DiffusionParams, cfg: LatentDiffusionConfig, z: torch.Tensor) -> torch.Tensor:
    """One frame's VAE decode (reference ddpm3d.py:669-675): z (h, w, 4) ->
    (H, W, 3), in cfg.compute_dtype, returned at z's dtype."""
    return decode_video_frames(params, cfg, z[None])[0]


def decode_video_frames(params, cfg, zs: torch.Tensor) -> torch.Tensor:
    """(T, h, w, 4) -> (T, H, W, 3), the frames decoded as one batch in
    cfg.compute_dtype and returned at zs's dtype; with an `SVDConfig`, as
    one video by the temporal decoder."""
    if isinstance(cfg, SVDConfig):
        return temporal_decode(params.vae, cfg.decoder, zs.to(cfg.dtype)).to(zs.dtype)
    return vae_decode(params.vae, cfg.vae, zs.to(cfg.dtype)).to(zs.dtype)


def svd_apply_model(params: SVDParams, cfg: SVDConfig, x_in: torch.Tensor, t: torch.Tensor,
                    cond: SVDConditioning) -> torch.Tensor:
    """F(c_in x, c_noise): x_in (B, T, h, w, 4) the scaled noisy latent, the
    conditioning latent concatenated after it (diffusers' pipeline), in
    cfg.compute_dtype, returned at x_in's dtype."""
    xc = torch.cat([x_in, cond.concat.to(x_in.dtype)], dim=-1)
    v = unet_st_apply(params.unet, cfg.unet, xc.to(cfg.dtype), t, cond.context.to(cfg.dtype), cond.time_ids)
    return v.to(x_in.dtype)
