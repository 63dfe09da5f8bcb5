"""Conditioning assembly and the sampling driver (image_guided_synthesis).

Counterpart of `guidedvd3dgs_tpu/diffusion/synthesis.py` (reference
utils_vc/diffusion_utils.py:111-223):

  cond context   = OpenCLIP-text(prompt) ++ Resampler(OpenCLIP-image(frame0))
  uncond context = OpenCLIP-text("")     ++ Resampler(OpenCLIP-image(zeros))
  c_concat       = the VAE latents of the point-cloud renders (both)

then plain DDIM sampling with CFG and the VAE decode of every frame. With
the guidedvd config (25 frames, resampler video_length 16 -> 256 image
tokens) the context is (1, 77 + 256, 1024) and the UNet repeats it per
frame. This slice carries generation without guidance (the reference's
--no_guidance); the guided sampler and the two-scale CFG come with the
guided slice.

Noise: the three draws of a request (the VAE encode's eps, x_T, the step
noise) are taken from `noise` where given, else from `generator`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import torch

from guidedvd3dgs_tpu_torch.diffusion import clip as clip_mod
from guidedvd3dgs_tpu_torch.diffusion import schedules as S
from guidedvd3dgs_tpu_torch.diffusion.model import (
    Conditioning,
    DiffusionParams,
    LatentDiffusionConfig,
    apply_model,
    decode_video_frames,
    encode_video_frames,
)
from guidedvd3dgs_tpu_torch.diffusion.resampler import ResamplerConfig, resampler_apply
from guidedvd3dgs_tpu_torch.diffusion.samplers.ddim import ddim_sample
from guidedvd3dgs_tpu_torch.diffusion.tokenizer import tokenize

GUIDED_SLICE = ("comes with the guided sampler slice (samplers/ddim_guidance.py, "
                "samplers/ddim_multicond.py)")


@dataclass(frozen=True)
class SynthesisConfig:
    ddim_steps: int = 50
    ddim_eta: float = 1.0
    cfg_scale: float = 7.5
    guidance_rescale: float = 0.7
    timestep_spacing: str = "uniform_trailing"
    # the two-scale CFG (reference --multiple_cond_cfg): not in this slice
    multiple_cond_cfg: bool = False
    fs: int = 10
    prompt: str = "Rotating view of a scene"
    text_config: clip_mod.TextConfig = field(default_factory=clip_mod.TextConfig)
    vision_config: clip_mod.VisionConfig = field(default_factory=clip_mod.VisionConfig)
    resampler_config: ResamplerConfig = field(default_factory=ResamplerConfig)


class SynthesisNoise(NamedTuple):
    """Injected noise of one request; a None field is drawn from the
    generator. encode_eps: (T, h, w, 4); x_T: (1, T, h, w, 4); steps:
    (S, 1, T, h, w, 4) in the sampler's loop order."""

    encode_eps: Optional[torch.Tensor] = None
    x_T: Optional[torch.Tensor] = None
    steps: Optional[torch.Tensor] = None


def _check_unguided(guidance_fn, scfg: SynthesisConfig) -> None:
    if guidance_fn is not None or scfg.multiple_cond_cfg:
        raise NotImplementedError("guided and two-scale CFG sampling " + GUIDED_SLICE)


def encode_text_pair(params: DiffusionParams, scfg: SynthesisConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CLIP text embeddings of the prompt and of the empty prompt."""
    return tuple(clip_mod.text_encode(params.clip_text, scfg.text_config,
                                      torch.as_tensor(tokenize([text]), dtype=torch.int64, device=device))
                 for text in (scfg.prompt, ""))


def build_conditioning(params: DiffusionParams, mcfg: LatentDiffusionConfig, scfg: SynthesisConfig,
                       video: torch.Tensor, eps: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       text_pair: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """(cond, uncond) Conditioning (reference diffusion_utils.py:134-174).
    video: (T, H, W, 3) renders in [-1, 1], frame 0 the real image; eps:
    the VAE encode's noise; text_pair: precomputed (txt, txt_uc)."""
    if text_pair is None:
        text_pair = encode_text_pair(params, scfg, video.device)
    txt, txt_uc = text_pair
    frame0 = video[:1]
    img_emb, img_emb_uc = (
        resampler_apply(params.resampler, scfg.resampler_config,
                        clip_mod.image_encode(params.clip_image, scfg.vision_config, img))
        for img in (frame0, torch.zeros_like(frame0)))
    z = encode_video_frames(params, mcfg, video, eps=eps, generator=generator)[None]
    fs = torch.full((1,), scfg.fs, dtype=torch.int64, device=video.device)
    return (Conditioning(context=torch.cat([txt, img_emb], dim=1), concat=z, fs=fs),
            Conditioning(context=torch.cat([txt_uc, img_emb_uc], dim=1), concat=z, fs=fs))


def sample_from_conditioning(params: DiffusionParams, mcfg: LatentDiffusionConfig,
                             scfg: SynthesisConfig, cond: Conditioning, uncond: Conditioning,
                             noise: SynthesisNoise = SynthesisNoise(),
                             generator: Optional[torch.Generator] = None,
                             guidance_fn=None) -> torch.Tensor:
    """Sampling and decode from prebuilt conditioning: the generated video
    (T, H, W, 3) in [-1, 1]. Without guidance only."""
    _check_unguided(guidance_fn, scfg)
    dev = cond.concat.device
    sched = mcfg.schedule(dev)
    pr = S.make_ddim_params(sched, scfg.ddim_steps, eta=scfg.ddim_eta, method=scfg.timestep_spacing)
    _, t, lh, lw, _ = cond.concat.shape
    x_T = noise.x_T
    if x_T is None:
        x_T = torch.randn((1, t, lh, lw, 4), generator=generator, dtype=torch.float32, device=dev)

    def ap_c(x, ts):
        return apply_model(params, mcfg, x, ts, cond)

    def ap_u(x, ts):
        return apply_model(params, mcfg, x, ts, uncond)

    x0 = ddim_sample(sched, pr, ap_c, ap_u, x_T, noise=noise.steps, generator=generator,
                     cfg_scale=scfg.cfg_scale, guidance_rescale=scfg.guidance_rescale)
    return decode_video_frames(params, mcfg, x0[0])


def image_guided_synthesis(params: DiffusionParams, mcfg: LatentDiffusionConfig,
                           scfg: SynthesisConfig, video: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           noise: SynthesisNoise = SynthesisNoise(), guidance_fn=None,
                           text_pair: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """The generated video (T, H, W, 3) in [-1, 1] from renders `video`
    (T, H, W, 3) in [-1, 1]. Without guidance only: a guidance function or
    multiple_cond_cfg raises NotImplementedError."""
    _check_unguided(guidance_fn, scfg)
    cond, uncond = build_conditioning(params, mcfg, scfg, video, eps=noise.encode_eps,
                                      generator=generator, text_pair=text_pair)
    return sample_from_conditioning(params, mcfg, scfg, cond, uncond, noise=noise, generator=generator)
