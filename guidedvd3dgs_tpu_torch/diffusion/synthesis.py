"""Conditioning assembly and the sampling driver (image_guided_synthesis).

Counterpart of `guidedvd3dgs_tpu/diffusion/synthesis.py` (reference
utils_vc/diffusion_utils.py:111-223):

  cond context   = OpenCLIP-text(prompt) ++ Resampler(OpenCLIP-image(frame0))
  uncond context = OpenCLIP-text("")     ++ Resampler(OpenCLIP-image(zeros))
  c_concat       = the VAE latents of the point-cloud renders (both)

then DDIM sampling with CFG, under scene-grounding guidance when a
guidance function is given (samplers/ddim_guidance.py) and plain otherwise
(the reference's --no_guidance), and the VAE decode of every frame. With
the guidedvd config (25 frames, resampler video_length 16 -> 256 image
tokens) the context is (1, 77 + 256, 1024) and the UNet repeats it per
frame. With `multiple_cond_cfg` (the reference's --multiple_cond_cfg) the
two-scale CFG sampler (samplers/ddim_multicond.py) takes a third context,
"image yes, text empty", and runs unguided as the reference's does.

Noise: the three draws of a request (the VAE encode's eps, x_T, the step
noise) are taken from `noise` where given, else from `generator`.
Conditioning and the final decode run without autograd; the guided
sampler turns it on for its own gradients.

Stable Video Diffusion (`build_svd_conditioning`, `svd_synthesis`;
diffusers `StableVideoDiffusionPipeline.__call__`):

  cond   = (CLIP image embedding of frame 0, the VAE encoder's mode of
            frame 0 + noise_aug_strength * eps, on every frame's channels)
  uncond = (zeros, zeros)
  time ids (both) = (fps - 1, motion_bucket_id, noise_aug_strength)

then the Euler EDM sampler with per-frame CFG (samplers/euler_edm.py),
guided through the shared guided step when a guidance function is given,
and the temporal decode in chunks of `decode_chunk` consecutive frames.
The conditioning latent is the encoder's unscaled mode, as the source's.
A request's draws: `SynthesisNoise.encode_eps` the augmentation noise of
frame 0 (1, H, W, 3), `x_T` standard normal (scaled by the sampler's
initial sigma here), `steps` the re-noise draws of recur_steps > 1.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import torch

from guidedvd3dgs_tpu_torch.diffusion import clip as clip_mod
from guidedvd3dgs_tpu_torch.diffusion import schedules as S
from guidedvd3dgs_tpu_torch.diffusion.model import (
    SVDConditioning,
    SVDConfig,
    SVDParams,
    Conditioning,
    DiffusionParams,
    LatentDiffusionConfig,
    apply_model,
    decode_video_frames,
    encode_video_frames,
)
from guidedvd3dgs_tpu_torch.diffusion.resampler import ResamplerConfig, resampler_apply
from guidedvd3dgs_tpu_torch.diffusion.samplers.ddim import ddim_sample
from guidedvd3dgs_tpu_torch.diffusion.samplers.ddim_guidance import (
    GuidedSampleConfig,
    guided_ddim_sample,
    guided_sample,
)
from guidedvd3dgs_tpu_torch.diffusion.samplers.euler_edm import (
    EulerConfig,
    EulerEDMRule,
    euler_edm_sample,
    frame_scales,
    init_noise_sigma,
)
from guidedvd3dgs_tpu_torch.diffusion.vae import vae_encode_moments
from guidedvd3dgs_tpu_torch.diffusion.samplers.ddim_multicond import ddim_sample_multicond
from guidedvd3dgs_tpu_torch.diffusion.tokenizer import tokenize
from guidedvd3dgs_tpu_torch.guidance.loss_guidance import GuidanceFn


@dataclass(frozen=True)
class SynthesisConfig:
    ddim_steps: int = 50
    ddim_eta: float = 1.0
    cfg_scale: float = 7.5
    guidance_rescale: float = 0.7
    timestep_spacing: str = "uniform_trailing"
    # the two-scale CFG (reference --multiple_cond_cfg / --cfg_img,
    # configs/infer_config.py:45-46); cfg_img None -> cfg_scale
    multiple_cond_cfg: bool = False
    cfg_img: Optional[float] = None
    fs: int = 10
    prompt: str = "Rotating view of a scene"
    text_config: clip_mod.TextConfig = field(default_factory=clip_mod.TextConfig)
    vision_config: clip_mod.VisionConfig = field(default_factory=clip_mod.VisionConfig)
    resampler_config: ResamplerConfig = field(default_factory=ResamplerConfig)


class SynthesisNoise(NamedTuple):
    """Injected noise of one request; a None field is drawn from the
    generator. encode_eps: (T, h, w, 4); x_T: (1, T, h, w, 4); steps:
    (draws, 1, T, h, w, 4) in the sampler's loop order (S draws without
    guidance; S * (2 recur_steps - 1) with it, ddim_guidance.py)."""

    encode_eps: Optional[torch.Tensor] = None
    x_T: Optional[torch.Tensor] = None
    steps: Optional[torch.Tensor] = None


def encode_text_pair(params: DiffusionParams, scfg: SynthesisConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CLIP text embeddings of the prompt and of the empty prompt."""
    return tuple(clip_mod.text_encode(params.clip_text, scfg.text_config,
                                      torch.as_tensor(tokenize([text]), dtype=torch.int64, device=device))
                 for text in (scfg.prompt, ""))


def build_conditioning(params: DiffusionParams, mcfg: LatentDiffusionConfig, scfg: SynthesisConfig,
                       video: torch.Tensor, eps: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       text_pair: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """(cond, uncond, uncond_img) Conditioning (reference
    diffusion_utils.py:134-181; uncond_img, "image yes, text empty", is the
    two-scale CFG's third context). video: (T, H, W, 3) renders in
    [-1, 1], frame 0 the real image; eps: the VAE encode's noise;
    text_pair: precomputed (txt, txt_uc)."""
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
            Conditioning(context=torch.cat([txt_uc, img_emb_uc], dim=1), concat=z, fs=fs),
            Conditioning(context=torch.cat([txt_uc, img_emb], dim=1), concat=z, fs=fs))


def sample_from_conditioning(params: DiffusionParams, mcfg: LatentDiffusionConfig,
                             scfg: SynthesisConfig, cond: Conditioning, uncond: Conditioning,
                             noise: SynthesisNoise = SynthesisNoise(),
                             generator: Optional[torch.Generator] = None,
                             guidance_fn: Optional[GuidanceFn] = None,
                             guided_cfg: GuidedSampleConfig = GuidedSampleConfig(),
                             scale_guidance_weight: float = 1.0, pred_x0_trace: bool = False,
                             uncond_img: Optional[Conditioning] = None):
    """Sampling and decode from prebuilt conditioning: the generated video
    (T, H, W, 3) in [-1, 1]. With `guidance_fn`, the guided sampler with
    `guided_cfg` (its CFG scale and rescale taken from `scfg`, as JAX
    synthesis.py:236-238). With `scfg.multiple_cond_cfg`, the two-scale CFG
    sampler on (cond, uncond, uncond_img), which takes no guidance (JAX
    synthesis.py:211-227; the engine decides to run such a request
    unguided, so a `guidance_fn` here is refused). With `pred_x0_trace`,
    (video, the guided sampler's per-step pred_x0 latents (S, T, h, w, 4),
    or None without guidance)."""
    if guidance_fn is not None and scfg.multiple_cond_cfg:
        raise ValueError("multiple_cond_cfg takes no guidance_fn: the two-scale CFG sampler is unguided")
    dev = cond.concat.device
    sched = mcfg.schedule(dev)
    pr = S.make_ddim_params(sched, scfg.ddim_steps, eta=scfg.ddim_eta, method=scfg.timestep_spacing)
    _, t, lh, lw, _ = cond.concat.shape
    x_T = noise.x_T
    if x_T is None:
        x_T = torch.randn((1, t, lh, lw, 4), generator=generator, dtype=torch.float32, device=dev)

    if guidance_fn is not None:
        gcfg = dataclasses.replace(guided_cfg, cfg_scale=scfg.cfg_scale,
                                   guidance_rescale=scfg.guidance_rescale)
        x0 = guided_ddim_sample(params, mcfg, sched, pr, cond, uncond, x_T, guidance_fn, gcfg,
                                scale_guidance_weight, noise=noise.steps, generator=generator,
                                return_trace=pred_x0_trace)
        if pred_x0_trace:
            x0, trace = x0
    else:
        def ap_c(x, ts):
            return apply_model(params, mcfg, x, ts, cond)

        def ap_u(x, ts):
            return apply_model(params, mcfg, x, ts, uncond)

        with torch.no_grad():
            if scfg.multiple_cond_cfg:
                if uncond_img is None:
                    raise ValueError("multiple_cond_cfg needs the uncond_img conditioning")

                def ap_ui(x, ts):
                    return apply_model(params, mcfg, x, ts, uncond_img)

                cfg_img = scfg.cfg_scale if scfg.cfg_img is None else scfg.cfg_img
                x0 = ddim_sample_multicond(sched, pr, ap_c, ap_u, ap_ui, x_T, noise=noise.steps,
                                           generator=generator, cfg_text=scfg.cfg_scale, cfg_img=cfg_img,
                                           guidance_rescale=scfg.guidance_rescale)
            else:
                x0 = ddim_sample(sched, pr, ap_c, ap_u, x_T, noise=noise.steps, generator=generator,
                                 cfg_scale=scfg.cfg_scale, guidance_rescale=scfg.guidance_rescale)
        trace = None
    with torch.no_grad():
        frames = decode_video_frames(params, mcfg, x0[0])
    return (frames, trace) if pred_x0_trace else frames


def image_guided_synthesis(params: DiffusionParams, mcfg: LatentDiffusionConfig,
                           scfg: SynthesisConfig, video: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           noise: SynthesisNoise = SynthesisNoise(),
                           guidance_fn: Optional[GuidanceFn] = None,
                           guided_cfg: GuidedSampleConfig = GuidedSampleConfig(),
                           scale_guidance_weight: float = 1.0,
                           text_pair: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                           pred_x0_trace: bool = False):
    """The generated video (T, H, W, 3) in [-1, 1] from renders `video`
    (T, H, W, 3) in [-1, 1], guided by `guidance_fn` when given; with
    `pred_x0_trace`, (video, trace) as sample_from_conditioning."""
    with torch.no_grad():
        cond, uncond, uncond_img = build_conditioning(params, mcfg, scfg, video, eps=noise.encode_eps,
                                          generator=generator, text_pair=text_pair)
    return sample_from_conditioning(params, mcfg, scfg, cond, uncond, noise=noise, generator=generator,
                                    guidance_fn=guidance_fn, guided_cfg=guided_cfg,
                                    scale_guidance_weight=scale_guidance_weight,
                                    pred_x0_trace=pred_x0_trace, uncond_img=uncond_img)


@dataclass(frozen=True)
class SVDSynthesisConfig:
    """An SVD-XT request: the pipeline's defaults for XT (fps 7, motion
    bucket 127, noise augmentation 0.02, decode chunk 14 as Stability's
    simple_video_sample.py's decoding_t) and the Euler EDM sampler's."""

    euler: EulerConfig = field(default_factory=EulerConfig)
    fps: int = 7  # the added time id is fps - 1
    motion_bucket_id: int = 127
    noise_aug_strength: float = 0.02
    decode_chunk: int = 14


def build_svd_conditioning(params: SVDParams, cfg: SVDConfig, scfg: SVDSynthesisConfig, video: torch.Tensor,
                           aug_noise: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None):
    """(cond, uncond) SVDConditioning of renders `video` (T, H, W, 3) in
    [-1, 1], conditioned on frame 0; aug_noise (1, H, W, 3), else drawn
    from `generator`."""
    frame0 = video[:1]
    emb = clip_mod.image_embed(params.clip_image, cfg.vision, frame0)[:, None]
    if aug_noise is None:
        aug_noise = torch.randn(frame0.shape, generator=generator, dtype=frame0.dtype, device=frame0.device)
    moments = vae_encode_moments(params.vae, cfg.vae, frame0 + scfg.noise_aug_strength * aug_noise.to(frame0.dtype))
    mean = moments.chunk(2, dim=-1)[0]
    concat = mean[:, None].expand(1, video.shape[0], *mean.shape[1:])
    ids = torch.tensor([[scfg.fps - 1, scfg.motion_bucket_id, scfg.noise_aug_strength]], dtype=torch.float32,
                       device=video.device)
    return (SVDConditioning(context=emb, concat=concat, time_ids=ids),
            SVDConditioning(context=torch.zeros_like(emb), concat=torch.zeros_like(concat), time_ids=ids))


def decode_chunks(params: SVDParams, cfg: SVDConfig, zs: torch.Tensor, chunk: int) -> torch.Tensor:
    """(T, h, w, 4) -> (T, H, W, 3): consecutive chunks of `chunk` frames,
    each decoded as one video."""
    return torch.cat([decode_video_frames(params, cfg, zs[c0:c0 + chunk]) for c0 in range(0, zs.shape[0], chunk)])


def svd_sample_from_conditioning(params: SVDParams, cfg: SVDConfig, scfg: SVDSynthesisConfig,
                                 cond: SVDConditioning, uncond: SVDConditioning,
                                 noise: SynthesisNoise = SynthesisNoise(),
                                 generator: Optional[torch.Generator] = None,
                                 guidance_fn: Optional[GuidanceFn] = None,
                                 guided_cfg: GuidedSampleConfig = GuidedSampleConfig(),
                                 scale_guidance_weight: float = 1.0, pred_x0_trace: bool = False):
    """The generated video (T, H, W, 3) in [-1, 1]; guided by `guidance_fn`
    with `guided_cfg` (its decode chunk taken from `scfg`) when given. With
    `pred_x0_trace`, (video, the guided sampler's per-step D latents or
    None)."""
    dev = cond.concat.device
    edm = scfg.euler.params(dev)
    _, t, lh, lw, _ = cond.concat.shape
    scales = frame_scales(scfg.euler, t, dev)
    x_T = noise.x_T
    if x_T is None:
        x_T = torch.randn((1, t, lh, lw, 4), generator=generator, dtype=torch.float32, device=dev)
    x_T = x_T * init_noise_sigma(edm)
    trace = None
    if guidance_fn is not None:
        rule = EulerEDMRule(edm, scales, dataclasses.replace(guided_cfg, decode_chunk=scfg.decode_chunk))
        x0 = guided_sample(params, cfg, rule, cond, uncond, x_T, guidance_fn, scale_guidance_weight,
                           noise=noise.steps, generator=generator, return_trace=pred_x0_trace)
        if pred_x0_trace:
            x0, trace = x0
    else:
        with torch.no_grad():
            x0 = euler_edm_sample(params, cfg, edm, scales, cond, uncond, x_T)
    with torch.no_grad():
        frames = decode_chunks(params, cfg, x0[0], scfg.decode_chunk)
    return (frames, trace) if pred_x0_trace else frames
