"""The request's conditioning: the plain reference's frozen copy of the
port's `diffusion/synthesis.py::encode_text_pair` and `build_conditioning`
(reference utils_vc/diffusion_utils.py:134-181):

  cond context   = OpenCLIP-text(prompt) ++ Resampler(OpenCLIP-image(frame0))
  uncond context = OpenCLIP-text("")     ++ Resampler(OpenCLIP-image(zeros))
  c_concat       = the VAE latents of the point-cloud renders (both)
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import clip as clip_mod
from .model import Conditioning, DiffusionParams, LatentDiffusionConfig, encode_video_frames
from .resampler import ResamplerConfig, resampler_apply
from .tokenizer import tokenize

PROMPT = "Rotating view of a scene"


def encode_text_pair(params: DiffusionParams, text_cfg: clip_mod.TextConfig, device,
                     prompt: str = PROMPT) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CLIP text embeddings of the prompt and of the empty prompt."""
    return tuple(clip_mod.text_encode(params.clip_text, text_cfg,
                                      torch.as_tensor(tokenize([text]), dtype=torch.int64, device=device))
                 for text in (prompt, ""))


def build_conditioning(params: DiffusionParams, mcfg: LatentDiffusionConfig, text_cfg: clip_mod.TextConfig,
                       vision_cfg: clip_mod.VisionConfig, res_cfg: ResamplerConfig, video: torch.Tensor,
                       eps: torch.Tensor, fs: int = 10) -> Tuple[Conditioning, Conditioning]:
    """(cond, uncond). video: (T, H, W, 3) renders in [-1, 1], frame 0 the
    real image; eps: the VAE encode's noise (T, h, w, 4)."""
    txt, txt_uc = encode_text_pair(params, text_cfg, video.device)
    frame0 = video[:1]
    img_emb, img_emb_uc = (resampler_apply(params.resampler, res_cfg,
                                           clip_mod.image_encode(params.clip_image, vision_cfg, img))
                           for img in (frame0, torch.zeros_like(frame0)))
    z = encode_video_frames(params, mcfg, video, eps=eps)[None]
    fsv = torch.full((1,), fs, dtype=torch.int64, device=video.device)
    return (Conditioning(context=torch.cat([txt, img_emb], dim=1), concat=z, fs=fsv),
            Conditioning(context=torch.cat([txt_uc, img_emb_uc], dim=1), concat=z, fs=fsv))
