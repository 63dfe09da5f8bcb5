"""The diffusion engine of the guided trainer.

Counterpart of the engine half of `guidedvd3dgs_tpu/train/guided.py`
(:181-205 the DiffusionEngine protocol, :297-602 ViewCrafterEngine;
reference utils/viewcrafter_wrapper.py:550-573 run_video_diffusion):
generation with scene-grounding guidance, or without it (the reference's
--no_guidance). The trainer around it is not ported yet. Every weight stays
resident on the device.
"""

from __future__ import annotations

from typing import Optional, Protocol

import torch
import torch.nn.functional as F

from guidedvd3dgs_tpu_torch.diffusion.model import DiffusionParams, LatentDiffusionConfig
from guidedvd3dgs_tpu_torch.diffusion.samplers.ddim_guidance import GuidedSampleConfig
from guidedvd3dgs_tpu_torch.diffusion.synthesis import (
    SynthesisConfig,
    SynthesisNoise,
    encode_text_pair,
    image_guided_synthesis,
)
from guidedvd3dgs_tpu_torch.guidance.loss_guidance import make_guidance_fn, resize_guidance


def resize_renders(video: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(T, H, W, C) frames at (height, width), bilinear as the reference's
    jax.image.resize (guided.py:561-564): antialiased where it shrinks (an
    antialiased bilinear that enlarges is the plain one)."""
    if video.shape[1:3] == (height, width):
        return video
    return F.interpolate(video.permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
                         align_corners=False, antialias=True).permute(0, 2, 3, 1)


class DiffusionEngine(Protocol):
    """Produces a video from point-cloud renders along a trajectory."""

    def generate(
        self,
        pc_renders: torch.Tensor,  # (T, H, W, 3) in [0, 1]
        guidance_images: torch.Tensor,  # (T, 3, Hg, Wg)
        guidance_masks: torch.Tensor,  # (T, 1, Hg, Wg)
        guidance_depths: torch.Tensor,  # (T, 1, Hg, Wg)
        generator: Optional[torch.Generator] = None,
        no_guidance: bool = False,
        scale_guidance_weight: float = 1.0,
    ) -> torch.Tensor:  # (T, 3, H, W) in [0, 1]
        ...


class ViewCrafterEngine:
    """The ViewCrafter stack behind DiffusionEngine. `params` live on the
    device the engine runs on; the prompt's text embeddings are computed
    once here (the prompt is fixed). `guided_cfg` configures the guided
    sampler; `w_recon`, `ssim_guidance`, `recon_loss` and `lpips_fn` the
    guidance loss (reference LossGuidance, viewcrafter_wrapper.py:47-99)."""

    def __init__(self, params: DiffusionParams, mcfg: LatentDiffusionConfig, scfg: SynthesisConfig,
                 guided_cfg: Optional[GuidedSampleConfig] = None, video_length: int = 25,
                 height: int = 320, width: int = 448, w_recon: float = 0.5,
                 ssim_guidance: bool = False, lpips_fn=None, recon_loss: str = "l2"):
        self.params, self.mcfg, self.scfg = params, mcfg, scfg
        self.guided_cfg = guided_cfg or GuidedSampleConfig()
        self.video_length, self.height, self.width = video_length, height, width
        self.w_recon, self.ssim_guidance, self.lpips_fn = w_recon, ssim_guidance, lpips_fn
        self.recon_loss = recon_loss
        # in the guidance-weight warmup mode the reference drops the alpha
        # mask and applies the loss everywhere (viewcrafter_wrapper.py:147-151)
        self.scale_weight_mode = False
        self.device = params.unet["out.2.weight"].device
        with torch.no_grad():
            self.text_pair = encode_text_pair(params, scfg, self.device)

    def generate(self, pc_renders, guidance_images=None, guidance_masks=None, guidance_depths=None,
                 generator: Optional[torch.Generator] = None, no_guidance: bool = False,
                 scale_guidance_weight: float = 1.0,
                 noise: SynthesisNoise = SynthesisNoise()) -> torch.Tensor:
        """pc_renders: (T, H, W, 3) point-cloud renders in [0, 1] at any
        size (resized to the engine's, reference guided.py:557-565); the
        guidance images (T, 3, Hg, Wg) in [0, 1], masks and depths (T, 1,
        Hg, Wg) at any size (resized by resize_guidance). Returns the
        generated (T, 3, height, width) video in [0, 1]. `noise` injects the
        request's noise; the rest is drawn from `generator`."""
        dev = self.device
        with torch.no_grad():
            video = resize_renders(pc_renders.to(dev, torch.float32), self.height, self.width)
        guidance_fn = None
        if not no_guidance:
            as_dev = (lambda a: None if a is None else a.to(dev, torch.float32))
            buffers = resize_guidance(as_dev(guidance_images), self.height, self.width,
                                      masks=None if self.scale_weight_mode else as_dev(guidance_masks),
                                      depths=as_dev(guidance_depths))
            guidance_fn = make_guidance_fn(buffers, w_recon=self.w_recon, ssim_guidance=self.ssim_guidance,
                                           lpips_fn=self.lpips_fn, recon_loss=self.recon_loss)
        frames = image_guided_synthesis(self.params, self.mcfg, self.scfg, video * 2.0 - 1.0,
                                        generator=generator, noise=noise, guidance_fn=guidance_fn,
                                        guided_cfg=self.guided_cfg,
                                        scale_guidance_weight=scale_guidance_weight,
                                        text_pair=self.text_pair)
        return torch.clamp((frames + 1.0) / 2.0, 0.0, 1.0).permute(0, 3, 1, 2)
