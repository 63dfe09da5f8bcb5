"""The diffusion engine of the guided trainer.

Counterpart of the engine half of `guidedvd3dgs_tpu/train/guided.py`
(:181-205 the DiffusionEngine protocol, :297-602 ViewCrafterEngine;
reference utils/viewcrafter_wrapper.py:550-573 run_video_diffusion). This
slice carries generation without guidance (the reference's --no_guidance);
the guided sampler and the trainer around it come with the guided slice.
Every weight stays resident on the device.
"""

from __future__ import annotations

from typing import Optional, Protocol

import torch
import torch.nn.functional as F

from guidedvd3dgs_tpu_torch.diffusion.model import DiffusionParams, LatentDiffusionConfig
from guidedvd3dgs_tpu_torch.diffusion.synthesis import (
    GUIDED_SLICE,
    SynthesisConfig,
    SynthesisNoise,
    encode_text_pair,
    image_guided_synthesis,
)


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
    once here (the prompt is fixed)."""

    def __init__(self, params: DiffusionParams, mcfg: LatentDiffusionConfig, scfg: SynthesisConfig,
                 video_length: int = 25, height: int = 320, width: int = 448):
        self.params, self.mcfg, self.scfg = params, mcfg, scfg
        self.video_length, self.height, self.width = video_length, height, width
        self.device = params.unet["out.2.weight"].device
        with torch.no_grad():
            self.text_pair = encode_text_pair(params, scfg, self.device)

    @torch.no_grad()
    def generate(self, pc_renders, guidance_images=None, guidance_masks=None, guidance_depths=None,
                 generator: Optional[torch.Generator] = None, no_guidance: bool = False,
                 scale_guidance_weight: float = 1.0,
                 noise: SynthesisNoise = SynthesisNoise()) -> torch.Tensor:
        """pc_renders: (T, H, W, 3) point-cloud renders in [0, 1] at any
        size (resized to the engine's, reference guided.py:557-565). Returns
        the generated (T, 3, height, width) video in [0, 1]. `noise`
        injects the request's noise; the rest is drawn from `generator`."""
        if not no_guidance:
            raise NotImplementedError("generation with scene-grounding guidance " + GUIDED_SLICE)
        video = resize_renders(pc_renders.to(self.device, torch.float32), self.height, self.width)
        frames = image_guided_synthesis(self.params, self.mcfg, self.scfg, video * 2.0 - 1.0,
                                        generator=generator, noise=noise, text_pair=self.text_pair)
        return torch.clamp((frames + 1.0) / 2.0, 0.0, 1.0).permute(0, 3, 1, 2)
