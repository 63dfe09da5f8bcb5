"""Scene-grounding guidance loss (Eq. 6 of the paper).

Counterpart of `guidedvd3dgs_tpu/guidance/loss_guidance.py` (reference
LossGuidance, utils/viewcrafter_wrapper.py:47-192); the plain reference's
frozen copy of the port's module, without the SSIM term and the weight
warmup, which the benchmark's requests do not use: the frozen baseline's
renderings (rgb, mask, depth) resized to the diffusion resolution, and per
DDIM step and frame the masked reconstruction loss

    L = w_recon * (x_hat0 - guide)^2 * mask    (summed, not averaged: the
        sampler divides each frame's gradient by its mask's numel)

optionally mixed 0.8 / 0.2 with the per-pixel SSIM, plus numel * 0.001
times a perceptual term `lpips_fn` (in the CLI the VGG loss of
utils/vgg_loss.py, as in the reference's). The guidance function takes a
batch of decoded frames (the sampler decodes `decode_chunk` frames at once)
and returns each frame's summed loss and numel.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F



class GuidanceBuffers(NamedTuple):
    images: torch.Tensor  # (T, H, W, 3) in [0, 1] at the diffusion resolution
    masks: Optional[torch.Tensor]  # (T, H, W, 1) or None
    depths: Optional[torch.Tensor]  # (T, H, W, 1) or None


def _resize(x: torch.Tensor, height: int, width: int, **mode) -> torch.Tensor:
    """(T, C, H0, W0) -> (T, height, width, C)."""
    return F.interpolate(x, size=(height, width), **mode).permute(0, 2, 3, 1)


def resize_guidance(images: torch.Tensor, height: int, width: int,
                    masks: Optional[torch.Tensor] = None,
                    depths: Optional[torch.Tensor] = None) -> GuidanceBuffers:
    """Resize to the diffusion resolution (reference viewcrafter_wrapper.py:
    104-121): images (T, 3, H0, W0) in [0, 1] bilinear, antialiased where
    they shrink, as jax.image.resize, clipped to [0, 1]; masks and depths
    (T, 1, H0, W0) nearest, with the pixel-centre rule of jax.image.resize
    ("nearest-exact"; torch's "nearest" picks other pixels)."""
    img = _resize(images, height, width, mode="bilinear", align_corners=False, antialias=True)
    m = None if masks is None else _resize(masks, height, width, mode="nearest-exact")
    d = None if depths is None else _resize(depths, height, width, mode="nearest-exact")
    return GuidanceBuffers(images=torch.clamp(img, 0.0, 1.0), masks=m, depths=d)


# guidance_fn(decoded frames (c, H, W, 3) in [-1, 1], ddim_index, frame
# indices (c,)) -> (summed loss per frame (c,), numel per frame (c,))
GuidanceFn = Callable[[torch.Tensor, int, torch.Tensor], tuple]
# lpips_fn(frames (c, H, W, 3), guidance (c, H, W, 3), mask (c, H, W, 3),
# all in [0, 1]) -> (c,): each frame's loss on its own, as the JAX
# package's per-frame call (one mean over the chunk would hand every frame
# the chunk's mean)
LpipsFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def make_guidance_fn(buffers: GuidanceBuffers, w_recon: float = 0.5, ssim_guidance: bool = False,
                     lpips_fn: Optional[LpipsFn] = None, recon_loss: str = "l2") -> GuidanceFn:
    """The sampler's GuidanceFn (reference viewcrafter_wrapper.py:123-165;
    `recon_loss` is the --guidance_recon_loss flag, "l2" the reference's
    behaviour)."""
    if recon_loss not in ("l1", "l2"):
        raise ValueError(f"recon_loss must be 'l1' or 'l2', got {recon_loss!r}")
    recon_fn = torch.abs if recon_loss == "l1" else torch.square

    def guidance_fn(frames: torch.Tensor, ddim_index: int, frame_idx: torch.Tensor):
        d = torch.clamp((frames + 1.0) / 2.0, 0.0, 1.0)  # (c, H, W, 3) in [0, 1]
        g = buffers.images[frame_idx]
        mask = torch.ones_like(d) if buffers.masks is None else buffers.masks[frame_idx].expand_as(d)
        loss = (w_recon * recon_fn(d - g) * mask).sum(dim=(1, 2, 3))
        numel = mask.sum(dim=(1, 2, 3))
        if ssim_guidance:
            raise NotImplementedError("the reference copy carries the l2 / l1 recon loss only")
        if lpips_fn is not None:
            # reference viewcrafter_wrapper.py:158-160
            loss = loss + numel * lpips_fn(d, g, mask) * 0.001
        return loss, numel

    return guidance_fn

