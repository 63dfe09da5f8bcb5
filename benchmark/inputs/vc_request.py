"""One ViewCrafter request's inputs, made by the benchmark from the seed.

Along a 25-frame orbit through the room (benchmark/inputs/room.py), at
the train resolution the guided trainer hands its engine (480 x 640):
  * the frozen model's renders: the room ray-cast (`images`, `depths`);
  * the observed mask: ones with a seeded rectangular hole of `hole`
    of the frame (the unobserved region an event fills);
  * the point-cloud renders: the images with the hole black;
then the request's noise: the VAE encode's eps, x_T and each DDIM step's
eta noise, drawn on the device from the same seed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from inputs import room as R


class Request(NamedTuple):
    renders: torch.Tensor  # (T, H, W, 3) in [0, 1], the point-cloud renders
    images: torch.Tensor  # (T, 3, H, W) guidance images in [0, 1]
    masks: torch.Tensor  # (T, 1, H, W) observed = 1
    depths: torch.Tensor  # (T, 1, H, W)
    eps: torch.Tensor  # (T, h, w, 4) the VAE encode's noise
    x_T: torch.Tensor  # (1, T, h, w, 4)
    noise: torch.Tensor  # (steps, 1, T, h, w, 4) each step's eta noise


def make_request(seed: int, traffic: dict, latent_hw, device) -> Request:
    rng = np.random.default_rng(seed)
    room = R.make_room(rng)
    t, gh, gw = traffic["frames"], traffic["guide_height"], traffic["guide_width"]
    c2ws = R.orbit_c2ws(t, phase=float(rng.uniform(0, 2 * math.pi)))
    imgs, deps = zip(*(R.raycast(room, c, gw, gh, traffic["hfov_deg"], device) for c in c2ws))
    images = torch.stack(imgs)  # (T, H, W, 3)
    depths = torch.stack(deps)[:, None]
    hh, hw = int(round(gh * math.sqrt(traffic["hole"]))), int(round(gw * math.sqrt(traffic["hole"])))
    y0, x0 = int(rng.integers(0, gh - hh + 1)), int(rng.integers(0, gw - hw + 1))
    masks = torch.ones((t, 1, gh, gw), device=device)
    masks[:, :, y0:y0 + hh, x0:x0 + hw] = 0.0
    renders = images * masks.permute(0, 2, 3, 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    lh, lw = latent_hw
    eps = torch.randn((t, lh, lw, 4), generator=gen, device=device)
    x_T = torch.randn((1, t, lh, lw, 4), generator=gen, device=device)
    noise = torch.randn((traffic["ddim_steps"], 1, t, lh, lw, 4), generator=gen, device=device)
    return Request(renders, images.permute(0, 3, 1, 2).contiguous(), masks, depths, eps, x_T, noise)
