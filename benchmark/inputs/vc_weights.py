"""ViewCrafter's weights, random from the seed, made on the device.

Every weight is N(0, 0.02), every norm's weight one and every bias zero,
as the port's own random init (`diffusion/init.py`) and the JAX package's
draw them; the key set and shapes are the checkpoint's
(reference/vc/layout.py). Each sub-model's weights come from one
`torch.randn` call into one buffer of the served type, of which every
parameter is a view: a few large calls on the card, not one per leaf.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from reference.vc.layout import Layout, diffusion_layout
from reference.vc.model import DiffusionParams

STD = 0.02


def _make(layout: Layout, gen: torch.Generator, device, dtype) -> Dict[str, torch.Tensor]:
    sizes = {k: math.prod(shape) for k, (shape, _) in layout.items()}
    n_rand = sum(sizes[k] for k, (_, kind) in layout.items() if kind == "normal")
    n_fill = sum(sizes[k] for k, (_, kind) in layout.items() if kind != "normal")
    rand = torch.randn(n_rand, generator=gen, device=device, dtype=dtype).mul_(STD)
    fill = torch.empty(n_fill, device=device, dtype=dtype)
    out, ir, jf = {}, 0, 0
    for k, (shape, kind) in layout.items():
        n = sizes[k]
        if kind == "normal":
            out[k] = rand[ir:ir + n].view(shape)
            ir += n
        else:
            out[k] = fill[jf:jf + n].view(shape).fill_(kind)
            jf += n
    return out


def make_weights(cfgs: Tuple, seed: int, device, dtype=torch.bfloat16) -> DiffusionParams:
    """DiffusionParams (unet, vae, resampler, clip_text, clip_image) of the
    configs (unet, vae, resampler, text, vision) from one generator seeded
    with `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return DiffusionParams(*(_make(lay, gen, device, dtype) for lay in diffusion_layout(*cfgs)))
