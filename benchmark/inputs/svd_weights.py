"""SVD-XT's weights, random from the seed, made on the device, in the
diffusers layout (the key set and shapes of reference/svd/svd_xt.py::
layout, prefixed "unet.", "vae.", "image_encoder.").

Every weight is N(0, 0.02), every norm's weight one, every bias zero and
every mix factor at its initial value, as the port's own random
checkpoint draws them (`diffusion/convert.py::random_svd_state_dict`).
The weights come from one `torch.randn` call into one buffer of the
served type, of which every parameter is a view.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from reference.svd.svd_xt import layout

STD = 0.02


def make_weights(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    lay = layout(cfg)
    sizes = {k: math.prod(shape) for k, (shape, _) in lay.items()}
    n_rand = sum(sizes[k] for k, (_, kind) in lay.items() if kind == "normal")
    n_fill = sum(sizes[k] for k, (_, kind) in lay.items() if kind != "normal")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rand = torch.randn(n_rand, generator=gen, device=device, dtype=dtype).mul_(STD)
    fill = torch.empty(n_fill, device=device, dtype=dtype)
    out, ir, jf = {}, 0, 0
    for k, (shape, kind) in lay.items():
        n = sizes[k]
        if kind == "normal":
            out[k] = rand[ir:ir + n].view(shape)
            ir += n
        else:
            out[k] = fill[jf:jf + n].view(shape).fill_(kind)
            jf += n
    return out
