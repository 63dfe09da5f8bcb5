"""VGG19's feature weights, random from the seed on the device: He-normal
convolutions (the port's `random_vgg19` draw: N(0, 2 / (9 c_in))), zero
biases, one `torch.randn` call for all of them."""

from __future__ import annotations

import math

import torch

from reference.gs.vgg import CHANNELS


def make_vgg(seed: int, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sizes = {ci: cout * cin * 9 for ci, (cin, cout) in CHANNELS.items()}
    buf = torch.randn(sum(sizes.values()), generator=gen, device=device)
    p, o = {}, 0
    for ci, (cin, cout) in CHANNELS.items():
        n = sizes[ci]
        p[f"features.{ci}.weight"] = buf[o:o + n].view(cout, cin, 3, 3).mul_(math.sqrt(2.0 / (9 * cin)))
        p[f"features.{ci}.bias"] = torch.zeros(cout, device=device)
        o += n
    return p
