"""The model FLOPs of one DDIM step, counted by
`torch.utils.flop_counter.FlopCounterMode` over the benchmark's plain
reference (benchmark/reference/vc) on the `meta` device: no weights, no
data, only shapes. Matrix products and convolutions are counted (2 per
multiply-add), elementwise work is not, as a model FLOP count does.

Guided step: the CFG pair's forward at batch 2, each decode chunk's VAE
decode with its gradient to the latents, and each branch's forward with
its VJP to x (the program's recomputation for the VJP is its own choice,
so the branches' forwards count: the step needs them). Plain step: the
pair as two forwards at batch 1. Activation checkpointing is off while
counting, so that nothing is counted twice.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference.vc import nnops
from reference.vc.layout import diffusion_layout
from reference.vc.model import decode_video_frames
from reference.vc.unet3d import unet_apply


def _meta_params(layout) -> dict:
    return {k: torch.empty(shape, device="meta", dtype=torch.bfloat16) for k, (shape, _) in layout.items()}


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def step_flops(cfgs, mcfg, traffic: dict, context_tokens: int) -> int:
    """cfgs: the reference's (unet, vae, resampler, text, vision) configs;
    mcfg: its LatentDiffusionConfig in the served type."""
    unet_l, vae_l = diffusion_layout(*cfgs)[:2]
    up, vp = _meta_params(unet_l), _meta_params(vae_l)
    dt = mcfg.dtype
    ucfg = mcfg.unet
    t = traffic["frames"]
    f = 2 ** (len(mcfg.vae.ch_mult) - 1)
    lh, lw = traffic["height"] // f, traffic["width"] // f

    def unet(b: int, grad: bool):
        x = torch.empty((b, t, lh, lw, ucfg.in_channels), device="meta", dtype=dt, requires_grad=grad)
        ts = torch.zeros((b,), device="meta", dtype=torch.int64)
        ctx = torch.empty((b, context_tokens, ucfg.context_dim), device="meta", dtype=dt)
        fs = torch.zeros((b,), device="meta", dtype=torch.int64)
        with torch.set_grad_enabled(grad):
            v = unet_apply(up, ucfg, x, ts, ctx, fs=fs)
            if grad:
                torch.autograd.grad(v, x, torch.empty_like(v))

    def decode(c: int):
        from reference.vc.model import DiffusionParams

        z = torch.empty((c, lh, lw, 4), device="meta", dtype=torch.float32, requires_grad=True)
        with torch.enable_grad():
            frames = decode_video_frames(DiffusionParams(None, vp, None, None, None), mcfg, z)
            torch.autograd.grad(frames, z, torch.empty_like(frames))

    with nnops.no_recompute():
        if not traffic["guided"]:
            return 2 * _count(lambda: unet(1, False))
        total = _count(lambda: unet(2, False)) + 2 * _count(lambda: unet(1, True))
        chunk = traffic["decode_chunk"]
        for c0 in range(0, t, chunk):
            total += _count(lambda: decode(min(chunk, t - c0)))
        return total
