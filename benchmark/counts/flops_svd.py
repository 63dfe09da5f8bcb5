"""The model FLOPs of one guided Euler EDM step of Stable Video Diffusion
XT, counted by `torch.utils.flop_counter.FlopCounterMode` over the plain
reference (benchmark/reference/svd) on the `meta` device, as
counts/flops.py counts a ViewCrafter step: the CFG pair's forward at
batch 2, each branch's forward with its VJP to x, and each decode chunk's
temporal decode with its gradient to the latents; matrix products and
convolutions only, activation checkpointing off."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference.svd import svd_xt as R


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def step_flops(cfg: dict, traffic: dict) -> int:
    dt = getattr(torch, cfg["compute_dtype"])
    sd = {k: torch.empty(shape, device="meta", dtype=dt) for k, (shape, _) in R.layout(cfg).items()}
    unet_p, vae_p, _ = R.split(sd)
    u, t = cfg["unet"], traffic["frames"]
    f = 2 ** (len(cfg["vae"]["ch_mult"]) - 1)
    lh, lw = traffic["height"] // f, traffic["width"] // f

    def unet(b: int, grad: bool):
        x = torch.empty((b, t, u["in_channels"], lh, lw), device="meta", dtype=dt, requires_grad=grad)
        ts = torch.zeros((b,), device="meta")
        ctx = torch.empty((b, 1, u["context_dim"]), device="meta", dtype=dt)
        ids = torch.zeros((b, 3), device="meta")
        with torch.set_grad_enabled(grad):
            v = R.unet_forward(unet_p, u, x, ts, ctx, ids)
            if grad:
                torch.autograd.grad(v, x, torch.empty_like(v))

    def decode(c: int):
        z = torch.empty((c, 4, lh, lw), device="meta", dtype=dt, requires_grad=True)
        with torch.enable_grad():
            frames = R.temporal_decode(vae_p, cfg["decoder"], z)
            torch.autograd.grad(frames, z, torch.empty_like(frames))

    with R.no_recompute():
        total = _count(lambda: unet(2, False)) + 2 * _count(lambda: unet(1, True))
        chunk = traffic["decode_chunk"]
        for c0 in range(0, t, chunk):
            total += _count(lambda: decode(min(chunk, t - c0)))
    return total
