#!/usr/bin/env python3
"""Device memory of the parts of one guided DDIM step at full ViewCrafter
width, on one NVIDIA GPU.

    python3 scripts/guided_step_memory.py [--chunks 1 5 9]

Random bf16 weights from a seed (the port's `diffusion/init.py`), 25
frames of 40x56 latents (320x448 frames), random conditioning of the
engine's shapes. Prints, in GB over the weights: the autograd graph that
the CFG pair holds after its forward under grad (one UNet application at
batch 2, and one branch at batch 1), the peak of its VJP, and the peak of
the guidance gradients through the VAE decode for each decode chunk; and
the ms of the forward under grad with its VJP at each batch (median of
REPS after one warm-up run, host clock with synchronize), which is what
the two exact designs of the pair's VJP cost: the pair again at batch 2,
or each branch again at batch 1. These numbers choose the guided step's
design (samplers/ddim_guidance.py).
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from guidedvd3dgs_tpu_torch.diffusion import synthesis  # noqa: E402
from guidedvd3dgs_tpu_torch.diffusion.init import init_diffusion_params  # noqa: E402
from guidedvd3dgs_tpu_torch.diffusion.model import Conditioning, LatentDiffusionConfig, apply_model  # noqa: E402
from guidedvd3dgs_tpu_torch.diffusion.samplers import ddim_guidance  # noqa: E402
from guidedvd3dgs_tpu_torch.guidance.loss_guidance import make_guidance_fn, resize_guidance  # noqa: E402

T, LH, LW = 25, 40, 56
REPS = 3


def gb(n: int) -> float:
    return n / 1e9


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--chunks", type=int, nargs="+", default=[1, 5, 9])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mcfg = LatentDiffusionConfig(compute_dtype="bfloat16")
    scfg = synthesis.SynthesisConfig()
    params = init_diffusion_params(mcfg, scfg, seed=1, device=dev, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    ctx = 77 + 16 * scfg.resampler_config.video_length

    def cond(b):
        return Conditioning(torch.randn((b, ctx, 1024), generator=gen, device=dev).to(torch.bfloat16),
                            torch.randn((b, T, LH, LW, 4), generator=gen, device=dev),
                            torch.full((b,), scfg.fs, dtype=torch.int64, device=dev))

    x = torch.randn((1, T, LH, LW, 4), generator=gen, device=dev)
    t = torch.full((1,), 500, dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    print(f"{torch.cuda.get_device_name(0)}; weights and inputs {gb(base):.2f} GB", flush=True)

    vjp_ms = {}
    for b in (2, 1):
        c = cond(b)
        cot = torch.randn((b, T, LH, LW, 4), generator=gen, device=dev)
        ms = []
        for _ in range(REPS + 1):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            xg = x.detach().requires_grad_()
            v = apply_model(params, mcfg, xg.expand(b, -1, -1, -1, -1), t.expand(b), c)
            torch.cuda.synchronize()
            held, fwd_peak = torch.cuda.memory_allocated() - base, torch.cuda.max_memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
            (gx,) = torch.autograd.grad(v, xg, cot)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            vjp_peak = torch.cuda.max_memory_allocated() - base
            del xg, v, gx
        vjp_ms[b] = statistics.median(ms[1:])
        print(f"UNet at batch {b} ({'the CFG pair' if b == 2 else 'one branch'}) under grad: graph held "
              f"{gb(held):.2f} GB (forward peak {gb(fwd_peak):.2f}); its VJP's peak {gb(vjp_peak):.2f} GB "
              f"(from the held graph); forward and VJP {vjp_ms[b]:.1f} ms (first {ms[0]:.1f})", flush=True)
        del c, cot
    print(f"the pair's VJP with its forward again: at batch 2 {vjp_ms[2]:.1f} ms; per branch 2 x "
          f"{vjp_ms[1]:.1f} = {2 * vjp_ms[1]:.1f} ms", flush=True)

    images = torch.rand((T, 3, 320, 448), generator=gen, device=dev)
    gfn = make_guidance_fn(resize_guidance(images, 320, 448, masks=torch.ones((T, 1, 320, 448), device=dev)))
    zs = torch.randn((T, LH, LW, 4), generator=gen, device=dev)
    for chunk in args.chunks:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ddim_guidance.per_frame_guidance_grads(params, mcfg, gfn, zs, 10,
                                               ddim_guidance.GuidedSampleConfig(decode_chunk=chunk))
        torch.cuda.synchronize()
        print(f"decode gradients, decode_chunk {chunk}: peak {gb(torch.cuda.max_memory_allocated() - base):.2f} GB",
              flush=True)


if __name__ == "__main__":
    main()
