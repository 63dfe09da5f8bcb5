#!/usr/bin/env python3
"""Where chip_smoke's bf16 forward check (phase 7c) sits, and how far a
wrong forward moves it, on one NVIDIA GPU.

    python3 scripts/ddim_step_parity.py

The step of `chip_smoke.py` phase 7c, on 7c's inputs (ViewCrafter at full
width, random weights from chip_smoke's seed, TF32 off): one float32 DDIM
step with L1's forward run in bfloat16 (`chip_smoke.bf16_forward`), held
against the same step with the plain version of the same bf16 inputs, in
L2 norm over |latent|, at each DDIM index 0, steps // 2, steps - 1 of the
request's schedule (three readings), with L1's forward:

- kernels                     the bf16 kernels, as 7c runs them; and again
- fault: one key tile skipped  the plain version without keys [64, 128),
                              one tile of the D <= 128 kernel's ring
- fault: P unrounded          the plain version with the softmax weights
                              left float32 for the product with v

Each is read on x_prev (what 7c holds) and on the step's CFG model
output, which the attentions reach without the x_t and noise terms of
x_prev. chip_smoke's STEP_TOL_BF16 must lie above the kernel readings and
below the key-tile fault. Beside it 7c's float32 check (L1's f32 kernel against
its plain version, max abs) at each index, and the same bf16 comparison
for the VAE decode of the step's input latents in float32 (25 frames; its
mid-block attention is L1 at D = 512), with one D = 512 key tile (keys
[32, 64)) skipped and with P unrounded. The last line is a JSON object of
every reading.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path
from unittest import mock

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from guidedvd3dgs_tpu_torch.diffusion import synthesis  # noqa: E402
from guidedvd3dgs_tpu_torch.diffusion.samplers import ddim  # noqa: E402
from guidedvd3dgs_tpu_torch.diffusion.model import decode_video_frames  # noqa: E402
from guidedvd3dgs_tpu_torch.ops import flash_attention as fa  # noqa: E402
from guidedvd3dgs_tpu_torch.train.guided import ViewCrafterEngine  # noqa: E402


def skip_keys(lo: int, hi: int):
    """The plain version of bf16 inputs without keys [lo, hi)."""
    def fault(q, k, v, scale):
        keep = torch.ones(k.shape[2], dtype=torch.bool, device=k.device)
        keep[lo:hi] = False
        return fa.flash_attention_plain(q, k[:, :, keep], v[:, :, keep], scale)
    return fault


def unrounded_p(q, k, v, scale):
    """The plain version with the softmax weights kept float32."""
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(sim, dim=-1), v.float()).to(v.dtype)


def variants(tile: int) -> dict:
    return {"kernels": cs.bf16_forward(), "kernels again": cs.bf16_forward(),
            "fault: one key tile skipped": cs.bf16_forward(fault=skip_keys(tile, 2 * tile)),
            "fault: P unrounded": cs.bf16_forward(fault=unrounded_p)}


def rel_l2(got, want) -> float:
    return ((got - want).norm() / want.norm()).item()


def step_and_output(step, index: int, fwd):
    """(x_prev, the CFG model output) of step(index) with `fwd` as L1's
    forward."""
    outs = []
    with mock.patch.object(fa, "_launch_fwd", fwd), cs.timed(ddim, "cfg_model_output", [], outs):
        x_prev = step(index)
    return x_prev, outs[-1][0]


def main() -> None:
    dev = cs.phase_device()
    cs.phase_build()
    mcfg = cs.LatentDiffusionConfig(compute_dtype="bfloat16")
    scfg = synthesis.SynthesisConfig(ddim_steps=cs.GEN_STEPS)
    params, _ = cs.gen_params(dev)
    engine = ViewCrafterEngine(params, mcfg, scfg, video_length=cs.GEN_FRAMES, height=cs.GEN_H, width=cs.GEN_W)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 8)  # as phase 7b
    renders = torch.rand((cs.GEN_FRAMES, cs.GEN_H, cs.GEN_W, 3), generator=gen, device=dev)
    cond, uncond, x, noise = cs.ddim_step_inputs(dev, params, mcfg, scfg, engine, renders)
    step = cs.f32_step(params, mcfg, scfg, cond, uncond, x, noise)

    out = {"step_tol": cs.STEP_TOL, "step_tol_bf16": cs.STEP_TOL_BF16}
    for index in (0, scfg.ddim_steps // 2, scfg.ddim_steps - 1):
        f32_err = (step(index) - step(index, plain=True)).abs().max().item()
        want, want_mo = step_and_output(step, index, cs.bf16_forward(plain=True))
        out[f"index {index}: f32 kernel vs plain, max abs"] = f32_err
        print(f"index {index}: f32 step, L1's kernel vs its plain version: max abs {f32_err:.4g} "
              f"(tol {cs.STEP_TOL})", flush=True)
        for name, fwd in variants(64).items():
            got, got_mo = step_and_output(step, index, fwd)
            out[f"index {index}: {name}"] = rel_l2(got, want)
            out[f"index {index}: {name}, model output"] = rel_l2(got_mo, want_mo)
            print(f"index {index}, L1's forward in bf16, {name}: against the plain version's "
                  f"{rel_l2(got, want):.4g} of |latent| {want.norm().item():.4g}; model output "
                  f"{rel_l2(got_mo, want_mo):.4g} of {want_mo.norm().item():.4g} (L2 norms)", flush=True)

    # the VAE decode of the step's latents in float32, L1 at D = 512
    mcfg32 = dataclasses.replace(mcfg, compute_dtype="float32")
    params32 = params._replace(vae={k: v.float() for k, v in params.vae.items()})

    def decode():
        with torch.no_grad():
            return decode_video_frames(params32, mcfg32, x[0])

    with mock.patch.object(fa, "_launch_fwd", cs.bf16_forward(plain=True)):
        want = decode()
    for name, fwd in variants(32).items():
        with mock.patch.object(fa, "_launch_fwd", fwd):
            got = decode()
        out[f"decode: {name}"] = rel_l2(got, want)
        print(f"decode (f32, {cs.GEN_FRAMES} frames), L1's forward in bf16, {name}: against the plain "
              f"version's {rel_l2(got, want):.4g} of |frames| {want.norm().item():.4g} (L2 norms)", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
