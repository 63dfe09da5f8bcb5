#!/usr/bin/env python3
"""Where the float32 guided step through L1's kernels parts from its plain
chain, and how far a wrong backward moves it, on one NVIDIA GPU.

    python3 scripts/guided_step_parity.py

The step of `chip_smoke.py` phase 8c, on 8c's inputs (ViewCrafter at full
spatial width, random weights from chip_smoke's seed, STEP32_FRAMES
frames, TF32 off), run with L1 swapped piece by piece:

- kernels          L1's forward (with its log-sum-exp) and both backward
                   kernels, as 8c runs it; and the same run again
- kernel fwd, plain bwd / plain fwd, kernel bwd: the gap split
- fault: dQ zeroed          the dQ kernel's output replaced by zeros
- fault: Delta zeroed       the row sums dO . O taken as zero
- fault: bf16 backward      the backward kernels run on the inputs rounded
                            to bfloat16, their gradients cast back

For each: the whole step's x_prev and pred_x0 against the plain chain's
(`plain=True`; max abs difference over max |x_prev|, max |pred_x0|) and
rho; and 8c's dL/dx from one forward's pred_x0 and v (the decode
gradients and the pair's VJP alone, cuDNN deterministic) against that of
L1's kernel forward with its plain backward (`chip_smoke.plain_backward`),
over max |dL/dx| and in L2 norm over |dL/dx|.
chip_smoke's GUIDED_STEP_TOL and GUIDED_GRAD_TOL must lie above the
kernel rows and below the fault rows.

Then 8c's bf16 check at each DDIM index of the schedule (three
readings): the f32 step's dL/dx with L1's backward in bf16
(`chip_smoke.bf16_backward`: the bf16 kernels) against the plain backward
of the same bf16 inputs, with the kernels (twice) and with dQ or Delta
zeroed; chip_smoke's GUIDED_GRAD_TOL_BF16 must lie above the kernel
readings and below the fault readings. Beside it the same comparison for
a whole bf16 step (the request's own type), where the step's own bf16
rounding hides the faults.
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path
from unittest import mock

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from guidedvd3dgs_tpu_torch.diffusion import synthesis  # noqa: E402
from guidedvd3dgs_tpu_torch.diffusion.model import LatentDiffusionConfig  # noqa: E402
from guidedvd3dgs_tpu_torch.guidance.loss_guidance import resize_guidance  # noqa: E402
from guidedvd3dgs_tpu_torch.ops import flash_attention as fa  # noqa: E402
from guidedvd3dgs_tpu_torch.train.guided import ViewCrafterEngine  # noqa: E402


def plain_forward(q, k, v, scale, with_lse):
    return fa.flash_attention_plain_lse(q, k, v, scale)


VARIANTS = {
    "kernels": (),
    "kernels again": (),
    "kernel fwd, plain bwd": (("flash_attention_bwd", fa.flash_attention_bwd_plain),),
    "plain fwd, kernel bwd": (("_launch_fwd", plain_forward),),
    "fault: dQ zeroed": (("bwd_dq_kernel", lambda q, *rest: torch.zeros_like(q)),),
    "fault: Delta zeroed": (("attention_delta", lambda o, do: torch.zeros(o.shape[:-1], device=o.device)),),
    "fault: bf16 backward": (("flash_attention_bwd", cs.bf16_backward()),),
}


def main() -> None:
    dev = cs.phase_device()
    cs.phase_build()
    mcfg = LatentDiffusionConfig(compute_dtype="bfloat16")
    scfg = synthesis.SynthesisConfig(ddim_steps=cs.GUIDED_STEPS)
    params, _ = cs.gen_params(dev)
    engine = ViewCrafterEngine(params, mcfg, scfg, video_length=cs.GEN_FRAMES, height=cs.GEN_H, width=cs.GEN_W)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 10)  # as phase 8b
    renders, images, masks, _ = cs.guided_inputs(dev, gen)
    bufs = resize_guidance(images, cs.GEN_H, cs.GEN_W, masks=masks)
    sched, pr, cond, uncond, x, step_noise, index = cs.guided_step_inputs(dev, params, mcfg, scfg, engine,
                                                                          renders)
    step, grad = cs.small_guided_step(params, mcfg, engine.guided_cfg, sched, pr, cond, uncond, bufs, x,
                                      step_noise, index)

    want_x, want_p0, want_rho = step(plain=True)
    with cs.deterministic_cudnn(), cs.plain_backward():
        want_g = grad()
    sx, sp, sg = (a.abs().max().item() for a in (want_x, want_p0, want_g))
    out = {"max_abs_x_prev": sx, "max_abs_pred_x0": sp, "max_abs_dL_dx": sg, "rho_plain": float(want_rho),
           "step_tol": cs.GUIDED_STEP_TOL, "grad_tol": cs.GUIDED_GRAD_TOL}
    for name, patches in VARIANTS.items():
        with contextlib.ExitStack() as stack:
            for attr, fn in patches:
                stack.enter_context(mock.patch.object(fa, attr, fn))
            got_x, got_p0, rho = step()
            with cs.deterministic_cudnn():
                got_g = grad()
            torch.cuda.synchronize()
        ex, ep, eg = ((a - b).abs().max().item() for a, b in ((got_x, want_x), (got_p0, want_p0), (got_g, want_g)))
        l2 = ((got_g - want_g).norm() / want_g.norm()).item()
        out[name] = {"x_prev": ex / sx, "pred_x0": ep / sp, "dL_dx": eg / sg, "dL_dx_l2": l2, "x_prev_abs": ex,
                     "rho": float(rho)}
        print(f"{name}: x_prev max abs diff from the plain chain {ex:.4g} = {ex / sx:.4g} of max |x_prev| "
              f"{sx:.4f}; pred_x0 {ep / sp:.4g} of max |pred_x0|; rho {float(rho):.7g} (plain "
              f"{float(want_rho):.7g}) | dL/dx against the kernel forward's with the plain backward "
              f"{eg / sg:.4g} of max |dL/dx| {sg:.4g}, in L2 norm {l2:.4g} of |dL/dx|", flush=True)

    out["grad_tol_bf16"] = cs.GUIDED_GRAD_TOL_BF16
    for idx in range(scfg.ddim_steps):
        for label, dtype, reference in (
                ("f32 step, L1 backward in bf16", cs.F32,
                 mock.patch.object(fa, "flash_attention_bwd", cs.bf16_backward(plain=True))),
                ("bf16 step", cs.BF16, cs.plain_backward())):
            grad_i = cs.small_guided_step(params, mcfg, engine.guided_cfg, sched, pr, cond, uncond, bufs, x,
                                          step_noise, idx, dtype=dtype)[1]
            with cs.deterministic_cudnn(), reference:
                want_i = grad_i().float()
            for name in ("kernels", "kernels again", "fault: dQ zeroed", "fault: Delta zeroed"):
                with contextlib.ExitStack() as stack:
                    if dtype == cs.F32:
                        stack.enter_context(mock.patch.object(fa, "flash_attention_bwd", cs.bf16_backward()))
                    for attr, fn in VARIANTS[name]:
                        stack.enter_context(mock.patch.object(fa, attr, fn))
                    with cs.deterministic_cudnn():
                        got_i = grad_i().float()
                l2 = ((got_i - want_i).norm() / want_i.norm()).item()
                out[f"{label}, index {idx}: {name}"] = {"dL_dx_l2": l2}
                print(f"{label}, index {idx}, {name}: dL/dx against the plain backward's {l2:.4g} of |dL/dx| "
                      f"{want_i.norm().item():.4g} (L2 norms)", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
