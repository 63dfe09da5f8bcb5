"""Timed loop: the guided Euler EDM steps of a Stable Video Diffusion XT request.

Set-up makes the weights (benchmark/inputs/svd_weights.py, the diffusers
layout) and the request from the seed: the renders, guidance images, masks
and depths of a ViewCrafter request (inputs/vc_request.py), then the
augmentation noise of frame 0 and x_T. It builds the program's
`SVDEngine` on the weights as `diffusion/convert.py` loads them, takes the
conditioning the program builds (`synthesis.build_svd_conditioning`) and
the guidance function (`loss_guidance.make_guidance_fn` of the resized
guidance buffers), and runs one warm-up step. The window then drives the
program's guided step (`ddim_guidance.rule_step` with
`euler_edm.EulerEDMRule`) over the 25 Euler steps from x_T, each step
waited for, wrapping to a fresh request with the same inputs after the
last, until `seconds` have passed; `ddim_step_ms` is the window over the
steps it completed, as drivers/ddim_steps.py times DDIM steps.

`correct`: once the window has closed and the peak has been read, the
plain float32 reference (benchmark/reference/svd) recomputes the
conditioning from the same renders, weights and noise, and, for the
window's first step (from x_T) and one more step of the first request
drawn from the seed, the step from the program's input latent. Compared,
each as a relative L2 gap, worst over the sampled steps:

  cond      the image embedding and the conditioning latents
  pair_v    each branch's v prediction, against the reference's pair
  x_prev    the step's output against the part of the reference's output
            the model made: x_prev less the Euler update of a zero model
            output (D = c_skip x)
  guidance  the guidance term x_prev - (the unguided Euler update of the
            step's pair) against the reference's

As drivers/ddim_steps.py's guided cell, the reference follows the program
from its own pair: it takes the program's v predictions (judged by
`pair_v`) and works out from them D, the Euler update, the decode
gradients through the temporal decoder, the branches' VJPs and the
adaptive step. The control (`calibrate`) is the reference in bfloat16
with float8 linear and convolution operands in the program's place.
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import Dict, List, NamedTuple, Optional
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from harness import result, trace
from harness.compare import rel, rel_to
from inputs.svd_weights import make_weights
from inputs.vc_request import make_request


class Request(NamedTuple):
    renders: torch.Tensor  # (T, H, W, 3) in [0, 1]
    images: torch.Tensor  # (T, 3, Hg, Wg)
    masks: torch.Tensor  # (T, 1, Hg, Wg)
    depths: torch.Tensor
    aug: torch.Tensor  # (1, h_img, w_img, 3) frame 0's augmentation noise at the engine's size
    x_T: torch.Tensor  # (1, T, h, w, 4) standard normal


def _request(seed: int, traffic: dict, lat, dev) -> Request:
    vc = make_request(seed, dict(traffic, ddim_steps=1), lat, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    aug = torch.randn((1, traffic["height"], traffic["width"], 3), generator=gen, device=dev)
    x_T = torch.randn((1, traffic["frames"]) + tuple(lat) + (4,), generator=gen, device=dev)
    return Request(vc.renders, vc.images, vc.masks, vc.depths, aug, x_T)


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


class Program:
    """The program under test, set up for one request."""

    def __init__(self, cfg: dict, traffic: dict, weights, req: Request, device, fault: Optional[str] = None):
        from guidedvd3dgs_tpu_torch.diffusion import clip, convert, synthesis, vae
        from guidedvd3dgs_tpu_torch.diffusion.model import SVDConfig
        from guidedvd3dgs_tpu_torch.diffusion.samplers import ddim_guidance, euler_edm
        from guidedvd3dgs_tpu_torch.diffusion.unet_st import STUNetConfig
        from guidedvd3dgs_tpu_torch.guidance.loss_guidance import make_guidance_fn, resize_guidance
        from guidedvd3dgs_tpu_torch.train.guided import SVDEngine, resize_renders

        self.dg, self.fault = ddim_guidance, fault
        vis = {k: v for k, v in cfg["clip_vision"].items() if k != "projection_dim"}
        mcfg = SVDConfig(unet=STUNetConfig(**_tuples(cfg["unet"])), vae=vae.VAEConfig(**_tuples(cfg["vae"])),
                         decoder=vae.TemporalDecoderConfig(**_tuples(cfg["decoder"])),
                         vision=clip.VisionConfig(**vis), compute_dtype=cfg["compute_dtype"])
        ecfg = euler_edm.EulerConfig(num_steps=traffic["steps"], sigma_min=traffic["sigma_min"],
                                     sigma_max=traffic["sigma_max"], rho=traffic["rho"], min_cfg=traffic["min_cfg"],
                                     max_cfg=traffic["max_cfg"])
        scfg = synthesis.SVDSynthesisConfig(euler=ecfg, fps=traffic["fps"],
                                            motion_bucket_id=traffic["motion_bucket_id"],
                                            noise_aug_strength=traffic["noise_aug_strength"],
                                            decode_chunk=traffic["decode_chunk"])
        gcfg = ddim_guidance.GuidedSampleConfig(rho_scale=traffic["rho_scale"], recur_steps=traffic["recur_steps"],
                                                decode_chunk=traffic["decode_chunk"])
        h, w, t = traffic["height"], traffic["width"], traffic["frames"]
        params = convert.convert_svd_state_dict(weights, device, getattr(torch, cfg["compute_dtype"]))
        self.engine = SVDEngine(params, mcfg, scfg, guided_cfg=gcfg, video_length=t, height=h, width=w,
                                w_recon=traffic["w_recon"], recon_loss=traffic["recon_loss"])
        self.params, self.mcfg = params, mcfg
        with torch.no_grad():
            video = resize_renders(req.renders, h, w) * 2.0 - 1.0
            self.cond, self.uncond = synthesis.build_svd_conditioning(params, mcfg, scfg, video, aug_noise=req.aug)
        bufs = resize_guidance(req.images, h, w, masks=req.masks, depths=req.depths)
        self.guidance_fn = make_guidance_fn(bufs, w_recon=traffic["w_recon"], recon_loss=traffic["recon_loss"])
        edm = ecfg.params(device)
        self.rule = euler_edm.EulerEDMRule(edm, euler_edm.frame_scales(ecfg, t, device), gcfg)
        self.x_T = req.x_T * euler_edm.init_noise_sigma(edm)
        self.num_steps = edm.num_steps
        self.capture: Optional[List] = None  # (v_cond, v_uncond) of each step while a list

    @contextlib.contextmanager
    def hooks(self):
        """Keep each step's pair outputs while `capture` is a list, and put
        in the planted fault, if any."""
        real, real_update = self.dg.pair_forward, self.dg.guidance_update

        def pair_forward(*args, **kwargs):
            vc, vu = real(*args, **kwargs)
            if self.fault == "altered":
                vc = vc.clone()
                vc[:, 0] = -vc[:, 0]
            if self.capture is not None:
                self.capture.append((vc, vu))
            return vc, vu

        def guidance_update(x_prev, gx, correction, scfg, w):
            # the planted fault "guidance": the adaptive step half as long again
            return real_update(x_prev, gx, correction, scfg, w * (1.5 if self.fault == "guidance" else 1.0))

        with mock.patch.object(self.dg, "pair_forward", pair_forward), \
                mock.patch.object(self.dg, "guidance_update", guidance_update):
            yield

    def step(self, x: torch.Tensor, k: int) -> torch.Tensor:
        x_prev, _, _ = self.dg.rule_step(self.params, self.mcfg, self.rule, self.cond, self.uncond, self.guidance_fn,
                                         1.0, x, k, None)
        if self.fault == "unchanged":
            return x
        if self.fault == "half_frames":  # the second half of the frames left as they were
            x_prev = x_prev.clone()
            x_prev[:, x.shape[1] // 2:] = x[:, x.shape[1] // 2:]
        return x_prev


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx) -> dict:
    spec, dev, seed = ctx.spec, ctx.device, ctx.seed
    cfg, traffic = spec.config, spec.traffic
    f = 2 ** (len(cfg["vae"]["ch_mult"]) - 1)
    lat = (traffic["height"] // f, traffic["width"] // f)
    weights = make_weights(cfg, seed, dev, getattr(torch, cfg["compute_dtype"]))
    req = _request(seed + 1, traffic, lat, dev)
    prog = Program(cfg, traffic, weights, req, dev, fault=ctx.fault)
    s = prog.num_steps
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    with prog.hooks():
        prog.step(prog.x_T, 0)  # warm-up: every shape of the window
        _sync(dev)
        setup_s = time.perf_counter() - ctx.t0
        inputs, outputs, prog.capture = [], [], []
        pairs = prog.capture
        st = dict(x=prog.x_T, k=0, n=0)

        def advance():
            x, k = st["x"], st["k"]
            first = st["n"] < s  # a step of the first request: kept for the check
            if first:
                inputs.append(x)
            else:
                prog.capture = None
            x_prev = prog.step(x, k)
            bad.add_((~torch.isfinite(x_prev).all()).long())
            _sync(dev)
            st["n"] += 1
            if first:
                outputs.append(x_prev)
            st["k"], st["x"] = (k + 1, x_prev) if k + 1 < s else (0, prog.x_T)

        step_s = None
        if ctx.trace:
            t_stretch = time.perf_counter()
            for _ in range(ctx.max_steps):
                advance()
            step_s = (time.perf_counter() - t_stretch) / ctx.max_steps
        n0 = st["n"]
        prof = trace.profiler() if ctx.trace else contextlib.nullcontext()
        spans = trace.spans(trace.metric_spans(spec.per_layer)) if ctx.trace else contextlib.nullcontext()
        t_start = time.perf_counter()
        with spans, prof:
            win = torch.profiler.record_function(trace.WINDOW) if ctx.trace else contextlib.nullcontext()
            with win:
                while True:
                    advance()
                    if ctx.max_steps:
                        if st["n"] - n0 >= ctx.max_steps:
                            break
                    elif time.perf_counter() - t_start >= ctx.seconds:
                        break
            t_stop = time.perf_counter()
        elapsed = time.perf_counter() - t_start
        n = st["n"] - n0
        if ctx.trace:
            trace.note("profiler stop", time.perf_counter() - t_stop)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = int(bad)
    metrics, breakdown, busy = {}, None, None
    if ctx.trace:
        t_reduce = time.perf_counter()
        view = trace.reduce(prof, n, info=dict(cfg=cfg, traffic=traffic, flops=lambda: _step_flops(cfg, traffic)),
                            step_s=step_s)
        for m in spec.per_layer:
            v = m.reader.read(view)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
        breakdown, busy = view.breakdown(), (view.busy_s, view.window_s)
        trace.note("trace reduced and read", time.perf_counter() - t_reduce)
    else:
        for m in spec.end_to_end:
            v = {"ddim_step_ms": elapsed / n * 1e3, "peak_gb": peak / 1e9, "setup_s": setup_s}[m.name]
            metrics[m.name] = {"value": v, "unit": m.unit}
    cond_prog = (prog.cond.context, prog.cond.concat)
    sample = _sample(seed, len(outputs))
    progd = [(k, inputs[k], outputs[k], pairs[k]) for k in sample]
    attempted = st["n"]
    del prog, inputs, outputs, pairs, st
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = check(cfg, traffic, weights, req, cond_prog, progd, dev, spec.limits)
    t_ref = time.perf_counter() - t_ref
    if ctx.calibrate:
        t_low = time.perf_counter()
        low = control_numbers(cfg, traffic, weights, req, progd, dev) if ctx.control and not ctx.fault else None
        return dict(program={k: c.value for k, c in checks.items()}, control=low, look=None, steps=attempted,
                    sampled=sample, reference_s=t_ref, control_s=time.perf_counter() - t_low, setup_s=setup_s,
                    step_ms=elapsed / n * 1e3, peak_gb=peak / 1e9)
    device = result.device_info(dev, 1, peak, *(busy or (None, None)))
    return result.line(checks, attempted, failed, metrics, device, breakdown,
                       extra=dict(reference_s=t_ref, sampled_steps=sample))


def _sample(seed: int, m: int) -> List[int]:
    """The window's first step, and one more of the first request's drawn
    from the seed."""
    if m <= 1:
        return [0][:m]
    return [0, int(np.random.default_rng(seed + 2).integers(1, m))]


def _step_flops(cfg, traffic) -> int:
    from counts.flops_svd import step_flops

    return step_flops(cfg, traffic)


def _cl(x: torch.Tensor) -> torch.Tensor:
    """The reference's (B, T, C, h, w) as the program's (B, T, h, w, C)."""
    return x.movedim(2, -1)


class Reference:
    """The plain reference in float32 (or, as the control, in the
    configuration's type under `lowered`) over the same weights and request."""

    def __init__(self, cfg, traffic, weights, req: Request, device, dtype=torch.float32):
        from reference.svd import svd_xt as R

        self.R, self.cfg, self.traffic, self.dtype = R, cfg, traffic, dtype
        self.params = R.split(weights)
        h, w = traffic["height"], traffic["width"]
        video = F.interpolate(req.renders.permute(0, 3, 1, 2), size=(h, w), mode="bilinear", align_corners=False,
                              antialias=True) * 2.0 - 1.0
        self.cond, self.uncond = R.conditioning(self.params, cfg, traffic, video, req.aug.permute(0, 3, 1, 2))
        images = torch.clamp(F.interpolate(req.images, size=(h, w), mode="bilinear", align_corners=False,
                                           antialias=True), 0.0, 1.0)
        masks = F.interpolate(req.masks, size=(h, w), mode="nearest-exact")
        self.loss_fn = R.guidance_loss(images, masks, traffic["w_recon"])
        self.edm = R.karras(traffic["steps"], traffic["sigma_min"], traffic["sigma_max"], traffic["rho"], device)
        self.scales = R.frame_scales(traffic["min_cfg"], traffic["max_cfg"], traffic["frames"], device)

    def pair(self, x, k):
        """(v_cond, v_uncond) from x (1, T, 4, h, w)."""
        return self.R.pair(self.params, self.cfg, self.dtype, x, k, self.edm, self.cond, self.uncond)

    def guided(self, x, k, vc, vu):
        return self.R.guided_step(self.params, self.cfg, self.dtype, self.traffic, x, k, self.edm, self.scales,
                                  self.cond, self.uncond, self.loss_fn, vc, vu)

    def unguided(self, x, k, vc, vu):
        return self.R.euler(x, k, self.edm, self.R.denoised(x, k, self.edm, self.scales, vc, vu))

    def unmodelled(self, x, k):
        return self.R.euler(x, k, self.edm, self.edm.c_skip[k] * x)


def compare(ref: Reference, cond_prog, progd) -> Dict[str, float]:
    """The numbers that decide `correct`, from the program's conditioning
    (context, concat) and its sampled steps [(k, x_t, x_prev, (v_cond,
    v_uncond))], all channels-last."""
    nums = {"cond": max(rel(cond_prog[0], ref.cond.context), rel(cond_prog[1], _cl(ref.cond.concat)))}
    pv = xp = gd = 0.0
    for k, x, x_prev, (vc_p, vu_p) in progd:
        xr = x.movedim(-1, 2).float()
        vc, vu = ref.pair(xr, k)
        pv = max(pv, rel(vc_p, _cl(vc)), rel(vu_p, _cl(vu)))
        vcp, vup = vc_p.movedim(-1, 2).float(), vu_p.movedim(-1, 2).float()
        x_ref = ref.guided(xr, k, vcp, vup)
        x_zero = ref.unmodelled(xr, k)
        xp = max(xp, rel_to(x_prev, _cl(x_ref), _cl(x_ref - x_zero)))
        u_p = ref.unguided(xr, k, vcp, vup)
        gd = max(gd, rel(x_prev - _cl(u_p), _cl(x_ref - u_p)))
        del vc, vu, x_ref
    nums.update(pair_v=pv, x_prev=xp, guidance=gd)
    return {k: (math.nan if v != v else v) for k, v in nums.items()}


def check(cfg, traffic, weights, req, cond_prog, progd, dev, limits) -> Dict[str, result.Check]:
    """The numbers against the cell's limits (its workload file's `limits`)."""
    nums = compare(Reference(cfg, traffic, weights, req, dev), cond_prog, progd)
    return {k: result.Check(v, limits[k]) for k, v in nums.items()}


def control_numbers(cfg, traffic, weights, req, progd, dev) -> Dict[str, float]:
    """The control: the reference one precision below the configuration's
    (bf16: float8_e4m3fn linear and convolution operands, bf16 elsewhere;
    float32: bf16) in the program's place, on the sampled steps' inputs,
    from its own pair, compared as the program is."""
    from reference.svd import svd_xt as R

    ref = Reference(cfg, traffic, weights, req, dev)
    low_dtype = {"bfloat16": torch.float8_e4m3fn, "float32": torch.bfloat16}[cfg["compute_dtype"]]
    with R.lowered(low_dtype):
        low = Reference(cfg, traffic, weights, req, dev, dtype=getattr(torch, cfg["compute_dtype"]))
        lowd = []
        for k, x, _, _ in progd:
            xr = x.movedim(-1, 2).float()
            vc, vu = low.pair(xr, k)
            lowd.append((k, x, _cl(low.guided(xr, k, vc, vu)), (_cl(vc), _cl(vu))))
    return compare(ref, (low.cond.context, _cl(low.cond.concat)), lowd)
