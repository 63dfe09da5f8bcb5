"""Timed loop: the DDIM steps of a ViewCrafter request, guided or plain.

Set-up makes the weights and the request from the seed (benchmark/inputs),
builds the program's `ViewCrafterEngine`, takes the conditioning the
program builds (`synthesis.build_conditioning`, with the engine's text
embeddings and the benchmark's encode noise) and the guidance function
(`loss_guidance.make_guidance_fn` of the resized guidance buffers), and
runs one warm-up step. The window then drives the program's step over the
schedule from its first index (guided: `ddim_guidance.guided_step`;
plain: `ddim.cfg_model_output` and `ddim.ddim_step`), each step waited
for, wrapping to a fresh request with the same inputs after the last
index, until `seconds` have passed. `ddim_step_ms` is the window over the
steps it completed.

`correct`: once the window has closed and the peak has been read, the
plain float32 reference (benchmark/reference/vc) recomputes the
conditioning from the same renders, weights and noise, and, for the
window's first step (from x_T) and one more step of the first request
drawn from the seed, the step from the program's input latent x_t.
Compared:

  cond      the conditioning (cond and uncond contexts, the concat latents)
  pair_v    each branch's v prediction, the reference's pair from x_t
  x_prev    the step's output, against the part of the reference's output
            that the model made: x_prev less the update of the same x_t
            and noise with a zero model output (the update is linear in
            the model output, so this reads the model output's relative
            gap at every DDIM index alike)
  guidance  guided: the guidance term x_prev - (the unguided update of the
            step's pair), against the reference's term

each as a relative L2 gap, worst over the sampled steps. Guided, the
reference follows the program from its own pair: it takes the program's
v predictions (judged by `pair_v`) and works out from them the CFG
output, the DDIM update, the decode gradients, the branches' VJPs and the
adaptive step, which `x_prev` and `guidance` then judge. From the
reference's own pair the guidance term would part by 0.12-0.22 in bf16
on every seed: the CFG difference v_cond - v_uncond, which sets the
adaptive step's size and, times 7.5, pred_x0, parts several times as far
as each branch does (PERF.md).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import time
from typing import Dict, List, Optional
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from harness import result, trace
from harness.compare import rel, rel_to
from inputs.vc_request import make_request
from inputs.vc_weights import make_weights


def ref_modules():
    from reference.vc import (clip, conditioning, ddim, ddim_guidance, loss_guidance, model, nnops,
                              resampler, schedules, unet3d, vae)
    return dict(clip=clip, conditioning=conditioning, ddim=ddim, dg=ddim_guidance, lg=loss_guidance,
                model=model, nnops=nnops, resampler=resampler, schedules=schedules, unet3d=unet3d, vae=vae)


def ref_configs(cfg: dict, compute_dtype: str):
    """The reference's (unet, vae, resampler, text, vision) configs and its
    LatentDiffusionConfig in `compute_dtype`."""
    R = ref_modules()
    cfgs = (R["unet3d"].UNetConfig(**_tuples(cfg["unet"])), R["vae"].VAEConfig(**_tuples(cfg["vae"])),
            R["resampler"].ResamplerConfig(**cfg["resampler"]), R["clip"].TextConfig(**cfg["clip_text"]),
            R["clip"].VisionConfig(**cfg["clip_vision"]))
    mcfg = R["model"].LatentDiffusionConfig(unet=cfgs[0], vae=cfgs[1], compute_dtype=compute_dtype,
                                            **cfg["schedule"])
    return cfgs, mcfg


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


class Program:
    """The program under test, set up for one request."""

    def __init__(self, cfg: dict, traffic: dict, weights, req, device, fault: Optional[str] = None):
        from guidedvd3dgs_tpu_torch.diffusion import clip, resampler, schedules, synthesis, unet3d, vae
        from guidedvd3dgs_tpu_torch.diffusion.model import LatentDiffusionConfig, apply_model
        from guidedvd3dgs_tpu_torch.diffusion.samplers import ddim, ddim_guidance
        from guidedvd3dgs_tpu_torch.guidance.loss_guidance import make_guidance_fn, resize_guidance
        from guidedvd3dgs_tpu_torch.train.guided import ViewCrafterEngine, resize_renders

        self.ddim, self.dg, self.apply_model = ddim, ddim_guidance, apply_model
        self.traffic, self.fault = traffic, fault
        self.guided = bool(traffic["guided"])
        mcfg = LatentDiffusionConfig(unet=unet3d.UNetConfig(**_tuples(cfg["unet"])),
                                     vae=vae.VAEConfig(**_tuples(cfg["vae"])),
                                     compute_dtype=cfg["compute_dtype"], **cfg["schedule"])
        scfg = synthesis.SynthesisConfig(
            ddim_steps=traffic["ddim_steps"], ddim_eta=traffic["eta"], cfg_scale=traffic["cfg_scale"],
            guidance_rescale=traffic["guidance_rescale"], timestep_spacing=traffic["timestep_spacing"],
            fs=traffic["fs"], text_config=clip.TextConfig(**cfg["clip_text"]),
            vision_config=clip.VisionConfig(**cfg["clip_vision"]),
            resampler_config=resampler.ResamplerConfig(**cfg["resampler"]))
        gcfg = ddim_guidance.GuidedSampleConfig(decode_chunk=traffic["decode_chunk"])
        h, w, t = traffic["height"], traffic["width"], traffic["frames"]
        self.engine = ViewCrafterEngine(weights, mcfg, scfg, guided_cfg=gcfg, video_length=t, height=h,
                                        width=w, w_recon=traffic["w_recon"], recon_loss=traffic["recon_loss"])
        self.params, self.mcfg, self.scfg = self.engine.params, mcfg, scfg
        with torch.no_grad():
            video = resize_renders(req.renders, h, w) * 2.0 - 1.0
            self.cond, self.uncond, _ = synthesis.build_conditioning(
                self.params, mcfg, scfg, video, eps=req.eps, text_pair=self.engine.text_pair)
        self.gcfg = dataclasses.replace(gcfg, cfg_scale=scfg.cfg_scale, guidance_rescale=scfg.guidance_rescale)
        if self.guided:
            bufs = resize_guidance(req.images, h, w, masks=req.masks, depths=req.depths)
            self.guidance_fn = make_guidance_fn(bufs, w_recon=traffic["w_recon"], recon_loss=traffic["recon_loss"])
        self.sched = mcfg.schedule(device)
        self.pr = schedules.make_ddim_params(self.sched, scfg.ddim_steps, eta=scfg.ddim_eta,
                                             method=scfg.timestep_spacing)
        self.capture: Optional[List] = None  # (v_cond, v_uncond) of each step while a list

    @contextlib.contextmanager
    def hooks(self):
        """Keep each step's pair outputs while `capture` is a list, and put
        in the planted fault, if any."""
        real, real_update = self.dg.pair_forward, self.dg.guidance_update

        def pair_forward(*args, **kwargs):
            vc, vu = real(*args, **kwargs)
            if self.fault == "altered":
                vc = _altered(vc)
            if self.capture is not None:
                self.capture.append((vc, vu))
            return vc, vu

        def guidance_update(x_prev, gx, correction, scfg, w):
            # the planted fault "guidance": the adaptive step half as long again
            return real_update(x_prev, gx, correction, scfg, w * (1.5 if self.fault == "guidance" else 1.0))

        with mock.patch.object(self.dg, "pair_forward", pair_forward), \
                mock.patch.object(self.dg, "guidance_update", guidance_update):
            yield

    def step(self, x: torch.Tensor, k: int, noise: torch.Tensor) -> torch.Tensor:
        """The program's step at schedule position k (DDIM index S - 1 - k)."""
        index = self.pr.num_steps - 1 - k
        if self.guided:
            x_prev, _, _ = self.dg.guided_step(self.params, self.mcfg, self.sched, self.pr, self.cond,
                                               self.uncond, self.gcfg, self.guidance_fn, 1.0, x, index, noise)
            return x if self.fault == "unchanged" else x_prev
        t = self.pr.timesteps[index].expand(x.shape[0])
        with torch.no_grad():
            vs = []

            def ap(c):
                def f(x_, t_):
                    v = self.apply_model(self.params, self.mcfg, x_, t_, c)
                    if self.fault == "altered" and c is self.cond:
                        v = _altered(v)
                    vs.append(v)
                    return v
                return f

            mo, _ = self.ddim.cfg_model_output(ap(self.cond), ap(self.uncond), x, t, self.scfg.cfg_scale,
                                               self.scfg.guidance_rescale)
            out = self.ddim.ddim_step(self.sched, self.pr, index, x, mo, noise)
        if self.capture is not None:
            self.capture.append(tuple(vs))
        return x if self.fault == "unchanged" else out.x_prev


def _altered(v: torch.Tensor) -> torch.Tensor:
    """The planted fault "altered": the cond branch's v prediction of the
    first frame negated where it is produced."""
    v = v.clone()
    v[:, 0] = -v[:, 0]
    return v


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx) -> dict:
    spec, dev, seed = ctx.spec, ctx.device, ctx.seed
    cfg, traffic = spec.config, spec.traffic
    f = 2 ** (len(cfg["vae"]["ch_mult"]) - 1)
    lat = (traffic["height"] // f, traffic["width"] // f)
    weights = make_weights(ref_configs(cfg, "float32")[0], seed, dev, getattr(torch, cfg["compute_dtype"]))
    req = make_request(seed + 1, traffic, lat, dev)
    prog = Program(cfg, traffic, weights, req, dev, fault=ctx.fault)
    s = prog.pr.num_steps
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    with prog.hooks():
        # warm-up: the first step of the request, every shape of the window
        prog.step(req.x_T, 0, req.noise[0])
        _sync(dev)
        setup_s = time.perf_counter() - ctx.t0
        inputs, outputs, prog.capture = [], [], []
        prog.pairs = prog.capture
        st = dict(x=req.x_T, k=0, n=0)

        def advance():
            x, k = st["x"], st["k"]
            first = st["n"] < s  # a step of the first request: kept for the check
            if first:
                inputs.append(x)
            else:
                prog.capture = None
            x_prev = prog.step(x, k, req.noise[k])
            bad.add_((~torch.isfinite(x_prev).all()).long())
            _sync(dev)
            st["n"] += 1
            if first:
                outputs.append(x_prev)
            st["k"], st["x"] = (k + 1, x_prev) if k + 1 < s else (0, req.x_T)

        step_s = None
        if ctx.trace:
            # an untraced stretch of as many steps as are traced, before the
            # profiler starts: the time a step without its host cost
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
        n = st["n"] - n0  # the steps traced, or the window's
        if ctx.trace:
            trace.note("profiler stop", time.perf_counter() - t_stop)
    pairs = prog.pairs
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
    cond_prog = (prog.cond.context, prog.uncond.context, prog.cond.concat)
    # the program's state goes before the reference runs
    sample = _sample(seed, len(outputs))
    progd = [(k, inputs[k], outputs[k], pairs[k]) for k in sample]
    attempted = st["n"]
    del prog, inputs, outputs, pairs, st
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    look = {} if ctx.look else None
    checks = check(cfg, traffic, weights, req, cond_prog, progd, dev, spec.limits, look=look)
    t_ref = time.perf_counter() - t_ref
    if ctx.calibrate:
        t_low = time.perf_counter()
        low = control_numbers(cfg, traffic, weights, req, progd, dev) if ctx.control and not ctx.fault else None
        return dict(program={k: c.value for k, c in checks.items()}, control=low, look=look, steps=attempted,
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
    from counts.flops import step_flops

    cfgs, mcfg = ref_configs(cfg, cfg["compute_dtype"])
    tokens = cfg["clip_text"]["context_length"] + cfg["resampler"]["num_queries"] * cfg["resampler"]["video_length"]
    return step_flops(cfgs, mcfg, traffic, tokens)


class Reference:
    """The plain reference in float32 (or, as the control, in the lowered
    precision) over the same weights and request."""

    def __init__(self, cfg, traffic, weights, req, device, compute_dtype: str = "float32"):
        self.R = R = ref_modules()
        self.traffic = traffic
        cfgs, self.mcfg = ref_configs(cfg, compute_dtype)
        self.params = R["model"].DiffusionParams(*weights)
        h, w = traffic["height"], traffic["width"]
        video = F.interpolate(req.renders.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                              align_corners=False, antialias=True).permute(0, 2, 3, 1) * 2.0 - 1.0
        with torch.no_grad():
            self.cond, self.uncond = R["conditioning"].build_conditioning(
                self.params, self.mcfg, cfgs[3], cfgs[4], cfgs[2], video, req.eps, fs=traffic["fs"])
        gcfg = R["dg"].GuidedSampleConfig(cfg_scale=traffic["cfg_scale"], guidance_rescale=traffic["guidance_rescale"],
                                          decode_chunk=traffic["decode_chunk"])
        self.gcfg = gcfg
        if traffic["guided"]:
            bufs = R["lg"].resize_guidance(req.images, h, w, masks=req.masks, depths=req.depths)
            self.guidance_fn = R["lg"].make_guidance_fn(bufs, w_recon=traffic["w_recon"],
                                                        recon_loss=traffic["recon_loss"])
        self.sched = self.mcfg.schedule(device)
        self.pr = R["schedules"].make_ddim_params(self.sched, traffic["ddim_steps"], eta=traffic["eta"],
                                                  method=traffic["timestep_spacing"])

    def unguided(self, x, index, noise, vc, vu):
        """The DDIM update of a step from the pair (vc, vu)."""
        mo = self.R["dg"].cfg_pred_x0(self.sched, self.pr, self.gcfg, x, index, vc, vu)[1]
        return self.R["ddim"].ddim_step(self.sched, self.pr, index, x, mo, noise).x_prev

    def unmodelled(self, x, index, noise):
        """The DDIM update of the step with a zero model output."""
        return self.R["ddim"].ddim_step(self.sched, self.pr, index, x, torch.zeros_like(x), noise).x_prev

    def pair(self, x, index):
        """(v_cond, v_uncond) of the step from x (DDIM index `index`)."""
        if self.traffic["guided"]:
            return self.R["dg"].pair_forward(self.params, self.mcfg, self.pr, self.cond, self.uncond, x, index)
        t = self.pr.timesteps[index].expand(x.shape[0])
        with torch.no_grad():
            return tuple(self.R["model"].apply_model(self.params, self.mcfg, x, t, c)
                         for c in (self.cond, self.uncond))

    def guided(self, x, index, noise, vc, vu):
        """The guided step's output from x and the pair (vc, vu): the CFG
        output and pred_x0, the DDIM update, the decode gradients, the
        branches' VJPs and the adaptive step."""
        dg = self.R["dg"]
        vc, vu = vc.to(x.dtype), vu.to(x.dtype)
        pred_x0, mo = dg.cfg_pred_x0(self.sched, self.pr, self.gcfg, x, index, vc, vu)
        out = self.R["ddim"].ddim_step(self.sched, self.pr, index, x, mo, noise, self.gcfg.temperature)
        grads = dg.per_frame_guidance_grads(self.params, self.mcfg, self.guidance_fn, pred_x0[0], index, self.gcfg)
        gx = dg.pair_vjp(self.params, self.mcfg, self.sched, self.pr, self.cond, self.uncond, self.gcfg, x, index,
                         vc, vu, grads[None])
        return dg.guidance_update(out.x_prev, gx, vc - vu, self.gcfg, 1.0)[0]

    def step(self, x, index, noise):
        """(v_cond, v_uncond, x_prev) of the whole step from x, from its own
        pair."""
        vc, vu = self.pair(x, index)
        if self.traffic["guided"]:
            return vc, vu, self.guided(x, index, noise, vc, vu)
        return vc, vu, self.unguided(x, index, noise, vc, vu)


def compare(ref: Reference, cond_prog, progd, req, look: Optional[dict] = None) -> Dict[str, float]:
    """The numbers that decide `correct`, from the program's conditioning
    and sampled steps [(k, x_t, x_prev, (v_cond, v_uncond))]. Guided, the
    step's output is worked out from the program's pair. With `look` (a
    dict), it also gets what the guided numbers would read from the
    reference's own pair, and how far the pair's CFG difference and output
    part: `pair_diff`, `cfg_out`, `x_prev_own_pair`, `guidance_own_pair`."""
    nums = {"cond": max(rel(cond_prog[0], ref.cond.context), rel(cond_prog[1], ref.uncond.context),
                        rel(cond_prog[2], ref.cond.concat))}
    s, guided = ref.pr.num_steps, ref.traffic["guided"]
    pv = xp = gd = 0.0
    for k, x, x_prev, (vc_p, vu_p) in progd:
        index, noise = s - 1 - k, req.noise[k]
        vc, vu = ref.pair(x, index)
        pv = max(pv, rel(vc_p, vc), rel(vu_p, vu))
        x_ref = ref.guided(x, index, noise, vc_p, vu_p) if guided else ref.unguided(x, index, noise, vc, vu)
        x_zero = ref.unmodelled(x, index, noise)
        xp = max(xp, rel_to(x_prev, x_ref, x_ref - x_zero))
        if guided:
            u_p = ref.unguided(x, index, noise, vc_p, vu_p)
            gd = max(gd, rel(x_prev - u_p, x_ref - u_p))
            if look is not None:
                cfg = lambda a, b: ref.R["dg"].cfg_pred_x0(ref.sched, ref.pr, ref.gcfg, x, index, a, b)[1]  # noqa: E731
                x_own = ref.guided(x, index, noise, vc, vu)
                u_r = ref.unguided(x, index, noise, vc, vu)
                for name, v in (("pair_diff", rel(vc_p - vu_p, vc - vu)),
                                ("cfg_out", rel(cfg(vc_p, vu_p), cfg(vc, vu))),
                                ("x_prev_own_pair", rel_to(x_prev, x_own, x_own - x_zero)),
                                ("guidance_own_pair", rel(x_prev - u_p, x_own - u_r))):
                    look[name] = max(look.get(name, 0.0), v)
        del vc, vu, x_ref
    nums["pair_v"], nums["x_prev"] = pv, xp
    if guided:
        nums["guidance"] = gd
    return {k: (math.nan if v != v else v) for k, v in nums.items()}


def stage_look(ref: Reference, low: Reference, item, req, look: dict) -> None:
    """Where the guided step's gap arises: the guidance stage of one sampled
    step worked out by the plain reference in float32 (`ref`) and in the
    configuration's precision (`low`, no kernel of the program), from the
    program's pair and the same conditioning. `decode_grads_low`: the
    decode gradients; `vjp_low`: the guidance term with the low VJP on the
    float32 decode gradients; `guidance_low`: the low stage whole;
    `program_vs_low`: the program's term against the low stage's;
    `branch_vjp_low`: each branch's VJP (of the CFG combination's cotangent)
    low against float32, the worse; `vjp_cancel`: how far the branches'
    VJPs cancel in their sum, (|J_c^T g_c| + |J_u^T g_u|) / |dL/dx|."""
    k, x, x_prev, (vc_p, vu_p) = item
    index, noise = ref.pr.num_steps - 1 - k, req.noise[k]
    dg = ref.R["dg"]
    vc, vu = vc_p.to(x.dtype), vu_p.to(x.dtype)
    pred_x0 = dg.cfg_pred_x0(ref.sched, ref.pr, ref.gcfg, x, index, vc, vu)[0]

    def grads(r):
        return dg.per_frame_guidance_grads(r.params, r.mcfg, r.guidance_fn, pred_x0[0], index, r.gcfg).float()

    def term(r, g):
        gx = dg.pair_vjp(r.params, r.mcfg, ref.sched, ref.pr, ref.cond, ref.uncond, ref.gcfg, x, index, vc, vu,
                         g[None])
        return dg.guidance_update(torch.zeros_like(x), gx.float(), vc - vu, ref.gcfg, 1.0)[0]

    g32, g_low = grads(ref), grads(low)
    t32 = term(ref, g32)
    t_low = term(low, g_low)
    t_p = x_prev - ref.unguided(x, index, noise, vc, vu)
    t = ref.pr.timesteps[index].expand(x.shape[0])
    with torch.enable_grad():
        xl, vcl, vul = (a.detach().requires_grad_() for a in (x, vc, vu))
        pred = dg.cfg_pred_x0(ref.sched, ref.pr, ref.gcfg, xl, index, vcl, vul)[0]
        gx, g_c, g_u = torch.autograd.grad(pred, (xl, vcl, vul), g32[None])
        branch = {}
        for r in (ref, low):
            for c, g in ((ref.cond, g_c), (ref.uncond, g_u)):
                xg = x.detach().requires_grad_()
                v = ref.R["model"].apply_model(r.params, r.mcfg, xg, t, c)
                branch[r is ref, c is ref.cond] = torch.autograd.grad(v, xg, g.to(v.dtype))[0].float()
    full = gx + branch[True, True] + branch[True, False]
    look.update(branch_vjp_low=max(rel(branch[False, b], branch[True, b]) for b in (True, False)),
                vjp_cancel=float((branch[True, True].norm() + branch[True, False].norm()) / full.norm()))
    look.update(decode_grads_low=rel(g_low, g32), vjp_low=rel(term(low, g32), t32), guidance_low=rel(t_low, t32),
                program_vs_low=rel(t_p, t_low), program_vs_f32=rel(t_p, t32))


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def check(cfg, traffic, weights, req, cond_prog, progd, dev, limits, look=None) -> Dict[str, result.Check]:
    """The numbers against the cell's limits (its workload file's `limits`)."""
    with _no_tf32():
        ref = Reference(cfg, traffic, weights, req, dev)
        nums = compare(ref, cond_prog, progd, req, look)
        if look is not None and traffic["guided"] and progd:
            ref16 = Reference(cfg, traffic, weights, req, dev, compute_dtype=cfg["compute_dtype"])
            stage_look(ref, ref16, progd[0], req, look)
    return {k: result.Check(v, limits[k]) for k, v in nums.items()}


def control_numbers(cfg, traffic, weights, req, progd, dev) -> Dict[str, float]:
    """The control: the reference in the precision below the configuration's
    (bf16: float8_e4m3fn linear and convolution inputs and weights, bf16
    elsewhere; float32: bf16) in the program's place, on the same sampled
    steps' inputs, compared as the program is."""
    R = ref_modules()
    low_dtype = {"bfloat16": torch.float8_e4m3fn, "float32": torch.bfloat16}[cfg["compute_dtype"]]
    with _no_tf32():
        ref = Reference(cfg, traffic, weights, req, dev)
        with R["nnops"].lowered(low_dtype):
            low = Reference(cfg, traffic, weights, req, dev, compute_dtype=cfg["compute_dtype"])
            lowd = []
            s = low.pr.num_steps
            for k, x, _, _ in progd:
                vc, vu, x_prev = low.step(x, s - 1 - k, req.noise[k])
                lowd.append((k, x, x_prev, (vc, vu)))
        cond_low = (low.cond.context, low.uncond.context, low.cond.concat)
        return compare(ref, cond_low, lowd, req)
