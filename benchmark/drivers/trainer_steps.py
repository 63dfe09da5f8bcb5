"""Timed loop: the Gaussian trainer's iterations in the middle of a run.

Set-up makes the scene from the seed (benchmark/inputs/gs_scene.py: the
room's train views with ray-cast ground truth, 1M initial Gaussians as
just after the opacity reset at iteration 3000), builds the program's
`train/baseline.py::BaselineTrainer` with the configuration's
optimisation flags, the SH degree at its maximum and the position
learning rate of the iteration, and warms it up by the window's own call,
`trainer.step(it)`, over the cycle's first `check_steps` iterations (a
densification among them). The Gaussians and the Adam state then go back
to the set-up's device copy and the window drives `trainer.step(it)` for
it = `first`...`last` of the cycle, again and again, the restore at each
cycle's end inside the window, until `seconds` have passed.
`train_step_ms` is the window over the iterations it completed.

With `guided` in the traffic the trainer is `train/guided.py::
GuidedTrainer` over a frozen copy of the initial Gaussians, with the VGG
pseudo term (random VGG19 weights from the seed), and one diffusion
event's products finalized at set-up by the program's own
`finalize_diffusion_event`: a 25-frame video along an arc of the orbit
from a train view (the room ray-cast: a perfect prior) with a seeded
unobserved hole, which fills the pseudo stacks. Each step then renders the
train view and a pseudo view as one chain. The event boundary lies past
the window (the configuration's `guidance_vd_iter`, listed in its
`reduced`): the events' diffusion is the vc-guided-ddim cell's work.

`correct`: the window's first `check_steps` iterations (three steps, then
the densification iteration), from the restored state, are recorded as
they run. Once the window has closed and the peak has been read, the
plain reference (benchmark/reference/gs) runs the same iterations from
the same initial Gaussians on the same views, in float32; a pseudo view is
the event's frame that the program picked, its pose and target taken
from the benchmark's own event. Compared:

  loss     each step's loss
  grad     the first step's gradient as the optimizer got it (Adam's first
           moment after one step over 1 - beta1), leaf by leaf
  change   each leaf's change over the three steps (the state the
           densification iteration starts from)
  densify  the Gaussians kept by the densification iteration, against
           those it adds or removes in the reference
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from types import SimpleNamespace
from typing import Dict, List, Optional
from unittest import mock

import numpy as np
import torch

from harness import result, trace
from inputs import room as Room
from inputs.gs_scene import make_scene
from inputs.vgg_weights import make_vgg

ADAM_B1 = 0.9


def _opt(cfg: dict, traffic: dict):
    from guidedvd3dgs_tpu_torch.config import ModelParams, OptimizationParams, PipelineParams

    opt = OptimizationParams(**dict(cfg["optimization"], guidance_vd_iter=cfg["guidance_vd_iter"],
                                    **traffic.get("optimization", {})))
    return opt, PipelineParams(), ModelParams(sh_degree=cfg["sh_degree"], white_background=False)


class Program:
    """The program's trainer over the scene, restorable to the initial state."""

    def __init__(self, cfg: dict, traffic: dict, scene, device, fault: Optional[str] = None, event=None,
                 vgg=None):
        from guidedvd3dgs_tpu_torch.models import gaussians as G
        from guidedvd3dgs_tpu_torch.scene.cameras import Camera
        from guidedvd3dgs_tpu_torch.train import baseline, guided

        self.G, self.baseline, self.guided_mod, self.fault = G, baseline, guided, fault
        self.cfg, self.traffic, self.scene = cfg, traffic, scene
        self.opt, pipe, mp = _opt(cfg, traffic)
        cams = [Camera(colmap_id=v.uid, R=v.R, T=v.T, FoVx=v.fovx, FoVy=v.fovy,
                       image=v.image.cpu().numpy(), image_name=f"view_{v.uid:03d}", uid=v.uid)
                for v in scene.views]
        ns = SimpleNamespace(getTrainCameras=lambda: cams, cameras_extent=scene.extent)
        self.picks: Optional[List] = None  # the pseudo view of each step while a list
        if event is None:
            self.trainer = baseline.BaselineTrainer(ns, self.fresh_state(), self.opt, pipe, mp)
        else:
            from guidedvd3dgs_tpu_torch.utils import vgg_loss

            def vgg_fn(x, y, mask=None, per_sample=False):
                # looked up at each call, where a metric's span may wrap it
                return vgg_loss.vgg_perceptual_loss(vgg, x, y, mask, per_sample=per_sample)

            frozen = guided.FrozenRenderer(SimpleNamespace(**{k: v.clone() for k, v in scene.params.items()}),
                                           cfg["sh_degree"])
            p = scene.params
            self.trainer = guided.GuidedTrainer(
                ns, self.fresh_state(), self.opt, pipe, mp, frozen, SimpleNamespace(video_length=event.video.shape[0]),
                pcd_points=p["xyz"].cpu().numpy(), pcd_colors=np.zeros((p["xyz"].shape[0], 3), np.float32),
                guidance_intrinsic=event.K, vgg_loss_fn=vgg_fn)
            self.trainer.finalize_diffusion_event(guided.PendingEvent(record=guided.EventRecord(
                event.view, event.traj, event.video, event.gs_alpha, event.gs_depth, "", None)))
            real_pick = self.trainer._pick_pseudo

            def pick(iteration):
                cam = real_pick(iteration)
                if self.picks is not None:
                    self.picks.append(cam)
                return cam

            self.trainer._pick_pseudo = pick
        self.trainer.active_sh_degree = self.trainer.max_sh_degree  # past iteration 1500
        # device copies of the ground truth: the trainer's own, made once
        for c in cams:
            self.trainer.camera_on_device(c)

    def fresh_state(self):
        G = self.G
        return G.GaussianState.fresh(G.GaussianParams(**{k: v.clone() for k, v in self.scene.params.items()}))

    def restore(self, iteration: int) -> None:
        """The set-up's Gaussians, zero Adam moments and statistics, and
        the position learning rate of the iteration before `iteration`."""
        self.trainer.state = self.fresh_state()
        self.trainer.xyz_lr = self.trainer.xyz_sched(iteration - 1)

    @contextlib.contextmanager
    def faults(self):
        """The planted fault, if any (tests only)."""
        G = self.G
        b = self.guided_mod if getattr(self.trainer, "vgg_loss_fn", None) is not None else self.baseline
        if self.fault == "unchanged":
            ctx = mock.patch.object(G, "adam_step", lambda state, grads, lrs: state)
        elif self.fault == "half_batch":
            real = b.l1_loss
            ctx = mock.patch.object(b, "l1_loss",
                                    lambda x, gt: real(x[:, : x.shape[1] // 2], gt[:, : gt.shape[1] // 2]))
        elif self.fault == "altered":
            real = b.l1_loss
            ctx = mock.patch.object(b, "l1_loss", lambda x, gt: real(x * 1.01, gt))
        else:
            ctx = contextlib.nullcontext()
        with ctx:
            yield

    def step(self, it: int):
        return self.trainer.step(it)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx) -> dict:
    spec, dev, seed = ctx.spec, ctx.device, ctx.seed
    cfg, traffic = spec.config, spec.traffic
    scene = make_scene(seed, cfg, dev)
    event = make_event(seed + 1, cfg, traffic, scene, dev) if traffic.get("guided") else None
    vgg = make_vgg(seed + 2, dev) if event is not None else None
    prog = Program(cfg, traffic, scene, dev, fault=ctx.fault, event=event, vgg=vgg)
    first, last, m = traffic["first"], traffic["last"], int(traffic["check_steps"])
    check_its = list(range(first, first + m))
    with prog.faults():
        # warm-up: the check's iterations through the window's call, every
        # shape the window uses (render, backward, Adam, densify)
        prog.restore(first)
        for it in check_its:
            prog.step(it)
        prog.restore(first)
        _sync(dev)
        setup_s = time.perf_counter() - ctx.t0
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        views: List[int] = []
        got = dict(loss=[], views=views, pseudo=[])
        counts_at = []  # (iteration, Gaussians) at each traced cycle's start and end
        cycle_t = []  # host clock at each cycle's start
        st = dict(n=0, it=first)
        prog.picks = got["pseudo"] if event is not None else None

        def advance():
            n, it = st["n"], st["it"]
            if it == first:
                cycle_t.append(time.perf_counter())
                if ctx.trace:
                    counts_at.append((it, prog.trainer.state.num_gaussians))
            stats = prog.step(it)
            bad.add_((~torch.isfinite(stats.loss)).long())
            views.append(prog.trainer.last_camera.uid)
            if n < m:  # the window's first iterations: kept for the check
                got["loss"].append(stats.loss.detach().clone())
                state = prog.trainer.state
                if n == 0:
                    got["m1"] = {k: state.adam_m[k].clone() for k in prog.G.PARAM_NAMES}
                if n == m - 2:
                    got["p3"] = {k: v.clone() for k, v in state.params.tensors().items()}
                    got["n_before"] = state.num_gaussians
                if n == m - 1:
                    got["n_after"] = state.num_gaussians
            if prog.picks is not None and len(prog.picks) >= max(m, 2 * ctx.max_steps):
                prog.picks = None  # only the checked steps' picks, and the traced run's, are kept
            st["n"] = n + 1
            if it == last:
                if ctx.trace:
                    counts_at.append((it, prog.trainer.state.num_gaussians))
                prog.restore(first)
                st["it"] = first
            else:
                st["it"] = it + 1

        step_s = None
        if ctx.trace:
            # an untraced stretch of as many steps as are traced, before the
            # profiler starts: the time a step without its host cost
            t_stretch = time.perf_counter()
            for _ in range(ctx.max_steps):
                advance()
            _sync(dev)
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
                    if st["n"] < m:  # the checked iterations lie inside every window
                        continue
                    if ctx.max_steps:
                        if st["n"] - n0 >= ctx.max_steps:
                            break
                    elif time.perf_counter() - t_start >= ctx.seconds:
                        break
                _sync(dev)
            t_stop = time.perf_counter()
        elapsed = time.perf_counter() - t_start
        n = st["n"] - n0  # the steps traced, or the window's
        if ctx.trace:
            trace.note("profiler stop", time.perf_counter() - t_stop)
            counts_at.append((st["it"] - 1, prog.trainer.state.num_gaussians))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed, attempted = int(bad), st["n"]
    cycle_ms = [(b - a) / (last - first + 1) * 1e3 for a, b in zip(cycle_t, cycle_t[1:])]
    got["loss"] = [float(x) for x in got["loss"]]
    got["views"] = views[:m]
    picks = [None if pc is None else event_frame(event, pc) for pc in got["pseudo"]]
    del prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    opt = _opt(cfg, traffic)[0]
    metrics, breakdown, busy, extra = {}, None, None, {}
    if ctx.trace:
        t_reduce = time.perf_counter()
        traced = range(n0, n0 + n)
        keys = [(views[j],) + ((("pseudo", picks[j]),) if j < len(picks) and picks[j] is not None else ())
                for j in traced]
        view = trace.reduce(prof, n, info=dict(cfg=cfg, traffic=traffic, views=keys,
                                               counts=lambda: _view_counts(cfg, scene, event, picks[n0:n0 + n], dev)),
                            step_s=step_s)
        for mt in spec.per_layer:
            v = mt.reader.read(view)
            if v is not None:
                metrics[mt.name] = {"value": v, "unit": mt.unit}
        breakdown, busy = view.breakdown(), (view.busy_s, view.window_s)
        trace.note("trace reduced and read", time.perf_counter() - t_reduce)
        extra["gaussians_at"] = counts_at
    else:
        for mt in spec.end_to_end:
            v = {"train_step_ms": elapsed / n * 1e3, "peak_gb": peak / 1e9, "setup_s": setup_s}[mt.name]
            metrics[mt.name] = {"value": v, "unit": mt.unit}
        extra["cycle_ms"] = cycle_ms
    got["pseudo"] = picks[:m]
    t_ref = time.perf_counter()
    nums = compare(cfg, traffic, opt, scene, got, check_its, dev, event=event, vgg=vgg)
    extra["reference_s"] = time.perf_counter() - t_ref
    if ctx.calibrate:
        low = None
        if ctx.control and not ctx.fault:
            low = compare(cfg, traffic, opt, scene, None, check_its, dev, control=got, event=event, vgg=vgg)
        return dict(program=nums, control=low, steps=attempted, reference_s=extra["reference_s"], setup_s=setup_s,
                    step_ms=elapsed / n * 1e3, peak_gb=peak / 1e9, cycle_ms=cycle_ms)
    checks = {k: result.Check(v, spec.limits[k]) for k, v in nums.items()}
    device = result.device_info(dev, 1, peak, *(busy or (None, None)))
    return result.line(checks, attempted, failed, metrics, device, breakdown, extra=extra)


def event_frame(event, cam) -> int:
    """The frame of the benchmark's event whose pose is nearest the program's
    pseudo camera (its center): which frame the program picked. The
    reference takes that frame's pose and target from the event itself."""
    c2w = np.asarray(event.traj, np.float64)
    center = -np.asarray(cam.R, np.float64) @ np.asarray(cam.T, np.float64)
    return int(np.argmin(np.linalg.norm(c2w[:, :3, 3] - center, axis=1)))


def pseudo_camera(event, frame: int, scene, cfg, dev, dtype=torch.float32):
    """The reference's camera of an event frame, from the benchmark's
    trajectory (c2w) and the event view's field of view."""
    from reference.gs import raster

    w2c = np.linalg.inv(np.asarray(event.traj[frame], np.float64))
    v = scene.views[event.view]
    return raster.camera(w2c[:3, :3].T, w2c[:3, 3], v.fovx, v.fovy, cfg["width"], cfg["height"], dev, dtype)


def ref_camera(v, cfg, dev, dtype=torch.float32):
    from reference.gs import raster

    return raster.camera(v.R, v.T, v.fovx, v.fovy, cfg["width"], cfg["height"], dev, dtype)


def _view_counts(cfg, scene, event, picks, dev) -> Dict[object, object]:
    """The reference binning's counts of each train view and each picked
    pseudo frame at the initial Gaussians (what the kernels of a traced step
    work on)."""
    from reference.gs import raster, train

    p = train.params_tuple(scene.params)
    bg = torch.zeros(3, device=dev)
    cams = {v.uid: ref_camera(v, cfg, dev) for v in scene.views}
    for f in set(picks) - {None}:
        cams[("pseudo", f)] = pseudo_camera(event, f, scene, cfg, dev)
    with torch.no_grad():
        return {k: raster.render(*p, c, bg, cfg["sh_degree"], cfg["sh_degree"]).counts for k, c in cams.items()}


def _lr_func(opt, extent: float):
    """The position learning rate's schedule (the 3DGS original's
    get_expon_lr_func, as the port's utils/general.py states it)."""
    lr_init, lr_final = opt.position_lr_init * extent, opt.position_lr_final * extent

    def f(step):
        if lr_init == 0.0 and lr_final == 0.0:
            return 0.0
        t = np.clip(step / opt.position_lr_max_steps, 0, 1)
        return 0.0 if step < 0 else float(np.exp(np.log(lr_init) * (1 - t) + np.log(lr_final) * t))
    return f


def reference_steps(cfg, traffic, opt, scene, views: List[int], check_its: List[int], dev,
                    dtype=torch.float32, pseudo=None, event=None, vgg=None) -> dict:
    """The reference's losses, first gradients, parameters before the
    densification iteration and Gaussians after it; `pseudo` the event
    frame of each step; `dtype` the precision the renders and losses
    compute in (the control's is below float32)."""
    from reference.gs import raster, train
    from reference.gs import vgg as vgg_ref

    st = train.State.fresh(scene.params)
    by_uid = {v.uid: v for v in scene.views}
    bg = torch.zeros(3, device=dev)
    lr = _lr_func(opt, scene.extent)
    out = dict(loss=[])
    for j, (it, uid) in enumerate(zip(check_its, views)):
        v = by_uid[uid]
        pc = pseudo[j] if pseudo else None
        p = train.with_grad(st)
        offsets = torch.zeros((1 if pc is None else 2, st.n, 2), device=dev, requires_grad=True)
        leaves = [p[k].to(dtype) for k in train.PARAM_NAMES]
        sh = cfg["sh_degree"]
        r = raster.render(*leaves, ref_camera(v, cfg, dev, dtype), bg.to(dtype), sh, sh, offset=offsets[0].to(dtype))
        loss = train.image_loss(r.color, v.image.to(dtype), opt.lambda_dssim)
        if pc is not None:
            cam = pseudo_camera(event, pc, scene, cfg, dev, dtype)
            rp = raster.render(*leaves, cam, bg.to(dtype), sh, sh, offset=offsets[1].to(dtype))
            pgt = event.video[pc].to(dtype)
            ploss = torch.abs(rp.color - pgt).mean()
            ploss = ploss + opt.pseudo_cam_lpips_weight * vgg_ref.perceptual_loss(
                vgg, torch.clamp(rp.color, 0, 1)[None], torch.clamp(pgt, 0, 1)[None])
            loss = loss + opt.pseudo_cam_weight * ploss
        grads = torch.autograd.grad(loss, [p[k] for k in train.PARAM_NAMES] + [offsets])
        g = {k: gk.float() for k, gk in zip(train.PARAM_NAMES, grads[:-1])}
        out["loss"].append(float(loss.detach()))
        if j == 0:
            out["g1"] = g
        densify = opt.densify_from_iter < it < opt.densify_until_iter and it % opt.densification_interval == 0
        if it < opt.densify_until_iter:
            og = grads[-1].float()
            if pc is None:
                train.add_stats(st, og[0], r.visible, r.radii)
            else:
                st.max_radii = torch.where(r.visible, torch.maximum(st.max_radii, r.radii.float()), st.max_radii)
                train.add_stats(st, og[0] + og[1], r.visible | rp.visible, rp.radii)
        if it < opt.iterations and not densify:
            lrs = dict(xyz=lr(it - 1), features_dc=opt.feature_lr, features_rest=opt.feature_lr / 20.0,
                       opacity=opt.opacity_lr, scaling=opt.scaling_lr, rotation=opt.rotation_lr)
            train.adam(st, g, lrs)
        if j == len(check_its) - 2:
            out["p3"] = {k: st.p[k].clone() for k in train.PARAM_NAMES}
            out["n_before"] = st.n
        if densify:
            cfgd = train.DensifyCfg(opt.densify_grad_threshold, opt.prune_threshold, scene.extent,
                                    opt.percent_dense, opt.dist_thres, it > opt.prune_from_iter)
            train.densify_and_prune(st, cfgd, it)
        del p, offsets, r, loss, grads
    out["n_after"] = st.n
    return out


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep) -> float:
    """Worst leaf of |norm(prog) - norm(ref)| / max(norm(ref), median leaf norm)."""
    pn = {k: float(torch.linalg.vector_norm(v.double())) for k, v in prog.items()}
    rn = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items()}
    med = float(np.median(list(rn.values())))
    gaps = [abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in rn if keep(k)]
    if any(not math.isfinite(pn[k]) for k in pn):
        return math.nan
    return max(gaps) if gaps else 0.0


def compare(cfg, traffic, opt, scene, got, check_its, dev, control=None, event=None, vgg=None) -> Dict[str, float]:
    """The numbers that decide `correct`: the program's (`got`) against the
    float32 reference, or, with `control` (the program's record, for its
    views), the reference in bfloat16 in the program's place."""
    rec = got if control is None else control
    kw = dict(pseudo=rec["pseudo"], event=event, vgg=vgg)
    ref = reference_steps(cfg, traffic, opt, scene, rec["views"], check_its, dev, **kw)
    if control is not None:
        low = reference_steps(cfg, traffic, opt, scene, rec["views"], check_its, dev, dtype=torch.bfloat16, **kw)
        got = dict(loss=low["loss"], m1={k: (1 - ADAM_B1) * v for k, v in low["g1"].items()}, p3=low["p3"],
                   n_after=low["n_after"], n_before=low["n_before"])
    g_prog = {k: v / (1.0 - ADAM_B1) for k, v in got["m1"].items()}
    gnorm = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref["g1"].items()}
    med_g = float(np.median(list(gnorm.values())))
    moved = lambda k: gnorm[k] >= 1e-3 * med_g  # noqa: E731
    p0 = scene.params
    d_prog = {k: got["p3"][k] - p0[k] for k in p0}
    d_ref = {k: ref["p3"][k] - p0[k] for k in p0}
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"]))
    added = abs(ref["n_after"] - ref["n_before"])
    return dict(loss=loss if all(map(math.isfinite, got["loss"])) else math.nan,
                grad=_leaf_gaps(g_prog, ref["g1"], lambda k: True),
                change=_leaf_gaps(d_prog, d_ref, moved),
                densify=abs(got["n_after"] - ref["n_after"]) / max(added, 1))


class Event(SimpleNamespace):
    """One diffusion event's products: view, traj (T, 4, 4) c2w, video
    (T, 3, H, W), gs_alpha (T, 1, H, W) 1 where unobserved, gs_depth, K."""


def make_event(seed: int, cfg: dict, traffic: dict, scene, dev) -> Event:
    """An event's products from the seed: along an arc of the orbit from a
    train view drawn from the seed, the room ray-cast (the perfect prior's
    video) and a seeded unobserved hole of `hole` of the frame."""
    rng = np.random.default_rng(seed)
    room = scene.room
    w, h, t = cfg["width"], cfg["height"], traffic["event_frames"]
    view = int(rng.integers(0, len(scene.views)))
    start = scene.views[view].uid / cfg["n_cams"] * 2 * np.pi
    traj = Room.orbit_c2ws(t * traffic["event_arc"], phase=start)[:t]
    frames = [Room.raycast(room, c, w, h, cfg["hfov_deg"], dev) for c in traj]
    video = torch.stack([f[0].permute(2, 0, 1) for f in frames])
    depth = torch.stack([f[1] for f in frames])[:, None]
    hh, hw = int(round(h * np.sqrt(traffic["hole"]))), int(round(w * np.sqrt(traffic["hole"])))
    y0, x0 = int(rng.integers(0, h - hh + 1)), int(rng.integers(0, w - hw + 1))
    alpha = torch.zeros((t, 1, h, w), device=dev)
    alpha[:, :, y0:y0 + hh, x0:x0 + hw] = 1.0
    fx = w / (2 * np.tan(scene.views[0].fovx / 2))
    fy = h / (2 * np.tan(scene.views[0].fovy / 2))
    K = np.array([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]], np.float32)
    return Event(view=view, traj=traj, video=video, gs_alpha=alpha, gs_depth=depth, K=K)
