"""Baseline 3DGS training loop.

Counterpart of `guidedvd3dgs_tpu/train/baseline.py` (`train_step`,
`BaselineTrainer`), with the same schedule:
  * SH degree +1 every 500 iterations (up to the maximum); the rasterizer
    runs at the maximum degree with the higher bands masked;
  * random camera epochs without replacement (`random.Random(seed)`);
  * loss = (1 - lambda) L1 + lambda (1 - SSIM);
  * densification statistics every iteration before densify_until_iter;
    densify and prune every densification_interval after densify_from_iter
    (screen-size threshold off); no Adam step on those iterations, nor on
    the last one;
  * the xyz learning rate scheduled after the step with its index;
  * opacity reset every opacity_reset_interval;
  * with `nan_debug`, the state snapshotted at the start of every
    densification interval (the JAX package's chunk) and checked after
    every step: on the first non-finite xyz, opacity or scaling the
    snapshot (a checkpoint that --start_checkpoint resumes) and the
    interval's schedule are written next to the checkpoints and the run
    stops (JAX train/baseline.py:426-515).

One step is a plain eager loop: render (K1 -> binning -> K4), loss,
`backward()` (K5 -> K6 -> K2), statistics, Adam. It reads nothing back to
the host but the instance count of the binning: the loss and PSNR stay on
the device until a log line asks for them. The reference's `lax.scan`
chunk trainer and its instance-buffer regrow were for the TPU; the port
sizes its buffers exactly and has neither.
"""

from __future__ import annotations

import json
import os
import random
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from guidedvd3dgs_tpu_torch.models import gaussians as G
from guidedvd3dgs_tpu_torch.models.render import render_gaussians, render_state
from guidedvd3dgs_tpu_torch.ops.projection import RasterCamera
from guidedvd3dgs_tpu_torch.train.logging import maybe_profiler_trace
from guidedvd3dgs_tpu_torch.train.checkpoint import checkpoint_arrays, save_checkpoint, write_checkpoint_arrays
from guidedvd3dgs_tpu_torch.utils.general import get_expon_lr_func
from guidedvd3dgs_tpu_torch.utils.losses import l1_loss, psnr, ssim
from guidedvd3dgs_tpu_torch.utils.tracing import span

# --profile_dir traces the steps from PROFILE_WINDOW[0] to PROFILE_WINDOW[1]
# after the start (JAX baseline.py:574-592).
PROFILE_WINDOW = (50, 60)

@dataclass
class StepStats:
    """One step's metrics, as 0-dim device tensors (read them only where
    they are printed: each read waits for the device)."""

    loss: torch.Tensor
    l1: torch.Tensor
    psnr: torch.Tensor
    num_active: int
    num_instances: Optional[int] = None  # (Gaussian, tile) instances of the render


def train_step(
    state: G.GaussianState,
    cam: RasterCamera,
    gt_image: torch.Tensor,
    bg: torch.Tensor,
    lrs: G.LearningRates,
    active_degree: int,
    sh_degree: int,
    lambda_dssim: float,
    use_confidence: bool = False,
    backend: str = "auto",
    apply_adam: bool = True,
    update_stats: bool = True,
) -> dict:
    """One baseline optimization step, updating `state` in place. Returns
    the metrics (loss, l1, psnr as device tensors; num_instances)."""
    with span("train.render"):
        offset = torch.zeros((state.num_gaussians, 2), device=state.device, requires_grad=True)
        r = render_state(state, cam, bg, sh_degree, means2d_offset=offset,
                         use_confidence=use_confidence, backend=backend, active_degree=active_degree)
    with span("train.loss"):
        ll1 = l1_loss(r.color, gt_image)
        loss = (1.0 - lambda_dssim) * ll1 + lambda_dssim * (1.0 - ssim(r.color, gt_image))
    # the gradient is taken every step, as the reference's value_and_grad
    state.params.zero_grad(set_to_none=True)
    with span("train.backward"):
        loss.backward()
    if update_stats:
        with span("train.stats"):
            G.update_max_radii(state, r.radii, r.visibility_filter)
            G.add_densification_stats(state, offset.grad, r.visibility_filter)
    if apply_adam:
        with span("train.adam"):
            grads = {n: getattr(state.params, n).grad for n in G.PARAM_NAMES}
            G.adam_step(state, grads, lrs)
    with torch.no_grad():
        return {
            "loss": loss.detach(),
            "l1": ll1.detach(),
            "psnr": psnr(r.color, gt_image)[0, 0],
            "num_instances": r.num_instances,
        }


def make_lr_schedule(opt, spatial_lr_scale: float):
    return get_expon_lr_func(
        lr_init=opt.position_lr_init * spatial_lr_scale,
        lr_final=opt.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt.position_lr_delay_mult,
        max_steps=opt.position_lr_max_steps,
    )


def lrs_for(opt, xyz_lr: float) -> G.LearningRates:
    return G.LearningRates(
        xyz=float(xyz_lr),
        f_dc=opt.feature_lr,
        f_rest=opt.feature_lr / 20.0,
        opacity=opt.opacity_lr,
        scaling=opt.scaling_lr,
        rotation=opt.rotation_lr,
    )


def densify_cfg(opt, extent: float, iteration: int, max_screen_size: float = 0.0):
    return G.DensifyConfig(
        grad_threshold=opt.densify_grad_threshold,
        min_opacity=opt.prune_threshold,
        extent=float(extent),
        max_screen_size=float(max_screen_size or 0.0),
        percent_dense=opt.percent_dense,
        dist_thres=opt.dist_thres,
        prune_enabled=iteration > opt.prune_from_iter,
        proximity_enabled=iteration < 2000,
    )


class BaselineTrainer:
    """The host-side schedule around `train_step`.

    `split_noise(iteration)` may return the (2, >= N, 3) standard normal
    rows of a densification event's split; by default they are drawn from
    a torch.Generator seeded with the iteration (the reference keys its
    noise by the iteration too, with JAX's generator)."""

    def __init__(self, scene, state: G.GaussianState, opt, pipe, model_params, background=None,
                 split_noise: Optional[Callable[[int], torch.Tensor]] = None):
        self.scene = scene
        self.state = state
        self.opt = opt
        self.pipe = pipe
        self.model_params = model_params
        self.device = state.device
        self.max_sh_degree = model_params.sh_degree
        self.active_sh_degree = 0
        bg = [1.0, 1.0, 1.0] if model_params.white_background else [0.0, 0.0, 0.0]
        self.bg = torch.tensor(background if background is not None else bg, dtype=torch.float32,
                               device=self.device)
        self.xyz_sched = make_lr_schedule(opt, scene.cameras_extent)
        self.xyz_lr = self.xyz_sched(0)
        self.viewpoint_stack = []
        self.rng = random.Random(getattr(opt, "seed", 1))
        self.backend = getattr(pipe, "raster_backend", "auto")
        self.ema_loss = torch.zeros((), device=self.device)
        self.split_noise = split_noise
        self.logger = None  # set via attach_logger
        self.last_camera = None  # the train view of the last step
        self._on_device = {}  # id(camera) -> (RasterCamera, gt image) on the device

    def pick_camera(self):
        if not self.viewpoint_stack:
            self.viewpoint_stack = list(self.scene.getTrainCameras())
        self.last_camera = self.viewpoint_stack.pop(self.rng.randint(0, len(self.viewpoint_stack) - 1))
        return self.last_camera

    def camera_on_device(self, cam):
        """The camera's RasterCamera and ground-truth image on the device,
        copied once."""
        key = id(cam)
        if key not in self._on_device:
            self._on_device[key] = (
                cam.raster_camera(self.device),
                torch.from_numpy(np.ascontiguousarray(cam.image, np.float32)).to(self.device),
            )
        return self._on_device[key]

    def write_checkpoint(self, path: str, iteration: int) -> None:
        save_checkpoint(path, self.state, iteration)
        print(f"[ITER {iteration}] saved checkpoint {path}")

    def attach_logger(self, logger):
        self.logger = logger

    def step(self, iteration: int) -> StepStats:
        with span("train.step"):
            return self._step(iteration)

    def _step(self, iteration: int) -> StepStats:
        opt = self.opt
        if iteration % 500 == 0 and self.active_sh_degree < self.max_sh_degree:
            self.active_sh_degree += 1

        rc, gt = self.camera_on_device(self.pick_camera())
        do_densify = (
            iteration < opt.densify_until_iter
            and iteration > opt.densify_from_iter
            and iteration % opt.densification_interval == 0
        )
        apply_adam = (iteration < opt.iterations) and not do_densify
        update_stats = iteration < opt.densify_until_iter

        metrics = train_step(
            self.state, rc, gt, self.bg, lrs_for(opt, self.xyz_lr), self.active_sh_degree,
            sh_degree=self.max_sh_degree,
            lambda_dssim=opt.lambda_dssim,
            use_confidence=getattr(self.pipe, "use_confidence", False),
            backend=self.backend,
            apply_adam=apply_adam,
            update_stats=update_stats,
        )

        if do_densify:
            self.densify(iteration)
        self.xyz_lr = self.xyz_sched(iteration)
        if iteration % opt.opacity_reset_interval == 0:
            G.reset_opacity(self.state)

        self.ema_loss = 0.4 * metrics["loss"] + 0.6 * self.ema_loss
        return StepStats(loss=metrics["loss"], l1=metrics["l1"], psnr=metrics["psnr"],
                         num_active=self.state.num_gaussians, num_instances=metrics["num_instances"])

    def densify(self, iteration: int) -> None:
        with span("train.densify"):
            cfg = densify_cfg(self.opt, self.scene.cameras_extent, iteration)
            noise = None if self.split_noise is None else self.split_noise(iteration)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(iteration)
            G.densify_and_prune(self.state, cfg, noise=noise, generator=gen)

    @torch.no_grad()
    def check_finite(self, iteration: int, snapshot, checkpoint_dir) -> None:
        """Raise after writing `nan_<it0>_<it>.ckpt` (the state before
        iteration it0 + 1) and `.json` (the steps since, each with its xyz
        lr, camera and SH degree) when xyz, opacity or scaling holds a
        non-finite value."""
        p = self.state.params
        if all(bool(torch.isfinite(t).all()) for t in (p.xyz, p.opacity, p.scaling)):
            return
        it0, arrays, schedule = snapshot
        stem = os.path.join(checkpoint_dir or ".", f"nan_{it0}_{iteration}")
        write_checkpoint_arrays(stem + ".ckpt", arrays)
        with open(stem + ".json", "w") as f:
            json.dump({"it0": it0, "it1": iteration, "schedule": schedule,
                       "densification_interval": self.opt.densification_interval}, f, indent=1)
        raise RuntimeError(f"non-finite parameters after iteration {iteration}; the state before "
                           f"iteration {it0 + 1} and the schedule since are in {stem}.ckpt / .json")

    @torch.no_grad()
    def evaluate(self, cameras, max_cams: Optional[int] = None):
        """Mean PSNR and L1 of the clamped renders over a camera list."""
        psnrs, l1s = [], []
        for cam in cameras[: max_cams or len(cameras)]:
            rc, gt = self.camera_on_device(cam)
            r = render_gaussians(self.state.params, rc, self.bg, self.active_sh_degree,
                                 backend=self.backend)
            img = torch.clamp(r.color, 0.0, 1.0)
            psnrs.append(float(psnr(img, gt)[0, 0]))
            l1s.append(float(l1_loss(img, gt)))
        return {"psnr": float(np.mean(psnrs)), "l1": float(np.mean(l1s))} if psnrs else {}

    def log_scalars(self, stats: StepStats) -> dict:
        """The scalars `train` logs every log_every steps (as train/<name>)."""
        return {"loss": float(stats.loss), "l1": float(stats.l1), "psnr": float(stats.psnr),
                "total_points": stats.num_active}

    def train(
        self,
        iterations=None,
        log_every=100,
        test_iterations=(),
        saving_iterations=(),
        checkpoint_iterations=(),
        checkpoint_dir=None,
        start_iteration=0,
        nan_debug=False,
        profile_dir=None,
    ):
        """The host schedule: steps, evaluation at test_iterations, ply
        snapshots, full checkpoints; with `nan_debug` the non-finite check
        of every step (see the module's docstring); with `profile_dir` a
        torch.profiler trace of the steps of PROFILE_WINDOW after the start,
        written when the window or the run ends."""
        iterations = iterations or self.opt.iterations
        t0 = time.time()
        snapshot = None
        prof = None
        for it in range(start_iteration + 1, iterations + 1):
            if it - start_iteration == PROFILE_WINDOW[0]:
                prof = maybe_profiler_trace(profile_dir, True)
            if nan_debug and (snapshot is None or (it - 1) % self.opt.densification_interval == 0):
                arrays = checkpoint_arrays(self.state, it - 1)
                if self.device.type == "cpu":  # there the arrays share the live tensors' memory
                    arrays = {k: v.copy() for k, v in arrays.items()}
                snapshot = (it - 1, arrays, [])
            if nan_debug:
                sched = dict(iteration=it, xyz_lr=float(self.xyz_lr))
            stats = self.step(it)
            if prof is not None and it - start_iteration == PROFILE_WINDOW[1]:
                self._stop_trace(profile_dir, prof)
                prof = None
            if nan_debug:
                sched.update(camera=getattr(self.last_camera, "image_name", ""),
                             sh_degree=self.active_sh_degree, num_gaussians=self.state.num_gaussians)
                snapshot[2].append(sched)
                self.check_finite(it, snapshot, checkpoint_dir)
            if log_every and it % log_every == 0:
                rate = (it - start_iteration) / (time.time() - t0)
                print(
                    f"[{it}/{iterations}] loss={float(self.ema_loss):.5f} psnr={float(stats.psnr):.2f} "
                    f"n={stats.num_active} {rate:.1f} it/s",
                    flush=True,
                )
                if self.logger is not None:
                    self.logger.scalars(it, {**self.log_scalars(stats), "it_per_s": rate}, prefix="train/")
            if it in test_iterations:
                m = self.evaluate(self.scene.getTestCameras())
                if m:
                    print(f"[ITER {it}] test psnr {m['psnr']:.3f} l1 {m['l1']:.4f}", flush=True)
                    if self.logger is not None:
                        self.logger.scalars(it, m, prefix="test/")
                mt = self.evaluate(self.scene.getTrainCameras())
                if mt and self.logger is not None:
                    self.logger.scalars(it, mt, prefix="train_eval/")
                if self.logger is not None:
                    self.logger.histogram(it, "opacity", self.state.params.get_opacity.detach().cpu().numpy())
            if it in saving_iterations:
                self.scene.save(it, self.state)
            if it in checkpoint_iterations and checkpoint_dir:
                self.write_checkpoint(f"{checkpoint_dir}/chkpnt{it}.ckpt", it)
        if prof is not None:
            self._stop_trace(profile_dir, prof)
        return self.state

    def _stop_trace(self, profile_dir: str, prof) -> None:
        """The device's queued work done, the trace written."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        maybe_profiler_trace(profile_dir, False, prof)
