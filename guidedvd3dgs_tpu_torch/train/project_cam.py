"""The baseline trainer with projection cameras.

Counterpart of `guidedvd3dgs_tpu/train/project_cam.py` (reference
train_replica_baseline_with_project_cam.py): when the view stack empties,
the next epoch takes the projection cameras with probability
1 - `project_cam_prob` (every 6th view of the trajectory, whose target is
the scene's point cloud projected to it, with the mask of the pixels a
point reached), else the train views. A projection camera is supervised
by `project_cam_weight` times the masked L1 of its projection, rendered
at the active SH degree; one without a projection, and every train view,
takes the baseline step. Each step renders once and takes the gradient,
so it launches K1-K6 once.
"""

from __future__ import annotations

import numpy as np
import torch

from guidedvd3dgs_tpu_torch.models import gaussians as G
from guidedvd3dgs_tpu_torch.models.render import render_state
from guidedvd3dgs_tpu_torch.ops.projection import RasterCamera
from guidedvd3dgs_tpu_torch.train.baseline import BaselineTrainer, StepStats, lrs_for, train_step
from guidedvd3dgs_tpu_torch.utils.losses import l1_loss_mask, psnr


def project_cam_step(
    state: G.GaussianState,
    cam: RasterCamera,
    projected_image: torch.Tensor,  # (3, H, W)
    mask: torch.Tensor,  # (H, W) or (1, H, W)
    weight: float,
    bg: torch.Tensor,
    lrs: G.LearningRates,
    sh_degree: int,
    use_confidence: bool = False,
    backend: str = "auto",
    apply_adam: bool = True,
    update_stats: bool = True,
) -> dict:
    """loss = weight * masked L1 of the render against the projection,
    updating `state` in place as `train_step` does. Returns the metrics
    (loss, l1, psnr against the projection as device tensors;
    num_instances)."""
    offset = torch.zeros((state.num_gaussians, 2), device=state.device, requires_grad=True)
    r = render_state(state, cam, bg, sh_degree, means2d_offset=offset, use_confidence=use_confidence,
                     backend=backend)
    ll1 = l1_loss_mask(r.color, projected_image, mask)
    loss = weight * ll1
    state.params.zero_grad(set_to_none=True)
    loss.backward()
    if update_stats:
        G.update_max_radii(state, r.radii, r.visibility_filter)
        G.add_densification_stats(state, offset.grad, r.visibility_filter)
    if apply_adam:
        G.adam_step(state, {n: getattr(state.params, n).grad for n in G.PARAM_NAMES}, lrs)
    with torch.no_grad():
        return {"loss": loss.detach(), "l1": ll1.detach(), "psnr": psnr(r.color, projected_image)[0, 0],
                "num_instances": r.num_instances}


class ProjectCamTrainer(BaselineTrainer):
    """BaselineTrainer whose epochs are drawn between the train views and
    the projection cameras by `np.random.default_rng(seed)`, one draw an
    epoch (the camera order stays the baseline's `random.Random`)."""

    def __init__(self, scene, state: G.GaussianState, opt, pipe, model_params, background=None):
        super().__init__(scene, state, opt, pipe, model_params, background)
        self.use_project_cam = False
        self.np_rng = np.random.default_rng(getattr(opt, "seed", 1))
        self.epochs = {"train": 0, "project": 0}
        self._projected = {}  # id(camera) -> (projection, mask) on the device

    def pick_camera(self):
        if not self.viewpoint_stack:
            project = self.scene.getProjectCameras()
            self.use_project_cam = self.np_rng.random() > self.opt.project_cam_prob and len(project) > 0
            self.viewpoint_stack = list(project if self.use_project_cam else self.scene.getTrainCameras())
            self.epochs["project" if self.use_project_cam else "train"] += 1
        return self.viewpoint_stack.pop(self.rng.randint(0, len(self.viewpoint_stack) - 1))

    def projection_on_device(self, cam):
        key = id(cam)
        if key not in self._projected:
            self._projected[key] = tuple(
                None if a is None else torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)
                for a in (cam.projected_image, cam.projected_mask))
        return self._projected[key]

    def _step(self, iteration: int) -> StepStats:
        opt = self.opt
        if iteration % 500 == 0 and self.active_sh_degree < self.max_sh_degree:
            self.active_sh_degree += 1

        cam = self.pick_camera()
        rc, gt = self.camera_on_device(cam)
        do_densify = (
            iteration < opt.densify_until_iter
            and iteration > opt.densify_from_iter
            and iteration % opt.densification_interval == 0
        )
        common = dict(use_confidence=getattr(self.pipe, "use_confidence", False), backend=self.backend,
                      apply_adam=(iteration < opt.iterations) and not do_densify,
                      update_stats=iteration < opt.densify_until_iter)
        if self.use_project_cam and cam.projected_image is not None:
            image, mask = self.projection_on_device(cam)
            metrics = project_cam_step(self.state, rc, image, mask, opt.project_cam_weight, self.bg,
                                       lrs_for(opt, self.xyz_lr), self.active_sh_degree, **common)
        else:
            metrics = train_step(self.state, rc, gt, self.bg, lrs_for(opt, self.xyz_lr),
                                 self.active_sh_degree, sh_degree=self.max_sh_degree,
                                 lambda_dssim=opt.lambda_dssim, **common)

        if do_densify:
            self.densify(iteration)
        self.xyz_lr = self.xyz_sched(iteration)
        if iteration % opt.opacity_reset_interval == 0:
            G.reset_opacity(self.state)

        self.ema_loss = 0.4 * metrics["loss"] + 0.6 * self.ema_loss
        return StepStats(loss=metrics["loss"], l1=metrics["l1"], psnr=metrics["psnr"],
                         num_active=self.state.num_gaussians, num_instances=metrics["num_instances"])
