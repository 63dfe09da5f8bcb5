"""A training step over a batch of cameras, on one device or over a mesh.

Counterpart of `guidedvd3dgs_tpu/parallel/data_parallel.py`: B cameras
render the same Gaussians, their losses are averaged and one backward pass
and one Adam step follow. The densification statistics are the per-camera
sums, as B reference iterations that share one optimizer step would count
them. The B renders run the kernels B times in one autograd graph (K1, K3,
K4 forward; K5, K6, K2 backward). `make_dp_train_step` splits the cameras
over a mesh's data axis: each device renders its cameras from a copy of
the parameters, and autograd brings the gradients back to the state's
device (JAX's XLA all-reduce over the replicated state).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch

from guidedvd3dgs_tpu_torch.models import gaussians as G
from guidedvd3dgs_tpu_torch.models.render import render_gaussians
from guidedvd3dgs_tpu_torch.ops.projection import RasterCamera
from guidedvd3dgs_tpu_torch.parallel.mesh import Mesh, device_scope
from guidedvd3dgs_tpu_torch.utils.losses import l1_loss, psnr, ssim


def stack_cameras(cams: Sequence[RasterCamera]) -> RasterCamera:
    """The cameras as one RasterCamera whose fields have a leading batch
    axis (the tangents of the fields of view as (B,) float64 tensors). All
    must share (height, width)."""
    hw = {(c.height, c.width) for c in cams}
    if len(hw) != 1:
        raise ValueError(f"batched cameras must share resolution, got {hw}")
    c0 = cams[0]
    return RasterCamera(
        viewmatrix=torch.stack([c.viewmatrix for c in cams]),
        projmatrix=torch.stack([c.projmatrix for c in cams]),
        campos=torch.stack([c.campos for c in cams]),
        tanfovx=torch.tensor([c.tanfovx for c in cams], dtype=torch.float64),
        tanfovy=torch.tensor([c.tanfovy for c in cams], dtype=torch.float64),
        height=c0.height,
        width=c0.width,
    )


def camera_at(cams: RasterCamera, i: int) -> RasterCamera:
    """Camera `i` of a stacked batch."""
    return dataclasses.replace(cams, viewmatrix=cams.viewmatrix[i], projmatrix=cams.projmatrix[i],
                               campos=cams.campos[i], tanfovx=float(cams.tanfovx[i]),
                               tanfovy=float(cams.tanfovy[i]))


class _ParamsOn(NamedTuple):
    """A device's copy of the Gaussian parameters, differentiable back to
    the originals (render_gaussians reads these six fields)."""

    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor


def _camera_on(cams: RasterCamera, i: int, device: torch.device) -> RasterCamera:
    cam = camera_at(cams, i)
    return dataclasses.replace(cam, viewmatrix=cam.viewmatrix.to(device),
                               projmatrix=cam.projmatrix.to(device), campos=cam.campos.to(device))


def _step_over(
    devices: Sequence[torch.device],
    state: G.GaussianState,
    cams: RasterCamera,
    gt_images: torch.Tensor,
    bg: torch.Tensor,
    lrs: G.LearningRates,
    sh_degree: int,
    lambda_dssim: float,
    use_confidence: bool,
    backend: str,
    apply_adam: bool,
    update_stats: bool,
) -> dict:
    """The step of `train_step_dp` with the B cameras split in order over
    `devices` (B divisible by their number): each device renders and scores
    its cameras from its copy of the parameters (the parameters themselves
    on the state's device), the losses and statistics meet on the state's
    device, and one backward pass there carries every device's gradients
    home through autograd."""
    batch, home = gt_images.shape[0], state.device
    if batch % len(devices):
        raise ValueError(f"{batch} cameras do not split over {len(devices)} devices")
    per = batch // len(devices)
    losses, l1s, psnrs, offsets, renders = [], [], [], [], []
    for j, dev in enumerate(devices):
        with device_scope(dev):
            params = _ParamsOn(*(getattr(state.params, n).to(dev) for n in G.PARAM_NAMES))
            conf, bg_d = state.confidence.to(dev), bg.to(dev)
            for b in range(j * per, (j + 1) * per):
                offset = torch.zeros((state.num_gaussians, 2), device=dev, requires_grad=True)
                r = render_gaussians(params, _camera_on(cams, b, dev), bg_d, sh_degree, means2d_offset=offset,
                                     confidence=conf, use_confidence=use_confidence, backend=backend)
                gt = gt_images[b].to(dev)
                ll1 = l1_loss(r.color, gt)
                loss = (1.0 - lambda_dssim) * ll1 + lambda_dssim * (1.0 - ssim(r.color, gt))
                losses.append(loss.to(home))
                l1s.append(ll1.detach().to(home))
                with torch.no_grad():
                    psnrs.append(psnr(r.color, gt)[0, 0].to(home))
                offsets.append(offset)
                renders.append(r)
    loss = torch.stack(losses).mean()
    state.params.zero_grad(set_to_none=True)
    loss.backward()
    if update_stats:
        with torch.no_grad():
            vis = torch.stack([r.visibility_filter.to(home) for r in renders])  # (B, N)
            gnorm = torch.stack([torch.linalg.norm(o.grad[:, :2], dim=-1).to(home) for o in offsets]) * batch
            state.xyz_gradient_accum += torch.where(vis, gnorm, torch.zeros_like(gnorm)).sum(0)[:, None]
            state.denom += vis.sum(0).to(state.denom.dtype)[:, None]
            radii = torch.stack([r.radii.to(home, torch.float32) for r in renders])
            state.max_radii2d = torch.maximum(
                state.max_radii2d, torch.where(vis, radii, torch.zeros_like(radii)).amax(0))
    if apply_adam:
        G.adam_step(state, {n: getattr(state.params, n).grad for n in G.PARAM_NAMES}, lrs)
    return {"loss": loss.detach(), "l1": torch.stack(l1s).mean(), "psnr": torch.stack(psnrs).mean()}


def train_step_dp(
    state: G.GaussianState,
    cams: RasterCamera,  # stacked: fields with a leading axis B
    gt_images: torch.Tensor,  # (B, 3, H, W)
    bg: torch.Tensor,  # (3,)
    lrs: G.LearningRates,
    sh_degree: int,
    lambda_dssim: float,
    use_confidence: bool = False,
    backend: str = "auto",
    apply_adam: bool = True,
    update_stats: bool = True,
) -> dict:
    """One step over B cameras, updating `state` in place: loss = the mean
    over the cameras of (1 - l) L1 + l (1 - SSIM), one backward pass; the
    viewspace gradient norms rescaled by B (the mean scales each camera's
    gradient by 1/B against the reference's per-camera backward) and summed
    where each camera sees the Gaussian, the visible counts summed, the max
    radii over the batch; one Adam step. Returns the metrics (loss, the mean
    l1 and psnr, as device tensors)."""
    return _step_over((state.device,), state, cams, gt_images, bg, lrs, sh_degree, lambda_dssim,
                      use_confidence, backend, apply_adam, update_stats)


def make_dp_train_step(mesh: Mesh, sh_degree: int, lambda_dssim: float, use_confidence: bool = False,
                       backend: str = "auto"):
    """`train_step_dp` over the mesh's data axis (JAX data_parallel.py:
    105-130): step(state, cams, gt_images, bg, lrs) splits the camera batch
    and its images in order over the data devices, each renders and scores
    its cameras from a copy of the parameters, and the gradients, Adam and
    the densification statistics meet on the state's device, which should
    be the mesh's home."""

    def step(state: G.GaussianState, cams: RasterCamera, gt_images: torch.Tensor, bg: torch.Tensor,
             lrs: G.LearningRates) -> dict:
        return _step_over(mesh.data_devices, state, cams, gt_images, bg, lrs, sh_degree, lambda_dssim,
                          use_confidence, backend, True, True)

    return step
