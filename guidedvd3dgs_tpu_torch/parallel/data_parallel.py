"""A training step over a batch of cameras, on one device.

Counterpart of `guidedvd3dgs_tpu/parallel/data_parallel.py`'s
`stack_cameras` and `train_step_dp`: B cameras render the same Gaussians,
their losses are averaged and one backward pass and one Adam step follow.
The densification statistics are the per-camera sums, as B reference
iterations that share one optimizer step would count them. The B renders
run the kernels B times in one autograd graph (K1, K3, K4 forward; K5, K6,
K2 backward). The JAX package's `make_dp_train_step`, which shards the
batch over a device mesh, waits for a multi-card host.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from guidedvd3dgs_tpu_torch.models import gaussians as G
from guidedvd3dgs_tpu_torch.models.render import render_state
from guidedvd3dgs_tpu_torch.ops.projection import RasterCamera
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
    batch = gt_images.shape[0]
    losses, l1s, psnrs, offsets, renders = [], [], [], [], []
    for b in range(batch):
        offset = torch.zeros((state.num_gaussians, 2), device=state.device, requires_grad=True)
        r = render_state(state, camera_at(cams, b), bg, sh_degree, means2d_offset=offset,
                         use_confidence=use_confidence, backend=backend)
        ll1 = l1_loss(r.color, gt_images[b])
        losses.append((1.0 - lambda_dssim) * ll1 + lambda_dssim * (1.0 - ssim(r.color, gt_images[b])))
        l1s.append(ll1.detach())
        with torch.no_grad():
            psnrs.append(psnr(r.color, gt_images[b])[0, 0])
        offsets.append(offset)
        renders.append(r)
    loss = torch.stack(losses).mean()
    state.params.zero_grad(set_to_none=True)
    loss.backward()
    if update_stats:
        with torch.no_grad():
            vis = torch.stack([r.visibility_filter for r in renders])  # (B, N)
            gnorm = torch.stack([torch.linalg.norm(o.grad[:, :2], dim=-1) for o in offsets]) * batch
            state.xyz_gradient_accum += torch.where(vis, gnorm, torch.zeros_like(gnorm)).sum(0)[:, None]
            state.denom += vis.sum(0).to(state.denom.dtype)[:, None]
            radii = torch.stack([r.radii.to(torch.float32) for r in renders])
            state.max_radii2d = torch.maximum(
                state.max_radii2d, torch.where(vis, radii, torch.zeros_like(radii)).amax(0))
    if apply_adam:
        G.adam_step(state, {n: getattr(state.params, n).grad for n in G.PARAM_NAMES}, lrs)
    return {"loss": loss.detach(), "l1": torch.stack(l1s).mean(), "psnr": torch.stack(psnrs).mean()}
