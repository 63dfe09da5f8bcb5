"""Dense (all Gaussians against all pixels) rasterizer: the oracle.

Counterpart of `guidedvd3dgs_tpu/ops/raster_dense.py`, in plain torch with
the same blend semantics: depth-sorted front-to-back compositing, alpha
clamp 0.99, contribution threshold 1/255, termination when T would fall
below 1e-4 (the instance that triggers it is not added), a Gaussian only
touching the 16x16 tiles of its radius rectangle. The per-pixel recurrence
is the reference's closed form over chunks of 256 Gaussians (masked
cumulative sums of log transmittance). O(N * P) work: for tests and tiny
scenes, and for an explicit `backend="dense"`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from guidedvd3dgs_tpu_torch.ops.projection import (
    ALPHA_EPS,
    ALPHA_MAX,
    T_EPS,
    ProcessedGaussians,
    RasterCamera,
    preprocess_gaussians,
)

TILE = 16


class RenderOutput(NamedTuple):
    color: torch.Tensor  # (3, H, W)
    depth: torch.Tensor  # (H, W) accumulated (unnormalized) depth
    alpha: torch.Tensor  # (H, W) accumulated alpha weight
    radii: torch.Tensor  # (N,) int32
    visibility: torch.Tensor  # (N,) bool, radii > 0
    # tile backend only: instances dropped (always 0: buffers are sized
    # exactly) and the number of (Gaussian, tile) instances
    overflow: Optional[int] = None
    num_instances: Optional[int] = None


def _pixel_grid(height: int, width: int, device) -> torch.Tensor:
    ys = torch.arange(height, dtype=torch.float32, device=device)
    xs = torch.arange(width, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)  # (P, 2) as (x, y)


def _chunk_alphas(means2d, conics, opacities, active, pix, radii, grid_wh):
    gx, gy = grid_wh
    r = radii.to(means2d.dtype)
    rminx = torch.clamp(((means2d[:, 0] - r) / TILE).to(torch.int32), 0, gx)
    rminy = torch.clamp(((means2d[:, 1] - r) / TILE).to(torch.int32), 0, gy)
    rmaxx = torch.clamp(((means2d[:, 0] + r + TILE - 1) / TILE).to(torch.int32), 0, gx)
    rmaxy = torch.clamp(((means2d[:, 1] + r + TILE - 1) / TILE).to(torch.int32), 0, gy)
    ptx = (pix[:, 0] / TILE).to(torch.int32)
    pty = (pix[:, 1] / TILE).to(torch.int32)
    in_rect = (
        (ptx[None, :] >= rminx[:, None])
        & (ptx[None, :] < rmaxx[:, None])
        & (pty[None, :] >= rminy[:, None])
        & (pty[None, :] < rmaxy[:, None])
    )
    d = means2d[:, None, :] - pix[None, :, :]  # (K, P, 2)
    dx, dy = d[..., 0], d[..., 1]
    a, b, c = conics[:, 0:1], conics[:, 1:2], conics[:, 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    # exp(power + log(op)), as the reference oracle computes it
    araw = torch.exp(power + torch.log(torch.clamp(opacities[:, None], min=1e-37)))
    alpha = torch.clamp(araw, max=ALPHA_MAX)
    live = (power <= 0.0) & (araw >= ALPHA_EPS) & active[:, None] & in_rect
    return torch.where(live, alpha, torch.zeros_like(alpha))  # (K, P)


def _blend_chunk(carry, chunk_vals, pix, grid_wh):
    T_in, done_in, acc_c, acc_d, acc_a = carry
    means2d, conics, opacities, colors, depths, active, radii = chunk_vals

    alpha = _chunk_alphas(means2d, conics, opacities, active, pix, radii, grid_wh)
    one_minus = 1.0 - alpha
    log_om = torch.log(torch.clamp(one_minus, min=1e-12))
    cum = torch.cumsum(log_om, dim=0)
    T_before = T_in[None, :] * torch.exp(cum - log_om)
    T_after = T_before * one_minus

    trigger = (alpha > 0.0) & (T_after < T_EPS)
    done_before = torch.cat(
        [done_in[None, :], done_in[None, :] | (torch.cumsum(trigger.int(), dim=0)[:-1] > 0)],
        dim=0,
    )
    include = (alpha > 0.0) & (~done_before) & (~trigger)

    w = torch.where(include, alpha * T_before, torch.zeros_like(alpha))  # (K, P)
    acc_c = acc_c + w.T @ colors
    acc_d = acc_d + w.T @ depths[:, None]
    acc_a = acc_a + w.sum(0)
    T_out = T_in * torch.exp(torch.where(include, log_om, torch.zeros_like(log_om)).sum(0))
    done_out = done_in | trigger.any(0)
    return (T_out, done_out, acc_c, acc_d, acc_a)


def rasterize_dense_processed(
    proc: ProcessedGaussians, cam: RasterCamera, bg: torch.Tensor, chunk: int = 256
) -> RenderOutput:
    """Blend already-preprocessed Gaussians: sort by view depth, then
    composite depth-ordered chunks onto every pixel."""
    n = proc.means2d.shape[0]
    height, width = cam.height, cam.width
    dev = proc.means2d.device
    pix = _pixel_grid(height, width, dev)
    p = pix.shape[0]

    active = proc.visible & (proc.radii > 0)
    sort_depth = torch.where(active, proc.depths, torch.full_like(proc.depths, float("inf")))
    order = torch.sort(sort_depth, stable=True).indices
    vals = [
        proc.means2d[order], proc.conics[order], proc.opacities[order],
        proc.colors[order], proc.depths[order], active[order], proc.radii[order],
    ]
    grid_wh = ((width + TILE - 1) // TILE, (height + TILE - 1) // TILE)
    carry = (
        torch.ones((p,), dtype=torch.float32, device=dev),
        torch.zeros((p,), dtype=torch.bool, device=dev),
        torch.zeros((p, 3), dtype=torch.float32, device=dev),
        torch.zeros((p, 1), dtype=torch.float32, device=dev),
        torch.zeros((p,), dtype=torch.float32, device=dev),
    )
    for c0 in range(0, n, chunk):
        carry = _blend_chunk(carry, [v[c0 : c0 + chunk] for v in vals], pix, grid_wh)
    T, _done, acc_c, acc_d, acc_a = carry

    color = (acc_c + T[:, None] * bg[None, :]).T.reshape(3, height, width)
    depth = acc_d[:, 0].reshape(height, width)
    alpha = acc_a.reshape(height, width)
    return RenderOutput(color, depth, alpha, proc.radii, proc.radii > 0)


def rasterize_dense(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    shs: Optional[torch.Tensor],
    cam: RasterCamera,
    bg: torch.Tensor,
    sh_degree: int = 3,
    scale_modifier: float = 1.0,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    chunk: int = 256,
    active_degree: Optional[int] = None,
) -> RenderOutput:
    """Full dense rasterization: preprocess + blend (forward only)."""
    proc = preprocess_gaussians(
        means3d, scales, rotations, opacities, shs, cam,
        sh_degree=sh_degree, scale_modifier=scale_modifier,
        colors_precomp=colors_precomp, cov3d_precomp=cov3d_precomp,
        active_degree=active_degree,
    )
    return rasterize_dense_processed(proc, cam, bg, chunk=chunk)
