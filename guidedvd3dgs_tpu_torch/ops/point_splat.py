"""Forward-only z-buffered point splatting.

Counterpart of `guidedvd3dgs_tpu/ops/point_splat.py` (plain jnp there, no
Pallas): the scene's point cloud rendered along a trajectory as the
diffusion model's conditioning (reference pvd_utils.py:288-304, a
pytorch3d PointsRasterizer of NDC radius 0.01 with an AlphaCompositor).
Each point is projected to its nearest pixel and covers a square of
2 r + 1 pixels a side (r = round(0.01 min(H, W) / 2)); visibility is a
two-pass z-buffer of `scatter_reduce("amin")` into one dump slot past the
image: the least depth per pixel, then the least index among the points
at that depth (the lowest index wins a tie). Rounding is half to even in
both packages (`jnp.round`, `torch.round`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

_BIG = torch.finfo(torch.float32).max
_IMAX = 2 ** 31 - 1


class SplatOutput(NamedTuple):
    image: torch.Tensor  # (H, W, 3)
    depth: torch.Tensor  # (H, W) z of the winning point (inf where empty)
    mask: torch.Tensor  # (H, W) bool, a point won the pixel


def _radius_px(radius_ndc: float, height: int, width: int) -> int:
    return max(int(round(radius_ndc * min(height, width) * 0.5)), 0)


def _to_camera(points_world: torch.Tensor, w2c: torch.Tensor) -> torch.Tensor:
    w2c = w2c.to(points_world)
    return points_world @ w2c[:3, :3].T + w2c[:3, 3]


def _project(points_cam, fx, fy, cx, cy, near, point_mask=None):
    """(z, valid, ix, iy) of camera-space points."""
    z = points_cam[:, 2]
    valid = z > near
    if point_mask is not None:
        valid = valid & point_mask
    zs = torch.where(valid, z, torch.ones_like(z))
    ix = torch.round(points_cam[:, 0] / zs * fx + cx).to(torch.int32)
    iy = torch.round(points_cam[:, 1] / zs * fy + cy).to(torch.int32)
    return z, valid, ix, iy


def _footprint(ix, iy, valid, r_pix: int, height: int, width: int):
    """(linear pixel index or the dump slot H*W, in bounds) of each point's
    pixel at each offset of its square, dy major."""
    npix = height * width
    for dy in range(-r_pix, r_pix + 1):
        for dx in range(-r_pix, r_pix + 1):
            tx, ty = ix + dx, iy + dy
            inb = valid & (tx >= 0) & (tx < width) & (ty >= 0) & (ty < height)
            yield torch.where(inb, ty * width + tx, npix).long(), inb


def _depth_buffer(z, ix, iy, valid, r_pix, height, width) -> torch.Tensor:
    """(H*W + 1,) least depth per pixel (_BIG where none; the last slot
    is the dump)."""
    dbuf = torch.full((height * width + 1,), _BIG, dtype=torch.float32, device=z.device)
    big = torch.full_like(z, _BIG)
    for lin, inb in _footprint(ix, iy, valid, r_pix, height, width):
        dbuf.scatter_reduce_(0, lin, torch.where(inb, z, big), "amin")
    return dbuf


def splat_points(
    points_cam: torch.Tensor,  # (N, 3) camera space, +z forward
    colors: torch.Tensor,  # (N, 3)
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    height: int,
    width: int,
    radius_ndc: float = 0.01,
    background: Optional[torch.Tensor] = None,
    near: float = 1e-4,
    point_mask: Optional[torch.Tensor] = None,
) -> SplatOutput:
    """Pinhole-project and z-buffer splat; `point_mask` (N,) bool leaves
    points out."""
    z, valid, ix, iy = _project(points_cam, fx, fy, cx, cy, near, point_mask)
    r_pix = _radius_px(radius_ndc, height, width)
    npix = height * width
    dbuf = _depth_buffer(z, ix, iy, valid, r_pix, height, width)
    idx = torch.arange(z.shape[0], dtype=torch.int32, device=z.device)
    imax = torch.full_like(idx, _IMAX)
    ibuf = torch.full((npix + 1,), _IMAX, dtype=torch.int32, device=z.device)
    for lin, inb in _footprint(ix, iy, valid, r_pix, height, width):
        winner = inb & (z == dbuf[lin])
        ibuf.scatter_reduce_(0, lin, torch.where(winner, idx, imax), "amin")
    ibuf = ibuf[:npix]
    hit = ibuf != _IMAX
    win = torch.where(hit, ibuf, torch.zeros_like(ibuf)).long()
    img = torch.where(hit[:, None], colors[win], torch.zeros((), dtype=colors.dtype, device=colors.device))
    if background is not None:
        img = torch.where(hit[:, None], img, background.to(img)[None, :])
    dep = torch.where(hit, z[win], torch.full_like(z[win], float("inf")))
    return SplatOutput(image=img.reshape(height, width, 3), depth=dep.reshape(height, width),
                       mask=hit.reshape(height, width))


def splat_points_world(points_world: torch.Tensor, colors: torch.Tensor, w2c: torch.Tensor,
                       intrinsics: torch.Tensor, height: int, width: int, **kwargs) -> SplatOutput:
    """splat_points of world points through w2c (4, 4; x' = R x + t) and
    intrinsics K (3, 3)."""
    k = intrinsics.detach().cpu().to(torch.float32)
    return splat_points(_to_camera(points_world, w2c), colors, fx=float(k[0, 0]), fy=float(k[1, 1]),
                        cx=float(k[0, 2]), cy=float(k[1, 2]), height=height, width=width, **kwargs)


def visible_points_mask(
    points_world: torch.Tensor,  # (N, 3)
    w2c: torch.Tensor,  # (4, 4)
    intrinsics: torch.Tensor,  # (3, 3)
    height: int,
    width: int,
    radius_ndc: float = 0.01,
    tol: float = 0.02,
    near: float = 1e-4,
) -> torch.Tensor:
    """(N,) bool: the points inside the view whose depth is within `tol`
    (relative) of the z-buffer's least depth at their own pixel (the
    z-buffer of the splat's footprint). It stands in for the reference's
    per-view pointmap: the scene cloud as seen from one view."""
    k = intrinsics.detach().cpu().to(torch.float32)
    z, valid, ix, iy = _project(_to_camera(points_world, w2c), float(k[0, 0]), float(k[1, 1]),
                                float(k[0, 2]), float(k[1, 2]), near)
    inb = valid & (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
    npix = height * width
    dbuf = _depth_buffer(z, ix, iy, valid, _radius_px(radius_ndc, height, width), height, width)
    win = dbuf[torch.where(inb, iy * width + ix, npix - 1).long()]
    return inb & (z <= win * (1.0 + tol) + 1e-6)
