"""The plain reference's Gaussian rasterizer: differentiable by autograd,
with the rule of the CUDA original as the port states it.

  preprocess   projection.py (a frozen copy of the port's plain preprocess)
  binning      the tight tile rectangles of each Gaussian (a frozen copy of
               the port's `ops/tiling.py::tile_rects`), one instance a
               (Gaussian, tile), the tile cull of the alpha >= 1/255 level
               set (the port's plain K3), one stable sort of the 64-bit keys
               tile << 32 | depth bits
  blend        per 16 x 16 tile, front to back: power = -0.5 (a dx^2 +
               c dy^2) - b dx dy, skipped if > 0; alpha = min(0.99, op
               exp(power)), skipped if < 1/255; a pixel stops before the
               instance that would take T below 1e-4; colour, depth and 1
               accumulate with weight alpha T; colour + T bg

in batches of tiles, each recomputed in the backward (activation
checkpointing). The backward passes the 0.99 clamp through, as the CUDA
original does (a straight-through clamp here). Besides the images it
returns the counts the kernels' least times are made of (`Counts`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from .projection import ALPHA_EPS, ALPHA_MAX, T_EPS, RasterCamera, preprocess_field_rows

TILE = 16
TILE_PIX = TILE * TILE
BATCH_ELEMS = 1 << 23  # (tiles x instances x 256) elements of one tile batch
_INT_SAFE = float(2**30)


def world_view(R: np.ndarray, T: np.ndarray) -> np.ndarray:
    """getWorld2View2 (the 3DGS original's) without recentring, transposed."""
    rt = np.zeros((4, 4))
    rt[:3, :3] = R.transpose()
    rt[:3, 3] = T
    rt[3, 3] = 1.0
    return np.float32(rt).T


def camera(R: np.ndarray, T: np.ndarray, fovx: float, fovy: float, width: int, height: int,
           device, dtype=torch.float32) -> RasterCamera:
    """The camera as the rasterizer takes it: transposed world-to-view and
    full projection (the original's pinhole form), centre, tan half-FOVs;
    its tensors in `dtype`."""
    wv = world_view(R, T)
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = 1.0 / math.tan(fovx / 2)
    proj[1, 1] = 1.0 / math.tan(fovy / 2)
    proj[2, 2] = proj[3, 2] = 1.0
    proj = proj.T
    full = (wv @ proj).astype(np.float32)
    center = np.linalg.inv(wv)[3, :3].astype(np.float32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device, dtype)
    return RasterCamera(dev(wv), dev(full), dev(center), math.tan(fovx / 2), math.tan(fovy / 2), height, width)


class Counts(NamedTuple):
    """What one render's kernels work on: Gaussians, those in some tile,
    all expanded (Gaussian, tile) instances (culled ones included), the
    tiles, the pixels, and the (instance, pixel) pairs the blend evaluates:
    blended, and walked without blending, inside the image."""

    gaussians: int
    binned: int
    instances: int
    tiles: int
    pixels: int
    blended: int
    walked: int


class Render(NamedTuple):
    color: torch.Tensor  # (3, H, W)
    depth: torch.Tensor
    alpha: torch.Tensor
    radii: torch.Tensor  # (N,) int32
    visible: torch.Tensor  # (N,) bool, radii > 0
    counts: Counts


def _to_i32(x):
    return torch.clamp(x, -_INT_SAFE, _INT_SAFE).to(torch.int32)


def tile_rects(x, y, radii, ext_x, ext_y, width: int, height: int):
    gx = (width + TILE - 1) // TILE
    gy = (height + TILE - 1) // TILE
    rmx = torch.clamp(_to_i32(torch.floor((x - ext_x) / TILE)), 0, gx)
    rmy = torch.clamp(_to_i32(torch.floor((y - ext_y) / TILE)), 0, gy)
    rxx = torch.clamp(_to_i32(torch.floor((x + ext_x) / TILE)) + 1, 0, gx)
    rxy = torch.clamp(_to_i32(torch.floor((y + ext_y) / TILE)) + 1, 0, gy)
    r = radii.to(torch.float32)
    rmx = torch.maximum(rmx, torch.clamp(_to_i32((x - r) / TILE), 0, gx))
    rmy = torch.maximum(rmy, torch.clamp(_to_i32((y - r) / TILE), 0, gy))
    rxx = torch.minimum(rxx, torch.clamp(_to_i32((x + r + TILE - 1) / TILE), 0, gx))
    rxy = torch.minimum(rxy, torch.clamp(_to_i32((y + r + TILE - 1) / TILE), 0, gy))
    w = torch.clamp(rxx - rmx, min=0)
    h = torch.clamp(rxy - rmy, min=0)
    count = torch.where(radii > 0, w * h, torch.zeros_like(w))
    return rmx, rmy, w, count, gx, gy


@torch.no_grad()
def bin_instances(f: torch.Tensor, radii, ext_x, ext_y, width: int, height: int):
    """(owner of each sorted binned instance, tile start, tile count,
    expanded instances, binned Gaussians, grid_x, grid_y). f: the (10, N)
    field rows."""
    rmx, rmy, w, count, gx, gy = tile_rects(f[0], f[1], radii, ext_x, ext_y, width, height)
    n, num_tiles = f.shape[1], gx * gy
    total = int(count.sum())
    dev = f.device
    owners = torch.repeat_interleave(torch.arange(n, device=dev), count.long(), output_size=total)
    offsets = torch.cumsum(count.long(), 0) - count.long()
    s = torch.arange(total, device=dev) - offsets[owners]
    ww = w[owners].long()
    q = torch.div(s, ww, rounding_mode="floor")
    tx = rmx[owners].long() + (s - q * ww)
    ty = rmy[owners].long() + q
    tile = ty * gx + tx
    mx, my, ca, cb, cc, op = (f[i][owners] for i in range(6))
    # the tile cull: the alpha >= 1/255 ellipse misses the tile's rectangle
    ex0 = tx.float() * 16.0 - mx
    ex1 = ex0 + 15.0
    ey0 = ty.float() * 16.0 - my
    ey1 = ey0 + 15.0
    inside = (ex0 <= 0.0) & (0.0 <= ex1) & (ey0 <= 0.0) & (0.0 <= ey1)
    caf, ccf = torch.clamp(ca, min=1e-12), torch.clamp(cc, min=1e-12)

    def qv(dx, dy):
        return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

    minq = torch.minimum(torch.minimum(qv(ex0, torch.clamp(-cb * ex0 / ccf, ey0, ey1)),
                                       qv(ex1, torch.clamp(-cb * ex1 / ccf, ey0, ey1))),
                         torch.minimum(qv(torch.clamp(-cb * ey0 / caf, ex0, ex1), ey0),
                                       qv(torch.clamp(-cb * ey1 / caf, ex0, ex1), ey1)))
    minq = torch.where(inside, torch.zeros_like(minq), minq)
    cull = minq > torch.log(torch.clamp(op, min=1e-12) * 255.0)
    dbits = f[9][owners].float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    keys = (torch.where(cull, torch.full_like(tile, num_tiles), tile) << 32) | dbits
    _, perm = torch.sort(keys, stable=True)
    kept = int((~cull).sum())
    inst = owners[perm][:kept]
    hist = torch.bincount(tile[~cull], minlength=num_tiles)
    start = torch.cumsum(hist, 0) - hist
    return inst, start, hist, total, int((count > 0).sum()), gx, gy


def _batches(counts, budget: int):
    t0, n = 0, len(counts)
    while t0 < n:
        t1, kmax = t0 + 1, max(counts[t0], 1)
        while t1 < n and max(kmax, counts[t1]) * (t1 - t0 + 1) * TILE_PIX <= budget:
            kmax = max(kmax, counts[t1])
            t1 += 1
        yield t0, t1
        t0 = t1


def _blend(f: torch.Tensor, inst, start, hist, t0: int, t1: int, gx: int, bg: torch.Tensor,
           width: int, height: int):
    """Tiles [t0, t1): ((B, 5, 256) colour, depth, alpha rows; blended and
    walked pair counts inside the image)."""
    dev = f.device
    cnt = hist[t0:t1]
    k = max(int(cnt.max()), 1)
    ks = torch.arange(k, device=dev)
    valid = ks[None, :] < cnt[:, None]
    idx = torch.clamp(start[t0:t1, None] + ks[None, :], max=max(inst.numel() - 1, 0))
    g = f[:, inst[idx]] if inst.numel() else torch.zeros((10,) + valid.shape, device=dev)
    tids = torch.arange(t0, t1, device=dev)
    lin = torch.arange(TILE_PIX, device=dev)
    pixx = ((tids % gx)[:, None] * TILE + lin[None, :] % TILE).to(f.dtype)
    pixy = ((tids // gx)[:, None] * TILE + lin[None, :] // TILE).to(f.dtype)
    mx, my, ca, cb, cc, op = (g[i][:, :, None] for i in range(6))
    dx = mx - pixx[:, None, :]
    dy = my - pixy[:, None, :]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    araw = op * torch.exp(power)
    live = (power <= 0.0) & (araw >= ALPHA_EPS) & valid[:, :, None]
    # straight-through clamp: the 0.99 cap in the value, not in the gradient
    capped = araw - torch.clamp(araw - ALPHA_MAX, min=0.0).detach()
    alpha = torch.where(live, capped, torch.zeros_like(araw))
    one_minus = 1.0 - alpha
    t_incl = torch.cumprod(one_minus, dim=1)
    t_before = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=1)
    trigger = live & (t_before * one_minus < T_EPS)
    before_stop = torch.cumsum(trigger.int(), dim=1) == 0
    include = live & before_stop
    w = torch.where(include, alpha * t_before, torch.zeros_like(alpha))
    t_pad = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl], dim=1)
    first = before_stop.sum(dim=1, keepdim=True)
    t_final = torch.gather(t_pad, 1, first)[:, 0]
    acc = torch.einsum("bkp,cbk->bcp", w, g[6:10])
    color = acc[:, :3] + t_final[:, None, :] * bg[None, :, None]
    out = torch.cat([color, acc[:, 3:4], w.sum(dim=1)[:, None]], dim=1)
    with torch.no_grad():
        in_img = ((pixx < width) & (pixy < height))[:, None, :]
        walked = int(((torch.cumsum(trigger.int(), dim=1) - trigger.int() == 0) & valid[:, :, None] & in_img).sum())
        blended = int((include & in_img).sum())
    return out, torch.tensor([blended, walked - blended])


def render(xyz, f_dc, f_rest, scaling, rotation, opacity, cam: RasterCamera, bg: torch.Tensor,
           sh_degree: int = 3, active_degree: Optional[int] = None,
           offset: Optional[torch.Tensor] = None) -> Render:
    """Render raw Gaussian parameters (log-scale, unnormalised quaternion,
    logit opacity) with their activations. `offset` (N, 2) is added to the
    screen means scaled by (W/2, H/2): its gradient is the viewspace
    gradient that densification reads."""
    scales = torch.exp(scaling)
    rots = rotation / torch.clamp(torch.linalg.norm(rotation, dim=-1, keepdim=True), min=1e-12)
    ops = torch.sigmoid(opacity)
    shs = torch.cat([f_dc, f_rest], dim=1)
    fields, radius, visible, ext_x, ext_y = preprocess_field_rows(
        xyz, scales, rots, ops, shs, cam, sh_degree, 1.0, active_degree=active_degree)
    fields = list(fields)
    if offset is not None:
        fields[0] = fields[0] + offset[:, 0] * (0.5 * cam.width)
        fields[1] = fields[1] + offset[:, 1] * (0.5 * cam.height)
    f = torch.stack(fields)
    radii = torch.where(visible, radius, torch.zeros_like(radius)).to(torch.int32)
    inst, start, hist, total, binned, gx, gy = bin_instances(f.detach(), radii, ext_x.detach(),
                                                              ext_y.detach(), cam.width, cam.height)
    tiles, pairs = [], torch.zeros(2, dtype=torch.long)
    for t0, t1 in _batches(hist.tolist(), BATCH_ELEMS):
        if f.requires_grad and torch.is_grad_enabled():
            out, pr = torch.utils.checkpoint.checkpoint(_blend, f, inst, start, hist, t0, t1, gx, bg,
                                                        cam.width, cam.height, use_reentrant=False)
        else:
            out, pr = _blend(f, inst, start, hist, t0, t1, gx, bg, cam.width, cam.height)
        tiles.append(out)
        pairs += pr
    x = torch.cat(tiles).reshape(gy, gx, 5, TILE, TILE).permute(2, 0, 3, 1, 4).reshape(5, gy * TILE, gx * TILE)
    x = x[:, :cam.height, :cam.width]
    counts = Counts(f.shape[1], binned, total, gx * gy, cam.width * cam.height, int(pairs[0]), int(pairs[1]))
    return Render(x[0:3], x[3], x[4], radii, radii > 0, counts)
