"""Tile rasterizer, forward: the production render path of the port.

Counterpart of `guidedvd3dgs_tpu/ops/raster_tiles.py::rasterize_tiles`
(forward only):
  kernel K1 (ops/preprocess_fused.py)  per-Gaussian (16, N) table
  binning (ops/tiling.py)              kernel K3 + one 64-bit key sort
  kernel K4 (`_run_fwd`, csrc/blend_fwd.cu)
                                       front-to-back alpha blend per 16x16
                                       tile over its depth-sorted instances

Blend rule (the dense oracle's), per pixel over the tile's instances:
power = -0.5 (a dx^2 + c dy^2) - b dx dy, skipped if > 0;
alpha = min(0.99, op * exp(power)), skipped if < 1/255; if
T (1 - alpha) < 1e-4 the pixel stops without adding this instance;
otherwise color, depth and 1 accumulate with weight alpha T and
T *= 1 - alpha. Output color = acc + T bg.

The backward kernels arrive with the training slice; until then a call
that would need a gradient raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from guidedvd3dgs_tpu_torch.ops import _build, preprocess_fused, tiling
from guidedvd3dgs_tpu_torch.ops.projection import ALPHA_EPS, ALPHA_MAX, T_EPS, RasterCamera
from guidedvd3dgs_tpu_torch.ops.raster_dense import RenderOutput
from guidedvd3dgs_tpu_torch.ops.tiling import TILE, TileBinning

TILE_PIX = TILE * TILE
# element budget of one tile batch of the plain blend: ~10 live
# (tiles, instances, 256) f32 temporaries of this size
PLAIN_BATCH_ELEMS = 1 << 24


def _tiles_to_planes(tiles: torch.Tensor, gx: int, gy: int) -> torch.Tensor:
    """(num_tiles, R, TILE_PIX) -> (R, gy * TILE, gx * TILE)."""
    r = tiles.shape[1]
    x = tiles.reshape(gy, gx, r, TILE, TILE)
    return x.permute(2, 0, 3, 1, 4).reshape(r, gy * TILE, gx * TILE)


def _blend_tiles_plain(tab, inst_gauss, tile_start, tile_count, t0, t1, gx, bg):
    """Plain blend of tiles [t0, t1): (t1 - t0, 5, TILE_PIX) rows color,
    depth, alpha. The sequential per-pixel rule in closed form: a running
    product of (1 - alpha) and the first triggering instance per pixel."""
    dev = tab.device
    b = t1 - t0
    cnt = tile_count[t0:t1].long()
    k = max(int(cnt.max()), 1)
    ks = torch.arange(k, device=dev)
    valid = ks[None, :] < cnt[:, None]  # (B, K)
    if inst_gauss.numel():
        idx = torch.clamp(tile_start[t0:t1].long()[:, None] + ks[None, :], max=inst_gauss.numel() - 1)
        f = tab[:10, inst_gauss[idx].long()]  # (10, B, K)
    else:
        f = torch.zeros((10, b, k), dtype=torch.float32, device=dev)
    tids = torch.arange(t0, t1, device=dev)
    lin = torch.arange(TILE_PIX, device=dev)
    pixx = ((tids % gx)[:, None] * TILE + lin[None, :] % TILE).float()  # (B, P)
    pixy = ((tids // gx)[:, None] * TILE + lin[None, :] // TILE).float()

    mx, my, ca, cb, cc, op = (f[i][:, :, None] for i in range(preprocess_fused.F_R))
    dx = mx - pixx[:, None, :]  # (B, K, P)
    dy = my - pixy[:, None, :]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    araw = op * torch.exp(power)
    live = (power <= 0.0) & (araw >= ALPHA_EPS) & valid[:, :, None]
    alpha = torch.where(live, torch.clamp(araw, max=ALPHA_MAX), torch.zeros_like(araw))
    one_minus = 1.0 - alpha
    t_incl = torch.cumprod(one_minus, dim=1)
    t_pad = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl], dim=1)  # T before k at [k]
    t_before = t_pad[:, :-1]
    trigger = live & (t_before * one_minus < T_EPS)
    no_trigger_yet = torch.cumsum(trigger.int(), dim=1) == 0
    include = live & no_trigger_yet
    w = torch.where(include, alpha * t_before, torch.zeros_like(alpha))
    first = no_trigger_yet.sum(dim=1, keepdim=True)  # index of the stopping instance, or K
    t_final = torch.gather(t_pad, 1, first)[:, 0]  # (B, P)
    cd = f[preprocess_fused.F_R :]  # (4, B, K) r, g, b, depth
    acc = torch.einsum("bkp,cbk->bcp", w, cd)  # (B, 4, P)
    color = acc[:, :3] + t_final[:, None, :] * bg[None, :, None]
    return torch.cat([color, acc[:, 3:4], w.sum(dim=1)[:, None]], dim=1)


def blend_fwd_plain(tab, binning: TileBinning, bg, width: int, height: int):
    """Plain PyTorch version of K4, in batches of tiles to bound memory."""
    gx, gy = binning.grid_x, binning.grid_y
    num_tiles = gx * gy
    counts = binning.tile_count.tolist()
    tiles = torch.empty((num_tiles, 5, TILE_PIX), dtype=torch.float32, device=tab.device)
    t0 = 0
    while t0 < num_tiles:
        t1, kmax = t0 + 1, max(counts[t0], 1)
        while t1 < num_tiles and max(kmax, counts[t1]) * (t1 - t0 + 1) * TILE_PIX <= PLAIN_BATCH_ELEMS:
            kmax = max(kmax, counts[t1])
            t1 += 1
        tiles[t0:t1] = _blend_tiles_plain(
            tab, binning.inst_gauss, binning.tile_start, binning.tile_count, t0, t1, gx, bg
        )
        t0 = t1
    planes = _tiles_to_planes(tiles, gx, gy)[:, :height, :width]
    return planes[0:3], planes[3], planes[4]


def _run_fwd(tab: torch.Tensor, binning: TileBinning, bg: torch.Tensor, width: int, height: int):
    """Kernel K4: blend the binned instances into (color (3, H, W),
    depth (H, W), alpha (H, W)). CPU tensors take the plain version."""
    if tab.device.type == "cpu":
        return blend_fwd_plain(tab, binning, bg, width, height)
    if tab.device.type != "cuda":
        raise ValueError(f"no blend kernel for device {tab.device}")
    dev = tab.device
    n = tab.shape[1]
    gx, gy = binning.grid_x, binning.grid_y
    num_tiles = gx * gy
    _build.check_cuda("tab", tab, torch.float32, dev, (16, n))
    _build.check_cuda("inst_gauss", binning.inst_gauss, torch.int32, dev, (binning.num_instances,))
    _build.check_cuda("tile_start", binning.tile_start, torch.int32, dev, (num_tiles,))
    _build.check_cuda("tile_count", binning.tile_count, torch.int32, dev, (num_tiles,))
    _build.check_cuda("bg", bg, torch.float32, dev, (3,))
    if gx != (width + TILE - 1) // TILE or gy != (height + TILE - 1) // TILE:
        raise ValueError(f"binning grid {gx}x{gy} does not cover {width}x{height}")
    color = torch.empty((3, height, width), dtype=torch.float32, device=dev)
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    alpha = torch.empty((height, width), dtype=torch.float32, device=dev)
    _build.launch(
        "blend_fwd",
        tab.data_ptr(), n, binning.inst_gauss.data_ptr(), binning.tile_start.data_ptr(),
        binning.tile_count.data_ptr(), bg.data_ptr(), gx, gy, width, height,
        color.data_ptr(), depth.data_ptr(), alpha.data_ptr(), _build.stream_of(tab),
    )
    return color, depth, alpha


def rasterize_tiles(
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
    active_degree: Optional[int] = None,
) -> RenderOutput:
    """Render through K1 -> binning (K3 + sort) -> K4. Inputs are
    post-activation; CUDA tensors run the kernels, CPU tensors their
    plain versions."""
    if colors_precomp is not None or cov3d_precomp is not None:
        raise NotImplementedError(
            "precomputed colors / cov3D are not supported by the tile rasterizer yet"
        )
    if shs is None:
        raise ValueError("the tile rasterizer needs SH features")
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (means3d, scales, rotations, opacities, shs)
    ):
        raise NotImplementedError(
            "the tile rasterizer has no backward yet; render under torch.no_grad()"
        )
    tab = preprocess_fused.preprocess_fused_fwd(
        means3d, scales, rotations, opacities, shs, cam, sh_degree, scale_modifier,
        active_degree=active_degree,
    )
    radii = preprocess_fused.visible_radii(tab)
    binning = tiling.bin_gaussians(tab, radii, cam.width, cam.height)
    color, depth, alpha = _run_fwd(tab, binning, bg, cam.width, cam.height)
    return RenderOutput(color, depth, alpha, radii, radii > 0, 0, binning.num_instances)
