"""Tile binning in the GPU form of the CUDA original.

Counterpart of `guidedvd3dgs_tpu/ops/tiling.py`. The steps follow
rasterizer_impl.cu of the CUDA original:
  1. per-Gaussian tile rectangles and instance counts (`tile_rects`,
     copied from the reference: tight level-set rects intersected with
     the reference getRect);
  2. exclusive offsets by `torch.cumsum`; the total instance count is read
     back once, to size the instance buffers exactly;
  3. kernel K3 (ops/expand.py): keys, owners and the per-tile histogram;
  4. one stable `torch.sort` of the 64-bit keys `tile << 32 | depth bits`
     (depth is positive past the near clip, so its f32 bits sort in order;
     equal keys keep Gaussian order);
  5. per-tile start and count from the histogram, and the tiles in the
     order the blend kernels K4 and K5 start them: the longest lists
     first (a block walks its tile alone, so a long list that starts late
     sets the kernel's end).
None of the TPU packing, padding or capacity machinery is needed here.

A chain of B cameras (`n_cams`, JAX `tile_rects(..., n_cams)`) bins a
(16, B N) table, camera c's Gaussians in columns [c N, (c + 1) N): the
cameras' tile grids are stacked as bands of gy_cam = ceil(H / 16) tile
rows, a grid of gx x B gy_cam. Each Gaussian's rectangle is its own
camera's, clamped to that camera's grid and moved into its band; the
table keeps each camera's own screen means (the JAX package shifts the
means by c gy_cam 16 pixels instead, which rounds them in f32), and K3,
K4 and K5 take the band of a tile row from gy_cam. One total is read back
for the whole chain.

The binning also keeps what the backward needs to reduce per-instance
gradients without a second sort: the sort's permutation (`perm[i]` is the
expansion slot of sorted instance i) and K3's per-Gaussian `offsets` and
`count` (Gaussian g owns the contiguous slots [offsets[g],
offsets[g] + count[g]), in ascending tile order).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from guidedvd3dgs_tpu_torch.ops import expand
from guidedvd3dgs_tpu_torch.ops.preprocess_fused import F_MX, F_MY, ROW_EXT_X, ROW_EXT_Y
from guidedvd3dgs_tpu_torch.utils import tracing

TILE = 16
_INT_SAFE = float(2**30)  # clamp before float -> int32 casts


class TileBinning(NamedTuple):
    inst_gauss: torch.Tensor  # (M,) int32 owner of each instance, tile-major depth order
    tile_start: torch.Tensor  # (num_tiles,) int32 first instance of each tile
    tile_count: torch.Tensor  # (num_tiles,) int32 instances of each tile
    num_instances: int  # M: all expanded instances, culled ones included
    grid_x: int
    grid_y: int
    perm: torch.Tensor  # (M,) int32 expansion slot of each sorted instance
    offsets: torch.Tensor  # (N,) int32 first expansion slot of each Gaussian
    count: torch.Tensor  # (N,) int32 expansion slots of each Gaussian
    tile_order: torch.Tensor  # (num_tiles,) int32 the tiles by instance count, longest first
    n_cams: int = 1  # cameras of the chain, each a band of grid_y / n_cams tile rows


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 truncating toward zero, saturating out-of-range values
    instead of wrapping (the reference's cast saturates)."""
    return torch.clamp(x, -_INT_SAFE, _INT_SAFE).to(torch.int32)


def tile_rects(x, y, radii, ext_x, ext_y, width: int, height: int, n_cams: int = 1):
    """Per-Gaussian tile rectangle: the tight level-set bbox (floor / floor
    + 1 tile bounds of mean -+ ext) intersected with the reference getRect
    of the 3-sigma radius. Returns (rect_min_x, rect_min_y, w, h, count,
    grid_x, grid_y); count = w * h for visible Gaussians, else 0. With
    `n_cams` > 1 the inputs are n_cams cameras' Gaussians one after another
    (each camera's own means), and rect_min_y and grid_y are the chain's
    (module docstring)."""
    gx = (width + TILE - 1) // TILE
    gy = (height + TILE - 1) // TILE
    rect_min_x = torch.clamp(_to_i32(torch.floor((x - ext_x) / TILE)), 0, gx)
    rect_min_y = torch.clamp(_to_i32(torch.floor((y - ext_y) / TILE)), 0, gy)
    rect_max_x = torch.clamp(_to_i32(torch.floor((x + ext_x) / TILE)) + 1, 0, gx)
    rect_max_y = torch.clamp(_to_i32(torch.floor((y + ext_y) / TILE)) + 1, 0, gy)
    r = radii.to(torch.float32)
    rect_min_x = torch.maximum(rect_min_x, torch.clamp(_to_i32((x - r) / TILE), 0, gx))
    rect_min_y = torch.maximum(rect_min_y, torch.clamp(_to_i32((y - r) / TILE), 0, gy))
    rect_max_x = torch.minimum(rect_max_x, torch.clamp(_to_i32((x + r + TILE - 1) / TILE), 0, gx))
    rect_max_y = torch.minimum(rect_max_y, torch.clamp(_to_i32((y + r + TILE - 1) / TILE), 0, gy))
    w = torch.clamp(rect_max_x - rect_min_x, min=0)
    h = torch.clamp(rect_max_y - rect_min_y, min=0)
    count = torch.where(radii > 0, w * h, torch.zeros_like(w))
    if n_cams > 1:
        npc = x.shape[0] // n_cams
        band = torch.arange(x.shape[0], device=x.device, dtype=torch.int32) // npc
        rect_min_y = rect_min_y + band * gy
        gy = gy * n_cams
    return rect_min_x, rect_min_y, w, h, count, gx, gy


def expand_inputs(tab: torch.Tensor, radii: torch.Tensor, width: int, height: int,
                  n_cams: int = 1):
    """Steps 1-2: K3's arguments after the table, (rect_min_x, rect_min_y,
    w, count, offsets, grid_x, num_tiles, total)."""
    rmx, rmy, w, _h, count, gx, gy = tile_rects(
        tab[F_MX], tab[F_MY], radii, tab[ROW_EXT_X], tab[ROW_EXT_Y], width, height, n_cams
    )
    cum = torch.cumsum(count, 0, dtype=torch.int64)
    # the one read-back per chain: sizes the instance buffers exactly
    total = 0
    if cum.numel():
        with tracing.readback():
            total = int(cum[-1])
    tracing.count("raster.instances", total)
    if total >= 2**31:
        raise ValueError(f"{total} instances exceed the int32 instance index")
    offsets = (cum - count).to(torch.int32)
    return rmx, rmy, w, count, offsets, gx, gx * gy, total


def bin_gaussians(
    tab: torch.Tensor, radii: torch.Tensor, width: int, height: int,
    expand_fn=expand.expand_instances, n_cams: int = 1,
) -> TileBinning:
    """Bin the Gaussians of a (16, N) K1 table into depth-sorted per-tile
    instance lists. `radii` (N,) int32 is 0 for culled Gaussians.
    `expand_fn` is K3's wrapper; a check against the plain chain passes
    `expand.expand_instances_plain`. With `n_cams` > 1 the table is a
    chain's (16, B N) and the grid its B bands (module docstring)."""
    args = expand_inputs(tab, radii, width, height, n_cams)
    count, offsets = args[3], args[4]
    gx, num_tiles, total = args[-3:]
    keys, owners, hist = expand_fn(tab, *args, gy_cam=num_tiles // gx // n_cams)
    _, perm = torch.sort(keys, stable=True)
    inst_gauss = owners[perm]
    tile_start = (torch.cumsum(hist, 0, dtype=torch.int32) - hist).to(torch.int32)
    tile_order = torch.argsort(hist, descending=True, stable=True).to(torch.int32)
    return TileBinning(inst_gauss, tile_start, hist, total, gx, num_tiles // gx,
                       perm.to(torch.int32), offsets, count, tile_order, n_cams)
