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
  5. per-tile start and count from the histogram.
None of the TPU packing, padding or capacity machinery is needed here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from guidedvd3dgs_tpu_torch.ops import expand
from guidedvd3dgs_tpu_torch.ops.preprocess_fused import F_MX, F_MY, ROW_EXT_X, ROW_EXT_Y

TILE = 16
_INT_SAFE = float(2**30)  # clamp before float -> int32 casts


class TileBinning(NamedTuple):
    inst_gauss: torch.Tensor  # (M,) int32 owner of each instance, tile-major depth order
    tile_start: torch.Tensor  # (num_tiles,) int32 first instance of each tile
    tile_count: torch.Tensor  # (num_tiles,) int32 instances of each tile
    num_instances: int  # M: all expanded instances, culled ones included
    grid_x: int
    grid_y: int


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 truncating toward zero, saturating out-of-range values
    instead of wrapping (the reference's cast saturates)."""
    return torch.clamp(x, -_INT_SAFE, _INT_SAFE).to(torch.int32)


def tile_rects(x, y, radii, ext_x, ext_y, width: int, height: int):
    """Per-Gaussian tile rectangle: the tight level-set bbox (floor / floor
    + 1 tile bounds of mean -+ ext) intersected with the reference getRect
    of the 3-sigma radius. Returns (rect_min_x, rect_min_y, w, h, count,
    grid_x, grid_y); count = w * h for visible Gaussians, else 0."""
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
    return rect_min_x, rect_min_y, w, h, count, gx, gy


def expand_inputs(tab: torch.Tensor, radii: torch.Tensor, width: int, height: int):
    """Steps 1-2: K3's arguments after the table, (rect_min_x, rect_min_y,
    w, count, offsets, grid_x, num_tiles, total)."""
    rmx, rmy, w, _h, count, gx, gy = tile_rects(
        tab[F_MX], tab[F_MY], radii, tab[ROW_EXT_X], tab[ROW_EXT_Y], width, height
    )
    cum = torch.cumsum(count, 0, dtype=torch.int64)
    # the one read-back per view: sizes the instance buffers exactly
    total = int(cum[-1]) if cum.numel() else 0
    if total >= 2**31:
        raise ValueError(f"{total} instances exceed the int32 instance index")
    offsets = (cum - count).to(torch.int32)
    return rmx, rmy, w, count, offsets, gx, gx * gy, total


def bin_gaussians(
    tab: torch.Tensor, radii: torch.Tensor, width: int, height: int,
    expand_fn=expand.expand_instances,
) -> TileBinning:
    """Bin the Gaussians of a (16, N) K1 table into depth-sorted per-tile
    instance lists. `radii` (N,) int32 is 0 for culled Gaussians.
    `expand_fn` is K3's wrapper; a check against the plain chain passes
    `expand.expand_instances_plain`."""
    args = expand_inputs(tab, radii, width, height)
    gx, num_tiles, total = args[-3:]
    keys, owners, hist = expand_fn(tab, *args)
    _, perm = torch.sort(keys, stable=True)
    inst_gauss = owners[perm]
    tile_start = (torch.cumsum(hist, 0, dtype=torch.int32) - hist).to(torch.int32)
    return TileBinning(inst_gauss, tile_start, hist, total, gx, num_tiles // gx)
