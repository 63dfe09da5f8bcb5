"""Public rasterization API.

Counterpart of `guidedvd3dgs_tpu/ops/raster.py::rasterize`. Backends:
  "tiles"  K1 -> K3 + sort -> K4 (ops/raster_tiles.py), the production path
  "dense"  the O(N * P) oracle (ops/raster_dense.py), tests and tiny scenes
  "auto"   "tiles" whatever N is, so the kernels always run on the card
"""

from __future__ import annotations

from typing import Optional

import torch

from guidedvd3dgs_tpu_torch.ops.projection import RasterCamera
from guidedvd3dgs_tpu_torch.ops.raster_dense import RenderOutput, rasterize_dense
from guidedvd3dgs_tpu_torch.ops.raster_tiles import rasterize_tiles


def rasterize(
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
    backend: str = "auto",
    active_degree: Optional[int] = None,
) -> RenderOutput:
    kwargs = dict(
        sh_degree=sh_degree,
        scale_modifier=scale_modifier,
        colors_precomp=colors_precomp,
        cov3d_precomp=cov3d_precomp,
        active_degree=active_degree,
    )
    if backend in ("auto", "tiles"):
        return rasterize_tiles(means3d, scales, rotations, opacities, shs, cam, bg, **kwargs)
    if backend == "dense":
        return rasterize_dense(means3d, scales, rotations, opacities, shs, cam, bg, **kwargs)
    raise ValueError(f"unknown raster backend: {backend}")
