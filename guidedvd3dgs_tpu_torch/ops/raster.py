"""Public rasterization API.

Counterpart of `guidedvd3dgs_tpu/ops/raster.py::rasterize`. Backends:
  "tiles"  K1 -> K3 + sort -> K4 (ops/raster_tiles.py), the production path
  "dense"  the O(N * P) oracle (ops/raster_dense.py), tests and tiny scenes
  "auto"   "tiles" whatever N is, so the kernels always run on the card
`shs` is one (N, K, 3) tensor or the model's pair (features_dc (N, 1, 3),
features_rest (N, K - 1, 3)): the tile rasterizer reads the pair in place,
the dense oracle concatenates it. `rasterize_multi` renders B cameras of
the same Gaussians: one chain on the tile path, a loop over the cameras
on the dense one (JAX `rasterize_multi`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from guidedvd3dgs_tpu_torch.ops.preprocess_fused import SH, concat_sh
from guidedvd3dgs_tpu_torch.ops.projection import RasterCamera
from guidedvd3dgs_tpu_torch.ops.raster_dense import RenderOutput, rasterize_dense
from guidedvd3dgs_tpu_torch.ops.raster_tiles import rasterize_tiles, rasterize_tiles_multi


def rasterize(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    shs: Optional[SH],
    cam: RasterCamera,
    bg: torch.Tensor,
    sh_degree: int = 3,
    scale_modifier: float = 1.0,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    backend: str = "auto",
    active_degree: Optional[int] = None,
    means2d_offset: Optional[torch.Tensor] = None,
) -> RenderOutput:
    kwargs = dict(
        sh_degree=sh_degree,
        scale_modifier=scale_modifier,
        colors_precomp=colors_precomp,
        cov3d_precomp=cov3d_precomp,
        active_degree=active_degree,
        means2d_offset=means2d_offset,
    )
    if backend in ("auto", "tiles"):
        return rasterize_tiles(means3d, scales, rotations, opacities, shs, cam, bg, **kwargs)
    if backend == "dense":
        shs = None if shs is None else concat_sh(shs)
        return rasterize_dense(means3d, scales, rotations, opacities, shs, cam, bg, **kwargs)
    raise ValueError(f"unknown raster backend: {backend}")


def rasterize_multi(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    shs: SH,
    cams: Sequence[RasterCamera],
    bg: torch.Tensor,
    sh_degree: int = 3,
    scale_modifier: float = 1.0,
    backend: str = "auto",
    active_degree: Optional[int] = None,
    means2d_offset: Optional[torch.Tensor] = None,  # (B, N, 2)
) -> RenderOutput:
    """B cameras (one resolution); the outputs carry a leading B, the
    parameter gradients are summed over the cameras. "tiles" / "auto": one
    chain (ops/raster_tiles.py::rasterize_tiles_multi); "dense": the oracle
    camera by camera."""
    kwargs = dict(sh_degree=sh_degree, scale_modifier=scale_modifier, active_degree=active_degree)
    if backend in ("auto", "tiles"):
        return rasterize_tiles_multi(means3d, scales, rotations, opacities, shs, cams, bg,
                                     means2d_offset=means2d_offset, **kwargs)
    if backend == "dense":
        shs = concat_sh(shs)
        outs = [rasterize_dense(means3d, scales, rotations, opacities, shs, cam, bg,
                                means2d_offset=None if means2d_offset is None else means2d_offset[c],
                                **kwargs)
                for c, cam in enumerate(cams)]
        return RenderOutput(*(None if xs[0] is None else torch.stack(xs) for xs in zip(*outs)))
    raise ValueError(f"unknown raster backend: {backend}")
