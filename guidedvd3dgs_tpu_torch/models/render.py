"""Render API: Gaussian parameters -> image.

Counterpart of `guidedvd3dgs_tpu/models/render.py::render_gaussians` and
`guidedvd3dgs_tpu/train/baseline.py::eval_render`, forward only: the
activations, then the rasterizer. The confidence gradient rescaling of the
reference only acts on gradients and arrives with the training slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from guidedvd3dgs_tpu_torch.models.gaussians import GaussianParams
from guidedvd3dgs_tpu_torch.ops.projection import RasterCamera
from guidedvd3dgs_tpu_torch.ops.raster import rasterize


class RenderResult(NamedTuple):
    color: torch.Tensor  # (3, H, W)
    depth: torch.Tensor  # (H, W)
    alpha: torch.Tensor  # (H, W)
    radii: torch.Tensor  # (N,)
    visibility_filter: torch.Tensor  # (N,) bool == radii > 0
    num_instances: Optional[int] = None  # tile backend: (Gaussian, tile) instances


def render_gaussians(
    params: GaussianParams,
    cam: RasterCamera,
    bg: torch.Tensor,
    active_sh_degree: int,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    backend: str = "auto",
    active_degree: Optional[int] = None,
) -> RenderResult:
    shs = None if override_color is not None else params.get_features
    out = rasterize(
        params.xyz,
        params.get_scaling,
        params.get_rotation,
        params.get_opacity,
        shs,
        cam,
        bg,
        sh_degree=active_sh_degree,
        scale_modifier=scaling_modifier,
        colors_precomp=override_color,
        backend=backend,
        active_degree=active_degree,
    )
    return RenderResult(
        color=out.color,
        depth=out.depth,
        alpha=out.alpha,
        radii=out.radii,
        visibility_filter=out.radii > 0,
        num_instances=out.num_instances,
    )


@torch.no_grad()
def eval_render(
    params: GaussianParams,
    cam: RasterCamera,
    bg: torch.Tensor,
    sh_degree: int,
    backend: str = "auto",
) -> RenderResult:
    """Render one view for evaluation (no gradients)."""
    return render_gaussians(params, cam, bg, sh_degree, backend=backend)
