"""Render API: Gaussian parameters -> image.

Counterpart of `guidedvd3dgs_tpu/models/render.py` (`render_gaussians`,
`render_state`) and `guidedvd3dgs_tpu/train/baseline.py::eval_render`: the
activations, the optional confidence rescaling of the gradients, then the
rasterizer. `means2d_offset` (N, 2) zeros that require grad give the
viewspace gradient that densification reads. `render_gaussians_multi`
renders B cameras of the same Gaussians through one chain.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from guidedvd3dgs_tpu_torch.models.gaussians import GaussianParams, GaussianState
from guidedvd3dgs_tpu_torch.ops.projection import RasterCamera
from guidedvd3dgs_tpu_torch.ops.raster import rasterize, rasterize_multi


class _ConfidenceGradScale(torch.autograd.Function):
    """Identity whose gradient is multiplied by the per-Gaussian
    confidence (a backward-only rescaling)."""

    @staticmethod
    def forward(ctx, x, conf):
        ctx.save_for_backward(conf)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (conf,) = ctx.saved_tensors
        return g * conf.reshape(conf.shape[:1] + (1,) * (g.dim() - 1)), None


def _confidence_grad_scale(x: torch.Tensor, conf: torch.Tensor) -> torch.Tensor:
    return _ConfidenceGradScale.apply(x, conf)


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
    means2d_offset: Optional[torch.Tensor] = None,
    confidence: Optional[torch.Tensor] = None,
    use_confidence: bool = False,
) -> RenderResult:
    """Differentiable render. With `use_confidence`, each parameter's
    gradient is multiplied by its Gaussian's `confidence` (N, 1)."""
    xyz, f_dc, f_rest, scaling, rotation, opacity = _activated(params, confidence, use_confidence)
    # the SH as the model holds it: the tile rasterizer reads both in place
    shs = None if override_color is not None else (f_dc, f_rest)
    out = rasterize(
        xyz,
        scaling,
        rotation,
        opacity,
        shs,
        cam,
        bg,
        sh_degree=active_sh_degree,
        scale_modifier=scaling_modifier,
        colors_precomp=override_color,
        backend=backend,
        active_degree=active_degree,
        means2d_offset=means2d_offset,
    )
    return RenderResult(
        color=out.color,
        depth=out.depth,
        alpha=out.alpha,
        radii=out.radii,
        visibility_filter=out.radii > 0,
        num_instances=out.num_instances,
    )


def _activated(params: GaussianParams, confidence, use_confidence: bool):
    """xyz, features_dc, features_rest and the activated scaling, rotation
    and opacity, each gradient multiplied by the confidence where asked."""
    xyz, f_dc, f_rest = params.xyz, params.features_dc, params.features_rest
    scaling, rotation, opacity = params.scaling, params.rotation, params.opacity
    if use_confidence:
        conf = confidence[:, 0]
        xyz, f_dc, f_rest, scaling, rotation, opacity = (
            _confidence_grad_scale(t, conf) for t in (xyz, f_dc, f_rest, scaling, rotation, opacity)
        )
    n = torch.linalg.norm(rotation, dim=-1, keepdim=True)
    return (xyz, f_dc, f_rest, torch.exp(scaling), rotation / torch.clamp(n, min=1e-12),
            torch.sigmoid(opacity))


def render_gaussians_multi(
    params: GaussianParams,
    cams: Sequence[RasterCamera],
    bg: torch.Tensor,
    active_sh_degree: int,
    scaling_modifier: float = 1.0,
    backend: str = "auto",
    active_degree: Optional[int] = None,
    means2d_offset: Optional[torch.Tensor] = None,
    confidence: Optional[torch.Tensor] = None,
    use_confidence: bool = False,
) -> RenderResult:
    """render_gaussians of B cameras (one resolution) of the same
    Gaussians through one chain (ops/raster.py::rasterize_multi); the
    fields carry a leading B, `means2d_offset` is (B, N, 2), num_instances
    is the chain's. The parameter gradients are summed over the cameras, as
    the reference's separate backward passes of a train view and a pseudo
    view accumulate into one .grad (JAX models/render.py::
    render_gaussians_multi)."""
    xyz, f_dc, f_rest, scaling, rotation, opacity = _activated(params, confidence, use_confidence)
    out = rasterize_multi(xyz, scaling, rotation, opacity, (f_dc, f_rest), cams, bg,
                          sh_degree=active_sh_degree, scale_modifier=scaling_modifier, backend=backend,
                          active_degree=active_degree, means2d_offset=means2d_offset)
    return RenderResult(color=out.color, depth=out.depth, alpha=out.alpha, radii=out.radii,
                        visibility_filter=out.radii > 0, num_instances=out.num_instances)


def render_state(state: GaussianState, cam: RasterCamera, bg: torch.Tensor,
                 active_sh_degree: int, **kwargs) -> RenderResult:
    """render_gaussians of a training state (its parameters and confidence)."""
    return render_gaussians(state.params, cam, bg, active_sh_degree,
                            confidence=state.confidence, **kwargs)


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
