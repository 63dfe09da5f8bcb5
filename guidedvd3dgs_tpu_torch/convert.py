"""Numpy bridge from the reference package's arrays to the port's objects.

`params_from_numpy` takes the leaves of the reference `GaussianParams`
(as numpy arrays, by name) and returns the port's module;
`state_from_numpy` takes a reference `GaussianState` whose leaves numpy
can convert and returns the port's training state of its active rows.
`diffusion_params_from_numpy` carries the reference DiffusionParams'
weights across. Tests use them so that both packages compute on the same
weights.
"""

from __future__ import annotations

import numpy as np
import torch

from guidedvd3dgs_tpu_torch.diffusion.model import DiffusionParams
from guidedvd3dgs_tpu_torch.models.gaussians import PARAM_NAMES, GaussianParams, GaussianState
from guidedvd3dgs_tpu_torch.ops.projection import RasterCamera


def params_from_numpy(leaves: dict, device="cpu") -> GaussianParams:
    """leaves: {xyz, features_dc, features_rest, scaling, rotation,
    opacity} as arrays (any array type numpy can convert)."""
    return GaussianParams.from_arrays({k: np.asarray(v) for k, v in leaves.items()}, device)


def state_from_numpy(state, device="cpu") -> GaussianState:
    """The port's state of a reference state's active rows: parameters,
    Adam moments, step, confidence and densification statistics (any object
    with the reference GaussianState's fields)."""
    act = np.asarray(state.active, bool)

    def rows(a):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a)[act], np.float32)).to(device)

    def group(g):
        return {k: rows(getattr(g, k)) for k in PARAM_NAMES}

    return GaussianState(
        params=GaussianParams(**group(state.params)),
        adam_m=group(state.adam_m),
        adam_v=group(state.adam_v),
        step=int(np.asarray(state.step)),
        confidence=rows(state.confidence),
        max_radii2d=rows(state.max_radii2d),
        xyz_gradient_accum=rows(state.xyz_gradient_accum),
        denom=rows(state.denom),
    )


def diffusion_params_from_numpy(params, device="cpu", dtype=None) -> DiffusionParams:
    """The port's DiffusionParams from any object with the reference
    DiffusionParams' five fields (unet, vae, resampler, clip_text,
    clip_image), each a {torch name: array} mapping: the same names and
    layouts, on `device`; floating arrays cast to `dtype` when given."""

    def tensor(a):
        t = torch.from_numpy(np.array(a))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return DiffusionParams(*({k: tensor(v) for k, v in getattr(params, f).items()}
                             for f in DiffusionParams._fields))


def raster_camera_from_numpy(cam, device="cpu") -> RasterCamera:
    """From any object with the reference RasterCamera's fields
    (viewmatrix, projmatrix, campos, tanfovx, tanfovy, height, width)."""

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return RasterCamera(
        viewmatrix=t(cam.viewmatrix),
        projmatrix=t(cam.projmatrix),
        campos=t(cam.campos),
        tanfovx=float(cam.tanfovx),
        tanfovy=float(cam.tanfovy),
        height=int(cam.height),
        width=int(cam.width),
    )
