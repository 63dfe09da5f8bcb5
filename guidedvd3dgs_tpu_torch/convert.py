"""Numpy bridge from the reference package's arrays to the port's objects.

`params_from_numpy` takes the leaves of the reference `GaussianParams`
(as numpy arrays, by name) and returns the port's module; tests use it so
that both packages compute on the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from guidedvd3dgs_tpu_torch.models.gaussians import GaussianParams
from guidedvd3dgs_tpu_torch.ops.projection import RasterCamera


def params_from_numpy(leaves: dict, device="cpu") -> GaussianParams:
    """leaves: {xyz, features_dc, features_rest, scaling, rotation,
    opacity} as arrays (any array type numpy can convert)."""
    return GaussianParams.from_arrays({k: np.asarray(v) for k, v in leaves.items()}, device)


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
