"""Gaussian parameters and their activations.

Counterpart of the serving part of `guidedvd3dgs_tpu/models/gaussians.py`:
the raw (pre-activation) parameters as an `nn.Module` of exactly N rows,
and the activations the renderer takes. The reference's fixed capacity
and `active` mask were for static shapes under jit; tensors here have the
size of the scene.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from guidedvd3dgs_tpu.scene.ply import load_gaussian_ply


class GaussianParams(nn.Module):
    """xyz (N, 3), features_dc (N, 1, 3), features_rest (N, R, 3), scaling
    (N, 3) log-scale, rotation (N, 4) unnormalized quaternion (w, x, y, z),
    opacity (N, 1) logit."""

    def __init__(self, xyz, features_dc, features_rest, scaling, rotation, opacity):
        super().__init__()
        self.xyz = nn.Parameter(xyz)
        self.features_dc = nn.Parameter(features_dc)
        self.features_rest = nn.Parameter(features_rest)
        self.scaling = nn.Parameter(scaling)
        self.rotation = nn.Parameter(rotation)
        self.opacity = nn.Parameter(opacity)

    @property
    def num_gaussians(self) -> int:
        return self.xyz.shape[0]

    @property
    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    @property
    def get_rotation(self) -> torch.Tensor:
        n = torch.linalg.norm(self.rotation, dim=-1, keepdim=True)
        return self.rotation / torch.clamp(n, min=1e-12)

    @property
    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    @property
    def get_features(self) -> torch.Tensor:
        return torch.cat([self.features_dc, self.features_rest], dim=1)  # (N, 1 + R, 3)

    @classmethod
    def from_arrays(cls, arrays: dict, device) -> "GaussianParams":
        """From numpy arrays under the names of `scene/ply.py::
        load_gaussian_ply` (xyz, features_dc, features_rest, scaling,
        rotation, opacity)."""
        t = {
            k: torch.from_numpy(np.ascontiguousarray(arrays[k], dtype=np.float32)).to(device)
            for k in ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
        }
        return cls(**t)

    @classmethod
    def from_ply(cls, path: str, device) -> "GaussianParams":
        """Load a `point_cloud.ply` snapshot: exactly its N rows."""
        return cls.from_arrays(load_gaussian_ply(path), device)
