"""Camera containers.

Counterpart of `guidedvd3dgs_tpu/scene/cameras.py` (Camera, PseudoCamera,
MiniCam, camera_from_w2c_K), with host numpy matrices in the reference's transposed
row-vector layout: world_view = getWorld2View2(R, T).T and
full_proj = world_view @ proj. `raster_camera(device)` hands the renderer
a torch `RasterCamera` on the given device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from guidedvd3dgs_tpu_torch.ops.projection import RasterCamera
from guidedvd3dgs_tpu_torch.utils.graphics import getProjectionMatrix, getWorld2View2


def _build_matrices(R, T, fovx, fovy, trans, scale):
    world_view = getWorld2View2(R, T, trans, scale).T.astype(np.float32)
    projection = getProjectionMatrix(0.01, 100.0, fovx, fovy).T.astype(np.float32)
    full_proj = (world_view @ projection).astype(np.float32)
    camera_center = np.linalg.inv(world_view)[3, :3].astype(np.float32)
    return world_view, projection, full_proj, camera_center


def _raster_camera(cam, height: int, width: int, device) -> RasterCamera:
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)

    return RasterCamera(
        viewmatrix=dev(cam.world_view_transform),
        projmatrix=dev(cam.full_proj_transform),
        campos=dev(cam.camera_center),
        tanfovx=math.tan(cam.FoVx * 0.5),
        tanfovy=math.tan(cam.FoVy * 0.5),
        height=height,
        width=width,
    )


@dataclasses.dataclass
class Camera:
    """Evaluation camera with its ground-truth image, (3, H, W) float32.
    A projection camera also holds the point cloud projected to its view,
    `projected_image` (3, H, W), and its coverage `projected_mask` (H, W)."""

    colmap_id: int
    R: np.ndarray  # (3, 3) world-from-camera rotation (COLMAP, transposed)
    T: np.ndarray  # (3,) world-to-camera translation
    FoVx: float
    FoVy: float
    image: np.ndarray  # (3, H, W) float32 in [0, 1]
    image_name: str = ""
    uid: int = 0
    gt_alpha_mask: Optional[np.ndarray] = None
    trans: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0
    projected_image: Optional[np.ndarray] = None
    projected_mask: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.gt_alpha_mask is not None:
            self.image = self.image * self.gt_alpha_mask
        (
            self.world_view_transform,
            self.projection_matrix,
            self.full_proj_transform,
            self.camera_center,
        ) = _build_matrices(self.R, self.T, self.FoVx, self.FoVy, self.trans, self.scale)

    @property
    def image_height(self) -> int:
        return self.image.shape[1]

    @property
    def image_width(self) -> int:
        return self.image.shape[2]

    def raster_camera(self, device) -> RasterCamera:
        return _raster_camera(self, self.image_height, self.image_width, device)


@dataclasses.dataclass
class PseudoCamera:
    """Camera without a ground-truth image (novel or path views); the
    guided trainer's pseudo views carry the generated frame as `pseudo_gt`
    (3, H, W) and the event's mask of unobserved pixels (1, H, W), tensors
    on its device."""

    R: np.ndarray
    T: np.ndarray
    FoVx: float
    FoVy: float
    width: int
    height: int
    pseudo_gt: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None
    trans: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0

    def __post_init__(self):
        (
            self.world_view_transform,
            self.projection_matrix,
            self.full_proj_transform,
            self.camera_center,
        ) = _build_matrices(self.R, self.T, self.FoVx, self.FoVy, self.trans, self.scale)

    @property
    def image_height(self) -> int:
        return self.height

    @property
    def image_width(self) -> int:
        return self.width

    def raster_camera(self, device) -> RasterCamera:
        return _raster_camera(self, self.height, self.width, device)


@dataclasses.dataclass
class MiniCam:
    """A camera given by its matrices in the transposed layout, as the
    network viewer sends them (reference scene/cameras.py:97-108)."""

    width: int
    height: int
    fovy: float
    fovx: float
    znear: float
    zfar: float
    world_view_transform: np.ndarray  # (4, 4)
    full_proj_transform: np.ndarray  # (4, 4)

    def __post_init__(self):
        self.camera_center = np.linalg.inv(self.world_view_transform)[3, :3]
        self.FoVx, self.FoVy = self.fovx, self.fovy

    def raster_camera(self, device) -> RasterCamera:
        return _raster_camera(self, self.height, self.width, device)


def camera_from_w2c_K(w2c: np.ndarray, K: np.ndarray, height: int, width: int) -> PseudoCamera:
    """PseudoCamera from an OpenCV-style w2c and intrinsics K."""
    fovx = 2 * math.atan(width / (2 * K[0, 0]))
    fovy = 2 * math.atan(height / (2 * K[1, 1]))
    R = w2c[:3, :3].T  # stored transposed, as the COLMAP readers do
    T = w2c[:3, 3]
    return PseudoCamera(R=R, T=T, FoVx=fovx, FoVy=fovy, width=width, height=height)
