"""Camera and projection math on the host (numpy).

Counterpart of `guidedvd3dgs_tpu/utils/graphics.py`, trimmed to what the
port calls. The conventions are the original's: the world-to-view matrix
is stored transposed (GLM row-vector layout) and the projection is the
simplified pinhole form (P[2,2] = P[3,2] = 1, no near/far scaling).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


class BasicPointCloud(NamedTuple):
    points: np.ndarray  # (N, 3)
    colors: np.ndarray  # (N, 3) in [0, 1]
    normals: np.ndarray  # (N, 3)


def getWorld2View2(
    R: np.ndarray,
    t: np.ndarray,
    translate: np.ndarray = np.array([0.0, 0.0, 0.0]),
    scale: float = 1.0,
) -> np.ndarray:
    """World-to-view 4x4 from COLMAP-style (R world-from-camera, t
    camera-from-world), with optional recentring of the camera position."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0

    C2W = np.linalg.inv(Rt)
    cam_center = C2W[:3, 3]
    cam_center = (cam_center + translate) * scale
    C2W[:3, 3] = cam_center
    Rt = np.linalg.inv(C2W)
    return np.float32(Rt)


def getProjectionMatrix(znear: float, zfar: float, fovX: float, fovY: float) -> np.ndarray:
    """The rasterizer's pinhole projection: after the w-divide only x/y
    carry information; depth comes from the view transform (znear/zfar
    are unused, as in the original)."""
    del znear, zfar
    tanHalfFovY = math.tan(fovY / 2)
    tanHalfFovX = math.tan(fovX / 2)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / tanHalfFovX
    P[1, 1] = 1.0 / tanHalfFovY
    P[2, 2] = 1.0
    P[3, 2] = 1.0
    return P


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))
