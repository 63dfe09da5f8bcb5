"""Point cloud -> image by a nearest-point z-buffer, in numpy.

The port's copy of `guidedvd3dgs_tpu/scene/pcd2img.py`: the projection
images of the project-cam trainer are made from the scene's point cloud
offline (`python -m guidedvd3dgs_tpu_torch.project_pcd_to_views`), so the
host function is kept as the reference has it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def project_point_cloud_to_image(
    point_cloud: np.ndarray,
    colors: np.ndarray,
    intrinsics: np.ndarray,
    extrinsics: np.ndarray,  # (4, 4) w2c
    width: int,
    height: int,
    near: float = 0.1,
    far: float = 1000.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(image uint8 (H, W, 3), mask uint8 (H, W)): each pixel takes the
    colour of the nearest point that rounds to it (the first in the input
    among equal depths); colours in [0, 1] are scaled to 0..255."""
    image = np.zeros((height, width, 3), np.uint8)
    mask = np.zeros((height, width), np.uint8)

    homog = np.hstack([point_cloud, np.ones((point_cloud.shape[0], 1))])
    cam = (extrinsics @ homog.T).T
    ok = (cam[:, 2] > near) & (cam[:, 2] < far)
    cam = cam[ok]
    cols = colors[ok]

    img_pts = (intrinsics @ cam[:, :3].T).T
    u = np.round(img_pts[:, 0] / img_pts[:, 2]).astype(int)
    v = np.round(img_pts[:, 1] / img_pts[:, 2]).astype(int)
    z = cam[:, 2]

    inb = (u >= 0) & (u < width) & (v >= 0) & (v < height)
    u, v, z, cols = u[inb], v[inb], z[inb], cols[inb]

    # nearest point first, then the first of each pixel
    lin = v * width + u
    order = np.argsort(z, kind="stable")
    lin, z, cols = lin[order], z[order], cols[order]
    first = np.unique(lin, return_index=True)[1]
    lin, z, cols = lin[first], z[first], cols[first]

    vv, uu = lin // width, lin % width
    if cols.dtype != np.uint8:
        cols = (np.clip(cols, 0, 1) * 255).astype(np.uint8)
    image[vv, uu] = cols
    mask[vv, uu] = 1
    return image, mask
