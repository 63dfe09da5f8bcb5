"""CameraInfo -> Camera loading with the reference resolution policy.

Counterpart of `guidedvd3dgs_tpu/scene/camera_utils.py`. Images are read
by the port's PNG decoder (utils/image_io.py) instead of PIL. When the
resolution policy asks for another size (it only ever shrinks), the image
is resampled with antialiased bicubic interpolation like PIL's `resize`;
torch's cubic kernel (a = -0.75) differs from PIL's (a = -0.5), so a
downscaled image agrees with PIL's within a few 8-bit levels.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from guidedvd3dgs_tpu.scene.dataset_readers import CameraInfo
from guidedvd3dgs_tpu.utils.graphics import fov2focal
from guidedvd3dgs_tpu_torch.scene.cameras import Camera
from guidedvd3dgs_tpu_torch.utils.image_io import read_png


def compute_resolution(orig_w: int, orig_h: int, args_resolution: int, resolution_scale: float):
    """Target (width, height): -r in {1, 2, 4, 8} divides; -1 caps the
    width at 1600 px; any other value is a target width."""
    if args_resolution in (1, 2, 4, 8):
        return (
            round(orig_w / (resolution_scale * args_resolution)),
            round(orig_h / (resolution_scale * args_resolution)),
        )
    if args_resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1
    else:
        global_down = orig_w / args_resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def image_to_chw(img_u8: np.ndarray, resolution) -> np.ndarray:
    """(H, W, C) uint8 -> (C, H', W') float32 in [0, 1] at resolution
    (W', H')."""
    w, h = resolution
    arr = img_u8.astype(np.float32)
    if (arr.shape[1], arr.shape[0]) != (w, h):
        t = torch.from_numpy(arr).permute(2, 0, 1)[None]
        t = F.interpolate(t, size=(h, w), mode="bicubic", align_corners=False, antialias=True)
        arr = torch.clamp(torch.round(t[0]), 0, 255).permute(1, 2, 0).numpy()
    return (arr / 255.0).transpose(2, 0, 1).astype(np.float32)


def load_cam(args, uid: int, info: CameraInfo, resolution_scale: float) -> Camera:
    img = read_png(info.image_path)
    resolution = compute_resolution(img.shape[1], img.shape[0], args.resolution, resolution_scale)
    rgb = image_to_chw(img, resolution)
    gt_alpha = None
    if rgb.shape[0] == 4:
        gt_alpha = rgb[3:4]
        rgb = rgb[:3]
    return Camera(
        colmap_id=info.uid,
        R=info.R,
        T=info.T,
        FoVx=info.FovX,
        FoVy=info.FovY,
        image=rgb,
        gt_alpha_mask=gt_alpha,
        image_name=info.image_name,
        uid=uid,
    )


def camera_list_from_infos(cam_infos: List[CameraInfo], resolution_scale: float, args):
    return [load_cam(args, i, c, resolution_scale) for i, c in enumerate(cam_infos)]


def camera_to_json(uid: int, camera) -> dict:
    """Camera entry of cameras.json."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = camera.R.transpose()
    Rt[:3, 3] = camera.T
    Rt[3, 3] = 1.0
    w2c = np.linalg.inv(Rt)
    pos = w2c[:3, 3]
    rot = w2c[:3, :3]
    return {
        "id": uid,
        "img_name": camera.image_name,
        "width": camera.image_width,
        "height": camera.image_height,
        "position": pos.tolist(),
        "rotation": [r.tolist() for r in rot],
        "fy": fov2focal(camera.FoVy, camera.image_height),
        "fx": fov2focal(camera.FoVx, camera.image_width),
    }
