"""Lifting generated frames to 3D points by monocular depth (numpy).

Counterpart of `guidedvd3dgs_tpu/guidance/depth_lift.py` (the reference's
utils/midas_depth_estimator.py:46-120 get_scaleshift / convert_rel_to_real
and utils/inpainted_depth_to_pointcloud.py:13-55, used by train_guidedvd.py:
569-612 when append_pcd_from_video_diffusion is on): the relative depth of
each frame fitted to the rendered depth where the scene is observed, then
the unobserved pixels unprojected along the trajectory.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def fit_scale_shift(rel_depth: np.ndarray, real_depth: np.ndarray,
                    mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per frame, least squares of rel_depth (N, H, W) against 1 / real_depth
    on the mask (lstsq_strategy 'each'): (scales, shifts)."""
    n = rel_depth.shape[0]
    rel = rel_depth.reshape(n, -1)
    real = real_depth.reshape(n, -1)
    m = mask.reshape(n, -1).astype(bool)
    scales, shifts = [], []
    for i in range(n):
        x = rel[i][m[i]]
        y = 1.0 / real[i][m[i]]
        A = np.vstack([x, 1 - x]).T
        s, t = np.linalg.lstsq(A, y, rcond=None)[0]
        min_depth, max_depth = 1 / s, 1 / t
        scales.append((1 / min_depth) - (1 / max_depth))
        shifts.append(1 / max_depth)
    return np.asarray(scales), np.asarray(shifts)


def rel_to_metric(rel_depth: np.ndarray, scale: np.ndarray, shift: np.ndarray) -> np.ndarray:
    return 1.0 / (scale[:, None, None] * rel_depth + shift[:, None, None])


def depth_to_point_cloud(depth_map: np.ndarray, intrinsic: np.ndarray, c2w: np.ndarray,
                         mask: np.ndarray, rgb_map: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The pixels where mask == 1 of depth_map (H, W) unprojected through K
    and c2w: (world points (M, 3), their colours (M, 3))."""
    h, w = depth_map.shape
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    sel = mask.flatten() == 1
    u, v = u.flatten()[sel], v.flatten()[sel]
    depth = depth_map.flatten()[sel]
    rgb = rgb_map.reshape(-1, 3)[sel]
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    x = (u - cx) * depth / fx
    y = (v - cy) * depth / fy
    pts_cam = np.vstack([x, y, depth, np.ones_like(depth)])
    return (c2w @ pts_cam)[:3].T, rgb


def lift_video_to_points(frames: np.ndarray, rel_depth: np.ndarray, gs_depth: np.ndarray,
                         observed_mask: np.ndarray, traj_c2ws: np.ndarray, intrinsic: np.ndarray,
                         frame_gap: int = 5) -> Tuple[np.ndarray, np.ndarray]:
    """frames (N, H, W, 3) in [0, 1], their relative depth, the rendered
    depth and the observed mask (N, H, W), the trajectory (N, 4, 4): the
    unobserved pixels of every frame (where the diffusion inpainted) lifted
    at the fitted metric depth, every `frame_gap`-th point of a frame, the
    non-finite dropped. (points (M, 3), colours (M, 3)) float32."""
    scale, shift = fit_scale_shift(rel_depth, gs_depth, observed_mask)
    metric = rel_to_metric(rel_depth, scale, shift)
    pts, rgbs = [], []
    for i in range(frames.shape[0]):
        p, c = depth_to_point_cloud(metric[i], intrinsic, traj_c2ws[i], 1.0 - observed_mask[i], frames[i])
        pts.append(p[::frame_gap])
        rgbs.append(c[::frame_gap])
    pts = np.concatenate(pts, 0).astype(np.float32)
    rgbs = np.concatenate(rgbs, 0).astype(np.float32)
    ok = np.isfinite(pts).all(1) & np.isfinite(rgbs).all(1)
    return pts[ok], rgbs[ok]
