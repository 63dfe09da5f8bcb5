"""Trajectory pose math of the guided trainer (host-side numpy, float64).

The port's own copy of `guidedvd3dgs_tpu/guidance/pose_math.py`, trimmed
to what the trainer calls (reference third_party/ViewCrafter/utils_vc/
pvd_utils.py:89-118 sphere2pose, :468-545 world_point_to_kth_my /
world_point_to_obj_my, :547-557 txt_interpolation; utils/
viewcrafter_wrapper.py:404-440 the candidate grid and the linear path).
These run once per trajectory on the host: poses, not tensors.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from scipy.interpolate import UnivariateSpline, interp1d


def sphere2pose(c2ws: np.ndarray, theta_deg: float, phi_deg: float, r: float) -> np.ndarray:
    """Translate along +z by r, then rotate theta about x and phi about y."""
    c2ws = np.array(c2ws, copy=True)
    c2ws[:, 2, 3] += r
    th = np.deg2rad(theta_deg)
    rot_x = np.array(
        [[1, 0, 0, 0],
         [0, np.cos(th), -np.sin(th), 0],
         [0, np.sin(th), np.cos(th), 0],
         [0, 0, 0, 1]], c2ws.dtype,
    )
    ph = np.deg2rad(phi_deg)
    rot_y = np.array(
        [[np.cos(ph), 0, np.sin(ph), 0],
         [0, 1, 0, 0],
         [-np.sin(ph), 0, np.cos(ph), 0],
         [0, 0, 0, 1]], c2ws.dtype,
    )
    return rot_y @ (rot_x @ c2ws)


def world_to_obj(poses: np.ndarray, k: int, r: float,
                 elevation_deg: float) -> Tuple[np.ndarray, np.ndarray]:
    """Recenter the world onto pose k, then onto an object frame at
    [0, 0, r] tilted by the elevation. Returns (poses in the object frame,
    transform_back: object frame -> world)."""
    kth = poses[k]
    poses = np.linalg.inv(kth)[None] @ poses
    el = np.deg2rad(180.0 - elevation_deg)
    R = np.array(
        [[1, 0, 0],
         [0, np.cos(el), np.sin(el)],
         [0, -np.sin(el), np.cos(el)]], poses.dtype,
    )
    pose_obj = np.eye(4, dtype=poses.dtype)
    pose_obj[:3, :3] = R
    pose_obj[:3, 3] = [0, 0, r]
    return np.linalg.inv(pose_obj)[None] @ poses, kth @ pose_obj


def txt_interpolation(values: Sequence[float], n: int, mode: str = "smooth") -> np.ndarray:
    x = np.linspace(0, 1, len(values))
    if mode == "smooth":
        f = UnivariateSpline(x, values, k=3)
    elif mode == "linear":
        f = interp1d(x, values)
    else:
        raise KeyError(f"Invalid txt interpolation mode: {mode}")
    return f(np.linspace(0, 1, n))


def candidate_pose_grid(
    c2w_obj: np.ndarray,  # (1, 4, 4) pose in the object frame
    transform_back: np.ndarray,  # (4, 4)
    d_phi: Sequence[float],
    d_theta: Sequence[float],
) -> Tuple[np.ndarray, List[Tuple[float, float, float]]]:
    """The (phi, theta) grid of candidate poses in the world frame, phi
    major, and each candidate's (phi, theta, r) offset."""
    cands, offsets = [], []
    for ph in d_phi:
        for th in d_theta:
            cands.append(sphere2pose(c2w_obj, float(th), float(ph), 0.0))
            offsets.append((float(ph), float(th), 0.0))
    return transform_back[None] @ np.concatenate(cands, 0), offsets


def _poses_along(c2w_obj, thetas, phis, rs) -> np.ndarray:
    return np.concatenate(
        [sphere2pose(c2w_obj, float(t), float(p), float(r)) for t, p, r in zip(thetas, phis, rs)], 0
    )


def interpolate_trajectory(c2w_obj: np.ndarray, d_phi: float, d_theta: float, d_r: float,
                           frames: int = 25) -> np.ndarray:
    """The linear path of `frames` poses to the offset, object frame."""
    return _poses_along(c2w_obj, np.linspace(0, d_theta, frames), np.linspace(0, d_phi, frames),
                        np.linspace(0, d_r * c2w_obj[0, 2, 3], frames))


# preset trajectories: phi / theta / r control points (the reference
# release's third_party/ViewCrafter/test/trajs/*.txt)
TRAJ_PRESETS = {
    "loop1": ([0, -3, -15, -20, -17, -5, 0], [0, -2, -5, -10, -8, -5, 0, 2, 5, 3, 0], [0, 0]),
    "loop2": ([0, 3, 10, 20, 17, 10, 0], [0, -2, -8, -6, 0, 2, 5, 3, 0],
              [0, -0.02, -0.09, -0.16, -0.09, 0]),
    "wave1": ([0, 30], [0, -1, -2, -1, 0, 3, 0, -3, 0, 1, 2], [0, 0]),
    "left": ([0, -40], [0, 0], [0.0, -0.2]),
    "zoomin1": ([0, 0], [0, 0], [0.0, -0.3]),
}


def traj_from_txt(c2w_obj: np.ndarray, phis: Sequence[float], thetas: Sequence[float],
                  rs: Sequence[float], frames: int = 25) -> np.ndarray:
    """A preset's control points splined (more than three) or interpolated
    linearly to `frames` poses, the spline's ends pinned to the first and
    last points (reference pvd_utils.py:235-285 generate_traj_txt_my)."""

    def interp(vals):
        if len(vals) > 3:
            out = txt_interpolation(vals, frames, "smooth")
            out[0], out[-1] = vals[0], vals[-1]
        else:
            out = txt_interpolation(vals, frames, "linear")
        return out

    phs, ths, rr = interp(list(phis)), interp(list(thetas)), interp(list(rs))
    return _poses_along(c2w_obj, ths, phs, rr * c2w_obj[0, 2, 3])

