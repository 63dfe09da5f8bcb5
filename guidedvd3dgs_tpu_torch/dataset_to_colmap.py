"""Raw dataset -> COLMAP sparse/0 text files.

The port's copy of `tools/dataset_to_colmap.py` (the reference's
tools/replica_to_colmap.py, scannetpp_to_colmap.py and re10k_to_colmap.py
behind one CLI), the first step of a run from raw data:

    python -m guidedvd3dgs_tpu_torch.dataset_to_colmap replica   --base <.../Replica> [--scenes ...]
    python -m guidedvd3dgs_tpu_torch.dataset_to_colmap scannetpp --base <.../scannetpp> [--scenes ...]
    python -m guidedvd3dgs_tpu_torch.dataset_to_colmap re10k     --base <scene_dir>

Each scene gets sparse/0/{cameras.txt, images.txt}: one PINHOLE camera per
frame, the w2c rotation as a (w, x, y, z) quaternion. Replica reads
`traj_w_c.txt` (c2w rows) and the size of `rgb/rgb_0.png` (hfov 90);
ScanNet++ `dslr/nerfstudio/transforms_undistorted.json` (train and test
frames by file name, oriented and centred on the poses' mean, scaled to
a unit box, OpenGL -> OpenCV); re10k `transforms.json`.
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import List, Optional

import numpy as np

from guidedvd3dgs_tpu_torch.scene.colmap import rotmat2qvec
from guidedvd3dgs_tpu_torch.utils.image_io import png_size

REPLICA_SCENES = [
    "office_2/Sequence_2", "office_3/Sequence_1", "office_4/Sequence_2",
    "room_0/Sequence_2", "room_1/Sequence_1", "room_2/Sequence_1",
]
SCANNETPP_SCENES = ["8a20d62ac0", "94ee15e8ba", "7831862f02", "a29cccc784"]
DEFAULT_SCENES = {"replica": REPLICA_SCENES, "scannetpp": SCANNETPP_SCENES, "re10k": [""]}


def save_cameras_txt(path: str, intrinsics: np.ndarray, H: int, W: int) -> None:
    """cameras.txt: camera i is PINHOLE W H fx fy cx cy of intrinsics[i]."""
    with open(os.path.join(path, "cameras.txt"), "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("# CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for i, K in enumerate(intrinsics):
            f.write(f"{i} PINHOLE {W} {H} {K[0, 0]} {K[1, 1]} {K[0, 2]} {K[1, 2]}\n")


def save_images_txt(path: str, w2c: np.ndarray, name_fmt: str = "{}.png") -> None:
    """images.txt: image i has the pose w2c[i], camera i and no 2D points."""
    with open(os.path.join(path, "images.txt"), "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("# IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("# POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for i in range(w2c.shape[0]):
            qw, qx, qy, qz = rotmat2qvec(w2c[i, :3, :3])
            tx, ty, tz = w2c[i, :3, 3]
            f.write(f"{i} {qw} {qx} {qy} {qz} {tx} {ty} {tz} {i} {name_fmt.format(i)}\n\n")


def load_replica(basedir: str):
    """(w2c (N, 4, 4), K (N, 3, 3), H, W) of a Replica sequence."""
    poses_w2c = []
    with open(os.path.join(basedir, "traj_w_c.txt")) as fp:
        for line in fp:
            c2w = np.array([float(t) for t in line.split()]).reshape(4, 4)
            poses_w2c.append(np.linalg.inv(c2w))
    poses_w2c = np.stack(poses_w2c, 0).astype(np.float32)
    W, H = png_size(os.path.join(basedir, "rgb", "rgb_0.png"))
    focal = W / 2.0 / math.tan(math.radians(90 / 2.0))  # hfov 90
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    return poses_w2c, np.repeat(K[None], len(poses_w2c), 0).astype(np.float32), H, W


def _rotation_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The rotation taking unit vector a to b (Rodrigues)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(a @ b)
    if np.linalg.norm(v) < 1e-10:
        return np.eye(3) if c > 0 else -np.eye(3)
    skew = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + skew + skew @ skew * ((1 - c) / (np.linalg.norm(v) ** 2))


def auto_orient_and_center_poses(poses: np.ndarray, method="up", center_method="poses"):
    """nerfstudio's orientation, its 'up' + 'poses' path: the mean up vector
    to +z, the poses' mean to the origin. (oriented (N, 3, 4), transform)."""
    origins = poses[:, :3, 3]
    translation = origins.mean(0) if center_method == "poses" else np.zeros(3)
    up = poses[:, :3, 1].mean(0)
    up = up / np.linalg.norm(up)
    rotation = _rotation_between(up, np.array([0, 0, 1.0]))
    transform = np.concatenate([rotation, rotation @ -translation[:, None]], -1)
    return transform[None] @ poses, transform


def load_scannetpp(basedir: str):
    with open(os.path.join(basedir, "dslr/nerfstudio/transforms_undistorted.json")) as f:
        meta = json.load(f)
    K = np.eye(3)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = meta["fl_x"], meta["fl_y"], meta["cx"], meta["cy"]
    H, W = meta["h"], meta["w"]
    frames = meta["frames"] + meta["test_frames"]
    frames.sort(key=lambda x: x["file_path"])
    poses = np.array([f["transform_matrix"] for f in frames], np.float32)

    poses34, _ = auto_orient_and_center_poses(poses, "up", "poses")
    poses34[:, :3, 3] /= float(np.max(np.abs(poses34[:, :3, 3])))
    # OpenGL (right-up-back) -> OpenCV (right-down-forward)
    R = poses34[:, :3, :3]
    R = np.stack([R[:, :, 0], -R[:, :, 1], -R[:, :, 2]], -1)
    poses4 = np.concatenate([np.concatenate([R, poses34[:, :3, 3:]], -1),
                             np.repeat(np.eye(4)[None, 3:], len(poses34), 0)], 1)
    w2c = np.stack([np.linalg.inv(p) for p in poses4], 0).astype(np.float32)
    return w2c, np.repeat(K[None], len(w2c), 0).astype(np.float32), H, W


def load_re10k(scene_dir: str):
    blender2opencv = np.diag([1.0, -1.0, -1.0, 1.0])
    with open(os.path.join(scene_dir, "transforms.json")) as f:
        meta = json.load(f)
    H, W = meta["h"], meta["w"]
    K = np.array([[meta["fl_x"], 0, meta["cx"]], [0, meta["fl_y"], meta["cy"]], [0, 0, 1]], np.float32)
    w2cs = np.stack([np.linalg.inv(np.array(f["transform_matrix"]) @ blender2opencv)
                     for f in meta["frames"]], 0).astype(np.float32)
    return w2cs, np.repeat(K[None], len(w2cs), 0), H, W


LOADERS = {"replica": load_replica, "scannetpp": load_scannetpp, "re10k": load_re10k}


def convert(dataset: str, base: str, scenes: List[str]) -> List[str]:
    """Write sparse/0 of each scene under `base`; the scenes' paths."""
    done = []
    for scene in scenes or [""]:
        path = os.path.join(base, scene) if scene else base
        w2c, Ks, H, W = LOADERS[dataset](path)
        sparse = os.path.join(path, "sparse/0")
        os.makedirs(sparse, exist_ok=True)
        save_cameras_txt(sparse, Ks, H, W)
        save_images_txt(sparse, w2c)
        print(path)
        done.append(path)
    return done


def main(argv: Optional[List[str]] = None) -> List[str]:
    p = argparse.ArgumentParser(description="raw dataset -> COLMAP sparse/0 text files")
    p.add_argument("dataset", choices=sorted(LOADERS))
    p.add_argument("--base", required=True)
    p.add_argument("--scenes", nargs="*", default=None)
    a = p.parse_args(argv)
    return convert(a.dataset, a.base, a.scenes if a.scenes is not None else DEFAULT_SCENES[a.dataset])


if __name__ == "__main__":
    main()
