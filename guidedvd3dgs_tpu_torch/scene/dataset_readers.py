"""Dataset readers: COLMAP scenes with fixed sparse-view splits.

The port's own copy of the `colmap` and `replica` readers of
`guidedvd3dgs_tpu/scene/dataset_readers.py` (pure numpy), which are the
ones the CLIs reach. Replica test views are every 10th frame within +/-50
of each train view of the fixed per-scene tables; a generic COLMAP scene
takes `train_test_split_<n>.json` when present, else every 8th frame as
the test set.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import List, NamedTuple

import numpy as np

from guidedvd3dgs_tpu_torch.scene import colmap
from guidedvd3dgs_tpu_torch.scene.ply import fetch_ply, store_ply
from guidedvd3dgs_tpu_torch.utils.graphics import BasicPointCloud, focal2fov, getWorld2View2


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray
    T: np.ndarray
    FovY: float
    FovX: float
    image_path: str
    image_name: str
    width: int
    height: int


class SceneInfo(NamedTuple):
    point_cloud: BasicPointCloud
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: dict
    ply_path: str


# fixed sparse-view train splits of the Replica scenes
REPLICA_TRAIN_IDX_6V = {
    "office2_seq2": [244, 291, 436, 607, 760, 831],
    "office3_seq1": [22, 98, 315, 504, 581, 731],
    "office4_seq2": [233, 305, 440, 555, 759, 806],
    "room0_seq2": [5, 80, 187, 392, 497, 658],
    "room1_seq1": [17, 39, 125, 349, 449, 840],
    "room2_seq1": [61, 178, 323, 485, 526, 758],
}
REPLICA_TRAIN_IDX_9V = {
    "office2_seq2": [159, 244, 291, 436, 510, 607, 684, 760, 831],
    "office3_seq1": [22, 98, 174, 264, 315, 504, 581, 633, 731],
    "office4_seq2": [49, 171, 233, 305, 440, 555, 655, 759, 806],
    "room0_seq2": [5, 80, 187, 296, 392, 497, 548, 658, 723],
    "room1_seq1": [17, 39, 125, 251, 349, 449, 542, 656, 840],
    "room2_seq1": [61, 178, 270, 323, 400, 485, 526, 601, 758],
}
REPLICA_TRAIN_IDX_3V = {
    "office2_seq2": [244, 291, 436],
    "office3_seq1": [22, 98, 315],
    "office4_seq2": [233, 305, 440],
    "room0_seq2": [392, 497, 658],
    "room1_seq1": [17, 39, 125],
    "room2_seq1": [323, 485, 526],
}
# project-page visualization splits (train == test anchors)
REPLICA_TRAIN_IDX_DEMO = {
    "office2_seq2": [244, 291, 436, 574, 760, 831],
    "office3_seq1": [22, 98, 187, 315, 504, 581],
    "room0_seq2": [80, 187, 392, 497, 658, 833],
    "office4_seq1": [0, 242, 370, 401, 554, 822],
}


def extract_number(s: str) -> int:
    m = re.findall(r"\d+", os.path.basename(str(s)))
    return int(m[-1]) if m else 0


def getNerfppNorm(cam_info: List[CameraInfo]) -> dict:
    """Scene radius and translate from the camera centers."""
    centers = []
    for cam in cam_info:
        w2c = getWorld2View2(cam.R, cam.T)
        c2w = np.linalg.inv(w2c)
        centers.append(c2w[:3, 3:4])
    centers = np.hstack(centers)
    avg = centers.mean(axis=1, keepdims=True)
    diagonal = np.linalg.norm(centers - avg, axis=0).max()
    return {"translate": -avg.flatten(), "radius": diagonal * 1.1}


def _fov_from_intrinsics(intr: colmap.ColmapCamera):
    if intr.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
        fx = fy = intr.params[0]
    elif intr.model == "PINHOLE":
        fx, fy = intr.params[0], intr.params[1]
    else:
        raise ValueError(f"unsupported COLMAP camera model {intr.model}")
    return focal2fov(fx, intr.width), focal2fov(fy, intr.height)


def _read_colmap_cameras(path: str, images_dir: str):
    sparse = os.path.join(path, "sparse", "0")
    try:
        extr = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        extr = colmap.read_images_text(os.path.join(sparse, "images.txt"))
        intr = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    rgb_mapping = [
        f
        for f in sorted(glob.glob(os.path.join(images_dir, "*")), key=extract_number)
        if f.lower().endswith((".jpg", ".png", ".jpeg"))
    ]

    infos = []
    keys = sorted(extr.keys(), key=lambda k: extract_number(extr[k].name))
    for idx, key in enumerate(keys):
        im = extr[key]
        cam = intr[im.camera_id]
        fovx, fovy = _fov_from_intrinsics(cam)
        image_path = rgb_mapping[idx] if idx < len(rgb_mapping) else os.path.join(images_dir, im.name)
        infos.append(
            CameraInfo(
                uid=cam.id,
                R=colmap.qvec2rotmat(im.qvec).T,
                T=np.array(im.tvec),
                FovY=fovy,
                FovX=fovx,
                image_path=image_path,
                image_name=os.path.splitext(os.path.basename(image_path))[0],
                width=cam.width,
                height=cam.height,
            )
        )
    return infos


def replica_scene_key(path: str) -> str:
    """'.../office_3/Sequence_1' -> 'office3_seq1'."""
    parts = path.rstrip("/").split("/")
    scene, seq = parts[-2], parts[-1]
    base, sid = scene.split("_")[0], scene.split("_")[1]
    seq_id = seq.split("_")[1]
    return f"{base}{sid}_seq{seq_id}"


def replica_test_indices(train_idx: List[int], num_cams: int) -> List[int]:
    """Every 10th frame within +/-50 of each train view."""
    test_idx = []
    for idx in train_idx:
        left = list(range(max(0, idx - 50), idx))
        right = list(range(idx + 1, min(idx + 50, num_cams)))
        test_idx.extend((left + right)[::10])
    return sorted(set(test_idx))


def read_colmap_scene(
    path: str,
    images: str,
    dataset: str,
    eval: bool = True,
    n_views: int = 6,
    ply_path: str = "",
    demo_setting: bool = False,
) -> SceneInfo:
    """A COLMAP scene with its sparse-view split. `ply_path` overrides the
    scene's own `sparse/0/points3D.ply` (e.g. a DUSt3R point cloud)."""
    cam_infos = _read_colmap_cameras(path, os.path.join(path, images or "images"))

    dataset_l = dataset.lower()
    if eval:
        if dataset_l == "replica":
            key = replica_scene_key(path)
            if demo_setting:
                train_idx = REPLICA_TRAIN_IDX_DEMO[key]
                test_idx = replica_test_indices(train_idx, len(cam_infos))
            else:
                table = {6: REPLICA_TRAIN_IDX_6V, 9: REPLICA_TRAIN_IDX_9V, 3: REPLICA_TRAIN_IDX_3V}
                train_idx = table[n_views][key]
                # test views for 6 and 9 views both derive from the 6-view anchors
                anchors = REPLICA_TRAIN_IDX_6V[key] if n_views in (6, 9) else train_idx
                test_idx = replica_test_indices(anchors, len(cam_infos))
        elif dataset_l in ("colmap", "custom"):
            split_json = os.path.join(path, f"train_test_split_{n_views}.json")
            if os.path.exists(split_json):
                with open(split_json) as f:
                    splits = json.load(f)
                train_idx, test_idx = splits["train_ids"], splits["test_ids"]
            else:
                test_idx = list(range(0, len(cam_infos), 8))
                train_idx = [i for i in range(len(cam_infos)) if i % 8 != 0]
        else:
            raise NotImplementedError(
                f"dataset {dataset!r}: the port reads 'replica' and 'colmap' scenes"
            )
        train_cams = [c for i, c in enumerate(cam_infos) if i in set(train_idx)]
        test_cams = [c for i, c in enumerate(cam_infos) if i in set(test_idx)]
    else:
        train_cams, test_cams = cam_infos, []

    if not ply_path:
        ply_path = os.path.join(path, "sparse", "0", "points3D.ply")
        if not os.path.exists(ply_path):
            sparse = os.path.join(path, "sparse", "0")
            for reader, fname in (
                (colmap.read_points3D_binary, "points3D.bin"),
                (colmap.read_points3D_text, "points3D.txt"),
            ):
                p = os.path.join(sparse, fname)
                if os.path.exists(p):
                    xyz, rgb, _ = reader(p)
                    store_ply(ply_path, xyz, rgb)
                    break
    pcd = fetch_ply(ply_path)

    return SceneInfo(
        point_cloud=pcd,
        train_cameras=train_cams,
        test_cameras=test_cams,
        nerf_normalization=getNerfppNorm(train_cams),
        ply_path=ply_path,
    )
