"""Dataset readers: COLMAP scenes with fixed sparse-view splits, and
Blender (NeRF-synthetic) transforms.

The port's own copy of `guidedvd3dgs_tpu/scene/dataset_readers.py` (pure
numpy). Replica test views are every 10th frame within +/-50 of each train
view of the fixed per-scene tables; ScanNet++ takes the train frames of
its fixed table by the number in each image's file name, and every 6th
frame of the covered range (+/-10) but those as the test set; re10k reads
`train_test_split_<n>.json`; a generic COLMAP scene takes that file when
present, else every 8th frame as the test set. With `projected_dir`, a
camera carries the paths of its point-cloud projection
`<projected_dir>/<image stem>.png` and mask `<image stem>_mask.npy` where
they exist; a Replica scene read with `replica_use_project_cam` has every
6th camera of the trajectory as a projection camera.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import List, NamedTuple, Optional

import numpy as np

from guidedvd3dgs_tpu_torch.scene import colmap
from guidedvd3dgs_tpu_torch.scene.ply import fetch_ply, store_ply
from guidedvd3dgs_tpu_torch.utils.graphics import BasicPointCloud, focal2fov, fov2focal, getWorld2View2
from guidedvd3dgs_tpu_torch.utils.image_io import png_size


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
    fid: int = 0  # the camera's place among the train cameras
    bounds: Optional[np.ndarray] = None
    projected_image_path: Optional[str] = None
    projected_mask_path: Optional[str] = None


class SceneInfo(NamedTuple):
    point_cloud: BasicPointCloud
    train_indices: list
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    all_cameras: List[CameraInfo]
    project_cameras: Optional[List[CameraInfo]]
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
# the ScanNet++ scenes' train frames, by the number in the image file name
SCANNETPP_TRAIN_ID = {
    "8a20d62ac0": [9, 85, 134, 172, 329, 380],
    "94ee15e8ba": [3057, 3107, 3177, 3184, 3274, 3302],
    "a29cccc784": [848, 865, 928, 947, 1006, 1040],
    "7831862f02": [3872, 3905, 3954, 3960, 3999, 4051],
}


def farthest_point_sampling(points: np.ndarray, k: int, seed=None) -> np.ndarray:
    """Greedy farthest-point subsample of an (N, D) cloud: k rows, the
    first at a random index drawn from `np.random.default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    n = points.shape[0]
    out = np.zeros((k, points.shape[1]), points.dtype)
    distances = np.full(n, np.inf)
    farthest = int(rng.integers(0, n))
    for i in range(k):
        out[i] = points[farthest]
        dist = np.sum((points - points[farthest]) ** 2, axis=1)
        distances = np.minimum(distances, dist)
        farthest = int(np.argmax(distances))
    return out


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


def colmap_views(path: str, images_dir: str):
    """The scene's COLMAP views in the readers' order (by the number in
    each image's name): [(ColmapImage, ColmapCamera, image path)], and the
    image files of `images_dir` sorted by the number in their names (the
    i-th view takes the i-th file)."""
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
    keys = sorted(extr.keys(), key=lambda k: extract_number(extr[k].name))
    views = []
    for idx, key in enumerate(keys):
        im = extr[key]
        image_path = rgb_mapping[idx] if idx < len(rgb_mapping) else os.path.join(images_dir, im.name)
        views.append((im, intr[im.camera_id], image_path))
    return views, rgb_mapping


def image_stem(image_path: str) -> str:
    return os.path.splitext(os.path.basename(image_path))[0]


def _read_colmap_cameras(path: str, images_dir: str, projected_dir: Optional[str] = None):
    views, rgb_mapping = colmap_views(path, images_dir)
    infos = []
    for im, cam, image_path in views:
        fovx, fovy = _fov_from_intrinsics(cam)
        name = image_stem(image_path)
        proj_img = proj_mask = None
        if projected_dir is not None:
            cand = os.path.join(projected_dir, f"{name}.png")
            cand_mask = os.path.join(projected_dir, f"{name}_mask.npy")
            proj_img = cand if os.path.exists(cand) else None
            proj_mask = cand_mask if os.path.exists(cand_mask) else None
        infos.append(
            CameraInfo(
                uid=cam.id,
                R=colmap.qvec2rotmat(im.qvec).T,
                T=np.array(im.tvec),
                FovY=fovy,
                FovX=fovx,
                image_path=image_path,
                image_name=name,
                width=cam.width,
                height=cam.height,
                bounds=np.array([1.0, 10.0]),
                projected_image_path=proj_img,
                projected_mask_path=proj_mask,
            )
        )
    return infos, rgb_mapping


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


def scannetpp_test_indices(train_indices: List[int], num_cams: int, gap: int = 6) -> List[int]:
    """Every `gap`th frame of the range the train frames cover (+/-10),
    the train frames excluded."""
    extend = 10
    start = max(train_indices[0] - extend, 0)
    end = min(train_indices[-1] + extend + 1, num_cams)
    test = list(range(start, end))[::gap]
    return [i for i in test if i not in train_indices]


def _split_json(path: str, n_views: int):
    with open(os.path.join(path, f"train_test_split_{n_views}.json")) as f:
        splits = json.load(f)
    return splits["train_ids"], splits["test_ids"]


def read_colmap_scene(
    path: str,
    images: str,
    dataset: str,
    eval: bool = True,
    n_views: int = 6,
    ply_path: str = "",
    replica_use_project_cam: bool = False,
    projected_dir: Optional[str] = None,
    demo_setting: bool = False,
) -> SceneInfo:
    """A COLMAP scene with its sparse-view split. `ply_path` overrides the
    scene's own `sparse/0/points3D.ply` (e.g. a DUSt3R point cloud)."""
    cam_infos, rgb_mapping = _read_colmap_cameras(path, os.path.join(path, images or "images"),
                                                  projected_dir)

    dataset_l = dataset.lower()
    project_cam_infos = None
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
            if replica_use_project_cam:
                project_cam_infos = cam_infos[::6]
        elif dataset_l == "scannetpp":
            scene_id = path.rstrip("/").split("/")[-1]
            suffixes = [extract_number(p) for p in rgb_mapping]
            train_idx = [suffixes.index(t) for t in sorted(SCANNETPP_TRAIN_ID[scene_id])]
            test_idx = scannetpp_test_indices(train_idx, len(cam_infos))
        elif dataset_l == "re10k":
            train_idx, test_idx = _split_json(path, n_views)
        elif dataset_l in ("colmap", "custom"):
            if os.path.exists(os.path.join(path, f"train_test_split_{n_views}.json")):
                train_idx, test_idx = _split_json(path, n_views)
            else:
                test_idx = list(range(0, len(cam_infos), 8))
                train_idx = [i for i in range(len(cam_infos)) if i % 8 != 0]
        else:
            raise NotImplementedError(
                f"dataset {dataset!r}: the port reads 'replica', 'scannetpp', 're10k' and "
                "'colmap' (or 'custom') COLMAP scenes, and Blender scenes by their transforms"
            )
        train_cams = [c for i, c in enumerate(cam_infos) if i in set(train_idx)]
        test_cams = [c for i, c in enumerate(cam_infos) if i in set(test_idx)]
    else:
        train_idx = list(range(len(cam_infos)))
        train_cams, test_cams = cam_infos, []
    train_cams = [c._replace(fid=i) for i, c in enumerate(train_cams)]

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
        train_indices=list(train_idx),
        train_cameras=train_cams,
        test_cameras=test_cams,
        all_cameras=cam_infos,
        project_cameras=project_cam_infos,
        nerf_normalization=getNerfppNorm(train_cams),
        ply_path=ply_path,
    )


def read_blender_scene(path: str, white_background: bool, eval: bool, extension: str = ".png") -> SceneInfo:
    """A NeRF-synthetic scene: `transforms_{train,test}.json` (Blender
    c2w, y and z flipped to COLMAP's), and `points3d.ply`, written first
    as 100,000 random points in [-1.3, 1.3]^3 (seed 0) when absent."""

    def read_split(transformsfile):
        infos = []
        with open(os.path.join(path, transformsfile)) as f:
            contents = json.load(f)
        fovx = contents["camera_angle_x"]
        for idx, frame in enumerate(contents["frames"]):
            image_path = os.path.join(path, frame["file_path"] + extension)
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1
            w2c = np.linalg.inv(c2w)
            width, height = png_size(image_path)
            infos.append(
                CameraInfo(
                    uid=idx,
                    R=w2c[:3, :3].T,
                    T=w2c[:3, 3],
                    FovY=focal2fov(fov2focal(fovx, width), height),
                    FovX=fovx,
                    image_path=image_path,
                    image_name=os.path.basename(frame["file_path"]),
                    width=width,
                    height=height,
                    fid=idx,
                )
            )
        return infos

    train_cams = read_split("transforms_train.json")
    test_cams = read_split("transforms_test.json") if eval else []

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        n = 100_000
        rng = np.random.default_rng(0)
        xyz = rng.random((n, 3)) * 2.6 - 1.3
        store_ply(ply_path, xyz, rng.random((n, 3)) * 255)
    pcd = fetch_ply(ply_path)

    return SceneInfo(
        point_cloud=pcd,
        train_indices=list(range(len(train_cams))),
        train_cameras=train_cams,
        test_cameras=test_cams,
        all_cameras=train_cams + test_cams,
        project_cameras=None,
        nerf_normalization=getNerfppNorm(train_cams),
        ply_path=ply_path,
    )
