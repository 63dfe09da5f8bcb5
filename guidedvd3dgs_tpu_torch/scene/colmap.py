"""COLMAP sparse-reconstruction parsers and text writers.

The port's own copy of `guidedvd3dgs_tpu/scene/colmap.py` (pure numpy):
cameras, images and points3D in binary and text form, written from the
COLMAP file-format spec.
"""

from __future__ import annotations

import struct
from typing import Dict, NamedTuple

import numpy as np


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray  # (4,) w,x,y,z
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray  # (P, 2)
    point3D_ids: np.ndarray  # (P,)


# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """Quaternion (w,x,y,z) -> rotation matrix (COLMAP convention)."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w,x,y,z), largest-component-stable."""
    m00, m01, m02 = R[0]
    m10, m11, m12 = R[1]
    m20, m21, m22 = R[2]
    tr = m00 + m11 + m22
    if tr > 0:
        s = 0.5 / np.sqrt(tr + 1.0)
        q = np.array([0.25 / s, (m21 - m12) * s, (m02 - m20) * s, (m10 - m01) * s])
    elif m00 > m11 and m00 > m22:
        s = 2.0 * np.sqrt(1.0 + m00 - m11 - m22)
        q = np.array([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s])
    elif m11 > m22:
        s = 2.0 * np.sqrt(1.0 + m11 - m00 - m22)
        q = np.array([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s])
    else:
        s = 2.0 * np.sqrt(1.0 + m22 - m00 - m11)
        q = np.array([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s])
    if q[0] < 0:
        q = -q
    return q


def _read(f, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{num_params}d"))
            cams[cam_id] = ColmapCamera(cam_id, name, width, height, params)
    return cams


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_p,) = _read(f, "<Q")
            blob = np.frombuffer(f.read(24 * num_p), dtype=np.float64).reshape(num_p, 3)
            xys = blob[:, :2].copy()
            ids = blob[:, 2].view(np.int64).copy()
            images[image_id] = ColmapImage(
                image_id, qvec, tvec, camera_id, name.decode("utf-8"), xys, ids
            )
    return images


def read_points3D_binary(path: str):
    xyzs, rgbs, errors = [], [], []
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<QdddBBBd")
            xyzs.append(vals[1:4])
            rgbs.append(vals[4:7])
            errors.append(vals[7])
            (track_len,) = _read(f, "<Q")
            f.seek(8 * track_len, 1)
    return np.array(xyzs), np.array(rgbs), np.array(errors)


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            model = parts[1]
            width, height = int(parts[2]), int(parts[3])
            params = np.array([float(p) for p in parts[4:]])
            cams[cam_id] = ColmapCamera(cam_id, model, width, height, params)
    return cams


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        # keep EMPTY lines: the points2D line of an image with no registered
        # points is blank (e.g. the dataset_to_colmap converters write it so)
        lines = [ln.strip() for ln in f if not ln.strip().startswith("#")]
    while lines and not lines[-1]:
        lines.pop()
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        image_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        camera_id = int(parts[8])
        name = parts[9]
        if i + 1 < len(lines):
            elems = lines[i + 1].split()
            xys = np.array(elems, dtype=np.float64).reshape(-1, 3)[:, :2] if elems else np.zeros((0, 2))
            ids = (
                np.array(elems, dtype=np.float64).reshape(-1, 3)[:, 2].astype(np.int64)
                if elems
                else np.zeros((0,), np.int64)
            )
        else:
            xys, ids = np.zeros((0, 2)), np.zeros((0,), np.int64)
        images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name, xys, ids)
    return images


def read_points3D_text(path: str):
    xyzs, rgbs, errors = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyzs.append([float(p) for p in parts[1:4]])
            rgbs.append([int(p) for p in parts[4:7]])
            errors.append(float(parts[7]))
    return np.array(xyzs), np.array(rgbs), np.array(errors)


def write_cameras_text(path: str, cams: Dict[int, ColmapCamera]):
    with open(path, "w") as f:
        f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
        for cam in cams.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def write_images_text(path: str, images: Dict[int, ColmapImage]):
    with open(path, "w") as f:
        f.write("# Image list: IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME\n")
        for im in images.values():
            q = " ".join(repr(float(v)) for v in im.qvec)
            t = " ".join(repr(float(v)) for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n\n")
