"""Append points lifted from inpainted depth to a scene's point cloud.

Counterpart of `tools/augment_ply_with_depth.py` (the reference's
utils/inpainted_depth_to_pointcloud.py:119-185): for each COLMAP image
(every `--every`-th by name) with all three of `<rgb_dir>/<stem>.png`,
`<depth_dir>/<stem>.npy` and `<mask_dir>/<stem>.png` (white = lift), the
masked pixels unprojected through the image's camera, every `--stride`-th
point kept, appended to the ply:

    python -m guidedvd3dgs_tpu_torch.augment_ply_with_depth \\
        --ply <in>/sparse/0/points3D.ply --sparse <in>/sparse/0 \\
        --rgb_dir ... --depth_dir ... --mask_dir ... --out <out>/sparse/0/points3D.ply

PNGs are read by the port's own decoder; a colour mask is taken to gray as
PIL's convert("L") does.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from guidedvd3dgs_tpu_torch.guidance.depth_lift import depth_to_point_cloud
from guidedvd3dgs_tpu_torch.scene import colmap as C
from guidedvd3dgs_tpu_torch.scene.ply import fetch_ply, store_ply
from guidedvd3dgs_tpu_torch.utils.image_io import load_image, read_png


def _intrinsic_of(cam: C.ColmapCamera) -> np.ndarray:
    p = np.asarray(cam.params, np.float64)
    if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
        fx = fy = p[0]
        cx, cy = p[1], p[2]
    else:  # PINHOLE and the OpenCV models' leading parameters
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


def load_colmap(sparse_dir: str):
    for read_c, read_i, ext in ((C.read_cameras_binary, C.read_images_binary, ".bin"),
                                (C.read_cameras_text, C.read_images_text, ".txt")):
        cpath = os.path.join(sparse_dir, "cameras" + ext)
        ipath = os.path.join(sparse_dir, "images" + ext)
        if os.path.exists(cpath) and os.path.exists(ipath):
            return read_c(cpath), read_i(ipath)
    raise FileNotFoundError(f"no cameras/images .bin or .txt in {sparse_dir}")


def read_gray(path: str) -> np.ndarray:
    """(H, W) uint8: a gray PNG as stored (its alpha dropped), a colour one
    by ITU-R 601-2 luma in PIL's fixed point."""
    img = read_png(path).astype(np.uint32)
    if img.shape[2] <= 2:
        return img[..., 0].astype(np.uint8)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def augment(ply_path: str, sparse_dir: str, rgb_dir: str, depth_dir: str, mask_dir: str, out_path: str,
            every: int = 1, stride: int = 10) -> int:
    """Write the augmented ply; returns its point count."""
    cams, images = load_colmap(sparse_dir)
    base = fetch_ply(ply_path)
    pts_all, cols_all = [], []
    used = 0
    for im in sorted(images.values(), key=lambda im: im.name)[::every]:
        stem = os.path.splitext(os.path.basename(im.name))[0]
        rgb_f = os.path.join(rgb_dir, stem + ".png")
        dep_f = os.path.join(depth_dir, stem + ".npy")
        msk_f = os.path.join(mask_dir, stem + ".png")
        if not (os.path.exists(rgb_f) and os.path.exists(dep_f) and os.path.exists(msk_f)):
            continue
        w2c = np.eye(4)
        w2c[:3, :3] = C.qvec2rotmat(im.qvec)
        w2c[:3, 3] = im.tvec
        mask = read_gray(msk_f) / 255.0 > 0.5
        rgb = load_image(rgb_f) / 255.0
        pts, cols = depth_to_point_cloud(np.load(dep_f), _intrinsic_of(cams[im.camera_id]),
                                         np.linalg.inv(w2c), mask.astype(np.float64), rgb)
        pts_all.append(pts[::stride])
        cols_all.append(cols[::stride])
        used += 1
        print(f"  {im.name}: +{pts[::stride].shape[0]} points")
    if not pts_all:
        raise RuntimeError("no (rgb, depth, mask) triplets matched any camera")
    all_pts = np.concatenate([np.asarray(base.points)] + pts_all, 0)
    all_cols = np.concatenate([np.asarray(base.colors)] + cols_all, 0)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    store_ply(out_path, all_pts, (all_cols * 255).astype(np.uint8))
    print(f"{used} views lifted; {base.points.shape[0]} -> {all_pts.shape[0]} points -> {out_path}")
    return all_pts.shape[0]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="append points lifted from inpainted depth to a ply")
    ap.add_argument("--ply", required=True)
    ap.add_argument("--sparse", required=True, help="COLMAP sparse/0 dir")
    ap.add_argument("--rgb_dir", required=True)
    ap.add_argument("--depth_dir", required=True)
    ap.add_argument("--mask_dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--every", type=int, default=1, help="take every N-th camera (the reference used 6)")
    ap.add_argument("--stride", type=int, default=10, help="keep every N-th lifted point (the reference's ::10)")
    a = ap.parse_args(argv)
    return augment(a.ply, a.sparse, a.rgb_dir, a.depth_dir, a.mask_dir, a.out, a.every, a.stride)


if __name__ == "__main__":
    main()
