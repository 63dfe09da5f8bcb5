"""Project a scene's point cloud to every k-th view, for the project-cam
trainer.

Counterpart of `tools/project_pcd_to_views.py`, writing what the readers
read: for every `--every`-th view in the readers' order (the Replica
projection cameras are every 6th), `<source>/<out>/<image stem>.png` (the
projection, `scene/pcd2img.py`) and `<image stem>_mask.npy` (uint8 (H, W),
1 where a point landed), the stem being that of the view's image file
under `<source>/<images>`:

    python -m guidedvd3dgs_tpu_torch.project_pcd_to_views --source <scene> --ply <points3D.ply>
        [--images rgb] [--every 6] [--out projected_dir]

The views are projected on a thread pool (numpy releases the interpreter
lock in its sorts and products, zlib in its compression).
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from guidedvd3dgs_tpu_torch.scene import colmap
from guidedvd3dgs_tpu_torch.scene.dataset_readers import colmap_views, image_stem
from guidedvd3dgs_tpu_torch.scene.pcd2img import project_point_cloud_to_image
from guidedvd3dgs_tpu_torch.scene.ply import fetch_ply
from guidedvd3dgs_tpu_torch.utils.image_io import save_image


def intrinsics(cam: colmap.ColmapCamera) -> np.ndarray:
    if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
        f, cx, cy = cam.params[:3]
        fx = fy = f
    elif cam.model == "PINHOLE":
        fx, fy, cx, cy = cam.params[:4]
    else:
        raise ValueError(f"unsupported COLMAP camera model {cam.model}")
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


def project_views(source: str, ply: str, images: str = "images", every: int = 6,
                  out: str = "projected_dir") -> List[str]:
    """Write the projections and masks; returns the stems written."""
    views, _ = colmap_views(source, os.path.join(source, images))
    pcd = fetch_ply(ply)
    pts, cols = np.asarray(pcd.points), np.asarray(pcd.colors)
    out_dir = os.path.join(source, out)
    os.makedirs(out_dir, exist_ok=True)

    def one(view) -> str:
        im, cam, image_path = view
        w2c = np.eye(4)
        w2c[:3, :3] = colmap.qvec2rotmat(im.qvec)
        w2c[:3, 3] = im.tvec
        image, mask = project_point_cloud_to_image(pts, cols, intrinsics(cam), w2c, cam.width, cam.height)
        stem = image_stem(image_path)
        save_image(image, os.path.join(out_dir, f"{stem}.png"))
        np.save(os.path.join(out_dir, f"{stem}_mask.npy"), mask)
        print(f"view {stem}: {int(mask.sum())} px covered")
        return stem

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(one, views[::every]))


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--source", required=True)
    p.add_argument("--ply", required=True)
    p.add_argument("--images", default="images")
    p.add_argument("--every", type=int, default=6)
    p.add_argument("--out", default="projected_dir")
    a = p.parse_args(argv)
    project_views(a.source, a.ply, a.images, a.every, a.out)


if __name__ == "__main__":
    main()
