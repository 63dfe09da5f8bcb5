"""A seeded synthetic indoor scene in the layout of tools/make_synthetic_scene.py.

Writes what the serving path reads: `<source>/images/*.png`,
`<source>/sparse/0/{cameras,images}.txt` + `points3D.ply`,
`<source>/train_test_split_<n>.json`, and `<model>/cfg_args.json` +
`<model>/point_cloud/iteration_<it>/point_cloud.ply`. The room geometry and
the camera orbit are the tool's own (`sample_room`, `orbit_cameras`); the
ground-truth images are whatever the caller renders.
"""

from __future__ import annotations

import json
import math
import os
import types

import numpy as np

from guidedvd3dgs_tpu.scene import colmap
from guidedvd3dgs_tpu.scene.ply import save_gaussian_ply, store_ply
from guidedvd3dgs_tpu_torch.scene.cameras import PseudoCamera
from guidedvd3dgs_tpu_torch.utils.image_io import save_image
from guidedvd3dgs_tpu_torch.utils.sh import RGB2SH, SH2RGB
from tools.make_synthetic_scene import orbit_cameras, sample_room


def room_gaussians(n: int, rng: np.random.Generator) -> dict:
    """Raw Gaussian parameters of the procedural room (the tool's
    build_gt_state in numpy): arrays named as scene/ply.py's
    load_gaussian_ply returns them."""
    pts, cols = sample_room(rng, n)
    m = pts.shape[0]
    vol = 2 * 2.0 * 2 * 1.4 * 2 * 2.0
    spacing = (vol / m) ** (1 / 3) * 1.2
    scales = np.log(spacing * np.exp(rng.uniform(-0.4, 0.4, (m, 3)))).astype(np.float32)
    rots = rng.normal(size=(m, 4)).astype(np.float32)
    rots /= np.linalg.norm(rots, axis=1, keepdims=True)
    opac_p = rng.uniform(0.75, 0.97, (m, 1)).astype(np.float32)
    return {
        "xyz": pts.astype(np.float32),
        "features_dc": RGB2SH(cols).astype(np.float32)[:, None, :],
        "features_rest": (rng.normal(size=(m, 15, 3)) * 0.02).astype(np.float32),
        "scaling": scales,
        "rotation": rots,
        "opacity": np.log(opac_p / (1 - opac_p)).astype(np.float32),
    }


def orbit(n_cams: int, width: int, height: int, hfov_deg: float, rng):
    """(c2ws (n, 4, 4), PseudoCameras) on the tool's interior orbit."""
    c2ws = orbit_cameras(n_cams, rng)
    fovx = math.radians(hfov_deg)
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    cams = []
    for c2w in c2ws:
        w2c = np.linalg.inv(c2w)
        cams.append(PseudoCamera(R=w2c[:3, :3].T, T=w2c[:3, 3], FoVx=fovx, FoVy=fovy,
                                 width=width, height=height))
    return c2ws, cams


def write_scene(
    source_dir: str,
    model_dir: str,
    c2ws: np.ndarray,
    cams,
    images,
    model_arrays: dict,
    train_ids,
    test_ids,
    iteration: int,
    rng: np.random.Generator,
    n_init: int = 2000,
) -> None:
    """Write the scene (images: (3, H, W) floats, one per camera) and a
    trained-model directory holding `model_arrays` at `iteration`."""
    width, height = cams[0].width, cams[0].height
    fx = width / (2 * math.tan(cams[0].FoVx / 2))
    fy = height / (2 * math.tan(cams[0].FoVy / 2))
    os.makedirs(os.path.join(source_dir, "images"), exist_ok=True)
    sparse = os.path.join(source_dir, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    intr = {1: colmap.ColmapCamera(1, "PINHOLE", width, height, np.array([fx, fy, width / 2, height / 2]))}
    extr = {}
    for i, (c2w, img) in enumerate(zip(c2ws, images)):
        w2c = np.linalg.inv(c2w)
        name = f"frame_{i:05d}.png"
        save_image(img, os.path.join(source_dir, "images", name))
        extr[i + 1] = colmap.ColmapImage(
            i + 1, colmap.rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], 1, name,
            np.zeros((0, 2)), np.zeros((0,), np.int64),
        )
    colmap.write_cameras_text(os.path.join(sparse, "cameras.txt"), intr)
    colmap.write_images_text(os.path.join(sparse, "images.txt"), extr)
    xyz = model_arrays["xyz"]
    sel = rng.choice(xyz.shape[0], size=min(n_init, xyz.shape[0]), replace=False)
    rgb = np.clip(SH2RGB(model_arrays["features_dc"][sel, 0]), 0, 1)
    store_ply(os.path.join(sparse, "points3D.ply"), xyz[sel], (rgb * 255).astype(np.uint8))
    n_views = len(train_ids)
    with open(os.path.join(source_dir, f"train_test_split_{n_views}.json"), "w") as f:
        json.dump({"train_ids": [int(i) for i in train_ids], "test_ids": [int(i) for i in test_ids]}, f)

    os.makedirs(model_dir, exist_ok=True)
    cfg = {
        "source_path": os.path.abspath(source_dir),
        "model_path": os.path.abspath(model_dir),
        "images": "images",
        "resolution": -1,
        "white_background": False,
        "sh_degree": 3,
        "eval": True,
        "n_views": n_views,
        "dataset": "colmap",
        "raster_backend": "auto",
    }
    with open(os.path.join(model_dir, "cfg_args.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    save_gaussian_ply(
        os.path.join(model_dir, "point_cloud", f"iteration_{iteration}", "point_cloud.ply"),
        types.SimpleNamespace(**model_arrays),
        np.ones(xyz.shape[0], bool),
    )
