"""A seeded synthetic indoor scene in the layout of tools/make_synthetic_scene.py.

The room geometry (`sample_room`, `texture`), the camera orbit
(`orbit_cameras`) and the ground-truth Gaussians (`gt_arrays`) are the
port's own copies of that tool's, drawing from the numpy generator in the
same order, so `make_scene` with the tool's defaults builds the tool's
scene: the same positions, colors, cameras and noisy init cloud. Only the
ground-truth images differ, because the port renders them itself.

    python -m guidedvd3dgs_tpu_torch.scene.synthetic --out <scene_dir> [--device cuda]
        [--height 352] [--width 624] [--n_gt 150000] [--n_init 30000] [--n_cams 60]
        [--n_train 6] [--fov_deg 70] [--seed 7]

Writes what the readers take: `<source>/images/*.png`,
`<source>/sparse/0/{cameras,images,points3D}.txt` + `points3D.ply`,
`<source>/train_test_split_<n>.json` and, from `make_scene`, the
ground-truth Gaussians `<source>/gt_gaussians.npz` (the tool's keys);
`write_scene` also writes a trained model directory (`cfg_args.json`,
`point_cloud/iteration_<it>/`).
"""

from __future__ import annotations

import json
import math
import os
import types

import numpy as np

from guidedvd3dgs_tpu_torch.scene import colmap
from guidedvd3dgs_tpu_torch.scene.cameras import PseudoCamera
from guidedvd3dgs_tpu_torch.scene.ply import save_gaussian_ply, store_ply
from guidedvd3dgs_tpu_torch.utils.image_io import save_images
from guidedvd3dgs_tpu_torch.utils.sh import RGB2SH, SH2RGB

ROOM_HALF = (2.0, 1.4, 2.0)


def texture(p: np.ndarray, seed_vecs: np.ndarray) -> np.ndarray:
    """Multi-octave procedural color for points (N, 3) -> (N, 3) in [0, 1]."""
    c = np.zeros((p.shape[0], 3), np.float32)
    for k, v in enumerate(seed_vecs):
        phase = p @ v[:3]
        c[:, k % 3] += 0.5 + 0.5 * np.sin(phase * v[3] + v[4])
    c /= max(len(seed_vecs) / 3.0, 1.0)
    return np.clip(c, 0.02, 0.98)


def sample_room(rng, n_gt: int):
    """Surface points and colors of a box room with interior objects."""
    hx, hy, hz = ROOM_HALF
    walls = []
    per_wall = n_gt // 10
    for axis, sign, frac in [
        (0, -1, 1.0), (0, 1, 1.0), (1, -1, 1.5), (1, 1, 1.5), (2, -1, 1.0), (2, 1, 1.0),
    ]:
        k = int(per_wall * frac)
        pts = rng.uniform(-1, 1, (k, 3)).astype(np.float32)
        pts[:, 0] *= hx
        pts[:, 1] *= hy
        pts[:, 2] *= hz
        pts[:, axis] = sign * (hx, hy, hz)[axis]
        walls.append(pts)
    objs = []
    n_obj = n_gt - sum(w.shape[0] for w in walls)
    centers = np.array(
        [[-0.8, -0.9, -0.6], [0.9, -0.8, 0.5], [0.0, -1.0, 1.1], [-0.3, -0.5, 0.9]],
        np.float32,
    )
    radii = np.array([0.45, 0.35, 0.3, 0.25], np.float32)
    per_obj = n_obj // len(centers)
    for c, r in zip(centers, radii):
        d = rng.normal(size=(per_obj, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-9
        objs.append(c + d * r)
    pts = np.concatenate(walls + objs, 0)
    seed_vecs = rng.uniform(-1, 1, (9, 5)).astype(np.float32)
    seed_vecs[:, 3] = rng.uniform(2.0, 9.0, 9)  # spatial frequencies
    cols = texture(pts, seed_vecs)
    return pts, cols


def orbit_cameras(n_cams: int, rng):
    """c2w matrices (OpenCV convention) on a small interior ellipse, looking
    out at the walls with a slow vertical nod. Draws nothing from `rng`."""
    del rng
    c2ws = []
    for i in range(n_cams):
        t = i / n_cams * 2 * math.pi
        pos = np.array(
            [0.9 * math.cos(t), -0.15 + 0.25 * math.sin(2 * t), 0.9 * math.sin(t)],
            np.float32,
        )
        look = np.array(
            [2.2 * math.cos(t + 0.35), 0.2 * math.sin(t * 3), 2.2 * math.sin(t + 0.35)],
            np.float32,
        )
        fwd = look - pos
        fwd /= np.linalg.norm(fwd)
        up = np.array([0, -1, 0], np.float32)  # OpenCV y-down
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        upv = np.cross(fwd, right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, upv, fwd, pos
        c2ws.append(c2w)
    return np.stack(c2ws)


def gt_arrays(pts: np.ndarray, cols: np.ndarray, rng) -> dict:
    """Raw Gaussian parameters on the room's surface points (the tool's
    build_gt_state in numpy), named as scene/ply.py's load_gaussian_ply
    returns them."""
    n = pts.shape[0]
    vol = 2 * ROOM_HALF[0] * 2 * ROOM_HALF[1] * 2 * ROOM_HALF[2]
    spacing = (vol / n) ** (1 / 3) * 1.2
    scales = np.log(spacing * np.exp(rng.uniform(-0.4, 0.4, (n, 3)))).astype(np.float32)
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    rots /= np.linalg.norm(rots, axis=1, keepdims=True)
    opac_p = rng.uniform(0.75, 0.97, (n, 1)).astype(np.float32)
    return {
        "xyz": pts.astype(np.float32),
        "features_dc": RGB2SH(cols).astype(np.float32)[:, None, :],
        "features_rest": (rng.normal(size=(n, 15, 3)) * 0.02).astype(np.float32),
        "scaling": scales,
        "rotation": rots,
        "opacity": np.log(opac_p / (1 - opac_p)).astype(np.float32),
    }


# the tool's names of the ground-truth npz keys, by the names gt_arrays uses
GT_NPZ_KEYS = {"xyz": "xyz", "f_dc": "features_dc", "f_rest": "features_rest",
               "scaling": "scaling", "rotation": "rotation", "opacity": "opacity"}


def write_gt_npz(path: str, gt: dict) -> None:
    """Write ground-truth Gaussians (gt_arrays' names) as the tool's
    `gt_gaussians.npz`: keys xyz, f_dc (N, 1, 3), f_rest (N, 15, 3),
    scaling, rotation, opacity. The oracle engine of the guided trainer
    reads it."""
    with open(path, "wb") as f:
        np.savez(f, **{k: np.asarray(gt[name], np.float32) for k, name in GT_NPZ_KEYS.items()})


def room_gaussians(n: int, rng: np.random.Generator) -> dict:
    """The ground-truth Gaussians of a room of `n` surface points."""
    return gt_arrays(*sample_room(rng, n), rng)


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


def split_ids(n_cams: int, n_train: int):
    """The tool's split: n_train spread train views, every 5th other view
    for test."""
    train_ids = [int(i) for i in np.linspace(0, n_cams, n_train, endpoint=False).astype(int)]
    test_ids = [i for i in range(0, n_cams, 5) if i not in train_ids]
    return train_ids, test_ids


def init_cloud(pts, cols, n_init: int, rng):
    """The noisy init cloud standing in for a DUSt3R point cloud."""
    sel = rng.choice(pts.shape[0], size=n_init, replace=False)
    init_pts = pts[sel] + rng.normal(scale=0.01, size=(n_init, 3)).astype(np.float32)
    init_cols = np.clip(
        cols[sel] + rng.normal(scale=0.05, size=(n_init, 3)).astype(np.float32), 0, 1
    )
    return init_pts, init_cols


def write_source(source_dir: str, c2ws, cams, images, train_ids, test_ids,
                 init_pts, init_rgb_u8, images_dir: str = "images", names=None) -> None:
    """Write a scene's images (under `images_dir`, named `names` or
    frame_<i>.png; encoded on a thread pool), COLMAP text model, init cloud
    and, where train_ids is given, its split json."""
    width, height = cams[0].width, cams[0].height
    fx = width / (2 * math.tan(cams[0].FoVx / 2))
    fy = height / (2 * math.tan(cams[0].FoVy / 2))
    names = names or [f"frame_{i:05d}.png" for i in range(len(c2ws))]
    os.makedirs(os.path.join(source_dir, images_dir), exist_ok=True)
    sparse = os.path.join(source_dir, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    intr = {1: colmap.ColmapCamera(1, "PINHOLE", width, height, np.array([fx, fy, width / 2, height / 2]))}
    extr = {}
    for i, (c2w, name) in enumerate(zip(c2ws, names)):
        w2c = np.linalg.inv(c2w)
        extr[i + 1] = colmap.ColmapImage(
            i + 1, colmap.rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], 1, name,
            np.zeros((0, 2)), np.zeros((0,), np.int64),
        )
    save_images(images, [os.path.join(source_dir, images_dir, n) for n in names])
    colmap.write_cameras_text(os.path.join(sparse, "cameras.txt"), intr)
    colmap.write_images_text(os.path.join(sparse, "images.txt"), extr)
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        f.write("# empty\n")
    store_ply(os.path.join(sparse, "points3D.ply"), init_pts, init_rgb_u8)
    if train_ids is not None:
        with open(os.path.join(source_dir, f"train_test_split_{len(train_ids)}.json"), "w") as f:
            json.dump({"train_ids": [int(i) for i in train_ids], "test_ids": [int(i) for i in test_ids]}, f)


def make_scene(
    out: str,
    height: int = 352,
    width: int = 624,
    n_gt: int = 150_000,
    n_init: int = 30_000,
    n_cams: int = 60,
    n_train: int = 6,
    fov_deg: float = 70.0,
    seed: int = 7,
    device="cuda",
) -> dict:
    """Build and write the tool's scene (its defaults are these) with
    ground-truth images rendered by the port on `device`. Returns the scene
    data: gt (raw Gaussian arrays), c2ws, init_pts, init_cols, train_ids,
    test_ids."""
    import torch

    from guidedvd3dgs_tpu_torch.convert import params_from_numpy
    from guidedvd3dgs_tpu_torch.models.render import eval_render

    rng = np.random.default_rng(seed)
    pts, cols = sample_room(rng, n_gt)
    gt = gt_arrays(pts, cols, rng)
    c2ws, cams = orbit(n_cams, width, height, fov_deg, rng)
    gt_params = params_from_numpy(gt, device)
    bg = torch.zeros(3, device=device)
    images = [eval_render(gt_params, c.raster_camera(device), bg, 3).color.clamp(0, 1).cpu().numpy()
              for c in cams]
    del gt_params
    init_pts, init_cols = init_cloud(pts, cols, n_init, rng)
    train_ids, test_ids = split_ids(n_cams, n_train)
    write_source(out, c2ws, cams, images, train_ids, test_ids, init_pts,
                 (init_cols * 255).astype(np.uint8))
    write_gt_npz(os.path.join(out, "gt_gaussians.npz"), gt)
    return dict(gt=gt, c2ws=c2ws, init_pts=init_pts, init_cols=init_cols,
                train_ids=train_ids, test_ids=test_ids)


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
    """Write the scene (images: (3, H, W) floats, one per camera; the init
    cloud is a sample of the model's own points) and a trained-model
    directory holding `model_arrays` at `iteration`."""
    xyz = model_arrays["xyz"]
    sel = rng.choice(xyz.shape[0], size=min(n_init, xyz.shape[0]), replace=False)
    rgb = np.clip(SH2RGB(model_arrays["features_dc"][sel, 0]), 0, 1)
    write_source(source_dir, c2ws, cams, images, train_ids, test_ids, xyz[sel],
                 (rgb * 255).astype(np.uint8))

    os.makedirs(model_dir, exist_ok=True)
    cfg = {
        "source_path": os.path.abspath(source_dir),
        "model_path": os.path.abspath(model_dir),
        "images": "images",
        "resolution": -1,
        "white_background": False,
        "sh_degree": 3,
        "eval": True,
        "n_views": len(train_ids),
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


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Write the synthetic room scene (colmap layout).")
    ap.add_argument("--out", required=True)
    ap.add_argument("--height", type=int, default=352)
    ap.add_argument("--width", type=int, default=624)
    ap.add_argument("--n_gt", type=int, default=150_000)
    ap.add_argument("--n_init", type=int, default=30_000)
    ap.add_argument("--n_cams", type=int, default=60)
    ap.add_argument("--n_train", type=int, default=6)
    ap.add_argument("--fov_deg", type=float, default=70.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from guidedvd3dgs_tpu_torch.render import resolve_device

    info = make_scene(a.out, a.height, a.width, a.n_gt, a.n_init, a.n_cams, a.n_train, a.fov_deg,
                      a.seed, resolve_device(a.device))
    print(f"scene written to {a.out}: {a.n_cams} cams @ {a.width}x{a.height}, "
          f"train={info['train_ids']}, test={len(info['test_ids'])} views")


if __name__ == "__main__":
    main()
