"""DUSt3R's scene pipeline: image pairs -> the network -> global alignment
-> a point cloud and a COLMAP model; and the CLI that writes a COLMAP
scene's init cloud from its train views, the step between
`dataset_to_colmap` and `train_baseline`:

    python -m guidedvd3dgs_tpu_torch.geometry.pipeline -s <scene> --dataset replica --images rgb \
        [--n_views 6] --weights DUSt3R_ViTLarge_BaseDecoder_512_dpt.pth [--device cuda]

It writes `<scene>/sparse/0/points3D.ply` (or --out): the train views
resized to 512 on the long side, every directed pair through the network
(4 pairs a batch), 300 alignment iterations with the COLMAP poses and focals
preset, the points above conf 3, every third (the reference's tools/get_replica_dust3r_pcd.py
and dust3r_to_colmap.py). Without --weights the network's weights are
random from --seed, announced.

Counterpart of `guidedvd3dgs_tpu/geometry/pipeline.py` (the reference's
dust3r/image_pairs.py make_pairs, dust3r/inference.py, tools/
dust3r_to_colmap.py:196-341, tools/get_replica_dust3r_pcd.py and
dust3r/utils/image.py's resize convention). `run_dust3r_scene` is the
reference's run_dust3r_train_views (viewcrafter_wrapper.py:291-343): every
directed pair of the train views, then the alignment with the COLMAP poses
and focals preset.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from guidedvd3dgs_tpu_torch.dataset_to_colmap import save_cameras_txt, save_images_txt
from guidedvd3dgs_tpu_torch.geometry import global_aligner as GA
from guidedvd3dgs_tpu_torch.geometry.dust3r import (
    AsymmetricCroCo3DStereo,
    Dust3rConfig,
    dust3r_apply,
    from_params,
    init_params,
)
from guidedvd3dgs_tpu_torch.render import resolve_device
from guidedvd3dgs_tpu_torch.scene import colmap
from guidedvd3dgs_tpu_torch.scene.dataset_readers import colmap_views, sparse_view_split
from guidedvd3dgs_tpu_torch.scene.ply import store_ply
from guidedvd3dgs_tpu_torch.utils.general import resize_bilinear
from guidedvd3dgs_tpu_torch.utils.image_io import load_image


def make_pairs(n_images: int, scene_graph: str = "complete", symmetrize: bool = True) -> List[Tuple[int, int]]:
    """The complete graph's n (n - 1) / 2 pairs (or a 'swin-<k>' window),
    then the same reversed."""
    pairs = []
    if scene_graph == "complete":
        for i in range(n_images):
            for j in range(i):
                pairs.append((i, j))
    elif scene_graph.startswith("swin"):
        winsize = int(scene_graph.split("-")[1]) if "-" in scene_graph else 3
        for i in range(n_images):
            for k in range(1, winsize + 1):
                pairs.append((i, (i + k) % n_images))
    else:
        raise ValueError(scene_graph)
    if symmetrize:
        pairs = pairs + [(j, i) for i, j in pairs]
    return pairs


def resize_for_dust3r(img: np.ndarray, size: int = 512) -> np.ndarray:
    """(H, W, 3): the long side to `size`, then H and W centre-cropped to
    multiples of 16 (640x480 gives 512x384)."""
    h, w = img.shape[:2]
    scale = size / max(h, w)
    nh, nw = round(h * scale), round(w * scale)
    out = resize_bilinear(torch.from_numpy(np.asarray(img, np.float32)), nh, nw).numpy()
    ch, cw = (nh // 16) * 16, (nw // 16) * 16
    oy, ox = (nh - ch) // 2, (nw - cw) // 2
    return out[oy: oy + ch, ox: ox + cw]


def normalize_images(imgs: np.ndarray) -> np.ndarray:
    """[0, 1] -> [-1, 1] (ImgNorm: mean 0.5, std 0.5)."""
    return (np.asarray(imgs, np.float32) - 0.5) / 0.5


@dataclass
class Dust3rScene:
    c2ws: np.ndarray  # (V, 4, 4)
    focals: np.ndarray  # (V,)
    pts3d: np.ndarray  # (V, H, W, 3)
    depths: np.ndarray  # (V, H, W)
    confs: np.ndarray  # (V, H, W)
    imgs: np.ndarray  # (V, H, W, 3) in [0, 1]


def pairwise_predictions(model: AsymmetricCroCo3DStereo, images: np.ndarray,
                         edges: List[Tuple[int, int]], batch_pairs: int = 4):
    """Every edge through the network, `batch_pairs` at a time, on the
    model's device: (pred_i, pred_j (E, H*W, 3), conf_i, conf_j (E, H*W))."""
    v, h, w, _ = images.shape
    dev = next(model.parameters()).device
    dtype = next(model.parameters()).dtype
    norm = torch.from_numpy(normalize_images(images)).to(dev, dtype)
    outs = [[], [], [], []]
    for s in range(0, len(edges), batch_pairs):
        chunk = edges[s: s + batch_pairs]
        o1, o2 = dust3r_apply(model, norm[[i for i, _ in chunk]], norm[[j for _, j in chunk]])
        for lst, t in zip(outs, (o1["pts3d"], o2["pts3d"], o1["conf"], o2["conf"])):
            lst.append(t.to(torch.float32))
    e = len(edges)
    pred_i, pred_j = (torch.cat(x).reshape(e, h * w, 3) for x in outs[:2])
    conf_i, conf_j = (torch.cat(x).reshape(e, h * w) for x in outs[2:])
    return pred_i, pred_j, conf_i, conf_j


def run_dust3r_scene(model: AsymmetricCroCo3DStereo, images: np.ndarray,
                     known_c2w: Optional[np.ndarray] = None, known_focals: Optional[np.ndarray] = None,
                     niter: int = 300, lr: float = 0.01, batch_pairs: int = 4, seed: int = 0) -> Dust3rScene:
    """images (V, H, W, 3) in [0, 1], already at DUSt3R's size: all directed
    pairs through the network, the alignment (poses and focals preset where
    given, on the model's device), each image's confidence the maximum over
    the edges that see it."""
    v, h, w, _ = images.shape
    edges = make_pairs(v)
    pred_i, pred_j, conf_i, conf_j = pairwise_predictions(model, images, edges, batch_pairs)
    acfg = GA.AlignerConfig(height=h, width=w, pose_preset=known_c2w is not None,
                            focal_preset=known_focals is not None)
    rng = np.random.default_rng(seed)
    state = GA.init_state(acfg, v, edges, pred_i.cpu().numpy(), rng, preset_c2w=known_c2w,
                          preset_focals=known_focals, device=pred_i.device)
    state, _ = GA.global_align(state, acfg, pred_i, pred_j, conf_i, conf_j, edges, niter=niter, lr=lr)
    with torch.no_grad():
        out = {k: t.cpu().numpy() for k, t in GA.aligner_outputs(state, acfg).items()}
    ci, cj = conf_i.cpu().numpy(), conf_j.cpu().numpy()
    im_conf = np.zeros((v, h, w), np.float32)
    for eidx, (i, j) in enumerate(edges):
        im_conf[i] = np.maximum(im_conf[i], ci[eidx].reshape(h, w))
        im_conf[j] = np.maximum(im_conf[j], cj[eidx].reshape(h, w))
    return Dust3rScene(c2ws=out["c2w"], focals=out["focals"], pts3d=out["pts3d"], depths=out["depth"],
                       confs=im_conf, imgs=np.asarray(images))


def scene_to_pointcloud(scene: Dust3rScene, min_conf_thr: float = 3.0,
                        every: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """The points above the confidence threshold, every `every`-th of them
    (tools/dust3r_to_colmap.py:299-316), with their colours in [0, 1]."""
    mask = scene.confs > min_conf_thr
    return (scene.pts3d[mask][::every].astype(np.float32),
            scene.imgs[mask][::every].astype(np.float32))


def export_colmap(scene: Dust3rScene, out_dir: str, min_conf_thr: float = 3.0) -> int:
    """sparse/0 from the scene: one PINHOLE camera per view at the averaged
    focal, the aligned poses, and points3D.ply. Returns the point count."""
    os.makedirs(out_dir, exist_ok=True)
    v, h, w = scene.confs.shape
    favg = float(np.mean(scene.focals))
    K = np.array([[favg, 0, w / 2.0], [0, favg, h / 2.0], [0, 0, 1]])
    w2c = np.stack([np.linalg.inv(c) for c in scene.c2ws])
    save_cameras_txt(out_dir, np.repeat(K[None], v, 0), h, w)
    save_images_txt(out_dir, w2c)
    pts, cols = scene_to_pointcloud(scene, min_conf_thr)
    store_ply(os.path.join(out_dir, "points3D.ply"), pts, (cols * 255).astype(np.uint8))
    return pts.shape[0]


def train_view_inputs(source: str, images: str, dataset: str, n_views: int = 6, size: int = 512):
    """The scene's train views at DUSt3R's size: (images (V, h, w, 3) in
    [0, 1], c2w (V, 4, 4), focals (V,) in pixels of that size)."""
    views, rgb_mapping = colmap_views(source, os.path.join(source, images))
    train_idx, _ = sparse_view_split(source, dataset, views, rgb_mapping, n_views)
    imgs, c2ws, focals = [], [], []
    for i in train_idx:
        im, cam, path = views[i]
        img = load_image(path).astype(np.float32) / 255.0
        h, w = img.shape[:2]
        imgs.append(resize_for_dust3r(img, size))
        w2c = np.eye(4)
        w2c[:3, :3] = colmap.qvec2rotmat(im.qvec)
        w2c[:3, 3] = im.tvec
        c2ws.append(np.linalg.inv(w2c))
        focals.append(float(cam.params[0]) * size / max(h, w))  # fx, at the resized scale
    return np.stack(imgs), np.stack(c2ws), np.asarray(focals)


def load_dust3r_weights(path: str) -> dict:
    """A DUSt3R checkpoint's state dict (under 'model', as the published
    .pth files hold it beside their argparse 'args', or bare), loaded
    with weights_only."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt.get("model", ckpt)


# The CLI's settings: the reference's (tools/get_replica_dust3r_pcd.py).
SIZE = 512  # DUSt3R's image size, the long side
NITER = 300
BATCH_PAIRS = 4
MIN_CONF_THR = 3.0


def main(argv: Optional[List[str]] = None) -> Tuple[Dust3rScene, int]:
    ap = argparse.ArgumentParser(description="a COLMAP scene's init cloud from DUSt3R on its train views")
    ap.add_argument("-s", "--source_path", required=True)
    ap.add_argument("--dataset", default="replica")
    ap.add_argument("--images", default="images")
    ap.add_argument("--n_views", type=int, default=6)
    ap.add_argument("--weights", default=None, help="DUSt3R_ViTLarge_BaseDecoder_512_dpt.pth")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="default <source>/sparse/0/points3D.ply")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    cfg = Dust3rConfig()
    if a.weights:
        params = load_dust3r_weights(a.weights)
    else:
        print(f"WARNING: no --weights; DUSt3R runs on random weights (seed {a.seed}): the cloud is not a scene's")
        params = init_params(cfg, a.seed)
    model = from_params(params, cfg, device)
    del params
    imgs, c2ws, focals = train_view_inputs(a.source_path, a.images, a.dataset, a.n_views, SIZE)
    scene = run_dust3r_scene(model, imgs, known_c2w=c2ws, known_focals=focals, niter=NITER,
                             batch_pairs=BATCH_PAIRS, seed=a.seed)
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    pts, cols = scene_to_pointcloud(scene, MIN_CONF_THR)
    out = a.out or os.path.join(a.source_path, "sparse", "0", "points3D.ply")
    store_ply(out, pts, (cols * 255).astype(np.uint8))
    print(f"{len(imgs)} train views at {imgs.shape[1]}x{imgs.shape[2]}, {len(make_pairs(len(imgs)))} pairs: "
          f"{pts.shape[0]} points (conf > {MIN_CONF_THR}) -> {out}")
    return scene, pts.shape[0]


if __name__ == "__main__":
    main()
