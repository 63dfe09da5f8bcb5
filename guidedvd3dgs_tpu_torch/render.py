"""Render a trained model's train/test views to PNGs, and a flythrough.

Counterpart of the reference `render.py`, with the same flags plus
`--device` (default cuda):

    python -m guidedvd3dgs_tpu_torch.render -m <model_dir> [--iteration N]
        [--skip_train] [--skip_test] [--save_depth] [--video [--path_type auto|spiral|ellipse]
        [--fps 30]] [--device cuda|cpu]

Writes `<model>/{train,test}/ours_<iteration>/{renders,gt}/NNNNN.png`
and, with --save_depth, `depth/NNNNN.npy`. `--video` renders 240 frames
along an ellipse around the train cameras, or a spiral from
`<source>/poses_bounds.npy` for an LLFF capture, into
`<model>/video/ours_<iteration>/final_video.mp4` (or its PNG frames in
`final_video/` where cv2 cannot write an mp4).
"""

from __future__ import annotations

import math
import os
from typing import List, Optional

import numpy as np
import torch

from guidedvd3dgs_tpu_torch.config import ModelParams, PipelineParams, build_parser, get_combined_args
from guidedvd3dgs_tpu_torch.models.gaussians import GaussianParams
from guidedvd3dgs_tpu_torch.models.render import eval_render
from guidedvd3dgs_tpu_torch.scene.cameras import Camera, camera_from_w2c_K
from guidedvd3dgs_tpu_torch.scene.scene import Scene
from guidedvd3dgs_tpu_torch.utils.image_io import save_image
from guidedvd3dgs_tpu_torch.utils.pose_paths import generate_ellipse_path, generate_spiral_path
from guidedvd3dgs_tpu_torch.utils.video import save_video, video_u8

VIDEO_FRAMES = 240


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for, but CUDA is not available")
    return device


def render_set(
    model_path: str,
    name: str,
    iteration: int,
    views: List[Camera],
    params: GaussianParams,
    bg: torch.Tensor,
    sh_degree: int,
    backend: str = "auto",
    save_depth: bool = False,
) -> None:
    base = os.path.join(model_path, name, f"ours_{iteration}")
    render_path = os.path.join(base, "renders")
    gts_path = os.path.join(base, "gt")
    depth_path = os.path.join(base, "depth")
    os.makedirs(render_path, exist_ok=True)
    os.makedirs(gts_path, exist_ok=True)
    if save_depth:
        os.makedirs(depth_path, exist_ok=True)
    device = params.xyz.device
    for idx, view in enumerate(views):
        r = eval_render(params, view.raster_camera(device), bg, sh_degree, backend=backend)
        save_image(r.color.cpu().numpy(), os.path.join(render_path, f"{idx:05d}.png"))
        save_image(view.image, os.path.join(gts_path, f"{idx:05d}.png"))
        if save_depth:
            np.save(os.path.join(depth_path, f"{idx:05d}.npy"), r.depth.cpu().numpy())


def video_cameras(views: List[Camera], path_type: str = "auto", source_path: str = ""):
    """The flythrough's VIDEO_FRAMES cameras, at the first view's size and
    fields of view: a spiral from an LLFF capture's poses_bounds.npy
    (`path_type` spiral, or auto with "llff" in the source path and the
    file present), else an ellipse around the views."""
    pb = os.path.join(source_path, "poses_bounds.npy") if source_path else ""
    if path_type == "spiral" or (path_type == "auto" and "llff" in source_path and os.path.exists(pb)):
        w2cs = generate_spiral_path(np.load(pb), n_frames=VIDEO_FRAMES)
    else:
        w2cs = generate_ellipse_path(views, n_frames=VIDEO_FRAMES)
    view0 = views[0]
    h, w = view0.image_height, view0.image_width
    fx = w / (2 * math.tan(view0.FoVx / 2))
    fy = h / (2 * math.tan(view0.FoVy / 2))
    K = np.array([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]])
    return [camera_from_w2c_K(np.asarray(w2c), K, h, w) for w2c in w2cs]


def render_video(model_path: str, iteration: int, views: List[Camera], params: GaussianParams,
                 bg: torch.Tensor, sh_degree: int, backend: str = "auto", fps: int = 30,
                 path_type: str = "auto", source_path: str = "") -> str:
    """Render the flythrough (frames quantised on the device) and write it;
    returns the video's path."""
    device = params.xyz.device
    frames = np.stack([
        video_u8(eval_render(params, cam.raster_camera(device), bg, sh_degree, backend=backend).color[None])[0]
        for cam in video_cameras(views, path_type, source_path)
    ])
    path = os.path.join(model_path, "video", f"ours_{iteration}", "final_video.mp4")
    save_video(frames, path, fps=fps)
    return path


def main(argv: Optional[List[str]] = None) -> None:
    parser = build_parser(fill_none=True)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--video", action="store_true")
    parser.add_argument("--path_type", default="auto", choices=["auto", "spiral", "ellipse"])
    parser.add_argument("--fps", default=30, type=int)
    parser.add_argument("--save_depth", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = get_combined_args(parser.parse_args(argv))
    device = resolve_device(args.device)

    dataset = ModelParams.extract(args)
    pipe = PipelineParams.extract(args)
    scene = Scene(dataset, load_iteration=args.iteration)
    params = scene.load_gaussians(scene.loaded_iter, device)
    bg_val = [1.0, 1.0, 1.0] if dataset.white_background else [0.0, 0.0, 0.0]
    bg = torch.tensor(bg_val, dtype=torch.float32, device=device)

    it = scene.loaded_iter
    for name, skip, views in (
        ("train", args.skip_train, scene.getTrainCameras()),
        ("test", args.skip_test, scene.getTestCameras()),
    ):
        if not skip:
            render_set(
                dataset.model_path, name, it, views, params, bg, dataset.sh_degree,
                backend=pipe.raster_backend, save_depth=args.save_depth,
            )
    if args.video:
        render_video(dataset.model_path, it, scene.getTrainCameras(), params, bg, dataset.sh_degree,
                     backend=pipe.raster_backend, fps=args.fps, path_type=args.path_type,
                     source_path=dataset.source_path)


if __name__ == "__main__":
    main()
