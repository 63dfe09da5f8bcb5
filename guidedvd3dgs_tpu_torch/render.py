"""Render a trained model's train/test views to PNGs.

Counterpart of the reference `render.py`, with the same flags plus
`--device` (default cuda):

    python -m guidedvd3dgs_tpu_torch.render -m <model_dir> [--iteration N]
        [--skip_train] [--skip_test] [--save_depth] [--device cuda|cpu]

Writes `<model>/{train,test}/ours_<iteration>/{renders,gt}/NNNNN.png`
and, with --save_depth, `depth/NNNNN.npy`. `--video` is not ported yet.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from guidedvd3dgs_tpu_torch.config import ModelParams, PipelineParams, build_parser, get_combined_args
from guidedvd3dgs_tpu_torch.models.gaussians import GaussianParams
from guidedvd3dgs_tpu_torch.models.render import eval_render
from guidedvd3dgs_tpu_torch.scene.cameras import Camera
from guidedvd3dgs_tpu_torch.scene.scene import Scene
from guidedvd3dgs_tpu_torch.utils.image_io import save_image


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
    if args.video:
        raise NotImplementedError("--video needs an mp4 writer and is not ported yet")
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


if __name__ == "__main__":
    main()
