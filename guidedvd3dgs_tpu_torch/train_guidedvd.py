"""Guided 3DGS trainer CLI.

Counterpart of the reference package's root `train_guidedvd.py` (the
reference's train_guidedvd.py:639-743), per step, with --device (default
cuda). First train the baseline (`train_baseline -m <baseline_path>`),
then

    python -m guidedvd3dgs_tpu_torch.train_guidedvd -s <source_path> -m <model_path> \\
        --baseline_path <baseline_path> [--baseline_iteration 10000] \\
        [--oracle_gt_npz <source_path>/gt_gaussians.npz] [--device cuda|cpu]

The frozen renderer is the baseline's `point_cloud/iteration_<N>`; the
trained model starts from the scene's point cloud, as the reference's
does. The engine: `--oracle_gt_npz` renders the pseudo ground truth from
known ground-truth Gaussians (validation); without it the mock engine
(the frozen renders with the holes filled by the point-cloud render),
announced. `--viewcrafter_ckpt` is refused: the ViewCrafter engine is not
wired into the trainer yet. The perceptual pseudo term (VGG) is not
ported: it is announced and left off, as the reference does without
weights. `--start_checkpoint` resumes a plain checkpoint and rebuilds the
trajectory pool. Writes what train_baseline writes plus
`timing_summary.json`.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional

import numpy as np
import torch

from guidedvd3dgs_tpu_torch.config import (
    ModelParams,
    OptimizationParams,
    PipelineParams,
    build_parser,
    save_cfg_args,
)
from guidedvd3dgs_tpu_torch.render import resolve_device
from guidedvd3dgs_tpu_torch.scene.scene import Scene
from guidedvd3dgs_tpu_torch.train.checkpoint import load_checkpoint
from guidedvd3dgs_tpu_torch.train.guided import (
    FrozenRenderer,
    GuidedTrainer,
    MockDiffusionEngine,
    OracleDiffusionEngine,
)
from guidedvd3dgs_tpu_torch.train.logging import MetricsLogger


def build_engine(args, height: int, width: int, device):
    if args.viewcrafter_ckpt:
        raise NotImplementedError(
            "--viewcrafter_ckpt: the ViewCrafter engine is not yet wired into the guided trainer "
            "(ROADMAP queue 1 item 2); use --oracle_gt_npz or the mock engine")
    if args.oracle_gt_npz:
        print(f"Using ORACLE diffusion engine (GT gaussians from {args.oracle_gt_npz}) - "
              "guided-machinery validation mode.")
        return OracleDiffusionEngine(args.oracle_gt_npz, video_length=25, height=height, width=width,
                                     backend=args.oracle_backend, device=device)
    print("WARNING: no --viewcrafter_ckpt given; using the MOCK diffusion engine "
          "(pseudo-GT = mask-blended frozen renders).")
    return MockDiffusionEngine(video_length=25, height=height, width=width)


def main(argv: Optional[List[str]] = None) -> GuidedTrainer:
    parser = build_parser()
    parser.add_argument("--baseline_path", type=str, required=True,
                        help="model_path of the trained baseline (the frozen renderer)")
    parser.add_argument("--baseline_iteration", type=int, default=10_000)
    parser.add_argument("--viewcrafter_ckpt", type=str, default=None)
    parser.add_argument("--oracle_gt_npz", type=str, default=None,
                        help="validation mode: pseudo ground truth rendered from these "
                             "ground-truth Gaussians (the synthetic scene's gt_gaussians.npz)")
    parser.add_argument("--oracle_backend", type=str, default="auto")
    parser.add_argument("--vgg19_weights", type=str, default=None)
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[10_000])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[10_000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--hybrid_traj", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    dataset = ModelParams.extract(args)
    opt = OptimizationParams.extract(args)
    pipe = PipelineParams.extract(args)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    os.makedirs(dataset.model_path, exist_ok=True)
    save_cfg_args(dataset.model_path, args)

    scene = Scene(dataset)
    state = scene.create_gaussians(max_sh_degree=dataset.sh_degree, use_color=pipe.use_color,
                                   device=device)
    base_scene = Scene(dataclasses.replace(dataset, model_path=args.baseline_path),
                       load_iteration=args.baseline_iteration)
    frozen = FrozenRenderer(base_scene.load_gaussians(base_scene.loaded_iter, device),
                            sh_degree=dataset.sh_degree, backend=pipe.raster_backend)

    cams = scene.getTrainCameras()
    h, w = cams[0].image_height, cams[0].image_width
    fx = w / (2 * math.tan(cams[0].FoVx / 2))
    fy = h / (2 * math.tan(cams[0].FoVy / 2))
    K = np.array([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]])
    engine = build_engine(args, h, w, device)
    if opt.pseudo_cam_lpips:
        print("WARNING: pseudo_cam_lpips requested but VGG19 weights not found "
              "(the perceptual loss is not ported); the perceptual pseudo term is DISABLED.")

    pcd = scene.scene_info.point_cloud
    trainer = GuidedTrainer(
        scene, state, opt, pipe, dataset, frozen=frozen, engine=engine,
        pcd_points=np.asarray(pcd.points, np.float32), pcd_colors=np.asarray(pcd.colors, np.float32),
        guidance_intrinsic=K, seed=args.seed, hybrid_traj=args.hybrid_traj,
    )
    first_iter = 0
    if args.start_checkpoint:
        trainer.state, first_iter = load_checkpoint(args.start_checkpoint, device)
        print(f"Restored checkpoint at iteration {first_iter}")
    if getattr(opt, "use_trajectory_pool", True):
        print("Building trajectory pool ...")
        trainer.init_trajectory_pool()
    else:
        trainer.init_view_geometry()  # the txt-preset mode builds no pool
    with MetricsLogger(dataset.model_path) as logger:
        trainer.attach_logger(logger)
        trainer.train(
            iterations=opt.iterations,
            test_iterations=set(args.test_iterations),
            saving_iterations=set(args.save_iterations),
            checkpoint_iterations=set(args.checkpoint_iterations),
            checkpoint_dir=dataset.model_path,
            start_iteration=first_iter,
        )
    print("\nGuided training complete.")
    return trainer


if __name__ == "__main__":
    main()
