"""Project-cam baseline trainer CLI.

Counterpart of the reference package's root `train_project_cam.py`: the
baseline trainer whose epochs take, with probability 1 -
`project_cam_prob`, the projection cameras of a Replica scene (every 6th
view of the trajectory, supervised by the scene's point cloud projected
to it, as `python -m guidedvd3dgs_tpu_torch.project_pcd_to_views`
writes it), plus --device (default cuda):

    python -m guidedvd3dgs_tpu_torch.train_project_cam -s <source> -m <model_path> --dataset replica \\
        --projected_dir <source>/projected_dir --project_cam_prob 0.8 --project_cam_weight 0.05 \\
        [--device cuda|cpu]

Writes what train_baseline writes.
"""

from __future__ import annotations

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
from guidedvd3dgs_tpu_torch.train.logging import MetricsLogger
from guidedvd3dgs_tpu_torch.train.project_cam import ProjectCamTrainer


def main(argv: Optional[List[str]] = None) -> ProjectCamTrainer:
    parser = build_parser()
    parser.add_argument("--projected_dir", type=str, required=True,
                        help="directory of the projections (<stem>.png) and masks (<stem>_mask.npy)")
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[10_000])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[10_000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--quiet", action="store_true")
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

    scene = Scene(dataset, replica_use_project_cam=True, projected_dir=args.projected_dir)
    state = scene.create_gaussians(max_sh_degree=dataset.sh_degree, use_color=pipe.use_color, device=device)
    trainer = ProjectCamTrainer(scene, state, opt, pipe, dataset)
    with MetricsLogger(dataset.model_path) as logger:
        trainer.attach_logger(logger)
        trainer.train(
            iterations=opt.iterations,
            test_iterations=set(args.test_iterations),
            saving_iterations=set(args.save_iterations),
            checkpoint_iterations=set(args.checkpoint_iterations),
            checkpoint_dir=dataset.model_path,
        )
    print(f"\nProject-cam training complete ({trainer.epochs['train']} train epochs, "
          f"{trainer.epochs['project']} projection epochs).")
    return trainer


if __name__ == "__main__":
    main()
