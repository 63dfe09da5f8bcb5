"""Baseline 3DGS trainer CLI.

Counterpart of the reference package's root `train_baseline.py`, with its
flags (the config tree, --test_iterations, --save_iterations,
--checkpoint_iterations, --start_checkpoint, --quiet, --nan_debug,
--profile_dir) except the TPU-only --no_scan, plus --device (default
cuda). --profile_dir <dir> writes a torch.profiler trace (CPU and CUDA
activities) of steps 50-60 after the start as `<dir>/trace.json`.
--nan_debug checks the parameters after every step and, on the first
non-finite one, writes the state from the start of that densification
interval (`<model>/nan_<it0>_<it>.ckpt`, which --start_checkpoint resumes)
and the interval's schedule (`.json`), then exits non-zero:

    python -m guidedvd3dgs_tpu_torch.train_baseline -s <source_path> -m <model_path> \\
        --iterations 10000 --test_iterations 10000 --save_iterations 10000 [--device cuda|cpu]

Writes `<model>/cfg_args.json`, `cameras.json`, `input.ply`,
`metrics.jsonl`, `point_cloud/iteration_<it>/point_cloud.ply` and the
requested checkpoints; `python -m guidedvd3dgs_tpu_torch.render` and
`.metrics` read the model directory.
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
from guidedvd3dgs_tpu_torch.train.baseline import BaselineTrainer
from guidedvd3dgs_tpu_torch.train.checkpoint import load_checkpoint
from guidedvd3dgs_tpu_torch.train.logging import MetricsLogger


def main(argv: Optional[List[str]] = None) -> BaselineTrainer:
    parser = build_parser()
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[10_000])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[10_000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--nan_debug", action="store_true")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of steps 50-60 into this directory")
    parser.add_argument("--start_checkpoint", type=str, default=None)
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

    scene = Scene(dataset)
    state = scene.create_gaussians(max_sh_degree=dataset.sh_degree, use_color=pipe.use_color,
                                   device=device)
    first_iter = 0
    if args.start_checkpoint:
        state, first_iter = load_checkpoint(args.start_checkpoint, device)
        print(f"Restored checkpoint at iteration {first_iter}")

    trainer = BaselineTrainer(scene, state, opt, pipe, dataset)
    with MetricsLogger(dataset.model_path) as logger:
        trainer.attach_logger(logger)
        trainer.train(
            iterations=opt.iterations,
            test_iterations=set(args.test_iterations),
            saving_iterations=set(args.save_iterations),
            checkpoint_iterations=set(args.checkpoint_iterations),
            checkpoint_dir=dataset.model_path,
            start_iteration=first_iter,
            nan_debug=args.nan_debug,
            profile_dir=args.profile_dir,
        )
    print("\nTraining complete.")
    return trainer


if __name__ == "__main__":
    main()
