"""Guided 3DGS trainer CLI.

Counterpart of the reference package's root `train_guidedvd.py` (the
reference's train_guidedvd.py:639-743), per step, with --device (default
cuda). First train the baseline (`train_baseline -m <baseline_path>`),
then

    python -m guidedvd3dgs_tpu_torch.train_guidedvd -s <source_path> -m <model_path> \\
        --baseline_path <baseline_path> [--baseline_iteration 10000] \\
        [--viewcrafter_ckpt <model.ckpt> [--guidance_gpu_id 1]] \\
        [--oracle_gt_npz <source_path>/gt_gaussians.npz] [--vgg19_weights <vgg19.pth>] \\
        [--mask_baseline_path <path> [--mask_baseline_iteration 10000]] [--device cuda|cpu]

The frozen renderer is the baseline's `point_cloud/iteration_<N>`; the
trained model starts from the scene's point cloud, as the reference's
does. The engine: `--viewcrafter_ckpt` loads the ViewCrafter checkpoint
(bf16 on a card) and runs the guided DDIM sampler, at 320x448 or 320x512
by the scene's aspect ratio, on `cuda:<guidance_gpu_id>` where the host
has that card and on the trainer's otherwise; `--oracle_gt_npz` renders
the pseudo ground truth from known ground-truth Gaussians (validation);
without either the mock engine (the frozen renders with the holes filled
by the point-cloud render), announced. The perceptual pseudo term
(pseudo_cam_lpips, on by default) and, with --guidance_with_lpips, the
guidance's perceptual term take the VGG19 of `--vgg19_weights`, of
VGG19_WEIGHTS or of the torch hub cache; without weights both are
announced and off, as in the reference. `--mask_baseline_path` is the
two-renderer variant (a second baseline picks the pool and supplies the
guidance masks). `--append_pcd_from_video_diffusion --dpt_weights <file>`
lifts each event's unobserved pixels to new Gaussians by DPT-large's depth
(an HF DPTForDepthEstimation checkpoint, .safetensors or .bin); without
`--dpt_weights` the flag is announced and off, as in the reference.
`--checkpoint_iterations` write guided checkpoints
(`chkpnt<it>.ckpt` and its `.guided.npz`) and `--start_checkpoint`
resumes one exactly; a plain checkpoint resumes its Gaussian state and
builds the trajectory pool anew. `--pipeline_guidance` overlaps each
diffusion event with training: the event is finalized one boundary late
and its device work runs on a worker thread with its own CUDA stream, on
the engine's card (`cuda:<guidance_gpu_id>` where the host has it, else
beside the trainer). `--guidance_tp N > 1` (the JAX package's tensor-
parallel engine over a device mesh) waits for a multi-card host and is
refused. Writes what train_baseline writes plus the event artifacts, the
video store and `timing_summary.json`.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional

import numpy as np
import torch

from guidedvd3dgs_tpu_torch.diffusion.convert import load_viewcrafter_checkpoint
from guidedvd3dgs_tpu_torch.diffusion.model import DiffusionParams, LatentDiffusionConfig
from guidedvd3dgs_tpu_torch.diffusion.samplers.ddim_guidance import GuidedSampleConfig
from guidedvd3dgs_tpu_torch.diffusion.synthesis import SynthesisConfig
from guidedvd3dgs_tpu_torch.config import (
    ModelParams,
    OptimizationParams,
    PipelineParams,
    build_parser,
    save_cfg_args,
)
from guidedvd3dgs_tpu_torch.guidance.dpt import DPTConfig, load_hf_dpt_weights, make_depth_estimator, params_to_device
from guidedvd3dgs_tpu_torch.render import resolve_device
from guidedvd3dgs_tpu_torch.scene.scene import Scene
from guidedvd3dgs_tpu_torch.train.guided_checkpoint import load_guided_checkpoint
from guidedvd3dgs_tpu_torch.train.guided import (
    FrozenRenderer,
    GuidedTrainer,
    MockDiffusionEngine,
    OracleDiffusionEngine,
    ViewCrafterEngine,
)
from guidedvd3dgs_tpu_torch.train.logging import MetricsLogger
from guidedvd3dgs_tpu_torch.utils.vgg_loss import frame_lpips_fn, make_vgg_loss_fn


def guidance_device(opt, device: torch.device) -> torch.device:
    """The engine's device (reference guidance_gpu_id, arguments/__init__.py:
    129): `cuda:<guidance_gpu_id>` where the host has that card, else the
    trainer's device; the CPU only when the trainer runs there."""
    idx = int(getattr(opt, "guidance_gpu_id", 0))
    if device.type == "cuda" and 0 <= idx < torch.cuda.device_count():
        return torch.device("cuda", idx)
    return device


def engine_width(opt, height: int, width: int) -> int:
    """The diffusion width at height 320 (reference viewcrafter_wrapper.py:
    251-281): 512 under scannetpp_newres, else 448 for aspect ratios within
    0.2 of 1.4 (640x480 gives 448), else 512."""
    if getattr(opt, "scannetpp_newres", False):
        return 512
    return 448 if abs(width / height - 1.4) < 0.2 else 512


def build_engine(args, opt, height: int, width: int, device):
    if args.viewcrafter_ckpt:
        if getattr(opt, "guidance_mean_loss", False):
            # the reference's LossGuidance asserts it off (viewcrafter_wrapper.py:86)
            raise ValueError("guidance_mean_loss must stay False (the reference's LossGuidance asserts it)")
        dev = guidance_device(opt, device)
        # bf16 weights and compute on a card (the reference's fp16
        # autocast); float32 on the CPU
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        print(f"Loading ViewCrafter checkpoint {args.viewcrafter_ckpt} ({dtype}) onto {dev} ...")
        split = load_viewcrafter_checkpoint(args.viewcrafter_ckpt, device=dev, dtype=dtype)
        params = DiffusionParams(unet=split["unet"], vae=split["vae"], resampler=split["resampler"],
                                 clip_text=split["clip_text"], clip_image=split["clip_image"])
        mcfg = LatentDiffusionConfig()
        if dtype == torch.bfloat16:
            mcfg = dataclasses.replace(mcfg, compute_dtype="bfloat16")
        d_w = engine_width(opt, height, width)
        print(f"ViewCrafter engine on {dev}: 25x320x{d_w}, {opt.guidance_ddim_steps} guided DDIM steps "
              f"(trainer on {device})")
        return ViewCrafterEngine(params, mcfg, SynthesisConfig(ddim_steps=opt.guidance_ddim_steps),
                                 guided_cfg=GuidedSampleConfig(recur_steps=opt.guidance_recur_steps),
                                 video_length=25, height=320, width=d_w, recon_loss=opt.guidance_recon_loss)
    if args.oracle_gt_npz:
        print(f"Using ORACLE diffusion engine (GT gaussians from {args.oracle_gt_npz}) - "
              "guided-machinery validation mode.")
        return OracleDiffusionEngine(args.oracle_gt_npz, video_length=25, height=height, width=width,
                                     backend=args.oracle_backend, device=device)
    print("WARNING: no --viewcrafter_ckpt given; using the MOCK diffusion engine "
          "(pseudo-GT = mask-blended frozen renders).")
    return MockDiffusionEngine(video_length=25, height=height, width=width)


def configure_engine(engine, opt, vgg_fn) -> None:
    """The guidance loss's settings from the options (JAX train_guidedvd.py:
    223-238): the perceptual term is the VGG loss, frame by frame, with
    guidance_with_lpips and weights only."""
    if not isinstance(engine, ViewCrafterEngine):
        return
    if getattr(opt, "guidance_with_lpips", False) and vgg_fn is not None:
        engine.lpips_fn = frame_lpips_fn(vgg_fn)
    engine.ssim_guidance = getattr(opt, "guidance_with_ssim", False)
    engine.verbose = getattr(opt, "guidance_verbose", False)
    engine.w_recon = opt.w_guidance_recon_loss
    engine.scale_weight_mode = getattr(opt, "scale_guidance_weight", False)


def build_depth_estimator(args, opt, device):
    """DPT-large on the trainer's device for append_pcd_from_video_diffusion
    (JAX train_guidedvd.py:238-251), or None with the reference's warning
    when no --dpt_weights is given."""
    if not getattr(opt, "append_pcd_from_video_diffusion", False):
        return None
    if not args.dpt_weights:
        print("WARNING: append_pcd_from_video_diffusion needs --dpt_weights "
              "(HF DPTForDepthEstimation ckpt); the append path is DISABLED.")
        return None
    print(f"DPT depth estimator from {args.dpt_weights} on {device}")
    return make_depth_estimator(params_to_device(load_hf_dpt_weights(args.dpt_weights), device), DPTConfig())


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
    # the two-renderer variant: a second baseline decides the guidance mask
    # (reference train_replica_guidedvd_tworenderer.py:60-74)
    parser.add_argument("--mask_baseline_path", type=str, default=None)
    parser.add_argument("--mask_baseline_iteration", type=int, default=10_000)
    parser.add_argument("--hybrid_traj", action="store_true")
    # DPT (MiDaS) weights of the append_pcd_from_video_diffusion path
    # (reference utils/midas_depth_estimator.py:9-39)
    parser.add_argument("--dpt_weights", type=str, default=None)
    parser.add_argument("--pipeline_guidance", action="store_true",
                        help="overlap diffusion generation with training (one-event pseudo-stack lag; "
                             "the engine on the guidance_gpu_id device)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    dataset = ModelParams.extract(args)
    opt = OptimizationParams.extract(args)
    pipe = PipelineParams.extract(args)
    if opt.guidance_tp > 1:
        raise ValueError("--guidance_tp > 1 (the JAX package's tensor-parallel engine over a device mesh) "
                         "waits for a multi-card host: not ported yet")
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
    frozen_mask = None
    if args.mask_baseline_path:
        mask_scene = Scene(dataclasses.replace(dataset, model_path=args.mask_baseline_path),
                           load_iteration=args.mask_baseline_iteration)
        frozen_mask = FrozenRenderer(mask_scene.load_gaussians(mask_scene.loaded_iter, device),
                                     sh_degree=dataset.sh_degree, backend=pipe.raster_backend)
        print(f"Two-renderer variant: guidance mask from {args.mask_baseline_path}")

    cams = scene.getTrainCameras()
    h, w = cams[0].image_height, cams[0].image_width
    fx = w / (2 * math.tan(cams[0].FoVx / 2))
    fy = h / (2 * math.tan(cams[0].FoVy / 2))
    K = np.array([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]])
    engine = build_engine(args, opt, h, w, device)
    vgg_fn = make_vgg_loss_fn(args.vgg19_weights) if opt.pseudo_cam_lpips else None
    if opt.pseudo_cam_lpips and vgg_fn is None:
        print("WARNING: pseudo_cam_lpips requested but VGG19 weights not found "
              "(set --vgg19_weights or VGG19_WEIGHTS); the perceptual pseudo term is DISABLED.")
    configure_engine(engine, opt, vgg_fn)
    depth_estimator = build_depth_estimator(args, opt, device)

    pcd = scene.scene_info.point_cloud
    trainer = GuidedTrainer(
        scene, state, opt, pipe, dataset, frozen=frozen, engine=engine,
        pcd_points=np.asarray(pcd.points, np.float32), pcd_colors=np.asarray(pcd.colors, np.float32),
        guidance_intrinsic=K, seed=args.seed, hybrid_traj=args.hybrid_traj, vgg_loss_fn=vgg_fn,
        frozen_mask=frozen_mask, depth_estimator=depth_estimator, pipeline_guidance=args.pipeline_guidance,
    )
    first_iter = 0
    if args.start_checkpoint:
        first_iter = load_guided_checkpoint(args.start_checkpoint, trainer)
        print(f"Restored checkpoint at iteration {first_iter}")
    elif getattr(opt, "use_trajectory_pool", True):
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
