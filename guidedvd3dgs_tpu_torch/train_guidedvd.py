"""Guided 3DGS trainer CLI.

Counterpart of the reference package's root `train_guidedvd.py` (the
reference's train_guidedvd.py:639-743), per step, with --device (default
cuda). First train the baseline (`train_baseline -m <baseline_path>`),
then

    python -m guidedvd3dgs_tpu_torch.train_guidedvd -s <source_path> -m <model_path> \\
        --baseline_path <baseline_path> [--baseline_iteration 10000] \\
        [--viewcrafter_ckpt <model.ckpt> | --svd_ckpt <svd-xt dir or file> [--guidance_gpu_id 1]] \\
        [--oracle_gt_npz <source_path>/gt_gaussians.npz] [--vgg19_weights <vgg19.pth>] \\
        [--mask_baseline_path <path> [--mask_baseline_iteration 10000]] [--device cuda|cpu]

The frozen renderer is the baseline's `point_cloud/iteration_<N>`; the
trained model starts from the scene's point cloud, as the reference's
does. The engine: `--viewcrafter_ckpt` loads the ViewCrafter checkpoint
(bf16 on a card) and runs the guided DDIM sampler, at 320x448 or 320x512
by the scene's aspect ratio, on `cuda:<guidance_gpu_id>` where the host
has that card and on the trainer's otherwise; `--svd_ckpt` loads Stable
Video Diffusion XT instead (diffusion/convert.py::load_svd_checkpoint: the
diffusers repository's directory, unet/ vae/ image_encoder/ with their
.safetensors or .bin files, or one torch file of the three state dicts
under the prefixes "unet.", "vae.", "image_encoder."; its weights are not
in the repository) and runs its guided Euler EDM sampler (25 steps, CFG
1 -> 3 over the frames) at the same sizes, bf16 on a card and float32 on
the CPU; `--oracle_gt_npz` renders
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
beside the trainer). `--guidance_tp N > 1` splits the ViewCrafter
engine's weights over N devices from `guidance_gpu_id` on (the model axis
of a mesh, parallel/model_parallel.py), with its activations on the
first: N CPU entries under `--device cpu`, N cards on CUDA. Where the
host has fewer cards the CLI raises; the JAX CLI warns and falls back to
one device instead, which would hide that the sharding did not happen.
`--profile_dir <dir>` writes a torch.profiler trace of steps 50-60 there.
Writes what train_baseline writes plus the event artifacts, the video
store and `timing_summary.json`.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional

import numpy as np
import torch

from guidedvd3dgs_tpu_torch.diffusion.convert import load_svd_checkpoint, load_viewcrafter_checkpoint
from guidedvd3dgs_tpu_torch.diffusion.model import DiffusionParams, LatentDiffusionConfig, SVDConfig
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
from guidedvd3dgs_tpu_torch.parallel.mesh import Mesh, make_mesh
from guidedvd3dgs_tpu_torch.render import resolve_device
from guidedvd3dgs_tpu_torch.scene.scene import Scene
from guidedvd3dgs_tpu_torch.train.guided_checkpoint import load_guided_checkpoint
from guidedvd3dgs_tpu_torch.train.guided import (
    FrozenRenderer,
    GuidedTrainer,
    MockDiffusionEngine,
    OracleDiffusionEngine,
    SVDEngine,
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


def guidance_mesh(opt, device: torch.device) -> Optional[Mesh]:
    """--guidance_tp N > 1: a (1, N) mesh for the engine's weights over N
    devices from guidance_gpu_id on (JAX train_guidedvd.py:37-54): N CPU
    entries for a CPU trainer, else N cards, raising where the host has
    fewer; None for N <= 1."""
    tp = int(getattr(opt, "guidance_tp", 1))
    if tp <= 1:
        return None
    if device.type == "cpu":
        return make_mesh(n_data=1, n_model=tp, devices=["cpu"] * tp)
    idx = int(getattr(opt, "guidance_gpu_id", 0))
    count = torch.cuda.device_count()
    if idx + tp > count:
        raise ValueError(f"--guidance_tp {tp} from card {idx} needs {idx + tp} cards; this host has {count}")
    return make_mesh(n_data=1, n_model=tp, devices=[torch.device("cuda", idx + i) for i in range(tp)])


def engine_width(opt, height: int, width: int) -> int:
    """The diffusion width at height 320 (reference viewcrafter_wrapper.py:
    251-281): 512 under scannetpp_newres, else 448 for aspect ratios within
    0.2 of 1.4 (640x480 gives 448), else 512."""
    if getattr(opt, "scannetpp_newres", False):
        return 512
    return 448 if abs(width / height - 1.4) < 0.2 else 512


def build_svd_engine(args, opt, height: int, width: int, device) -> SVDEngine:
    """--svd_ckpt: SVD-XT on the engine's device, bf16 on a card (weights and
    compute), float32 on the CPU."""
    if getattr(opt, "guidance_tp", 1) > 1:
        raise ValueError("--guidance_tp splits the ViewCrafter engine only; SVD-XT runs on one device")
    dev = guidance_device(opt, device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    print(f"Loading SVD-XT weights {args.svd_ckpt} ({dtype}) onto {dev} ...")
    params = load_svd_checkpoint(args.svd_ckpt, device=dev, dtype=dtype)
    cfg = SVDConfig(compute_dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    d_w = engine_width(opt, height, width)
    print(f"SVD-XT engine on {dev}: 25x320x{d_w}, 25 guided Euler EDM steps (trainer on {device})")
    return SVDEngine(params, cfg, guided_cfg=GuidedSampleConfig(recur_steps=opt.guidance_recur_steps),
                     video_length=25, height=320, width=d_w, recon_loss=opt.guidance_recon_loss)


def build_engine(args, opt, height: int, width: int, device):
    svd_ckpt = getattr(args, "svd_ckpt", None)
    if args.viewcrafter_ckpt and svd_ckpt:
        raise ValueError("give --viewcrafter_ckpt or --svd_ckpt, not both")
    if svd_ckpt:
        if getattr(opt, "guidance_mean_loss", False):
            raise ValueError("guidance_mean_loss must stay False (the reference's LossGuidance asserts it)")
        return build_svd_engine(args, opt, height, width, device)
    if args.viewcrafter_ckpt:
        if getattr(opt, "guidance_mean_loss", False):
            # the reference's LossGuidance asserts it off (viewcrafter_wrapper.py:86)
            raise ValueError("guidance_mean_loss must stay False (the reference's LossGuidance asserts it)")
        mesh = guidance_mesh(opt, device)
        dev = guidance_device(opt, device) if mesh is None else mesh.home
        # bf16 weights and compute on a card (the reference's fp16
        # autocast); float32 on the CPU. A sharded engine reads its pieces
        # from the host copy
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        load_dev = dev if mesh is None else torch.device("cpu")
        print(f"Loading ViewCrafter checkpoint {args.viewcrafter_ckpt} ({dtype}) onto {load_dev} ...")
        split = load_viewcrafter_checkpoint(args.viewcrafter_ckpt, device=load_dev, dtype=dtype)
        params = DiffusionParams(unet=split["unet"], vae=split["vae"], resampler=split["resampler"],
                                 clip_text=split["clip_text"], clip_image=split["clip_image"])
        mcfg = LatentDiffusionConfig()
        if dtype == torch.bfloat16:
            mcfg = dataclasses.replace(mcfg, compute_dtype="bfloat16")
        d_w = engine_width(opt, height, width)
        where = dev if mesh is None else f"{[str(d) for d in mesh.model_devices]} (weights split)"
        print(f"ViewCrafter engine on {where}: 25x320x{d_w}, {opt.guidance_ddim_steps} guided DDIM steps "
              f"(trainer on {device})")
        return ViewCrafterEngine(params, mcfg, SynthesisConfig(ddim_steps=opt.guidance_ddim_steps),
                                 guided_cfg=GuidedSampleConfig(recur_steps=opt.guidance_recur_steps),
                                 video_length=25, height=320, width=d_w, recon_loss=opt.guidance_recon_loss,
                                 mesh=mesh)
    if getattr(opt, "guidance_tp", 1) > 1:
        print("NOTE: --guidance_tp splits the ViewCrafter engine only; this engine runs on one device.")
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
    if not isinstance(engine, (ViewCrafterEngine, SVDEngine)):
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
    parser.add_argument("--svd_ckpt", type=str, default=None,
                        help="Stable Video Diffusion XT as the guided prior: the diffusers repository "
                             "stabilityai/stable-video-diffusion-img2vid-xt (a directory with unet/, vae/ and "
                             "image_encoder/ weights, .safetensors or .bin) or one torch file of the three state "
                             "dicts under the prefixes 'unet.', 'vae.', 'image_encoder.'; the weights are not in "
                             "this repository")
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
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of steps 50-60 into this directory")
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
            profile_dir=args.profile_dir,
        )
    print("\nGuided training complete.")
    return trainer


if __name__ == "__main__":
    main()
