#!/usr/bin/env python3
"""Run the PyTorch port's serving and training paths on one NVIDIA GPU and
check them.

    python3 chip_smoke.py

Phases (each prints a line, phase 5 one per quantity; any failure raises
and the exit code is non-zero; there is no CPU fallback):
  1. device   the card's name and power limit (nvidia-smi); TF32 off
  2. build    nvcc builds the kernels from csrc/ into build/torch_kernels/;
              ptxas's registers, shared memory and stack of each kernel
  3. kernels  K1-K6 against their plain PyTorch versions on the card, on a
              200,000-Gaussian room at 640x480, SH degree 3: max abs error
              against the stated tolerance, ms of each by CUDA events over
              EVENT_LAUNCHES calls (the host-clock median beside it), the
              plain version's median ms, its bound from the bytes and
              operations of this data, for K6 the one PyTorch call that
              computes the same (torch.segment_reduce), and the tiles'
              instance counts and walks (max, p99, mean). K1 reads the SH
              pair (features_dc, features_rest) in place; its full table
              is held to the plain version, and as the tile rasterizer
              calls it (rows 6-8 of the Gaussians without a tile skipped,
              a screen offset) to that table bitwise; it is timed as the
              rasterizer calls it, against the bound of the bytes it needs
              (the SH of the Gaussians in a tile only), with the all-rows
              bound and the full table's ms beside it. K2 with the SH
              pair is held bitwise to K2 with one SH tensor
  4. render   a 1,000,000-Gaussian, SH degree 3 room at 640x480, hfov 90
              (the Replica camera), written in the colmap layout, rendered
              by `guidedvd3dgs_tpu_torch.render.main` and scored by
              `guidedvd3dgs_tpu_torch.metrics.evaluate`; the kernel launch
              counts of that run, the render time per view, the device
              time per stage and idle share from one torch.profiler trace
              of `eval_render` on the test views, and one view against
              the chain of plain versions
  5. train    the baseline trainer at the same width: `create_from_pcd` of
              a noisy 1M-point cloud of the room, 6 train views, 60 steps
              at SH degree 3 with one densify_and_prune (step 40); every
              kernel launched once per step, the loss falls; step time,
              densify time, instances, and a torch.profiler trace of 10
              steps by stage with the idle share and read-backs
  5b. trained density  the trainer on the noisy 1M-Gaussian ground-truth
              room (phase 4's model): 24 steps, 10 traced by stage, and
              one densify_and_prune whose threshold is placed so that a
              tenth of the Gaussians clone or split (the init cloud's
              event at step 40 is near-empty): its time, the Gaussians
              before and after, the step time after it; and K1 (as the
              rasterizer calls it, and its full table), K3, K4, K5, K6 and
              K2 alone at one train view of the room by CUDA events, with
              their bounds from that view's counts and its tile
              statistics. Phases 4, 5 and 5b's traces count torch.cat's
              kernels and the CatBackward nodes (phases 5 and 5b fail on
              one: the SH reaches K1 and K2 unconcatenated)
  5c. guided trainer  `train.guided.GuidedTrainer` on phase 5b's room:
              the noisy room frozen as the baseline, the oracle engine
              rendering the ground truth from the npz that make_scene's
              writer writes, a 1M-point cloud of the room; the trajectory
              pool (its seconds and frames), one diffusion event of 25
              frames (pc_render, frozen, generate seconds; the splat's
              device ms traced alone), then 24 guided steps that each take
              a pseudo view (train view + pseudo view, one chain, one
              backward): host ms per step, 10 steps traced by stage with the
              idle share and the torch.cat kernels (no CatBackward, at most
              6 a step); K1 and K2 twice a step, K3-K6 once, K1 once more a
              frozen or oracle frame and K3, K4 once more a chain of them
              (FrozenRenderer.GROUP frames), exactly; every loss finite,
              pseudo_l1 > 0
  5d. ViewCrafter-guided trainer  the same trainer and room with the
              ViewCrafterEngine in place of the oracle (random bf16 weights,
              25x320x448, GUIDED_STEPS guided DDIM steps of the default 50)
              and the VGG19 pseudo term on random_vgg19 weights: one event
              with its artifacts and the video store in the work dir, a
              second on the same pool entry read from the store (no engine
              call), 24 guided steps, 10 traced: the event's seconds by
              phase, the guided DDIM step's ms in the trainer (beside 8b's),
              the card's peak with the trainer live, the step's host and
              device ms and the VGG term's share (beside 5c's step), K1-K6
              and L1 launched exactly (L1 20 S + 2 / 15 S / 15 S in the
              event), every loss finite, pseudo_l1 and the VGG term > 0, the
              frames finite in [0, 1], the artifacts and the store present;
              a 10k-run projection from these parts
  6. CLI      `guidedvd3dgs_tpu_torch.train_baseline` for 2000 iterations
              on the tool-default synthetic scene (scene.synthetic.
              make_scene), then the render and metrics CLIs on its
              iteration-0 and iteration-2000 models: test PSNR must gain
              at least 2 dB
  6b. guided CLI  `guidedvd3dgs_tpu_torch.train_guidedvd` for 2000
              iterations on that scene with the oracle engine (its
              gt_gaussians.npz) and phase 6's model as the frozen baseline,
              pseudo views between iterations 200 and 1900, an event every
              260 (8); the render and metrics CLIs on it: at least 7 events,
              a pseudo stack of 24, the CLI's launch counts exactly, and a
              test PSNR not below phase 6's at 2000 (printed with SSIM and
              the margin)
  6c. ViewCrafter CLI  the same random weights written as a ViewCrafter
              checkpoint (sub-model and CLIP prefixes, framestride_embed,
              bf16, ~5.1 GB, deleted at the end) and a random VGG19 as a
              torchvision state dict; `train_guidedvd --viewcrafter_ckpt
              --pseudo_cam_lpips --vgg19_weights --guidance_save_videos
              --guidance_ddim_steps 3` on phase 6's scene and baseline for
              30 iterations with two events: the engine's width by the
              rule, 2 events, a pseudo stack of 24, 2 stored videos, L1's
              launches exactly; the render and metrics CLIs on the result;
              the checkpoint's write and load seconds
  6d. published chain  each CLI of scripts/run_*.sh at full width on phase
              4's room, the launches of each run exact: the room written as
              the four ScanNet++ scenes (dslr/undistorted_images, the train
              frames of SCANNETPP_TRAIN_ID among CHAIN_FRAMES), each through
              train_baseline --dataset scannetpp (CHAIN_ITERS), render and
              metrics, then get_avg_results --dataset scannetpp; the room as
              a Replica scene, its 1M-point cloud projected to every 6th view
              by project_pcd_to_views, train_project_cam (both kinds of
              epoch, each kind's loss falling); phase 5c's trainer run A with
              a guided checkpoint at RESUME_AT and events on both sides, run
              B resumed from it: bitwise A's state; render --video of phase
              4's model (240 frames); metrics with random LPIPS weights
              written as torchvision / LPIPS v0.1 files (both LPIPS fields
              finite), and a view's LPIPS ms
  7. generate the video-diffusion generation path (ViewCrafter at full
              width: 25 frames, 320x448, UNet 320 channels, ViT-H-14
              towers, random weights from a seed)
     7a. kernel L1 (flash attention) against its plain version on the
              card at the UNet's (one CFG branch and the batched pair), the
              VAE's (25 frames, the decode chunk, one frame) and a ragged
              shape, in float32 and bfloat16: max abs error against the
              stated tolerance, median ms, bound, plain ms and the ms of
              torch.nn.functional.scaled_dot_product_attention; for bf16
              the ratio to it and the share of the bound
     7b. one request through `ViewCrafterEngine.generate(no_guidance=True)`
              in bfloat16 with GEN_STEPS DDIM steps (cut from the default
              50; every step is the same program): conditioning, ms per
              step, decode, total, peak memory, L1's launches against
              10 per step + 2, the frames finite in [0, 1]; one DDIM step
              traced by stage with the idle share
     7c. one DDIM step at full width in float32 through L1 and through
              its plain version: the latents agree within STEP_TOL; and
              the same step with L1's forward in bf16 (the bf16 kernels
              against the plain version of the same bf16 inputs) within
              STEP_TOL_BF16 in L2 norm
  8. guided   generation under scene-grounding guidance (the same
              ViewCrafter at full width), which differentiates through L1
     8a. L1's backward (the dK/dV and dQ kernels) against its plain
              backward on the card at the guided step's shapes (the UNet's
              batched CFG pair and one branch, the VAE's decode chunk) and
              a ragged one, in float32 and bfloat16: max abs error of dq,
              dk, dv over max |grad| against L1_BWD_TOL, median ms of each
              kernel, bounds, the plain backward's ms and the backward of
              torch.nn.functional.scaled_dot_product_attention, the pair's
              ratio to it and share of the bound; the forward's
              log-sum-exp against torch.logsumexp
     8b. one request through `ViewCrafterEngine.generate(no_guidance=
              False)` in bfloat16 with GUIDED_STEPS guided DDIM steps (cut
              from the default 50; every step is the same program), 480x640
              renders and guidance with a hole in the observed masks:
              conditioning, per-step ms by part (CFG pair forward, decode
              gradients, each branch again with its VJP, update), decode,
              total, peak memory, L1's
              launches against the formula, rho > 0 at every step, frames
              finite in [0, 1], the masked L2 to the guidance against an
              unguided request with the same noise (a reading); one guided
              step traced by stage, backward kernels included
     8c. one float32 guided step at full spatial width with STEP32_FRAMES
              frames through L1's kernels and through its plain forward and
              backward (`plain=True`): x_prev agrees within GUIDED_STEP_TOL;
              its dL/dx through L1's backward kernels and through its
              plain backward after the same forward within GUIDED_GRAD_TOL
              (L2 norms); and that dL/dx with L1's backward in bf16 (the
              bf16 kernels against the plain backward of the same bf16
              inputs) within GUIDED_GRAD_TOL_BF16
  9. raw data, append, two-scale CFG, --nan_debug, viewer
     9a. phase 4's room written as a raw Replica sequence (traj_w_c.txt,
              rgb/rgb_<i>.png, the 660 frames of the 6-view split);
              `dataset_to_colmap replica`; the DUSt3R cloud CLI
              (`geometry.pipeline`) at Dust3rConfig() from a .pth of random
              weights (DUST3R_HEAD_BIAS), the 6 train views at 512x384, 30
              pairs in batches of 4, 300 alignment iterations with the COLMAP
              poses and focals preset, no kernel launched; train_baseline
              GEOM_ITERS iterations from that cloud, launches exact; the pair
              forward ms, the alignment s, the cloud's size, the peak; and
              the aligner's known answer: perfect predictions made from the
              room's rendered depth at the train views, the depth recovered
              within ALIGN_TOL, the presets bitwise
     9b. phase 5c's trainer on the room with holes (APPEND_HOLE) with the oracle
              and DPT-large at DPTConfig() (random weights) under
              append_pcd_from_video_diffusion: one event with the lift and
              add_points, 24 guided steps; points added, the DPT ms for the
              25 frames, the lift s, the step's host ms beside 5c's;
              launches exact
     9c. one ViewCrafterEngine.generate with multiple_cond_cfg at 7b's
              widths in bf16, GEN_STEPS steps: step ms, peak, L1 forward
              exactly 15 a step (three branches) + 2
     9d. a NaN planted during iteration 7 of train_baseline --nan_debug
              stops the run with its bundle (nan_5_7.ckpt / .json); a
              NetworkGUI round trip on localhost answers one 640x480 view
              of 9a's model through K1/K3/K4 (once each), byte for byte
    10. pipelined events (pipeline_guidance) and the camera-batch step, on
              phase 5b's room: 10a phase 5c's trainer with the oracle,
              PIPE_BOUNDARIES boundaries PIPE_SPAN steps apart and the
              drain, inline (serial), with the worker thread and its stream,
              and with the trainer's stream at priority -1: state, stacks
              and random streams bitwise equal across the three, the spans'
              seconds, the step's host ms while an event runs and while none
              does, the finalize wait, launches exact; 10b the ViewCrafter
              engine (random bf16 weights, GUIDED_STEPS guided steps) in that
              trainer: an event alone, then one with the trainer stepping
              beside it on the same card until its worker is done: the
              event's s and its guided DDIM step's ms both ways, the
              trainer's step ms during and after, the peak (below 80 GB),
              launches exact (L1 20 S + 2 / 15 S / 15 S an event); 10c
              train_step_dp of the 6 train views: K1-K6 exactly 6 a step,
              and one step against its plain chain (DP_* tolerances); 10d
              train_guidedvd --pipeline_guidance with the oracle on phase
              6's scene (a checkpoint with an event in flight, launches
              exact) and with 6c's ViewCrafter checkpoint
 11. the B-camera chain (ops/raster_tiles.py::rasterize_tiles_multi) on
              phase 5b's room: 11a B = 2, 5 and 11 orbit cameras (11 x
              1,200 tiles: past K3's shared histogram) as one chain against
              B single renders: the images and radii bitwise, the chain's
              launches exactly (K1 and K2 a camera, K3-K6 once), the
              gradients at B = 2 and 5 within MULTI_GRAD_TOL, the forward's
              ms both ways; at B = 2 and 5 the chain against itself on the
              plain versions (the images by phase 3's K4_TOL, the radii by
              its K1 rule, the summed and the (B, N, 2) offset gradients
              within MULTI_PLAIN_GRAD_TOL, which a K2 that overwrote
              instead of adding would exceed); 11b phase 5c's trainer: an
              oracle event's launches (K3 and K4 once a chain of 5
              frames), guided steps in timed blocks per-view (each view
              its own render, the step before the chain), chain, chain,
              per-view, launches exactly each step, host ms, one traced
              step each way (device ms by stage, sorts and read-backs a
              step)
 12. the device mesh and the last modules: 12a the ViewCrafter engine at
              7b's widths with its weights split over a (1, MESH_TP) mesh
              (cuda:0, cuda:1 where the host has two cards, else cuda:0
              twice; printed): one UNet forward of the guided pair, each
              engine's bf16 against the f32 forward (the sharded error at
              most MESH_BF16_RATIO times the unsharded one's); 8b's guided
              request both ways, each twice (seconds cold and warm, each
              card's peak, the videos
              within MESH_VIDEO_RATIO times the yardstick of the unsharded
              request with its x_T moved by bf16's rounding, L1 launched
              exactly by (kernel, card, heads)); the pair's forward in
              float32 both ways within MESH_F32_TOL, and on
              STEP32_FRAMES frames each branch's float32 UNet VJP within
              MESH_F32_TOL and the sampler's pair VJP within
              MESH_VJP_RATIO times its yardstick of x moved by 2^-24; a level-1
              transformer block on level 0's tokens,
              whose 10 heads split: L1 forward and backward once a card with
              5 heads, output and dL/dx each against the f32 block
              within MESH_BF16_RATIO of the unsharded one's error; 12b
              make_dp_train_step of phase 5b's 6 views on a (2, 1) mesh
              against train_step_dp (loss, gradients within
              MESH_DP_GRAD_TOL in L2, statistics exact, K1-K6 exactly 6 a
              step, host ms in turns); 12c rasterize_tiles with
              colors_precomp, then cov3d_precomp, at phase 4's room: K3-K6
              once each and K1, K2 not at all, the images and gradients
              against the same call on the plain versions (K4_TOL,
              DP_GRAD_TOL) and, on a centred PRECOMP_CROP window, against
              the dense backend; 12d train_baseline --profile_dir for
              PROFILE_ITERS iterations on phase 6's scene: K1-K6 exactly
              once a step, the trace naming K1, K4 and K5
`python3 chip_smoke.py --generate-only STEPS` runs phases 1, 2 and 7b
alone with STEPS DDIM steps; `--guided-only STEPS` phases 1, 2 and 8b
(the 50-step requests of PERF.md); `--backward-only` phases 1, 2, 8a and
8b-8c (L1's backward kernels and the guided step); `--forward-only`
phases 1, 2, 7a and 7b-7c (L1's forward kernels and the DDIM request);
`--gaussian-only` phases 1, 2, 3, 5 and 5b (the Gaussian kernels K1-K6
and the trainer); `--guided-trainer-only` phases 1, 2 and 5c (the guided
trainer); `--vc-trainer-only STEPS` phases 1, 2 and 5d with STEPS guided
DDIM steps (50: a real event's time); `--chain-only` phases 1, 2 and 6d
(the published scripts' chain); `--geometry-only` phases 1, 2 and 9;
`--pipeline-only` phases 1, 2 and 10; `--multi-only` phases 1, 2 and 11;
`--parallel-only` phases 1, 2 and 12.
The line before the last is the JSON kernel table (each kernel's launches
summed over the phases that drive a path: K1-K6 over 4, 5, 5b, 5c, 5d, 6,
6b, 6c, 6d, 9, 10, 11 and 12 (K1 and K2 not in 12c), L1's forward over 5d,
6c, 7b, 8b, 9, 10 and 12, its backward over 5d, 6c, 8b, 10 and 12; each phase's count in `launches_by_phase`; for
K1-K6 `host_ms` beside `ms` and `ms_dense` and `bound_ms_dense` from
phase 5b's view; for K1 also `ms_full_table`, `bound_ms_all_rows` and
their `_dense` twins);
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from guidedvd3dgs_tpu_torch import dataset_to_colmap as port_d2c  # noqa: E402
from guidedvd3dgs_tpu_torch import get_avg_results as port_avg  # noqa: E402
from guidedvd3dgs_tpu_torch import metrics as port_metrics  # noqa: E402
from guidedvd3dgs_tpu_torch import project_pcd_to_views  # noqa: E402
from guidedvd3dgs_tpu_torch import render as port_render  # noqa: E402
from guidedvd3dgs_tpu_torch import train_baseline as port_train_cli  # noqa: E402
from guidedvd3dgs_tpu_torch import train_guidedvd as port_guided_cli  # noqa: E402
from guidedvd3dgs_tpu_torch import train_project_cam as port_project_cli  # noqa: E402
from guidedvd3dgs_tpu_torch.config import (  # noqa: E402
    ModelParams,
    OptimizationParams,
    PipelineParams,
    build_parser,
    get_combined_args,
)
from guidedvd3dgs_tpu_torch.convert import params_from_numpy  # noqa: E402
from guidedvd3dgs_tpu_torch.diffusion import attention as d_attention  # noqa: E402
from guidedvd3dgs_tpu_torch.diffusion import schedules as S  # noqa: E402
from guidedvd3dgs_tpu_torch.diffusion import synthesis  # noqa: E402
from guidedvd3dgs_tpu_torch.diffusion.init import init_diffusion_params  # noqa: E402
from guidedvd3dgs_tpu_torch.diffusion.model import Conditioning, LatentDiffusionConfig, apply_model  # noqa: E402
from guidedvd3dgs_tpu_torch.diffusion.samplers import ddim, ddim_guidance, ddim_multicond  # noqa: E402
from guidedvd3dgs_tpu_torch.geometry import dust3r  # noqa: E402
from guidedvd3dgs_tpu_torch.geometry import global_aligner as GA  # noqa: E402
from guidedvd3dgs_tpu_torch.geometry import pipeline as geometry_pipeline  # noqa: E402
from guidedvd3dgs_tpu_torch.guidance import dpt  # noqa: E402
from guidedvd3dgs_tpu_torch.guidance.loss_guidance import make_guidance_fn, resize_guidance  # noqa: E402
from guidedvd3dgs_tpu_torch.models import gaussians as G  # noqa: E402
from guidedvd3dgs_tpu_torch.models.render import RenderResult, eval_render, render_gaussians  # noqa: E402
from guidedvd3dgs_tpu_torch.ops import _build, expand, preprocess_fused, raster_tiles, segsum, tiling  # noqa: E402
from guidedvd3dgs_tpu_torch.ops import flash_attention as fa  # noqa: E402
from guidedvd3dgs_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain  # noqa: E402
from guidedvd3dgs_tpu_torch.ops.knn import dist_knn3  # noqa: E402
from guidedvd3dgs_tpu_torch.scene import cameras, dataset_readers, synthetic  # noqa: E402
from guidedvd3dgs_tpu_torch.scene.ply import load_gaussian_ply  # noqa: E402
from guidedvd3dgs_tpu_torch.scene.scene import Scene  # noqa: E402
from guidedvd3dgs_tpu_torch.ops import raster_dense  # noqa: E402
from guidedvd3dgs_tpu_torch.parallel import make_dp_train_step, make_mesh, stack_cameras, train_step_dp  # noqa: E402
from guidedvd3dgs_tpu_torch.parallel.model_parallel import Sharded, shard_params  # noqa: E402
from guidedvd3dgs_tpu_torch.train.baseline import BaselineTrainer, lrs_for  # noqa: E402
from guidedvd3dgs_tpu_torch.train import guided as guided_module  # noqa: E402
from guidedvd3dgs_tpu_torch.train.guided import (  # noqa: E402
    FrozenRenderer,
    GuidedTrainer,
    OracleDiffusionEngine,
    ViewCrafterEngine,
    resize_renders,
)
from guidedvd3dgs_tpu_torch.train.checkpoint import load_checkpoint  # noqa: E402
from guidedvd3dgs_tpu_torch.train.guided_checkpoint import load_guided_checkpoint  # noqa: E402
from guidedvd3dgs_tpu_torch.train.project_cam import ProjectCamTrainer  # noqa: E402
from guidedvd3dgs_tpu_torch.utils.lpips import load_lpips, write_random_lpips  # noqa: E402
from guidedvd3dgs_tpu_torch.utils import graphics  # noqa: E402
from guidedvd3dgs_tpu_torch.utils.general import build_rotation  # noqa: E402
from guidedvd3dgs_tpu_torch.utils.image_io import save_images  # noqa: E402
from guidedvd3dgs_tpu_torch.utils.sh import SH2RGB  # noqa: E402
from guidedvd3dgs_tpu_torch.utils import tracing  # noqa: E402
from guidedvd3dgs_tpu_torch.viewer import network_gui  # noqa: E402
from guidedvd3dgs_tpu_torch.utils.vgg_loss import make_vgg_loss_fn, random_vgg19  # noqa: E402

SEED = 20261016
WIDTH, HEIGHT, HFOV = 640, 480, 90.0
N_KERNEL_CHECK = 200_000
N_SCENE = 1_000_000
N_CAMS = 60
ITERATION = 10_000

KERNELS = {
    "preprocess_fwd": ("guidedvd3dgs_tpu_torch/csrc/preprocess_fwd.cu",
                       "guidedvd3dgs_tpu/ops/preprocess_pallas.py:173"),
    "preprocess_bwd": ("guidedvd3dgs_tpu_torch/csrc/preprocess_bwd.cu",
                       "guidedvd3dgs_tpu/ops/preprocess_pallas.py:209"),
    "expand": ("guidedvd3dgs_tpu_torch/csrc/expand.cu", "guidedvd3dgs_tpu/ops/expand.py:249"),
    "blend_fwd": ("guidedvd3dgs_tpu_torch/csrc/blend_fwd.cu",
                  "guidedvd3dgs_tpu/ops/raster_tiles.py:426"),
    "blend_bwd": ("guidedvd3dgs_tpu_torch/csrc/blend_bwd.cu",
                  "guidedvd3dgs_tpu/ops/raster_tiles.py:718"),
    "segsum": ("guidedvd3dgs_tpu_torch/csrc/segsum.cu", "guidedvd3dgs_tpu/ops/segsum.py:144"),
    "flash_attn_fwd": ("guidedvd3dgs_tpu_torch/csrc/flash_attn_fwd.cu",
                       "guidedvd3dgs_tpu/diffusion/nnops.py:193"),
    # the backward of the library kernel that nnops.py:193 calls
    "flash_attn_bwd_dkv": ("guidedvd3dgs_tpu_torch/csrc/flash_attn_bwd.cu",
                           "jax/experimental/pallas/ops/tpu/flash_attention.py:941"),
    "flash_attn_bwd_dq": ("guidedvd3dgs_tpu_torch/csrc/flash_attn_bwd.cu",
                          "jax/experimental/pallas/ops/tpu/flash_attention.py:1287"),
}
L1_BWD_KERNELS = ("flash_attn_bwd_dkv", "flash_attn_bwd_dq")
# the kernels of a render (phase 4); training (phase 5) runs K1-K6
FORWARD_KERNELS = ("preprocess_fwd", "expand", "blend_fwd")
GAUSSIAN_KERNELS = ("preprocess_fwd", "preprocess_bwd", "expand", "blend_fwd", "blend_bwd", "segsum")
# the card's peaks for the bounds (H100 SXM data sheet, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# f32 operations per (instance, pixel) pair a pixel walks before its stop
# (expf counted as one, comparisons not counted), by class. Every walked
# pair takes the offset and the quadratic form (11) and most stop there;
# a blended pair also takes, in K4, exp, alpha, T and the 5 accumulations
# (26 in all); in K5, that and u, the prefix and suffix sums, dalpha, the
# 10 values and their sums over the tile's pixels (56 in all)
WALKED_FLOPS = 11
K4_BLENDED_FLOPS = 26
K5_BLENDED_FLOPS = 56
# K2: max abs error over max |grad| of each output (the same formulas
# differentiated by hand and by torch autograd, another operation order)
K2_TOL = 1e-4
# K5: per instance row, |err| <= K5_ATOL * max |grad| of the field +
# K5_RTOL * |grad| (sums over 256 pixels in another order); a pixel whose
# stop lands within rounding of 1e-4 in one version and not the other (the
# K4 allowance) moves the row of its stopping instance, so at most
# K5_STOP_FRACTION of the rows may exceed that, finite
K5_ATOL = K5_RTOL = 1e-4
K5_STOP_FRACTION = 1e-4
# K6: f32 sums in slot order against the float64 sums; bound
# count * 2^-23 * sum |terms| (sequential summation) + 1e-30
# K1: the same f32 formulas op by op; 1e-5 covers libm differences.
K1_ATOL = K1_RTOL = 1e-5
K1_ROWS = list(range(10)) + [12, 13]
# K4 and the plain chain: the kernel multiplies T sequentially, the plain
# version by a scan, and sums in another order: color/alpha atol 2e-5,
# depth 2e-4, rtol 1e-4. A pixel whose stop test T (1 - alpha) < 1e-4
# lands within that rounding of 1e-4 may stop one instance apart, which
# moves it by at most that instance's weight (< 1e-2, depth < 1e-2 * 5 m);
# at most 1e-4 of the pixels may do so.
K4_TOL = {"color": (2e-5, 1e-2), "depth": (2e-4, 5e-2), "alpha": (2e-5, 1e-2)}
K4_RTOL = 1e-4
K4_STOP_FRACTION = 1e-4
# phase 4's trace: stage of a device kernel by a piece of its name
STAGE_KERNELS = (("K1", "preprocess_fwd_kernel"), ("K3", "expand_kernel"),
                 ("K4", "blend_fwd_kernel"), ("sort", "sort"), ("K5", "blend_bwd_kernel"),
                 ("K6", "segsum_kernel"), ("K2", "preprocess_bwd_kernel"),
                 ("Adam", "multi_tensor_apply"))
PROFILE_REPS = 3
# phase 3 and 5b's kernel times: CUDA events over EVENT_LAUNCHES calls,
# queued behind a sleep of SLEEP_CYCLES (~11 ms at 1.755 GHz, longer than
# the host takes to queue the calls)
EVENT_LAUNCHES = 20
SLEEP_CYCLES = 20_000_000
# phase 5: steps of the full-width trainer, and the steps it traces
TRAIN_ITERS = 60
DENSIFY_AT = 40  # densify_from_iter 20, densification_interval 20, densify_until_iter 60
TRACE_STEPS = range(46, 56)
KNN_CHECK = 100_000  # points of the card-vs-host check of dist_knn3
# phase 5b: steps at trained density, the densify event among them, the
# steps it traces, and the share of the Gaussians the event selects
DENSE_ITERS = 24
DENSE_DENSIFY_AT = 20  # densify_from_iter 10, densification_interval 20, densify_until_iter 24
DENSE_TRACE = range(10, 20)
DENSE_SELECT = 0.1
# phase 5c: the guided trainer on phase 5b's room: one diffusion event of
# EVENT_FRAMES frames (the oracle engine), then GUIDED_TRAINER_STEPS steps
# that each take a pseudo view, GUIDED_TRACE of them traced
EVENT_FRAMES = 25
GUIDED_TRAINER_STEPS = 24
GUIDED_TRACE = range(8, 18)  # iterations; the steps are iterations 2-25
# torch.cat kernels a guided step may launch: K1's and K2's camera rows, 4
# (the baseline step's 2 a view), the screen offsets' gradient and the two
# views' gradients stacked by one UnbindBackward
GUIDED_CAT_KERNELS = 6
# phase 6: iterations of the CLI run on the tool-default synthetic scene;
# 6b: the guided CLI on it with the oracle, pseudo views between these
CLI_ITERS = 2000
CLI_PSEUDO = (200, 1900)
CLI_MIN_EVENTS = 7  # of the 8 the schedule fires (a view without a trajectory skips one)
# 6c: the guided CLI with a ViewCrafter checkpoint on that scene: events at
# iterations 1 and 1 + VC_CLI_EVERY, each of VC_CLI_STEPS guided steps
VC_CLI_ITERS, VC_CLI_EVERY, VC_CLI_STEPS = 30, 15, 3
# phase 6d: the published scripts' chain. The ScanNet++ scenes' frames:
# their train frame numbers among CHAIN_FRAMES numbers spread over the
# span they cover (+-12); the Replica scene of the project-cam trainer
# (room_0/Sequence_2: its 6-view split needs 659 frames); iterations of
# each trainer; the guided run resumed: RESUME_STEPS steps, an event every
# RESUME_EVERY from step 1 (1, 9, 17), the checkpoint at RESUME_AT
CHAIN_FRAMES = 60
REPLICA_SCENE, REPLICA_FRAMES = "room_0/Sequence_2", 660
CHAIN_ITERS = 200
PROJECT_CAM_PROB = 0.8  # the published script's: seed 1 draws a train, a projection, a train epoch...
RESUME_STEPS, RESUME_AT, RESUME_EVERY = 24, 12, 8
# phase 7: the ViewCrafter request (configs/inference_pvd_1024.yaml widths,
# the guidedvd engine size) and L1's shapes on its path: the UNet's level-0
# spatial attention per CFG branch and with the guided step's CFG pair
# batched, the VAE's mid-block attention with the 25 frames batched (encode
# in float32, decode in bfloat16) and at the guided step's decode chunk,
# the per-frame VAE shape of the JAX package, and a ragged tail
GEN_FRAMES, GEN_H, GEN_W = 25, 320, 448
GEN_STEPS = 10  # of the default 50: every DDIM step is the same program
BF16, F32 = torch.bfloat16, torch.float32
DECODE_CHUNK = ddim_guidance.GuidedSampleConfig().decode_chunk
L1_SHAPES = [((25, 5, 2240, 64), BF16), ((25, 5, 2240, 64), F32), ((50, 5, 2240, 64), BF16),
             ((25, 1, 2240, 512), F32), ((25, 1, 2240, 512), BF16), ((DECODE_CHUNK, 1, 2240, 512), BF16),
             ((1, 1, 2240, 512), F32), ((1, 1, 2240, 512), BF16), ((2, 3, 1200, 64), F32)]
L1_MAIN = L1_SHAPES[0]  # the UNet's, ten launches per DDIM step of the bf16 request
L1_VAE = L1_SHAPES[5]  # the decode chunk's: its times are extra fields of the JSON line
# L1 against its plain version on unit-normal inputs: float32 (another sum
# order); bfloat16 against the plain version of the same bf16 inputs, which
# rounds the weights to bf16 before the second product
L1_TOL = {F32: 2e-5, BF16: 1e-2}
# 7c: one float32 DDIM step through L1 and through its plain version; the
# ten attentions differ by ~1e-6, carried through the UNet and the CFG
# scale of 7.5 to latents of O(1)
STEP_TOL = 1e-3
# 7c's bf16 check: the same f32 step with L1's forward run in bf16
# (`bf16_forward`: the bf16 kernels) against the plain version of the same
# bf16 inputs, in L2 norm over |latent|. Read by
# scripts/ddim_step_parity.py at DDIM indices 0, 5, 9 (H100): 4.135e-5,
# 3.059e-5, 6.67e-6 (each twice identical), against 4.396e-4, 3.188e-4,
# 7.032e-5 with one key tile skipped; the weights left unrounded read
# 3.541e-5, 2.625e-5, 5.715e-6, inside the kernels' own rounding gap
STEP_TOL_BF16 = 6e-5
# 7b's and 8b's traces: the stage of each range of the diffusion primitives
# (diffusion/nnops.py, "span:<label>" from utils/tracing.py)
STAGES = {"nn.attention": "attention", "nn.conv": "conv", "nn.group_norm": "GroupNorm", "nn.linear": "matmul"}
STAGE_ORDER = ("L1 fwd", "L1 bwd", "attention", "conv", "GroupNorm", "matmul", "other")
# phase 8: the guided request (GUIDED_STEPS of the default 50), its renders
# and guidance at the train resolution of the Replica camera (the engine
# resizes them), the observed masks with a hole of a fifth of the frame
GUIDED_STEPS = 3
GUIDE_H, GUIDE_W = 480, 640
HOLE = (slice(120, 360), slice(0, 256))  # 240 x 256 of 480 x 640 = 0.2
# L1's shapes in the guided step: the UNet's level-0 attention of one
# branch (25; each branch's VJP runs alone) and with the CFG pair batched
# (50, the pair's forward); the VAE's decode chunk; ragged
L1_BWD_SHAPES = [((25, 5, 2240, 64), BF16), ((25, 5, 2240, 64), F32), ((50, 5, 2240, 64), BF16),
                 ((50, 5, 2240, 64), F32), ((DECODE_CHUNK, 1, 2240, 512), BF16),
                 ((DECODE_CHUNK, 1, 2240, 512), F32), ((2, 3, 1200, 64), F32)]
L1_BWD_MAIN = L1_BWD_SHAPES[0]
L1_BWD_VAE = L1_BWD_SHAPES[4]  # the decode chunk's: its times are extra fields of the JSON line
# dq, dk, dv against the plain backward of the same inputs, max abs error
# over max |grad|: float32 another sum order; bfloat16 the tensor-core
# kernels round dS to bf16 for two of their products (the plain version
# keeps it float32); the log-sum-exp absolute, against torch.logsumexp
L1_BWD_TOL = {F32: 1e-4, BF16: 2e-2}
LSE_TOL = 1e-4
# 8c: one float32 guided step of STEP32_FRAMES frames through L1's kernels
# and through its plain pair, x_prev within GUIDED_STEP_TOL of max |x_prev|;
# and its dL/dx through L1's backward kernels and through its plain
# backward after the same kernel forward (cuDNN deterministic), within
# GUIDED_GRAD_TOL in L2 norm over |dL/dx|. Read by
# scripts/guided_step_parity.py on 8c's inputs (H100): x_prev 2.07e-4, all
# of it the forward's (plain forward with the kernel backward 2.5e-6),
# against 3.69e-4 with dQ zeroed and 7.97e-4 with Delta zeroed; a bf16
# backward (2.05e-4) hides in the forward's gap, which the clamp of the
# decoded frames in the guidance loss spreads. dL/dx 1.713e-5 (the same in
# every run), against 3.894e-5 with the bf16 backward, 1.68e-3 with dQ
# zeroed and 3.88e-3 with Delta zeroed
STEP32_FRAMES = 5
GUIDED_STEP_TOL = 3e-4
GUIDED_GRAD_TOL = 2.6e-5
# 8c's bf16 check: the same dL/dx with L1's backward run in bf16
# (`bf16_backward`: the bf16 kernels, wgmma at D = 64 and mma.sync at the
# VAE's D = 512) against the plain backward of the same bf16 inputs, cuDNN
# deterministic, in L2 norm over |dL/dx|. Read by
# scripts/guided_step_parity.py at the three DDIM indices (H100): 1.776e-5,
# 1.925e-5, 1.92e-5 (each twice identical), against 1.63e-3 to 1.76e-3
# with dQ zeroed and 3.85e-3 to 4.11e-3 with Delta zeroed
GUIDED_GRAD_TOL_BF16 = 4e-5
# phase 9: train_baseline's iterations from the DUSt3R cloud; the DUSt3R
# heads' last bias (x, y, z, conf): random weights at the published width
# put every point ~3 cm from its camera with conf ~1.9, below the
# reference's min_conf_thr of 3, so this bias places the untrained network's
# points 2.5 m in front of the camera (expm1 of z's 1.2528) with conf ~5
# (1 + e^1.386), as a trained one indoors; the aligner's known-answer
# tolerance (median relative depth error over the covered pixels); cfg_img
# of the two-scale CFG request
GEOM_ITERS = 200
DUST3R_HEAD_BIAS = (0.0, 0.0, 1.2528, 1.386)
ALIGN_TOL = 1e-3
MULTICOND_CFG_IMG = 2.5
APPEND_HOLE = 0.25  # 9b's baseline: the room's hole at each train view's centre, by its depth


# phase 10: pipelined events. 10a: events PIPE_SPAN steps apart (an oracle
# event of 25 frames at 1M Gaussians, ~1.2 s, spans about that many
# ~12-ms guided steps); 10b: PIPE_IDLE_STEPS steps without an event after
# the ViewCrafter event; 10c: DP_STEPS camera-batch steps, then one against
# its plain chain: the loss within DP_LOSS_TOL absolute, each gradient and
# the accumulated norms within DP_GRAD_TOL in L2 norm over the plain's (K4
# against its plain version may stop a pixel one instance apart, K6 and K2
# sum in other orders), rows of denom / max radii differing (a radius or a
# visibility at a rounding edge) at most DP_ROW_FRACTION of the Gaussians
PIPE_SPAN = 100
PIPE_BOUNDARIES = 3
PIPE_CLI_ITERS, PIPE_CLI_EVERY = 400, 100  # 10d: boundaries at 1, 101, 201, 301
PIPE_IDLE_STEPS = 30
DP_STEPS = 3
DP_LOSS_TOL = 1e-5
DP_GRAD_TOL = 1e-3
DP_ROW_FRACTION = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def activations(params):
    """The rasterizer's inputs: means, scales, rotations, opacities and the
    SH as the model holds it, (features_dc, features_rest)."""
    with torch.no_grad():
        return (params.xyz.detach().contiguous(), params.get_scaling.contiguous(),
                params.get_rotation.contiguous(), params.get_opacity.contiguous(),
                (params.features_dc.detach().contiguous(), params.features_rest.detach().contiguous()))


def stream_sync() -> None:
    """Wait for the calling thread's current stream only."""
    torch.cuda.current_stream().synchronize()


def median_ms(fn, runs: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def event_ms(fn, launches: int = EVENT_LAUNCHES, warmup: int = 2) -> float:
    """Device ms per call of `fn` by CUDA events over `launches` calls after
    a warm-up. The calls are queued behind a sleep kernel, so the host's
    pace between them does not enter what the events read."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def check_k4(name: str, got, want) -> float:
    """Hold one image output against its plain version (K4_TOL)."""
    atol, stop_atol = K4_TOL[name]
    err = (got - want).abs()
    tight = err <= atol + K4_RTOL * want.abs()
    frac = 1.0 - tight.float().mean().item()
    max_err = err.max().item()
    if not (math.isfinite(max_err) and frac <= K4_STOP_FRACTION and max_err <= stop_atol):
        raise AssertionError(f"{name}: max abs err {max_err:.3g}, {frac:.3g} of pixels above "
                             f"{atol} (allowed {K4_STOP_FRACTION} up to {stop_atol})")
    return max_err


def plain_chain(params, cam, bg):
    """One view through the chain of plain versions: K1's, the binning with
    K3's, K4's (in batches of tiles). Returns ((color, depth, alpha), M)."""
    with torch.no_grad():
        tab = preprocess_fused.preprocess_table_plain(*activations(params), cam, 3, 1.0)
        binning = tiling.bin_gaussians(tab, preprocess_fused.visible_radii(tab), cam.width,
                                       cam.height, expand_fn=expand.expand_instances_plain)
        out = tuple(x[0] for x in raster_tiles.blend_fwd_plain(tab, binning, bg, cam.width, cam.height))
    return out, binning.num_instances


def trace_summary(prof, units: int):
    """From a torch.profiler trace of `units` views or steps: the device ms
    per unit of each stage (by kernel name), the device's idle share of the
    traced span (first event to last device event; the profiler's own host
    cost widens the gaps), the host ms per unit and count per unit of the
    read-backs (`aten::_local_scalar_dense`), and the concatenations: the
    count and device ms per unit of torch.cat's kernels with the longest
    one's us, and the CatBackward nodes (a split of a gradient) per unit."""
    stage_us, spans, readback_us, readbacks = {}, [], 0.0, 0
    cat_us, cat_longest, cats, cat_backward = 0.0, 0.0, 0, 0
    first, last = math.inf, -math.inf
    for evt in prof.events():
        start, end = evt.time_range.start, evt.time_range.end
        first = min(first, start)
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            name = evt.name.lower()
            stage = next((s for s, key in STAGE_KERNELS if key in name), "other")
            stage_us[stage] = stage_us.get(stage, 0.0) + (end - start)
            spans.append((start, end))
            last = max(last, end)
            if "catarraybatchedcopy" in name:
                cats += 1
                cat_us += end - start
                cat_longest = max(cat_longest, end - start)
        elif evt.name == "aten::_local_scalar_dense":
            readback_us += end - start
            readbacks += 1
        elif "CatBackward" in evt.name:
            cat_backward += 1
    ms = {k: v / 1e3 / units for k, v in stage_us.items()}
    concat = dict(kernels=cats / units, ms=cat_us / 1e3 / units, longest_us=cat_longest,
                  cat_backward=cat_backward / units)
    return ms, idle_share(spans, first, last), readback_us / 1e3 / units, readbacks / units, concat


def fmt_concat(concat: dict, unit: str) -> str:
    return (f"torch.cat kernels/{unit} {concat['kernels']:g} ({concat['ms']:.4f} ms, the longest "
            f"{concat['longest_us']:.1f} us), CatBackward/{unit} {concat['cat_backward']:g}")


def idle_share(spans, first: float, last: float) -> float:
    """1 - (the union of the device spans) / (first event to last device event)."""
    if not spans:
        raise RuntimeError("the profiler recorded no device time")
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return 1.0 - busy / (last - first)


PROFILER_ACTIVITIES = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def profile_views(params, cams, bg, reps: int):
    """trace_summary of `eval_render` over the views, `reps` times."""
    with torch.profiler.profile(activities=PROFILER_ACTIVITIES) as prof:
        for _ in range(reps):
            for cam in cams:
                eval_render(params, cam, bg, 3)
        torch.cuda.synchronize()
    return trace_summary(prof, reps * len(cams))


def fmt_stages(dev_ms: dict) -> str:
    order = ["K1", "K3", "sort", "K4", "K5", "K6", "K2", "Adam", "other"]
    return " ".join(f"{k} {dev_ms[k]:.3f}" for k in order if k in dev_ms) + \
        f" (total {sum(dev_ms.values()):.3f})"


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this check needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    log(f"phase 1 device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"count {torch.cuda.device_count()} | torch {torch.__version__} cuda {torch.version.cuda}")
    return dev


def kernel_name(mangled: str) -> str:
    """`name<i, ...>` of a mangled kernel: its identifier ending in
    `kernel` and its integer template arguments."""
    i = 0
    while i < len(mangled):
        m = re.match(r"\d+", mangled[i:])
        if not m:
            i += 1
            continue
        start = i + m.end()
        ident = mangled[start:start + int(m.group())]
        i = start + len(ident)
        if ident.endswith("kernel"):
            args = re.match(r"I((?:Li-?\d+E)+)", mangled[i:])
            ints = re.findall(r"Li(-?\d+)E", args.group(1)) if args else []
            return ident + (f"<{', '.join(ints)}>" if ints else "")
    return mangled


def ptxas_summary(build_log: str) -> list[str]:
    """One line per kernel of `nvcc -Xptxas=-v` output: its name, then
    ptxas's register, barrier, shared memory and stack line."""
    out, name = [], None
    for ln in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = kernel_name(m.group(1))
        elif "Used" in ln and name is not None:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}")
            name = None
    return out


def phase_build():
    t0 = time.perf_counter()
    path, compile_s, build_log = _build.build()
    _build.library()
    log(f"phase 2 build: {path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {compile_s:.1f} s) | ptxas: {'; '.join(ptxas_summary(build_log))}")


def bound(n_bytes: float, n_flops: float, peak_flops: float = PEAK_F32_FLOPS):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak of their type (f32 unless
    given). Returns (ms, bound_by)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def evaluated_pairs(tab, binning, width: int, height: int):
    """(instance, pixel) pairs the blend evaluates on this data, by class:
    (blended, walked but not blended), and each tile's walk: the instances
    up to its last pixel's stop, where K5's block leaves. Each pixel inside
    the image walks its tile's instances up to and including the one that
    stops it (the plain version's closed form of K4's rule)."""
    gx = binning.grid_x
    blended = walked_total = 0
    walks = []
    with torch.no_grad():
        for t0, t1 in raster_tiles._tile_batches(binning.tile_count.tolist(),
                                                  raster_tiles.PLAIN_BATCH_ELEMS):
            q = raster_tiles.tile_batch(tab, binning, t0, t1)
            walked = (torch.cumsum(q.trigger.int(), dim=1) - q.trigger.int() == 0) & q.valid[:, :, None]
            tids = torch.arange(t0, t1, device=tab.device)
            lin = torch.arange(raster_tiles.TILE_PIX, device=tab.device)
            inside = ((tids % gx)[:, None] * 16 + lin[None, :] % 16 < width) & \
                ((tids // gx)[:, None] * 16 + lin[None, :] // 16 < height)
            per_pixel = walked.sum(1) * inside
            walked_total += int(per_pixel.sum())
            walks.append(per_pixel.amax(1))
            blended += int((q.include.sum(1) * inside).sum())
    return blended, walked_total - blended, torch.cat(walks)


def tile_stats(binning, walks) -> str:
    """max, p99 and mean of the instances per tile and of the tiles' walks."""
    def stats(x):
        x = x.float()
        return f"max {int(x.max())} p99 {float(torch.quantile(x, 0.99)):.0f} mean {float(x.mean()):.1f}"
    return f"tile_count {stats(binning.tile_count)}; walk to the last pixel's stop {stats(walks)}"


def check_rows(got, want, atol, rtol):
    """Rows of `got` within atol * max |want| of the column + rtol |want|:
    (fraction of rows outside, max abs err)."""
    err = (got - want).abs()
    scale = want.abs().amax(dim=0, keepdim=True)
    bad_rows = (err > atol * scale + rtol * want.abs()).any(dim=1)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite values")
    return bad_rows.float().mean().item(), err.max().item()


def bwd_inputs(acts, cam, tab, binning, image, gen):
    """K5's and K2's arguments for one view, from its K1 table, binning and
    K4 image: seeded cotangents of the image (dC, 0.1 dD, dA) and of the
    table's ten rows (none on culled rows, as the rasterizer hands them)."""
    dev, h, w = tab.device, cam.height, cam.width
    dC = torch.randn((1, 3, h, w), generator=gen, device=dev)
    dD = 0.1 * torch.randn((1, h, w), generator=gen, device=dev)
    dA = torch.randn((1, h, w), generator=gen, device=dev)
    visible = (preprocess_fused.visible_radii(tab) > 0).float()
    cot = torch.randn((10, tab.shape[1]), generator=gen, device=dev) * visible
    return (tab, binning, *image, dC, dD, dA, w, h), (*acts, cam, 3, 1.0, cot)


def view_inputs(params, cam, bg, seed: int):
    """One view's K5 and K2 arguments (bwd_inputs, cotangents from `seed`),
    through the kernels K1 (as the tile rasterizer calls it), K3 and K4."""
    acts = activations(params)
    tab = preprocess_fused.preprocess_fused_fwd(*acts, cam, 3, 1.0, skip_unbinned=True)
    binning = tiling.bin_gaussians(tab, preprocess_fused.visible_radii(tab), cam.width, cam.height)
    image = raster_tiles._run_fwd(tab, binning, bg, cam.width, cam.height)
    gen = torch.Generator(device=tab.device)
    gen.manual_seed(seed)
    return bwd_inputs(acts, cam, tab, binning, image, gen)


def kernel_times(fn, plain_fn=None, library_fn=None) -> dict:
    """ms of a kernel's wrapper by CUDA events (event_ms) with its
    host-clock median beside it (`host_ms`), the plain version's host-clock
    median and the library call's CUDA-event ms, where given."""
    out = dict(ms=event_ms(fn), extra=dict(host_ms=median_ms(fn)))
    if plain_fn is not None:
        out["plain_ms"] = median_ms(plain_fn)
    if library_fn is not None:
        out["library_ms"] = event_ms(library_fn)
    return out


def kernel_check_view(dev):
    """Phase 3's data: a 200,000-Gaussian room, one orbit view, a background."""
    rng = np.random.default_rng(SEED)
    params = params_from_numpy(synthetic.room_gaussians(N_KERNEL_CHECK, rng), dev)
    _, cams = synthetic.orbit(N_CAMS, WIDTH, HEIGHT, HFOV, rng)
    return params, cams[7].raster_camera(dev), torch.tensor([0.1, 0.2, 0.3], device=dev)


def dense_room(dev):
    """Phase 5b's room: its ground truth (N_SCENE Gaussians), the orbit's
    cameras, and the noisy model the trainer starts from (on the card)."""
    rng = np.random.default_rng(SEED + 3)
    gt = synthetic.room_gaussians(N_SCENE, rng)
    _, pcams = synthetic.orbit(N_CAMS, WIDTH, HEIGHT, HFOV, rng)
    return gt, pcams, params_from_numpy(noisy_model(gt, rng), dev)


def dense_view(pcams, dev):
    """The view of phase 5b's kernel timings: its first train view."""
    return pcams[synthetic.split_ids(N_CAMS, 6)[0][0]].raster_camera(dev)


def k1_bounds(acts, binned: int) -> dict:
    """K1's two bounds on one view: the geometry (means, scales, rotations,
    opacity: 44 B) read and the 16 rows (64 B) written for every Gaussian,
    and the SH rows (16 coefficients at degree 3: 192 B) read only for the
    `binned` Gaussians, those a tile holds (`needed`: what the tile
    rasterizer's K1 reads), or for every Gaussian (`all_rows`: the full
    table's); ~600 operations per Gaussian at SH 3 (transform, cov3D, EWA,
    conic, tile count, 48 SH products)."""
    n, sh_bytes = acts[0].shape[0], 16 * 3 * 4
    base = n * (11 * 4 + 16 * 4)
    return dict(needed=bound(base + binned * sh_bytes, 600 * n),
                all_rows=bound(base + n * sh_bytes, 600 * n))


def k6_bound(grad, binning):
    """K6's bound on one view: 40 B read per instance slot, the offset and
    count read and 40 B written per Gaussian; one add per value."""
    total, n = grad.shape[0], binning.offsets.numel()
    return bound(total * 40 + n * 48, total * 10)


def k3_bound(k3_args):
    """K3's bound on one view: the count read for every Gaussian, the other
    11 rows (7 of the table, rect x, y, w and the offset) only for the
    Gaussians in view (count > 0; no slot needs the others), 12 B per
    instance and the histogram written; ~60 operations per instance (the
    tile cull)."""
    count, num_tiles, total = k3_args[4], k3_args[-2], k3_args[-1]
    in_view = int((count > 0).sum())
    return bound(count.numel() * 4 + in_view * 11 * 4 + total * 12 + num_tiles * 4, 60 * total)


def k4_bound(binning, width: int, height: int, blended: int, culled: int):
    """K4's bound on one view: 40 B of fields + 4 B id per binned instance,
    the tiles' start, count and order, 5 f32 out per pixel; the pairs'
    operations."""
    total, num_tiles = binning.num_instances, binning.grid_x * binning.grid_y
    return bound(total * 44 + num_tiles * 12 + width * height * 20,
                 K4_BLENDED_FLOPS * blended + WALKED_FLOPS * culled)


def k5_bound(k5_args, blended: int, culled: int):
    """K5's bound on one view: fields, owner and slot per binned instance,
    10 f32 in per pixel, 40 B out per instance; the pairs' operations."""
    binning, width, height = k5_args[1], k5_args[-2], k5_args[-1]
    total, num_tiles, hw = binning.num_instances, binning.grid_x * binning.grid_y, width * height
    return bound(total * 48 + num_tiles * 8 + hw * 40 + total * 40,
                 K5_BLENDED_FLOPS * blended + WALKED_FLOPS * culled)


def k2_bound(k2_args):
    """K2's bound: the inputs read and the gradients (shaped like them)
    written, 10 cotangents read; ~1000 operations per Gaussian (recompute
    and reverse sweep)."""
    acts, n = k2_args[:4] + tuple(k2_args[4]), k2_args[0].shape[0]
    n_in = sum(t.numel() for t in acts) * 4
    return bound(2 * n_in + 10 * 4 * n, 1000 * n)


def phase_kernels(dev):
    params, cam, bg = kernel_check_view(dev)
    acts = activations(params)
    n = acts[0].shape[0]
    res = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    # K1: the full table (the JAX kernel's) against the plain version, then
    # as the tile rasterizer calls it (rows 6-8 of the Gaussians without a
    # tile skipped, a screen offset) against the full table, bitwise
    tab_k = preprocess_fused.preprocess_fused_fwd(*acts, cam, 3, 1.0)
    tab_p = preprocess_fused.preprocess_table_plain(*acts, cam, 3, 1.0)
    screen_off = 0.01 * torch.randn((n, 2), generator=torch.Generator(device=dev).manual_seed(SEED + 9),
                                    device=dev)
    tab_s = preprocess_fused.preprocess_fused_fwd(*acts, cam, 3, 1.0, means2d_offset=screen_off,
                                                  skip_unbinned=True)
    torch.cuda.synchronize()
    d = (tab_k[K1_ROWS] - tab_p[K1_ROWS]).abs()
    if not bool((d <= K1_ATOL + K1_RTOL * tab_p[K1_ROWS].abs()).all()):
        raise AssertionError(f"K1 fields differ: max abs err {d.max().item():.3g}")
    if not torch.equal(tab_k[11], tab_p[11]):
        raise AssertionError("K1 visibility differs")
    rad_bad = int((tab_k[10] != tab_p[10]).sum())
    if rad_bad > max(10, N_KERNEL_CHECK // 10000):
        raise AssertionError(f"K1 radius differs on {rad_bad} Gaussians")
    k1_err = d.max().item()
    want = tab_k.clone()
    want[0] = want[0] + screen_off[:, 0] * (0.5 * cam.width)
    want[1] = want[1] + screen_off[:, 1] * (0.5 * cam.height)
    binned = tiling.tile_rects(want[0], want[1], preprocess_fused.visible_radii(want), want[12], want[13],
                               cam.width, cam.height)[4] > 0
    want[6:9, ~binned] = 0.0
    if not torch.equal(tab_s, want):
        raise AssertionError("K1 with the skip and the offset differs from its full table plus the offset "
                             "(rows 6-8 zero where no tile) in bits")
    n_binned = int(binned.sum())
    k1_bounds_v = k1_bounds(acts, n_binned)
    res["preprocess_fwd"] = dict(
        max_abs_err=k1_err,
        **kernel_times(lambda: preprocess_fused.preprocess_fused_fwd(*acts, cam, 3, 1.0, skip_unbinned=True),
                       lambda: preprocess_fused.preprocess_table_plain(*acts, cam, 3, 1.0,
                                                                       skip_unbinned=True)),
        bound=k1_bounds_v["needed"],
    )
    res["preprocess_fwd"]["extra"].update(
        ms_full_table=event_ms(lambda: preprocess_fused.preprocess_fused_fwd(*acts, cam, 3, 1.0)),
        bound_ms_all_rows=k1_bounds_v["all_rows"][0])

    # K3, on the kernel table
    tab = tab_k
    radii = preprocess_fused.visible_radii(tab)
    k3_args = (tab, *tiling.expand_inputs(tab, radii, WIDTH, HEIGHT))
    total = k3_args[-1]
    out_k = expand.expand_instances(*k3_args)
    out_p = expand.expand_instances_plain(*k3_args)
    torch.cuda.synchronize()
    for nm, a, b in zip(("keys", "owners", "hist"), out_k, out_p):
        if not torch.equal(a, b):
            raise AssertionError(f"K3 {nm} differ from the plain version")
    k3_err = 0.0  # bit-exact, checked above
    res["expand"] = dict(
        max_abs_err=k3_err,
        **kernel_times(lambda: expand.expand_instances(*k3_args),
                       lambda: expand.expand_instances_plain(*k3_args)),
        bound=k3_bound(k3_args),
    )

    # K4, on the kernel binning
    binning = tiling.bin_gaussians(tab, radii, WIDTH, HEIGHT)
    img_k = raster_tiles._run_fwd(tab, binning, bg, WIDTH, HEIGHT)
    img_p = raster_tiles.blend_fwd_plain(tab, binning, bg, WIDTH, HEIGHT)
    torch.cuda.synchronize()
    k4_errs = {nm: check_k4(nm, a, b) for nm, a, b in zip(("color", "depth", "alpha"), img_k, img_p)}
    k4_err = max(k4_errs.values())
    blended, culled, walks = evaluated_pairs(tab, binning, WIDTH, HEIGHT)
    res["blend_fwd"] = dict(
        max_abs_err=k4_err,
        **kernel_times(lambda: raster_tiles._run_fwd(tab, binning, bg, WIDTH, HEIGHT),
                       lambda: raster_tiles.blend_fwd_plain(tab, binning, bg, WIDTH, HEIGHT)),
        bound=k4_bound(binning, WIDTH, HEIGHT, blended, culled),
    )

    # K5, on the kernel forward with seeded cotangents
    bwd_args, k2_args = bwd_inputs(acts, cam, tab, binning, img_k, gen)
    gi_k = raster_tiles._run_bwd(*bwd_args)
    gi_p = raster_tiles.blend_bwd_plain(*bwd_args)
    torch.cuda.synchronize()
    k5_bad, k5_err = check_rows(gi_k, gi_p, K5_ATOL, K5_RTOL)
    if k5_bad > K5_STOP_FRACTION:
        raise AssertionError(f"K5: {k5_bad:.3g} of the instance rows outside the tolerance "
                             f"(allowed {K5_STOP_FRACTION}); max abs err {k5_err:.3g}")
    res["blend_bwd"] = dict(
        max_abs_err=k5_err,
        **kernel_times(lambda: raster_tiles._run_bwd(*bwd_args),
                       lambda: raster_tiles.blend_bwd_plain(*bwd_args)),
        bound=k5_bound(bwd_args, blended, culled),
    )

    # K6, on the kernel's per-instance gradients
    off, cnt = binning.offsets, binning.count
    acc_k = segsum.segment_sum_sorted(gi_k, off, cnt)
    acc_p = segsum.segment_sum_sorted_plain(gi_k, off, cnt)
    abs_sum = segsum.segment_sum_sorted_plain(gi_k.abs(), off, cnt)
    torch.cuda.synchronize()
    k6_tol = cnt.float()[None, :] * 2.0 ** -23 * abs_sum + 1e-30
    k6_diff = (acc_k - acc_p).abs()
    if not bool((k6_diff <= k6_tol).all()):
        raise AssertionError(f"K6 differs from the float64 sums: max abs err {k6_diff.max().item():.3g}")
    res["segsum"] = dict(
        max_abs_err=k6_diff.max().item(),
        **kernel_times(lambda: segsum.segment_sum_sorted(gi_k, off, cnt),
                       lambda: segsum.segment_sum_sorted_plain(gi_k, off, cnt),
                       lambda: torch.segment_reduce(gi_k, "sum", lengths=cnt, axis=0)),
        bound=k6_bound(gi_k, binning),
    )

    # K2, on seeded cotangents (culled rows none, as the rasterizer hands
    # them), with the SH pair; and with the SH as one tensor, bitwise alike
    g_k = preprocess_fused.preprocess_fused_bwd(*k2_args)
    g_p = preprocess_fused.preprocess_fused_bwd_plain(*k2_args)
    cat_args = list(k2_args)
    cat_args[4] = torch.cat(k2_args[4], dim=1)
    g_cat = preprocess_fused.preprocess_fused_bwd(*cat_args)
    torch.cuda.synchronize()
    g_k, g_p = g_k[:4] + g_k[4], g_p[:4] + g_p[4]
    if not all(torch.equal(a, b) for a, b in zip(g_k[:4] + (torch.cat(g_k[4:], 1),), g_cat)):
        raise AssertionError("K2 with the SH as one tensor differs from K2 with the pair in bits")
    k2_errs = {}
    for nm, a, b in zip(("means", "scales", "rotations", "opacity", "features_dc", "features_rest"),
                        g_k, g_p):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"K2 {nm}: non-finite gradients")
        k2_errs[nm] = ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
        if k2_errs[nm] > K2_TOL:
            raise AssertionError(f"K2 {nm}: max abs err / max |grad| {k2_errs[nm]:.3g} > {K2_TOL}")
    res["preprocess_bwd"] = dict(
        max_abs_err=max((a - b).abs().max().item() for a, b in zip(g_k, g_p)),
        **kernel_times(lambda: preprocess_fused.preprocess_fused_bwd(*k2_args),
                       lambda: preprocess_fused.preprocess_fused_bwd_plain(*k2_args)),
        bound=k2_bound(k2_args),
    )

    def t(name):
        r = res[name]
        lib = f", library {r['library_ms']:.4f} ms" if "library_ms" in r else ""
        return (f"{r['ms']:.4f} ms (CUDA events; host clock {r['extra']['host_ms']:.3f}) vs plain "
                f"{r['plain_ms']:.3f} ms{lib}, bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")

    k1 = res["preprocess_fwd"]["extra"]
    log(f"phase 3 kernels vs plain (N={N_KERNEL_CHECK}, {WIDTH}x{HEIGHT}, SH 3; {n_binned} Gaussians in a "
        f"tile; {total} instances; instance-pixel pairs walked {blended + culled}, blended {blended}; "
        f"{tile_stats(binning, walks)}): "
        f"K1 full table max abs err {k1_err:.3g} (tol {K1_ATOL} + {K1_RTOL} rel; radius mismatches "
        f"{rad_bad}), with the skip and an offset bitwise the full table's (rows 6-8 zero where no tile); "
        f"as the rasterizer calls it {t('preprocess_fwd')} (needed bytes: the SH of the Gaussians in a "
        f"tile), all-rows bound {k1['bound_ms_all_rows']:.4f} ms, the full table "
        f"{k1['ms_full_table']:.4f} ms | K3 keys/owners/hist exact, {t('expand')} | "
        f"K4 max abs err " + ", ".join(f"{k} {v:.3g}" for k, v in k4_errs.items())
        + f" (tol (atol, stop atol) {K4_TOL}, rtol {K4_RTOL}) {t('blend_fwd')} | "
        f"K5 max abs err {k5_err:.3g}, rows outside {K5_ATOL} max|g| + {K5_RTOL} |g|: {k5_bad:.3g} "
        f"(allowed {K5_STOP_FRACTION}) {t('blend_bwd')} | "
        f"K6 max abs err {res['segsum']['max_abs_err']:.3g} (tol count 2^-23 sum|g|) {t('segsum')} | "
        f"K2 max abs err / max |grad| " + ", ".join(f"{k} {v:.3g}" for k, v in k2_errs.items())
        + f" (tol {K2_TOL}; the SH as one tensor bitwise alike) {t('preprocess_bwd')}")
    return res


def noisy_model(gt: dict, rng) -> dict:
    """The ground-truth room with noise on its colors and opacities: a
    scene at trained density that is not yet exact."""
    model = {k: v.copy() for k, v in gt.items()}
    model["features_dc"] += rng.normal(scale=0.1, size=model["features_dc"].shape).astype(np.float32)
    model["opacity"] += rng.normal(scale=0.3, size=model["opacity"].shape).astype(np.float32)
    return model


def phase_main(dev, work: Path):
    rng = np.random.default_rng(SEED + 1)
    gt = synthetic.room_gaussians(N_SCENE, rng)
    c2ws, cams = synthetic.orbit(N_CAMS, WIDTH, HEIGHT, HFOV, rng)
    bg = torch.zeros(3, device=dev)
    gt_params = params_from_numpy(gt, dev)
    images = [eval_render(gt_params, c.raster_camera(dev), bg, 3).color.clamp(0, 1).cpu().numpy()
              for c in cams]
    del gt_params
    model = noisy_model(gt, rng)
    train_ids = [int(i) for i in np.linspace(0, N_CAMS, 6, endpoint=False)]
    test_ids = [i for i in range(0, N_CAMS, 5) if i not in train_ids]
    src, mdl = work / "scene", work / "model"
    synthetic.write_scene(str(src), str(mdl), c2ws, cams, images, model, train_ids, test_ids,
                          ITERATION, rng)

    # the main path, through the entry points a user calls
    _build.reset_launches()
    t0 = time.perf_counter()
    port_render.main(["-m", str(mdl), "--skip_train", "--device", "cuda"])
    torch.cuda.synchronize()
    render_cli_s = time.perf_counter() - t0
    port_metrics.evaluate([str(mdl)], device="cuda")
    launches = dict(_build.LAUNCHES)
    for name in FORWARD_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the render path")
    if any(launches[name] for name in launches if name not in FORWARD_KERNELS):
        raise AssertionError(f"a backward kernel ran on the render path: {launches}")

    results = json.loads((mdl / "results.json").read_text())[f"ours_{ITERATION}"]
    psnr, ssim = results["PSNR"], results["SSIM"]
    if not (math.isfinite(psnr) and math.isfinite(ssim) and psnr > 15.0):
        raise AssertionError(f"bad quality: PSNR {psnr} SSIM {ssim}")
    n_png = len(os.listdir(mdl / "test" / f"ours_{ITERATION}" / "renders"))
    if n_png != len(test_ids):
        raise AssertionError(f"{n_png} renders for {len(test_ids)} test views")

    # render time per view (host clock, synchronised) on the same test views
    params = params_from_numpy(model, dev)
    test_cams = [cams[i].raster_camera(dev) for i in test_ids]
    whole, instances = [], []
    for cam in test_cams:
        whole.append(median_ms(lambda: eval_render(params, cam, bg, 3), runs=5, warmup=1))
        ref = eval_render(params, cam, bg, 3)
        if float(ref.color.std()) < 0.01:
            raise AssertionError("render is (nearly) constant")
        instances.append(ref.num_instances)
    # where the device time goes: one trace of eval_render over the views
    dev_ms, idle, readback_ms, readbacks, concat = profile_views(params, test_cams, bg, PROFILE_REPS)

    # one full-size view against the chain of plain versions
    (c_p, d_p, a_p), total_p = plain_chain(params, test_cams[0], bg)
    ref = eval_render(params, test_cams[0], bg, 3)
    if total_p != ref.num_instances:
        raise AssertionError(f"plain chain has {total_p} instances, kernels {ref.num_instances}")
    chain_err = max(check_k4(nm, a, b) for nm, a, b in
                    zip(("color", "depth", "alpha"), (ref.color, ref.depth, ref.alpha), (c_p, d_p, a_p)))

    log(f"phase 4 main path ({N_SCENE} Gaussians SH 3, {WIDTH}x{HEIGHT} hfov {HFOV}, "
        f"{len(test_ids)} test views): PSNR {psnr:.4f} dB SSIM {ssim:.5f} | instances/view median "
        f"{int(statistics.median(instances))} (min {min(instances)}, max {max(instances)}) | "
        f"render ms/view median {statistics.median(whole):.3f} | traced device ms/view "
        + fmt_stages(dev_ms) + f", idle share {idle:.3f} (under the profiler) | "
        f"read-backs/view {readbacks:g}, host wait {readback_ms:.3f} ms/view; {fmt_concat(concat, 'view')} | "
        f"render CLI {render_cli_s:.1f} s | launches {launches} | "
        f"plain chain max abs err {chain_err:.3g}")
    return launches


class _TrainViews:
    """The trainer's scene: its train views and the camera extent."""

    def __init__(self, cams, extent):
        self.cams, self.cameras_extent = cams, extent

    def getTrainCameras(self):
        return self.cams

    def getTestCameras(self):
        return []

    def save(self, iteration, state):
        pass


def train_views(gt: dict, pcams, dev):
    """The tool's 6 train views of the orbit, as Cameras holding images
    rendered from the ground-truth Gaussians `gt`, and their extent."""
    train_ids, _ = synthetic.split_ids(N_CAMS, 6)
    gt_params = params_from_numpy(gt, dev)
    black = torch.zeros(3, device=dev)
    cams = []
    for i in train_ids:
        c = pcams[i]
        img = eval_render(gt_params, c.raster_camera(dev), black, 3).color.clamp(0, 1).cpu().numpy()
        cams.append(cameras.Camera(colmap_id=i, R=c.R, T=c.T, FoVx=c.FoVx, FoVy=c.FoVy, image=img))
    return _TrainViews(cams, dataset_readers.getNerfppNorm(cams)["radius"])


def time_densify(trainer, events: list, prepare=None) -> None:
    """Wrap the trainer's densification: each event appends (ms, Gaussians
    before, after); `prepare(trainer)` runs first, outside the time."""
    densify = trainer.densify

    def run(it):
        if prepare is not None:
            prepare(trainer)
        torch.cuda.synchronize()
        before = trainer.state.num_gaussians
        t = time.perf_counter()
        densify(it)
        torch.cuda.synchronize()
        events.append(((time.perf_counter() - t) * 1e3, before, trainer.state.num_gaussians))

    trainer.densify = run


def run_steps(trainer, iters: int, trace: range, first: int = 1, on_step=None):
    """Steps first..iters, each timed on the host clock (synchronised), with
    a torch.profiler trace over the steps of `trace`; `on_step(it)` runs
    after each step, outside its time. Returns ({step: ms}, losses,
    instances per step, the profiler)."""
    prof = torch.profiler.profile(activities=PROFILER_ACTIVITIES)
    step_ms, losses, instances = {}, [], []
    for it in range(first, iters + 1):
        if it == trace.start:
            prof.start()
        torch.cuda.synchronize()
        t = time.perf_counter()
        st = trainer.step(it)
        torch.cuda.synchronize()
        step_ms[it] = (time.perf_counter() - t) * 1e3
        if it == trace[-1]:
            prof.stop()
        losses.append(st.loss)
        instances.append(st.num_instances)
        if on_step is not None:
            on_step(it)
    return step_ms, losses, instances, prof


def check_no_sh_split(concat: dict) -> None:
    """A training step hands K1 and K2 the SH in place: no gradient is split
    after a concatenation."""
    if concat["cat_backward"]:
        raise AssertionError(f"{concat['cat_backward']:g} CatBackward nodes a step: a concatenation "
                             "is differentiated on the training step")


def check_launches(iters: int) -> dict:
    launches = dict(_build.LAUNCHES)
    if any(launches[n] != iters for n in GAUSSIAN_KERNELS) or any(
            launches[n] for n in ("flash_attn_fwd",) + L1_BWD_KERNELS):
        raise AssertionError(f"each of K1-K6 should run once per step ({iters}): {launches}")
    return launches


def phase_train(dev):
    """The trainer at full width: a 1M-point noisy cloud of the room, six
    train views rendered from the 1M-Gaussian ground truth, TRAIN_ITERS steps
    at SH degree 3 with one densify_and_prune (at DENSIFY_AT)."""
    rng = np.random.default_rng(SEED + 2)
    pts, cols = synthetic.sample_room(rng, N_SCENE)
    gt = synthetic.gt_arrays(pts, cols, rng)
    _, pcams = synthetic.orbit(N_CAMS, WIDTH, HEIGHT, HFOV, rng)
    views = train_views(gt, pcams, dev)
    init_pts, init_cols = synthetic.init_cloud(pts, cols, N_SCENE, rng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = G.create_from_pcd(init_pts, init_cols, device=dev)  # dist_knn3 at 1M
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3
    # the 3-NN on the card against the same code on the host (100k points)
    sub = torch.from_numpy(np.ascontiguousarray(init_pts[:KNN_CHECK], np.float32))
    d_dev, i_dev = dist_knn3(sub.to(dev))
    d_cpu, i_cpu = dist_knn3(sub)
    same = (i_dev.cpu().sort(1).values == i_cpu.sort(1).values).all(1)
    knn_same = same.float().mean().item()
    # the approximate search may pick other neighbours where distances tie
    # within rounding (matrix products in another order); where both pick
    # the same ones, the distances agree
    knn_err = ((d_dev.cpu() - d_cpu).abs() / d_cpu)[same].max().item()
    if knn_same < 0.999 or knn_err > 1e-5:
        raise AssertionError(f"dist_knn3 on the card: {knn_same} same neighbours, d2 rel err {knn_err}")
    opt = OptimizationParams(iterations=TRAIN_ITERS, densify_from_iter=20, densification_interval=20,
                             prune_from_iter=20, densify_until_iter=TRAIN_ITERS)
    trainer = BaselineTrainer(views, state, opt, PipelineParams(), ModelParams())
    trainer.active_sh_degree = 3  # as after the SH warmup
    events = []
    time_densify(trainer, events)

    # the main path of this slice
    _build.reset_launches()
    step_ms, losses, instances, prof = run_steps(trainer, TRAIN_ITERS, TRACE_STEPS)
    launches = check_launches(TRAIN_ITERS)

    if len(events) != 1:
        raise AssertionError(f"{len(events)} densification events, expected one")
    first, last = float(losses[0]), float(losses[-1])
    # each epoch of 6 steps sees every train view once: compare whole epochs
    n_views = len(views.cams)
    epoch_first = float(torch.stack(losses[:n_views]).mean())
    epoch_last = float(torch.stack(losses[-n_views:]).mean())
    if not (math.isfinite(first) and math.isfinite(last) and epoch_last < epoch_first):
        raise AssertionError(f"the loss did not fall: step 1 {first}, step {TRAIN_ITERS} {last}; "
                             f"first epoch mean {epoch_first}, last {epoch_last}")
    untraced = [ms for it, ms in step_ms.items() if it not in TRACE_STEPS and it != DENSIFY_AT]
    dev_ms, idle, rb_ms, rbs, concat = trace_summary(prof, len(TRACE_STEPS))
    check_no_sh_split(concat)
    lines = [
        f"trainer ({N_SCENE} Gaussians from a noisy room cloud, SH 3 from step 1, {WIDTH}x{HEIGHT} "
        f"hfov {HFOV}, 6 train views, {TRAIN_ITERS} steps): create_from_pcd {init_ms:.1f} ms; "
        f"dist_knn3 card vs host on {KNN_CHECK} points: same neighbours {knn_same:.5f} (tol 0.999), "
        f"d2 max rel err where the same {knn_err:.2g} (tol 1e-5)",
        f"step ms median {statistics.median(untraced):.3f} (host clock, synchronised, "
        f"{len(untraced)} untraced steps without the densify)",
        f"densify_and_prune at {DENSIFY_AT} (threshold {opt.densify_grad_threshold:g}; near-empty "
        f"this early): {events[0][0]:.1f} ms, Gaussians {events[0][1]} -> {events[0][2]}",
        f"instances/view median {int(statistics.median(instances))} (min {min(instances)}, "
        f"max {max(instances)})",
        f"loss step 1 {first:.5f} -> step {TRAIN_ITERS} {last:.5f}; mean of the first epoch "
        f"(6 views) {epoch_first:.5f} -> last {epoch_last:.5f}",
        f"launches {launches}",
        f"traced device ms/step over steps {TRACE_STEPS.start}-{TRACE_STEPS[-1]}: "
        + fmt_stages(dev_ms) + f", idle share {idle:.3f} (under the profiler); read-backs/step "
        f"{rbs:g}, host wait {rb_ms:.3f} ms/step; {fmt_concat(concat, 'step')}",
    ]
    for line in lines:
        log("phase 5 " + line)
    return launches


def phase_train_dense(dev):
    """The trainer at trained density: the noisy ground-truth room (as phase
    4's model: 1M Gaussians, ~1.75M instances per view), DENSE_ITERS steps
    at SH degree 3 with a trace, and one densify_and_prune (at
    DENSE_DENSIFY_AT) whose gradient threshold is placed so that a share
    DENSE_SELECT of the Gaussians seen reaches it: a full-size clone/split
    event with its two dist_knn3 at 1M, then steps at the grown size."""
    gt, pcams, params = dense_room(dev)
    views = train_views(gt, pcams, dev)
    # K1, K3, K4, K5, K6 and K2 alone at one view of the room, before the
    # trainer starts (K1 as the tile rasterizer calls it, and its full table)
    bg = torch.zeros(3, device=dev)
    cam = dense_view(pcams, dev)
    k5_args, k2_args = view_inputs(params, cam, bg, SEED + 3)
    tab, binning = k5_args[:2]
    k3_args = (tab, *tiling.expand_inputs(tab, preprocess_fused.visible_radii(tab), WIDTH, HEIGHT))
    blended, culled, walks = evaluated_pairs(tab, binning, WIDTH, HEIGHT)
    acts = k2_args[:5]
    k1_b = k1_bounds(acts, int((k3_args[4] > 0).sum()))
    grad_inst = raster_tiles._run_bwd(*k5_args)
    dense = {"preprocess_fwd": dict(ms=event_ms(lambda: preprocess_fused.preprocess_fused_fwd(
                 *acts, cam, 3, 1.0, skip_unbinned=True)), bound=k1_b["needed"],
                 ms_full_table=event_ms(lambda: preprocess_fused.preprocess_fused_fwd(*acts, cam, 3, 1.0)),
                 bound_all_rows=k1_b["all_rows"]),
             "expand": dict(ms=event_ms(lambda: expand.expand_instances(*k3_args)),
                            bound=k3_bound(k3_args)),
             "blend_fwd": dict(ms=event_ms(lambda: raster_tiles._run_fwd(tab, binning, bg, WIDTH, HEIGHT)),
                               bound=k4_bound(binning, WIDTH, HEIGHT, blended, culled)),
             "blend_bwd": dict(ms=event_ms(lambda: raster_tiles._run_bwd(*k5_args)),
                               bound=k5_bound(k5_args, blended, culled)),
             "segsum": dict(ms=event_ms(lambda: segsum.segment_sum_sorted(grad_inst, binning.offsets,
                                                                          binning.count)),
                            bound=k6_bound(grad_inst, binning)),
             "preprocess_bwd": dict(ms=event_ms(lambda: preprocess_fused.preprocess_fused_bwd(*k2_args)),
                                    bound=k2_bound(k2_args))}
    view = (f"train view {synthetic.split_ids(N_CAMS, 6)[0][0]} of the room before the steps "
            f"({params.xyz.shape[0]} Gaussians, {int((k3_args[4] > 0).sum())} in a tile, "
            f"{k5_args[1].num_instances} instances, pairs walked "
            f"{blended + culled}, blended {blended}; {tile_stats(k5_args[1], walks)})")
    del k5_args, k2_args, k3_args, tab, binning, acts, grad_inst
    state = G.GaussianState.fresh(params)
    opt = OptimizationParams(iterations=DENSE_ITERS, densify_from_iter=DENSE_DENSIFY_AT // 2,
                             densification_interval=DENSE_DENSIFY_AT,
                             prune_from_iter=DENSE_DENSIFY_AT // 2, densify_until_iter=DENSE_ITERS)
    trainer = BaselineTrainer(views, state, opt, PipelineParams(), ModelParams())
    trainer.active_sh_degree = 3
    placed = {}

    def place_threshold(tr):
        s = tr.state
        seen = s.denom[:, 0] > 0
        g = (s.xyz_gradient_accum[:, 0] / torch.clamp(s.denom[:, 0], min=1e-12))[seen]
        thr = float(torch.quantile(g, 1.0 - DENSE_SELECT))
        placed.update(thr=thr, seen=int(seen.sum()),
                      at_default=int((g >= opt.densify_grad_threshold).sum()))
        tr.opt = dataclasses.replace(opt, densify_grad_threshold=thr)

    events = []
    time_densify(trainer, events, place_threshold)
    _build.reset_launches()
    step_ms, losses, instances, prof = run_steps(trainer, DENSE_ITERS, DENSE_TRACE)
    launches = check_launches(DENSE_ITERS)
    if len(events) != 1 or events[0][2] <= events[0][1]:
        raise AssertionError(f"densification events {events}: expected one that adds Gaussians")
    if not all(math.isfinite(float(v)) for v in losses):
        raise AssertionError(f"non-finite losses: {[float(v) for v in losses]}")
    before = [step_ms[it] for it in range(2, DENSE_TRACE.start)]
    after = [step_ms[it] for it in range(DENSE_DENSIFY_AT + 1, DENSE_ITERS + 1)]
    dev_ms, idle, rb_ms, rbs, concat = trace_summary(prof, len(DENSE_TRACE))
    check_no_sh_split(concat)
    lines = [
        f"trained density ({N_SCENE} Gaussians of the noisy ground-truth room, SH 3, {WIDTH}x{HEIGHT}, "
        f"6 train views, {DENSE_ITERS} steps): instances/view median "
        f"{int(statistics.median(instances[:DENSE_DENSIFY_AT]))} before the event, "
        f"{int(statistics.median(instances[DENSE_DENSIFY_AT:]))} after",
        f"step ms median {statistics.median(before):.3f} (steps 2-{DENSE_TRACE.start - 1}), "
        f"{statistics.median(after):.3f} after the event (steps {DENSE_DENSIFY_AT + 1}-{DENSE_ITERS}; "
        f"host clock, synchronised)",
        f"densify_and_prune at {DENSE_DENSIFY_AT}: threshold {placed['thr']:.4g} (the top "
        f"{DENSE_SELECT:g} of the {placed['seen']} Gaussians seen; the default "
        f"{opt.densify_grad_threshold:g} selects {placed['at_default']}): {events[0][0]:.1f} ms, "
        f"Gaussians {events[0][1]} -> {events[0][2]}",
        f"loss step 1 {float(losses[0]):.5f} -> step {DENSE_DENSIFY_AT} "
        f"{float(losses[DENSE_DENSIFY_AT - 1]):.5f} -> step {DENSE_ITERS} {float(losses[-1]):.5f} "
        f"(from a near-exact start); launches {launches}",
        f"traced device ms/step over steps {DENSE_TRACE.start}-{DENSE_TRACE[-1]}: "
        + fmt_stages(dev_ms) + f", idle share {idle:.3f} (under the profiler); read-backs/step "
        f"{rbs:g}, host wait {rb_ms:.3f} ms/step; {fmt_concat(concat, 'step')}",
        f"K1, K3, K4, K5, K6 and K2 alone at {view}, CUDA events over {EVENT_LAUNCHES} launches: "
        + " | ".join(f"{k} {dense[name]['ms']:.4f} ms, bound {dense[name]['bound'][0]:.4f} ms "
                     f"({dense[name]['bound'][1]})"
                     for k, name in (("K1", "preprocess_fwd"), ("K3", "expand"), ("K4", "blend_fwd"),
                                     ("K5", "blend_bwd"), ("K6", "segsum"), ("K2", "preprocess_bwd")))
        + f" | K1 (needed bytes: the SH of the Gaussians in a tile) all-rows bound "
        f"{dense['preprocess_fwd']['bound_all_rows'][0]:.4f} ms, its full table "
        f"{dense['preprocess_fwd']['ms_full_table']:.4f} ms",
    ]
    for line in lines:
        log("phase 5b " + line)
    return dense, launches


def guidance_intrinsic(cam) -> np.ndarray:
    """K at the train resolution from a camera's field of view, as the
    guided CLI builds it."""
    w, h = cam.image_width, cam.image_height
    fx, fy = w / (2 * math.tan(cam.FoVx / 2)), h / (2 * math.tan(cam.FoVy / 2))
    return np.array([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]])


def chains_of(frames: int) -> int:
    """The chains of a FrozenRenderer.render_many of `frames` frames."""
    return -(-frames // FrozenRenderer.GROUP)


def launches_of(steps: int = 0, pseudo_steps: int = 0, frames: int = 0, chains: int = 0) -> dict:
    """K1-K6 launches of `steps` training steps, `pseudo_steps` of them with
    a pseudo view (a step is one chain: K3-K6 once, K1 and K2 once a view),
    and of forward renders of `frames` frames in `chains` chains (K1 once a
    frame, K3 and K4 once a chain)."""
    return {"preprocess_fwd": steps + pseudo_steps + frames, "expand": steps + chains,
            "blend_fwd": steps + chains, "blend_bwd": steps, "segsum": steps,
            "preprocess_bwd": steps + pseudo_steps}


def count_renders(renderer: FrozenRenderer, counter: dict, key: str) -> None:
    """Count the renderer's frames under `key` and its chains under
    `key` + "_chains" (a render is one of each; render_many a chain of
    FrozenRenderer.GROUP frames at a time)."""
    render, render_many = renderer.render, renderer.render_many

    def add(frames):
        counter[key] = counter.get(key, 0) + frames
        counter[key + "_chains"] = counter.get(key + "_chains", 0) + chains_of(frames)

    def counted(*args, **kwargs):
        add(1)
        return render(*args, **kwargs)

    def counted_many(w2cs, *args, **kwargs):
        add(len(w2cs))
        return render_many(w2cs, *args, **kwargs)

    renderer.render, renderer.render_many = counted, counted_many


def frames_and_chains(counter: dict) -> tuple[int, int]:
    """All frames and chains count_renders counted into `counter`."""
    return (sum(v for k, v in counter.items() if not k.endswith("_chains")),
            sum(v for k, v in counter.items() if k.endswith("_chains")))


def phase_guided_trainer(dev, work: Path):
    """The guided trainer at full width on phase 5b's room: the frozen
    renderer is the noisy room (1M Gaussians), the oracle engine renders the
    ground-truth room from the npz that make_scene's writer writes, the
    point cloud is a 1M-point noisy cloud of the room. It builds the
    trajectory pool, runs one diffusion event of EVENT_FRAMES frames, then
    GUIDED_TRAINER_STEPS steps that each take a pseudo view (train view +
    pseudo view, one backward), GUIDED_TRACE of them traced by stage."""
    gt, pcams, params = dense_room(dev)
    views = train_views(gt, pcams, dev)
    npz = work / "gt_gaussians.npz"
    synthetic.write_gt_npz(str(npz), gt)
    rng = np.random.default_rng(SEED + 5)
    cols = np.clip(SH2RGB(gt["features_dc"][:, 0]), 0, 1).astype(np.float32)
    pcd_pts, pcd_cols = synthetic.init_cloud(gt["xyz"], cols, N_SCENE, rng)
    frozen = FrozenRenderer(params, 3)
    engine = OracleDiffusionEngine(str(npz), EVENT_FRAMES, HEIGHT, WIDTH, device=dev)
    state = G.GaussianState.fresh(G.GaussianParams(**{k: v.clone() for k, v in params.tensors().items()}))
    last = GUIDED_TRAINER_STEPS + 1
    # pseudo views from the first step, no event inside the steps, the
    # statistics on and no densification (phase 5b times that)
    opt = OptimizationParams(iterations=10 * last, start_sample_pseudo=0, end_sample_pseudo=10 * last,
                             guidance_vd_iter=10 * last, densify_from_iter=10 * last,
                             densify_until_iter=10 * last)
    trainer = GuidedTrainer(views, state, opt, PipelineParams(), ModelParams(), frozen, engine,
                            pcd_pts, pcd_cols, guidance_intrinsic(views.cams[0]))
    frames = {}
    count_renders(frozen, frames, "frozen")
    count_renders(engine.renderer, frames, "oracle")

    # the main path of this slice
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.init_trajectory_pool()
    torch.cuda.synchronize()
    pool_s = time.perf_counter() - t0
    pool_frames = frames["frozen"]
    pool_sizes = {v: len(e) for v, e in trainer.trajectory_pool.items()}
    trainer.run_diffusion_event(1)
    if trainer.events_run != 1 or len(trainer.pseudo_stack) != EVENT_FRAMES - 1:
        raise AssertionError(f"event: {trainer.events_run} run, stack {len(trainer.pseudo_stack)}")
    event = dict(trainer.event_phase_s)
    pseudo_l1 = []
    step_ms, losses, instances, prof = run_steps(
        trainer, last, GUIDED_TRACE, first=2,
        on_step=lambda it: pseudo_l1.append(float(trainer.last_metrics["pseudo_l1"])))
    launches = dict(_build.LAUNCHES)
    steps = GUIDED_TRAINER_STEPS
    renders, chains = frames_and_chains(frames)
    want = launches_of(steps, steps, renders, chains)
    if any(launches[n] != want[n] for n in GAUSSIAN_KERNELS) or any(
            launches[n] for n in ("flash_attn_fwd",) + L1_BWD_KERNELS):
        raise AssertionError(f"launches {launches}, expected {want}: a guided step one chain of two views (K1 "
                             f"and K2 twice, K3-K6 once), K1 once more a frozen or oracle frame ({renders}), K3 "
                             f"and K4 once more a chain of them ({chains})")
    if not all(math.isfinite(float(v)) for v in losses) or not all(p > 0.0 for p in pseudo_l1):
        raise AssertionError(f"losses {[float(v) for v in losses]}, pseudo_l1 {pseudo_l1}")
    dev_ms, idle, rb_ms, rbs, concat = trace_summary(prof, len(GUIDED_TRACE))
    check_no_sh_split(concat)
    if concat["kernels"] > GUIDED_CAT_KERNELS:
        raise AssertionError(f"{concat['kernels']:g} torch.cat kernels a guided step "
                             f"(at most {GUIDED_CAT_KERNELS}: the camera rows of K1 and K2 a view, the "
                             f"offsets' gradient, the views' gradients)")
    untraced = [ms for it, ms in step_ms.items() if it not in GUIDED_TRACE and it > 2]
    # the splat of one event's trajectory alone, traced: its device ms
    traj = trainer.trajectory_pool[0][0].traj_c2ws
    trainer.pc_render_along(traj, 0)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=PROFILER_ACTIVITIES) as sprof:
        trainer.pc_render_along(traj, 0)
        torch.cuda.synchronize()
    splat_ms = sum(trace_summary(sprof, 1)[0].values())
    event_s = sum(event.values())
    lines = [
        f"guided trainer (phase 5b's room: frozen = the noisy room, {N_SCENE} Gaussians SH 3, oracle = "
        f"the ground truth from {npz.name}, {pcd_pts.shape[0]}-point cloud, {WIDTH}x{HEIGHT}, 6 train "
        f"views): trajectory pool {pool_s:.3f} s ({pool_frames} frozen frames; entries per view "
        f"{pool_sizes})",
        f"one diffusion event of {EVENT_FRAMES} frames {event_s:.3f} s: pc_render {event['pc_render']:.3f} s, "
        f"frozen {event['frozen']:.3f} s, generate (oracle) {event['generate']:.3f} s; the splat alone "
        f"{splat_ms:.3f} device ms an event (traced), {splat_ms / 1e3 / event_s:.4f} of the event",
        f"{steps} guided steps (train view + pseudo view): step ms median "
        f"{statistics.median(untraced):.3f} (host clock, synchronised, {len(untraced)} untraced steps); "
        f"instances (larger render) median {int(statistics.median(instances))}",
        f"loss step 2 {float(losses[0]):.5f} -> step {last} {float(losses[-1]):.5f}; pseudo_l1 "
        f"{pseudo_l1[0]:.5f} -> {pseudo_l1[-1]:.5f} (all > 0); launches {launches} "
        f"(frozen frames {frames['frozen']}, oracle frames {frames['oracle']})",
        f"traced device ms/step over iterations {GUIDED_TRACE.start}-{GUIDED_TRACE[-1]}: "
        + fmt_stages(dev_ms) + f", splat 0 (events only), idle share {idle:.3f} (under the profiler); "
        f"read-backs/step {rbs:g}, host wait {rb_ms:.3f} ms/step; {fmt_concat(concat, 'step')}",
    ]
    for line in lines:
        log("phase 5c " + line)
    return launches, dict(host_ms=statistics.median(untraced), device_ms=sum(dev_ms.values()))


def vc_trainer_launches(ucfg, steps: int, renders: int, chains: int, train_steps: int) -> dict:
    """K1-K6 and L1's launches of phase 5d: a guided step one chain of two
    views, the frozen frames in their chains (launches_of); one guided
    request of `steps` guided steps (L1's forward 20 a step and 2 for the
    VAE's encode and decode, each backward kernel 15 a step)."""
    fwd, bwd = guided_launches(ucfg, steps, GEN_FRAMES, ddim_guidance.GuidedSampleConfig().decode_chunk)
    want = launches_of(train_steps, train_steps, renders, chains)
    want.update(flash_attn_fwd=fwd + 2, flash_attn_bwd_dkv=bwd, flash_attn_bwd_dq=bwd)
    return want


def artifact_frames(path: Path) -> int:
    """Frames of one event video: an mp4 (counted as its frame count is not
    read: 1) or a directory of PNG frames."""
    if path.with_suffix(".mp4").exists():
        return 1
    return len(list(path.glob("*.png")))


def phase_vc_trainer(dev, work: Path, steps: int, c5=None):
    """5d: the guided trainer with the ViewCrafter engine at full width on
    phase 5b's room (phase 5c's set-up, the engine in place of the oracle):
    random bf16 weights, 25x320x448, `steps` guided DDIM steps, the VGG19
    pseudo term on random weights; one event with its artifacts and the
    video store, a second on the same pool entry read from the store (no
    engine call), then GUIDED_TRAINER_STEPS steps, GUIDED_TRACE of them
    traced. `c5`: phase 5c's step readings, printed beside. Returns the
    launches and readings."""
    gt, pcams, params = dense_room(dev)
    views = train_views(gt, pcams, dev)
    rng = np.random.default_rng(SEED + 5)
    cols = np.clip(SH2RGB(gt["features_dc"][:, 0]), 0, 1).astype(np.float32)
    pcd_pts, pcd_cols = synthetic.init_cloud(gt["xyz"], cols, N_SCENE, rng)
    frozen = FrozenRenderer(params, 3)
    last = GUIDED_TRAINER_STEPS + 1
    opt = OptimizationParams(iterations=10 * last, start_sample_pseudo=0, end_sample_pseudo=10 * last,
                             guidance_vd_iter=10 * last, densify_from_iter=10 * last,
                             densify_until_iter=10 * last, guidance_ddim_steps=steps)
    width = port_guided_cli.engine_width(opt, HEIGHT, WIDTH)
    gparams, _ = gen_params(dev)
    mcfg = LatentDiffusionConfig(compute_dtype="bfloat16")
    engine = ViewCrafterEngine(gparams, mcfg, synthesis.SynthesisConfig(ddim_steps=steps),
                               video_length=EVENT_FRAMES, height=GEN_H, width=width)
    vgg_fn = make_vgg_loss_fn(random_init=True)
    if vgg_fn is None or width != GEN_W:
        raise AssertionError(f"VGG term {vgg_fn}, engine width {width} (expected {GEN_W})")
    state = G.GaussianState.fresh(G.GaussianParams(**{k: v.clone() for k, v in params.tensors().items()}))
    mdl = work / "vc_trainer"
    trainer = GuidedTrainer(views, state, opt, PipelineParams(), ModelParams(model_path=str(mdl)), frozen, engine,
                            pcd_pts, pcd_cols, guidance_intrinsic(views.cams[0]), vgg_loss_fn=vgg_fn)
    frames = {}
    count_renders(frozen, frames, "frozen")
    calls = []
    generate = engine.generate
    engine.generate = lambda *a, **k: calls.append(1) or generate(*a, **k)

    # the main path of this slice
    _build.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.init_trajectory_pool()
    torch.cuda.synchronize()
    pool_s = time.perf_counter() - t0
    step_ms = []
    with timed(ddim_guidance, "guided_step", step_ms):
        trainer.run_diffusion_event(1)
    event1 = dict(trainer.event_phase_s)
    l1_event = {n: _build.LAUNCHES[n] for n in ("flash_attn_fwd",) + L1_BWD_KERNELS}
    video = torch.stack([c.pseudo_gt for c in trainer.pseudo_stack])
    if trainer.events_run != 1 or len(trainer.pseudo_stack) != EVENT_FRAMES - 1 or len(calls) != 1 \
            or video.dtype != torch.float32 or not bool(torch.isfinite(video).all()) \
            or float(video.min()) < 0.0 or float(video.max()) > 1.0:
        raise AssertionError(f"event 1: {trainer.events_run} run, stack {len(trainer.pseudo_stack)}, engine calls "
                             f"{len(calls)}, frames {video.dtype} in [{float(video.min())}, {float(video.max())}]")
    # the second event on the same pool entry, read from the store
    sidx, view, cidx = trainer._cur_video_key
    store = trainer._video_file_path()
    entry = next(e for e in trainer.trajectory_pool[view] if e.cand_idx == cidx and e.scale_idx == sidx)
    trainer.trajectory_pool_shuffle[view], trainer.vd_indices = [entry], [view]
    trainer.opt.guidance_videos_from_file = True
    trainer.run_diffusion_event(2)
    reused = torch.stack([c.pseudo_gt for c in trainer.pseudo_stack])
    event2 = {k: v - event1[k] for k, v in trainer.event_phase_s.items()}
    if trainer.events_run != 2 or len(calls) != 1 or not torch.equal(reused, video):
        raise AssertionError(f"event 2 from {store}: {trainer.events_run} run, engine calls {len(calls)}, "
                             f"frames equal {torch.equal(reused, video)}")
    pseudo_l1, pseudo_vgg = [], []

    def on_step(it):
        pseudo_l1.append(float(trainer.last_metrics["pseudo_l1"]))
        pseudo_vgg.append(float(trainer.last_metrics["pseudo_vgg"]))

    step_host, losses, instances, prof = run_steps(trainer, last, GUIDED_TRACE, first=2, on_step=on_step)
    trainer.artifact_writer.drain()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(_build.LAUNCHES)
    want = vc_trainer_launches(mcfg.unet, steps, frames["frozen"], frames["frozen_chains"], GUIDED_TRAINER_STEPS)
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}: a chain of two views a guided step, K1, K3, K4 "
                             f"more a frozen frame ({frames['frozen']}), L1 in event 1 only")
    if not all(math.isfinite(float(v)) for v in losses) or not all(p > 0.0 for p in pseudo_l1) \
            or not all(v > 0.0 for v in pseudo_vgg):
        raise AssertionError(f"losses {[float(v) for v in losses]}, pseudo_l1 {pseudo_l1}, "
                             f"pseudo_vgg {pseudo_vgg}")
    if peak_gb >= 80.0:
        raise AssertionError(f"peak {peak_gb:.2f} GB")
    event_dir = mdl / "diffusion_events" / "train_iter1"
    arts = {name: artifact_frames(event_dir / name)
            for name in ("render0", "gs_render", "gs_render_alpha", "gs_render_depth", "diffusion0")}
    stored = sorted(mdl.glob("video_files_scale*/*/*.npz"))
    if any(n not in (1, EVENT_FRAMES) for n in arts.values()) or [str(p) for p in stored] != [store]:
        raise AssertionError(f"artifacts {arts} (frames of each), store {stored}")
    dev_ms, idle, rb_ms, rbs, concat = trace_summary(prof, len(GUIDED_TRACE))
    check_no_sh_split(concat)
    untraced = [ms for it, ms in step_host.items() if it not in GUIDED_TRACE and it > 2]
    # the VGG term alone on the pseudo view's shapes: forward and backward
    rp = torch.rand((3, HEIGHT, WIDTH), device=dev, requires_grad=True)
    pgt = torch.rand((3, HEIGHT, WIDTH), device=dev)
    vgg_ms = event_ms(lambda: vgg_fn(rp[None], pgt[None]).backward(), launches=5)
    host_ms, device_ms = statistics.median(untraced), sum(dev_ms.values())
    step_med = statistics.median(step_ms)
    # a projection, not a run: a 10k-iteration run of 37 events at 50 guided
    # steps, from this event's parts and this phase's step time
    gen_rest = event1["generate"] - sum(step_ms) / 1e3
    event_50 = event1["pc_render"] + event1["frozen"] + event1["artifacts"] + gen_rest + 50 * step_med / 1e3
    c5_txt = "phase 5c not run in this call"
    if c5:
        c5_txt = (f"phase 5c (the same room, the oracle, no VGG term) in this call: host ms {c5['host_ms']:.3f}, "
                  f"traced device ms {c5['device_ms']:.3f}")
    lines = [
        f"ViewCrafter-guided trainer (phase 5b's room: frozen = the noisy room, {N_SCENE} Gaussians SH 3; "
        f"engine {EVENT_FRAMES}x{GEN_H}x{width} bf16, random weights, {steps} guided DDIM steps of the default "
        f"50; VGG19 pseudo term on random_vgg19 weights; {WIDTH}x{HEIGHT}, 6 train views): pool {pool_s:.3f} s",
        "event 1 s: " + ", ".join(f"{k} {v:.3f}" for k, v in event1.items())
        + f" (total {sum(event1.values()):.3f}); guided DDIM step in the trainer ms median {step_med:.1f} "
        f"(first {step_ms[0]:.1f}, min {min(step_ms):.1f}); the rest of generate {gen_rest:.3f} s "
        f"(conditioning, decode, resize and copy)",
        "event 2 (the same pool entry from the store, no engine call) s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in event2.items()) + f"; store {Path(store).name} "
        f"{Path(store).stat().st_size / 1e6:.1f} MB; artifacts (frames, 1 = an mp4) {arts}",
        f"peak allocated over the phase (engine weights, trainer state, stacks): {peak_gb:.2f} GB of 80",
        f"{GUIDED_TRAINER_STEPS} guided steps (train view + pseudo view + VGG term): host ms median "
        f"{host_ms:.3f} ({len(untraced)} untraced steps); traced device ms/step {fmt_stages(dev_ms)}, idle share "
        f"{idle:.3f} (under the profiler), read-backs/step {rbs:g}; the VGG term alone (forward + backward at "
        f"{WIDTH}x{HEIGHT} -> 224, CUDA events) {vgg_ms:.3f} ms = {vgg_ms / device_ms:.3f} of the traced step; "
        + c5_txt,
        f"loss step 2 {float(losses[0]):.5f} -> step {last} {float(losses[-1]):.5f}; pseudo_l1 {pseudo_l1[0]:.5f} "
        f"-> {pseudo_l1[-1]:.5f}, pseudo_vgg {pseudo_vgg[0]:.5f} -> {pseudo_vgg[-1]:.5f} (all > 0); "
        f"launches {launches} (expected exactly; frozen frames {frames['frozen']}; L1 in event 1 {l1_event})",
        f"projection (not a run): a 50-step event {event_50:.1f} s; a 10k-iteration run of 37 events "
        f"{(37 * event_50 + 10_000 * host_ms / 1e3) / 60:.1f} min on one card",
    ]
    for line in lines:
        log("phase 5d " + line)
    return launches, dict(step_ms=step_med)


def vc_checkpoint(params, path: Path) -> None:
    """The parameters as a ViewCrafter checkpoint: the sub-models under the
    checkpoint's prefixes (the CLIP towers' open_clip prefixes included),
    the UNet's fps embedding under its checkpoint name framestride_embed,
    Lightning's state_dict nesting; bf16 as given."""
    prefixes = {"unet": "model.diffusion_model.", "vae": "first_stage_model.",
                "clip_text": "cond_stage_model.model.", "clip_image": "embedder.model.visual.",
                "resampler": "image_proj_model."}
    sd = {}
    for part, prefix in prefixes.items():
        for k, v in getattr(params, part).items():
            sd[prefix + k.replace("fps_embedding", "framestride_embed")] = v.cpu()
    torch.save({"state_dict": sd}, path)


def phase_vc_cli(dev, work: Path, src: Path, base: Path, extra: tuple = (), tag: str = "6c"):
    """6c: the guided CLI with --viewcrafter_ckpt on phase 6's scene and
    baseline: the random parameters written as a ViewCrafter checkpoint, a
    random VGG19 as a torchvision state dict, VC_CLI_ITERS iterations with
    two events of VC_CLI_STEPS guided steps; then the render and metrics
    CLIs. The checkpoint is deleted at the end. `extra`: more CLI flags
    (10d: --pipeline_guidance), logged under `tag`."""
    t_phase = time.perf_counter()
    gparams, _ = gen_params(dev)
    ckpt, vgg_path, mdl = work / "viewcrafter.ckpt", work / "vgg19.pth", work / f"synthetic_vc_{tag}"
    try:
        t0 = time.perf_counter()
        vc_checkpoint(gparams, ckpt)
        write_s = time.perf_counter() - t0
        ckpt_gb = ckpt.stat().st_size / 1e9
        torch.save(random_vgg19(SEED), vgg_path)
        load_ms = []
        _build.reset_launches()
        with timed(port_guided_cli, "load_viewcrafter_checkpoint", load_ms):
            t0 = time.perf_counter()
            trainer = port_guided_cli.main([
                "-s", str(src), "-m", str(mdl), "--dataset", "colmap", "--n_views", "6", "--eval",
                "--iterations", str(VC_CLI_ITERS), "--test_iterations", str(VC_CLI_ITERS),
                "--save_iterations", str(VC_CLI_ITERS), "--baseline_path", str(base),
                "--baseline_iteration", str(CLI_ITERS), "--viewcrafter_ckpt", str(ckpt), "--pseudo_cam_lpips",
                "--vgg19_weights", str(vgg_path), "--guidance_save_videos",
                "--guidance_ddim_steps", str(VC_CLI_STEPS), "--guidance_vd_iter", str(VC_CLI_EVERY),
                "--start_sample_pseudo", "2", "--end_sample_pseudo", str(VC_CLI_ITERS - 2), "--device", dev.type,
                *extra,
            ])
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
    finally:
        ckpt.unlink(missing_ok=True)
    launches = dict(_build.LAUNCHES)
    engine = trainer.engine
    want_w = port_guided_cli.engine_width(trainer.opt, trainer.H, trainer.W)
    stored = sorted(mdl.glob("video_files_scale*/*/*.npz"))
    fwd, bwd = guided_launches(engine.mcfg.unet, VC_CLI_STEPS, GEN_FRAMES, engine.guided_cfg.decode_chunk)
    l1_want = {"flash_attn_fwd": 2 * (fwd + 2), "flash_attn_bwd_dkv": 2 * bwd, "flash_attn_bwd_dq": 2 * bwd}
    if not isinstance(engine, ViewCrafterEngine) or (engine.height, engine.width) != (GEN_H, want_w) \
            or trainer.events_run != 2 or len(trainer.pseudo_stack) != EVENT_FRAMES - 1 or len(stored) != 2 \
            or trainer.vgg_loss_fn is None or any(launches[n] != v for n, v in l1_want.items()):
        raise AssertionError(f"engine {type(engine).__name__} {engine.height}x{engine.width} (rule: {want_w}), "
                             f"events {trainer.events_run}, stack {len(trainer.pseudo_stack)}, store {stored}, "
                             f"VGG {trainer.vgg_loss_fn}, launches {launches} (L1 expected {l1_want})")
    port_render.main(["-m", str(mdl), "--skip_train", "--iteration", str(VC_CLI_ITERS), "--device", dev.type])
    port_metrics.evaluate([str(mdl)], device=dev.type)
    res = json.loads((mdl / "results.json").read_text())[f"ours_{VC_CLI_ITERS}"]
    if not (math.isfinite(res["PSNR"]) and math.isfinite(res["SSIM"])):
        raise AssertionError(f"scores {res}")
    timing = json.loads((mdl / "timing_summary.json").read_text())
    if timing.get("pipeline_guidance") != ("--pipeline_guidance" in extra):
        raise AssertionError(f"timing_summary pipeline_guidance {timing.get('pipeline_guidance')}, flags {extra}")
    log(f"phase {tag} ViewCrafter CLI {' '.join(extra)} (phase 6's scene {trainer.W}x{trainer.H} and its "
        f"{CLI_ITERS}-iteration baseline; "
        f"the random bf16 weights as a ViewCrafter checkpoint of {ckpt_gb:.2f} GB, written in {write_s:.1f} s; "
        f"a random VGG19 in the torchvision layout): checkpoint load {load_ms[0] / 1e3:.1f} s | train_guidedvd "
        f"{VC_CLI_ITERS} iterations {train_s:.1f} s (events {timing['event_s']:.3f} s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in timing["event_phase_s"].items())
        + f") | engine {engine.video_length}x{engine.height}x{engine.width} on {engine.device}, "
        f"{VC_CLI_STEPS} guided steps | events {trainer.events_run}, pseudo stack {len(trainer.pseudo_stack)}, "
        f"store {len(stored)} npz | test PSNR {res['PSNR']:.4f} SSIM {res['SSIM']:.5f} (random weights: a "
        f"reading) | finalize waited {timing['event_wait_s']:.3f} s | launches {launches} | phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_cli(dev, work: Path):
    """The trainer CLI on the tool-default synthetic scene, then the render
    and metrics CLIs on what it saved and on its iteration-0 model."""
    src, mdl = work / "synthetic", work / "synthetic_model"
    t0 = time.perf_counter()
    synthetic.make_scene(str(src), device=dev)
    scene_s = time.perf_counter() - t0
    _build.reset_launches()
    t0 = time.perf_counter()
    port_train_cli.main([
        "-s", str(src), "-m", str(mdl), "--dataset", "colmap", "--n_views", "6", "--eval",
        "--iterations", str(CLI_ITERS), "--test_iterations", str(CLI_ITERS),
        "--save_iterations", str(CLI_ITERS), "--device", dev.type,
    ])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    for name in GAUSSIAN_KERNELS:
        n = launches[name]
        if n < CLI_ITERS:
            raise AssertionError(f"kernel {name} ran {n} times in {CLI_ITERS} training steps")
    # iteration 0's model: the trainer's initial state, as a snapshot
    args = get_combined_args(build_parser(fill_none=True).parse_args(["-m", str(mdl)]))
    scene = Scene(ModelParams.extract(args))
    scene.save(0, scene.create_gaussians(device=dev))
    for it in (0, CLI_ITERS):
        port_render.main(["-m", str(mdl), "--skip_train", "--iteration", str(it), "--device", dev.type])
    port_metrics.evaluate([str(mdl)], device=dev.type)
    res = json.loads((mdl / "results.json").read_text())
    p0, p1 = res["ours_0"]["PSNR"], res[f"ours_{CLI_ITERS}"]["PSNR"]
    s0, s1 = res["ours_0"]["SSIM"], res[f"ours_{CLI_ITERS}"]["SSIM"]
    if not (math.isfinite(p1) and math.isfinite(s1) and p1 >= p0 + 2.0):
        raise AssertionError(f"test PSNR {p0} at iteration 0 -> {p1} at {CLI_ITERS} (needs +2 dB)")
    n_final = load_gaussian_ply(str(mdl / "point_cloud" / f"iteration_{CLI_ITERS}" / "point_cloud.ply"))
    log(f"phase 6 CLI (tool-default scene 624x352, 150000 GT Gaussians, 30000-point init, 6 train / "
        f"{len(json.loads((src / 'train_test_split_6.json').read_text())['test_ids'])} test views): "
        f"scene {scene_s:.1f} s | train_baseline {CLI_ITERS} iterations {train_s:.1f} s "
        f"({train_s / CLI_ITERS * 1e3:.2f} ms/iteration with the test evaluation and the save) | "
        f"Gaussians at {CLI_ITERS}: {n_final['xyz'].shape[0]} | test PSNR {p0:.4f} -> {p1:.4f} dB, "
        f"SSIM {s0:.5f} -> {s1:.5f} (iteration 0 -> {CLI_ITERS}) | launches {launches}")
    return src, mdl, (p1, s1), launches


def phase_guided_cli(dev, work: Path, src: Path, base: Path, base_scores):
    """The guided CLI with the oracle on phase 6's scene, its 2000-iteration
    baseline as the frozen renderer, pseudo views between CLI_PSEUDO, an
    event every 260 iterations (the default); then the render and metrics
    CLIs. Its test PSNR must not be lower than the baseline's."""
    mdl = work / "synthetic_guided"
    _build.reset_launches()
    t0 = time.perf_counter()
    trainer = port_guided_cli.main([
        "-s", str(src), "-m", str(mdl), "--dataset", "colmap", "--n_views", "6", "--eval",
        "--iterations", str(CLI_ITERS), "--test_iterations", str(CLI_ITERS),
        "--save_iterations", str(CLI_ITERS), "--baseline_path", str(base),
        "--baseline_iteration", str(CLI_ITERS), "--oracle_gt_npz", str(src / "gt_gaussians.npz"),
        "--start_sample_pseudo", str(CLI_PSEUDO[0]), "--end_sample_pseudo", str(CLI_PSEUDO[1]),
        "--device", dev.type,
    ])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    timing = json.loads((mdl / "timing_summary.json").read_text())
    events = trainer.events_run
    if events < CLI_MIN_EVENTS or len(trainer.pseudo_stack) != EVENT_FRAMES - 1:
        raise AssertionError(f"{events} events, a pseudo stack of {len(trainer.pseudo_stack)}")
    # every step renders the train view; the steps strictly inside
    # CLI_PSEUDO (the first event comes after step 1) a pseudo view too, in
    # the same chain
    pseudo_steps = CLI_PSEUDO[1] - CLI_PSEUDO[0] - 1
    # K1, K3, K4 also render: the centre depth of each train view (one view
    # a chain) and its 3 scales x 20 pool candidates, the frozen and the
    # oracle frames of each event (chains of FrozenRenderer.GROUP frames),
    # the test and train views of the evaluation at CLI_ITERS (one a chain)
    n_train, n_test = len(trainer.train_cams), len(trainer.scene.getTestCameras())
    want = launches_of(CLI_ITERS, pseudo_steps,
                       n_train * (1 + 3 * 20) + 2 * EVENT_FRAMES * events + n_test + n_train,
                       n_train * (1 + 3 * chains_of(20)) + 2 * chains_of(EVENT_FRAMES) * events + n_test + n_train)
    if any(launches[n] != want[n] for n in GAUSSIAN_KERNELS):
        raise AssertionError(f"guided CLI launches {launches}, expected {want}")
    port_render.main(["-m", str(mdl), "--skip_train", "--iteration", str(CLI_ITERS), "--device", dev.type])
    port_metrics.evaluate([str(mdl)], device=dev.type)
    res = json.loads((mdl / "results.json").read_text())[f"ours_{CLI_ITERS}"]
    p, s = res["PSNR"], res["SSIM"]
    if not (math.isfinite(p) and math.isfinite(s) and p >= base_scores[0]):
        raise AssertionError(f"guided test PSNR {p} below the baseline's {base_scores[0]} at {CLI_ITERS}")
    log(f"phase 6b guided CLI (oracle engine, phase 6's scene and its {CLI_ITERS}-iteration baseline as "
        f"the frozen renderer, pseudo views in {CLI_PSEUDO}, an event every 260): train_guidedvd "
        f"{CLI_ITERS} iterations {train_s:.1f} s (events {timing['event_s']:.3f} s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in timing["event_phase_s"].items())
        + f"; training {timing['train_s']:.3f} s) | events {events}, pseudo stack "
        f"{len(trainer.pseudo_stack)}, all-time stack {len(trainer.pseudo_stack_alltime)} | test PSNR "
        f"{p:.4f} dB SSIM {s:.5f} against the baseline's {base_scores[0]:.4f} / {base_scores[1]:.5f} at "
        f"{CLI_ITERS} (margin {p - base_scores[0]:+.4f} dB) | launches {launches}")
    return launches


def chain_room(dev):
    """Phase 4's room (the same draws): its ground truth, the noisy model,
    and a 1M-point noisy cloud of it (the DUSt3R cloud's stand-in)."""
    rng = np.random.default_rng(SEED + 1)
    gt = synthetic.room_gaussians(N_SCENE, rng)
    synthetic.orbit(N_CAMS, WIDTH, HEIGHT, HFOV, rng)
    model = noisy_model(gt, rng)
    cols = np.clip(SH2RGB(gt["features_dc"][:, 0]), 0, 1).astype(np.float32)
    pts, pcols = synthetic.init_cloud(gt["xyz"], cols, N_SCENE, rng)
    return gt, model, pts, (pcols * 255).astype(np.uint8)


def orbit_images(gt_params, n: int, dev):
    """(c2ws, cameras, images) of an n-view orbit of the room at full width."""
    c2ws, cams = synthetic.orbit(n, WIDTH, HEIGHT, HFOV, None)
    bg = torch.zeros(3, device=dev)
    images = [eval_render(gt_params, c.raster_camera(dev), bg, 3).color.clamp(0, 1).cpu().numpy() for c in cams]
    return c2ws, cams, images


def add_launches(total: dict) -> dict:
    """Add the launches since the last reset to `total`; returns them."""
    now = dict(_build.LAUNCHES)
    for k, v in now.items():
        total[k] = total.get(k, 0) + v
    return now


def check_chain_launches(what: str, got: dict, forward: int = 0, backward: int = 0, want: dict = None) -> None:
    """K1-K6 launched `want` times, or, without it, K1, K3, K4 `forward` and
    K2, K5, K6 `backward` times (single-view renders and steps); no L1."""
    if want is None:
        want = {n: forward if n in FORWARD_KERNELS else backward for n in GAUSSIAN_KERNELS}
    if any(got[n] != want[n] for n in GAUSSIAN_KERNELS) or any(
            got[n] for n in ("flash_attn_fwd",) + L1_BWD_KERNELS):
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def chain_scannetpp(dev, work: Path, gt_params, pts, cols_u8, total: dict) -> list:
    """The ScanNet++ script's chain on the room written as each of its four
    scenes: train_baseline --dataset scannetpp, render, metrics; then
    get_avg_results --dataset scannetpp."""
    c2ws, cams, images = orbit_images(gt_params, CHAIN_FRAMES, dev)
    images_dir = "dslr/undistorted_images"
    root = work / "output"
    lines, steps_ms = [], []
    for scene_id, train in dataset_readers.SCANNETPP_TRAIN_ID.items():
        fill = np.linspace(max(train[0] - 12, 0), train[-1] + 12, CHAIN_FRAMES - len(train)).round()
        numbers = sorted(set(train) | {int(k) for k in fill})
        src, mdl = work / "scannetpp" / scene_id, root / "chain" / scene_id
        synthetic.write_source(str(src), c2ws, cams, images, None, None, pts, cols_u8, images_dir=images_dir,
                               names=[f"DSC{k:05d}.png" for k in numbers])
        _build.reset_launches()
        t0 = time.perf_counter()
        port_train_cli.main(["-s", str(src), "-m", str(mdl), "--dataset", "scannetpp", "--images", images_dir,
                             "--eval", "--n_views", "6", "--densify_grad_threshold", "1e10",
                             "--iterations", str(CHAIN_ITERS), "--test_iterations", str(CHAIN_ITERS),
                             "--save_iterations", str(CHAIN_ITERS)])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        port_render.main(["-s", str(src), "-m", str(mdl), "--iteration", str(CHAIN_ITERS)])
        port_metrics.evaluate([str(mdl)])
        launches = add_launches(total)
        n_test = len(os.listdir(mdl / "test" / f"ours_{CHAIN_ITERS}" / "renders"))
        n_train = len(os.listdir(mdl / "train" / f"ours_{CHAIN_ITERS}" / "renders"))
        if n_train != 6 or n_test < 1:
            raise AssertionError(f"{scene_id}: split {n_train} train / {n_test} test")
        # each step renders and takes the gradient once; the evaluation at the
        # last iteration renders the test and train views, and so does render
        check_chain_launches(f"ScanNet++ {scene_id}", launches, CHAIN_ITERS + 2 * (n_test + n_train),
                             CHAIN_ITERS)
        res = json.loads((mdl / "results.json").read_text())[f"ours_{CHAIN_ITERS}"]
        if not (math.isfinite(res["PSNR"]) and math.isfinite(res["SSIM"])):
            raise AssertionError(f"{scene_id}: {res}")
        lines.append(f"{scene_id} {len(numbers)} frames (train {train}) split 6 / {n_test}, test PSNR "
                     f"{res['PSNR']:.4f} SSIM {res['SSIM']:.5f}, train_baseline {train_s:.1f} s")
    avg = port_avg.main(["-m", "chain", "--dataset", "scannetpp", "--iteration", str(CHAIN_ITERS),
                         "--root", str(root)])
    if len(avg["psnr"]) != 4 or not math.isfinite(avg["psnr_all"]):
        raise AssertionError(f"get_avg_results: {avg}")
    return lines + [f"get_avg_results --dataset scannetpp: PSNR {avg['psnr_all']:.4f} SSIM "
                    f"{avg['ssim_all']:.5f} over {len(avg['psnr'])} scenes"]


def chain_project_cam(dev, work: Path, gt_params, pts, cols_u8, total: dict) -> list:
    """The project-cam script's trainer: the room as a Replica scene, its
    cloud projected to every 6th view by project_pcd_to_views, then
    train_project_cam with the published project_cam_prob and weight."""
    src, mdl = work / "replica" / REPLICA_SCENE, work / "output" / "project_cam"
    t0 = time.perf_counter()
    c2ws, cams, images = orbit_images(gt_params, REPLICA_FRAMES, dev)
    synthetic.write_source(str(src), c2ws, cams, images, None, None, pts, cols_u8, images_dir="rgb",
                           names=[f"rgb_{i}.png" for i in range(REPLICA_FRAMES)])
    del images
    scene_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    project_pcd_to_views.main(["--source", str(src), "--ply", str(src / "sparse" / "0" / "points3D.ply"),
                               "--images", "rgb"])
    project_s = time.perf_counter() - t0

    record = []
    step = ProjectCamTrainer.step

    def timed_step(self, it):
        torch.cuda.synchronize()
        t = time.perf_counter()
        st = step(self, it)
        torch.cuda.synchronize()
        record.append((self.use_project_cam, float(st.loss), (time.perf_counter() - t) * 1e3))
        return st

    _build.reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(ProjectCamTrainer, "step", timed_step):
        trainer = port_project_cli.main([
            "-s", str(src), "-m", str(mdl), "--dataset", "replica", "--images", "rgb", "--eval",
            "--n_views", "6", "--projected_dir", str(src / "projected_dir"), "--sample_pseudo_interval", "1",
            "--densify_grad_threshold", "1e10", "--project_cam_prob", str(PROJECT_CAM_PROB),
            "--project_cam_weight", "0.05", "--iterations", str(CHAIN_ITERS),
            "--test_iterations", str(CHAIN_ITERS), "--save_iterations", str(CHAIN_ITERS)])
    train_s = time.perf_counter() - t0
    launches = add_launches(total)
    n_test, n_proj = len(trainer.scene.getTestCameras()), len(trainer.scene.getProjectCameras())
    check_chain_launches("project-cam trainer", launches, CHAIN_ITERS + n_test + 6, CHAIN_ITERS)
    with_proj = [c for c in trainer.scene.getProjectCameras() if c.projected_mask is not None]
    if n_proj != len(range(0, REPLICA_FRAMES, 6)) or len(with_proj) != n_proj:
        raise AssertionError(f"{n_proj} projection cameras, {len(with_proj)} with a projection and mask")
    if not (trainer.epochs["train"] and trainer.epochs["project"]):
        raise AssertionError(f"epochs {trainer.epochs}: both kinds are needed")
    # epochs: runs of steps of one kind; the loss of each kind's first and last epoch
    epochs = []
    for p_, loss, _ in record:
        if not epochs or epochs[-1][0] != p_:
            epochs.append((p_, []))
        epochs[-1][1].append(loss)
    kinds = {k: [loss for p_, loss, _ in record if p_ == k] for k in (False, True)}
    falling = {k: (statistics.mean(next(v for p_, v in epochs if p_ == k)),
                   statistics.mean([v for p_, v in epochs if p_ == k][-1])) for k in (False, True)}
    if not all(math.isfinite(x) for _, x, _ in record) or not all(b < a for a, b in falling.values()):
        raise AssertionError(f"mean losses (first epoch, last epoch) by kind: {falling}")
    coverage = statistics.mean(float(c.projected_mask.mean()) for c in with_proj)
    return [f"Replica {REPLICA_SCENE} ({REPLICA_FRAMES} frames, scene written in {scene_s:.1f} s): "
            f"project_pcd_to_views {n_proj} views of the {pts.shape[0]}-point cloud in {project_s:.1f} s "
            f"(mean coverage {coverage:.3f} of the pixels)",
            f"train_project_cam {CHAIN_ITERS} iterations {train_s:.1f} s: epochs {trainer.epochs} "
            f"(train steps {len(kinds[False])}, projection steps {len(kinds[True])}, in epochs of "
            f"{[len(v) for _, v in epochs]}); mean loss of the first -> the last epoch: train {falling[False][0]:.5f} -> {falling[False][1]:.5f}, "
            f"projection {falling[True][0]:.6f} -> {falling[True][1]:.6f}; step ms median "
            f"{statistics.median(ms for _, _, ms in record[1:]):.3f} (host clock, synchronised); "
            f"launches {launches} ({n_test} test views)"]


def chain_resume(dev, work: Path, total: dict) -> list:
    """Phase 5c's trainer (the 1M room frozen, the oracle, a 1M-point
    cloud) run A to RESUME_STEPS with a guided checkpoint at RESUME_AT,
    run B a fresh trainer loaded from it: B's state must be A's bitwise."""
    gt, pcams, params = dense_room(dev)
    views = train_views(gt, pcams, dev)
    npz = work / "resume_gt.npz"
    synthetic.write_gt_npz(str(npz), gt)
    cols = np.clip(SH2RGB(gt["features_dc"][:, 0]), 0, 1).astype(np.float32)
    pcd_pts, pcd_cols = synthetic.init_cloud(gt["xyz"], cols, N_SCENE, np.random.default_rng(SEED + 5))
    frozen = FrozenRenderer(params, 3)
    engine = OracleDiffusionEngine(str(npz), EVENT_FRAMES, HEIGHT, WIDTH, device=dev)
    frames = {}
    count_renders(frozen, frames, "frozen")
    count_renders(engine.renderer, frames, "oracle")
    opt = OptimizationParams(iterations=RESUME_STEPS, start_sample_pseudo=0, end_sample_pseudo=10 * RESUME_STEPS,
                             guidance_vd_iter=RESUME_EVERY, densify_from_iter=10 * RESUME_STEPS,
                             densify_until_iter=10 * RESUME_STEPS)

    def trainer():
        state = G.GaussianState.fresh(G.GaussianParams(**{k: v.clone() for k, v in params.tensors().items()}))
        return GuidedTrainer(views, state, opt, PipelineParams(), ModelParams(), frozen, engine, pcd_pts,
                             pcd_cols, guidance_intrinsic(views.cams[0]))

    ck = str(work / f"chkpnt{RESUME_AT}.ckpt")
    a = trainer()
    write = a.write_checkpoint
    write_s = []

    def timed_write(path, it):
        torch.cuda.synchronize()
        t = time.perf_counter()
        write(path, it)
        write_s.append(time.perf_counter() - t)

    a.write_checkpoint = timed_write
    _build.reset_launches()
    a.init_trajectory_pool()
    a.train(iterations=RESUME_STEPS, log_every=0, checkpoint_iterations={RESUME_AT}, checkpoint_dir=str(work))
    torch.cuda.synchronize()
    launches_a, frames_a = add_launches(total), dict(frames)
    # step 1 renders the train view only (its event comes after it), every later step a pseudo view too
    check_chain_launches("run A", launches_a,
                         want=launches_of(RESUME_STEPS, RESUME_STEPS - 1, *frames_and_chains(frames_a)))

    b = trainer()
    frames.clear()
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    it = load_guided_checkpoint(ck, b)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    events_at = b.events_run
    b.train(iterations=RESUME_STEPS, log_every=0, start_iteration=it)
    torch.cuda.synchronize()
    launches_b = add_launches(total)
    check_chain_launches("run B", launches_b,
                         want=launches_of(RESUME_STEPS - it, RESUME_STEPS - it, *frames_and_chains(frames)))
    if not (0 < events_at < a.events_run == b.events_run):
        raise AssertionError(f"events: {events_at} at the checkpoint, A {a.events_run}, B {b.events_run}")
    differ = [n for n in G.PARAM_NAMES if not torch.equal(getattr(a.state.params, n), getattr(b.state.params, n))]
    differ += [f"adam_{k}/{n}" for k in ("m", "v") for n in G.PARAM_NAMES
               if not torch.equal(getattr(a.state, f"adam_{k}")[n], getattr(b.state, f"adam_{k}")[n])]
    differ += [n for n in ("xyz_gradient_accum", "denom", "max_radii2d")
               if not torch.equal(getattr(a.state, n), getattr(b.state, n))]
    stacks = [(len(x.pseudo_stack), len(x.pseudo_stack_alltime)) for x in (a, b)]
    same_poses = all(np.array_equal(p.world_view_transform, q.world_view_transform)
                     for p, q in zip(a.pseudo_stack + a.pseudo_stack_alltime, b.pseudo_stack + b.pseudo_stack_alltime))
    if differ or stacks[0] != stacks[1] or not same_poses:
        raise AssertionError(f"resumed run differs from the uninterrupted one: {differ}, stacks {stacks}, "
                             f"poses equal {same_poses}")
    mb = os.path.getsize(ck + ".guided.npz") / 2**20
    return [f"exact resume (phase 5c's trainer: {N_SCENE} Gaussians, the oracle, {pcd_pts.shape[0]}-point cloud, "
            f"events every {RESUME_EVERY} from 1): run A {RESUME_STEPS} steps ({a.events_run} events, "
            f"{events_at} before the checkpoint at {RESUME_AT}), run B loaded at {it} and run to "
            f"{RESUME_STEPS}: parameters, Adam moments and statistics bitwise equal; pseudo stacks "
            f"{stacks[0]} (current, all-time) with equal poses | checkpoint written in {write_s[0]:.3f} s "
            f"({os.path.getsize(ck) / 2**20:.1f} MB state + {mb:.1f} MB .guided.npz), loaded in {load_s:.3f} s "
            f"| launches A {launches_a}, B {launches_b}"]


def chain_video_lpips(dev, work: Path, gt, model, total: dict) -> list:
    """Phase 4's model in the colmap layout: render --video (240 frames),
    then its test views rendered and scored by metrics with random LPIPS
    weights (alexnet, vgg16 and the lin layers from a seed, in the
    torchvision / LPIPS v0.1 file layout)."""
    rng = np.random.default_rng(SEED + 7)
    gt_params = params_from_numpy(gt, dev)
    c2ws, cams, images = orbit_images(gt_params, N_CAMS, dev)
    del gt_params
    train_ids, test_ids = synthetic.split_ids(N_CAMS, 6)
    src, mdl = work / "chain_scene", work / "chain_model"
    synthetic.write_scene(str(src), str(mdl), c2ws, cams, images, model, train_ids, test_ids, ITERATION, rng)

    _build.reset_launches()
    t0 = time.perf_counter()
    port_render.main(["-m", str(mdl), "--skip_train", "--skip_test", "--video"])
    torch.cuda.synchronize()
    video_s = time.perf_counter() - t0
    launches = add_launches(total)
    check_chain_launches("render --video", launches, port_render.VIDEO_FRAMES, 0)
    out = mdl / "video" / f"ours_{ITERATION}"
    n_frames = len(list((out / "final_video").glob("*.png"))) if (out / "final_video").is_dir() else None
    if n_frames is None and (out / "final_video.mp4").exists():
        import cv2  # an mp4 when cv2 is present: its frame count

        n_frames = int(cv2.VideoCapture(str(out / "final_video.mp4")).get(cv2.CAP_PROP_FRAME_COUNT))
    if n_frames != port_render.VIDEO_FRAMES:
        raise AssertionError(f"the video has {n_frames} frames")
    params = params_from_numpy(model, dev)
    vcams = [c.raster_camera(dev) for c in port_render.video_cameras(
        Scene(ModelParams.extract(get_combined_args(build_parser(fill_none=True).parse_args(
            ["-m", str(mdl)]))), load_iteration=ITERATION).getTrainCameras())]
    bg = torch.zeros(3, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in vcams:
        eval_render(params, c, bg, 3)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3 / len(vcams)

    weights = work / "lpips_weights"
    write_random_lpips(str(weights), seed=SEED)
    _build.reset_launches()
    with mock.patch.dict(os.environ, {"LPIPS_WEIGHTS_DIR": str(weights)}):
        port_render.main(["-m", str(mdl), "--skip_train"])
        t0 = time.perf_counter()
        port_metrics.evaluate([str(mdl)])
        metrics_s = time.perf_counter() - t0
        nets = {n: load_lpips(n).to(dev) for n in ("vgg", "alex")}
    add_launches(total)
    res = json.loads((mdl / "results.json").read_text())[f"ours_{ITERATION}"]
    if not all(res[k] is not None and math.isfinite(res[k]) for k in ("LPIPS", "LPIPS_ALEX", "PSNR", "SSIM")):
        raise AssertionError(f"metrics with LPIPS weights: {res}")
    x = torch.from_numpy(images[test_ids[0]][None]).to(dev)
    y = eval_render(params, cams[test_ids[0]].raster_camera(dev), bg, 3).color.clamp(0, 1)[None]
    # vgg on [0, 1], alex on [-1, 1], as metrics.py
    ranged = {"vgg": (x, y), "alex": (x * 2 - 1, y * 2 - 1)}
    with torch.no_grad():
        lp_ms = {n: median_ms(functools.partial(net, *ranged[n]), runs=10) for n, net in nets.items()}
    return [f"render --video: {n_frames} frames in {video_s:.1f} s (CLI: the model's load, the renders, the "
            f"frame writes), {frame_ms:.3f} ms a frame rendering alone (host clock, synchronised) | launches "
            f"{launches}",
            f"metrics with random LPIPS weights ({len(test_ids)} test views): PSNR {res['PSNR']:.4f} SSIM "
            f"{res['SSIM']:.5f} LPIPS (vgg) {res['LPIPS']:.5f} LPIPS_ALEX {res['LPIPS_ALEX']:.5f} (random "
            f"weights: a reading); metrics {metrics_s:.2f} s, a view's LPIPS median ms vgg {lp_ms['vgg']:.3f} "
            f"alex {lp_ms['alex']:.3f} at {WIDTH}x{HEIGHT}"]


def phase_chain(dev, work: Path) -> dict:
    """6d: each CLI of the published scripts at full width on the room."""
    gt, model, pts, cols_u8 = chain_room(dev)
    total = {}
    gt_params = params_from_numpy(gt, dev)
    lines = chain_scannetpp(dev, work, gt_params, pts, cols_u8, total)
    lines += chain_project_cam(dev, work, gt_params, pts, cols_u8, total)
    del gt_params
    lines += chain_resume(dev, work, total)
    lines += chain_video_lpips(dev, work, gt, model, total)
    for line in lines:
        log("phase 6d " + line)
    return total


def l1_bound(shape, dtype):
    """L1's least time: q, k, v read once and o written once, against the
    two products (4 B H N^2 D operations) at the peak of the input type."""
    b, h, n, d = shape
    elem = torch.empty((), dtype=dtype).element_size()
    return bound(4 * b * h * n * d * elem, 4 * b * h * n * n * d,
                 PEAK_BF16_FLOPS if dtype == BF16 else PEAK_F32_FLOPS)


def phase_l1(dev):
    """7a: L1 against its plain version at every shape of L1_SHAPES."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    rows, res = [], {}
    with torch.no_grad():
        for shape, dtype in L1_SHAPES:
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))
            scale = shape[3] ** -0.5
            got = flash_attention(q, k, v, scale)
            want = flash_attention_plain(q, k, v, scale)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if got.dtype != dtype or got.shape != want.shape or not err <= L1_TOL[dtype]:
                raise AssertionError(f"L1 {shape} {dtype}: max abs err {err:.3g} > {L1_TOL[dtype]}")
            r = dict(max_abs_err=err, bound=l1_bound(shape, dtype),
                     ms=median_ms(lambda: flash_attention(q, k, v, scale)),
                     plain_ms=median_ms(lambda: flash_attention_plain(q, k, v, scale)),
                     library_ms=median_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)))
            res[(shape, dtype)] = r
            ratio = (f", {r['ms'] / r['library_ms']:.2f}x sdpa's, at {r['bound'][0] / r['ms']:.1%} of the bound"
                     if dtype == BF16 else "")
            rows.append(f"{shape} {str(dtype)[6:]}: err {err:.3g} (tol {L1_TOL[dtype]}), {r['ms']:.3f} ms "
                        f"vs plain {r['plain_ms']:.3f}, sdpa {r['library_ms']:.3f}, bound "
                        f"{r['bound'][0]:.4f} ms ({r['bound'][1]}){ratio}")
            del q, k, v, got, want
    log("phase 7a L1 vs plain (unit-normal inputs; median of 10, host clock with synchronize): "
        + " | ".join(rows))
    vae = res[L1_VAE]
    return dict(res[L1_MAIN], extra=dict(shape_d512=list(L1_VAE[0]), ms_d512=vae["ms"],
                                         library_ms_d512=vae["library_ms"], bound_ms_d512=vae["bound"][0]))


@contextlib.contextmanager
def timed(module, name: str, record: list, outputs: list | None = None):
    """Time every call of module.name (the calling thread's stream
    synchronised on both sides: a pipelined event's worker times its own
    work) into `record`, in ms, while the context is open; append what each
    call returns to `outputs` if given."""
    fn = getattr(module, name)

    def run(*args, **kwargs):
        stream_sync()
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        stream_sync()
        record.append((time.perf_counter() - t) * 1e3)
        if outputs is not None:
            outputs.append(out)
        return out

    with mock.patch.object(module, name, run):
        yield


def stage_summary(prof):
    """Device ms per stage of a trace: L1's forward and backward by their
    kernel names; every other kernel by the innermost range of STAGES
    above the op that launched it or, in a backward pass, above the
    forward op whose autograd node it runs (the profiler's sequence number
    and forward thread pair them, as torch's own backward stack traces
    do); "other" takes what neither places. Also the idle share of the
    traced span and the device ms of the largest kernels of the
    "attention" stage by name."""
    stage_us = dict.fromkeys(STAGE_ORDER, 0.0)
    attn_kernels = {}
    spans, first, last, total = [], math.inf, -math.inf, 0.0
    events = prof.events()

    def labelled(evt):
        while evt is not None:
            stage = STAGES.get(evt.name[len(tracing.PREFIX):]) if evt.name.startswith(tracing.PREFIX) else None
            if stage is not None:
                return stage
            evt = evt.cpu_parent
        return None

    def backward_node(evt):
        while evt is not None:
            if evt.scope == 1:  # a backward function
                return evt
            evt = evt.cpu_parent
        return None

    fwd_stage = {}
    for evt in events:
        if evt.device_type == torch.autograd.DeviceType.CPU and evt.sequence_nr >= 0 \
                and backward_node(evt) is None:
            stage = labelled(evt)
            if stage is not None:
                fwd_stage.setdefault((evt.sequence_nr, evt.thread), stage)
    for evt in events:
        first = min(first, evt.time_range.start)
        if evt.name.startswith(tracing.PREFIX):
            continue  # a range itself, also mirrored on the device's timeline
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            dur = evt.time_range.end - evt.time_range.start
            spans.append((evt.time_range.start, evt.time_range.end))
            last = max(last, evt.time_range.end)
            total += dur
            if "flash_attn_fwd" in evt.name:
                stage_us["L1 fwd"] += dur
            elif "flash_attn_bwd" in evt.name:
                stage_us["L1 bwd"] += dur
        elif evt.kernels:
            stage = labelled(evt)
            node = backward_node(evt) if stage is None else None
            if node is not None:
                stage = fwd_stage.get((node.sequence_nr, node.fwd_thread))
            for kern in evt.kernels:
                if stage is not None and "flash_attn" not in kern.name:
                    stage_us[stage] += kern.duration
                    if stage == "attention":
                        attn_kernels[kern.name] = attn_kernels.get(kern.name, 0.0) + kern.duration / 1e3
    idle = idle_share(spans, first, last)
    stage_us["other"] = total - sum(v for k, v in stage_us.items() if k != "other")
    top = sorted(attn_kernels.items(), key=lambda kv: -kv[1])[:4]
    return {k: v / 1e3 for k, v in stage_us.items()}, idle, top


def fmt_diffusion_stages(dev_ms: dict, idle: float) -> str:
    return (" ".join(f"{k} {dev_ms[k]:.3f}" for k in STAGE_ORDER)
            + f" (total {sum(dev_ms.values()):.3f}), idle share {idle:.3f} (under the profiler)")


def one_step(params, mcfg, scfg, cond, uncond, x, index, noise, plain=False):
    """One DDIM step of the request's sampler (CFG pair, then the update)."""
    sched = mcfg.schedule(x.device)
    pr = S.make_ddim_params(sched, scfg.ddim_steps, eta=scfg.ddim_eta, method=scfg.timestep_spacing)
    t = pr.timesteps[index].expand(x.shape[0])
    mo, _ = ddim.cfg_model_output(lambda x_, t_: apply_model(params, mcfg, x_, t_, cond, plain=plain),
                                  lambda x_, t_: apply_model(params, mcfg, x_, t_, uncond, plain=plain),
                                  x, t, scfg.cfg_scale, scfg.guidance_rescale)
    return ddim.ddim_step(sched, pr, index, x, mo, noise).x_prev


@functools.lru_cache(maxsize=1)
def gen_params(dev):
    """The ViewCrafter's random parameters on the card in bf16 (phases 7
    and 8 share them) and the seconds their init took."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_diffusion_params(LatentDiffusionConfig(), synthesis.SynthesisConfig(), seed=SEED,
                                   device=dev, dtype=BF16)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def phase_generate(dev, steps: int, trace_and_f32: bool = True) -> int:
    """7b (and 7c): one full-width request of `steps` DDIM steps through
    the engine a user calls, in bfloat16. Returns L1's launches in it."""
    mcfg = LatentDiffusionConfig(compute_dtype="bfloat16")
    scfg = synthesis.SynthesisConfig(ddim_steps=steps)
    params, init_s = gen_params(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = ViewCrafterEngine(params, mcfg, scfg, video_length=GEN_FRAMES, height=GEN_H, width=GEN_W)
    torch.cuda.synchronize()
    setup_s = init_s + time.perf_counter() - t0
    n_params = sum(v.numel() for part in params for v in part.values())
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    renders = torch.rand((GEN_FRAMES, GEN_H, GEN_W, 3), generator=gen, device=dev)

    # the main path of this slice
    cond_ms, model_ms, update_ms, decode_ms = [], [], [], []
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with timed(synthesis, "build_conditioning", cond_ms), timed(synthesis, "decode_video_frames", decode_ms), \
            timed(ddim, "cfg_model_output", model_ms), timed(ddim, "ddim_step", update_ms):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        video = engine.generate(renders, no_guidance=True, generator=gen)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = 10 * steps + 2  # 5 level-0 spatial attentions x 2 CFG branches per step; VAE encode, decode
    if launches["flash_attn_fwd"] != expected or any(launches[n] for n in GAUSSIAN_KERNELS + L1_BWD_KERNELS):
        raise AssertionError(f"launches in the request {launches}; L1 expected {expected}")
    if tuple(video.shape) != (GEN_FRAMES, 3, GEN_H, GEN_W) or not bool(torch.isfinite(video).all()) \
            or float(video.min()) < 0.0 or float(video.max()) > 1.0:
        raise AssertionError(f"bad video: shape {tuple(video.shape)}, range "
                             f"[{float(video.min())}, {float(video.max())}]")
    step_ms = [m + u for m, u in zip(model_ms, update_ms)]
    log(f"phase 7b request (ViewCrafter full width, {n_params} parameters in bf16, random from a seed; "
        f"{GEN_FRAMES}x{GEN_H}x{GEN_W}, {steps} DDIM steps, no guidance, compute bf16): set-up "
        f"(init on the card + text pair) {setup_s:.2f} s | conditioning {cond_ms[0]:.1f} ms | DDIM step "
        f"ms median {statistics.median(step_ms):.1f} (first {step_ms[0]:.1f}, min {min(step_ms):.1f}, "
        f"max {max(step_ms):.1f}; model pair {statistics.median(model_ms):.1f}) | decode "
        f"{decode_ms[0]:.1f} ms | total {total_s:.3f} s | peak allocated {peak_gb:.2f} GB | L1 launches "
        f"{launches['flash_attn_fwd']} (expected {expected}) | video std {float(video.std()):.4f}")
    if not trace_and_f32:
        return launches["flash_attn_fwd"]

    # one DDIM step traced by stage, outside the counted run
    cond, uncond, x, noise = ddim_step_inputs(dev, params, mcfg, scfg, engine, renders)
    index = steps // 2
    with torch.no_grad():
        one_step(params, mcfg, scfg, cond, uncond, x, index, noise)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=PROFILER_ACTIVITIES) as prof:
            one_step(params, mcfg, scfg, cond, uncond, x, index, noise)
            torch.cuda.synchronize()
    dev_ms, idle, top = stage_summary(prof)
    log("phase 7b one DDIM step traced (bf16, CFG pair + update), device ms: "
        + fmt_diffusion_stages(dev_ms, idle) + "; largest attention kernels: "
        + "; ".join(f"{name[:70]} {ms:.3f}" for name, ms in top))

    # 7c: one float32 step through L1 and through its plain version
    step32 = f32_step(params, mcfg, scfg, cond, uncond, x, noise)
    before = _build.LAUNCHES["flash_attn_fwd"]
    got = step32(index)
    mid = _build.LAUNCHES["flash_attn_fwd"]
    want = step32(index, plain=True)
    # the bf16 check: the same step with L1's forward in bf16, the bf16
    # kernels (twice) against the plain version of the same bf16 inputs
    with mock.patch.object(fa, "_launch_fwd", bf16_forward()):
        got16 = step32(index)
        after16 = _build.LAUNCHES["flash_attn_fwd"]
        again16 = step32(index)
    with mock.patch.object(fa, "_launch_fwd", bf16_forward(plain=True)):
        want16 = step32(index)
    torch.cuda.synchronize()
    # 10 kernel launches a kernel step, none a plain one
    ran = (mid - before, after16 - mid, _build.LAUNCHES["flash_attn_fwd"] - after16)
    if ran != (10, 10, 10):
        raise AssertionError(f"7c: L1 launched {ran} times in (f32 kernel; f32 plain + bf16 kernel; bf16 "
                             f"kernel + bf16 plain), expected 10 each")
    err = (got - want).abs().max().item()
    err16 = ((got16 - want16).norm() / want16.norm()).item()
    if not (bool(torch.isfinite(got).all()) and err <= STEP_TOL
            and bool(torch.isfinite(got16).all()) and err16 <= STEP_TOL_BF16):
        raise AssertionError(f"7c: the f32 step through L1 differs from the plain chain by {err:.3g} (tol "
                             f"{STEP_TOL}); with L1's forward in bf16 by {err16:.3g} in L2 (tol {STEP_TOL_BF16})")
    log(f"phase 7c one f32 DDIM step (TF32 off) at index {index}, L1 vs its plain version: latent max abs "
        f"diff {err:.3g} (tol {STEP_TOL}; max |latent| {got.abs().max().item():.3f}) | the same step with L1's "
        f"forward in bf16, the bf16 kernels vs the plain version of the same bf16 inputs: {err16:.4g} of "
        f"|latent| {want16.norm().item():.4g} (L2 norms; tol {STEP_TOL_BF16}); the kernels run twice "
        f"{(got16 - again16).norm().item():.3g}")
    return launches["flash_attn_fwd"]


def ddim_step_inputs(dev, params, mcfg, scfg, engine, renders):
    """The inputs of 7b's traced step and of 7c, from SEED + 12: the
    request's conditioning (with its own encode noise), x_t and the step's
    noise; returns (cond, uncond, x, noise)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 12)
    with torch.no_grad():
        cond, uncond, _ = synthesis.build_conditioning(params, mcfg, scfg, renders * 2.0 - 1.0,
                                                       generator=gen, text_pair=engine.text_pair)
        x = torch.randn(cond.concat.shape, generator=gen, device=dev)
        noise = torch.randn(x.shape, generator=gen, device=dev)
    return cond, uncond, x, noise


def f32_step(params, mcfg, scfg, cond, uncond, x, noise):
    """7c's step: step(index, plain=False) -> x_prev of one DDIM step of
    the bf16 request's inputs in float32 (the UNet's weights cast; run it
    with TF32 off), without autograd."""
    mcfg32 = dataclasses.replace(mcfg, compute_dtype="float32")
    params32 = params._replace(unet={k: v.float() for k, v in params.unet.items()})

    def step(index: int, plain: bool = False):
        with torch.no_grad():
            return one_step(params32, mcfg32, scfg, cond, uncond, x, index, noise, plain=plain)
    return step


def bf16_forward(plain: bool = False, fault=None):
    """L1's forward in bfloat16, to patch in as `fa._launch_fwd`: q, k, v
    rounded to bf16, the bf16 kernel (with `plain`, the plain version of the
    same bf16 inputs; with `fault`, fault(q, k, v, scale) of them), the
    output cast back. 7c's bf16 check: in the float32 step around it L1's
    bf16 arithmetic is the only difference between the two."""
    real = fa._launch_fwd

    def fwd(q, k, v, scale, with_lse):
        q, k, v = (t.to(BF16) for t in (q, k, v))
        if fault is not None:
            out, lse = fault(q, k, v, scale), None
        elif plain:
            out, lse = fa.flash_attention_plain_lse(q, k, v, scale)
        else:
            out, lse = real(q, k, v, scale, with_lse)
        return out.float(), lse if with_lse else None
    return fwd


def l1_bwd_bounds(shape, dtype):
    """L1's backward kernels' least times: dK/dV reads q, k, v, dO, the
    log-sum-exp and Delta and writes dk, dv, against four n x n products
    (S, dP, dV, dK: 8 B H N^2 D operations); dQ reads the same and writes
    dq, against three (6 B H N^2 D), at the peak of the input type."""
    b, h, n, d = shape
    elems, rows = b * h * n * d, b * h * n
    size = torch.empty((), dtype=dtype).element_size()
    peak = PEAK_BF16_FLOPS if dtype == BF16 else PEAK_F32_FLOPS
    reads = 4 * elems * size + 2 * rows * 4
    return (bound(reads + 2 * elems * size, 8 * rows * n * d, peak),
            bound(reads + elems * size, 6 * rows * n * d, peak))


def phase_l1_bwd(dev):
    """8a: L1's backward against its plain backward at every shape of
    L1_BWD_SHAPES; returns the rows of the kernel table at L1_BWD_MAIN."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    rows, res = [], {}
    for shape, dtype in L1_BWD_SHAPES:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(4))
        scale = shape[3] ** -0.5
        with torch.no_grad():
            out, lse = fa.flash_attention_lse(q, k, v, scale)
            want_lse = torch.logsumexp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, dim=-1)
            lse_err = (lse - want_lse).abs().max().item()
            del want_lse
            got = fa.flash_attention_bwd(q, k, v, out, lse, do, scale)
            want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, scale)
            torch.cuda.synchronize()
            abs_errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
            errs = [e / w.float().abs().max().item() for e, w in zip(abs_errs, want)]
            del got, want
        if not (lse_err <= LSE_TOL and all(e <= L1_BWD_TOL[dtype] for e in errs)):
            raise AssertionError(f"L1 backward {shape} {dtype}: log-sum-exp err {lse_err:.3g} (tol "
                                 f"{LSE_TOL}); dq, dk, dv err / max |grad| {errs} (tol {L1_BWD_TOL[dtype]})")
        delta = fa.attention_delta(out, do)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        sdpa = F.scaled_dot_product_attention(*leaves, scale=scale)
        bounds = l1_bwd_bounds(shape, dtype)
        with torch.no_grad():
            r = dict(dkv_ms=median_ms(lambda: fa.bwd_dkv_kernel(q, k, v, do, lse, delta, scale)),
                     dq_ms=median_ms(lambda: fa.bwd_dq_kernel(q, k, v, do, lse, delta, scale)),
                     plain_ms=median_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, do, scale)))
        r["library_ms"] = median_ms(lambda: torch.autograd.grad(sdpa, leaves, do, retain_graph=True))
        r.update(abs_errs=abs_errs, errs=errs, lse_err=lse_err, bounds=bounds)
        res[(shape, dtype)] = r
        pair = r["dkv_ms"] + r["dq_ms"]
        rows.append(f"{shape} {str(dtype)[6:]}: err/max|g| dq {errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g} "
                    f"(tol {L1_BWD_TOL[dtype]}), lse err {lse_err:.3g}; dK/dV {r['dkv_ms']:.3f} ms (bound "
                    f"{bounds[0][0]:.4f}, {bounds[0][1]}), dQ {r['dq_ms']:.3f} ms (bound {bounds[1][0]:.4f}, "
                    f"{bounds[1][1]}); plain backward {r['plain_ms']:.3f}, sdpa backward {r['library_ms']:.3f}; "
                    f"dK/dV + dQ {pair / r['library_ms']:.2f}x sdpa's, at "
                    f"{(bounds[0][0] + bounds[1][0]) / pair:.1%} of the bound")
        del q, k, v, do, out, lse, delta, leaves, sdpa
    log("phase 8a L1 backward vs plain (unit-normal q, k, v, dO; median of 10, host clock with "
        "synchronize; the plain and sdpa times are of the whole backward): " + " | ".join(rows))
    main, vae = res[L1_BWD_MAIN], res[L1_BWD_VAE]
    whole = {"plain_ms_of": "the whole backward (dq, dk, dv)", "library_ms_of": "the whole backward (dq, dk, dv)",
             "shape_d512": list(L1_BWD_VAE[0])}
    return {"flash_attn_bwd_dkv": dict(max_abs_err=max(main["abs_errs"][1:]), ms=main["dkv_ms"],
                                       plain_ms=main["plain_ms"], library_ms=main["library_ms"],
                                       bound=main["bounds"][0],
                                       extra=dict(whole, ms_d512=vae["dkv_ms"], library_ms_d512=vae["library_ms"],
                                                  bound_ms_d512=vae["bounds"][0][0])),
            "flash_attn_bwd_dq": dict(max_abs_err=main["abs_errs"][0], ms=main["dq_ms"],
                                      plain_ms=main["plain_ms"], library_ms=main["library_ms"],
                                      bound=main["bounds"][1],
                                      extra=dict(whole, ms_d512=vae["dq_ms"], library_ms_d512=vae["library_ms"],
                                                 bound_ms_d512=vae["bounds"][1][0]))}


def guided_inputs(dev, gen):
    """The request's renders (T, 480, 640, 3), guidance images (T, 3, 480,
    640) in [0, 1], observed masks with the HOLE, depths."""
    t = GEN_FRAMES
    renders = torch.rand((t, GUIDE_H, GUIDE_W, 3), generator=gen, device=dev)
    images = torch.rand((t, 3, GUIDE_H, GUIDE_W), generator=gen, device=dev)
    masks = torch.ones((t, 1, GUIDE_H, GUIDE_W), device=dev)
    masks[:, :, HOLE[0], HOLE[1]] = 0.0
    depths = 1.0 + 2.0 * torch.rand((t, 1, GUIDE_H, GUIDE_W), generator=gen, device=dev)
    return renders, images, masks, depths


def guided_launches(ucfg, steps: int, frames: int, chunk: int) -> tuple[int, int]:
    """L1's launches (forward; each backward kernel) in `steps` guided steps
    of `frames` frames. Per step the level-0 spatial attentions (5 in the
    ViewCrafter UNet: 2 input and 3 output blocks) run forward once for the
    batched pair (without autograd), then forward and backward once in each
    branch for its VJP; one VAE mid attention per decode chunk runs forward
    and backward."""
    level0 = (2 * ucfg.num_res_blocks + 1) * (1 in ucfg.attention_resolutions)
    level0 += len(ucfg.channel_mult) == 1  # the middle block's, when level 0 is the deepest
    chunks = -(-frames // chunk)
    return steps * (3 * level0 + chunks), steps * (2 * level0 + chunks)


def masked_l2(video, buffers) -> float:
    m = buffers.masks.permute(0, 3, 1, 2)
    return float(((video - buffers.images.permute(0, 3, 1, 2)) ** 2 * m).sum() / (3 * m.sum()))


def guided_step_inputs(dev, params, mcfg, scfg, engine, renders):
    """The inputs of 8b's traced step and of 8c, from SEED + 11: the
    request's conditioning (with its own encode noise), x_t and the step's
    noise; returns (sched, pr, cond, uncond, x, step_noise, index)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)
    f = 2 ** (len(mcfg.vae.ch_mult) - 1)  # the VAE's downsampling
    lat = (GEN_FRAMES, GEN_H // f, GEN_W // f, 4)
    with torch.no_grad():
        cond, uncond, _ = synthesis.build_conditioning(
            params, mcfg, scfg, resize_renders(renders, GEN_H, GEN_W) * 2.0 - 1.0,
            eps=torch.randn(lat, generator=gen, device=dev), text_pair=engine.text_pair)
    sched = mcfg.schedule(dev)
    pr = S.make_ddim_params(sched, scfg.ddim_steps, eta=scfg.ddim_eta, method=scfg.timestep_spacing)
    x = torch.randn((1,) + lat, generator=gen, device=dev)
    step_noise = torch.randn(x.shape, generator=gen, device=dev)
    return sched, pr, cond, uncond, x, step_noise, scfg.ddim_steps // 2


def plain_backward():
    """Within it L1's autograd Function takes its plain backward after the
    kernel forward: 8c's reference for dL/dx, whose forward must be the
    same (the guidance loss clamps the decoded frames to [0, 1], so the
    forward's rounding flips pixels at the clamp in or out)."""
    return mock.patch.object(fa, "flash_attention_bwd", fa.flash_attention_bwd_plain)


def bf16_backward(plain: bool = False):
    """L1's backward in bfloat16, to patch in as `fa.flash_attention_bwd`:
    q, k, v, o and dO rounded to bf16, the bf16 backward kernels (with
    `plain`, the plain backward of the same bf16 inputs), the gradients cast
    back. 8c's bf16 check: in the float32 step around it L1's bf16
    arithmetic is the only difference between the two. A whole bf16 step is
    no yardstick: its own rounding moves dL/dx by ~9% in L2 for any change
    of one attention's gradient, a planted fault included (PERF.md)."""
    real = fa.flash_attention_bwd_plain if plain else fa.flash_attention_bwd

    def bwd(q, k, v, o, lse, do, scale):
        grads = real(*(t.to(BF16) for t in (q, k, v, o)), lse, do.to(BF16), scale)
        return tuple(g.float() for g in grads)
    return bwd


@contextlib.contextmanager
def deterministic_cudnn():
    """Within it cuDNN takes deterministic algorithms: 8c's dL/dx
    comparison then sees L1's backward and not the order in which a
    convolution's backward sums."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def small_guided_step(params, mcfg, gcfg, sched, pr, cond, uncond, bufs, x, step_noise, index: int,
                      dtype=F32):
    """8c's step: one guided step of the first STEP32_FRAMES frames of the
    bf16 request's inputs, in float32 (the UNet's and the VAE's weights
    cast; run it with TF32 off) or in the request's bfloat16. Returns
    (step, grad): step(plain=False) -> (x_prev, pred_x0, rho) of the whole
    step; grad(plain=False) -> the step's dL/dx from the pred_x0 and the
    branches' v of one forward through L1's kernel: the decode gradients
    and the pair's VJP alone."""
    t = STEP32_FRAMES
    mcfg32, params32 = mcfg, params
    if dtype == F32:
        mcfg32 = dataclasses.replace(mcfg, compute_dtype="float32")
        params32 = params._replace(unet={k: v.float() for k, v in params.unet.items()},
                                   vae={k: v.float() for k, v in params.vae.items()})
    c32, u32 = (Conditioning(c.context, c.concat[:, :t].contiguous(), c.fs) for c in (cond, uncond))
    g32 = make_guidance_fn(bufs._replace(images=bufs.images[:t], masks=bufs.masks[:t]))
    x32, n32 = x[:, :t].contiguous(), step_noise[:, :t].contiguous()
    v_cond, v_uncond = ddim_guidance.pair_forward(params32, mcfg32, pr, c32, u32, x32, index)
    pred_x0 = ddim_guidance.cfg_pred_x0(sched, pr, gcfg, x32, index, v_cond, v_uncond)[0]

    def step(plain: bool = False):
        return ddim_guidance.guided_step(params32, mcfg32, sched, pr, c32, u32, gcfg, g32, 1.0, x32, index,
                                         n32, plain)

    def grad(plain: bool = False):
        grads = ddim_guidance.per_frame_guidance_grads(params32, mcfg32, g32, pred_x0[0], index, gcfg, plain)
        return ddim_guidance.pair_vjp(params32, mcfg32, sched, pr, c32, u32, gcfg, x32, index, v_cond, v_uncond,
                                      grads[None], plain)
    return step, grad


def phase_guided(dev, steps: int, trace_and_f32: bool = True):
    """8b (and 8c): one full-width guided request of `steps` guided DDIM
    steps through the engine a user calls, in bfloat16. Returns L1's
    launches in it and the median ms of its guided steps."""
    mcfg = LatentDiffusionConfig(compute_dtype="bfloat16")
    scfg = synthesis.SynthesisConfig(ddim_steps=steps)
    params, _ = gen_params(dev)
    engine = ViewCrafterEngine(params, mcfg, scfg, video_length=GEN_FRAMES, height=GEN_H, width=GEN_W)
    gcfg = engine.guided_cfg
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 10)
    renders, images, masks, depths = guided_inputs(dev, gen)
    f = 2 ** (len(mcfg.vae.ch_mult) - 1)  # the VAE's downsampling
    lat = (GEN_FRAMES, GEN_H // f, GEN_W // f, 4)
    noise = synthesis.SynthesisNoise(
        encode_eps=torch.randn(lat, generator=gen, device=dev),
        x_T=torch.randn((1,) + lat, generator=gen, device=dev),
        steps=torch.randn((steps * (2 * gcfg.recur_steps - 1), 1) + lat, generator=gen, device=dev))

    # the main path of this slice
    cond_ms, step_ms, pair_ms, grads_ms, vjp_ms, ddim_ms, upd_ms, decode_ms, upd_out = ([] for _ in range(9))
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with timed(synthesis, "build_conditioning", cond_ms), timed(synthesis, "decode_video_frames", decode_ms), \
            timed(ddim_guidance, "guided_step", step_ms), timed(ddim_guidance, "pair_forward", pair_ms), \
            timed(ddim_guidance, "per_frame_guidance_grads", grads_ms), \
            timed(ddim_guidance, "pair_vjp", vjp_ms), timed(ddim_guidance, "ddim_step", ddim_ms), \
            timed(ddim_guidance, "guidance_update", upd_ms, upd_out):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        video = engine.generate(renders, images, masks, depths, no_guidance=False, noise=noise)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_steps = steps * gcfg.recur_steps
    fwd, bwd = guided_launches(mcfg.unet, n_steps, GEN_FRAMES, gcfg.decode_chunk)
    expected = {"flash_attn_fwd": fwd + 2, "flash_attn_bwd_dkv": bwd, "flash_attn_bwd_dq": bwd}
    if any(launches[n] != e for n, e in expected.items()) or any(launches[n] for n in GAUSSIAN_KERNELS):
        raise AssertionError(f"launches in the guided request {launches}; expected {expected}")
    rhos = [float(rho) for _, rho in upd_out]
    if len(rhos) != n_steps or not all(math.isfinite(r) and r > 0 for r in rhos):
        raise AssertionError(f"rho per step {rhos}: expected {n_steps} positive values")
    if tuple(video.shape) != (GEN_FRAMES, 3, GEN_H, GEN_W) or not bool(torch.isfinite(video).all()) \
            or float(video.min()) < 0.0 or float(video.max()) > 1.0:
        raise AssertionError(f"bad guided video: shape {tuple(video.shape)}, range "
                             f"[{float(video.min())}, {float(video.max())}]")
    # a reading, not a check (random weights): the masked L2 to the guidance
    # of the guided frames and of an unguided request with the same noise
    bufs = resize_guidance(images, GEN_H, GEN_W, masks=masks)
    unguided = engine.generate(renders, no_guidance=True, noise=noise._replace(steps=noise.steps[:steps]))
    l2_guided, l2_unguided = masked_l2(video, bufs), masked_l2(unguided, bufs)
    med = statistics.median
    log(f"phase 8b guided request (ViewCrafter full width, random bf16 weights; {GEN_FRAMES}x{GEN_H}x{GEN_W} "
        f"from {GUIDE_H}x{GUIDE_W} renders and guidance, hole {HOLE[0].stop - HOLE[0].start}x"
        f"{HOLE[1].stop - HOLE[1].start} in the masks; {steps} guided DDIM steps of the default 50, "
        f"CFG pair batched, then each branch again for its VJP, decode_chunk {gcfg.decode_chunk}): "
        f"conditioning {cond_ms[0]:.1f} ms | guided step ms median {med(step_ms):.1f} (first "
        f"{step_ms[0]:.1f}, min {min(step_ms):.1f}); by part, medians: pair forward {med(pair_ms):.1f}, "
        f"decode gradients {med(grads_ms):.1f}, the branches again with their VJPs {med(vjp_ms):.1f}, update {med(ddim_ms) + med(upd_ms):.1f} | decode {decode_ms[0]:.1f} ms | total "
        f"{total_s:.3f} s | peak allocated {peak_gb:.2f} GB | launches fwd {launches['flash_attn_fwd']} "
        f"dK/dV {launches['flash_attn_bwd_dkv']} dQ {launches['flash_attn_bwd_dq']} (expected {expected}) | "
        f"rho per step {', '.join(f'{r:.4g}' for r in rhos)} | masked L2 to the guidance: guided "
        f"{l2_guided:.6f}, unguided with the same noise {l2_unguided:.6f}")
    if not trace_and_f32:
        return launches, med(step_ms)

    # one guided step traced by stage, outside the counted run
    sched, pr, cond, uncond, x, step_noise, index = guided_step_inputs(dev, params, mcfg, scfg, engine, renders)
    gfn = make_guidance_fn(bufs)

    def step():
        return ddim_guidance.guided_step(params, mcfg, sched, pr, cond, uncond, gcfg, gfn, 1.0, x, index,
                                         step_noise)

    step()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=PROFILER_ACTIVITIES) as prof:
        step()
        torch.cuda.synchronize()
    dev_ms, idle, _ = stage_summary(prof)
    log("phase 8b one guided step traced (bf16: CFG pair forward, decode gradients, each branch again "
        "with its VJP, update), "
        "device ms: " + fmt_diffusion_stages(dev_ms, idle))

    # 8c: one float32 guided step of STEP32_FRAMES frames through L1's
    # kernels and through its plain forward and backward
    t = STEP32_FRAMES
    step32, grad32 = small_guided_step(params, mcfg, gcfg, sched, pr, cond, uncond, bufs, x, step_noise, index)
    before = dict(_build.LAUNCHES)
    got, _, rho_k = step32()
    mid = dict(_build.LAUNCHES)
    want, _, rho_p = step32(plain=True)
    torch.cuda.synchronize()
    plain_launched = {n: _build.LAUNCHES[n] - mid[n] for n in mid}
    # the same kernel step again: how far two runs of it differ (cuDNN's
    # backward algorithms need not sum in one order)
    again = step32()[0]
    with deterministic_cudnn():
        gx = grad32()
        with plain_backward():
            gx_plain = grad32()
        gx_again = grad32()
    fwd32, bwd32 = guided_launches(mcfg.unet, 1, t, gcfg.decode_chunk)
    ran = {n: mid[n] - before[n] for n in ("flash_attn_fwd",) + L1_BWD_KERNELS}
    if ran != {"flash_attn_fwd": fwd32, "flash_attn_bwd_dkv": bwd32, "flash_attn_bwd_dq": bwd32} \
            or any(plain_launched.values()):
        raise AssertionError(f"8c: L1 launched {ran} through the kernel path (expected {fwd32}, "
                             f"{bwd32}, {bwd32}), {plain_launched} through the plain one")
    scale_x, scale_g = got.abs().max().item(), gx_plain.norm().item()
    err, rerun = (got - want).abs().max().item(), (got - again).abs().max().item()
    gerr, grerun = (gx - gx_plain).norm().item() / scale_g, (gx - gx_again).norm().item() / scale_g
    # the same dL/dx with L1's backward in bf16: the bf16 kernels against the
    # plain backward of the same bf16 inputs
    with deterministic_cudnn():
        with mock.patch.object(fa, "flash_attention_bwd", bf16_backward()):
            g16 = grad32()
        with mock.patch.object(fa, "flash_attention_bwd", bf16_backward(plain=True)):
            g16_plain = grad32()
        with mock.patch.object(fa, "flash_attention_bwd", bf16_backward()):
            g16_again = grad32()
    gerr16 = (g16 - g16_plain).norm().item() / g16_plain.norm().item()
    rerun16 = (g16 - g16_again).norm().item() / g16_plain.norm().item()
    if not (bool(torch.isfinite(got).all()) and err <= GUIDED_STEP_TOL * scale_x
            and bool(torch.isfinite(gx).all()) and gerr <= GUIDED_GRAD_TOL
            and bool(torch.isfinite(g16).all()) and gerr16 <= GUIDED_GRAD_TOL_BF16):
        raise AssertionError(f"8c: the f32 guided step through L1's kernels differs from the plain chain "
                             f"by {err:.3g} (max |x_prev| {scale_x:.3f}); its dL/dx by {gerr:.3g} of |dL/dx|; "
                             f"with L1's backward in bf16 by {gerr16:.3g} (tol {GUIDED_GRAD_TOL_BF16})")
    log(f"phase 8c one f32 guided step (TF32 off; {t} frames at {GEN_H}x{GEN_W}, index {index}), L1's kernels "
        f"vs its plain forward and backward: x_prev max abs diff {err:.3g} = {err / scale_x:.3g} of max "
        f"|x_prev| {scale_x:.3f} (tol {GUIDED_STEP_TOL}); the kernel step run twice differs by {rerun:.3g}; "
        f"rho {float(rho_k):.6g} vs {float(rho_p):.6g} | dL/dx from one forward's pred_x0 and v, L1's "
        f"backward kernels vs its plain backward (the forward L1's kernel in both, cuDNN deterministic): "
        f"|diff| {gerr:.4g} of |dL/dx| {scale_g:.4g} (L2 norms; tol {GUIDED_GRAD_TOL}); the kernels run "
        f"twice {grerun:.3g} | the same dL/dx with L1's backward in bf16, the bf16 kernels vs the plain "
        f"backward of the same bf16 inputs: {gerr16:.4g} of |dL/dx| {g16_plain.norm().item():.4g} (tol "
        f"{GUIDED_GRAD_TOL_BF16}); the kernels run twice {rerun16:.3g}")
    return launches, med(step_ms)


# --- phase 9: from raw data, the append path, the two-scale CFG, --nan_debug and the viewer ----------


def geometry_raw_replica(dev, work: Path):
    """Phase 4's room written as a raw Replica sequence (traj_w_c.txt and
    rgb/rgb_<i>.png, REPLICA_FRAMES frames: the 6-view split's); returns
    (the scene's path, the ground truth on the card, seconds)."""
    t0 = time.perf_counter()
    gt = chain_room(dev)[0]
    gt_params = params_from_numpy(gt, dev)
    c2ws, _, images = orbit_images(gt_params, REPLICA_FRAMES, dev)
    scene = work / "Replica" / REPLICA_SCENE
    (scene / "rgb").mkdir(parents=True)
    with open(scene / "traj_w_c.txt", "w") as f:
        for c2w in c2ws:
            f.write(" ".join(repr(float(x)) for x in np.asarray(c2w).flatten()) + "\n")
    save_images(images, [str(scene / "rgb" / f"rgb_{i}.png") for i in range(REPLICA_FRAMES)])
    return scene, gt_params, time.perf_counter() - t0


def dust3r_checkpoint(path: Path) -> float:
    """Random DUSt3R weights at the published width from the seed, written
    as a DUSt3R .pth ({"model": state dict}); the two heads' last bias is
    DUST3R_HEAD_BIAS (see there). Returns the seconds."""
    t0 = time.perf_counter()
    params = dust3r.init_params(dust3r.Dust3rConfig(), SEED + 20)
    for h in (1, 2):
        params[f"downstream_head{h}.dpt.head.4.bias"] = np.asarray(DUST3R_HEAD_BIAS, np.float32)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in params.items()}}, str(path))
    return time.perf_counter() - t0


def aligner_known_answer(dev, gt_params, scene: Path) -> str:
    """The aligner fed perfect predictions made from the room's rendered
    depth at the 6 train views at DUSt3R's size, poses and focals preset,
    the depth start corrupted by +0.3 in log: it must recover the depth
    (median relative error over the pixels the room covers <= ALIGN_TOL)
    and leave the presets bitwise."""
    imgs, c2ws, focals = geometry_pipeline.train_view_inputs(str(scene), "rgb", "replica", 6)
    v, h, w, _ = imgs.shape
    depth, cover = [], []
    for c2w, f in zip(c2ws, focals):
        K = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]])
        cam = cameras.camera_from_w2c_K(np.linalg.inv(c2w), K, h, w).raster_camera(dev)
        r = eval_render(gt_params, cam, torch.zeros(3, device=dev), 3)
        depth.append(r.depth.cpu().numpy())
        cover.append(r.alpha.cpu().numpy() > 0.99)
    depth, cover = np.stack(depth), np.stack(cover)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    world = []
    for k in range(v):  # the aligner's own unprojection (pixel grid, centred principal point)
        cam_pts = np.stack([(xx - w / 2.0) * depth[k] / focals[k], (yy - h / 2.0) * depth[k] / focals[k],
                            depth[k]], -1).reshape(-1, 3)
        world.append(cam_pts @ c2ws[k][:3, :3].T + c2ws[k][:3, 3])
    edges = geometry_pipeline.make_pairs(v)

    def in_frame(pts, k):
        w2c = np.linalg.inv(c2ws[k])
        return pts @ w2c[:3, :3].T + w2c[:3, 3]

    pred_i = np.stack([in_frame(world[i], i) for i, _ in edges]).astype(np.float32)
    pred_j = np.stack([in_frame(world[j], i) for i, j in edges]).astype(np.float32)
    conf_i = np.stack([np.where(cover[i].reshape(-1), 5.0, 1.0 + 1e-6) for i, _ in edges]).astype(np.float32)
    conf_j = np.stack([np.where(cover[j].reshape(-1), 5.0, 1.0 + 1e-6) for _, j in edges]).astype(np.float32)
    acfg = GA.AlignerConfig(height=h, width=w, pose_preset=True, focal_preset=True)
    s0 = GA.init_state(acfg, v, edges, pred_i, np.random.default_rng(SEED + 21), preset_c2w=c2ws,
                       preset_focals=focals, device=dev)
    s0 = s0._replace(im_depth=s0.im_depth + 0.3)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = GA.global_align(s0, acfg, t(pred_i), t(pred_j), t(conf_i), t(conf_j), edges, niter=300, lr=0.02)
    torch.cuda.synchronize()
    align_s = time.perf_counter() - t0
    got = GA.aligner_outputs(state, acfg)["depth"].cpu().numpy()
    rel = np.abs(got - depth)[cover] / depth[cover]
    med, p90 = float(np.median(rel)), float(np.percentile(rel, 90))
    if not (med <= ALIGN_TOL and torch.equal(state.im_poses, s0.im_poses)
            and torch.equal(state.im_focals, s0.im_focals)):
        raise AssertionError(f"9a aligner known answer: median relative depth error {med:.4g} (tol {ALIGN_TOL}), "
                             "or the preset poses / focals moved")
    return (f"aligner known answer ({v} views {w}x{h}, {len(edges)} edges, 300 iterations lr 0.02, presets, "
            f"start +0.3 in log depth): median relative depth error {med:.3g} (tol {ALIGN_TOL}), 90th pct "
            f"{p90:.3g}, over {int(cover.sum())} covered pixels; loss {float(loss):.4g}; presets bitwise; "
            f"{align_s:.2f} s")


def geometry_init_chain(dev, work: Path, total: dict) -> list:
    """9a: raw Replica files -> dataset_to_colmap -> the DUSt3R cloud (the
    pipeline CLI at Dust3rConfig(), a .pth of random weights) ->
    train_baseline GEOM_ITERS iterations from that cloud; and the aligner's
    known-answer check on the room's depth."""
    scene, gt_params, scene_s = geometry_raw_replica(dev, work)
    ckpt = work / "dust3r.pth"
    ckpt_s = dust3r_checkpoint(ckpt)
    pair_ms, align_ms = [], []
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    port_d2c.main(["replica", "--base", str(work / "Replica"), "--scenes", REPLICA_SCENE])
    d2c_s = time.perf_counter() - t0
    with timed(geometry_pipeline, "dust3r_apply", pair_ms), timed(GA, "global_align", align_ms):
        t0 = time.perf_counter()
        ds, n_pts = geometry_pipeline.main(["-s", str(scene), "--dataset", "replica", "--images", "rgb",
                                            "--weights", str(ckpt), "--seed", str(SEED)])
        torch.cuda.synchronize()
        cloud_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ckpt.unlink()
    during = add_launches(total)
    if any(during.values()):
        raise AssertionError(f"9a: the DUSt3R cloud launched kernels {during} (its attention is plain)")
    if ds.imgs.shape != (6, 384, 512, 3) or n_pts < 1000 or not np.isfinite(ds.pts3d).all():
        raise AssertionError(f"9a: cloud of {n_pts} points from images {ds.imgs.shape}")
    mdl = work / "geometry_model"
    t0 = time.perf_counter()
    trainer = port_train_cli.main(["-s", str(scene), "-m", str(mdl), "--dataset", "replica", "--images", "rgb",
                                   "--eval", "--n_views", "6", "--iterations", str(GEOM_ITERS),
                                   "--test_iterations", str(GEOM_ITERS), "--save_iterations", str(GEOM_ITERS)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = add_launches(total)
    n_test = len(trainer.scene.getTestCameras())
    check_chain_launches("9a train_baseline", launches, GEOM_ITERS + n_test + 6, GEOM_ITERS)
    if trainer.state.num_gaussians < 1000 or not bool(torch.isfinite(trainer.state.params.xyz).all()):
        raise AssertionError(f"9a: {trainer.state.num_gaussians} Gaussians after training")
    conf = ds.confs.reshape(-1)
    return [
        f"raw Replica {REPLICA_SCENE} ({REPLICA_FRAMES} frames {WIDTH}x{HEIGHT}, hfov {HFOV:g}) written in "
        f"{scene_s:.1f} s; "
        f"dataset_to_colmap {d2c_s:.2f} s",
        f"DUSt3R at Dust3rConfig() (random weights from the seed, heads' last bias {DUST3R_HEAD_BIAS}; the "
        f".pth written in {ckpt_s:.1f} s): 6 train views 512x384, {len(pair_ms)} batches of up to 4 of the 30 "
        f"pairs, pair forward ms median {statistics.median(pair_ms) / 4:.1f} a pair ({statistics.median(pair_ms):.1f} "
        f"a batch of 4, first {pair_ms[0]:.1f}); alignment (300 iterations, presets) {align_ms[0] / 1e3:.2f} s; "
        f"cloud CLI {cloud_s:.1f} s; {n_pts} points (conf > 3; conf 5/50/95 pct "
        f"{np.percentile(conf, 5):.2f}/{np.percentile(conf, 50):.2f}/{np.percentile(conf, 95):.2f}); peak "
        f"allocated {peak_gb:.2f} GB; no kernel launched",
        f"train_baseline from the cloud: {GEOM_ITERS} iterations {train_s:.1f} s, {trainer.state.num_gaussians} "
        f"Gaussians, launches {launches} ({n_test} test views)",
    ] + [aligner_known_answer(dev, gt_params, scene)]


def geometry_append(dev, work: Path, step_ms_5c, total: dict) -> list:
    """9b: phase 5c's guided trainer (the oracle) with DPT-large at
    DPTConfig() (random weights from the seed) as the depth estimator and
    append_pcd_from_video_diffusion: one event with the lift and
    add_points, then GUIDED_TRAINER_STEPS guided steps. The frozen
    baseline and the trained state are the noisy room with a hole: its
    Gaussians within APPEND_HOLE of the surface point at the centre of each
    train view (that view's depth times APPEND_HOLE) removed, as a
    sparse-view baseline leaves regions unobserved (the whole room leaves
    no pixel below alpha 0.9). The event's trajectory is the loop2 preset
    (use_trajectory_pool off), which circles that centre point."""
    gt, pcams, full = dense_room(dev)
    views = train_views(gt, pcams, dev)
    keep = torch.ones(N_SCENE, dtype=torch.bool, device=dev)
    xyz = full.xyz.detach()
    for cam in views.cams:
        w2c = np.asarray(cam.world_view_transform).T
        c2w = np.linalg.inv(w2c)
        h, w = cam.image_height, cam.image_width
        depth = float(eval_render(full, cam.raster_camera(dev), torch.zeros(3, device=dev), 3).depth[h // 2, w // 2])
        centre = torch.from_numpy((c2w[:3, 3] + depth * c2w[:3, 2]).astype(np.float32)).to(dev)
        keep &= torch.linalg.norm(xyz - centre, dim=1) > APPEND_HOLE * depth
    params = G.GaussianParams(**{k: v[keep].clone() for k, v in full.tensors().items()})
    del full
    npz = work / "gt_gaussians_9b.npz"
    synthetic.write_gt_npz(str(npz), gt)
    cols = np.clip(SH2RGB(gt["features_dc"][:, 0]), 0, 1).astype(np.float32)
    pcd_pts, pcd_cols = synthetic.init_cloud(gt["xyz"], cols, N_SCENE, np.random.default_rng(SEED + 5))
    t0 = time.perf_counter()
    dcfg = dpt.DPTConfig()
    estimator = dpt.make_depth_estimator(dpt.params_to_device(dpt.init_dpt_params(dcfg, SEED + 22), dev), dcfg)
    dpt_init_s = time.perf_counter() - t0
    dpt_ms = []

    def timed_estimator(frames):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = estimator(frames)
        torch.cuda.synchronize()
        dpt_ms.append((time.perf_counter() - t) * 1e3)
        return out

    frozen = FrozenRenderer(params, 3)
    engine = OracleDiffusionEngine(str(npz), EVENT_FRAMES, HEIGHT, WIDTH, device=dev)
    state = G.GaussianState.fresh(G.GaussianParams(**{k: v.clone() for k, v in params.tensors().items()}))
    last = GUIDED_TRAINER_STEPS + 1
    opt = OptimizationParams(iterations=10 * last, start_sample_pseudo=0, end_sample_pseudo=10 * last,
                             guidance_vd_iter=10 * last, densify_from_iter=10 * last,
                             densify_until_iter=10 * last, append_pcd_from_video_diffusion=True,
                             use_trajectory_pool=False)
    trainer = GuidedTrainer(views, state, opt, PipelineParams(), ModelParams(), frozen, engine, pcd_pts, pcd_cols,
                            guidance_intrinsic(views.cams[0]), depth_estimator=timed_estimator)
    frames = {}
    count_renders(frozen, frames, "frozen")
    count_renders(engine.renderer, frames, "oracle")
    trainer.init_view_geometry()
    pool_frames = dict(frames)
    n0 = trainer.state.num_gaussians
    _build.reset_launches()
    trainer.run_diffusion_event(1)
    added = trainer.state.num_gaussians - n0
    unobserved = [int(c.mask.sum()) for c in trainer.pseudo_stack]
    if trainer.points_added != added or added <= 0 or len(dpt_ms) != 1:
        raise AssertionError(f"9b: {added} Gaussians added, points_added {trainer.points_added}, "
                             f"{len(dpt_ms)} DPT calls; unobserved pixels of the event's frames {unobserved}")
    step_ms, losses, _, _ = run_steps(trainer, last, range(-1, 0), first=2)  # none traced
    launches = add_launches(total)
    renders, chains = (a - b for a, b in zip(frames_and_chains(frames), frames_and_chains(pool_frames)))
    want = launches_of(GUIDED_TRAINER_STEPS, GUIDED_TRAINER_STEPS, renders, chains)
    if any(launches[n] != want[n] for n in GAUSSIAN_KERNELS) or not all(math.isfinite(float(v)) for v in losses):
        raise AssertionError(f"9b: launches {launches}, expected {want}; losses {[float(v) for v in losses]}")
    ms = statistics.median(list(step_ms.values())[1:])
    return [f"append path (phase 5b's room with a hole at each train view's centre: {params.num_gaussians} of "
            f"{N_SCENE} Gaussians; the oracle; the loop2 trajectory; DPT-large random weights from the seed, "
            f"init {dpt_init_s:.1f} s): one event of {EVENT_FRAMES} frames, DPT on the {EVENT_FRAMES} frames "
            f"{dpt_ms[0]:.1f} ms, the lift (DPT, scale-shift fit, unprojection, add_points) "
            f"{trainer.event_phase_s['lift']:.3f} s, {added} Gaussians added ({n0} -> {trainer.state.num_gaussians}; "
            f"unobserved pixels of frames 1-{EVENT_FRAMES - 1} min {min(unobserved)} max {max(unobserved)})",
            f"{GUIDED_TRAINER_STEPS} guided steps after it: step ms median {ms:.3f} (host clock, synchronised; "
            f"5c's at {n0}: {step_ms_5c}); loss {float(losses[0]):.5f} -> {float(losses[-1]):.5f}; "
            f"launches {launches}"]


def geometry_multicond(dev) -> list:
    """9c: one ViewCrafterEngine.generate with multiple_cond_cfg at phase
    7b's widths in bf16, GEN_STEPS steps: L1 exactly 15 a step (5 level-0
    attentions x 3 branches) + 2."""
    mcfg = LatentDiffusionConfig(compute_dtype="bfloat16")
    scfg = synthesis.SynthesisConfig(ddim_steps=GEN_STEPS, multiple_cond_cfg=True, cfg_img=MULTICOND_CFG_IMG)
    params, _ = gen_params(dev)
    engine = ViewCrafterEngine(params, mcfg, scfg, video_length=GEN_FRAMES, height=GEN_H, width=GEN_W)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    renders = torch.rand((GEN_FRAMES, GEN_H, GEN_W, 3), generator=gen, device=dev)
    model_ms, update_ms = [], []
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with timed(ddim_multicond, "multicond_model_output", model_ms), timed(ddim_multicond, "ddim_step", update_ms):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        video = engine.generate(renders, no_guidance=True, generator=gen)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = 15 * GEN_STEPS + 2
    if launches["flash_attn_fwd"] != expected or any(launches[n] for n in GAUSSIAN_KERNELS + L1_BWD_KERNELS):
        raise AssertionError(f"9c: launches {launches}; L1 expected {expected}")
    if tuple(video.shape) != (GEN_FRAMES, 3, GEN_H, GEN_W) or not bool(torch.isfinite(video).all()):
        raise AssertionError(f"9c: bad video {tuple(video.shape)}")
    step_ms = [m + u for m, u in zip(model_ms, update_ms)]
    return [launches, f"two-scale CFG request ({GEN_FRAMES}x{GEN_H}x{GEN_W}, bf16, {GEN_STEPS} steps, cfg_img "
            f"{MULTICOND_CFG_IMG}): DDIM step ms median {statistics.median(step_ms):.1f} (first {step_ms[0]:.1f}, "
            f"min {min(step_ms):.1f}; three branches {statistics.median(model_ms):.1f}) | total {total_s:.3f} s | "
            f"peak allocated {peak_gb:.2f} GB | L1 launches {launches['flash_attn_fwd']} (expected {expected}) | "
            f"video std {float(video.std()):.4f}"]


def geometry_nan_and_gui(dev, work: Path, total: dict) -> list:
    """9d: a NaN planted during iteration 7 of train_baseline --nan_debug
    (densification_interval 5) on the 9a scene stops the run with its
    bundle; a NetworkGUI on localhost answers one 640x480 view of the room
    through K1/K3/K4, byte for byte the renderer's."""
    scene = work / "Replica" / REPLICA_SCENE
    step = BaselineTrainer.step

    def planted(self, iteration):
        out = step(self, iteration)
        if iteration == 7:
            with torch.no_grad():
                self.state.params.xyz[11, 0] = float("nan")
        return out

    mdl = work / "nan_model"
    _build.reset_launches()
    with mock.patch.object(BaselineTrainer, "step", planted):
        try:
            port_train_cli.main(["-s", str(scene), "-m", str(mdl), "--dataset", "replica", "--images", "rgb",
                                 "--eval", "--n_views", "6", "--iterations", "20", "--densification_interval", "5",
                                 "--test_iterations", "20", "--save_iterations", "20", "--nan_debug"])
        except RuntimeError as e:
            halted = str(e)
        else:
            raise AssertionError("9d: the planted NaN did not stop the run")
    bundle = json.loads((mdl / "nan_5_7.json").read_text())
    snap, it0 = load_checkpoint(str(mdl / "nan_5_7.ckpt"), dev)
    if [s["iteration"] for s in bundle["schedule"]] != [6, 7] or it0 != 5 \
            or not bool(torch.isfinite(snap.params.xyz).all()):
        raise AssertionError(f"9d: bundle {bundle}, snapshot at {it0}")
    nan_launches = add_launches(total)

    params = G.GaussianParams.from_ply(str(work / "geometry_model" / "point_cloud" / f"iteration_{GEOM_ITERS}"
                                         / "point_cloud.ply"), dev)
    render = network_gui.gaussian_render_fn(params, 3)
    c2w = synthetic.orbit(N_CAMS, WIDTH, HEIGHT, HFOV, None)[0][3]
    view = np.linalg.inv(c2w).T.astype(np.float32)  # the transposed layout
    fovx = math.radians(HFOV)
    fovy = 2 * math.atan(math.tan(fovx / 2) * HEIGHT / WIDTH)
    proj = view @ graphics.getProjectionMatrix(0.01, 100.0, fovx, fovy).T.astype(np.float32)
    sent = {"resolution_x": WIDTH, "resolution_y": HEIGHT, "train": False, "fov_y": fovy, "fov_x": fovx,
            "z_near": 0.01, "z_far": 100.0, "shs_python": False, "rot_scale_python": False, "keep_alive": True,
            "scaling_modifier": 1.0}
    for key, m in (("view_matrix", view), ("view_projection_matrix", proj)):
        m = m.copy()
        m[:, 1:3] *= -1  # the viewer negates these columns
        sent[key] = [float(x) for x in m.flatten()]
    gui = network_gui.NetworkGUI(port=0)
    got = {}

    def client():
        with socket.create_connection(("127.0.0.1", gui.listener.getsockname()[1]), timeout=30) as c:
            payload = json.dumps(sent).encode()
            c.sendall(len(payload).to_bytes(4, "little") + payload)
            img = b""
            while len(img) < WIDTH * HEIGHT * 3:
                img += c.recv(WIDTH * HEIGHT * 3 - len(img))
            n = int.from_bytes(c.recv(4), "little")
            got["img"], got["verify"] = img, c.recv(n).decode()

    seen = {}

    def render_fn(cam, scaling):
        seen["cam"] = cam
        return render(cam, scaling)

    th = threading.Thread(target=client, daemon=True)
    _build.reset_launches()
    try:
        th.start()
        for _ in range(500):
            if gui.try_connect():
                break
            time.sleep(0.01)
        t0 = time.perf_counter()
        gui.serve_once(render_fn, str(scene), training=False)
        serve_ms = (time.perf_counter() - t0) * 1e3
        th.join(timeout=30)
    finally:
        gui.close()
    gui_launches = add_launches(total)
    want = {n: 1 if n in FORWARD_KERNELS else 0 for n in GAUSSIAN_KERNELS}
    if th.is_alive() or any(gui_launches[n] != want[n] for n in GAUSSIAN_KERNELS):
        raise AssertionError(f"9d: the GUI round trip ({'hung' if th.is_alive() else 'done'}) launched "
                             f"{gui_launches}, expected {want}")
    img = np.clip(render(seen["cam"], 1.0) * 255, 0, 255).astype(np.uint8).transpose(1, 2, 0).tobytes()
    if got.get("img") != img or got.get("verify") != str(scene) or len(set(img)) < 10:
        raise AssertionError("9d: the GUI's answer is not the renderer's image of the view")
    return [f"--nan_debug: the NaN planted in iteration 7 stopped the run ({halted[:60]}...), bundle nan_5_7 "
            f"(snapshot at {it0}, schedule {[s['iteration'] for s in bundle['schedule']]}); launches {nan_launches}",
            f"NetworkGUI round trip on localhost: one {WIDTH}x{HEIGHT} view of the 9a model "
            f"({params.num_gaussians} Gaussians) answered in {serve_ms:.1f} ms (render, bytes, send), the "
            f"renderer's image byte for byte; launches {gui_launches}"]


def phase_geometry(dev, work: Path, step_ms_5c=None):
    """Phase 9 (see the module's docstring). Returns its launches."""
    total = {}
    lines = geometry_init_chain(dev, work, total)
    for line in lines:
        log("phase 9a " + line)
    shown_5c = "not run in this call" if step_ms_5c is None else f"{step_ms_5c:.3f} in this call"
    for line in geometry_append(dev, work, shown_5c, total):
        log("phase 9b " + line)
    l1, line = geometry_multicond(dev)
    total["flash_attn_fwd"] = total.get("flash_attn_fwd", 0) + l1["flash_attn_fwd"]
    log("phase 9c " + line)
    for line in geometry_nan_and_gui(dev, work, total):
        log("phase 9d " + line)
    return {n: total.get(n, 0) for n in KERNELS}


# ----------------------------------------------------------------------------
# phase 10: pipelined events and the camera-batch step
# ----------------------------------------------------------------------------


def event_running(trainer) -> bool:
    """A pipelined event's worker is still at its device work."""
    p = trainer._pending_event
    return p is not None and p.future is not None and not p.future.done()


def pipelined_trainer(views, params, frozen, engine, pcd, K, event_worker: bool, span: int,
                      model_path: str = "") -> GuidedTrainer:
    """Phase 5c's trainer with pipeline_guidance, an event every `span`
    steps from step 1, pseudo views from the first step, no densification."""
    state = G.GaussianState.fresh(G.GaussianParams(**{k: v.clone() for k, v in params.tensors().items()}))
    far = 100 * span
    opt = OptimizationParams(iterations=far, start_sample_pseudo=0, end_sample_pseudo=far, guidance_vd_iter=span,
                             densify_from_iter=far, densify_until_iter=far)
    return GuidedTrainer(views, state, opt, PipelineParams(), ModelParams(model_path=model_path), frozen, engine,
                         pcd[0], pcd[1], K, pipeline_guidance=True, event_worker=event_worker)


def count_step_renders(trainer, counter: dict) -> None:
    """Count the trainer's steps ("steps") and those with a pseudo view
    ("pseudo")."""
    pick = trainer._pick_pseudo

    def counted(it):
        cam = pick(it)
        counter["steps"] = counter.get("steps", 0) + 1
        counter["pseudo"] = counter.get("pseudo", 0) + (cam is not None)
        return cam

    trainer._pick_pseudo = counted


def trainer_bits(trainer) -> dict:
    """Everything a pipelined run leaves that the same run must leave bit
    for bit: the state's tensors, both stacks, the random streams."""
    st = trainer.state
    out = {f"p/{k}": v for k, v in st.params.tensors().items()}
    out.update({f"m/{k}": v for k, v in st.adam_m.items()})
    out.update({f"v/{k}": v for k, v in st.adam_v.items()})
    out.update(max_radii2d=st.max_radii2d, accum=st.xyz_gradient_accum, denom=st.denom)
    for name, stack in (("cur", trainer.pseudo_stack), ("alltime", trainer.pseudo_stack_alltime)):
        out[f"{name}/frames"] = torch.stack([c.pseudo_gt for c in stack])
        out[f"{name}/masks"] = torch.stack([c.mask for c in stack])
    out["generator"] = trainer.generator.get_state()
    out["host"] = (json.dumps(trainer.rng_np.bit_generator.state), trainer.rng.getstate(), trainer.vd_indices,
                   trainer.events_run, st.step)
    return out


def check_same_bits(what: str, a: dict, b: dict) -> None:
    differ = [k for k in a if (not torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] != b[k])]
    if differ:
        raise AssertionError(f"{what}: not bitwise equal in {differ}")


def pipeline_oracle(dev, work: Path, room, pcd) -> tuple[dict, list]:
    """10a: the oracle engine at phase 5c's sizes, PIPE_BOUNDARIES event
    boundaries PIPE_SPAN steps apart and the drain, inline (the lagged order
    on one thread: the serial run), with the worker, and with the worker
    and the trainer on a stream of higher priority. Returns the launches of
    the worker's run and the lines."""
    gt, pcams, params = room
    views = train_views(gt, pcams, dev)
    npz = work / "gt_gaussians_10a.npz"
    synthetic.write_gt_npz(str(npz), gt)
    frozen = FrozenRenderer(params, 3)
    engine = OracleDiffusionEngine(str(npz), EVENT_FRAMES, HEIGHT, WIDTH, device=dev)
    frames = {}
    count_renders(frozen, frames, "frozen")
    count_renders(engine.renderer, frames, "oracle")
    K = guidance_intrinsic(views.cams[0])
    last = (PIPE_BOUNDARIES - 1) * PIPE_SPAN + 1
    runs = {}
    for mode in ("inline", "worker", "worker_prio"):
        trainer = pipelined_trainer(views, params, frozen, engine, pcd, K, mode != "inline", PIPE_SPAN)
        counter = {}
        count_step_renders(trainer, counter)
        frames.clear()
        prio = torch.cuda.Stream(device=dev, priority=-1) if mode == "worker_prio" else None
        if prio is not None:
            prio.wait_stream(torch.cuda.current_stream())
        torch.cuda.synchronize()
        step_ms = {"event": [], "idle": [], "boundary": []}
        span_t = []
        _build.reset_launches()
        with torch.cuda.stream(prio) if prio is not None else contextlib.nullcontext():
            trainer.init_trajectory_pool()
            stream_sync()
            t0 = time.perf_counter()
            for it in range(1, last + 1):
                boundary = (it - 1) % PIPE_SPAN == 0
                busy = event_running(trainer)
                t = time.perf_counter()
                if boundary:
                    span_t.append(t)
                trainer.step(it)
                stream_sync()
                step_ms["boundary" if boundary else ("event" if busy else "idle")].append(
                    (time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            trainer.close_event_worker()
            stream_sync()
            t_end = time.perf_counter()
        if prio is not None:
            torch.cuda.current_stream().wait_stream(prio)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        want = launches_of(counter["steps"], counter["pseudo"], *frames_and_chains(frames))
        if any(launches[n] != want[n] for n in GAUSSIAN_KERNELS) or any(
                launches[n] for n in ("flash_attn_fwd",) + L1_BWD_KERNELS):
            raise AssertionError(f"10a {mode}: launches {launches}, expected {want}: a chain a step "
                                 f"({counter}), K1 once more a frozen or oracle frame, K3 and K4 a chain of "
                                 f"them ({frames})")
        if trainer.events_run != PIPE_BOUNDARIES or len(trainer.pseudo_stack) != EVENT_FRAMES - 1 \
                or trainer._executor is not None:
            raise AssertionError(f"10a {mode}: {trainer.events_run} events, stack {len(trainer.pseudo_stack)}")
        runs[mode] = dict(bits=trainer_bits(trainer), spans=[b - a for a, b in zip(span_t, span_t[1:] + [t])],
                          drain=t_end - t, total=t_end - t0, step_ms=step_ms, wait=trainer.event_wait_s,
                          phases=dict(trainer.event_phase_s), launches=launches, frames=dict(frames))
        del trainer
    for mode in ("worker", "worker_prio"):
        check_same_bits(f"10a {mode} against inline", runs[mode]["bits"], runs["inline"]["bits"])
    med = lambda xs: statistics.median(xs) if xs else float("nan")  # noqa: E731
    lines = [f"the oracle engine at phase 5c's sizes ({N_SCENE} Gaussians frozen, {EVENT_FRAMES}-frame events, "
             f"{WIDTH}x{HEIGHT}, 6 train views), pipeline_guidance: boundaries every {PIPE_SPAN} steps at 1, "
             f"{PIPE_SPAN + 1}, {last}, then the drain; inline (the same order on one thread, serial), worker, "
             f"worker with the trainer on a priority -1 stream: state, stacks and random streams bitwise equal "
             f"across the three"]
    for mode, r in runs.items():
        sm = r["step_ms"]
        lines.append(
            f"{mode}: spans s " + ", ".join(f"{x:.3f}" for x in r["spans"]) + f" (the last: the third boundary "
            f"step), drain {r['drain']:.3f} s, total {r['total']:.3f} s; finalize waited {r['wait']:.3f} s; "
            f"step host ms median while an event runs {med(sm['event']):.3f} ({len(sm['event'])} steps), while "
            f"none does {med(sm['idle']):.3f} ({len(sm['idle'])}), boundary steps "
            + ", ".join(f"{x:.1f}" for x in sm["boundary"]) + "; event s " + ", ".join(
                f"{k} {v:.3f}" for k, v in r["phases"].items() if v) + f"; frames {r['frames']}; launches "
            f"{ {n: r['launches'][n] for n in GAUSSIAN_KERNELS} }")
    serial, over = runs["inline"]["total"], runs["worker"]["total"]
    lines.append(f"overlap: {last} steps and {PIPE_BOUNDARIES} events {serial:.3f} s serial (inline), {over:.3f} s "
                 f"with the worker ({serial - over:.3f} s hidden), {runs['worker_prio']['total']:.3f} s with the "
                 "trainer's stream at priority -1")
    return runs["worker"]["launches"], lines


def pipeline_viewcrafter(dev, work: Path, room, pcd) -> tuple[dict, list, float]:
    """10b: the ViewCrafter engine at 7b's widths (random bf16 weights,
    GUIDED_STEPS guided steps) in phase 5c's trainer with the worker: a
    first event alone (warm-up), a second alone (nothing steps beside it),
    then one with the trainer's steps beside it on the same card until its
    worker is done, on the default stream and on a stream of priority -1,
    each followed by PIPE_IDLE_STEPS steps without an event. Returns the
    launches, the lines and the guided step's ms alone."""
    gt, pcams, params = room
    views = train_views(gt, pcams, dev)
    frozen = FrozenRenderer(params, 3)
    gparams, _ = gen_params(dev)
    mcfg = LatentDiffusionConfig(compute_dtype="bfloat16")
    width = port_guided_cli.engine_width(OptimizationParams(), HEIGHT, WIDTH)
    engine = ViewCrafterEngine(gparams, mcfg, synthesis.SynthesisConfig(ddim_steps=GUIDED_STEPS),
                               video_length=EVENT_FRAMES, height=GEN_H, width=width)
    trainer = pipelined_trainer(views, params, frozen, engine, pcd, guidance_intrinsic(views.cams[0]), True,
                                10 ** 6)
    frames, counter = {}, {}
    count_renders(frozen, frames, "frozen")
    count_step_renders(trainer, counter)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    trainer.init_trajectory_pool()
    alone_s, alone_ms = [], []
    for it in (1, 2):
        ms = []
        with timed(ddim_guidance, "guided_step", ms):
            t = time.perf_counter()
            trainer.finalize_diffusion_event(trainer.submit_diffusion_event(it))
            stream_sync()
            alone_s.append(time.perf_counter() - t)
        alone_ms.append(ms)
    step_alone = statistics.median(alone_ms[1])
    it = 2
    beside = {}
    for name, prio in (("default stream", None), ("priority -1", torch.cuda.Stream(device=dev, priority=-1))):
        r = dict(step_ms=[], during=[], idle=[])
        wait0 = trainer.event_wait_s
        if prio is not None:
            prio.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(prio) if prio is not None else contextlib.nullcontext():
            with timed(ddim_guidance, "guided_step", r["step_ms"]):
                it += 1
                t0 = time.perf_counter()
                pending = trainer.submit_diffusion_event(it)
                while not pending.future.done():
                    it += 1
                    t = time.perf_counter()
                    trainer.step(it)
                    stream_sync()
                    r["during"].append((time.perf_counter() - t) * 1e3)
                trainer.finalize_diffusion_event(pending)
                stream_sync()
                r["event_s"] = time.perf_counter() - t0
            for _ in range(PIPE_IDLE_STEPS):
                it += 1
                t = time.perf_counter()
                trainer.step(it)
                stream_sync()
                r["idle"].append((time.perf_counter() - t) * 1e3)
        if prio is not None:
            torch.cuda.current_stream().wait_stream(prio)
        r["wait"] = trainer.event_wait_s - wait0
        beside[name] = r
    trainer.close_event_worker()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(_build.LAUNCHES)
    fwd, bwd = guided_launches(mcfg.unet, GUIDED_STEPS, GEN_FRAMES, DECODE_CHUNK)
    events = 2 + len(beside)
    want = launches_of(counter["steps"], counter["pseudo"], frames["frozen"], frames["frozen_chains"])
    want.update(flash_attn_fwd=events * (fwd + 2), flash_attn_bwd_dkv=events * bwd, flash_attn_bwd_dq=events * bwd)
    if launches != want:
        raise AssertionError(f"10b: launches {launches}, expected {want}: {events} events' L1 and frozen frames, "
                             f"a chain a step")
    if trainer.events_run != events or not all(r["during"] for r in beside.values()) or peak_gb >= 80.0:
        raise AssertionError(f"10b: {trainer.events_run} events, steps beside "
                             f"{[len(r['during']) for r in beside.values()]}, peak {peak_gb:.2f} GB")
    video = torch.stack([c.pseudo_gt for c in trainer.pseudo_stack])
    if not bool(torch.isfinite(video).all()) or float(video.min()) < 0.0 or float(video.max()) > 1.0:
        raise AssertionError("10b: the event's frames are not finite values in [0, 1]")
    lines = [
        f"the ViewCrafter engine ({EVENT_FRAMES}x{GEN_H}x{width} bf16, random weights, {GUIDED_STEPS} guided DDIM "
        f"steps) in phase 5c's trainer ({N_SCENE} Gaussians), pipeline_guidance with the worker: event alone "
        f"{alone_s[1]:.3f} s (warm-up event {alone_s[0]:.3f} s), guided DDIM step ms alone "
        + ", ".join(f"{x:.1f}" for x in alone_ms[1]) + f" (median {step_alone:.1f})"]
    for name, r in beside.items():
        during, idle = statistics.median(r["during"]), statistics.median(r["idle"])
        # the same work one after the other: the event alone, then the steps at their idle pace
        serial = alone_s[1] + len(r["during"]) * idle / 1e3
        lines.append(
            f"beside the trainer on the {name}: event {r['event_s']:.3f} s to its finalize, guided DDIM step ms "
            + ", ".join(f"{x:.1f}" for x in r["step_ms"]) + f" (median {statistics.median(r['step_ms']):.1f}, "
            f"{statistics.median(r['step_ms']) / step_alone:.3f}x alone); {len(r['during'])} trainer steps meanwhile, "
            f"host ms median {during:.3f} (max {max(r['during']):.1f}) against {idle:.3f} with no event "
            f"({PIPE_IDLE_STEPS} steps after; {during / idle:.3f}x); the same work serial {serial:.3f} s, so "
            f"{serial - r['event_s']:.3f} s hidden; finalize waited {r['wait']:.3f} s")
    lines.append(
        f"peak allocated (engine weights, trainer state, stacks, the guided steps beside the trainer's): "
        f"{peak_gb:.2f} GB of 80; launches {launches} (exactly: L1 {fwd + 2} / {bwd} / {bwd} an event, "
        f"frozen frames {frames['frozen']} in {frames['frozen_chains']} chains, steps {counter})")
    del trainer, engine, gparams
    torch.cuda.empty_cache()
    return launches, lines, step_alone


@contextlib.contextmanager
def plain_gaussian_kernels():
    """The rasterizer's kernel wrappers routed to their plain versions on
    the card (the comparison of 10c; nothing on the main path does so)."""
    bin_gaussians = tiling.bin_gaussians
    with mock.patch.object(preprocess_fused, "preprocess_fused_fwd", preprocess_fused.preprocess_table_plain), \
            mock.patch.object(preprocess_fused, "preprocess_fused_bwd", preprocess_fused.preprocess_fused_bwd_plain), \
            mock.patch.object(raster_tiles, "_run_fwd", raster_tiles.blend_fwd_plain), \
            mock.patch.object(raster_tiles, "_run_bwd", raster_tiles.blend_bwd_plain), \
            mock.patch.object(segsum, "segment_sum_sorted", segsum.segment_sum_sorted_plain), \
            mock.patch.object(tiling, "bin_gaussians",
                              functools.partial(bin_gaussians, expand_fn=expand.expand_instances_plain)):
        yield


def pipeline_dp(dev, room) -> tuple[dict, list]:
    """10c: `train_step_dp` of the 6 train views at phase 5b's room (1M
    Gaussians, SH 3): DP_STEPS steps on the main path (each of K1-K6
    exactly 6 times a step), then one step without Adam from the same state
    through the kernels and through their plain versions."""
    gt, pcams, params = room
    views = train_views(gt, pcams, dev)
    cams = stack_cameras([c.raster_camera(dev) for c in views.cams])
    gts = torch.stack([torch.from_numpy(np.ascontiguousarray(c.image, np.float32)) for c in views.cams]).to(dev)
    bg = torch.zeros(3, device=dev)
    opt = OptimizationParams()
    lrs = lrs_for(opt, opt.position_lr_init * views.cameras_extent)

    def fresh():
        return G.GaussianState.fresh(G.GaussianParams(**{k: v.clone() for k, v in params.tensors().items()}))

    state = fresh()
    torch.cuda.synchronize()
    _build.reset_launches()
    ms, losses = [], []
    for _ in range(DP_STEPS):
        t = time.perf_counter()
        m = train_step_dp(state, cams, gts, bg, lrs, 3, opt.lambda_dssim)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
    launches = dict(_build.LAUNCHES)
    b = len(views.cams)
    if any(launches[n] != b * DP_STEPS for n in GAUSSIAN_KERNELS) or any(
            launches[n] for n in ("flash_attn_fwd",) + L1_BWD_KERNELS):
        raise AssertionError(f"10c: launches {launches}: each of K1-K6 exactly {b} a step ({DP_STEPS} steps)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"10c: losses {losses}")
    # against the plain chain: six renders and the mean through the plain versions
    a, p = fresh(), fresh()
    ma = train_step_dp(a, cams, gts, bg, lrs, 3, opt.lambda_dssim, apply_adam=False)
    before = dict(_build.LAUNCHES)
    with plain_gaussian_kernels():
        torch.cuda.synchronize()
        t = time.perf_counter()
        mp = train_step_dp(p, cams, gts, bg, lrs, 3, opt.lambda_dssim, apply_adam=False)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
    if dict(_build.LAUNCHES) != before:
        raise AssertionError("10c: the plain chain launched a kernel")
    errs = {}
    for name in G.PARAM_NAMES:
        g, w = getattr(a.params, name).grad, getattr(p.params, name).grad
        errs[name] = float((g - w).norm() / w.norm().clamp_min(1e-30))
    errs["accum"] = float((a.xyz_gradient_accum - p.xyz_gradient_accum).norm()
                          / p.xyz_gradient_accum.norm().clamp_min(1e-30))
    loss_err = abs(float(ma["loss"]) - float(mp["loss"]))
    rows = {k: int((getattr(a, k) != getattr(p, k)).flatten().sum()) for k in ("denom", "max_radii2d")}
    if max(errs.values()) > DP_GRAD_TOL or loss_err > DP_LOSS_TOL \
            or max(rows.values()) > DP_ROW_FRACTION * a.num_gaussians:
        raise AssertionError(f"10c against the plain chain: gradient errors {errs} (tol {DP_GRAD_TOL}), loss "
                             f"{float(ma['loss'])} vs {float(mp['loss'])} (tol {DP_LOSS_TOL}), rows differing "
                             f"{rows} (at most {DP_ROW_FRACTION} of {a.num_gaussians})")
    lines = [
        f"train_step_dp of the {b} train views ({N_SCENE} Gaussians, SH 3, {WIDTH}x{HEIGHT}): step host ms "
        + ", ".join(f"{x:.2f}" for x in ms) + f"; loss {losses[0]:.5f} -> {losses[-1]:.5f}; launches "
        f"{ {n: launches[n] for n in GAUSSIAN_KERNELS} } (exactly {b} a step)",
        f"against its plain chain (the same step without Adam, {b} renders through the plain versions, "
        f"{plain_ms:.1f} ms): loss {float(ma['loss']):.7f} vs {float(mp['loss']):.7f} (|err| {loss_err:.2e}, tol "
        f"{DP_LOSS_TOL}), gradients' error in L2 norm over the plain's " + ", ".join(f"{k} {v:.2e}" for k, v in
                                                                         errs.items())
        + f" (tol {DP_GRAD_TOL}); rows of denom / max radii differing {rows['denom']} / {rows['max_radii2d']}",
    ]
    return launches, lines


def pipeline_cli(dev, work: Path, src: Path, base: Path) -> dict:
    """10d: train_guidedvd --pipeline_guidance with the oracle on phase 6's
    scene and baseline, PIPE_CLI_ITERS iterations, an event every
    PIPE_CLI_EVERY, a checkpoint while an event is in flight; launches
    exact (the steps' renders and the FrozenRenderer frames counted, the
    evaluation's views); then the ViewCrafter CLI of 6c with the flag."""
    mdl = work / "synthetic_guided_pipelined"
    counts = {"steps": 0, "pseudo": 0, "frames": 0, "chains": 0, "submitted": 0}
    pick, submit = GuidedTrainer._pick_pseudo, GuidedTrainer.submit_diffusion_event
    render, render_many = FrozenRenderer.render, FrozenRenderer.render_many

    def counted_pick(self, it):
        cam = pick(self, it)
        counts["steps"] += 1
        counts["pseudo"] += cam is not None
        return cam

    def counted_render(self, *args, **kwargs):
        counts["frames"] += 1
        counts["chains"] += 1
        return render(self, *args, **kwargs)

    def counted_many(self, w2cs, *args, **kwargs):
        counts["frames"] += len(w2cs)
        counts["chains"] += chains_of(len(w2cs))
        return render_many(self, w2cs, *args, **kwargs)

    def counted_submit(self, it):
        pending = submit(self, it)
        counts["submitted"] += pending is not None
        return pending

    ckpt_at = PIPE_CLI_EVERY + PIPE_CLI_EVERY // 2  # the second event in flight
    _build.reset_launches()
    with mock.patch.object(GuidedTrainer, "_pick_pseudo", counted_pick), \
            mock.patch.object(FrozenRenderer, "render", counted_render), \
            mock.patch.object(FrozenRenderer, "render_many", counted_many), \
            mock.patch.object(GuidedTrainer, "submit_diffusion_event", counted_submit):
        t0 = time.perf_counter()
        trainer = port_guided_cli.main([
            "-s", str(src), "-m", str(mdl), "--dataset", "colmap", "--n_views", "6", "--eval",
            "--iterations", str(PIPE_CLI_ITERS), "--test_iterations", str(PIPE_CLI_ITERS),
            "--save_iterations", str(PIPE_CLI_ITERS), "--baseline_path", str(base),
            "--baseline_iteration", str(CLI_ITERS), "--oracle_gt_npz", str(src / "gt_gaussians.npz"),
            "--guidance_vd_iter", str(PIPE_CLI_EVERY), "--start_sample_pseudo", "2",
            "--end_sample_pseudo", str(PIPE_CLI_ITERS - 2), "--checkpoint_iterations", str(ckpt_at),
            "--pipeline_guidance", "--device", dev.type,
        ])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    timing = json.loads((mdl / "timing_summary.json").read_text())
    n_eval = len(trainer.train_cams) + len(trainer.scene.getTestCameras())
    want = launches_of(counts["steps"], counts["pseudo"], counts["frames"] + n_eval, counts["chains"] + n_eval)
    if any(launches[n] != want[n] for n in GAUSSIAN_KERNELS) or trainer.events_run != counts["submitted"] \
            or trainer.events_run < 3 or not timing["pipeline_guidance"] or trainer._executor is not None \
            or not (mdl / f"chkpnt{ckpt_at}.ckpt.guided.npz").exists():
        raise AssertionError(f"10d: launches {launches}, expected {want}; events {trainer.events_run} of "
                             f"{counts['submitted']} submitted; timing {timing}")
    port_render.main(["-m", str(mdl), "--skip_train", "--iteration", str(PIPE_CLI_ITERS), "--device", dev.type])
    port_metrics.evaluate([str(mdl)], device=dev.type)
    res = json.loads((mdl / "results.json").read_text())[f"ours_{PIPE_CLI_ITERS}"]
    if not (math.isfinite(res["PSNR"]) and math.isfinite(res["SSIM"])):
        raise AssertionError(f"10d scores {res}")
    log(f"phase 10d oracle CLI --pipeline_guidance (phase 6's scene and baseline): train_guidedvd "
        f"{PIPE_CLI_ITERS} iterations {train_s:.1f} s (training {timing['train_s']:.3f} s; events "
        + ", ".join(f"{k} {v:.3f}" for k, v in timing["event_phase_s"].items())
        + f" on the worker; finalize waited {timing['event_wait_s']:.3f} s) | events {trainer.events_run}, "
        f"checkpoint at {ckpt_at} with an event in flight | test PSNR {res['PSNR']:.4f} SSIM {res['SSIM']:.5f} | "
        f"launches {launches} (exactly: steps {counts['steps']}, {counts['pseudo']} of them with a pseudo view, "
        f"frozen and oracle frames {counts['frames']} in {counts['chains']} chains, evaluation views {n_eval})")
    vc = phase_vc_cli(dev, work, src, base, extra=("--pipeline_guidance",), tag="10d")
    return {n: launches.get(n, 0) + vc.get(n, 0) for n in KERNELS}


def phase_pipeline(dev, work: Path, cli=None):
    """Phase 10 (see the module's docstring). Returns its launches, and
    the guided DDIM step's ms alone in 10b."""
    room = dense_room(dev)
    gt = room[0]
    rng = np.random.default_rng(SEED + 5)
    cols = np.clip(SH2RGB(gt["features_dc"][:, 0]), 0, 1).astype(np.float32)
    pcd = synthetic.init_cloud(gt["xyz"], cols, N_SCENE, rng)
    total = {}
    launches, lines = pipeline_oracle(dev, work, room, pcd)
    for line in lines:
        log("phase 10a " + line)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    launches, lines, step_alone = pipeline_viewcrafter(dev, work, room, pcd)
    for line in lines:
        log("phase 10b " + line)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    launches, lines = pipeline_dp(dev, room)
    for line in lines:
        log("phase 10c " + line)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    del room
    if cli is None:  # phase 6's scene and baseline, made here when phase 6 did not run
        cli = phase_cli(dev, work)[:2]
    for k, v in pipeline_cli(dev, work, *cli).items():
        total[k] = total.get(k, 0) + v
    return {n: total.get(n, 0) for n in KERNELS}, step_alone


# phase 11: the B-camera chain at full width. 11 cameras of 640x480 make
# 11 x 1,200 tiles, past K3's shared histogram of 12,288 bins
MULTI_BATCHES = (2, 5, 11)
MULTI_GRAD_BATCHES = (2, 5)
K3_HIST_CAP = 12288
# the chain's gradients against the sum of B single renders' (the same
# per-camera K2 outputs added in the same camera order): max abs error
# over max |grad| of each input
MULTI_GRAD_TOL = 1e-5
# the chain against itself on the plain versions: each gradient's error in
# L2 norm over the plain's (10c's DP_GRAD_TOL, for the same reasons); a K2
# that overwrote instead of adding would leave the last camera's gradients
# alone, an error of |sum of the other cameras'| / |sum|, which must exceed it
MULTI_PLAIN_GRAD_TOL = DP_GRAD_TOL
MULTI_STEPS = 8  # guided steps a timed block; blocks per-view, chain, chain, per-view
MULTI_CLOUD = N_SCENE // 10  # the event's point cloud (its splat is not this phase's subject)


def per_view_multi(params, cams, bg, active_sh_degree, means2d_offset=None, confidence=None,
                   use_confidence=False, backend="auto", **_):
    """render_gaussians_multi's result from one render_gaussians a camera:
    the guided step's renders before the chain, kept here as its yardstick
    (the two renders' fields are stacked: two small copies a field)."""
    outs = [render_gaussians(params, cam, bg, active_sh_degree, means2d_offset=means2d_offset[c],
                             confidence=confidence, use_confidence=use_confidence, backend=backend)
            for c, cam in enumerate(cams)]
    return RenderResult(*(torch.stack(x) for x in zip(*(o[:5] for o in outs))),
                        sum(o.num_instances for o in outs))


def multi_against_singles(dev, acts, cams, bg, grads: bool) -> dict:
    """One chain of `cams` against their single renders: the images and
    radii bitwise, the chain's launches exactly (K1 a camera, K3 and K4
    once; backward K5 and K6 once, K2 a camera), the forward's ms both ways;
    with `grads`, the gradients of a fixed random loss both ways, and the
    chain's images, radii and gradients against the same chain on the
    plain versions."""
    b = len(cams)
    n = acts[0].shape[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + b)
    wc = torch.randn((b, 3, HEIGHT, WIDTH), generator=gen, device=dev)
    wd = torch.randn((b, HEIGHT, WIDTH), generator=gen, device=dev) * 0.1
    wa = torch.randn((b, HEIGHT, WIDTH), generator=gen, device=dev)

    def leaves():
        flat = [t.detach().clone().requires_grad_(grads) for t in acts[:4] + acts[4]]
        return flat[:4] + [tuple(flat[4:])]

    lv = leaves()
    off = torch.zeros((b, n, 2), device=dev, requires_grad=grads)
    _build.reset_launches()
    chain = raster_tiles.rasterize_tiles_multi(*lv, cams, bg, means2d_offset=off)
    fwd = dict(_build.LAUNCHES)
    want = launches_of(frames=b, chains=1)
    if any(fwd[k] != want[k] for k in GAUSSIAN_KERNELS):
        raise AssertionError(f"11a B={b}: forward launches {fwd}, expected {want}")
    out = dict(cameras=b, tiles=b * ((WIDTH + 15) // 16) * ((HEIGHT + 15) // 16),
               instances=chain.num_instances)
    differ = []
    with torch.no_grad():
        singles = [raster_tiles.rasterize_tiles(*acts, cam, bg) for cam in cams]
    for c, one in enumerate(singles):
        for name in ("color", "depth", "alpha", "radii"):
            if not torch.equal(getattr(chain, name)[c], getattr(one, name)):
                differ.append(f"{name}[{c}]")
    if differ or chain.num_instances != sum(o.num_instances for o in singles):
        raise AssertionError(f"11a B={b}: the chain's forward is not bitwise its single renders in {differ}; "
                             f"instances {chain.num_instances} against {[o.num_instances for o in singles]}")
    with torch.no_grad():
        out["chain_fwd_ms"] = median_ms(lambda: raster_tiles.rasterize_tiles_multi(*acts, cams, bg), runs=5)
        out["singles_fwd_ms"] = median_ms(lambda: [raster_tiles.rasterize_tiles(*acts, c, bg) for c in cams],
                                          runs=5)
    if not grads:
        return out

    def loss(color, depth, alpha, cams=slice(None)):
        return (color * wc[cams]).sum() + (depth * wd[cams]).sum() + (alpha * wa[cams]).sum()

    _build.reset_launches()
    loss(chain.color, chain.depth, chain.alpha).backward()
    bwd = dict(_build.LAUNCHES)
    want = {"preprocess_fwd": 0, "expand": 0, "blend_fwd": 0, "blend_bwd": 1, "segsum": 1, "preprocess_bwd": b}
    if any(bwd[k] != want[k] for k in GAUSSIAN_KERNELS):
        raise AssertionError(f"11a B={b}: backward launches {bwd}, expected {want}")
    got = [t.grad for t in lv[:4] + list(lv[4])] + [off.grad]
    ls = leaves()
    offs = [torch.zeros((n, 2), device=dev, requires_grad=True) for _ in cams]
    rs = [raster_tiles.rasterize_tiles(*ls, cam, bg, means2d_offset=o) for cam, o in zip(cams, offs)]
    # the cameras before the last first: what an overwriting K2 would lose
    loss(torch.stack([r.color for r in rs[:-1]]), torch.stack([r.depth for r in rs[:-1]]),
         torch.stack([r.alpha for r in rs[:-1]]), slice(0, b - 1)).backward()
    lost = [t.grad.clone() for t in ls[:4] + list(ls[4])]
    loss(rs[-1].color[None], rs[-1].depth[None], rs[-1].alpha[None], slice(b - 1, b)).backward()
    ref = [t.grad for t in ls[:4] + list(ls[4])] + [torch.stack([o.grad for o in offs])]
    names = ("means", "scales", "rotations", "opacity", "features_dc", "features_rest", "offsets")
    errs = {k: float((g - r).abs().max() / r.abs().max().clamp(min=1e-30)) for k, g, r in zip(names, got, ref)}
    if not all(math.isfinite(e) and e <= MULTI_GRAD_TOL for e in errs.values()) \
            or float(ref[-1].abs().max()) == 0.0:
        raise AssertionError(f"11a B={b}: gradient errors {errs} (tol {MULTI_GRAD_TOL})")
    out.update(grad_err=errs, grads_bitwise=[k for k, g, r in zip(names, got, ref) if torch.equal(g, r)])

    # the same chain on the plain versions: K1 into its columns, K3 and the
    # blends over the bands, K2 adding camera by camera
    lp = leaves()
    off_p = torch.zeros((b, n, 2), device=dev, requires_grad=True)
    before = dict(_build.LAUNCHES)
    with plain_gaussian_kernels():
        plain = raster_tiles.rasterize_tiles_multi(*lp, cams, bg, means2d_offset=off_p)
        loss(plain.color, plain.depth, plain.alpha).backward()
    if dict(_build.LAUNCHES) != before:
        raise AssertionError(f"11a B={b}: the plain chain launched a kernel")
    out["plain_img_err"] = {k: check_k4(k, getattr(chain, k), getattr(plain, k))
                            for k in ("color", "depth", "alpha")}
    out["plain_radii_differ"] = int((chain.radii != plain.radii).sum())
    if out["plain_radii_differ"] > max(10, b * n // 10000):
        raise AssertionError(f"11a B={b}: radii differ from the plain chain's on {out['plain_radii_differ']} "
                             f"of {b * n}")
    plain_g = [t.grad for t in lp[:4] + list(lp[4])] + [off_p.grad]
    perr = {k: float((g - p).norm() / p.norm().clamp(min=1e-30)) for k, g, p in zip(names, got, plain_g)}
    overwrite = {k: float(x.norm() / r.norm().clamp(min=1e-30)) for k, x, r in zip(names, lost, ref)}
    if not all(math.isfinite(e) and e <= MULTI_PLAIN_GRAD_TOL for e in perr.values()) \
            or not min(overwrite.values()) > MULTI_PLAIN_GRAD_TOL:
        raise AssertionError(f"11a B={b}: gradients against the plain chain {perr} (tol {MULTI_PLAIN_GRAD_TOL}); "
                             f"an overwriting K2's error {overwrite} must exceed the tolerance")
    out.update(plain_grad_err=perr, overwrite_err=overwrite)
    return out


def phase_multi(dev, work: Path) -> dict:
    """Phase 11: the B-camera chain at full width on phase 5b's room (1M
    Gaussians, SH 3, 640x480). 11a the chain of B = 2, 5 and 11 orbit
    cameras against B single renders (forward bitwise; at B = 2 and 5 the
    gradients within MULTI_GRAD_TOL; B = 11 past K3's shared histogram).
    11b phase 5c's trainer (the oracle, txt trajectories, a point cloud of
    MULTI_CLOUD points): one event's launches (K3 and K4 once a chain of
    FrozenRenderer.GROUP frames), then guided steps with a pseudo view in
    timed blocks of MULTI_STEPS, per-view (each view its own render, as
    before the chain), chain, chain, per-view: launches exactly each step,
    host ms, and one traced step each way (device ms by stage, sorts and
    read-backs). Returns the phase's launches."""
    total = {}
    gt, pcams, params = dense_room(dev)
    acts = activations(params)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    lines = []
    for b in MULTI_BATCHES:
        cams = [pcams[i * N_CAMS // b].raster_camera(dev) for i in range(b)]
        r = multi_against_singles(dev, acts, cams, bg, grads=b in MULTI_GRAD_BATCHES)
        add_launches(total)
        lines.append(
            f"11a B={b} ({r['tiles']} tiles{', past K3 shared histogram' if r['tiles'] > K3_HIST_CAP else ''}, "
            f"{r['instances']} instances): forward bitwise the single renders; forward ms chain "
            f"{r['chain_fwd_ms']:.3f} against {r['singles_fwd_ms']:.3f} for the {b} single renders (host clock, "
            f"synchronised, median of 5)"
            + (f"; gradients' max abs error over max |grad| "
               + ", ".join(f"{k} {v:.2e}" for k, v in r["grad_err"].items())
               + f" (tol {MULTI_GRAD_TOL}), bitwise: {r['grads_bitwise']}; against the chain on the plain "
               f"versions: images' max abs error " + ", ".join(f"{k} {v:.2e}" for k, v in r["plain_img_err"].items())
               + f" (K4_TOL), radii differing {r['plain_radii_differ']}, gradients' error in L2 norm over the "
               f"plain's " + ", ".join(f"{k} {v:.2e}" for k, v in r["plain_grad_err"].items())
               + f" (tol {MULTI_PLAIN_GRAD_TOL}; a K2 that overwrote would err by "
               + ", ".join(f"{k} {v:.3f}" for k, v in r["overwrite_err"].items()) + ")"
               if "grad_err" in r else ""))
    del acts

    views = train_views(gt, pcams, dev)
    npz = work / "gt_gaussians_11.npz"
    synthetic.write_gt_npz(str(npz), gt)
    cols = np.clip(SH2RGB(gt["features_dc"][:, 0]), 0, 1).astype(np.float32)
    pcd_pts, pcd_cols = synthetic.init_cloud(gt["xyz"], cols, MULTI_CLOUD, np.random.default_rng(SEED + 11))
    frozen = FrozenRenderer(params, 3)
    engine = OracleDiffusionEngine(str(npz), EVENT_FRAMES, HEIGHT, WIDTH, device=dev)
    last = 4 * MULTI_STEPS + 3
    opt = OptimizationParams(iterations=10 * last, start_sample_pseudo=0, end_sample_pseudo=10 * last,
                             guidance_vd_iter=10 * last, densify_from_iter=10 * last,
                             densify_until_iter=10 * last, use_trajectory_pool=False)
    state = G.GaussianState.fresh(G.GaussianParams(**{k: v.clone() for k, v in params.tensors().items()}))
    trainer = GuidedTrainer(views, state, opt, PipelineParams(), ModelParams(), frozen, engine, pcd_pts,
                            pcd_cols, guidance_intrinsic(views.cams[0]))
    trainer.init_view_geometry()
    add_launches(total)
    _build.reset_launches()
    trainer.run_diffusion_event(1)
    event = add_launches(total)
    want = launches_of(frames=2 * EVENT_FRAMES, chains=2 * chains_of(EVENT_FRAMES))
    if any(event[k] != want[k] for k in GAUSSIAN_KERNELS) or len(trainer.pseudo_stack) != EVENT_FRAMES - 1:
        raise AssertionError(f"11b event: launches {event}, expected {want} (the frozen and the oracle's "
                             f"{EVENT_FRAMES} frames, chains of {FrozenRenderer.GROUP})")
    lines.append(f"11b an oracle event: K1 {event['preprocess_fwd']}, K3 {event['expand']}, K4 "
                 f"{event['blend_fwd']} (the frozen renders' {EVENT_FRAMES} frames and the oracle's, each "
                 f"{chains_of(EVENT_FRAMES)} chains of {FrozenRenderer.GROUP}; one a frame before the chain: "
                 f"K3 {2 * EVENT_FRAMES})")

    per_view = mock.patch.object(guided_module, "render_gaussians_multi", per_view_multi)
    it = 1
    host = {"per_view": [], "chain": []}
    for way in ("per_view", "chain", "chain", "per_view"):
        with per_view if way == "per_view" else contextlib.nullcontext():
            for _ in range(MULTI_STEPS):
                it += 1
                _build.reset_launches()
                torch.cuda.synchronize()
                t = time.perf_counter()
                st = trainer.step(it)
                torch.cuda.synchronize()
                host[way].append((time.perf_counter() - t) * 1e3)
                got = add_launches(total)
                # per-view: two single-view chains; the chain: one of two views
                want = launches_of(2) if way == "per_view" else launches_of(1, 1)
                if any(got[k] != want[k] for k in GAUSSIAN_KERNELS) or not math.isfinite(float(st.loss)) \
                        or not float(trainer.last_metrics["pseudo_l1"]) > 0.0:
                    raise AssertionError(f"11b {way} step {it}: launches {got}, expected {want}; loss "
                                         f"{float(st.loss)}, pseudo_l1 {float(trainer.last_metrics['pseudo_l1'])}")
    traced = {}
    for way in ("per_view", "chain"):
        with per_view if way == "per_view" else contextlib.nullcontext():
            it += 1
            trainer.step(it)  # warm
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=PROFILER_ACTIVITIES) as prof:
                it += 1
                trainer.step(it)
                torch.cuda.synchronize()
            add_launches(total)
        dev_ms, idle, rb_ms, rbs, concat = trace_summary(prof, 1)
        sorts = sum(1 for e in prof.events() if e.name == "aten::sort")
        traced[way] = dict(dev_ms=dev_ms, idle=idle, readbacks=rbs, sorts=sorts, concat=concat)
    for way in ("per_view", "chain"):
        t = traced[way]
        lines.append(f"11b guided step {way}: host ms median {statistics.median(host[way]):.3f} (blocks "
                     + ", ".join(f"{statistics.median(host[way][i:i + MULTI_STEPS]):.3f}"
                                 for i in range(0, len(host[way]), MULTI_STEPS))
                     + f"); traced device ms " + fmt_stages(t["dev_ms"]) + f", idle share {t['idle']:.3f}; "
                     f"sorts/step {t['sorts']}, read-backs/step {t['readbacks']:g}; {fmt_concat(t['concat'], 'step')}")
    lines.append(f"11b chain against per-view: host ms {statistics.median(host['chain']):.3f} / "
                 f"{statistics.median(host['per_view']):.3f}, device ms {sum(traced['chain']['dev_ms'].values()):.3f}"
                 f" / {sum(traced['per_view']['dev_ms'].values()):.3f} a guided step (blocks in turns: per-view, "
                 f"chain, chain, per-view)")
    for line in lines:
        log("phase " + line)
    if traced["chain"]["sorts"] >= traced["per_view"]["sorts"] or \
            traced["chain"]["readbacks"] >= traced["per_view"]["readbacks"]:
        raise AssertionError(f"11b: sorts and read-backs a step, chain against per-view: {traced}")
    return {n: total.get(n, 0) for n in KERNELS}


# --- phase 12: the device mesh, precomputed colours, --profile_dir ---------------------------------

MESH_TP = 2  # the engine's model axis
# 12a: one UNet forward of the guided pair, sharded and unsharded, both in
# bf16, each against the same forward in f32 (unsharded, TF32 off): the
# sharded one's error may be at most MESH_BF16_RATIO times the unsharded
# one's (as tests/test_torch_diffusion_models.py::test_unet_bf16 holds the
# port's bf16 to JAX's)
MESH_BF16_RATIO = 1.5
# 12a: the bf16 request at full width parts at the scale of its own rounding
# (PERF.md, phase 12): its video moves as far when x_T moves by 2^-9 of each
# value, bf16's rounding, as when the weights are split. The sharded
# request's video may stand at most MESH_VIDEO_RATIO times that yardstick
# from the unsharded one's; the sharded arithmetic itself is held by the
# pair's forward in f32 (MESH_F32_TOL) and by the block below
MESH_VIDEO_RATIO = 2.0
# 12a: a transformer block at level 1 (640 channels, 10 heads of 64) on
# level 0's 2240 tokens: its self-attention takes L1, split 5 heads a
# device; forward and backward each held to the f32 block as the pair
MESH_BLOCK = "input_blocks.4.1.transformer_blocks.0"
MESH_BLOCK_TOKENS = (GEN_H // 8) * (GEN_W // 8)
# 12a: in float32 (TF32 off, cuDNN deterministic), sharded against
# unsharded, in L2 over the unsharded (the partial sums added in another
# order): the pair's UNet forward, and each branch's UNet VJP (dL/dx for a
# cotangent on v from SEED + 13: every split layer's backward) on the first
# STEP32_FRAMES frames
MESH_F32_TOL = 1e-4
# 12a: the pair's VJP in float32 (ddim_guidance.pair_vjp: dL/dx of pred_x0,
# the gradient the guided sampler uses) on the same frames: the CFG
# combination subtracts the branches' nearly equal gradients (cfg_scale
# 7.5), which amplifies their rounding, so it is held to its own yardstick,
# the unsharded VJP with x moved by 2^-24 of each value (f32's rounding):
# the sharded one may stand at most MESH_VJP_RATIO times as far (at the
# toy widths of tests/test_torch_model_parallel.py 1.9e-5 against 1.8e-5)
MESH_VJP_RATIO = 2.0
# 12b: the camera batch split over two devices; the parameters' gradients
# sum each camera's contributions in another order on two cards (f32: a
# few ulps of each sum), bitwise on one card
MESH_DP_GRAD_TOL = 1e-5
MESH_DP_STEPS = 3  # steps a timed block: mesh, single, single, mesh
# 12c: the crop of the dense comparison (width, height), centred
PRECOMP_CROP = (200, 136)
PROFILE_ITERS = 60  # 12d: train_baseline --profile_dir traces steps 50-60
PROFILE_KERNELS = ("preprocess_fwd_kernel", "blend_fwd_kernel", "blend_bwd_kernel")


def mesh_devices(n: int) -> list:
    """n cards: cuda:0 .. cuda:n-1 where the host has them, else cuda:0 n
    times (the sharded program on one card)."""
    count = torch.cuda.device_count()
    return [torch.device("cuda", i if count >= n else 0) for i in range(n)]


def sync_devices(devs) -> None:
    for d in dict.fromkeys(devs):
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def l1_launch_log(record: list):
    """Within it each launch of L1's three kernels appends (kernel, card
    index, heads) to `record` (the wrappers themselves still count it)."""
    wraps = {"_launch_fwd": "flash_attn_fwd", "bwd_dkv_kernel": "flash_attn_bwd_dkv",
             "bwd_dq_kernel": "flash_attn_bwd_dq"}
    real = {fn: getattr(fa, fn) for fn in wraps}

    def wrap(fn):
        def call(q, *args, **kwargs):
            record.append((wraps[fn], q.device.index, q.shape[1]))
            return real[fn](q, *args, **kwargs)
        return call

    with contextlib.ExitStack() as stack:
        for fn in wraps:
            stack.enter_context(mock.patch.object(fa, fn, wrap(fn)))
        yield


def count_by(record: list) -> dict:
    out = {}
    for key in record:
        out[key] = out.get(key, 0) + 1
    return out


def rel_errs(got: torch.Tensor, want: torch.Tensor) -> dict:
    g, w = got.float(), want.float()
    return {"max_abs": float((g - w).abs().max()), "rel_l2": float((g - w).norm() / w.norm().clamp_min(1e-30))}


def expected_l1(mcfg, steps: int, mesh) -> dict:
    """L1's launches of a guided request of `steps` steps by (kernel, card,
    heads): the UNet's level-0 attentions on every device of the model axis
    with heads / n_model heads where the heads split, else on the home
    device with all of them; the VAE's (single head) on the home device."""
    ucfg = mcfg.unet
    heads = ucfg.model_channels // ucfg.num_head_channels
    fwd, bwd = guided_launches(ucfg, steps, GEN_FRAMES, DECODE_CHUNK)
    chunks = steps * -(-GEN_FRAMES // DECODE_CHUNK)
    unet = {"flash_attn_fwd": fwd - chunks, "flash_attn_bwd_dkv": bwd - chunks, "flash_attn_bwd_dq": bwd - chunks}
    vae = {"flash_attn_fwd": chunks + 2, "flash_attn_bwd_dkv": chunks, "flash_attn_bwd_dq": chunks}
    devs = mesh.model_devices
    out = {}
    for name in unet:
        where = [(d, heads // len(devs)) for d in devs] if heads % len(devs) == 0 else [(mesh.home, heads)]
        for d, h in where:
            out[(name, d.index, h)] = out.get((name, d.index, h), 0) + unet[name]
        out[(name, mesh.home.index, 1)] = out.get((name, mesh.home.index, 1), 0) + vae[name]
    return out


def mesh_engine(dev) -> dict:
    """12a: the ViewCrafter engine at full width with its weights split over
    a (1, MESH_TP) mesh against the unsharded engine on the same inputs."""
    devs = mesh_devices(MESH_TP)
    mesh = make_mesh(n_data=1, n_model=MESH_TP, devices=devs)
    where = "two cards" if devs[0] != devs[1] else "one card twice (the host has one)"
    mcfg = LatentDiffusionConfig(compute_dtype="bfloat16")
    scfg = synthesis.SynthesisConfig(ddim_steps=GUIDED_STEPS)
    params, _ = gen_params(dev)
    base = ViewCrafterEngine(params, mcfg, scfg, video_length=GEN_FRAMES, height=GEN_H, width=GEN_W)
    sync_devices(devs)
    t = time.perf_counter()
    tp = ViewCrafterEngine(params, mcfg, scfg, video_length=GEN_FRAMES, height=GEN_H, width=GEN_W, mesh=mesh)
    sync_devices(devs)
    shard_s = time.perf_counter() - t
    n_split = sum(isinstance(v, Sharded) for part in tp.params for v in part.values())
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 10)
    renders, images, masks, depths = guided_inputs(dev, gen)
    gcfg = base.guided_cfg
    f = 2 ** (len(mcfg.vae.ch_mult) - 1)
    lat = (GEN_FRAMES, GEN_H // f, GEN_W // f, 4)
    noise = synthesis.SynthesisNoise(
        encode_eps=torch.randn(lat, generator=gen, device=dev),
        x_T=torch.randn((1,) + lat, generator=gen, device=dev),
        steps=torch.randn((GUIDED_STEPS * (2 * gcfg.recur_steps - 1), 1) + lat, generator=gen, device=dev))
    def say(line: str) -> None:
        log(f"phase 12a {line}")
    say(f"mesh (1, {MESH_TP}) on {[str(d) for d in devs]}: {where}; {n_split} weights split, shard_params "
        f"{shard_s:.2f} s")

    # one UNet forward of the guided pair: both engines' bf16 against the f32 forward
    sched, pr, cond, uncond, x, _, index = guided_step_inputs(dev, params, mcfg, scfg, base, renders)
    with torch.no_grad():
        pair = {k: ddim_guidance.pair_forward(e.params, mcfg, pr, cond, uncond, x, index)
                for k, e in (("unsharded", base), ("sharded", tp))}
        p32 = params._replace(unet={k: v.float() for k, v in params.unet.items()})
        m32 = dataclasses.replace(mcfg, compute_dtype="float32")
        s32 = shard_params(p32, mesh)
        truth = ddim_guidance.pair_forward(p32, m32, pr, cond, uncond, x, index)
        truth_tp = ddim_guidance.pair_forward(s32, m32, pr, cond, uncond, x, index)
    torch.cuda.empty_cache()
    errs = {k: [rel_errs(v, t) for v, t in zip(pair[k], truth)] for k in pair}
    between = [rel_errs(a, b) for a, b in zip(pair["sharded"], pair["unsharded"])]
    err32 = [rel_errs(a, b) for a, b in zip(truth_tp, truth)]
    for branch in (0, 1):
        s, u = errs["sharded"][branch]["rel_l2"], errs["unsharded"][branch]["rel_l2"]
        if not (math.isfinite(s) and s <= MESH_BF16_RATIO * u):
            raise AssertionError(f"12a UNet pair branch {branch}: the sharded bf16 forward errs by {s:.4g} of the "
                                 f"f32 one in L2, the unsharded by {u:.4g} (allowed {MESH_BF16_RATIO}x)")
        if not err32[branch]["rel_l2"] <= MESH_F32_TOL:
            raise AssertionError(f"12a UNet pair branch {branch}: in float32 the sharded forward differs from the "
                                 f"unsharded one by {err32[branch]} (tol {MESH_F32_TOL} in L2)")
    say("UNet forward of the guided pair (bf16, index " + str(index) + "), error in L2 over the f32 forward's, "
        "cond / uncond: sharded " + " / ".join(f"{e['rel_l2']:.4g}" for e in errs["sharded"])
        + ", unsharded " + " / ".join(f"{e['rel_l2']:.4g}" for e in errs["unsharded"])
        + f" (allowed {MESH_BF16_RATIO}x); sharded against unsharded: "
        + " / ".join(f"max abs {e['max_abs']:.4g}, L2 {e['rel_l2']:.4g}" for e in between)
        + "; in float32 sharded against unsharded: "
        + " / ".join(f"max abs {e['max_abs']:.4g}, L2 {e['rel_l2']:.4g}" for e in err32) + f" (tol {MESH_F32_TOL})")

    # in float32 on STEP32_FRAMES frames, sharded against unsharded: each
    # branch's UNet VJP, and the pair's VJP beside its yardstick
    t = STEP32_FRAMES
    c5, u5 = (Conditioning(c.context, c.concat[:, :t].contiguous(), c.fs) for c in (cond, uncond))
    x5 = x[:, :t].contiguous()
    g13 = torch.Generator(device=dev).manual_seed(SEED + 13)
    cot = torch.randn(x5.shape, generator=g13, device=dev)
    sgn = torch.randint(0, 2, x5.shape, generator=g13, device=dev).float() * 2.0 - 1.0
    tt = pr.timesteps[index].expand(1)

    def branch_vjp(p, c):
        with torch.enable_grad():
            xg = x5.detach().requires_grad_()
            return torch.autograd.grad(apply_model(p, m32, xg, tt, c), xg, cot)[0]

    def sampler_vjp(p, xv):
        v_cond, v_uncond = ddim_guidance.pair_forward(p, m32, pr, c5, u5, xv, index)
        return ddim_guidance.pair_vjp(p, m32, sched, pr, c5, u5, gcfg, xv, index, v_cond, v_uncond, cot)

    with deterministic_cudnn():
        berr = [rel_errs(branch_vjp(s32, c), branch_vjp(p32, c)) for c in (c5, u5)]
        gx = {"unsharded": sampler_vjp(p32, x5), "sharded": sampler_vjp(s32, x5),
              "moved": sampler_vjp(p32, x5 * (1.0 + 2.0 ** -24 * sgn))}
    sync_devices(devs)
    del p32, s32
    torch.cuda.empty_cache()
    gerr, gyard = rel_errs(gx["sharded"], gx["unsharded"]), rel_errs(gx["moved"], gx["unsharded"])
    if not all(e["rel_l2"] <= MESH_F32_TOL for e in berr):
        raise AssertionError(f"12a: each branch's f32 UNet VJP sharded against unsharded {berr} "
                             f"(tol {MESH_F32_TOL} in L2)")
    if not (bool(torch.isfinite(gx["sharded"]).all()) and gerr["rel_l2"] <= MESH_VJP_RATIO * gyard["rel_l2"]):
        raise AssertionError(f"12a: the pair's f32 VJP sharded differs from the unsharded one by {gerr}, more than "
                             f"{MESH_VJP_RATIO}x the {gyard} of x moved by 2^-24")
    say(f"in float32 on {t} frames at {GEN_H}x{GEN_W} (index {index}, cuDNN deterministic), sharded against "
        f"unsharded: each branch's UNet VJP, cond / uncond, " + " / ".join(
            f"max abs {e['max_abs']:.4g}, L2 {e['rel_l2']:.4g}" for e in berr) + f" (tol {MESH_F32_TOL}); "
        f"the pair's VJP (the sampler's dL/dx, |dL/dx| {float(gx['unsharded'].norm()):.4g}) max abs "
        f"{gerr['max_abs']:.4g}, L2 {gerr['rel_l2']:.4g} (allowed {MESH_VJP_RATIO}x the next), the unsharded one's "
        f"with x moved by 2^-24 max abs {gyard['max_abs']:.4g}, L2 {gyard['rel_l2']:.4g}")
    del gx

    # the request both ways, L1's launches by card and heads
    def request(eng, noise_):
        """eng's guided request on 8b's inputs: the video, its seconds, each
        card's peak, L1's launches by (kernel, card, heads), all launches."""
        record = []
        for d in dict.fromkeys(devs):
            torch.cuda.reset_peak_memory_stats(d)
        _build.reset_launches()
        with l1_launch_log(record):
            sync_devices(devs)
            t = time.perf_counter()
            video = eng.generate(renders, images, masks, depths, no_guidance=False, noise=noise_)
            sync_devices(devs)
            sec = time.perf_counter() - t
        got = dict(_build.LAUNCHES)
        if any(got[n] for n in GAUSSIAN_KERNELS) or \
                len(record) != sum(got[n] for n in ("flash_attn_fwd",) + L1_BWD_KERNELS):
            raise AssertionError(f"12a: launches {got}, L1 by card and heads {count_by(record)}")
        peak = {str(d): torch.cuda.max_memory_allocated(d) / 1e9 for d in dict.fromkeys(devs)}
        return video, sec, peak, count_by(record), got

    videos, secs, peaks, logs = {}, {}, {}, {}
    for name, eng in (("unsharded", base), ("sharded", tp)):
        videos[name], secs[name], peaks[name], logs[name], got = request(eng, noise)
        if name == "sharded":
            total_launches = got
    single = make_mesh(n_data=1, n_model=1, devices=devs[:1])
    for name, m in (("unsharded", single), ("sharded", mesh)):
        want = expected_l1(mcfg, GUIDED_STEPS * gcfg.recur_steps, m)
        if logs[name] != want:
            raise AssertionError(f"12a {name}: L1 launches by (kernel, card, heads) {logs[name]}, expected {want}")
    heads0 = mcfg.unet.model_channels // mcfg.unet.num_head_channels
    v = videos["sharded"]
    if tuple(v.shape) != (GEN_FRAMES, 3, GEN_H, GEN_W) or not bool(torch.isfinite(v).all()):
        raise AssertionError(f"12a: sharded video shape {tuple(v.shape)}, finite {bool(torch.isfinite(v).all())}")
    # the yardstick: the unsharded request with its start x_T moved by
    # 2^-9 of each value (bf16's rounding), as far as two roundings part
    sgn = torch.randint(0, 2, noise.x_T.shape, generator=gen, device=dev).float() * 2.0 - 1.0
    moved, moved_s = request(base, noise._replace(x_T=noise.x_T * (1.0 + 2.0 ** -9 * sgn)))[:2]
    again, again_s = request(tp, noise)[:2]  # warm: the first of each met its shapes cold
    verr = rel_errs(videos["sharded"], videos["unsharded"])
    yard = rel_errs(moved, videos["unsharded"])
    if not verr["rel_l2"] <= MESH_VIDEO_RATIO * yard["rel_l2"]:
        raise AssertionError(f"12a: the sharded request's video differs from the unsharded one's by {verr}, "
                             f"more than {MESH_VIDEO_RATIO}x the {yard} of x_T moved by 2^-9")
    say(f"guided request ({GEN_FRAMES}x{GEN_H}x{GEN_W} bf16, {GUIDED_STEPS} guided steps, 8b's inputs "
                 f"and noise): seconds sharded {secs['sharded']:.3f} and {again_s:.3f} (first, again: bitwise "
                 f"{torch.equal(again, videos['sharded'])}) against unsharded {secs['unsharded']:.3f} and "
                 f"{moved_s:.3f} (first, again with x_T moved); "
                 f"video sharded against unsharded max abs {verr['max_abs']:.4g}, L2 {verr['rel_l2']:.4g} (allowed "
                 f"{MESH_VIDEO_RATIO}x the next), the unsharded one's with x_T moved by 2^-9 max abs {yard['max_abs']:.4g}, "
                 f"L2 {yard['rel_l2']:.4g}; peak GB by card sharded {peaks['sharded']}, unsharded "
                 f"{peaks['unsharded']}; L1 launches by (kernel, card, heads) sharded {logs['sharded']}, unsharded "
                 f"{logs['unsharded']} (exact: level 0's {heads0} heads "
                 f"{'split' if heads0 % MESH_TP == 0 else 'do not split'} over {MESH_TP}; the VAE's single head "
                 f"attends on the home card)")

    # the heads split: a level-1 block on MESH_BLOCK_TOKENS tokens, forward and backward
    p_unet = {k: v for k, v in params.unet.items() if k.startswith(MESH_BLOCK)}
    s_unet = {k: v for k, v in tp.params.unet.items() if k.startswith(MESH_BLOCK)}
    c = p_unet[f"{MESH_BLOCK}.attn1.to_q.weight"].shape[0]
    heads = c // mcfg.unet.num_head_channels
    g2 = torch.Generator(device=dev).manual_seed(SEED + 12)
    xb = torch.randn((2, MESH_BLOCK_TOKENS, c), generator=g2, device=dev).to(BF16)
    ctx = torch.randn((2, mcfg.unet.text_context_len + mcfg.unet.image_tokens_per_frame, mcfg.unet.context_dim),
                      generator=g2, device=dev).to(BF16)
    wout = torch.randn((2, MESH_BLOCK_TOKENS, c), generator=g2, device=dev)
    block = {}
    for name, p in (("unsharded", p_unet), ("sharded", s_unet),
                    ("f32", {k: v.float() for k, v in p_unet.items()})):
        record = []
        dt = torch.float32 if name == "f32" else BF16
        xin = xb.to(dt, copy=True).requires_grad_(True)
        with l1_launch_log(record):
            out = d_attention.basic_transformer_block(p, MESH_BLOCK, xin, ctx.to(dt), heads,
                                                      mcfg.unet.num_head_channels, image_cross_attention=True)
            (out.float() * wout).sum().backward()
        sync_devices(devs)
        block[name] = (out.detach(), xin.grad, count_by(record))
    want = {}
    for kernel in ("flash_attn_fwd",) + L1_BWD_KERNELS:
        for d in devs:
            want[(kernel, d.index, heads // MESH_TP)] = want.get((kernel, d.index, heads // MESH_TP), 0) + 1
    if block["sharded"][2] != want or block["unsharded"][2] != {(k, dev.index, heads): 1 for k in
                                                                ("flash_attn_fwd",) + L1_BWD_KERNELS}:
        raise AssertionError(f"12a block: L1 launches by (kernel, card, heads) sharded {block['sharded'][2]} "
                             f"(expected {want}), unsharded {block['unsharded'][2]}")
    parts = ((0, "output"), (1, "dL/dx"))
    berr = {k: rel_errs(block["sharded"][i], block["unsharded"][i]) for i, k in parts}
    terr = {w: {k: rel_errs(block[w][i], block["f32"][i])["rel_l2"] for i, k in parts} for w in ("sharded", "unsharded")}
    for _, k in parts:
        if not terr["sharded"][k] <= MESH_BF16_RATIO * terr["unsharded"][k]:
            raise AssertionError(f"12a block {k}: the sharded bf16 errs by {terr['sharded'][k]:.4g} of the f32 one "
                                 f"in L2, the unsharded by {terr['unsharded'][k]:.4g} (allowed {MESH_BF16_RATIO}x)")
    say(f"the heads split: {MESH_BLOCK} ({c} channels, {heads} heads) on {MESH_BLOCK_TOKENS} tokens, bf16, forward "
        f"and backward: L1 by (kernel, card, heads) sharded {block['sharded'][2]}, unsharded {block['unsharded'][2]}; "
        "error in L2 over the f32 block's, " + ", ".join(
            f"{k} sharded {terr['sharded'][k]:.4g}, unsharded {terr['unsharded'][k]:.4g}" for _, k in parts)
        + f" (allowed {MESH_BF16_RATIO}x); sharded against unsharded: " + ", ".join(
            f"{k} max abs {berr[k]['max_abs']:.4g}, L2 {berr[k]['rel_l2']:.4g}" for _, k in parts))
    del tp, base
    torch.cuda.empty_cache()
    launches = {n: total_launches.get(n, 0) for n in KERNELS}
    for (kernel, _, _), k in block["sharded"][2].items():
        launches[kernel] += k
    return launches


def mesh_dp(dev) -> dict:
    """12b: make_dp_train_step of phase 5b's room (6 views, 1M Gaussians,
    SH 3, 640x480) on a (2, 1) mesh against train_step_dp on one device:
    the first step's loss, gradients and statistics, K1-K6 exactly 6 a step,
    then host ms in turns."""
    devs = mesh_devices(2)
    mesh = make_mesh(n_data=2, n_model=1, devices=devs)
    gt, pcams, params = dense_room(dev)
    views = train_views(gt, pcams, dev)
    cams = stack_cameras([c.raster_camera(dev) for c in views.cams])
    gts = torch.stack([torch.from_numpy(np.ascontiguousarray(c.image, np.float32)) for c in views.cams]).to(dev)
    bg = torch.zeros(3, device=dev)
    opt = OptimizationParams()
    lrs = lrs_for(opt, opt.position_lr_init * views.cameras_extent)
    b = len(views.cams)
    states = {k: G.GaussianState.fresh(G.GaussianParams(**{n: v.clone() for n, v in params.tensors().items()}))
              for k in ("mesh", "single")}
    step = make_dp_train_step(mesh, 3, opt.lambda_dssim)
    run = {"mesh": lambda s: step(s, cams, gts, bg, lrs),
           "single": lambda s: train_step_dp(s, cams, gts, bg, lrs, 3, opt.lambda_dssim)}
    total, first, ms = {}, {}, {"mesh": [], "single": []}
    for way in ("mesh", "single", "single", "mesh"):
        for _ in range(MESH_DP_STEPS):
            _build.reset_launches()
            sync_devices(devs)
            t = time.perf_counter()
            m = run[way](states[way])
            sync_devices(devs)
            ms[way].append((time.perf_counter() - t) * 1e3)
            got = add_launches(total) if way == "mesh" else dict(_build.LAUNCHES)  # single: the reference
            if any(got[n] != b for n in GAUSSIAN_KERNELS) or not math.isfinite(float(m["loss"])):
                raise AssertionError(f"12b {way}: launches {got} (each of K1-K6 exactly {b}), loss {float(m['loss'])}")
            if way not in first:
                st = states[way]
                first[way] = dict(loss=float(m["loss"]), stats={k: getattr(st, k).clone() for k in
                                                               ("xyz_gradient_accum", "denom", "max_radii2d")},
                                  grads={n: getattr(st.params, n).grad.clone() for n in G.PARAM_NAMES})
    a, s = first["mesh"], first["single"]
    errs = {n: float((a["grads"][n] - s["grads"][n]).norm() / s["grads"][n].norm().clamp_min(1e-30))
            for n in G.PARAM_NAMES}
    errs["accum"] = float((a["stats"]["xyz_gradient_accum"] - s["stats"]["xyz_gradient_accum"]).norm()
                          / s["stats"]["xyz_gradient_accum"].norm().clamp_min(1e-30))
    bitwise = all(torch.equal(a["grads"][n], s["grads"][n]) for n in G.PARAM_NAMES)
    rows = {k: int((a["stats"][k] != s["stats"][k]).sum()) for k in ("denom", "max_radii2d")}
    if max(errs.values()) > MESH_DP_GRAD_TOL or abs(a["loss"] - s["loss"]) > DP_LOSS_TOL or any(rows.values()):
        raise AssertionError(f"12b: the mesh step against train_step_dp: gradient errors {errs} (tol "
                             f"{MESH_DP_GRAD_TOL}), loss {a['loss']} vs {s['loss']}, rows differing {rows}")
    med = statistics.median
    log(f"phase 12b make_dp_train_step on a (2, 1) mesh {[str(d) for d in devs]}, {b} views ({b // 2} a device), "
        f"{N_SCENE} Gaussians, SH 3, {WIDTH}x{HEIGHT}: first step loss {a['loss']:.7f} against train_step_dp's "
        f"{s['loss']:.7f}; gradients' error in L2 over train_step_dp's "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (tol {MESH_DP_GRAD_TOL}; bitwise {bitwise}); "
        f"denom / max radii rows differing {rows['denom']} / {rows['max_radii2d']}; K1-K6 exactly {b} a step")
    log(f"phase 12b step host ms in turns (mesh, single, single, mesh; {MESH_DP_STEPS} steps a block): mesh median "
        f"{med(ms['mesh']):.2f} (" + ", ".join(f"{x:.2f}" for x in ms["mesh"]) + f"), single median "
        f"{med(ms['single']):.2f} (" + ", ".join(f"{x:.2f}" for x in ms["single"]) + ")")
    return {n: total.get(n, 0) for n in KERNELS}


def crop_camera(cam, width: int, height: int):
    """The centred width x height window of `cam`'s image as a camera of its own."""
    fx, fy = cam.image_width / (2 * math.tan(cam.FoVx / 2)), cam.image_height / (2 * math.tan(cam.FoVy / 2))
    K = np.array([[fx, 0.0, width / 2.0], [0.0, fy, height / 2.0], [0.0, 0.0, 1.0]])
    w2c = np.eye(4)
    w2c[:3, :3], w2c[:3, 3] = cam.R.T, cam.T
    return cameras.camera_from_w2c_K(w2c, K, height, width)


def precomp_render(leaves: dict, cam, bg, weights):
    """rasterize_tiles of the leaves (means, opacity, offset; colours or
    SH; cov3D or scales and rotations) and a fixed loss's backward: the
    images and each leaf's gradient."""
    out = raster_tiles.rasterize_tiles(
        leaves["means"], leaves.get("scales"), leaves.get("rotations"), leaves["opacity"], leaves.get("sh"), cam,
        bg, colors_precomp=leaves.get("colors"), cov3d_precomp=leaves.get("cov3d"), means2d_offset=leaves["offset"])
    wc, wd, wa = weights
    ((out.color * wc).sum() + (out.depth * wd).sum() + (out.alpha * wa).sum()).backward()
    return out, {k: v.grad for k, v in leaves.items() if v is not None and v.requires_grad}


def mesh_precomp(dev) -> dict:
    """12c: rasterize_tiles with colors_precomp, then with cov3d_precomp, at
    phase 4's 1M-Gaussian room and a test view: K3-K6 once each (K1 and K2
    not at all), the images and gradients against the same call on the
    plain versions (K4_TOL, DP_GRAD_TOL in L2) and, on the Gaussians that
    reach a centred PRECOMP_CROP window, against the dense backend."""
    gt = chain_room(dev)[0]
    params = params_from_numpy(gt, dev)
    means, scales, rots, opac, sh = activations(params)
    _, ocams = synthetic.orbit(N_CAMS, WIDTH, HEIGHT, HFOV, None)
    view = ocams[7]
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    n = means.shape[0]
    colors = torch.rand((n, 3), generator=gen, device=dev)
    L = build_rotation(rots) * scales[:, None, :]
    sig = L @ L.transpose(1, 2)
    cov3d = torch.stack([sig[:, 0, 0], sig[:, 0, 1], sig[:, 0, 2], sig[:, 1, 1], sig[:, 1, 2], sig[:, 2, 2]], -1)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    cases = {"colors_precomp": dict(colors=colors, scales=scales, rotations=rots),
             "cov3d_precomp": dict(sh=torch.cat(sh, 1), cov3d=cov3d)}
    total = {}
    for case, extra in cases.items():
        def leaves(sel=slice(None)):
            d = dict(means=means, opacity=opac, **extra)
            out = {k: v[sel].detach().clone().requires_grad_(True) for k, v in d.items()}
            out["offset"] = torch.zeros((out["means"].shape[0], 2), device=dev, requires_grad=True)
            return out

        for cam_kind, pcam in (("full", view), ("crop", crop_camera(view, *PRECOMP_CROP))):
            cam = pcam.raster_camera(dev)
            sel = slice(None)
            if cam_kind == "crop":  # the Gaussians that reach a tile of the window
                with torch.no_grad():
                    tab = preprocess_fused.preprocess_table_plain(means, scales, rots, opac, sh, cam, 3, 1.0)
                    count = tiling.tile_rects(tab[0], tab[1], preprocess_fused.visible_radii(tab), tab[12],
                                              tab[13], cam.width, cam.height)[4]
                sel = torch.nonzero(count > 0)[:, 0]
            weights = (torch.randn((3, cam.height, cam.width), generator=gen, device=dev),
                       torch.randn((cam.height, cam.width), generator=gen, device=dev) * 0.1,
                       torch.randn((cam.height, cam.width), generator=gen, device=dev))
            _build.reset_launches()
            out, grads = precomp_render(leaves(sel), cam, bg, weights)
            got = add_launches(total)
            want = {"preprocess_fwd": 0, "preprocess_bwd": 0, "expand": 1, "blend_fwd": 1, "blend_bwd": 1,
                    "segsum": 1}
            if any(got[k] != want[k] for k in GAUSSIAN_KERNELS):
                raise AssertionError(f"12c {case} {cam_kind}: launches {got}, expected {want}")
            _build.reset_launches()
            if cam_kind == "full":
                with plain_gaussian_kernels():
                    ref, ref_g = precomp_render(leaves(sel), cam, bg, weights)
                against = "the plain versions"
            else:
                lv = leaves(sel)
                ref = raster_dense.rasterize_dense(
                    lv["means"], lv.get("scales"), lv.get("rotations"), lv["opacity"], lv.get("sh"), cam, bg,
                    colors_precomp=lv.get("colors"), cov3d_precomp=lv.get("cov3d"), means2d_offset=lv["offset"])
                wc, wd, wa = weights
                ((ref.color * wc).sum() + (ref.depth * wd).sum() + (ref.alpha * wa).sum()).backward()
                ref_g = {k: v.grad for k, v in lv.items() if v is not None and v.requires_grad}
                against = "the dense backend"
            if add_launches({}) != {k: 0 for k in _build.LAUNCHES}:
                raise AssertionError(f"12c {case} {cam_kind}: {against} launched a kernel")
            img = {k: check_k4(k, getattr(out, k), getattr(ref, k)) for k in ("color", "depth", "alpha")}
            gerr = {k: float((grads[k] - ref_g[k]).norm() / ref_g[k].norm().clamp_min(1e-30)) for k in grads}
            if not all(math.isfinite(e) and e <= DP_GRAD_TOL for e in gerr.values()) \
                    or not all(float(g.abs().max()) > 0 for g in grads.values()):
                raise AssertionError(f"12c {case} {cam_kind}: gradients against {against} {gerr} (tol {DP_GRAD_TOL})")
            log(f"phase 12c {case}, {cam_kind} view ({cam.width}x{cam.height}, {out.radii.shape[0]} Gaussians, "
                f"{out.num_instances} instances) against {against}: images' max abs error "
                + ", ".join(f"{k} {v:.2e}" for k, v in img.items()) + " (K4_TOL); gradients' error in L2 over the "
                "reference's " + ", ".join(f"{k} {v:.2e}" for k, v in gerr.items())
                + f" (tol {DP_GRAD_TOL}); launches K3-K6 1 each, K1 and K2 0")
    return {n: total.get(n, 0) for n in KERNELS}


def mesh_profile(dev, work: Path, src: Optional[Path]) -> dict:
    """12d: train_baseline --profile_dir for PROFILE_ITERS iterations on
    phase 6's scene (made here when phase 6 did not run): K1-K6 exactly
    once a step, and the trace written, naming K1, K4 and K5."""
    if src is None:
        src = work / "synthetic_12d"
        synthetic.make_scene(str(src), device=dev)
    mdl, prof = work / "profile_model", work / "profile_trace"
    _build.reset_launches()
    t = time.perf_counter()
    port_train_cli.main(["-s", str(src), "-m", str(mdl), "--dataset", "colmap", "--n_views", "6",
                         "--iterations", str(PROFILE_ITERS), "--test_iterations", str(PROFILE_ITERS + 1),
                         "--save_iterations", str(PROFILE_ITERS), "--profile_dir", str(prof),
                         "--device", dev.type])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = dict(_build.LAUNCHES)
    if any(launches[n] != PROFILE_ITERS for n in GAUSSIAN_KERNELS):
        raise AssertionError(f"12d: launches {launches}, each of K1-K6 exactly {PROFILE_ITERS}")
    path = prof / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    found = {k: sum(k in name for name in kernels) for k in PROFILE_KERNELS}
    if not all(found.values()):
        raise AssertionError(f"12d: the trace {path} names {found} of {PROFILE_KERNELS}")
    log(f"phase 12d train_baseline --profile_dir, {PROFILE_ITERS} iterations on phase 6's scene in {secs:.1f} s: "
        f"{path.stat().st_size / 1e6:.1f} MB trace of the steps 50-{PROFILE_ITERS}, {len(kernels)} kernel events, "
        f"by name {found}; K1-K6 exactly {PROFILE_ITERS} each")
    return launches


def phase_mesh(dev, work: Path, src: Optional[Path] = None) -> dict:
    """Phase 12 (see the module's docstring). Returns its launches."""
    total = {}
    for launches in (mesh_engine(dev), mesh_dp(dev), mesh_precomp(dev), mesh_profile(dev, work, src)):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return {n: total.get(n, 0) for n in KERNELS}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--generate-only", type=int, metavar="STEPS", default=None,
                        help="run phases 1, 2 and 7b alone, with STEPS DDIM steps")
    parser.add_argument("--guided-only", type=int, metavar="STEPS", default=None,
                        help="run phases 1, 2 and 8b alone, with STEPS guided DDIM steps")
    parser.add_argument("--backward-only", action="store_true",
                        help="run phases 1, 2, 8a and 8b-8c alone: L1's backward kernels and the guided step")
    parser.add_argument("--forward-only", action="store_true",
                        help="run phases 1, 2, 7a and 7b-7c alone: L1's forward kernels and the DDIM request")
    parser.add_argument("--gaussian-only", action="store_true",
                        help="run phases 1, 2, 3, 5 and 5b alone: the Gaussian kernels K1-K6 and the trainer")
    parser.add_argument("--guided-trainer-only", action="store_true",
                        help="run phases 1, 2 and 5c alone: the guided trainer at full width")
    parser.add_argument("--vc-trainer-only", type=int, metavar="STEPS", default=None,
                        help="run phases 1, 2 and 5d alone, with STEPS guided DDIM steps in the event")
    parser.add_argument("--chain-only", action="store_true",
                        help="run phases 1, 2 and 6d alone: the published scripts' chain")
    parser.add_argument("--geometry-only", action="store_true",
                        help="run phases 1, 2 and 9 alone: raw data to the DUSt3R cloud and training, the "
                             "append path, the two-scale CFG, --nan_debug and the viewer")
    parser.add_argument("--pipeline-only", action="store_true",
                        help="run phases 1, 2 and 10 alone: pipelined events (the oracle's, the "
                             "ViewCrafter's beside the trainer) and the camera-batch step")
    parser.add_argument("--multi-only", action="store_true",
                        help="run phases 1, 2 and 11 alone: the B-camera chain against single renders, "
                             "its launches in the guided step and an event, the step's ms both ways")
    parser.add_argument("--parallel-only", action="store_true",
                        help="run phases 1, 2 and 12 alone: the sharded engine, the camera-sharded step, "
                             "precomputed colours on the tile rasterizer and --profile_dir")
    args = parser.parse_args()
    start = time.perf_counter()
    secs = {}

    def run(name, fn, *fn_args, **fn_kwargs):
        t = time.perf_counter()
        out = fn(*fn_args, **fn_kwargs)
        secs[name] = time.perf_counter() - t
        return out

    dev = run("1", phase_device)
    run("2", phase_build)
    if args.generate_only is not None:
        phase_generate(dev, args.generate_only, trace_and_f32=False)
        return
    if args.guided_only is not None:
        phase_guided(dev, args.guided_only, trace_and_f32=False)
        return
    if args.backward_only:
        run("8a", phase_l1_bwd, dev)
        run("8b-8c", phase_guided, dev, GUIDED_STEPS)
        log("seconds per phase: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
        return
    if args.forward_only:
        run("7a", phase_l1, dev)
        run("7b-7c", phase_generate, dev, GEN_STEPS)
        log("seconds per phase: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
        return
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=build_dir))
    try:
        if args.guided_trainer_only:
            run("5c", phase_guided_trainer, dev, work)
            log("seconds per phase: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
            return
        if args.vc_trainer_only is not None:
            run("5d", phase_vc_trainer, dev, work, args.vc_trainer_only)
            log("seconds per phase: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
            return
        if args.chain_only:
            run("6d", phase_chain, dev, work)
            log("seconds per phase: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
            return
        if args.geometry_only:
            run("9", phase_geometry, dev, work)
            log("seconds per phase: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
            return
        if args.pipeline_only:
            run("10", phase_pipeline, dev, work)
            log("seconds per phase: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
            return
        if args.multi_only:
            run("11", phase_multi, dev, work)
            log("seconds per phase: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
            return
        if args.parallel_only:
            run("12", phase_mesh, dev, work)
            log("seconds per phase: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
            return
        res = run("3", phase_kernels, dev)
        if args.gaussian_only:
            run("5", phase_train, dev)
            run("5b", phase_train_dense, dev)
            log("seconds per phase: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
            return
        # every kernel's launches on every path that runs it, by phase
        by_phase = {"4": run("4", phase_main, dev, work), "5": run("5", phase_train, dev)}
        dense, by_phase["5b"] = run("5b", phase_train_dense, dev)
        by_phase["5c"], c5 = run("5c", phase_guided_trainer, dev, work)
        by_phase["5d"], vc = run("5d", phase_vc_trainer, dev, work, GUIDED_STEPS, c5)
        cli_src, base, base_scores, by_phase["6"] = run("6", phase_cli, dev, work)
        by_phase["6b"] = run("6b", phase_guided_cli, dev, work, cli_src, base, base_scores)
        by_phase["6c"] = run("6c", phase_vc_cli, dev, work, cli_src, base)
        by_phase["6d"] = run("6d", phase_chain, dev, work)
        res["flash_attn_fwd"] = run("7a", phase_l1, dev)
        by_phase["7b"] = {"flash_attn_fwd": run("7b-7c", phase_generate, dev, GEN_STEPS)}
        res.update(run("8a", phase_l1_bwd, dev))
        by_phase["8b"], step_8b = run("8b-8c", phase_guided, dev, GUIDED_STEPS)
        by_phase["9"] = run("9", phase_geometry, dev, work, c5["host_ms"])
        by_phase["10"], step_10b = run("10", phase_pipeline, dev, work, (cli_src, base))
        by_phase["11"] = run("11", phase_multi, dev, work)
        by_phase["12"] = run("12", phase_mesh, dev, work, cli_src)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 5d vs 8b: a guided DDIM step ({GUIDED_STEPS}-step request, 25x320x448 bf16) "
        f"{vc['step_ms']:.1f} ms inside the trainer (5d), {step_8b:.1f} ms alone (8b), in this call")
    log(f"phase 10b vs 8b: a guided DDIM step {step_10b:.1f} ms in the pipelined trainer's event with nothing "
        f"beside it (10b), {step_8b:.1f} ms alone (8b), in this call")
    launches = {name: sum(ph.get(name, 0) for ph in by_phase.values()) for name in KERNELS}
    for name in KERNELS:
        res[name].setdefault("extra", {})["launches_by_phase"] = {k: ph[name] for k, ph in by_phase.items()
                                                                  if ph.get(name)}
    for name, d in dense.items():
        res[name]["extra"].update(ms_dense=d["ms"], bound_ms_dense=d["bound"][0])
    res["preprocess_fwd"]["extra"].update(ms_full_table_dense=dense["preprocess_fwd"]["ms_full_table"],
                                          bound_ms_all_rows_dense=dense["preprocess_fwd"]["bound_all_rows"][0])
    log("seconds per phase: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
        + f"; total {time.perf_counter() - start:.1f}")
    table = [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
             max_abs_err=res[name]["max_abs_err"], ms=res[name]["ms"],
             plain_ms=res[name]["plain_ms"], bound_ms=res[name]["bound"][0],
             bound_by=res[name]["bound"][1], library_ms=res[name].get("library_ms"),
             **res[name].get("extra", {}))
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
