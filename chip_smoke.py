#!/usr/bin/env python3
"""Run the PyTorch port's serving and training paths on one NVIDIA GPU and
check them.

    python3 chip_smoke.py

Phases (each prints a line, phase 5 one per quantity; any failure raises
and the exit code is non-zero; there is no CPU fallback):
  1. device   the card's name and power limit (nvidia-smi); TF32 off
  2. build    nvcc builds the kernels from csrc/ into build/torch_kernels/
  3. kernels  K1-K6 against their plain PyTorch versions on the card, on a
              200,000-Gaussian room at 640x480, SH degree 3: max abs error
              against the stated tolerance, median ms of each, its bound
              from the bytes and operations of this data, and for K6 the
              one PyTorch call that computes the same (torch.segment_reduce)
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
              before and after, the step time after it
  6. CLI      `guidedvd3dgs_tpu_torch.train_baseline` for 2000 iterations
              on the tool-default synthetic scene (scene.synthetic.
              make_scene), then the render and metrics CLIs on its
              iteration-0 and iteration-2000 models: test PSNR must gain
              at least 2 dB
  7. generate the video-diffusion generation path (ViewCrafter at full
              width: 25 frames, 320x448, UNet 320 channels, ViT-H-14
              towers, random weights from a seed)
     7a. kernel L1 (flash attention) against its plain version on the
              card at the UNet's, the VAE's and a ragged shape, in float32
              and bfloat16: max abs error against the stated tolerance,
              median ms, bound, plain ms and the ms of
              torch.nn.functional.scaled_dot_product_attention
     7b. one request through `ViewCrafterEngine.generate(no_guidance=True)`
              in bfloat16 with GEN_STEPS DDIM steps (cut from the default
              50; every step is the same program): conditioning, ms per
              step, decode, total, peak memory, L1's launches against
              10 per step + 2, the frames finite in [0, 1]; one DDIM step
              traced by stage with the idle share
     7c. one DDIM step at full width in float32 through L1 and through
              its plain version: the latents agree within STEP_TOL
`python3 chip_smoke.py --generate-only STEPS` runs phases 1, 2 and 7b
alone with STEPS DDIM steps (the 50-step request of PERF.md).
The line before the last is the JSON kernel table (launches of K1-K6 from
phase 5, of L1 from phase 7b); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from guidedvd3dgs_tpu_torch import metrics as port_metrics  # noqa: E402
from guidedvd3dgs_tpu_torch import render as port_render  # noqa: E402
from guidedvd3dgs_tpu_torch import train_baseline as port_train_cli  # noqa: E402
from guidedvd3dgs_tpu_torch.config import (  # noqa: E402
    ModelParams,
    OptimizationParams,
    PipelineParams,
    build_parser,
    get_combined_args,
)
from guidedvd3dgs_tpu_torch.convert import params_from_numpy  # noqa: E402
from guidedvd3dgs_tpu_torch.diffusion import attention as d_attention  # noqa: E402
from guidedvd3dgs_tpu_torch.diffusion import nnops as d_nnops  # noqa: E402
from guidedvd3dgs_tpu_torch.diffusion import schedules as S  # noqa: E402
from guidedvd3dgs_tpu_torch.diffusion import synthesis, unet3d  # noqa: E402
from guidedvd3dgs_tpu_torch.diffusion.init import init_diffusion_params  # noqa: E402
from guidedvd3dgs_tpu_torch.diffusion.model import LatentDiffusionConfig, apply_model  # noqa: E402
from guidedvd3dgs_tpu_torch.diffusion.samplers import ddim  # noqa: E402
from guidedvd3dgs_tpu_torch.models import gaussians as G  # noqa: E402
from guidedvd3dgs_tpu_torch.models.render import eval_render  # noqa: E402
from guidedvd3dgs_tpu_torch.ops import _build, expand, preprocess_fused, raster_tiles, segsum, tiling  # noqa: E402
from guidedvd3dgs_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain  # noqa: E402
from guidedvd3dgs_tpu_torch.ops.knn import dist_knn3  # noqa: E402
from guidedvd3dgs_tpu_torch.scene import cameras, dataset_readers, synthetic  # noqa: E402
from guidedvd3dgs_tpu_torch.scene.ply import load_gaussian_ply  # noqa: E402
from guidedvd3dgs_tpu_torch.scene.scene import Scene  # noqa: E402
from guidedvd3dgs_tpu_torch.train.baseline import BaselineTrainer  # noqa: E402
from guidedvd3dgs_tpu_torch.train.guided import ViewCrafterEngine  # noqa: E402

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
}
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
# phase 6: iterations of the CLI run on the tool-default synthetic scene
CLI_ITERS = 2000
# phase 7: the ViewCrafter request (configs/inference_pvd_1024.yaml widths,
# the guidedvd engine size) and L1's shapes on its path: the UNet's level-0
# spatial attention per CFG branch, the VAE's mid-block attention with the
# 25 frames batched (encode in float32, decode in bfloat16), the per-frame
# VAE shape of the JAX package, and a ragged tail
GEN_FRAMES, GEN_H, GEN_W = 25, 320, 448
GEN_STEPS = 10  # of the default 50: every DDIM step is the same program
BF16, F32 = torch.bfloat16, torch.float32
L1_SHAPES = [((25, 5, 2240, 64), BF16), ((25, 5, 2240, 64), F32), ((25, 1, 2240, 512), F32),
             ((25, 1, 2240, 512), BF16), ((1, 1, 2240, 512), F32), ((1, 1, 2240, 512), BF16),
             ((2, 3, 1200, 64), F32)]
L1_MAIN = L1_SHAPES[0]  # the UNet's, ten launches per DDIM step of the bf16 request
# L1 against its plain version on unit-normal inputs: float32 (another sum
# order); bfloat16 against the plain version of the same bf16 inputs, which
# rounds the weights to bf16 before the second product
L1_TOL = {F32: 2e-5, BF16: 1e-2}
# 7c: one float32 DDIM step through L1 and through its plain version; the
# ten attentions differ by ~1e-6, carried through the UNet and the CFG
# scale of 7.5 to latents of O(1)
STEP_TOL = 1e-3
# 7b's trace: the stage of each diffusion function (by its module name)
STAGE_FNS = {"attention": "attention", "conv2d": "conv", "conv3d": "conv",
             "group_norm": "GroupNorm", "linear": "matmul", "conv1d_k1": "matmul"}
STAGE_ORDER = ("L1", "attention", "conv", "GroupNorm", "matmul", "other")


def log(msg: str) -> None:
    print(msg, flush=True)


def activations(params):
    with torch.no_grad():
        return (params.xyz.detach().contiguous(), params.get_scaling.contiguous(),
                params.get_rotation.contiguous(), params.get_opacity.contiguous(),
                params.get_features.contiguous())


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
        out = raster_tiles.blend_fwd_plain(tab, binning, bg, cam.width, cam.height)
    return out, binning.num_instances


def trace_summary(prof, units: int):
    """From a torch.profiler trace of `units` views or steps: the device ms
    per unit of each stage (by kernel name), the device's idle share of the
    traced span (first event to last device event; the profiler's own host
    cost widens the gaps), and the host ms per unit and count per unit of
    the read-backs (`aten::_local_scalar_dense`)."""
    stage_us, spans, readback_us, readbacks = {}, [], 0.0, 0
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
        elif evt.name == "aten::_local_scalar_dense":
            readback_us += end - start
            readbacks += 1
    ms = {k: v / 1e3 / units for k, v in stage_us.items()}
    return ms, idle_share(spans, first, last), readback_us / 1e3 / units, readbacks / units


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


def phase_build():
    t0 = time.perf_counter()
    path, compile_s, build_log = _build.build()
    _build.library()
    regs = [ln.split(":", 1)[1].strip() for ln in build_log.splitlines() if "Used" in ln]
    log(f"phase 2 build: {path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {compile_s:.1f} s) | ptxas: {'; '.join(regs)}")


def bound(n_bytes: float, n_flops: float, peak_flops: float = PEAK_F32_FLOPS):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak of their type (f32 unless
    given). Returns (ms, bound_by)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def evaluated_pairs(tab, binning, width: int, height: int):
    """(instance, pixel) pairs the blend evaluates on this data, by class:
    (blended, walked but not blended). Each pixel inside the image walks
    its tile's instances up to and including the one that stops it (the
    plain version's closed form of K4's rule)."""
    gx = binning.grid_x
    blended = walked_total = 0
    with torch.no_grad():
        for t0, t1 in raster_tiles._tile_batches(binning.tile_count.tolist(),
                                                  raster_tiles.PLAIN_BATCH_ELEMS):
            q = raster_tiles.tile_batch(tab, binning, t0, t1)
            walked = (torch.cumsum(q.trigger.int(), dim=1) - q.trigger.int() == 0) & q.valid[:, :, None]
            tids = torch.arange(t0, t1, device=tab.device)
            lin = torch.arange(raster_tiles.TILE_PIX, device=tab.device)
            inside = ((tids % gx)[:, None] * 16 + lin[None, :] % 16 < width) & \
                ((tids // gx)[:, None] * 16 + lin[None, :] // 16 < height)
            walked_total += int((walked.sum(1) * inside).sum())
            blended += int((q.include.sum(1) * inside).sum())
    return blended, walked_total - blended


def check_rows(got, want, atol, rtol):
    """Rows of `got` within atol * max |want| of the column + rtol |want|:
    (fraction of rows outside, max abs err)."""
    err = (got - want).abs()
    scale = want.abs().amax(dim=0, keepdim=True)
    bad_rows = (err > atol * scale + rtol * want.abs()).any(dim=1)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite values")
    return bad_rows.float().mean().item(), err.max().item()


def phase_kernels(dev):
    rng = np.random.default_rng(SEED)
    params = params_from_numpy(synthetic.room_gaussians(N_KERNEL_CHECK, rng), dev)
    _, cams = synthetic.orbit(N_CAMS, WIDTH, HEIGHT, HFOV, rng)
    cam = cams[7].raster_camera(dev)
    acts = activations(params)
    n = acts[0].shape[0]
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    res = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    # K1
    tab_k = preprocess_fused.preprocess_fused_fwd(*acts, cam, 3, 1.0)
    tab_p = preprocess_fused.preprocess_table_plain(*acts, cam, 3, 1.0)
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
    n_in = sum(t.numel() for t in acts) * 4
    res["preprocess_fwd"] = dict(
        max_abs_err=k1_err,
        ms=median_ms(lambda: preprocess_fused.preprocess_fused_fwd(*acts, cam, 3, 1.0)),
        plain_ms=median_ms(lambda: preprocess_fused.preprocess_table_plain(*acts, cam, 3, 1.0)),
        # ~600 operations per Gaussian at SH 3 (transform, cov3D, EWA, conic, 48 SH products)
        bound=bound(n_in + 16 * 4 * n, 600 * n),
    )

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
    num_tiles = k3_args[-2]
    res["expand"] = dict(
        max_abs_err=k3_err,
        ms=median_ms(lambda: expand.expand_instances(*k3_args)),
        plain_ms=median_ms(lambda: expand.expand_instances_plain(*k3_args)),
        # reads 7 table rows + 5 int rows per Gaussian, writes 12 B per
        # instance and the histogram; ~60 operations per instance (tile cull)
        bound=bound(n * 12 * 4 + total * 12 + num_tiles * 4, 60 * total),
    )

    # K4, on the kernel binning
    binning = tiling.bin_gaussians(tab, radii, WIDTH, HEIGHT)
    img_k = raster_tiles._run_fwd(tab, binning, bg, WIDTH, HEIGHT)
    img_p = raster_tiles.blend_fwd_plain(tab, binning, bg, WIDTH, HEIGHT)
    torch.cuda.synchronize()
    k4_errs = {nm: check_k4(nm, a, b) for nm, a, b in zip(("color", "depth", "alpha"), img_k, img_p)}
    k4_err = max(k4_errs.values())
    blended, culled = evaluated_pairs(tab, binning, WIDTH, HEIGHT)
    hw = WIDTH * HEIGHT
    res["blend_fwd"] = dict(
        max_abs_err=k4_err,
        ms=median_ms(lambda: raster_tiles._run_fwd(tab, binning, bg, WIDTH, HEIGHT)),
        plain_ms=median_ms(lambda: raster_tiles.blend_fwd_plain(tab, binning, bg, WIDTH, HEIGHT)),
        # 40 B of fields + 4 B id per binned instance, 5 f32 out per pixel
        bound=bound(total * 44 + num_tiles * 8 + hw * 20,
                    K4_BLENDED_FLOPS * blended + WALKED_FLOPS * culled),
    )

    # K5, on the kernel forward with seeded cotangents
    color, depth, alpha = img_k
    dC = torch.randn((3, HEIGHT, WIDTH), generator=gen, device=dev)
    dD = 0.1 * torch.randn((HEIGHT, WIDTH), generator=gen, device=dev)
    dA = torch.randn((HEIGHT, WIDTH), generator=gen, device=dev)
    bwd_args = (tab, binning, color, depth, alpha, dC, dD, dA, WIDTH, HEIGHT)
    gi_k = raster_tiles._run_bwd(*bwd_args)
    gi_p = raster_tiles.blend_bwd_plain(*bwd_args)
    torch.cuda.synchronize()
    k5_bad, k5_err = check_rows(gi_k, gi_p, K5_ATOL, K5_RTOL)
    if k5_bad > K5_STOP_FRACTION:
        raise AssertionError(f"K5: {k5_bad:.3g} of the instance rows outside the tolerance "
                             f"(allowed {K5_STOP_FRACTION}); max abs err {k5_err:.3g}")
    res["blend_bwd"] = dict(
        max_abs_err=k5_err,
        ms=median_ms(lambda: raster_tiles._run_bwd(*bwd_args)),
        plain_ms=median_ms(lambda: raster_tiles.blend_bwd_plain(*bwd_args)),
        # fields + id + slot per binned instance, 10 f32 in per pixel, 40 B out per instance
        bound=bound(total * 48 + num_tiles * 8 + hw * 40 + total * 40,
                    K5_BLENDED_FLOPS * blended + WALKED_FLOPS * culled),
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
        ms=median_ms(lambda: segsum.segment_sum_sorted(gi_k, off, cnt)),
        plain_ms=median_ms(lambda: segsum.segment_sum_sorted_plain(gi_k, off, cnt)),
        library_ms=median_ms(lambda: torch.segment_reduce(gi_k, "sum", lengths=cnt, axis=0)),
        bound=bound(total * 40 + n * 48, total * 10),
    )

    # K2, on seeded cotangents (culled rows none, as the rasterizer hands them)
    cot = torch.randn((10, n), generator=gen, device=dev) * (radii > 0).float()
    g_k = preprocess_fused.preprocess_fused_bwd(*acts, cam, 3, 1.0, cot)
    g_p = preprocess_fused.preprocess_fused_bwd_plain(*acts, cam, 3, 1.0, cot)
    torch.cuda.synchronize()
    k2_errs = {}
    for nm, a, b in zip(("means", "scales", "rotations", "opacity", "shs"), g_k, g_p):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"K2 {nm}: non-finite gradients")
        k2_errs[nm] = ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
        if k2_errs[nm] > K2_TOL:
            raise AssertionError(f"K2 {nm}: max abs err / max |grad| {k2_errs[nm]:.3g} > {K2_TOL}")
    res["preprocess_bwd"] = dict(
        max_abs_err=max((a - b).abs().max().item() for a, b in zip(g_k, g_p)),
        ms=median_ms(lambda: preprocess_fused.preprocess_fused_bwd(*acts, cam, 3, 1.0, cot)),
        plain_ms=median_ms(lambda: preprocess_fused.preprocess_fused_bwd_plain(*acts, cam, 3, 1.0, cot)),
        # reads the inputs and 10 cotangents, writes gradients shaped like
        # the inputs; ~1000 operations per Gaussian (recompute + reverse sweep)
        bound=bound(2 * n_in + 10 * 4 * n, 1000 * n),
    )

    def t(name):
        r = res[name]
        lib = f", library {r['library_ms']:.3f} ms" if "library_ms" in r else ""
        return (f"{r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} ms{lib}, bound {r['bound'][0]:.4f} ms "
                f"({r['bound'][1]})")

    log(f"phase 3 kernels vs plain (N={N_KERNEL_CHECK}, {WIDTH}x{HEIGHT}, SH 3; "
        f"{total} instances; instance-pixel pairs walked {blended + culled}, blended {blended}): "
        f"K1 max abs err {k1_err:.3g} (tol {K1_ATOL} + {K1_RTOL} rel; radius mismatches {rad_bad}) "
        f"{t('preprocess_fwd')} | K3 keys/owners/hist exact, {t('expand')} | "
        f"K4 max abs err " + ", ".join(f"{k} {v:.3g}" for k, v in k4_errs.items())
        + f" (tol (atol, stop atol) {K4_TOL}, rtol {K4_RTOL}) {t('blend_fwd')} | "
        f"K5 max abs err {k5_err:.3g}, rows outside {K5_ATOL} max|g| + {K5_RTOL} |g|: {k5_bad:.3g} "
        f"(allowed {K5_STOP_FRACTION}) {t('blend_bwd')} | "
        f"K6 max abs err {res['segsum']['max_abs_err']:.3g} (tol count 2^-23 sum|g|) {t('segsum')} | "
        f"K2 max abs err / max |grad| " + ", ".join(f"{k} {v:.3g}" for k, v in k2_errs.items())
        + f" (tol {K2_TOL}) {t('preprocess_bwd')}")
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
    dev_ms, idle, readback_ms, readbacks = profile_views(params, test_cams, bg, PROFILE_REPS)

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
        f"read-backs/view {readbacks:g}, host wait {readback_ms:.3f} ms/view | "
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


def run_steps(trainer, iters: int, trace: range):
    """Steps 1..iters, each timed on the host clock (synchronised), with a
    torch.profiler trace over the steps of `trace`. Returns ({step: ms},
    losses, instances per step, the profiler)."""
    prof = torch.profiler.profile(activities=PROFILER_ACTIVITIES)
    step_ms, losses, instances = {}, [], []
    for it in range(1, iters + 1):
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
    return step_ms, losses, instances, prof


def check_launches(iters: int) -> dict:
    launches = dict(_build.LAUNCHES)
    if any(launches[n] != iters for n in GAUSSIAN_KERNELS) or launches["flash_attn_fwd"]:
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
    dev_ms, idle, rb_ms, rbs = trace_summary(prof, len(TRACE_STEPS))
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
        f"{rbs:g}, host wait {rb_ms:.3f} ms/step",
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
    rng = np.random.default_rng(SEED + 3)
    gt = synthetic.room_gaussians(N_SCENE, rng)
    _, pcams = synthetic.orbit(N_CAMS, WIDTH, HEIGHT, HFOV, rng)
    views = train_views(gt, pcams, dev)
    state = G.GaussianState.fresh(params_from_numpy(noisy_model(gt, rng), dev))
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
    dev_ms, idle, rb_ms, rbs = trace_summary(prof, len(DENSE_TRACE))
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
        f"{rbs:g}, host wait {rb_ms:.3f} ms/step",
    ]
    for line in lines:
        log("phase 5b " + line)


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
            rows.append(f"{shape} {str(dtype)[6:]}: err {err:.3g} (tol {L1_TOL[dtype]}), {r['ms']:.3f} ms "
                        f"vs plain {r['plain_ms']:.3f}, sdpa {r['library_ms']:.3f}, bound "
                        f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")
            del q, k, v, got, want
    log("phase 7a L1 vs plain (unit-normal inputs; median of 10, host clock with synchronize): "
        + " | ".join(rows))
    return res[L1_MAIN]


@contextlib.contextmanager
def timed(module, name: str, record: list):
    """Time every call of module.name (synchronised on both sides) into
    `record`, in ms, while the context is open."""
    fn = getattr(module, name)

    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        record.append((time.perf_counter() - t) * 1e3)
        return out

    with mock.patch.object(module, name, run):
        yield


@contextlib.contextmanager
def labelled_stages():
    """Run every diffusion function of STAGE_FNS inside a profiler range
    "stage:<stage>", so that a trace can sort the kernels by stage."""
    with contextlib.ExitStack() as stack:
        for module in (d_nnops, d_attention, unet3d):
            for name, stage in STAGE_FNS.items():
                fn = getattr(module, name, None)
                if fn is None:
                    continue

                def run(*args, _fn=fn, _label=f"stage:{stage}", **kwargs):
                    with torch.profiler.record_function(_label):
                        return _fn(*args, **kwargs)

                stack.enter_context(mock.patch.object(module, name, run))
        yield


def stage_summary(prof):
    """Device ms per stage of a trace under labelled_stages (L1 by its
    kernel name; the rest by the innermost "stage:" range above the op that
    launched the kernel; "other" takes what no range holds), the idle share
    of the traced span, and the device ms of the largest kernels of the
    "attention" stage by name."""
    stage_us = dict.fromkeys(STAGE_ORDER, 0.0)
    attn_kernels = {}
    spans, first, last, total = [], math.inf, -math.inf, 0.0
    for evt in prof.events():
        first = min(first, evt.time_range.start)
        if evt.name.startswith("stage:"):
            continue  # a range itself, also mirrored on the device's timeline
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            dur = evt.time_range.end - evt.time_range.start
            spans.append((evt.time_range.start, evt.time_range.end))
            last = max(last, evt.time_range.end)
            total += dur
            if "flash_attn" in evt.name:
                stage_us["L1"] += dur
        elif evt.kernels:
            p, stage = evt, None
            while p is not None and stage is None:
                if p.name.startswith("stage:"):
                    stage = p.name[len("stage:"):]
                p = p.cpu_parent
            for kern in evt.kernels:
                if stage is not None and "flash_attn" not in kern.name:
                    stage_us[stage] += kern.duration
                    if stage == "attention":
                        attn_kernels[kern.name] = attn_kernels.get(kern.name, 0.0) + kern.duration / 1e3
    idle = idle_share(spans, first, last)
    stage_us["other"] = total - sum(v for k, v in stage_us.items() if k != "other")
    top = sorted(attn_kernels.items(), key=lambda kv: -kv[1])[:4]
    return {k: v / 1e3 for k, v in stage_us.items()}, idle, top


def one_step(params, mcfg, scfg, cond, uncond, x, index, noise, plain=False):
    """One DDIM step of the request's sampler (CFG pair, then the update)."""
    sched = mcfg.schedule(x.device)
    pr = S.make_ddim_params(sched, scfg.ddim_steps, eta=scfg.ddim_eta, method=scfg.timestep_spacing)
    t = pr.timesteps[index].expand(x.shape[0])
    mo, _ = ddim.cfg_model_output(lambda x_, t_: apply_model(params, mcfg, x_, t_, cond, plain=plain),
                                  lambda x_, t_: apply_model(params, mcfg, x_, t_, uncond, plain=plain),
                                  x, t, scfg.cfg_scale, scfg.guidance_rescale)
    return ddim.ddim_step(sched, pr, index, x, mo, noise).x_prev


def phase_generate(dev, steps: int, trace_and_f32: bool = True) -> int:
    """7b (and 7c): one full-width request of `steps` DDIM steps through
    the engine a user calls, in bfloat16. Returns L1's launches in it."""
    mcfg = LatentDiffusionConfig(compute_dtype="bfloat16")
    scfg = synthesis.SynthesisConfig(ddim_steps=steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_diffusion_params(mcfg, scfg, seed=SEED, device=dev, dtype=BF16)
    engine = ViewCrafterEngine(params, mcfg, scfg, video_length=GEN_FRAMES, height=GEN_H, width=GEN_W)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
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
    if launches["flash_attn_fwd"] != expected or any(launches[n] for n in GAUSSIAN_KERNELS):
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
    with torch.no_grad():
        cond, uncond = synthesis.build_conditioning(params, mcfg, scfg, renders * 2.0 - 1.0,
                                                       generator=gen, text_pair=engine.text_pair)
        x = torch.randn(cond.concat.shape, generator=gen, device=dev)
        noise = torch.randn(x.shape, generator=gen, device=dev)
        index = steps // 2
        one_step(params, mcfg, scfg, cond, uncond, x, index, noise)
        torch.cuda.synchronize()
        with labelled_stages(), torch.profiler.profile(activities=PROFILER_ACTIVITIES) as prof:
            one_step(params, mcfg, scfg, cond, uncond, x, index, noise)
            torch.cuda.synchronize()
    dev_ms, idle, top = stage_summary(prof)
    log("phase 7b one DDIM step traced (bf16, CFG pair + update), device ms: "
        + " ".join(f"{k} {dev_ms[k]:.3f}" for k in STAGE_ORDER)
        + f" (total {sum(dev_ms.values()):.3f}), idle share {idle:.3f} (under the profiler); "
        "largest attention kernels: " + "; ".join(f"{name[:70]} {ms:.3f}" for name, ms in top))

    # 7c: one float32 step through L1 and through its plain version
    mcfg32 = dataclasses.replace(mcfg, compute_dtype="float32")
    params32 = params._replace(unet={k: v.float() for k, v in params.unet.items()})
    with torch.no_grad():
        before = _build.LAUNCHES["flash_attn_fwd"]
        got = one_step(params32, mcfg32, scfg, cond, uncond, x, index, noise)
        mid = _build.LAUNCHES["flash_attn_fwd"]
        want = one_step(params32, mcfg32, scfg, cond, uncond, x, index, noise, plain=True)
        torch.cuda.synchronize()
    if mid - before != 10 or _build.LAUNCHES["flash_attn_fwd"] != mid:
        raise AssertionError(f"7c: L1 launched {mid - before} times through the kernel path "
                             f"(expected 10), {_build.LAUNCHES['flash_attn_fwd'] - mid} through the plain one")
    err = (got - want).abs().max().item()
    if not (bool(torch.isfinite(got).all()) and err <= STEP_TOL):
        raise AssertionError(f"7c: the f32 step through L1 differs from the plain chain by {err:.3g}")
    log(f"phase 7c one f32 DDIM step (TF32 off) at index {index}, L1 vs its plain version: latent max abs "
        f"diff {err:.3g} (tol {STEP_TOL}; max |latent| {got.abs().max().item():.3f})")
    return launches["flash_attn_fwd"]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--generate-only", type=int, metavar="STEPS", default=None,
                        help="run phases 1, 2 and 7b alone, with STEPS DDIM steps")
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
    res = run("3", phase_kernels, dev)
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=build_dir))
    try:
        run("4", phase_main, dev, work)
        launches = run("5", phase_train, dev)
        run("5b", phase_train_dense, dev)
        run("6", phase_cli, dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["flash_attn_fwd"] = run("7a", phase_l1, dev)
    launches["flash_attn_fwd"] = run("7b-7c", phase_generate, dev, GEN_STEPS)
    log("seconds per phase: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
        + f"; total {time.perf_counter() - start:.1f}")
    table = [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
             max_abs_err=res[name]["max_abs_err"], ms=res[name]["ms"],
             plain_ms=res[name]["plain_ms"], bound_ms=res[name]["bound"][0],
             bound_by=res[name]["bound"][1], library_ms=res[name].get("library_ms"))
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
