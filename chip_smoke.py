#!/usr/bin/env python3
"""Run the PyTorch port's serving path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and the exit code is
non-zero; there is no CPU fallback):
  1. device   the card's name and power limit (nvidia-smi); TF32 off
  2. build    nvcc builds the kernels from csrc/ into build/torch_kernels/
  3. kernels  K1, K3, K4 against their plain PyTorch versions on the card,
              on a 200,000-Gaussian room at 640x480, SH degree 3: max abs
              error against the stated tolerance, median ms of each
  4. main     a 1,000,000-Gaussian, SH degree 3 room at 640x480, hfov 90
              (the Replica camera), written in the colmap layout, rendered
              by `guidedvd3dgs_tpu_torch.render.main` and scored by
              `guidedvd3dgs_tpu_torch.metrics.evaluate`; the kernel launch
              counts of that run, the render time per view, the device
              time per stage and idle share from one torch.profiler trace
              of `eval_render` on the test views, and one view against
              the chain of plain versions
  5. result   the last line: {"ok": true, "device": {...}}
The line before the last is the JSON kernel table.
"""

from __future__ import annotations

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

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from guidedvd3dgs_tpu_torch import metrics as port_metrics  # noqa: E402
from guidedvd3dgs_tpu_torch import render as port_render  # noqa: E402
from guidedvd3dgs_tpu_torch.convert import params_from_numpy  # noqa: E402
from guidedvd3dgs_tpu_torch.models.render import eval_render  # noqa: E402
from guidedvd3dgs_tpu_torch.ops import _build, expand, preprocess_fused, raster_tiles, tiling  # noqa: E402
from guidedvd3dgs_tpu_torch.scene import synthetic  # noqa: E402

SEED = 20261016
WIDTH, HEIGHT, HFOV = 640, 480, 90.0
N_KERNEL_CHECK = 200_000
N_SCENE = 1_000_000
N_CAMS = 60
ITERATION = 10_000

KERNELS = {
    "preprocess_fwd": ("guidedvd3dgs_tpu_torch/csrc/preprocess_fwd.cu",
                       "guidedvd3dgs_tpu/ops/preprocess_pallas.py:173"),
    "expand": ("guidedvd3dgs_tpu_torch/csrc/expand.cu", "guidedvd3dgs_tpu/ops/expand.py:249"),
    "blend_fwd": ("guidedvd3dgs_tpu_torch/csrc/blend_fwd.cu",
                  "guidedvd3dgs_tpu/ops/raster_tiles.py:426"),
}
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
                 ("K4", "blend_fwd_kernel"), ("sort", "sort"))
PROFILE_REPS = 3


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


def profile_views(params, cams, bg, reps: int):
    """Trace `eval_render` over the views with torch.profiler. Returns the
    device ms per view of each stage (by kernel name), the device's idle
    share of the traced span (first event to last device event; the
    profiler's own host cost widens the gaps), and the host ms per view
    and count per view of the instance-count read-backs."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            for cam in cams:
                eval_render(params, cam, bg, 3)
        torch.cuda.synchronize()
    views = reps * len(cams)
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
    ms = {k: v / 1e3 / views for k, v in stage_us.items()}
    return ms, 1.0 - busy / (last - first), readback_us / 1e3 / views, readbacks / views


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


def phase_kernels(dev):
    rng = np.random.default_rng(SEED)
    params = params_from_numpy(synthetic.room_gaussians(N_KERNEL_CHECK, rng), dev)
    _, cams = synthetic.orbit(N_CAMS, WIDTH, HEIGHT, HFOV, rng)
    cam = cams[7].raster_camera(dev)
    acts = activations(params)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    res = {}

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
    res["preprocess_fwd"] = dict(
        max_abs_err=k1_err,
        ms=median_ms(lambda: preprocess_fused.preprocess_fused_fwd(*acts, cam, 3, 1.0)),
        plain_ms=median_ms(lambda: preprocess_fused.preprocess_table_plain(*acts, cam, 3, 1.0)),
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
    res["expand"] = dict(
        max_abs_err=k3_err,
        ms=median_ms(lambda: expand.expand_instances(*k3_args)),
        plain_ms=median_ms(lambda: expand.expand_instances_plain(*k3_args)),
    )

    # K4, on the kernel binning
    binning = tiling.bin_gaussians(tab, radii, WIDTH, HEIGHT)
    img_k = raster_tiles._run_fwd(tab, binning, bg, WIDTH, HEIGHT)
    img_p = raster_tiles.blend_fwd_plain(tab, binning, bg, WIDTH, HEIGHT)
    torch.cuda.synchronize()
    k4_errs = {nm: check_k4(nm, a, b) for nm, a, b in zip(("color", "depth", "alpha"), img_k, img_p)}
    k4_err = max(k4_errs.values())
    res["blend_fwd"] = dict(
        max_abs_err=k4_err,
        ms=median_ms(lambda: raster_tiles._run_fwd(tab, binning, bg, WIDTH, HEIGHT)),
        plain_ms=median_ms(lambda: raster_tiles.blend_fwd_plain(tab, binning, bg, WIDTH, HEIGHT)),
    )
    log(f"phase 3 kernels vs plain (N={N_KERNEL_CHECK}, {WIDTH}x{HEIGHT}, SH 3; "
        f"{total} instances): "
        f"K1 max abs err {k1_err:.3g} (tol {K1_ATOL} + {K1_RTOL} rel; radius mismatches {rad_bad}) "
        f"{res['preprocess_fwd']['ms']:.3f} ms vs plain {res['preprocess_fwd']['plain_ms']:.3f} ms | "
        f"K3 keys/owners/hist exact, {res['expand']['ms']:.3f} ms vs plain {res['expand']['plain_ms']:.3f} ms | "
        f"K4 max abs err " + ", ".join(f"{k} {v:.3g}" for k, v in k4_errs.items())
        + f" (tol (atol, stop atol) {K4_TOL}, rtol {K4_RTOL}) "
        f"{res['blend_fwd']['ms']:.3f} ms vs plain {res['blend_fwd']['plain_ms']:.3f} ms")
    return res


def phase_main(dev, work: Path):
    rng = np.random.default_rng(SEED + 1)
    gt = synthetic.room_gaussians(N_SCENE, rng)
    c2ws, cams = synthetic.orbit(N_CAMS, WIDTH, HEIGHT, HFOV, rng)
    bg = torch.zeros(3, device=dev)
    gt_params = params_from_numpy(gt, dev)
    images = [eval_render(gt_params, c.raster_camera(dev), bg, 3).color.clamp(0, 1).cpu().numpy()
              for c in cams]
    del gt_params
    model = {k: v.copy() for k, v in gt.items()}
    model["features_dc"] += rng.normal(scale=0.1, size=model["features_dc"].shape).astype(np.float32)
    model["opacity"] += rng.normal(scale=0.3, size=model["opacity"].shape).astype(np.float32)
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
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")

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
        + " ".join(f"{k} {v:.3f}" for k, v in sorted(dev_ms.items()))
        + f" (total {sum(dev_ms.values()):.3f}), idle share {idle:.3f} (under the profiler) | "
        f"read-backs/view {readbacks:g}, host wait {readback_ms:.3f} ms/view | "
        f"render CLI {render_cli_s:.1f} s | launches {launches} | "
        f"plain chain max abs err {chain_err:.3g}")
    return launches


def main() -> None:
    dev = phase_device()
    phase_build()
    res = phase_kernels(dev)
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=build_dir))
    try:
        launches = phase_main(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    table = [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
             max_abs_err=res[name]["max_abs_err"], ms=res[name]["ms"],
             plain_ms=res[name]["plain_ms"])
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
