"""The oracle-guided acceptance run of the port on the tool-default scene.

    python scripts/guided_oracle_e2e.py --out build/e2e [--iterations 10000] [--seed 1] [--device cuda]

For each of two versions of the tool-default synthetic scene (624x352, 60
cameras, 6 train views, 150,000 ground-truth Gaussians): the images as the
reference's tool renders them (`scripts/synthetic_reference_gt.py`: without
the instances its renderer drops) and the exact images (`make_scene`), it
trains the port's baseline (`train_baseline`, --iterations), then the
oracle-guided run on it (`train_guidedvd --oracle_gt_npz`, the reference's
flags otherwise: events every 260 iterations, pseudo views between 2000
and 9500), and scores both with the render and metrics CLIs. It prints the
test PSNR / SSIM of each (and the PSNR of each test view), the guided run's split between training and
events (`timing_summary.json`), and the capacity count: every frame of
every pool trajectory (the trajectories an event draws from) as the JAX
package's CLI renders it, against the fixed capacity of its chain, each
Gaussian taking max(tiles, 1) slots. The frozen baseline (the tile
backend) binds groups of five frames into one chain of max(4 N 5, 16384)
slots (N = its state's power-of-two capacity); the oracle (its CLI's
--oracle_backend auto, whose FrozenRenderer renders frame by frame) one
frame into max(4 N, 16384) slots (N = the ground truth's 150,000 rows),
the capacity the scene's reference images were rendered at. A group or
frame above its capacity dropped instances. A third run
(`reference_capacity`) trains the guided model on the reference's images
again, from the same baseline, with the oracle's frames rendered as the
JAX package's oracle renders them: each frame its own chain of that
capacity, slots given in Gaussian order, the Gaussians past the capacity
dropped, and the one that straddles it kept in its first slots: the
first tiles of its rectangle walked row by row
(`render_group_as_reference`). `--runs reference_capacity` alone trains
the baseline of the reference images and this run. `--runs` picks the
runs; `--seed` goes to both CLIs (the train views' order, the pool's and
the events' draws; the scene is the same at every seed), so runs at
several seeds measure the spread. Each guided run's pseudo-L1 curve is
read from its `metrics.jsonl` every 100 iterations: train/pseudo_l1 (the
logged step's, as the JAX package's train_scan logs it), printed beside
the JAX package's own run of the same scene where its log is in the
repository (`output/synthetic_oracle_e2e_r5`, a TPU run). The last line is one JSON object of these
numbers; it is also written to `<out>/guided_e2e.json`.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from guidedvd3dgs_tpu_torch import metrics as port_metrics  # noqa: E402
from guidedvd3dgs_tpu_torch import render as port_render  # noqa: E402
from guidedvd3dgs_tpu_torch import train_baseline as port_train_cli  # noqa: E402
from guidedvd3dgs_tpu_torch import train_guidedvd as port_guided_cli  # noqa: E402
from guidedvd3dgs_tpu_torch.models.gaussians import GaussianParams  # noqa: E402
from guidedvd3dgs_tpu_torch.render import resolve_device  # noqa: E402
from guidedvd3dgs_tpu_torch.scene import synthetic  # noqa: E402
from guidedvd3dgs_tpu_torch.scene.cameras import camera_from_w2c_K  # noqa: E402

GROUP = 5  # frames the reference's FrozenRenderer.render_many binds into one chain (tile backend)
ORACLE_GROUP = 1  # frames its oracle's renderer binds (backend auto: frame by frame)
JAX_LOG = ROOT / "output" / "synthetic_oracle_e2e_r5" / "metrics.jsonl"
CURVE_ITERS = (2100, 2600, 3000, 5000, 8000, 9500)  # where the JAX run's pseudo_l1 is quoted
QUANTUM = 512
TILE = 16


def _reference_gt():
    spec = importlib.util.spec_from_file_location("synthetic_reference_gt",
                                                  ROOT / "scripts" / "synthetic_reference_gt.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def chain_capacity(rows: int, frames: int = GROUP) -> int:
    """The reference's default capacity of a chain of `frames` frames of a
    state of `rows` rows."""
    return -(-max(4 * rows * frames, 1 << 14) // QUANTUM) * QUANTUM


def pow2_capacity(n: int) -> int:
    """The reference's state capacity of a loaded model (default_capacity)."""
    return 1 << max(10, int(np.ceil(np.log2(max(n, 1) * 4))))


def capacity_count(trainer, params, rows: int, ref, group: int = GROUP) -> dict:
    """Slots each `group`-frame group of every pool trajectory takes
    (padding rows beyond the params' own take one slot a frame) against
    chain_capacity(rows, group)."""
    cap = chain_capacity(rows, group)
    pad = rows - params.xyz.shape[0]
    demand = []
    for entries in trainer.trajectory_pool.values():
        for e in entries:
            slots = []
            for c2w in e.traj_c2ws:
                cam = camera_from_w2c_K(np.linalg.inv(c2w), trainer.intrinsic, trainer.H, trainer.W)
                count = ref.tile_counts(params, cam.raster_camera(params.xyz.device), trainer.W, trainer.H)
                slots.append(int(torch.clamp(count, min=1).sum()) + pad)
            demand += [sum(slots[i:i + group]) for i in range(0, len(slots), group)]
    demand = np.asarray(demand)
    return dict(rows=rows, capacity=cap, groups=int(demand.size), groups_over=int((demand > cap).sum()),
                max_slots=int(demand.max()), max_share=float(demand.max() / cap),
                slots_over=int(np.clip(demand - cap, 0, None).sum()))


class ReferenceCapacityOracle:
    """An oracle engine whose frames drop what the reference's oracle drops
    (module docstring)."""

    def __init__(self, oracle, ref):
        self.oracle, self.ref = oracle, ref
        self.video_length, self.height, self.width = oracle.video_length, oracle.height, oracle.width
        self.renderer = oracle.renderer
        self.dropped = []  # instances the reference drops, per group

    def set_trajectory(self, w2cs, K):
        self.oracle.set_trajectory(w2cs, K)

    def generate(self, *args, **kwargs):
        n = self.renderer.params.xyz.shape[0]
        w2cs, K = self.oracle._w2cs, self.oracle._K
        frames = []
        for g0 in range(0, len(w2cs), ORACLE_GROUP):
            group, dropped = render_group_as_reference(self.renderer, w2cs[g0:g0 + ORACLE_GROUP], K, self.height,
                                                       self.width, chain_capacity(n, ORACLE_GROUP), self.ref)
            self.dropped.append(dropped)
            frames += group
        return torch.clamp(torch.stack(frames), 0.0, 1.0)


def render_group_as_reference(renderer, w2cs, K, height: int, width: int, capacity: int, ref):
    """The colour (3, H, W) of each frame of one chain of the reference's
    batched renderer, and the instances it drops. The frames' Gaussians
    take max(tiles, 1) slots each, frame by frame in index order; slots
    from `capacity` on are dropped. A Gaussian whose slots lie past it is
    left out; the one that straddles it keeps its first slots, the first
    tiles of its rectangle walked row by row. A tile's pixels depend only on
    the instances binned to it, so that frame is the render without the
    straddler where it lost its tile and the render with it where it kept
    it."""
    params, dev = renderer.params, renderer.device
    n = params.xyz.shape[0]
    rects = [ref.tile_rects(params, camera_from_w2c_K(w, K, height, width).raster_camera(dev), width, height)
             for w in w2cs]
    counts = torch.cat([r[3] for r in rects]).long()
    kept, dropped, _ = ref.reference_drop(counts, capacity)
    end = torch.cumsum(torch.clamp(counts, min=1), 0)
    start = end - torch.clamp(counts, min=1)
    straddle = torch.nonzero((start < capacity) & (end > capacity) & (counts > 0)).flatten()

    def render(keep, w):
        sub = GaussianParams(**{k: v[keep] for k, v in params.tensors().items()})
        return type(renderer)(sub, renderer.sh_degree, backend=renderer.backend).render(w, K, height, width)[0]

    frames = []
    for j, w in enumerate(w2cs):
        keep = kept[j * n:(j + 1) * n].clone()
        img = render(keep, w)
        for g in straddle.tolist():
            if g // n != j:
                continue
            i = g - j * n
            rmx, rmy, rw, _, _ = (x[i] if torch.is_tensor(x) else x for x in rects[j])
            tiles = torch.zeros((-(-height // TILE), -(-width // TILE)), dtype=torch.bool, device=dev)
            for slot in range(capacity - int(start[g])):
                tiles[int(rmy) + slot // int(rw), int(rmx) + slot % int(rw)] = True
            pix = tiles.repeat_interleave(TILE, 0).repeat_interleave(TILE, 1)[:height, :width]
            keep[i] = True
            img = torch.where(pix, render(keep, w), img)
        frames.append(img)
    return frames, dropped


def pseudo_l1_curve(metrics_jsonl: Path) -> dict:
    """{iteration: pseudo_l1} of a guided run's log (the train/ scalars
    every 100 iterations)."""
    curve = {}
    for line in metrics_jsonl.read_text().splitlines():
        rec = json.loads(line)
        if "train/pseudo_l1" in rec:
            curve[int(rec["step"])] = rec["train/pseudo_l1"]
    return curve


def run_scene(name: str, src: Path, out: Path, iters: int, dev, ref, base: Path = None,
              reference_capacity: bool = False, seed: int = 1, guided_run: bool = True) -> dict:
    """Train the baseline (unless `base` is given), then, with `guided_run`,
    the guided run on it; score both."""
    guided = out / f"{name}_guided"
    common = ["-s", str(src), "--dataset", "colmap", "--n_views", "6", "--eval",
              "--iterations", str(iters), "--test_iterations", str(iters),
              "--save_iterations", str(iters), "--seed", str(seed), "--device", dev.type]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    base_s = None
    if base is None:
        base = out / f"{name}_baseline"
        t0 = time.perf_counter()
        port_train_cli.main(common + ["-m", str(base)])
        sync()
        base_s = time.perf_counter() - t0
    if not guided_run:
        return dict(scene=name, iterations=iters, seed=seed, baseline_s=base_s)
    build_engine = port_guided_cli.build_engine
    if reference_capacity:
        port_guided_cli.build_engine = lambda *a: ReferenceCapacityOracle(build_engine(*a), ref)
    t0 = time.perf_counter()
    try:
        trainer = port_guided_cli.main(common + [
            "-m", str(guided), "--baseline_path", str(base), "--baseline_iteration", str(iters),
            "--oracle_gt_npz", str(src / "gt_gaussians.npz")])
    finally:
        port_guided_cli.build_engine = build_engine
    sync()
    guided_s = time.perf_counter() - t0
    scores = {}
    # the renders are named by their place among the test cameras
    test_ids = json.loads((src / "train_test_split_6.json").read_text())["test_ids"]
    camera_names = [f"{test_ids.index(i):05d}.png" for i in (5, 15, 35)]
    for mdl in (base, guided):
        port_render.main(["-m", str(mdl), "--skip_train", "--device", dev.type])
        port_metrics.evaluate([str(mdl)], device=dev.type)
        res = json.loads((mdl / "results.json").read_text())[f"ours_{iters}"]
        per_view = json.loads((mdl / "per_view.json").read_text())[f"ours_{iters}"]["PSNR"]
        scores[mdl.name] = {"PSNR": res["PSNR"], "SSIM": res["SSIM"],
                            "PSNR_per_view": [per_view[k] for k in sorted(per_view)],
                            "PSNR_cameras_5_15_35": [per_view[k] for k in camera_names]}
    frozen_n = trainer.frozen.params.xyz.shape[0]
    out_rec = dict(
        scene=name, iterations=iters, seed=seed, baseline_s=base_s, guided_s=guided_s, scores=scores,
        timing=json.loads((guided / "timing_summary.json").read_text()),
        events_run=trainer.events_run, gaussians=trainer.state.num_gaussians,
        capacity_oracle=capacity_count(trainer, trainer.engine.renderer.params,
                                       trainer.engine.renderer.params.xyz.shape[0], ref, ORACLE_GROUP),
        capacity_frozen=capacity_count(trainer, trainer.frozen.params, pow2_capacity(frozen_n), ref),
        pseudo_l1=pseudo_l1_curve(guided / "metrics.jsonl"),
    )
    if reference_capacity:
        out_rec["oracle_dropped_per_group"] = trainer.engine.dropped
    print(f"[{name}] " + json.dumps(out_rec), flush=True)
    return out_rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--iterations", type=int, default=10_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", default="reference,exact,reference_capacity")
    ap.add_argument("--seed", type=int, default=1)
    a = ap.parse_args(argv)
    runs = a.runs.split(",")
    dev = resolve_device(a.device)
    out = Path(a.out)
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    ref = _reference_gt()
    s_ref, s_exact = out / "scene_reference", out / "scene_exact"
    records = []
    if "reference" in runs or "reference_capacity" in runs:
        ref.main(["--out", str(s_ref), "--device", dev.type])
        records.append(run_scene("reference", s_ref, out, a.iterations, dev, ref, seed=a.seed,
                                 guided_run="reference" in runs))
    if "exact" in runs:
        synthetic.make_scene(str(s_exact), device=dev)
        records.append(run_scene("exact", s_exact, out, a.iterations, dev, ref, seed=a.seed))
    if "reference_capacity" in runs:
        records.append(run_scene("reference_capacity", s_ref, out, a.iterations, dev, ref,
                                 base=out / "reference_baseline", reference_capacity=True, seed=a.seed))
    for r in records:
        if "scores" not in r:
            continue  # the baseline of reference_capacity alone: scored in its record
        b = r["scores"].get(f"{r['scene']}_baseline") or r["scores"]["reference_baseline"]
        g = r["scores"][f"{r['scene']}_guided"]
        t = r["timing"]
        print(f"{r['scene']} images, seed {r['seed']}: baseline PSNR {b['PSNR']:.4f} SSIM {b['SSIM']:.5f}; oracle-guided "
              f"PSNR {g['PSNR']:.4f} SSIM {g['SSIM']:.5f}; guided run {t['total_s']:.3f} s = training "
              f"{t['train_s']:.3f} + events {t['event_s']:.3f} ({t['events_run']} events: "
              + ", ".join(f"{k} {v:.3f}" for k, v in t["event_phase_s"].items())
              + f"); cameras 5 / 15 / 35: baseline {b['PSNR_cameras_5_15_35']}, guided "
              f"{g['PSNR_cameras_5_15_35']}; capacity: oracle {r['capacity_oracle']}, frozen {r['capacity_frozen']}",
              flush=True)
        jax_curve = pseudo_l1_curve(JAX_LOG) if JAX_LOG.exists() else {}
        if r["pseudo_l1"]:
            print(f"{r['scene']} pseudo_l1 at " + "; ".join(
                f"{it}: {r['pseudo_l1'][it]:.5f} (JAX r5 "
                + (f"{jax_curve[it]:.5f})" if it in jax_curve else "-)")
                for it in CURVE_ITERS if it in r["pseudo_l1"]), flush=True)
        if not (math.isfinite(g["PSNR"]) and math.isfinite(b["PSNR"])):
            raise AssertionError(f"non-finite scores: {r['scores']}")
    line = json.dumps({"guided_e2e": records})
    (out / "guided_e2e.json").write_text(line)
    print(line)


if __name__ == "__main__":
    main()
