"""Does the JAX package's packed raster arithmetic, or its chunked
trainer, move the guided result?

    python scripts/pack_fields_parity.py [--steps 1000] [--out build/pack_parity]   (CPU)

The JAX package trains on its tile rasterizer with opacity and RGB carried
through the binning sort as f16 pairs (`guidedvd3dgs_tpu/ops/tiling.py`,
`set_pack_fields`) and its per-instance gradients reduced as bf16 pairs
(`ops/raster_tiles.py`, `set_pack_grads`), both on by default; the port
has neither. JAX's CLI trains through `GuidedTrainer.train_scan` (every
span between schedule events one scan, the train and pseudo views one
B-camera chain), not through its `step`. This script trains the JAX guided
trainer on the tile path in interpret mode three times step by step, with
both packings on (`jax_pack`, the default), the fields' off (`jax_nopack`)
and both off (`jax_exact`), once through `train_scan` with both off
(`jax_scan`), and the port's trainer once (`port`), from the same start: the three 40x40
views and the anisotropic 96-point start of
tests/test_torch_guided_densify.py at SH degree 0, the oracle engine on
the 80 ground-truth Gaussians that render the views (5-frame events every
40 steps), pseudo views from the first step, densification every 50 steps
up to 160 (the split noise of the JAX package's keys in both), `--steps`
guided steps (the last without Adam, as `train_scan` ends). Each run is
its own process (the packing switches are read when JAX traces). It
prints, for each pair of runs, the Gaussian counts (at every step, or at
each boundary of the scan where `jax_scan` is one of the pair), each
parameter's max abs difference over its largest magnitude, the largest
difference of a step's loss (at those steps), and the exact test PSNR (the
port's dense renderer on each final state, three held-out views rendered
from the ground truth); the last line is one JSON object of these.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import numpy as np  # noqa: E402

MODES = ("jax_pack", "jax_nopack", "jax_exact", "jax_scan", "port")
PARAMS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
CAPACITY = 4096
TEST_Z = (-4.2, -3.8, -4.4)


def run(mode: str, steps: int, out: Path) -> None:
    import jax
    import jax.numpy as jnp
    import torch

    from guidedvd3dgs_tpu.models import gaussians as JG
    from guidedvd3dgs_tpu.ops import raster_tiles as jrt
    from guidedvd3dgs_tpu.ops import tiling as jtiling
    from guidedvd3dgs_tpu.ops.raster_dense import rasterize_dense
    from guidedvd3dgs_tpu.train import guided as jg
    from guidedvd3dgs_tpu_torch.convert import params_from_numpy, state_from_numpy
    from guidedvd3dgs_tpu_torch.models.render import render_gaussians
    from guidedvd3dgs_tpu_torch.scene import cameras as port_cameras
    from guidedvd3dgs_tpu_torch.train import guided as pg
    from helpers import activated, make_camera, random_gaussians
    from test_train_baseline import FakeModelParams, FakePipe, FakeScene, make_synthetic
    from test_train_guided import GuidedOpt, _intrinsic

    torch.set_num_threads(2)
    opt = lambda: GuidedOpt(iterations=steps, start_sample_pseudo=0, end_sample_pseudo=steps + 5,  # noqa: E731
                            densification_interval=50, densify_from_iter=2, prune_from_iter=2,
                            densify_until_iter=160, densify_grad_threshold=2e-5, opacity_reset_interval=10 ** 6,
                            guidance_vd_iter=40, position_lr_max_steps=steps + 10)
    cams = make_synthetic()
    gt_raw = random_gaussians(n=80, seed=42)
    gt_act = activated(*gt_raw)
    xyz, ls, rots, opl, sh = gt_raw
    npz = out / f"gt_{mode}.npz"
    np.savez(npz, xyz=xyz, f_dc=sh[:, :1], f_rest=sh[:, 1:], scaling=ls,
             rotation=rots / np.linalg.norm(rots, axis=-1, keepdims=True), opacity=opl)
    test = []
    for i, z in enumerate(TEST_Z):
        cam = make_camera(height=40, width=40, cam_z=z, look_noise=0.3, seed=10 + i)
        img = rasterize_dense(*(jnp.asarray(p) for p in gt_act), cam.raster_camera(), jnp.zeros(3)).color
        test.append((cam, np.clip(np.asarray(img), 0, 1)))
    rng = np.random.default_rng(7)
    pts = rng.normal(scale=1.2, size=(96, 3)).astype(np.float32)
    cols = rng.uniform(size=(96, 3)).astype(np.float32)
    jstate = JG.create_from_pcd(pts, cols, capacity=CAPACITY)
    p = jstate.params
    scaling = np.asarray(p.scaling).copy()
    scaling[:96] += rng.uniform(-0.5, 0.5, (96, 3)).astype(np.float32)
    rotation = np.asarray(p.rotation).copy()
    rotation[:96] = rng.normal(size=(96, 4)).astype(np.float32)
    jstate = jstate._replace(params=p._replace(scaling=jnp.asarray(scaling), rotation=jnp.asarray(rotation)))
    gt_state = JG.create_from_pcd(np.asarray(gt_act[0]), np.ones((80, 3)) * 0.5, capacity=128)
    K = _intrinsic(cams[0])
    if mode.startswith("jax"):
        jrt.set_interpret(True)
        jtiling.set_pack_fields(mode == "jax_pack")
        jrt.set_pack_grads(mode in ("jax_pack", "jax_nopack"))
        tr = jg.GuidedTrainer(
            FakeScene(cams, extent=3.0), jstate, opt(), FakePipe(raster_backend="tiles"),
            FakeModelParams(sh_degree=0), frozen=jg.FrozenRenderer(gt_state, sh_degree=0, backend="dense"),
            engine=jg.OracleDiffusionEngine(str(npz), video_length=5, height=40, width=40, sh_degree=3,
                                            backend="dense"),
            pcd_points=pts, pcd_colors=cols, guidance_intrinsic=K)
    else:
        pcams = [port_cameras.Camera(colmap_id=0, R=c.R, T=c.T, FoVx=c.FoVx, FoVy=c.FoVy, image=c.image)
                 for c in cams]
        tr = pg.GuidedTrainer(
            FakeScene(pcams, extent=3.0), state_from_numpy(jax.device_get(jstate)), opt(),
            FakePipe(raster_backend="tiles"), FakeModelParams(sh_degree=0),
            frozen=pg.FrozenRenderer(state_from_numpy(jax.device_get(gt_state)).params, 0, backend="dense"),
            engine=pg.OracleDiffusionEngine(str(npz), video_length=5, height=40, width=40, sh_degree=3,
                                            backend="dense", device="cpu"),
            pcd_points=pts, pcd_colors=cols, guidance_intrinsic=K)

        def split_noise(iteration):
            key = jax.random.key(iteration)
            return torch.from_numpy(np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i),
                                                                           (CAPACITY, 3))) for i in range(2)]))

        tr.split_noise = split_noise
    tr.init_trajectory_pool()
    t0 = time.time()
    log = []
    if mode == "jax_scan":
        class Boundaries:  # what train_scan logs at each boundary of its spans
            def scalars(self, step, values, prefix=""):
                if "total_points" in values:
                    log.append((step, values["loss"], int(values["total_points"]), int(tr.events_run)))

        tr.attach_logger(Boundaries())
        tr.train_scan(iterations=steps, log_every=1)
    else:
        for it in range(1, steps + 1):
            s = tr.step(it)
            log.append((it, float(s.loss), int(s.num_active), int(tr.events_run)))
    if mode.startswith("jax"):
        st = jax.device_get(tr.state)
        act = np.asarray(st.active)
        params = {k: np.asarray(getattr(st.params, k))[act] for k in PARAMS}
    else:
        params = {k: v.detach().numpy() for k, v in tr.state.params.tensors().items()}
    pp = params_from_numpy(params, "cpu")
    psnrs = []
    for cam, img in test:
        pc = port_cameras.Camera(colmap_id=0, R=cam.R, T=cam.T, FoVx=cam.FoVx, FoVy=cam.FoVy, image=img)
        r = render_gaussians(pp, pc.raster_camera("cpu"), torch.zeros(3), 0, backend="dense")
        psnrs.append(float(10 * np.log10(1.0 / ((r.color.detach().clamp(0, 1).numpy() - img) ** 2).mean())))
    np.savez(out / f"{mode}.npz", **params, psnrs=np.asarray(psnrs), log=np.asarray(log),
             seconds=np.asarray(time.time() - t0))


def compare(out: Path) -> dict:
    runs = {m: np.load(out / f"{m}.npz") for m in MODES}
    rec = {m: dict(gaussians=int(r["xyz"].shape[0]), test_psnr=float(r["psnrs"].mean()),
                   test_psnr_per_view=[float(x) for x in r["psnrs"]], seconds=float(r["seconds"]))
           for m, r in runs.items()}
    pairs = []
    for a, b in (("jax_pack", "jax_nopack"), ("jax_nopack", "jax_exact"), ("jax_pack", "jax_exact"),
                 ("jax_exact", "port"), ("jax_pack", "port"), ("jax_scan", "jax_exact"), ("jax_scan", "port")):
        ra, rb = runs[a], runs[b]
        la, lb = ra["log"], rb["log"]
        # the steps both logged: every step, or the scan's boundaries
        its = np.intersect1d(la[:, 0], lb[:, 0])
        la, lb = (l[np.searchsorted(l[:, 0], its)] for l in (la, lb))
        pr = dict(a=a, b=b, psnr_diff=rec[a]["test_psnr"] - rec[b]["test_psnr"], compared_steps=int(its.size),
                  counts_equal=bool((la[:, 2] == lb[:, 2]).all()),
                  max_loss_diff=float(np.abs(la[:, 1] - lb[:, 1]).max()))
        if ra["xyz"].shape == rb["xyz"].shape:
            pr["param_err"] = {n: float(np.abs(ra[n] - rb[n]).max() / max(np.abs(ra[n]).max(), 1e-30))
                               for n in PARAMS}
        pairs.append(pr)
        print(f"{a} vs {b}: " + json.dumps(pr), flush=True)
    for m, r in rec.items():
        print(f"{m}: {r['gaussians']} Gaussians, exact test PSNR {r['test_psnr']:.4f} "
              f"({', '.join(f'{x:.4f}' for x in r['test_psnr_per_view'])}), {r['seconds']:.0f} s", flush=True)
    return dict(runs=rec, pairs=pairs)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--out", default=str(ROOT / "build" / "pack_parity"))
    ap.add_argument("--run", choices=MODES, default=None, help="one run (the script starts these itself)")
    a = ap.parse_args(argv)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    if a.run:
        run(a.run, a.steps, out)
        return
    procs = [subprocess.Popen([sys.executable, __file__, "--run", m, "--steps", str(a.steps), "--out", str(out)],
                              stdout=subprocess.DEVNULL) for m in MODES]
    rcs = [p.wait() for p in procs]
    if any(rcs):
        raise SystemExit(f"runs failed: {dict(zip(MODES, rcs))}")
    print(json.dumps(dict(steps=a.steps, **compare(out))))


if __name__ == "__main__":
    main()
