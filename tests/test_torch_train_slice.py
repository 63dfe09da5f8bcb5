"""The baseline training slice, port against reference, on the CPU.

  - 8 steps of both trainers from one state (the reference's
    `create_from_pcd` with its scales made anisotropic and its rotations
    random, handed to the port by `state_from_numpy`) on the
    scene of tests/test_train_baseline.py, with one densification event at
    step 4 whose split noise is the reference's, fed to the port. The
    reference renders with its dense oracle, the port with its tile path
    (K1 -> binning -> K4, K5 -> K6 -> K2, plain on the CPU). The Gaussian
    counts agree exactly after every step, the losses within 1e-4, and
    every parameter (rows in order) within 1e-4 of its largest magnitude.
  - The port's CLI trains a tiny `make_scene` scene for 30 iterations; its
    render and metrics CLIs read what it saved.
  - `make_scene` builds the scene of tools/make_synthetic_scene.py (its
    draws in its order): the same Gaussians, cameras, init cloud and split.
"""

import dataclasses
import json
import math

import jax
import numpy as np
import torch

from guidedvd3dgs_tpu.models import gaussians as JG
from guidedvd3dgs_tpu.train.baseline import BaselineTrainer as JaxTrainer
from guidedvd3dgs_tpu_torch import metrics as port_metrics
from guidedvd3dgs_tpu_torch import render as port_render
from guidedvd3dgs_tpu_torch import train_baseline as port_train_cli
from guidedvd3dgs_tpu_torch.convert import state_from_numpy
from guidedvd3dgs_tpu_torch.models.gaussians import PARAM_NAMES
from guidedvd3dgs_tpu_torch.scene import cameras as port_cameras
from guidedvd3dgs_tpu_torch.scene import synthetic
from guidedvd3dgs_tpu_torch.scene.ply import fetch_ply
from guidedvd3dgs_tpu_torch.train.baseline import BaselineTrainer
from tools import make_synthetic_scene as tool

from test_train_baseline import FakeModelParams, FakeOpt, FakePipe, FakeScene, make_synthetic

torch.set_num_threads(2)

CAPACITY = 512
STEPS = 8


def jax_split_noise(iteration):
    key = jax.random.key(iteration)
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(key, i), (CAPACITY, 3))) for i in range(2)
    ]))


def test_eight_steps_with_a_densify_event_match_reference():
    cams = make_synthetic()
    rng = np.random.default_rng(7)
    pts = rng.normal(scale=1.2, size=(96, 3)).astype(np.float32)
    cols = rng.uniform(size=(96, 3)).astype(np.float32)
    jstate = JG.create_from_pcd(pts, cols, capacity=CAPACITY)
    # anisotropic, rotated Gaussians: an isotropic one has a rotation
    # gradient of pure rounding noise, which Adam's normalisation turns into
    # steps of +-lr in either package
    p = jstate.params
    scaling = np.asarray(p.scaling).copy()
    scaling[:96] += rng.uniform(-0.5, 0.5, (96, 3)).astype(np.float32)
    rotation = np.asarray(p.rotation).copy()
    rotation[:96] = rng.normal(size=(96, 4)).astype(np.float32)
    jstate = jstate._replace(params=p._replace(scaling=jax.numpy.asarray(scaling),
                                               rotation=jax.numpy.asarray(rotation)))
    opt = dataclasses.replace(
        FakeOpt(), iterations=STEPS, densification_interval=4, densify_from_iter=2,
        prune_from_iter=2, densify_until_iter=STEPS, densify_grad_threshold=1e-6,
    )
    pstate = state_from_numpy(jax.device_get(jstate))
    pcams = [port_cameras.Camera(colmap_id=0, R=c.R, T=c.T, FoVx=c.FoVx, FoVy=c.FoVy, image=c.image)
             for c in cams]
    jt = JaxTrainer(FakeScene(cams, extent=3.0), jstate, opt, FakePipe(), FakeModelParams())
    pt = BaselineTrainer(FakeScene(pcams, extent=3.0), pstate, opt, FakePipe(raster_backend="tiles"),
                         FakeModelParams(), split_noise=jax_split_noise)

    counts = []
    for it in range(1, STEPS + 1):
        js = jt.step(it)
        ps = pt.step(it)
        assert ps.num_active == js.num_active, (it, ps.num_active, js.num_active)
        assert abs(float(ps.loss) - js.loss) <= 1e-4, (it, float(ps.loss), js.loss)
        counts.append(ps.num_active)
    assert counts[0] == 96 and counts[-1] > 96  # the event at step 4 densified

    jfinal = jax.device_get(jt.state)
    act = np.asarray(jfinal.active)
    for name in PARAM_NAMES:
        want = np.asarray(getattr(jfinal.params, name))[act]
        got = getattr(pt.state.params, name).detach().numpy()
        assert got.shape == want.shape, name
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 1e-4, (name, err)
    assert pt.state.step == int(jfinal.step)


def test_cli_trains_a_tiny_scene_that_render_reads(tmp_path):
    src, mdl = tmp_path / "scene", tmp_path / "model"
    synthetic.make_scene(str(src), height=48, width=64, n_gt=3000, n_init=400, n_cams=12,
                         n_train=3, device="cpu")
    port_train_cli.main([
        "-s", str(src), "-m", str(mdl), "--dataset", "colmap", "--n_views", "3", "--eval",
        "--iterations", "30", "--test_iterations", "30", "--save_iterations", "30",
        "--checkpoint_iterations", "30", "--densify_from_iter", "10",
        "--densification_interval", "10", "--device", "cpu",
    ])
    ply = mdl / "point_cloud" / "iteration_30" / "point_cloud.ply"
    assert ply.exists() and (mdl / "chkpnt30.ckpt").exists()
    lines = [json.loads(x) for x in (mdl / "metrics.jsonl").read_text().splitlines()]
    assert any("test/psnr" in rec for rec in lines)
    port_render.main(["-m", str(mdl), "--skip_train", "--device", "cpu"])
    port_metrics.evaluate([str(mdl)], device="cpu")
    res = json.loads((mdl / "results.json").read_text())["ours_30"]
    assert math.isfinite(res["PSNR"]) and math.isfinite(res["SSIM"]) and res["PSNR"] > 5.0


def test_make_scene_builds_the_tools_scene(tmp_path):
    n_gt, n_init, n_cams, seed = 1500, 200, 10, 11
    src = tmp_path / "scene"
    info = synthetic.make_scene(str(src), height=24, width=40, n_gt=n_gt, n_init=n_init,
                                n_cams=n_cams, n_train=3, seed=seed, device="cpu")
    # the tool's main(), up to its renders, then its init cloud
    rng = np.random.default_rng(seed)
    pts, cols = tool.sample_room(rng, n_gt)
    gt = tool.build_gt_state(pts, cols, rng)
    c2ws = tool.orbit_cameras(n_cams, rng)
    sel = rng.choice(pts.shape[0], size=n_init, replace=False)
    init_pts = pts[sel] + rng.normal(scale=0.01, size=(n_init, 3)).astype(np.float32)
    init_cols = np.clip(cols[sel] + rng.normal(scale=0.05, size=(n_init, 3)).astype(np.float32), 0, 1)

    names = {"xyz": "xyz", "f_dc": "features_dc", "f_rest": "features_rest", "scaling": "scaling",
             "rotation": "rotation", "opacity": "opacity"}
    for k, name in names.items():
        np.testing.assert_allclose(info["gt"][name], np.asarray(gt[k]), rtol=1e-6, atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(info["c2ws"], c2ws)
    np.testing.assert_array_equal(info["init_pts"], init_pts)
    np.testing.assert_array_equal(info["init_cols"], init_cols)
    train_ids = [int(i) for i in np.linspace(0, n_cams, 3, endpoint=False).astype(int)]
    assert info["train_ids"] == train_ids
    assert info["test_ids"] == [i for i in range(0, n_cams, 5) if i not in train_ids]
    pcd = fetch_ply(str(src / "sparse" / "0" / "points3D.ply"))
    np.testing.assert_allclose(pcd.points, init_pts, rtol=0, atol=0)
    assert len(list((src / "images").iterdir())) == n_cams
