"""The guided trainer, port against reference, on the CPU.

Both trainers start from the same inputs: the scene of
tests/test_train_guided.py (three 40x40 views of 80 ground-truth
Gaussians, a 96-point cloud, the mock engine at 5 frames), the frozen
model handed to the port by `state_from_numpy`, and the training state
made anisotropic and rotated first (an isotropic Gaussian's rotation
gradient is rounding noise that Adam turns into +-lr steps in either
package). The reference renders with its dense oracle; the port's frozen
renderer with its dense backend, its trainer with the tile path.

  - Frozen renders (`render`, `render_many`): color and alpha within
    atol 2e-5 / rtol 1e-4, depth atol 2e-4 / rtol 1e-4 of the reference's
    dense renders; one tiles render against the reference's tile renderer
    in interpret mode with exact fields within atol 5e-5 (depth 5e-4),
    the tolerances of tests/test_torch_raster.py.
  - The trajectory pool: the same (cand_idx, scale_idx) per view and the
    same shuffled order; trajectories and the loop2 preset within 1e-6.
  - One mock event, then 12 guided steps that each take a pseudo view:
    the pseudo frames within the frozen renders' tolerances, the same
    stacks; each step's loss and pseudo_l1 within 1e-4; then every
    parameter, xyz_gradient_accum within 1e-4 of its largest magnitude,
    denom and max_radii2d equal (tests/test_torch_train_slice.py's
    tolerances).
  - The oracle engine's frames are the frozen renders of its Gaussians, at
    the K-based and the FoV-based camera (within 2e-5).
  - The CLI: a tiny `make_scene` scene, the baseline for 30 iterations,
    the guided trainer for 40 with the oracle, then render and metrics.
"""

import contextlib
import json
import math

import jax
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.models import gaussians as JG
from guidedvd3dgs_tpu.ops import raster_tiles as jax_raster_tiles
from guidedvd3dgs_tpu.ops import tiling as jax_tiling
from guidedvd3dgs_tpu.train import guided as jg
from guidedvd3dgs_tpu_torch import metrics as port_metrics
from guidedvd3dgs_tpu_torch import render as port_render
from guidedvd3dgs_tpu_torch import train_baseline as port_baseline_cli
from guidedvd3dgs_tpu_torch import train_guidedvd as port_guided_cli
from guidedvd3dgs_tpu_torch.convert import state_from_numpy
from guidedvd3dgs_tpu_torch.models.gaussians import PARAM_NAMES
from guidedvd3dgs_tpu_torch.models.render import render_gaussians
from guidedvd3dgs_tpu_torch.scene import cameras as port_cameras
from guidedvd3dgs_tpu_torch.scene import synthetic
from guidedvd3dgs_tpu_torch.train import guided as pg

from helpers import activated, random_gaussians
from test_train_baseline import FakeModelParams, FakePipe, FakeScene, make_synthetic
from test_train_guided import GuidedOpt, _intrinsic

torch.set_num_threads(2)

STEPS = range(2, 14)  # 12 guided steps after the event at iteration 1
COLOR_TOL = dict(atol=2e-5, rtol=1e-4)
DEPTH_TOL = dict(atol=2e-4, rtol=1e-4)


def _opt():
    # pseudo views from the first step; statistics on, no densify event
    return GuidedOpt(start_sample_pseudo=0, densify_from_iter=1000, densify_until_iter=1000)


def _states():
    rng = np.random.default_rng(7)
    pts = rng.normal(scale=1.2, size=(96, 3)).astype(np.float32)
    cols = rng.uniform(size=(96, 3)).astype(np.float32)
    jstate = JG.create_from_pcd(pts, cols, capacity=256)
    p = jstate.params
    scaling = np.asarray(p.scaling).copy()
    scaling[:96] += rng.uniform(-0.5, 0.5, (96, 3)).astype(np.float32)
    rotation = np.asarray(p.rotation).copy()
    rotation[:96] = rng.normal(size=(96, 4)).astype(np.float32)
    jstate = jstate._replace(params=p._replace(scaling=jax.numpy.asarray(scaling),
                                               rotation=jax.numpy.asarray(rotation)))
    gt_parts = activated(*random_gaussians(n=80, seed=42))
    gt_state = JG.create_from_pcd(np.asarray(gt_parts[0]), np.ones((80, 3)) * 0.5, capacity=128)
    return jstate, gt_state, pts, cols


@pytest.fixture(scope="module")
def pair():
    """(reference trainer, port trainer, cams, pools as built) with the
    trajectory pool built on both."""
    cams = make_synthetic()
    jstate, gt_state, pts, cols = _states()
    K = _intrinsic(cams[0])
    pstate = state_from_numpy(jax.device_get(jstate))
    pfrozen = pg.FrozenRenderer(state_from_numpy(jax.device_get(gt_state)).params, 0, backend="dense")
    jt = jg.GuidedTrainer(
        FakeScene(cams, extent=3.0), jstate, _opt(), FakePipe(), FakeModelParams(),
        frozen=jg.FrozenRenderer(gt_state, sh_degree=0, backend="dense"),
        engine=jg.MockDiffusionEngine(video_length=5, height=40, width=40),
        pcd_points=pts, pcd_colors=cols, guidance_intrinsic=K,
    )
    pcams = [port_cameras.Camera(colmap_id=0, R=c.R, T=c.T, FoVx=c.FoVx, FoVy=c.FoVy, image=c.image)
             for c in cams]
    pt = pg.GuidedTrainer(
        FakeScene(pcams, extent=3.0), pstate, _opt(), FakePipe(raster_backend="tiles"),
        FakeModelParams(), frozen=pfrozen,
        engine=pg.MockDiffusionEngine(video_length=5, height=40, width=40),
        pcd_points=pts, pcd_colors=cols, guidance_intrinsic=K,
    )
    jt.init_trajectory_pool()
    pt.init_trajectory_pool()
    order = {t: {v: [(e.cand_idx, e.scale_idx) for e in es] for v, es in tr.trajectory_pool_shuffle.items()}
             for t, tr in (("jax", jt), ("port", pt))}
    return jt, pt, cams, gt_state, order


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _w2cs(cams):
    return np.stack([np.asarray(c.raster_camera().viewmatrix).T for c in cams])


@contextlib.contextmanager
def _interpret_exact():
    prev = jax_raster_tiles._INTERPRET[0]
    jax_raster_tiles.set_interpret(True)
    jax_tiling.set_pack_fields(False)
    jax_raster_tiles.set_pack_grads(False)
    try:
        yield
    finally:
        jax_raster_tiles.set_interpret(prev)
        jax_tiling.set_pack_fields(True)
        jax_raster_tiles.set_pack_grads(True)


def test_frozen_renders_match_reference(pair):
    jt, pt, cams, gt_state, _ = pair
    K = pt.intrinsic
    w2cs = _w2cs(cams)
    got, want = pt.frozen.render(w2cs[1], K, 40, 40), jt.frozen.render(w2cs[1], K, 40, 40)
    for name, g, w in zip(("color", "alpha", "depth"), got, want):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name,
                                   **(DEPTH_TOL if name == "depth" else COLOR_TOL))
    traj = jt.trajectory_pool[0][0].traj_c2ws
    many = np.stack([np.linalg.inv(c) for c in traj])
    got, want = pt.frozen.render_many(many, K, 40, 40), jt.frozen.render_many(many, K, 40, 40)
    for name, g, w in zip(("color", "alpha", "depth"), got, want):
        assert g.shape == tuple(w.shape), name
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name,
                                   **(DEPTH_TOL if name == "depth" else COLOR_TOL))
    # one tiles render against the reference's tile renderer (interpret mode)
    with _interpret_exact():
        want = jg.FrozenRenderer(gt_state, sh_degree=0, backend="tiles").render(w2cs[2], K, 40, 40)
    got = pg.FrozenRenderer(pt.frozen.params, 0, backend="tiles").render(w2cs[2], K, 40, 40)
    for name, g, w in zip(("color", "alpha", "depth"), got, want):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, atol=5e-4 if name == "depth" else 5e-5)


def test_trajectory_pool_matches_reference(pair):
    jt, pt, _, _, order = pair
    np.testing.assert_allclose(pt.center_depths, jt.center_depths, rtol=1e-6)
    np.testing.assert_array_equal(pt.train_c2ws, jt.train_c2ws)
    assert set(pt.trajectory_pool) == set(jt.trajectory_pool) == {0, 1, 2}
    assert order["port"] == order["jax"]
    n = 0
    for v, want in jt.trajectory_pool.items():
        got = pt.trajectory_pool[v]
        assert [(e.cand_idx, e.scale_idx) for e in got] == [(e.cand_idx, e.scale_idx) for e in want]
        for g, w in zip(got, want):
            assert g.traj_c2ws.shape == (5, 4, 4)
            np.testing.assert_allclose(g.traj_c2ws, w.traj_c2ws, rtol=0, atol=1e-6)
            n += 1
        np.testing.assert_allclose(pt._txt_trajectory(v), jt._txt_trajectory(v), rtol=0, atol=1e-6)
    assert n > 3


def test_guided_steps_with_a_mock_event_match_reference(pair):
    jt, pt, _, _, _ = pair
    jt.run_diffusion_event(1)
    pt.run_diffusion_event(1)
    assert pt.events_run == jt.events_run == 1
    assert len(pt.pseudo_stack) == len(jt.pseudo_stack) == 4
    assert len(pt.pseudo_stack_alltime) == len(jt.pseudo_stack_alltime)
    for g, w in zip(pt.pseudo_stack, jt.pseudo_stack):
        np.testing.assert_array_equal(g.world_view_transform, w.world_view_transform)
        np.testing.assert_allclose(_np(g.pseudo_gt), _np(w.pseudo_gt), **COLOR_TOL)
        np.testing.assert_array_equal(_np(g.mask), _np(w.mask))

    for it in STEPS:
        js = jt.step(it)
        ps = pt.step(it)
        assert ps.num_active == js.num_active == 96
        assert abs(float(ps.loss) - js.loss) <= 1e-4, (it, float(ps.loss), js.loss)
        jp, pp = float(jt.last_metrics["pseudo_l1"]), float(pt.last_metrics["pseudo_l1"])
        assert pp > 0.0 and abs(pp - jp) <= 1e-4, (it, pp, jp)
    assert pt.events_run == jt.events_run == 1

    jfinal = jax.device_get(jt.state)
    act = np.asarray(jfinal.active)
    for name in PARAM_NAMES:
        want = np.asarray(getattr(jfinal.params, name))[act]
        got = getattr(pt.state.params, name).detach().numpy()
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 1e-4, (name, err)
    want = np.asarray(jfinal.xyz_gradient_accum)[act]
    err = np.abs(pt.state.xyz_gradient_accum.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-4, err
    np.testing.assert_array_equal(pt.state.denom.numpy(), np.asarray(jfinal.denom)[act])
    np.testing.assert_array_equal(pt.state.max_radii2d.numpy(), np.asarray(jfinal.max_radii2d)[act])
    assert pt.state.step == int(jfinal.step) == len(STEPS)


def test_oracle_engine_renders_the_gt_gaussians(pair, tmp_path):
    _, pt0, cams, _, _ = pair
    gt = {k: v.numpy() for k, v in pt0.frozen.params.tensors().items()}
    npz = tmp_path / "gt_gaussians.npz"
    synthetic.write_gt_npz(str(npz), gt)
    engine = pg.OracleDiffusionEngine(str(npz), video_length=5, height=40, width=40, sh_degree=0,
                                      backend="dense", device="cpu")
    jstate, _, pts, cols = _states()
    pcams = [port_cameras.Camera(colmap_id=0, R=c.R, T=c.T, FoVx=c.FoVx, FoVy=c.FoVy, image=c.image)
             for c in cams]
    opt = _opt()
    opt.use_trajectory_pool = False  # the txt-preset mode: no pool to build
    pt = pg.GuidedTrainer(FakeScene(pcams, extent=3.0), state_from_numpy(jax.device_get(jstate)), opt,
                          FakePipe(raster_backend="tiles"), FakeModelParams(), frozen=pt0.frozen,
                          engine=engine, pcd_points=pts, pcd_colors=cols,
                          guidance_intrinsic=pt0.intrinsic)
    pt.init_view_geometry()
    pt.run_diffusion_event(1)
    assert len(pt.pseudo_stack) == 4
    for pc in pt.pseudo_stack:
        w2c = np.eye(4)
        w2c[:3, :3] = pc.R.T
        w2c[:3, 3] = pc.T
        rgb, _, _ = pt.frozen.render(w2c, pt.intrinsic, 40, 40)
        np.testing.assert_allclose(_np(pc.pseudo_gt), _np(rgb.clamp(0, 1)), atol=2e-5, rtol=0)
        # the loss side renders at the FoV-based camera of the PseudoCamera
        out = render_gaussians(pt.frozen.params, pc.raster_camera("cpu"), torch.zeros(3), 0, backend="dense")
        np.testing.assert_allclose(_np(pc.pseudo_gt), _np(out.color.clamp(0, 1)), atol=2e-5, rtol=0)


def test_cli_guided_round_trip_with_the_oracle(tmp_path):
    src, base, mdl = tmp_path / "scene", tmp_path / "baseline", tmp_path / "guided"
    synthetic.make_scene(str(src), height=48, width=64, n_gt=3000, n_init=400, n_cams=12, n_train=3,
                         device="cpu")
    common = ["-s", str(src), "--dataset", "colmap", "--n_views", "3", "--eval", "--device", "cpu"]
    port_baseline_cli.main(common + ["-m", str(base), "--iterations", "30", "--test_iterations", "30",
                                     "--save_iterations", "30"])
    port_guided_cli.main(common + [
        "-m", str(mdl), "--baseline_path", str(base), "--baseline_iteration", "30",
        "--oracle_gt_npz", str(src / "gt_gaussians.npz"), "--iterations", "40",
        "--test_iterations", "40", "--save_iterations", "40", "--start_sample_pseudo", "2",
        "--end_sample_pseudo", "38", "--guidance_vd_iter", "15",
    ])
    timing = json.loads((mdl / "timing_summary.json").read_text())
    assert timing["events_run"] == 3 and timing["engine"] == "OracleDiffusionEngine"
    assert timing["iterations"] == 40 and 0.0 < timing["event_s"] < timing["total_s"]
    assert (mdl / "point_cloud" / "iteration_40" / "point_cloud.ply").exists()
    port_render.main(["-m", str(mdl), "--skip_train", "--device", "cpu"])
    port_metrics.evaluate([str(mdl)], device="cpu")
    res = json.loads((mdl / "results.json").read_text())["ours_40"]
    assert math.isfinite(res["PSNR"]) and math.isfinite(res["SSIM"]) and res["PSNR"] > 5.0
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        port_guided_cli.main(common + ["-m", str(tmp_path / "vc"), "--baseline_path", str(base),
                                       "--baseline_iteration", "30", "--viewcrafter_ckpt", "x.ckpt"])
