"""The guided trainer across densification, port against reference, on the
CPU.

tests/test_torch_train_guided.py holds 12 guided steps with densification
off; this file runs the same scene and trainers (three 40x40 views, a
96-point anisotropic start, the mock engine at 5 frames, pseudo views
from the first step) through 20 guided steps, iterations 2-21, that
cross two densify events (densification_interval 5, densify_from_iter 2,
densify_until_iter 12: iterations 5 and 10), one opacity reset
(iteration 12) and a second mock event (iteration 16). The split noise is
the reference's (its key of the iteration, at the state's capacity), and
the capacity is large enough that the reference never regrows. Both
trainers run at SH degree 0: a Gaussian that a densify event appends has
zero Adam moments, and its first Adam step moves each SH coefficient by
up to lr whatever the gradient's size; a rest coefficient whose gradient
is rounding of zero (1e-15 in one package, 1e-14 in the other) then
parts by a fraction of lr that later steps keep (seen at SH degree 3:
0.9% of the coefficients' largest magnitude after 20 steps).

After each densify event the two active counts are equal and every
parameter is within 1e-4 of its largest magnitude; each step's loss and
pseudo_l1 within 1e-4; at the end the parameters and xyz_gradient_accum
within 1e-4 of the largest magnitude, denom and max_radii2d equal (the
tolerances of tests/test_torch_train_guided.py).
"""

import jax
import numpy as np
import torch

from guidedvd3dgs_tpu.models import gaussians as JG
from guidedvd3dgs_tpu.train import guided as jg
from guidedvd3dgs_tpu_torch.convert import state_from_numpy
from guidedvd3dgs_tpu_torch.models.gaussians import PARAM_NAMES
from guidedvd3dgs_tpu_torch.scene import cameras as port_cameras
from guidedvd3dgs_tpu_torch.train import guided as pg

from helpers import activated, random_gaussians
from test_train_baseline import FakeModelParams, FakePipe, FakeScene, make_synthetic
from test_train_guided import GuidedOpt, _intrinsic

torch.set_num_threads(2)

CAPACITY = 2048
DENSIFY_AT = (5, 10)
RESET_AT = 12
EVENTS_AT = (1, 16)


def _opt():
    return GuidedOpt(start_sample_pseudo=0, densification_interval=5, densify_from_iter=2, prune_from_iter=2,
                     densify_until_iter=12, densify_grad_threshold=1e-6, opacity_reset_interval=RESET_AT,
                     guidance_vd_iter=15)


def _jax_split_noise(iteration):
    key = jax.random.key(iteration)
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(key, i), (CAPACITY, 3))) for i in range(2)]))


def _trainers():
    cams = make_synthetic()
    rng = np.random.default_rng(7)
    pts = rng.normal(scale=1.2, size=(96, 3)).astype(np.float32)
    cols = rng.uniform(size=(96, 3)).astype(np.float32)
    jstate = JG.create_from_pcd(pts, cols, capacity=CAPACITY)
    p = jstate.params
    scaling = np.asarray(p.scaling).copy()
    scaling[:96] += rng.uniform(-0.5, 0.5, (96, 3)).astype(np.float32)
    rotation = np.asarray(p.rotation).copy()
    rotation[:96] = rng.normal(size=(96, 4)).astype(np.float32)
    jstate = jstate._replace(params=p._replace(scaling=jax.numpy.asarray(scaling),
                                               rotation=jax.numpy.asarray(rotation)))
    gt_parts = activated(*random_gaussians(n=80, seed=42))
    gt_state = JG.create_from_pcd(np.asarray(gt_parts[0]), np.ones((80, 3)) * 0.5, capacity=128)
    K = _intrinsic(cams[0])
    jt = jg.GuidedTrainer(
        FakeScene(cams, extent=3.0), jstate, _opt(), FakePipe(), FakeModelParams(sh_degree=0),
        frozen=jg.FrozenRenderer(gt_state, sh_degree=0, backend="dense"),
        engine=jg.MockDiffusionEngine(video_length=5, height=40, width=40),
        pcd_points=pts, pcd_colors=cols, guidance_intrinsic=K)
    pcams = [port_cameras.Camera(colmap_id=0, R=c.R, T=c.T, FoVx=c.FoVx, FoVy=c.FoVy, image=c.image)
             for c in cams]
    pt = pg.GuidedTrainer(
        FakeScene(pcams, extent=3.0), state_from_numpy(jax.device_get(jstate)), _opt(),
        FakePipe(raster_backend="tiles"), FakeModelParams(sh_degree=0),
        frozen=pg.FrozenRenderer(state_from_numpy(jax.device_get(gt_state)).params, 0, backend="dense"),
        engine=pg.MockDiffusionEngine(video_length=5, height=40, width=40),
        pcd_points=pts, pcd_colors=cols, guidance_intrinsic=K)
    pt.split_noise = _jax_split_noise
    jt.init_trajectory_pool()
    pt.init_trajectory_pool()
    return jt, pt


def _check_params(jt, pt, what):
    jstate = jax.device_get(jt.state)
    act = np.asarray(jstate.active)
    assert pt.state.num_gaussians == int(act.sum()), (what, pt.state.num_gaussians, int(act.sum()))
    for name in PARAM_NAMES:
        want = np.asarray(getattr(jstate.params, name))[act]
        got = getattr(pt.state.params, name).detach().numpy()
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 1e-4, (what, name, err)
    return jstate, act


def test_guided_steps_across_densify_reset_and_two_events_match_reference():
    jt, pt = _trainers()
    jt.run_diffusion_event(EVENTS_AT[0])
    pt.run_diffusion_event(EVENTS_AT[0])
    counts = [96]
    for it in range(2, 22):
        js, ps = jt.step(it), pt.step(it)
        assert ps.num_active == js.num_active, (it, ps.num_active, js.num_active)
        assert abs(float(ps.loss) - js.loss) <= 1e-4, (it, float(ps.loss), js.loss)
        jp, pp = float(jt.last_metrics["pseudo_l1"]), float(pt.last_metrics["pseudo_l1"])
        assert pp > 0.0 and abs(pp - jp) <= 1e-4, (it, pp, jp)
        if it in DENSIFY_AT:
            _check_params(jt, pt, f"after the densify event at {it}")
            counts.append(ps.num_active)
        if it == RESET_AT:
            assert float(pt.state.params.get_opacity.max()) <= 0.05 + 1e-6
    assert pt.events_run == jt.events_run == len(EVENTS_AT)
    assert counts[1] > counts[0] and counts[2] != counts[1], counts  # both events changed the count
    jstate, act = _check_params(jt, pt, "at the end")
    want = np.asarray(jstate.xyz_gradient_accum)[act]
    err = np.abs(pt.state.xyz_gradient_accum.numpy() - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= 1e-4, err
    np.testing.assert_array_equal(pt.state.denom.numpy(), np.asarray(jstate.denom)[act])
    np.testing.assert_array_equal(pt.state.max_radii2d.numpy(), np.asarray(jstate.max_radii2d)[act])
    assert pt.state.step == int(jstate.step)
