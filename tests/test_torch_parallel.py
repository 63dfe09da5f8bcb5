"""The camera-batch step (`parallel/data_parallel.py`), port against the JAX
package on the CPU.

- `train_step_dp` at B = 2 on the dense backend from the same state (100
  random Gaussians, two 32x32 cameras with noisy poses and random targets),
  against the JAX package's `train_step_dp`: every parameter within rtol
  2e-4 / atol 2e-6, xyz_gradient_accum within rtol 2e-4 / atol 1e-7, denom
  exact (the tolerances of tests/test_parallel.py); max_radii2d exact; the
  loss within 1e-5.
- At B = 1 the step is bitwise the baseline trainer's step on the tile
  path.
- `stack_cameras` refuses cameras of two resolutions; `camera_at` gives
  each camera back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.config import OptimizationParams as JOpt
from guidedvd3dgs_tpu.models import gaussians as JG
from guidedvd3dgs_tpu.parallel import data_parallel as jdp
from guidedvd3dgs_tpu.train.baseline import lrs_for as jlrs_for
from guidedvd3dgs_tpu_torch.config import OptimizationParams
from guidedvd3dgs_tpu_torch.convert import state_from_numpy
from guidedvd3dgs_tpu_torch.models.gaussians import PARAM_NAMES
from guidedvd3dgs_tpu_torch.parallel import camera_at, stack_cameras, train_step_dp
from guidedvd3dgs_tpu_torch.scene import cameras as port_cameras
from guidedvd3dgs_tpu_torch.train.baseline import lrs_for, train_step

from helpers import make_camera, random_gaussians

torch.set_num_threads(2)


def _jax_state(n=100, cap=128, seed=0):
    xyz, _, _, _, sh = random_gaussians(n=n, seed=seed)
    rgb = 1.0 / (1.0 + np.exp(-sh[:, 0]))
    return JG.create_from_pcd(xyz, rgb, capacity=cap)


def _cams(n, h=32, w=32):
    cams = [make_camera(height=h, width=w, look_noise=0.08, seed=i) for i in range(n)]
    gts = np.random.default_rng(7).uniform(size=(n, 3, h, w)).astype(np.float32)
    pcams = [port_cameras.Camera(colmap_id=0, R=c.R, T=c.T, FoVx=c.FoVx, FoVy=c.FoVy, image=gts[i])
             for i, c in enumerate(cams)]
    return cams, pcams, gts


def test_train_step_dp_matches_reference_at_b2():
    cams, pcams, gts = _cams(2)
    jstate = _jax_state()
    jopt = JOpt()
    jout, jm = jdp.train_step_dp(jstate, jdp.stack_cameras([c.raster_camera() for c in cams]), jnp.asarray(gts),
                                 jnp.zeros(3), jlrs_for(jopt, jopt.position_lr_init), sh_degree=0,
                                 lambda_dssim=0.2, backend="dense")
    state = state_from_numpy(jax.device_get(jstate))
    opt = OptimizationParams()
    m = train_step_dp(state, stack_cameras([c.raster_camera("cpu") for c in pcams]), torch.from_numpy(gts),
                      torch.zeros(3), lrs_for(opt, opt.position_lr_init), sh_degree=0, lambda_dssim=0.2,
                      backend="dense")
    jout = jax.device_get(jout)
    act = np.asarray(jout.active)
    assert state.num_gaussians == int(act.sum()) == 100 and state.step == int(jout.step) == 1
    for name in PARAM_NAMES:
        np.testing.assert_allclose(getattr(state.params, name).detach().numpy(),
                                   np.asarray(getattr(jout.params, name))[act], rtol=2e-4, atol=2e-6,
                                   err_msg=name)
    np.testing.assert_allclose(state.xyz_gradient_accum.numpy(), np.asarray(jout.xyz_gradient_accum)[act],
                               rtol=2e-4, atol=1e-7)
    assert float(state.xyz_gradient_accum.max()) > 0.0
    np.testing.assert_array_equal(state.denom.numpy(), np.asarray(jout.denom)[act])
    assert int(state.denom.max()) == 2  # some Gaussian seen by both cameras
    np.testing.assert_array_equal(state.max_radii2d.numpy(), np.asarray(jout.max_radii2d)[act])
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
    assert abs(float(m["psnr"]) - float(jm["psnr"])) <= 1e-3


def test_train_step_dp_of_one_camera_is_the_baseline_step():
    _, pcams, gts = _cams(1)
    opt = OptimizationParams()
    lrs = lrs_for(opt, opt.position_lr_init)
    a, b = (state_from_numpy(jax.device_get(_jax_state())) for _ in range(2))
    cam = pcams[0].raster_camera("cpu")
    ma = train_step_dp(a, stack_cameras([cam]), torch.from_numpy(gts), torch.zeros(3), lrs, sh_degree=0,
                       lambda_dssim=0.2, backend="tiles")
    mb = train_step(b, cam, torch.from_numpy(gts[0]), torch.zeros(3), lrs, 0, sh_degree=0, lambda_dssim=0.2,
                    backend="tiles")
    assert torch.equal(ma["loss"], mb["loss"])
    for name in PARAM_NAMES:
        assert torch.equal(getattr(a.params, name), getattr(b.params, name)), name
        assert torch.equal(a.adam_m[name], b.adam_m[name]) and torch.equal(a.adam_v[name], b.adam_v[name])
    for name in ("xyz_gradient_accum", "denom", "max_radii2d"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_stack_cameras_checks_the_resolution_and_unstacks():
    _, pcams, _ = _cams(3)
    rcs = [c.raster_camera("cpu") for c in pcams]
    stacked = stack_cameras(rcs)
    assert stacked.viewmatrix.shape == (3, 4, 4) and (stacked.height, stacked.width) == (32, 32)
    for i, c in enumerate(rcs):
        got = camera_at(stacked, i)
        for f in ("viewmatrix", "projmatrix", "campos"):
            assert torch.equal(getattr(got, f), getattr(c, f)), f
        assert (got.tanfovx, got.tanfovy, got.height, got.width) == (c.tanfovx, c.tanfovy, c.height, c.width)
    other = port_cameras.Camera(colmap_id=0, R=pcams[0].R, T=pcams[0].T, FoVx=1.0, FoVy=1.0,
                                image=np.zeros((3, 16, 32), np.float32))
    with pytest.raises(ValueError, match="share resolution"):
        stack_cameras(rcs + [other.raster_camera("cpu")])
