"""The project-cam trainer, port against reference, on the CPU.

The scene and state of tests/test_torch_train_slice.py (three 40x40 views
of 80 ground-truth Gaussians, 96 anisotropic, rotated Gaussians; the
reference renders with its dense oracle, the port with its tile path),
each view also a projection camera: its projection the half-bright image
with seeded noise, its mask a seeded half of the pixels.

  - `project_cam_step` (masked L1 at project_cam_weight): the loss and
    every parameter's gradient (the reference's by jax.grad of the same
    loss) within 1e-4 of the largest magnitude, then 4 steps with Adam:
    losses within 1e-4, parameters and xyz_gradient_accum within 1e-4 of
    their largest magnitude, max_radii2d and denom equal (the tolerances
    of the baseline step's parity);
  - `ProjectCamTrainer` at project_cam_prob 0.5: the same kind of epoch at
    every step and the same losses over 18 steps; at -1 every epoch takes
    the projection cameras (the reference's test_variants epochs test);
  - the CLI on a tiny Replica scene whose projections the port's tool
    wrote: both kinds of epoch, a saved model that render and metrics read.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from guidedvd3dgs_tpu.models import gaussians as JG
from guidedvd3dgs_tpu.models.render import render_gaussians as jax_render
from guidedvd3dgs_tpu.train import project_cam as jpc
from guidedvd3dgs_tpu.train.baseline import lrs_for as jax_lrs_for
from guidedvd3dgs_tpu.utils.losses import l1_loss_mask as jax_l1_loss_mask
from guidedvd3dgs_tpu_torch import metrics as port_metrics
from guidedvd3dgs_tpu_torch import project_pcd_to_views
from guidedvd3dgs_tpu_torch import render as port_render
from guidedvd3dgs_tpu_torch import train_project_cam as port_cli
from guidedvd3dgs_tpu_torch.convert import state_from_numpy
from guidedvd3dgs_tpu_torch.models.gaussians import PARAM_NAMES
from guidedvd3dgs_tpu_torch.scene import cameras as port_cameras
from guidedvd3dgs_tpu_torch.scene import synthetic
from guidedvd3dgs_tpu_torch.train import project_cam as ppc
from guidedvd3dgs_tpu_torch.train.baseline import lrs_for
from guidedvd3dgs_tpu_torch.utils.losses import l1_loss_mask

from test_train_baseline import FakeModelParams, FakeOpt, FakePipe, FakeScene, make_synthetic

torch.set_num_threads(2)

TOL = 1e-4


@dataclasses.dataclass
class Opt(FakeOpt):
    project_cam_prob: float = 0.5
    project_cam_weight: float = 0.05
    densify_from_iter: int = 1000
    densify_until_iter: int = 1000


class ProjScene(FakeScene):
    def getProjectCameras(self):
        return self.cams


def _inputs():
    cams = make_synthetic()
    rng = np.random.default_rng(7)
    pts = rng.normal(scale=1.2, size=(96, 3)).astype(np.float32)
    cols = rng.uniform(size=(96, 3)).astype(np.float32)
    jstate = JG.create_from_pcd(pts, cols, capacity=256)
    p = jstate.params
    scaling = np.asarray(p.scaling).copy()
    scaling[:96] += rng.uniform(-0.5, 0.5, (96, 3)).astype(np.float32)
    rotation = np.asarray(p.rotation).copy()
    rotation[:96] = rng.normal(size=(96, 4)).astype(np.float32)
    jstate = jstate._replace(params=p._replace(scaling=jnp.asarray(scaling), rotation=jnp.asarray(rotation)))
    for c in cams:
        c.projected_image = np.clip(c.image * 0.5 + rng.normal(scale=0.05, size=c.image.shape), 0, 1).astype(
            np.float32)
        c.projected_mask = (rng.uniform(size=c.image.shape[1:]) < 0.5).astype(np.float32)
    pcams = [port_cameras.Camera(colmap_id=0, R=c.R, T=c.T, FoVx=c.FoVx, FoVy=c.FoVy, image=c.image,
                                 projected_image=c.projected_image, projected_mask=c.projected_mask)
             for c in cams]
    return cams, pcams, jstate


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_project_cam_step_matches_reference():
    cams, pcams, jstate = _inputs()
    pstate = state_from_numpy(jax.device_get(jstate))
    opt = Opt()
    bg = jnp.zeros(3)
    cam, pcam = cams[1], pcams[1]
    jimg, jmask = jnp.asarray(cam.projected_image), jnp.asarray(cam.projected_mask)
    pimg, pmask = torch.from_numpy(pcam.projected_image), torch.from_numpy(pcam.projected_mask)

    # the loss and its gradient
    def jloss(params):
        r = jax_render(params, jstate.active, jstate.confidence, cam.raster_camera(), bg, 1, backend="dense")
        return opt.project_cam_weight * jax_l1_loss_mask(r.color, jimg, jmask)

    jl, jgrad = jax.value_and_grad(jloss)(jstate.params)
    m = ppc.project_cam_step(pstate, pcam.raster_camera("cpu"), pimg, pmask, opt.project_cam_weight,
                             torch.zeros(3), lrs_for(opt, 1e-4), 1, backend="tiles", apply_adam=False)
    assert abs(float(m["loss"]) - float(jl)) <= TOL
    act = np.asarray(jstate.active)
    for name in PARAM_NAMES:
        want = np.asarray(getattr(jgrad, name))[act]
        got = getattr(pstate.params, name).grad.numpy()
        assert _rel(got, want) <= TOL, name
    np.testing.assert_allclose(float(l1_loss_mask(pimg, pimg * 0, pmask)),
                               float(jax_l1_loss_mask(jimg, jimg * 0, jmask)), rtol=1e-6)

    # four steps with Adam and the statistics
    pstate = state_from_numpy(jax.device_get(jstate))
    for it in range(4):
        jstate, jm = jpc.project_cam_step(jstate, cam.raster_camera(), jimg, jmask,
                                          jnp.float32(opt.project_cam_weight), bg, jax_lrs_for(opt, 1e-4),
                                          sh_degree=1, backend="dense")
        pm = ppc.project_cam_step(pstate, pcam.raster_camera("cpu"), pimg, pmask, opt.project_cam_weight,
                                  torch.zeros(3), lrs_for(opt, 1e-4), 1, backend="tiles")
        assert abs(float(pm["loss"]) - float(jm["loss"])) <= TOL, it
        assert abs(float(pm["psnr"]) - float(jm["psnr"])) <= 1e-3, it
    jf = jax.device_get(jstate)
    for name in PARAM_NAMES:
        assert _rel(getattr(pstate.params, name).detach().numpy(), np.asarray(getattr(jf.params, name))[act]) \
            <= TOL, name
    assert _rel(pstate.xyz_gradient_accum.numpy(), np.asarray(jf.xyz_gradient_accum)[act]) <= TOL
    np.testing.assert_array_equal(pstate.denom.numpy(), np.asarray(jf.denom)[act])
    np.testing.assert_array_equal(pstate.max_radii2d.numpy(), np.asarray(jf.max_radii2d)[act])
    assert pstate.step == int(jf.step)


def test_project_cam_trainer_epochs_match_reference():
    cams, pcams, jstate = _inputs()
    host = jax.device_get(jstate)  # the reference's step donates its state
    pstate = state_from_numpy(host)
    jt = jpc.ProjectCamTrainer(ProjScene(cams, 3.0), jstate, Opt(), FakePipe(), FakeModelParams())
    pt = ppc.ProjectCamTrainer(ProjScene(pcams, 3.0), pstate, Opt(), FakePipe(raster_backend="tiles"),
                               FakeModelParams())
    kinds = []
    for it in range(1, 19):
        js, ps = jt.step(it), pt.step(it)
        assert pt.use_project_cam == jt.use_project_cam, it
        kinds.append(pt.use_project_cam)
        assert abs(float(ps.loss) - js.loss) <= TOL, (it, float(ps.loss), js.loss)
    assert any(kinds) and not all(kinds)
    assert pt.epochs == {"train": kinds[::3].count(False), "project": kinds[::3].count(True)}

    always = ppc.ProjectCamTrainer(ProjScene(pcams, 3.0), state_from_numpy(host),
                                   dataclasses.replace(Opt(), project_cam_prob=-1.0),
                                   FakePipe(raster_backend="tiles"), FakeModelParams())
    for it in range(1, 21):
        stats = always.step(it)
    assert always.use_project_cam and always.epochs == {"train": 0, "project": 7}
    assert math.isfinite(float(stats.loss))


def test_cli_trains_on_projections_the_tool_wrote(tmp_path):
    rng = np.random.default_rng(3)
    src = tmp_path / "office_3" / "Sequence_1"
    gt = synthetic.room_gaussians(3000, rng)
    c2ws, cams = synthetic.orbit(330, 32, 24, 90.0, rng)
    from guidedvd3dgs_tpu_torch.convert import params_from_numpy
    from guidedvd3dgs_tpu_torch.models.render import eval_render

    params = params_from_numpy(gt, "cpu")
    images = [eval_render(params, c.raster_camera("cpu"), torch.zeros(3), 3).color.clamp(0, 1).numpy()
              for c in cams]
    pts, cols = synthetic.init_cloud(gt["xyz"], np.full((3000, 3), 0.5, np.float32), 600, rng)
    synthetic.write_source(str(src), c2ws, cams, images, None, None, pts, (cols * 255).astype(np.uint8),
                           images_dir="rgb", names=[f"rgb_{i}.png" for i in range(330)])
    project_pcd_to_views.main(["--source", str(src), "--ply", str(src / "sparse/0/points3D.ply"),
                               "--images", "rgb"])
    mdl = tmp_path / "model"
    trainer = port_cli.main([
        "-s", str(src), "-m", str(mdl), "--dataset", "replica", "--images", "rgb", "--n_views", "3",
        "--eval", "--projected_dir", str(src / "projected_dir"), "--project_cam_prob", "0.5",
        "--iterations", "120", "--test_iterations", "120", "--save_iterations", "120",
        "--densify_grad_threshold", "1e10", "--device", "cpu",
    ])
    assert len(trainer.scene.getProjectCameras()) == 55
    assert trainer.epochs["train"] >= 1 and trainer.epochs["project"] >= 1, trainer.epochs
    port_render.main(["-m", str(mdl), "--skip_train", "--device", "cpu"])
    port_metrics.evaluate([str(mdl)], device="cpu")
    res = json.loads((mdl / "results.json").read_text())["ours_120"]
    assert math.isfinite(res["PSNR"]) and math.isfinite(res["SSIM"])
    assert os.path.exists(mdl / "point_cloud" / "iteration_120" / "point_cloud.ply")
