"""Exact resume of the port's guided trainer, and three guided variants
held to the JAX package, on the CPU.

The scene and states of tests/test_torch_train_guided.py (three 40x40
views, 96 training Gaussians, the mock engine at 5 frames).

  - Resume: run A trains 12 iterations (events at 1, 5 and 9, densify
    events at 4 and 8) and checkpoints at 6; run B, a fresh trainer
    loaded from that checkpoint, trains 7-12. Every parameter, Adam moment
    and statistic of B is bitwise A's, and so are both pseudo stacks
    (poses, frames, masks), the event count and the random streams. A
    view whose pool is empty survives the checkpoint; a plain checkpoint
    loads (its pool built anew); a checkpoint of another video_length is
    refused. The CLI resumes its own checkpoint to the bitwise same ply.
  - hybrid_traj: the first epoch of events takes the loop2 preset, then the
    pool; the same pseudo poses (atol 1e-6, the preset trajectories'
    tolerance) and the same switch in both packages.
  - pseudo_cam_weight_decay: `_pseudo_weight` equal at every iteration of
    two event intervals, and 12 guided steps with the decay on within the
    guided steps' tolerances (losses 1e-4).
  - scale_guidance_weight: the same guidance weight handed to the engine
    at each event, exactly.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.train import guided as jg
from guidedvd3dgs_tpu_torch import train_baseline as port_baseline_cli
from guidedvd3dgs_tpu_torch import train_guidedvd as port_guided_cli
from guidedvd3dgs_tpu_torch.convert import state_from_numpy
from guidedvd3dgs_tpu_torch.models.gaussians import PARAM_NAMES
from guidedvd3dgs_tpu_torch.scene import cameras as port_cameras
from guidedvd3dgs_tpu_torch.scene import synthetic
from guidedvd3dgs_tpu_torch.train import guided as pg
from guidedvd3dgs_tpu_torch.train.checkpoint import save_checkpoint
from guidedvd3dgs_tpu_torch.train.guided_checkpoint import load_guided_checkpoint, save_guided_checkpoint

from test_torch_train_guided import _states
from test_train_baseline import FakeModelParams, FakePipe, FakeScene, make_synthetic
from test_train_guided import GuidedOpt, _intrinsic

torch.set_num_threads(2)


@dataclasses.dataclass
class Opt(GuidedOpt):
    pseudo_cam_weight_start: float = 0.2
    pseudo_cam_weight_end: float = 0.01
    scale_guidance_weight: bool = False


def _inputs():
    cams = make_synthetic()
    jstate, gt_state, pts, cols = _states()
    return cams, jax.device_get(jstate), jax.device_get(gt_state), pts, cols


def _port_trainer(inputs, opt, video_length=5, **kw):
    cams, jstate, gt_state, pts, cols = inputs
    pcams = [port_cameras.Camera(colmap_id=0, R=c.R, T=c.T, FoVx=c.FoVx, FoVy=c.FoVy, image=c.image)
             for c in cams]
    frozen = pg.FrozenRenderer(state_from_numpy(gt_state).params, 0, backend="dense")
    return pg.GuidedTrainer(
        FakeScene(pcams, extent=3.0), state_from_numpy(jstate), opt, FakePipe(raster_backend="tiles"),
        FakeModelParams(), frozen=frozen,
        engine=pg.MockDiffusionEngine(video_length=video_length, height=40, width=40),
        pcd_points=pts, pcd_colors=cols, guidance_intrinsic=_intrinsic(cams[0]), **kw)


def _jax_trainer(inputs, opt, **kw):
    cams, jstate, gt_state, pts, cols = inputs
    t = jg.GuidedTrainer(
        FakeScene(cams, extent=3.0), jax.tree_util.tree_map(jax.numpy.asarray, jstate), opt, FakePipe(),
        FakeModelParams(), frozen=jg.FrozenRenderer(jax.tree_util.tree_map(jax.numpy.asarray, gt_state),
                                                    sh_degree=0, backend="dense"),
        engine=jg.MockDiffusionEngine(video_length=5, height=40, width=40),
        pcd_points=pts, pcd_colors=cols, guidance_intrinsic=_intrinsic(cams[0]))
    for k, v in kw.items():
        setattr(t, k, v)
    return t


def _resume_opt():
    return Opt(iterations=12, start_sample_pseudo=0, end_sample_pseudo=100, guidance_vd_iter=4,
               densify_from_iter=2, densification_interval=4, densify_until_iter=12,
               densify_grad_threshold=1e-6, prune_from_iter=2)


def _np(t):
    return t.detach().cpu().numpy()


def _same_stack(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.world_view_transform, y.world_view_transform)
        np.testing.assert_array_equal(_np(x.pseudo_gt), _np(y.pseudo_gt))
        np.testing.assert_array_equal(_np(x.mask), _np(y.mask))


def test_guided_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    inputs = _inputs()
    a = _port_trainer(inputs, _resume_opt())
    a.init_trajectory_pool()
    a.train(iterations=12, log_every=0, checkpoint_iterations={6}, checkpoint_dir=str(tmp_path))
    assert a.events_run == 3 and a.state.num_gaussians > 96  # events 1, 5 | 9; densify 4 | 8

    b = _port_trainer(inputs, _resume_opt())
    ck = str(tmp_path / "chkpnt6.ckpt")
    assert os.path.exists(ck + ".guided.npz")
    assert load_guided_checkpoint(ck, b) == 6
    assert b.events_run == 2
    b.train(iterations=12, log_every=0, start_iteration=6)

    for name in PARAM_NAMES:
        np.testing.assert_array_equal(_np(getattr(b.state.params, name)), _np(getattr(a.state.params, name)))
        np.testing.assert_array_equal(_np(b.state.adam_m[name]), _np(a.state.adam_m[name]))
        np.testing.assert_array_equal(_np(b.state.adam_v[name]), _np(a.state.adam_v[name]))
    for name in ("xyz_gradient_accum", "denom", "max_radii2d", "confidence"):
        np.testing.assert_array_equal(_np(getattr(b.state, name)), _np(getattr(a.state, name)))
    assert b.state.step == a.state.step and b.events_run == a.events_run == 3
    _same_stack(b.pseudo_stack, a.pseudo_stack)
    _same_stack(b.pseudo_stack_alltime, a.pseudo_stack_alltime)
    assert b.rng_np.bit_generator.state == a.rng_np.bit_generator.state
    assert b.rng.getstate() == a.rng.getstate()
    assert torch.equal(b.generator.get_state(), a.generator.get_state())
    assert b.vd_indices == a.vd_indices and float(b.ema_loss) == float(a.ema_loss)


def test_guided_checkpoint_empty_view_plain_fallback_and_video_length(tmp_path):
    inputs = _inputs()
    a = _port_trainer(inputs, _resume_opt())
    a.init_trajectory_pool()
    a.run_diffusion_event(1)
    a.trajectory_pool[0] = []
    a.trajectory_pool_shuffle[0] = []
    ck = str(tmp_path / "c.ckpt")
    save_guided_checkpoint(ck, a, 42)

    b = _port_trainer(inputs, _resume_opt())
    assert load_guided_checkpoint(ck, b) == 42
    assert b.trajectory_pool[0] == [] and set(b.trajectory_pool) == set(a.trajectory_pool) == {0, 1, 2}
    for v in (1, 2):
        assert [e.cand_idx for e in b.trajectory_pool_shuffle[v]] == [e.cand_idx for e in a.trajectory_pool_shuffle[v]]
    _same_stack(b.pseudo_stack, a.pseudo_stack)
    np.testing.assert_array_equal(b.train_c2ws, a.train_c2ws)
    assert b.xyz_lr == b.xyz_sched(42)

    plain = str(tmp_path / "plain.ckpt")
    save_checkpoint(plain, a.state, 17)
    c = _port_trainer(inputs, _resume_opt())
    assert load_guided_checkpoint(plain, c) == 17
    assert set(c.trajectory_pool) == {0, 1, 2} and c.events_run == 0  # the pool built anew
    np.testing.assert_array_equal(_np(c.state.params.xyz), _np(a.state.params.xyz))

    d = _port_trainer(inputs, _resume_opt(), video_length=3)
    with pytest.raises(ValueError, match="video_length"):
        load_guided_checkpoint(ck, d)


def test_cli_resumes_its_guided_checkpoint_exactly(tmp_path):
    src, base = tmp_path / "scene", tmp_path / "baseline"
    synthetic.make_scene(str(src), height=48, width=64, n_gt=3000, n_init=400, n_cams=12, n_train=3,
                         device="cpu")
    common = ["-s", str(src), "--dataset", "colmap", "--n_views", "3", "--eval", "--device", "cpu"]
    port_baseline_cli.main(common + ["-m", str(base), "--iterations", "20", "--test_iterations", "20",
                                     "--save_iterations", "20"])
    guided = common + ["--baseline_path", str(base), "--baseline_iteration", "20",
                       "--oracle_gt_npz", str(src / "gt_gaussians.npz"), "--iterations", "24",
                       "--test_iterations", "24", "--save_iterations", "24", "--start_sample_pseudo", "0",
                       "--end_sample_pseudo", "30", "--guidance_vd_iter", "4"]
    a = port_guided_cli.main(guided + ["-m", str(tmp_path / "a"), "--checkpoint_iterations", "12"])
    b = port_guided_cli.main(guided + ["-m", str(tmp_path / "b"), "--start_checkpoint",
                                       str(tmp_path / "a" / "chkpnt12.ckpt")])
    # events at 1, 5, ..., 21 where the view has a trajectory: some on each side
    sidecar = json.loads(bytes(np.load(tmp_path / "a" / "chkpnt12.ckpt.guided.npz")["__sidecar__"]))
    assert 0 < sidecar["events_run"] < a.events_run == b.events_run
    ply = os.path.join("point_cloud", "iteration_24", "point_cloud.ply")
    assert (tmp_path / "a" / ply).read_bytes() == (tmp_path / "b" / ply).read_bytes()


def test_hybrid_traj_warmup_matches_reference():
    inputs = _inputs()
    jt = _jax_trainer(inputs, GuidedOpt(), hybrid_traj=True, txt_traj_warmup=True)
    pt = _port_trainer(inputs, GuidedOpt(), hybrid_traj=True)
    jt.init_trajectory_pool()
    pt.init_trajectory_pool()
    sizes = {k: len(v) for k, v in pt.trajectory_pool_shuffle.items()}
    for e in range(len(inputs[0]) + 2):
        jt.run_diffusion_event(1 + 40 * e)
        pt.run_diffusion_event(1 + 40 * e)
        assert pt.txt_traj_warmup == jt.txt_traj_warmup == (e < len(inputs[0])), e
        assert {k: len(v) for k, v in pt.trajectory_pool_shuffle.items()} == \
            {k: len(v) for k, v in jt.trajectory_pool_shuffle.items()}
        for g, w in zip(pt.pseudo_stack, jt.pseudo_stack, strict=True):
            np.testing.assert_allclose(g.world_view_transform, w.world_view_transform, rtol=0, atol=1e-6)
    # the warm-up left the pool alone; then two events took from it
    assert sum(len(v) for v in pt.trajectory_pool_shuffle.values()) == sum(sizes.values()) - 2


def test_pseudo_cam_weight_decay_matches_reference():
    inputs = _inputs()
    opt = Opt(start_sample_pseudo=0, densify_from_iter=1000, densify_until_iter=1000,
              pseudo_cam_weight_decay=True, guidance_vd_iter=7)
    jt, pt = _jax_trainer(inputs, opt), _port_trainer(inputs, opt)
    assert [pt._pseudo_weight(i) for i in range(15)] == [jt._pseudo_weight(i) for i in range(15)]
    assert len({pt._pseudo_weight(i) for i in range(7)}) == 7
    jt.init_trajectory_pool()
    pt.init_trajectory_pool()
    jt.run_diffusion_event(1)
    pt.run_diffusion_event(1)
    for it in range(2, 14):
        js, ps = jt.step(it), pt.step(it)
        assert abs(float(ps.loss) - js.loss) <= 1e-4, (it, float(ps.loss), js.loss)
    assert pt.events_run == jt.events_run == 2  # the event at 8


def test_scale_guidance_weight_schedule_matches_reference():
    inputs = _inputs()
    opt = Opt(scale_guidance_weight=True, guidance_vd_iter=260)
    jt, pt = _jax_trainer(inputs, opt), _port_trainer(inputs, opt)
    seen = {"jax": [], "port": []}
    for key, t in (("jax", jt), ("port", pt)):
        gen = t.engine.generate

        def record(*a, _gen=gen, _out=seen[key], **k):
            _out.append(k["scale_guidance_weight"])
            return _gen(*a, **k)

        t.engine.generate = record
        t.init_trajectory_pool()
        for it in (1, 261, 521, 1301, 2601, 5201):
            t.run_diffusion_event(it)
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] < 0.02 and seen["port"][-1] == 1.0 and seen["port"] == sorted(seen["port"])
