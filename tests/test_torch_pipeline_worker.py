"""Pipelined diffusion events (`pipeline_guidance`): the port's worker
thread against its inline mode, on the CPU, on the scene of
tests/test_torch_pipeline_guidance.py (the mock engine, events every 7
steps: boundaries at 1, 8 and 15, densify events at 5 and 10, an opacity
reset at 12, then the drain).

- The worker and the inline mode (the same lagged order on one thread)
  give the same bits: every tensor of the state, the stacks, the random
  streams; with guidance_with_training_gs too.
- A checkpoint written with an event in flight holds the state after its
  finalize, and a run resumed from it is bitwise the run that wrote it.
- Under guidance_with_training_gs the event renders the training Gaussians
  as they were at its submission, whatever the trainer does to them while
  the worker runs.
- The CLI with --pipeline_guidance on a tiny scene with the oracle (a
  checkpoint with an event in flight, the drain), and with --guidance_tp 2
  (the toy ViewCrafter engine split over two CPU entries) through two
  events and their artifacts.
"""

import json
import threading

import jax
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.diffusion import init as jinit
from guidedvd3dgs_tpu.models import gaussians as JG
from guidedvd3dgs_tpu_torch import train_baseline as port_baseline_cli
from guidedvd3dgs_tpu_torch import train_guidedvd as port_guided_cli
from guidedvd3dgs_tpu_torch.convert import diffusion_params_from_numpy, state_from_numpy
from guidedvd3dgs_tpu_torch.scene import cameras as port_cameras
from guidedvd3dgs_tpu_torch.scene import synthetic
from guidedvd3dgs_tpu_torch.train import guided as pg
from guidedvd3dgs_tpu_torch.train.guided_checkpoint import load_guided_checkpoint

from helpers import activated, random_gaussians
from test_torch_guided_densify import CAPACITY, _jax_split_noise, _opt
from test_torch_diffusion_models import toy_configs
from test_torch_pipeline_guidance import BOUNDARIES, LAST, _pipelined
from test_torch_train_vc import sharded_cli_run
from test_train_baseline import FakeModelParams, FakePipe, FakeScene, make_synthetic
from test_train_guided import _intrinsic

torch.set_num_threads(2)


def _port(event_worker=True, training_gs=False, pool=True):
    """The port's trainer of `_trainers` alone (no JAX trainer), pipelined."""
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
    cams = _cams()
    pcams = [port_cameras.Camera(colmap_id=0, R=c.R, T=c.T, FoVx=c.FoVx, FoVy=c.FoVy, image=c.image)
             for c in cams]
    pt = pg.GuidedTrainer(
        FakeScene(pcams, extent=3.0), state_from_numpy(jax.device_get(jstate)), _opt(),
        FakePipe(raster_backend="tiles"), FakeModelParams(sh_degree=0),
        frozen=pg.FrozenRenderer(state_from_numpy(jax.device_get(gt_state)).params, 0, backend="dense"),
        engine=pg.MockDiffusionEngine(video_length=5, height=40, width=40),
        pcd_points=pts, pcd_colors=cols, guidance_intrinsic=_intrinsic(cams[0]), event_worker=event_worker)
    pt.split_noise = _jax_split_noise
    _pipelined(pt, training_gs=training_gs)
    if pool:
        pt.init_trajectory_pool()
    return pt


_CAMS = []


def _cams():
    if not _CAMS:
        _CAMS.extend(make_synthetic())
    return _CAMS


def _run(pt, first=1, last=LAST):
    for it in range(first, last + 1):
        pt.step(it)
    pt.close_event_worker()
    return pt


def _state_tensors(pt):
    st = pt.state
    out = dict(st.params.tensors())
    out.update({f"m/{k}": v for k, v in st.adam_m.items()})
    out.update({f"v/{k}": v for k, v in st.adam_v.items()})
    out.update(max_radii2d=st.max_radii2d, accum=st.xyz_gradient_accum, denom=st.denom,
               confidence=st.confidence)
    return out


def _assert_same_run(a, b):
    assert a.state.step == b.state.step and a.events_run == b.events_run
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    for sa, sb in ((a.pseudo_stack, b.pseudo_stack), (a.pseudo_stack_alltime, b.pseudo_stack_alltime)):
        assert len(sa) == len(sb)
        for ca, cb in zip(sa, sb):
            assert torch.equal(ca.pseudo_gt, cb.pseudo_gt) and torch.equal(ca.mask, cb.mask)
            np.testing.assert_array_equal(ca.world_view_transform, cb.world_view_transform)
    assert a.rng_np.bit_generator.state == b.rng_np.bit_generator.state
    assert a.rng.getstate() == b.rng.getstate()
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.vd_indices == b.vd_indices


@pytest.mark.parametrize("training_gs", [False, True], ids=["frozen", "training_gs"])
def test_the_worker_and_inline_modes_give_the_same_bits(training_gs):
    worker = _port(event_worker=True, training_gs=training_gs)
    inline = _port(event_worker=False, training_gs=training_gs)
    _run(worker)
    _run(inline)
    assert worker.events_run == len(BOUNDARIES)
    assert inline._executor is None  # the inline mode starts no thread
    _assert_same_run(worker, inline)


def test_a_checkpoint_with_an_event_in_flight_resumes_bitwise(tmp_path):
    a = _port()
    for it in range(1, 11):
        a.step(it)
    assert a._pending_event is not None and a.events_run == 1  # the event of 8 in flight
    path = str(tmp_path / "chkpnt10.ckpt")
    a.write_checkpoint(path, 10)
    assert a._pending_event is None and a.events_run == 2  # finalized first
    _run(a, first=11)

    b = _port(pool=False)
    assert load_guided_checkpoint(path, b) == 10
    assert b.events_run == 2 and len(b.pseudo_stack) == 4 and b._pending_event is None
    _run(b, first=11)
    _assert_same_run(a, b)


def test_the_event_renders_the_training_gaussians_as_they_were_at_its_submission():
    runs = {}
    for mode in ("worker", "inline"):
        pt = _port(event_worker=mode == "worker", training_gs=True)
        seen, gate = [], threading.Event()
        generate, pc_render = pt.engine.generate, pt.pc_render_along

        def spy(pc, images, masks, depths, **kw):
            seen.append(images.clone())
            return generate(pc, images, masks, depths, **kw)

        def gated(*args):
            assert gate.wait(timeout=30)
            return pc_render(*args)

        pt.engine.generate, pt.pc_render_along = spy, gated
        if mode == "inline":
            gate.set()
        pending = pt.submit_diffusion_event(1)
        with torch.no_grad():  # the trainer moves the Gaussians while the worker waits
            pt.state.params.xyz.add_(0.5)
            pt.state.params.opacity.fill_(4.0)
        gate.set()
        pt.finalize_diffusion_event(pending)
        pt.close_event_worker()
        runs[mode] = seen[0]
    assert torch.equal(runs["worker"], runs["inline"])


def test_cli_runs_pipelined_with_the_oracle(tmp_path):
    src, base, mdl = tmp_path / "scene", tmp_path / "baseline", tmp_path / "guided"
    synthetic.make_scene(str(src), height=48, width=64, n_gt=3000, n_init=400, n_cams=12, n_train=3,
                         device="cpu")
    common = ["-s", str(src), "--dataset", "colmap", "--n_views", "3", "--eval", "--device", "cpu"]
    port_baseline_cli.main(common + ["-m", str(base), "--iterations", "30", "--test_iterations", "30",
                                     "--save_iterations", "30"])
    trainer = port_guided_cli.main(common + [
        "-m", str(mdl), "--baseline_path", str(base), "--baseline_iteration", "30",
        "--oracle_gt_npz", str(src / "gt_gaussians.npz"), "--iterations", "40",
        "--test_iterations", "40", "--save_iterations", "40", "--start_sample_pseudo", "2",
        "--end_sample_pseudo", "38", "--guidance_vd_iter", "15", "--pipeline_guidance",
        "--checkpoint_iterations", "20",
    ])
    assert trainer.pipeline_guidance and trainer._executor is None and trainer._pending_event is None
    timing = json.loads((mdl / "timing_summary.json").read_text())
    # boundaries 1, 16, 31; the checkpoint at 20 finalizes the event of 16;
    # the drain the event of 31
    assert timing["events_run"] == 3 and timing["pipeline_guidance"] is True
    assert timing["event_wait_s"] >= 0.0 and 0.0 < timing["train_s"] <= timing["total_s"]
    assert (mdl / "chkpnt20.ckpt.guided.npz").exists()
    assert (mdl / "point_cloud" / "iteration_40" / "point_cloud.ply").exists()
    # --guidance_tp 2 pipelined: the worker runs the engine split over two
    # CPU entries through both events (the drain finalizes the second)
    jm, js, pm, ps = toy_configs()
    tparams = diffusion_params_from_numpy(jinit.init_diffusion_params(jm, js, jax.random.key(0)), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        tp = sharded_cli_run(tmp_path / "tp", mp, tparams, pm, ps, extra=("--pipeline_guidance",))
    assert tp.pipeline_guidance and tp._executor is None and tp._pending_event is None
