"""The guided trainer's event variants and artifacts, on the CPU, each
mirroring a test of the JAX package (the trainer of
tests/test_torch_train_guided.py: three 40x40 views, the 80 ground-truth
Gaussians frozen, the mock engine at 5 frames).

- guidance_save_videos writes `video_files_scale{s}/{view}/{cand}.npz`
  (key `video`, the train resolution) and guidance_videos_from_file reads
  it back instead of calling the engine (JAX
  tests/test_train_guided.py::test_video_files_store_and_reuse); a store
  the JAX trainer wrote is read by the port's; the txt mode writes
  `video_view{v}.npz` in the event's directory.
- The two-renderer variant: a mask renderer that sees nothing empties the
  pool (JAX tests/test_variants.py::test_two_renderer_mask_source) and
  makes every pixel of an event's mask unobserved.
- guidance_with_training_gs: the live renderer follows the trainer's
  state, the event's guidance images are the training Gaussians' renders,
  without autograd, and not the frozen ones; the mask stays the frozen
  renderer's (JAX tests/test_train_guided.py::
  test_guidance_with_training_gs_renders_current_state).
- The per-event videos and save_pred_x0's per-step videos of a toy
  ViewCrafterEngine, written as PNG frames when cv2 does not import.
"""

import functools
import glob
import os
import sys

import jax
import numpy as np
import torch

from guidedvd3dgs_tpu.train import guided as jg
from guidedvd3dgs_tpu_torch.convert import state_from_numpy
from guidedvd3dgs_tpu_torch.models.gaussians import GaussianParams
from guidedvd3dgs_tpu_torch.scene import cameras as port_cameras
from guidedvd3dgs_tpu_torch.train import guided as pg
from guidedvd3dgs_tpu_torch.utils.image_io import read_png
from guidedvd3dgs_tpu_torch.utils.video import video_u8

from test_torch_diffusion_models import T, toy_configs
from test_torch_diffusion_slice import ENGINE, jax_request_noise
from test_torch_train_guided import _np, _opt, _states
from test_train_baseline import FakeModelParams, FakePipe, FakeScene, make_synthetic
from test_train_guided import _intrinsic

torch.set_num_threads(2)


def port_trainer(model_path: str = "", engine=None, jax_too: bool = False):
    """The port's trainer (and the JAX package's on the same inputs), the
    pool not built yet."""
    cams = make_synthetic()
    jstate, gt_state, pts, cols = _states()
    K = _intrinsic(cams[0])
    pcams = [port_cameras.Camera(colmap_id=0, R=c.R, T=c.T, FoVx=c.FoVx, FoVy=c.FoVy, image=c.image)
             for c in cams]
    mp = FakeModelParams()
    mp.model_path = model_path
    pt = pg.GuidedTrainer(
        FakeScene(pcams, extent=3.0), state_from_numpy(jax.device_get(jstate)), _opt(),
        FakePipe(raster_backend="tiles"), mp,
        frozen=pg.FrozenRenderer(state_from_numpy(jax.device_get(gt_state)).params, 0, backend="dense"),
        engine=engine or pg.MockDiffusionEngine(video_length=5, height=40, width=40),
        pcd_points=pts, pcd_colors=cols, guidance_intrinsic=K)
    if not jax_too:
        return pt
    jmp = FakeModelParams()
    jmp.model_path = model_path
    jt = jg.GuidedTrainer(
        FakeScene(cams, extent=3.0), jstate, _opt(), FakePipe(), jmp,
        frozen=jg.FrozenRenderer(gt_state, sh_degree=0, backend="dense"),
        engine=jg.MockDiffusionEngine(video_length=5, height=40, width=40),
        pcd_points=pts, pcd_colors=cols, guidance_intrinsic=K)
    return pt, jt


def _w2c(cam) -> np.ndarray:
    w2c = np.eye(4)
    w2c[:3, :3], w2c[:3, 3] = cam.R.T, cam.T
    return w2c


def test_video_files_store_and_reuse(tmp_path):
    pt = port_trainer(str(tmp_path))
    pt.opt.guidance_save_videos = True
    pt.init_trajectory_pool()
    pt.run_diffusion_event(1)
    files = glob.glob(str(tmp_path / "video_files_scale*" / "*" / "*.npz"))
    assert len(files) == 1, files
    sidx, view, cidx = pt._cur_video_key
    assert files[0] == os.path.join(str(tmp_path), f"video_files_scale{sidx}", str(view), f"{cidx}.npz")
    saved = np.load(files[0])["video"]
    assert saved.shape == (5, 3, pt.H, pt.W) and saved.dtype == np.float32

    # reuse: the same pool entry again, the engine broken, the stored video verbatim
    entry = next(e for e in pt.trajectory_pool[view] if e.cand_idx == cidx and e.scale_idx == sidx)
    pt.trajectory_pool_shuffle[view] = [entry]
    pt.vd_indices = [view]
    pt.opt.guidance_videos_from_file = True
    pt.engine.generate = None  # would raise if called
    pt.run_diffusion_event(261)
    np.testing.assert_array_equal(_np(pt.pseudo_stack[0].pseudo_gt), saved[1])
    assert pt.events_run == 2

    # the txt mode (no pool entry): the video in the event's directory
    pt = port_trainer(str(tmp_path / "txt"))
    pt.opt.guidance_save_videos = True
    pt.opt.use_trajectory_pool = False
    pt.init_view_geometry()
    pt.run_diffusion_event(1)
    files = glob.glob(str(tmp_path / "txt" / "diffusion_events" / "train_iter1" / "video_view*.npz"))
    assert len(files) == 1 and not glob.glob(str(tmp_path / "txt" / "video_files_scale*"))


def test_a_store_written_by_jax_is_read_by_the_port(tmp_path):
    pt, jt = port_trainer(str(tmp_path), jax_too=True)
    jt.opt.guidance_save_videos = True
    jt.init_trajectory_pool()
    pt.init_trajectory_pool()
    jt.run_diffusion_event(1)
    jax_key = jt._cur_video_key
    pt.opt.guidance_videos_from_file = True
    pt.opt.save_event_artifacts = False
    pt.engine.generate = None
    pt.run_diffusion_event(1)  # the same shuffled pool entry as JAX's event
    assert pt._cur_video_key == jax_key
    saved = np.load(pt._video_file_path())["video"]
    for i, cam in enumerate(pt.pseudo_stack, start=1):
        np.testing.assert_array_equal(_np(cam.pseudo_gt), saved[i])
        np.testing.assert_allclose(_np(cam.pseudo_gt), _np(jt.pseudo_stack[i - 1].pseudo_gt), atol=1e-6)


def _seeing_nothing(dev="cpu") -> pg.FrozenRenderer:
    """A renderer whose only Gaussian is transparent: alpha 0 everywhere."""
    z = torch.zeros
    params = GaussianParams(xyz=z((1, 3)), features_dc=z((1, 1, 3)), features_rest=z((1, 0, 3)),
                            scaling=torch.full((1, 3), -3.0), rotation=torch.tensor([[1.0, 0, 0, 0]]),
                            opacity=torch.full((1, 1), -60.0))
    return pg.FrozenRenderer(params, 0, backend="dense")


def test_two_renderer_mask_source():
    pt = port_trainer()
    pt.frozen_mask = _seeing_nothing()
    pt.init_trajectory_pool()
    # every candidate is all unobserved for the mask renderer: the pool is empty
    assert set(pt.trajectory_pool) == {0, 1, 2}
    assert all(len(v) == 0 for v in pt.trajectory_pool.values())

    # the pool of the frozen baseline, the event's mask from the mask renderer
    pt = port_trainer()
    pt.init_trajectory_pool()
    pt.frozen_mask = _seeing_nothing()
    seen = {}
    generate = pt.engine.generate

    def spy(pc, images, masks, depths, **kw):
        seen.update(images=images, masks=masks)
        return generate(pc, images, masks, depths, **kw)

    pt.engine.generate = spy
    pt.run_diffusion_event(1)
    assert float(seen["masks"].max()) == 0.0  # nothing observed
    assert all(bool((cam.mask == 1.0).all()) for cam in pt.pseudo_stack)
    w2c = _w2c(pt.pseudo_stack[0])
    rgb, _, _ = pt.frozen.render(w2c, pt.intrinsic, pt.H, pt.W)
    np.testing.assert_array_equal(_np(seen["images"][1]), _np(rgb.clamp(0, 1)))  # rgb still the baseline's


def test_guidance_with_training_gs_renders_current_state():
    pt = port_trainer()
    pt.opt.guidance_with_training_gs = True
    pt.opt.guidance_with_training_gs_startiter = 0
    pt.init_trajectory_pool()
    seen = []
    generate = pt.engine.generate

    def spy(pc, images, masks, depths, **kw):
        seen.append((images, masks))
        return generate(pc, images, masks, depths, **kw)

    pt.engine.generate = spy
    pt.run_diffusion_event(1)
    assert pt.events_run == 1 and len(pt.pseudo_stack) == 4
    assert pt._live_renderer is not None and pt._live_renderer.state is pt.state
    images, masks = seen[0]
    assert not images.requires_grad
    w2c = _w2c(pt.pseudo_stack[0])
    live = pg.FrozenRenderer(GaussianParams(**pt.state.params.tensors()), pt.max_sh_degree, backend="dense")
    rgb_live, _, _ = live.render(w2c, pt.intrinsic, pt.H, pt.W)
    rgb_frozen, alpha_frozen, _ = pt.frozen.render(w2c, pt.intrinsic, pt.H, pt.W)
    np.testing.assert_array_equal(_np(images[1]), _np(rgb_live.clamp(0, 1)))
    assert float((images[1] - rgb_frozen.clamp(0, 1)).abs().max()) > 0.1
    np.testing.assert_array_equal(_np(masks[1, 0]), _np((alpha_frozen.clamp(0, 1) >= 0.9).float()))

    # after steps, the next event renders the state as it is then
    for it in range(2, 5):
        pt.step(it)
    pt.run_diffusion_event(5)
    assert pt._live_renderer.state is pt.state
    w2c = _w2c(pt.pseudo_stack[0])
    live = pg.FrozenRenderer(GaussianParams(**pt.state.params.tensors()), pt.max_sh_degree, backend="dense")
    rgb_live, _, _ = live.render(w2c, pt.intrinsic, pt.H, pt.W)
    np.testing.assert_array_equal(_np(seen[1][0][1]), _np(rgb_live.clamp(0, 1)))


def test_event_artifacts_and_pred_x0_as_png_without_cv2(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now raises ImportError
    jm, js, pm, ps = toy_configs()
    from guidedvd3dgs_tpu.diffusion import init as jinit
    from guidedvd3dgs_tpu_torch.convert import diffusion_params_from_numpy

    params = diffusion_params_from_numpy(jinit.init_diffusion_params(jm, js, jax.random.key(0)), device="cpu")
    engine = pg.ViewCrafterEngine(params, pm, ps, video_length=T, height=ENGINE, width=ENGINE)
    engine.generate = functools.partial(engine.generate, noise=jax_request_noise(jax.random.key(1), ps.ddim_steps))
    pt = port_trainer(str(tmp_path), engine=engine)
    pt.opt.save_pred_x0 = True
    pt.init_trajectory_pool()
    pt.run_diffusion_event(1)
    pt.artifact_writer.drain()
    d = tmp_path / "diffusion_events" / "train_iter1"
    names = ["render0", "gs_render", "gs_render_alpha", "gs_render_depth", "diffusion0"]
    names += [f"pred_x0_step{i:03d}" for i in range(ps.ddim_steps)]
    for name in names:
        pngs = sorted(glob.glob(str(d / name / "*.png")))
        assert [os.path.basename(p) for p in pngs] == [f"{i:03d}.png" for i in range(T)], name
        assert read_png(pngs[0]).shape == ((pt.H, pt.W, 3) if not name.startswith("pred") else (ENGINE, ENGINE, 3))
    assert not glob.glob(str(d / "*.mp4"))
    # diffusion0 holds the pseudo ground truth quantised
    np.testing.assert_array_equal(read_png(str(d / "diffusion0" / "001.png")),
                                  video_u8(pt.pseudo_stack[0].pseudo_gt[None])[0])
    assert engine.save_pred_x0_dir == str(d)
    pt.opt.save_pred_x0 = False
    pt.run_diffusion_event(2)
    assert engine.save_pred_x0_dir is None
    pt.artifact_writer.drain()
    assert not glob.glob(str(tmp_path / "diffusion_events" / "train_iter2" / "pred_x0_*"))
